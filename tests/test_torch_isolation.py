"""The PyTorch port stands alone: no JAX, no ``repro`` imports, and entry
points that run on CUDA unless asked for the CPU."""
from __future__ import annotations

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path) -> list:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.append(node.module)
    return mods


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib"), f"{path} imports {mod}"
        assert top != "repro", f"{path} imports {mod}"


def test_port_file_list_is_complete():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES[:-1]}
    for mod in ("core/compression.py", "core/columnar.py", "core/engine.py",
                "core/exchange.py", "core/semijoin.py", "core/topk.py",
                "core/late_materialization.py", "kernels/ops.py",
                "kernels/wire_codec.py", "query/lower.py", "tpch/driver.py"):
        assert mod in names


@pytest.mark.parametrize("entry", ["cluster", "driver"])
def test_entry_points_need_cuda_or_an_explicit_cpu(entry, monkeypatch):
    from repro_torch.core.engine import Cluster
    from repro_torch.tpch.driver import TPCHDriver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = {"cluster": lambda **kw: Cluster(8, **kw),
            "driver": lambda **kw: TPCHDriver(0.001, **kw)}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    if entry == "cluster":
        assert make(device="cpu").device == torch.device("cpu")
