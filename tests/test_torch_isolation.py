"""The PyTorch port stands alone: no JAX, no ``repro`` imports, and entry
points that run on CUDA unless asked for the CPU."""
from __future__ import annotations

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "tools" / "logit_fault_control.py",
           ROOT / "tools" / "grad_fault_control.py",
           ROOT / "tools" / "serving_probe.py",
           ROOT / "examples" / "serve_queries_torch.py"]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + SCRIPTS


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
             for p in PORT_FILES if p not in SCRIPTS}
    for mod in ("core/compression.py", "core/columnar.py", "core/engine.py",
                "core/exchange.py", "core/semijoin.py", "core/topk.py",
                "core/late_materialization.py", "kernels/ops.py",
                "kernels/wire_codec.py", "query/lower.py", "tpch/driver.py",
                "kernels/flash_attention.py", "kernels/decode_attention.py",
                "models/config.py", "models/params.py", "models/layers.py",
                "models/transformer.py", "models/model.py",
                "models/convert.py", "configs/registry.py",
                "configs/qwen2_5_3b.py", "configs/qwen3_moe_30b_a3b.py",
                "configs/phi3_5_moe_42b_a6_6b.py", "models/moe.py",
                "models/moe_dispatch.py", "serve/sampling.py",
                "serve/engine.py", "kernels/flash_attention_bwd.py",
                "optim/adamw.py", "data/synthetic.py",
                "train/train_step.py", "train/checkpoint.py",
                "train/elastic.py", "train/trainer.py", "launch/train.py",
                "kernels/topk_select.py", "kernels/bitset_pack.py",
                "kernels/mbit_codec.py", "core/topk_approx.py",
                "core/plans/__init__.py", "core/plans/common.py",
                "core/plans/local.py", "core/plans/distributed_topk.py",
                "tpch/capacities.py", "tpch/reference.py",
                "obs/__init__.py", "obs/metrics.py", "obs/trace.py",
                "cube/__init__.py", "cube/spec.py", "cube/build.py",
                "cube/router.py", "cube/serving.py", "tpch/cubes.py",
                "serve/__init__.py", "serve/olap_engine.py",
                "serve/workload.py", "launch/serve_olap.py",
                "launch/mesh.py", "models/ssm.py", "models/hybrid.py",
                "configs/mamba2_2_7b.py", "configs/recurrentgemma_2b.py",
                "models/encdec.py", "models/vlm.py",
                "configs/whisper_medium.py", "configs/paligemma_3b.py"):
        assert mod in names


@pytest.mark.parametrize("entry", ["cluster", "driver", "model",
                                   "decode_state", "train_state", "trainer",
                                   "launch_train", "serve_olap"])
def test_entry_points_need_cuda_or_an_explicit_cpu(entry, monkeypatch):
    from repro_torch.configs import get_arch
    from repro_torch.core.engine import Cluster
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.serve_olap import main as serve_olap
    from repro_torch.launch.train import main as launch_train
    from repro_torch.models.model import build
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tpch.driver import TPCHDriver
    from repro_torch.train.train_step import init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build(get_arch("qwen2.5-3b", smoke=True))
    data = SyntheticLM(vocab_size=256, seq_len=8, global_batch=2)

    def launch(device=None):
        argv = ["--arch", "qwen2.5-3b", "--smoke", "--steps", "1",
                "--batch", "2", "--seq", "8"]
        return launch_train(argv + (["--device", device] if device else []))

    def serve(device=None):
        argv = ["--sf", "0.001", "--queries", "q6", "--repeat", "1"]
        return serve_olap(argv + (["--device", device] if device else []))

    make = {"cluster": lambda **kw: Cluster(8, **kw),
            "driver": lambda **kw: TPCHDriver(0.001, **kw),
            "model": lambda **kw: model.init(0, **kw),
            "decode_state": lambda **kw: model.init_decode_state(
                2, 8, **kw),
            "train_state": lambda **kw: init_train_state(model, 0, **kw),
            "trainer": lambda device=None: Trainer(
                model, data, device, AdamWConfig(), TrainerConfig(steps=1)),
            "launch_train": launch, "serve_olap": serve}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    if entry == "cluster":
        assert make(device="cpu").device == torch.device("cpu")
    if entry == "model":
        p = make(device="cpu")
        assert p.embedding["table"].device == torch.device("cpu")
    if entry == "trainer":
        assert make(device="cpu").device == torch.device("cpu")
    if entry == "serve_olap":
        assert make(device="cpu") == 0
