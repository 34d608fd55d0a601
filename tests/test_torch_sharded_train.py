"""The port's sharded trainer against the JAX package, on the CPU at the
qwen2.5-3b SMOKE size (2 layers, d_model 64, 4 / 2 heads, f32).

Two spawns of ``tests/fixtures/torch_train_worker.py`` run one after the
other (at most 4 ranks at a time), each rank a process with torchrun's
variables, over gloo:

- ``w4``: ``launch/train.py --mesh 2x2 --device cpu``, then 3 steps on
  the mesh (2, 2);
- ``w2``: 3 steps on (2, 1) (then a checkpoint and 2 more steps), 3 steps
  on (1, 2) through the flash path (the plain B7 / B8 on the CPU), the
  (2, 1) checkpoint restored on (1, 2) with its 2 more steps, and flash
  attention on DTensors.

Each mesh starts from the JAX SMOKE parameters (biases made non-zero)
carried across, and its steps are held against the JAX package's
unsharded jitted ``make_train_step`` on the same global batches, with
the limits of ``test_torch_train.test_train_steps_match_jax``: the loss
at rtol 1e-5, the gradient norm at rtol 1e-4 and the parameters after 3
steps within 1e-5 of their largest |value| (2e-5 on the meshes with a
model axis: ``TP_PARAM_REL`` says why).  The JAX model is built with
the mesh's ``model`` size as ``tp``; at the SMOKE size that pads no head,
so one reference serves every mesh (checked).  The JAX package's own
sharded ``Trainer`` fails on JAX 0.9 (``ROADMAP.md`` §C), so it is not
used; its pure sharding logic (``sharding.resolve``, ``spec_tree``) is,
on ``AbstractMesh``es of the test and production shapes.

Every rank's block of every parameter and AdamW moment has the shape the
port's ``resolve`` gives; the elastic restore continues the uninterrupted
run's losses at rtol 1e-5; ``compress_gradients`` gives the JAX int8
codes bit for bit over 3 steps of error feedback, its scales and
residuals within f32 rounding (rtol 1e-6); ``save_hot`` gives the JAX
``save_hot``'s loss and gradients (rtol 1e-5, 1e-5 of the largest
|gradient|) and the port's ``full`` ones exactly.
"""
from __future__ import annotations

import os
import pathlib
import pickle
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_arch as jax_get_arch
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro.launch import mesh as jax_mesh
from repro.models import sharding as jax_sharding
from repro.models.model import build as jax_build
from repro.models.params import values
from repro.optim import adamw as jax_adamw
from repro.optim import compression as jax_compression
from repro.train.train_step import TrainState as JaxTrainState
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import sharding as SH
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build
from repro_torch.optim import compression
from test_torch_train import _grad_tree

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "fixtures" / "torch_train_worker.py"
ARCH = "qwen2.5-3b"
LOSS_RTOL = 1e-5
GNORM_RTOL = 1e-4
PARAM_REL = 1e-5
# A mesh with a model axis of 2 sums each row-parallel product and the
# vocab-parallel softmax over two ranks: other rounding, which AdamW's
# m / sqrt(v) turns into 1.15x (1x2, at layers.attn.bk) and 1.21x (2x2,
# at embedding.table) of PARAM_REL after 3 steps, where the gradient of
# an element cancels over the batch; the unsharded port sits at 0.81x
# (flash) and 0.45x (xla) of it.  Losses and gradient norms keep their
# limits.
TP_PARAM_REL = 2 * PARAM_REL
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
STEPS = 5                 # batches: 3 steps held against JAX, 2 more
TIMEOUT_S = 180
MESHES = {"2x1": ("w2", "mesh_2x1", "xla"), "1x2": ("w2", "mesh_1x2", "flash"),
          "2x2": ("w4", "mesh_2x2", "xla")}


def _jax_params(tp: int) -> dict:
    """The JAX SMOKE parameters built with ``tp``, as numpy; the QKV
    biases made non-zero (as in test_torch_train)."""
    cfg = jax_get_arch(ARCH, smoke=True)
    tree = jax.tree.map(np.asarray,
                        values(jax_build(cfg, tp=tp).init(jax.random.key(0))))
    rng = np.random.default_rng(0)
    for b in ("bq", "bk", "bv"):
        a = tree["layers"]["attn"][b]
        tree["layers"]["attn"][b] = (0.1 * rng.normal(size=a.shape)
                                     ).astype(np.float32)
    return tree


def _batches() -> list:
    cfg = jax_get_arch(ARCH, smoke=True)
    data = JaxSyntheticLM(vocab_size=cfg.vocab_size, seq_len=64,
                          global_batch=4, seed=0)
    return [data.host_batch(t) for t in range(STEPS)]


def _jax_run(params, batches, impl, steps):
    """The JAX package's unsharded jitted step: [(loss, grad norm)], and
    the parameters after 3 steps."""
    jm = jax_build(jax_get_arch(ARCH, smoke=True))
    jstep = jax.jit(jax_make_train_step(
        jm, jax_adamw.AdamWConfig(**OPT), fwd_kw={"attn_impl": impl}))
    jp = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(jp, jax_adamw.adamw_init(jp))
    hist, after3 = [], None
    for t in range(steps):
        state, met = jstep(state, jax.tree.map(jnp.asarray, batches[t]))
        hist.append((float(met["loss"]), float(met["grad_norm"])))
        if t == 2:
            after3 = jax.tree.map(np.asarray, state.params)
    return hist, after3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(spawn: str, world: int, inp, out: pathlib.Path) -> list:
    src = str(ROOT / "src")
    base = dict(os.environ, OMP_NUM_THREADS="1", WORLD_SIZE=str(world),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                PYTHONPATH=os.pathsep.join(
                    [src] + [p for p in os.environ.get("PYTHONPATH", "")
                             .split(os.pathsep) if p]))
    procs = []
    for rank in range(world):
        log = open(out / f"rank{rank}.log", "w")
        procs.append((log, subprocess.Popen(
            [sys.executable, str(WORKER), spawn, str(inp), str(out)],
            env=dict(base, RANK=str(rank), LOCAL_RANK=str(rank)),
            stdout=log, stderr=subprocess.STDOUT)))
    return procs


def _collect(procs, out: pathlib.Path, spawn: str) -> list:
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for _, p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{spawn}: the ranks did not finish within {TIMEOUT_S} s")
    finally:
        for log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    res = []
    for rank, (_, p) in enumerate(procs):
        text = (out / f"rank{rank}.log").read_text()[-4000:]
        path = out / f"rank{rank}.pkl"
        assert p.returncode == 0 and path.exists(), (
            f"{spawn} rank {rank} exited {p.returncode}:\n{text}")
        with open(path, "rb") as f:
            r = pickle.load(f)
        assert "error" not in r, f"{spawn} rank {rank}:\n{r['error']}"
        res.append(r)
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns' per-rank results and the JAX references; the JAX
    steps run while the first spawn does."""
    params = _jax_params(1)
    padded = _jax_params(2)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(params), jax.tree.leaves(padded)))
    batches = _batches()
    inp = tmp_path_factory.mktemp("inputs") / "inputs.pkl"
    with open(inp, "wb") as f:
        pickle.dump({"arch": ARCH, "params": params, "batches": batches,
                     "opt": OPT}, f)
    out4 = tmp_path_factory.mktemp("w4")
    procs = _spawn("w4", 4, inp, out4)
    try:
        jax_ref = {"xla": _jax_run(params, batches, "xla", STEPS),
                   "flash": _jax_run(params, batches, "flash", 3)}
    except BaseException:
        for log, p in procs:
            p.kill()
            p.wait()
            log.close()
        raise
    res = {"w4": _collect(procs, out4, "w4"), "jax": jax_ref}
    out2 = tmp_path_factory.mktemp("w2")
    res["w2"] = _collect(_spawn("w2", 2, inp, out2), out2, "w2")
    return res


def _assert_tree_close(got: dict, want: dict, rel: float):
    """Each leaf of ``want`` within ``rel`` of its largest |value| of the
    same leaf of ``got`` (both nested dicts of numpy arrays)."""
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for k in path:
            g = g[k.key]
        tol = rel * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=0,
                                   atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# the sharded steps against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_steps_match_jax(runs, mesh):
    spawn, key, impl = MESHES[mesh]
    want, want_params = runs["jax"][impl]
    for r in runs[spawn]:
        got = r[key]
        assert got["step"] == 3
        for t, ((gl, gn), (wl, wn)) in enumerate(zip(got["history"],
                                                     want[:3], strict=True)):
            np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL,
                                       err_msg=f"rank {r['rank']} step {t}")
            np.testing.assert_allclose(gn, wn, rtol=GNORM_RTOL,
                                       err_msg=f"rank {r['rank']} step {t}")
        _assert_tree_close(got["params"], want_params,
                           PARAM_REL if mesh == "2x1" else TP_PARAM_REL)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_each_rank_holds_its_blocks(runs, mesh):
    """Every parameter's and moment's block on every rank has the shape
    the port's ``resolve`` gives on the mesh; each mesh axis of more than
    one rank shards some leaf, and the moments follow the parameters."""
    spawn, key, _ = MESHES[mesh]
    dims = tuple(int(x) for x in mesh.split("x"))
    shape = SH.MeshShape(("data", "model"), dims)
    meta = build(get_arch(ARCH, smoke=True), tp=dims[1])._init(None)
    want, split = {}, set()
    for n, p in meta.named_parameters():
        local = list(p.shape)
        for ax, pl in zip(shape.axis_names, SH.resolve(p.axes, shape)):
            if isinstance(pl, Shard):
                local[pl.dim] //= dict(zip(*shape))[ax]
                if dict(zip(*shape))[ax] > 1:
                    split.add(ax)
        for label in ("params", "mu", "nu"):
            want[f"{label}.{n}"] = tuple(local)
    assert split == {ax for ax, s in zip(*shape) if s > 1}
    for r in runs[spawn]:
        assert r[key]["local"] == want, f"rank {r['rank']}"


def test_elastic_restore_onto_another_mesh(runs):
    """The checkpoint saved under (2, 1) after 3 steps restores under
    (1, 2) and continues with the uninterrupted (2, 1) run's losses."""
    for r in runs["w2"]:
        assert r["elastic"]["start"] == 3
        want = r["mesh_2x1"]["more"]
        got = r["elastic"]["history"]
        assert len(got) == len(want) == 2
        for (gl, gn), (wl, wn) in zip(got, want):
            np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL)
            np.testing.assert_allclose(gn, wn, rtol=GNORM_RTOL)
        # and with the JAX package's steps 4 and 5
        for (gl, _), (wl, _) in zip(got, runs["jax"]["xla"][0][3:]):
            np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL)
        assert r["elastic"]["local"] == r["mesh_1x2"]["local"]


def test_launcher_mesh_2x2(runs):
    """``launch/train.py --mesh 2x2 --device cpu`` on 4 gloo ranks: every
    rank returns 0, rank 0 alone prints the final loss."""
    for r in runs["w4"]:
        assert r["launcher_rc"] == 0
        assert ("final loss" in r["launcher_out"]) == (r["rank"] == 0)


def test_flash_attention_on_dtensors(runs):
    """Flash attention on DTensors laid out as the fused (B*KV) dim wants
    runs on the local blocks (forward and backward counted) and equals
    the whole call; another layout is refused, never gathered."""
    for r in runs["w2"]:
        got = r["flash_dtensor"]
        assert max(got["errs"]) < 1e-5, got["errs"]
        assert got["counts"] == {"flash_attention_fwd": 1,
                                 "flash_attention_bwd": 1,
                                 "decode_attention": 0}
        assert "kv-head axes" in got["refused"]
        assert got["placements"] == [(0, 0), (1, 2)]
        assert r["refuse_moe"] and "item 11.4" in r["refuse_moe"]


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo group of this process alone, destroyed after the test."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'st'}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        launch_mesh.destroy()


@pytest.mark.parametrize("arch", [ARCH, "qwen3-moe-30b-a3b"])
def test_one_rank_mesh_equals_the_device_path(one_rank_group, arch):
    """On a mesh (1, 1) the trainer gives the device path's losses and
    gradient norms exactly (no collective runs on a dim of one rank); a
    family other than the dense one runs there, its parameters made local
    whole."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_arch(arch, smoke=True)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
                       seed=0)

    def run(where):
        return Trainer(build(cfg), data, where,
                       AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3),
                       TrainerConfig(steps=3, log_every=1000)).run()[1]

    want = run("cpu")
    got = run(launch_mesh.parse_mesh("1x1", "cpu"))
    assert [(h["loss"], h["grad_norm"]) for h in got] == [
        (h["loss"], h["grad_norm"]) for h in want]


# ---------------------------------------------------------------------------
# the sharding rules against the JAX package's (no devices: abstract meshes)
# ---------------------------------------------------------------------------

MESH_SHAPES = {(2, 2): ("data", "model"), (16, 16): ("data", "model"),
               (2, 16, 16): ("pod", "data", "model")}
_STACKED = ("layers", "enc_layers", "dec_layers")


def _jax_in_port_layout(jtree, cfg, strip):
    """A JAX tree of axes or specs in the port's layout: each stacked tree
    split into its layers (``strip`` drops the leading ``layers`` entry of
    each leaf), a hybrid layer's live block only."""
    from repro_torch.models.hybrid import is_attn_layer

    def layer(sub):
        if isinstance(sub, dict):
            return {k: layer(v) for k, v in sub.items()}
        return strip(sub)

    out = {}
    for name, sub in jtree.items():
        if name not in _STACKED:
            out[name] = sub
            continue
        n = (cfg.encdec.n_enc_layers if name == "enc_layers"
             else cfg.n_layers)
        if set(sub) == {"attn_block", "rec_block"}:
            out[name] = [layer(sub["attn_block" if is_attn_layer(cfg, i)
                                   else "rec_block"]) for i in range(n)]
        else:
            out[name] = [layer(sub) for _ in range(n)]
    return out


def _strip_axes(axes):
    assert axes[0] == "layers"
    return axes[1:]


def _strip_spec(spec):
    assert spec[0] is None
    return spec[1:]


def _placements_of(spec, names):
    """A JAX PartitionSpec (its entries) -> DTensor placements."""
    out = []
    for name in names:
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_and_resolve_match_jax(arch):
    """Each SMOKE config's logical-axes tree equals JAX's leaf for leaf;
    on meshes (2, 2), (16, 16) and (2, 16, 16) every leaf's partition spec
    equals JAX's ``resolve``, its placements JAX's spec, ``spec_tree``
    JAX's ``spec_tree``; the decode state's axes equal JAX's."""
    jcfg, cfg = jax_get_arch(arch, smoke=True), get_arch(arch, smoke=True)
    jm, model = jax_build(jcfg, tp=2), build(cfg, tp=2)
    jaxes = jm.param_axes()
    axes = model.param_axes()
    assert axes == _jax_in_port_layout(jaxes, cfg, _strip_axes)
    for dims, names in MESH_SHAPES.items():
        amesh = AbstractMesh(dims, names)
        shape = SH.MeshShape(names, dims)
        jspecs = _jax_in_port_layout(jax.tree.map(
            tuple, jax_sharding.spec_tree(jaxes, amesh),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)),
            cfg, _strip_spec)
        pairs = list(zip(_leaves(axes), _leaves(jspecs),
                         _leaves(SH.spec_tree(axes, shape)), strict=True))
        for ax, js, pl in pairs:
            assert SH.partition_spec(ax, shape) == js, (ax, dims)
            assert pl == SH.resolve(ax, shape) == _placements_of(js, names)
    jstate = jm.decode_state_axes()
    state = model.decode_state_axes()
    assert {f: getattr(state, f) for f in jstate._fields} == jstate._asdict()


def test_rules_degrade_as_jax():
    """Axes absent from the mesh and a batch that does not divide the
    data shards replicate, as the reference's ``resolve`` and
    ``launch/cells._rules_for``."""
    from repro.launch.cells import _rules_for as jax_rules_for

    for dims, names in MESH_SHAPES.items():
        amesh, shape = AbstractMesh(dims, names), SH.MeshShape(names, dims)
        for batch in (1, 3, 32, 256):
            rules = SH.rules_for(shape, batch)
            assert rules == jax_rules_for(amesh, batch)
            for axes in (("batch", "seq"), ("batch", None, "embed"),
                         ("vocab", "embed"), ("expert", "embed", "mlp")):
                assert SH.partition_spec(axes, shape, rules) == tuple(
                    jax_sharding.resolve(axes, amesh, rules))
    with pytest.raises(ValueError, match="one dim"):
        SH.resolve(("heads", "mlp"), SH.MeshShape(("model",), (2,)))


def test_meshes_need_their_ranks():
    """The LM meshes name torchrun when this process has no group of
    their size."""
    for make in (launch_mesh.make_production_mesh,
                 launch_mesh.make_test_mesh):
        with pytest.raises(ValueError, match="torchrun"):
            make()
    with pytest.raises(ValueError, match="PxDxM"):
        launch_mesh.parse_mesh("2x2x2x2", "cpu")


def test_hardware_constants_keys():
    """The card's constants under the reference's keys, none of them the
    reference's TPU numbers, with the card's name and power limit."""
    got = launch_mesh.hardware_constants()
    want = jax_mesh.hardware_constants()
    assert set(want) <= set(got)
    assert all(got[k] != want[k] and got[k] > 0 for k in want)
    assert got["peak_flops_bf16"] == 989e12 and got["hbm_bandwidth"] == 3.35e12
    assert "H100" in got["device"] and got["power_limit_w"] == 700.0


# ---------------------------------------------------------------------------
# gradient compression and save_hot
# ---------------------------------------------------------------------------


def _grad_trees(rng, n):
    return [{"a": rng.normal(size=(3, 5)).astype(np.float32) * 10 ** i,
             "b": [rng.normal(size=7).astype(np.float32),
                   rng.normal(size=(2, 2, 2)).astype(np.float32) * 1e-3]}
            for i in range(n)]


def test_compress_gradients_match_jax():
    trees = _grad_trees(np.random.default_rng(5), 3)
    jstate = jax_compression.compression_init(trees[0])
    state = compression.compression_init(
        jax.tree.map(torch.from_numpy, trees[0]))
    for g in trees:
        jq, jstate = jax_compression.compress_gradients(
            jax.tree.map(jnp.asarray, g), jstate)
        q, state = compression.compress_gradients(
            jax.tree.map(torch.from_numpy, g), state)
        got, want = jax.tree.leaves(q), jax.tree.leaves(jq)
        assert len(got) == len(want) == 6
        for a, b in zip(got[0::2], want[0::2]):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(got[1::2], want[1::2]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        for a, b in zip(jax.tree.leaves(state.error),
                        jax.tree.leaves(jstate.error)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6 * float(np.abs(b).max()))
        for a, b in zip(jax.tree.leaves(compression.decompress_gradients(q)),
                        jax.tree.leaves(
                            jax_compression.decompress_gradients(jq))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_save_hot_matches_jax(impl):
    params = _jax_params(1)
    batch = _batches()[0]
    jm = jax_build(jax_get_arch(ARCH, smoke=True))
    want_l, want_g = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, attn_impl=impl,
                             remat_policy="save_hot")))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch))
    model = build(get_arch(ARCH, smoke=True))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = {}
    for policy in ("save_hot", "full"):
        p = params_from_jax(params, trainable=True)
        loss = model.loss(p, tb, attn_impl=impl, remat_policy=policy)
        loss.backward()
        grads[policy] = (float(loss.detach()), _grad_tree(p))
    np.testing.assert_allclose(grads["save_hot"][0], float(want_l),
                               rtol=LOSS_RTOL)
    assert grads["save_hot"][0] == grads["full"][0]
    for a, b in zip(jax.tree.leaves(grads["save_hot"][1]),
                    jax.tree.leaves(grads["full"][1]), strict=True):
        assert torch.equal(a, b)
    got = jax.tree.map(lambda t: t.numpy(), grads["save_hot"][1])
    _assert_tree_close(got, jax.tree.map(np.asarray, want_g), PARAM_REL)
