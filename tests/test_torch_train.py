"""The port's training path against the JAX package, on the CPU at the
qwen2.5-3b SMOKE size (2 layers, d_model 64, f32): ``Model.loss`` and its
gradients, AdamW, the train step over 3 steps (1 and 2 microbatches, both
attention impls), the data pipeline, checkpoints in both directions, the
trainer and the launcher.

The JAX sharded ``Trainer`` is not used: on JAX 0.9 its embedding gather
fails under the Explicit mesh axes that ``jax.make_mesh`` makes
(``ROADMAP.md`` §C).  The port is held against the unsharded functions:
``Model.loss``, ``jax.value_and_grad``, ``adamw_update`` and the jitted
``make_train_step``, from the same state (``train_state_from_jax``).

Tolerances: the same f32 arithmetic in another order.  Loss rtol 1e-5;
each gradient within 1e-4 of its largest |value|; AdamW rtol 1e-6;
parameters after 3 steps within 1e-5 of their largest |value|.
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro.models.model import build as jax_build
from repro.models.params import values
from repro.optim import adamw as jax_adamw
from repro.train import checkpoint as jax_ckpt
from repro.train import elastic as jax_elastic
from repro.train.train_step import TrainState as JaxTrainState
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import SyntheticLM, zipf_tokens
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import (jax_layout, params_from_jax,
                                        train_state_from_jax)
from repro_torch.models.model import build
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import elastic
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "qwen2.5-3b"
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
PARAM_REL = 1e-5


@pytest.fixture(scope="module")
def jax_params():
    """The JAX SMOKE parameters, as numpy; biases made non-zero so that
    the QKV bias path carries gradient."""
    cfg = jax_get_arch(ARCH, smoke=True)
    tree = jax.tree.map(np.asarray,
                        values(jax_build(cfg).init(jax.random.key(0))))
    rng = np.random.default_rng(0)
    for b in ("bq", "bk", "bv"):
        a = tree["layers"]["attn"][b]
        tree["layers"]["attn"][b] = (0.1 * rng.normal(size=a.shape)
                                     ).astype(np.float32)
    return tree


def _batch(step=0, batch=4, seq=64):
    cfg = jax_get_arch(ARCH, smoke=True)
    return JaxSyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=batch, seed=0).host_batch(step)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _grad_tree(params: Transformer) -> dict:
    """The gradients of ``params`` in the JAX layout."""
    t = params.tree()

    def sub(d):
        return {k: v.grad for k, v in d.items()}

    tree = {n: sub(t[n]) for n in ("embedding", "final_norm", "head")
            if n in t}
    tree["layers"] = [{b: sub(d) for b, d in lp.items()}
                      for lp in t["layers"]]
    return jax_layout(Transformer(tree))


def _assert_tree_close(got: dict, want, rel: float):
    """Each leaf of ``want`` (a JAX tree) within ``rel`` of its largest
    |value| of the same leaf of ``got`` (nested dicts of tensors)."""
    n = 0
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        x = got
        for k in path:
            x = x[k.key]
        w = np.asarray(w, np.float32)
        tol = rel * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(x.detach().float().numpy(), w, rtol=0,
                                   atol=tol, err_msg=jax.tree_util.keystr(
                                       path))
        n += 1
    assert n == len(jax.tree.leaves(want))


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_loss_and_grads_match_jax(jax_params, impl, remat):
    jm = jax_build(jax_get_arch(ARCH, smoke=True))
    batch = _batch()
    want_l, want_g = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, attn_impl=impl)))(
        jax.tree.map(jnp.asarray, jax_params),
        jax.tree.map(jnp.asarray, batch))
    model = build(get_arch(ARCH, smoke=True))
    params = params_from_jax(jax_params, trainable=True)
    ops.reset_launch_counts()
    loss = model.loss(params, _torch_batch(batch), attn_impl=impl,
                      remat_policy=remat)
    loss.backward()
    assert loss.dtype == torch.float32 and loss.ndim == 0
    np.testing.assert_allclose(float(loss.detach()), float(want_l),
                               rtol=LOSS_RTOL)
    _assert_tree_close(_grad_tree(params), want_g, GRAD_REL)
    assert not any(ops.launch_counts().values())


def test_chunked_cross_entropy_masks_and_counts(jax_params):
    """Labels of -1 count for nothing; chunks that do not divide S shrink
    to a divisor, as in JAX."""
    from repro.models.model import chunked_cross_entropy as jax_cce
    from repro_torch.models.model import chunked_cross_entropy

    cfg = jax_get_arch(ARCH, smoke=True)
    rng = np.random.default_rng(4)
    h = rng.normal(size=(2, 48, cfg.d_model)).astype(np.float32)
    lab = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    lab[0, ::3] = -1
    want, wcnt = jax_cce(jnp.asarray(h), jnp.asarray(lab), cfg,
                         jax.tree.map(jnp.asarray, jax_params), chunk=20)
    got, cnt = chunked_cross_entropy(
        torch.from_numpy(h), torch.from_numpy(lab), get_arch(ARCH, smoke=True),
        params_from_jax(jax_params), chunk=20)
    assert int(cnt) == int(wcnt) == 96 - 16
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_remat_policies():
    """``save_hot`` gives ``full``'s loss and gradients exactly (the same
    operations, kept or recomputed); an unknown policy raises."""
    model = build(get_arch(ARCH, smoke=True))
    params = model.init(0, device="cpu", trainable=True)
    assert all(p.requires_grad for p in params.parameters())
    assert not any(p.requires_grad for p in model.cast(params).parameters())
    b = _torch_batch(_batch(batch=2, seq=16))
    got = {}
    for policy in ("full", "save_hot"):
        loss = model.loss(params, b, remat_policy=policy)
        loss.backward()
        got[policy] = (float(loss.detach()),
                       [p.grad for p in adamw.leaves(params)])
        for p in params.parameters():
            p.grad = None
    assert got["save_hot"][0] == got["full"][0]
    for a, c in zip(got["save_hot"][1], got["full"][1], strict=True):
        assert torch.equal(a, c)
    with pytest.raises(ValueError, match="remat"):
        model.loss(params, b, remat_policy="everything")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _random_tree(rng, scale=1.0):
    return {"a": (scale * rng.normal(size=(3, 5))).astype(np.float32),
            "b": {"c": (scale * rng.normal(size=7)).astype(np.float32),
                  "d": (scale * rng.normal(size=(2, 2, 2))).astype(
                      np.float32)}}


@pytest.mark.parametrize("gscale", [0.01, 10.0])   # below / above clip_norm
def test_adamw_update_matches_jax(gscale):
    rng = np.random.default_rng(int(gscale * 100))
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20)
    jcfg = jax_adamw.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20)
    p = _random_tree(rng)
    mu, nu = _random_tree(rng, 0.1), jax.tree.map(np.abs,
                                                  _random_tree(rng, 0.01))
    js = jax_adamw.AdamWState(jnp.int32(4), jax.tree.map(jnp.asarray, mu),
                              jax.tree.map(jnp.asarray, nu))
    t = lambda tree: jax.tree.map(torch.from_numpy, tree)  # noqa: E731
    ts = adamw.AdamWState(torch.tensor(4, dtype=torch.int32), t(mu), t(nu))
    tp = t(jax.tree.map(np.copy, p))
    for step in range(3):
        g = _random_tree(rng, gscale)
        jp, js, jm = jax_adamw.adamw_update(jax.tree.map(jnp.asarray, g), js,
                                            jax.tree.map(jnp.asarray, p),
                                            jcfg)
        p = jax.tree.map(np.asarray, jp)
        tp, ts, tm = adamw.adamw_update(t(g), ts, tp, cfg)
        assert int(ts.step) == int(js.step) == 5 + step
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        for got, want in ((tp, p), (ts.mu, js.mu), (ts.nu, js.nu)):
            for a, b in zip(adamw.leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-12)


def test_schedule_matches_jax():
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_frac=0.1), dict(lr=3e-4, warmup_steps=0,
                                           total_steps=7)):
        cfg, jcfg = adamw.AdamWConfig(**kw), jax_adamw.AdamWConfig(**kw)
        for s in (0, 1, 5, 10, 11, 55, 99, 100, 130):
            np.testing.assert_allclose(
                float(adamw.schedule(cfg, s)),
                float(jax_adamw.schedule(jcfg, jnp.int32(s))), rtol=1e-6)


def test_adamw_init_like_params():
    params = build(get_arch(ARCH, smoke=True)).init(0, device="cpu",
                                                    trainable=True)
    st = adamw.adamw_init(params)
    assert int(st.step) == 0 and st.step.dtype == torch.int32
    for p, m, v in zip(params.parameters(), st.mu.parameters(),
                       st.nu.parameters()):
        assert m.shape == p.shape and m.dtype == p.dtype and not m.any()
        assert not m.requires_grad and not v.any()
    tree = {"b": torch.ones(3), "a": [torch.ones(2, 2), torch.ones(1)]}
    st = adamw.adamw_init(tree)
    assert [tuple(t.shape) for t in adamw.leaves(st.mu)] == [(2, 2), (1,),
                                                             (3,)]
    assert not any(t.any() for t in adamw.leaves(st.nu))


# ---------------------------------------------------------------------------
# the train step, 3 steps against the jitted JAX step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(jax_params, microbatches, impl):
    cfg_kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jm = jax_build(jax_get_arch(ARCH, smoke=True))
    jstep = jax.jit(jax_make_train_step(
        jm, jax_adamw.AdamWConfig(**cfg_kw), microbatches=microbatches,
        fwd_kw={"attn_impl": impl}))
    jp = jax.tree.map(jnp.asarray, jax_params)
    jstate = JaxTrainState(jp, jax_adamw.adamw_init(jp))
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate))
    step = make_train_step(build(get_arch(ARCH, smoke=True)),
                           adamw.AdamWConfig(**cfg_kw),
                           microbatches=microbatches,
                           fwd_kw={"attn_impl": impl})
    for t in range(3):
        batch = _batch(step=t)
        jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, met = step(state, _torch_batch(batch))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
    assert int(state.opt.step) == int(jstate.opt.step) == 3
    _assert_tree_close(jax_layout(state.params), jstate.params, PARAM_REL)
    assert all(p.grad is None for p in state.params.parameters())


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step,shard,shards", [(0, 0, 1), (3, 2, 4)])
def test_host_batch_bit_identical(step, shard, shards):
    kw = dict(vocab_size=97, seq_len=16, global_batch=8, seed=5)
    want = JaxSyntheticLM(**kw).host_batch(step, shard, shards)
    got = SyntheticLM(**kw).host_batch(step, shard, shards)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_zipf_transform_matches_jax():
    """JAX's device batch and the port's transform on JAX's uniforms."""
    d = JaxSyntheticLM(vocab_size=300, seq_len=64, global_batch=8, seed=3)
    want = d.device_batch(2)
    k = jax.random.fold_in(jax.random.key(3), 2)
    u = jax.random.uniform(k, (8, 65), jnp.float32, 1e-6, 1.0)
    z = zipf_tokens(torch.from_numpy(np.array(u)), 300).numpy()
    np.testing.assert_array_equal(z[:, :-1], np.asarray(want["tokens"]))
    np.testing.assert_array_equal(z[:, 1:], np.asarray(want["labels"]))
    assert z.max() < 300 and z.min() >= 0


def test_device_batch_deterministic():
    d = SyntheticLM(vocab_size=97, seq_len=16, global_batch=8, seed=5)
    a = d.device_batch(3, device="cpu")
    assert a["tokens"].shape == (8, 16) and a["tokens"].dtype == torch.int32
    assert torch.equal(a["tokens"], d.device_batch(3, device="cpu")["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert not torch.equal(a["tokens"], d.device_batch(4, device="cpu")[
        "tokens"])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32)}}
    ckpt.save(str(tmp_path), tree, 7, data_state={"seed": 3})
    like = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4,
                                                          dtype=torch.int32)}}
    out, step, ds = ckpt.restore(str(tmp_path), like)
    assert step == 7 and ds == {"seed": 3}
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["b"]["c"],
                                                            tree["b"]["c"])
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), {"a": torch.zeros(3, 2),
                                     "b": {"c": torch.zeros(4)}})


def test_checkpoint_partial_write_is_invisible(tmp_path):
    ckpt.save(str(tmp_path), {"a": torch.zeros(2)}, 1)
    os.makedirs(tmp_path / "step_00000002.tmp")  # simulated crash mid-save
    assert ckpt.latest_step(str(tmp_path)) == 1
    _, step, _ = ckpt.restore(str(tmp_path), {"a": torch.zeros(2)})
    assert step == 1


def test_checkpoint_gc_keeps_latest(tmp_path):
    for s in range(1, 6):
        t = ckpt.save(str(tmp_path), {"a": torch.zeros(2)}, s,
                      blocking=(s % 2 == 0))
        if t is not None:
            t.join()
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000003", "step_00000004", "step_00000005"]


def _random_jax_state(jax_params, seed):
    rng = np.random.default_rng(seed)
    rand = lambda t: jax.tree.map(  # noqa: E731
        lambda x: rng.normal(size=x.shape).astype(x.dtype), t)
    return JaxTrainState(jax_params, jax_adamw.AdamWState(
        np.asarray(7, np.int32), rand(jax_params), rand(jax_params)))


def test_checkpoint_jax_to_port(tmp_path, jax_params):
    state = _random_jax_state(jax_params, 1)
    jax_ckpt.save(str(tmp_path), state, 7, data_state={"next_step": 7})
    like = init_train_state(build(get_arch(ARCH, smoke=True)), 3,
                            device="cpu")
    got, step, ds = ckpt.restore(str(tmp_path), like)
    assert step == 7 and ds == {"next_step": 7}
    assert got.params is like.params
    assert all(p.requires_grad for p in got.params.parameters())
    want = train_state_from_jax(state)
    assert int(got.opt.step) == 7 and got.opt.step.dtype == torch.int32
    for a, b in ((got.params, want.params), (got.opt.mu, want.opt.mu),
                 (got.opt.nu, want.opt.nu)):
        x, y = dict(a.named_parameters()), dict(b.named_parameters())
        assert x.keys() == y.keys()
        assert all(torch.equal(x[k], y[k]) for k in x)


def test_checkpoint_port_to_jax(tmp_path, jax_params):
    state = train_state_from_jax(_random_jax_state(jax_params, 2))
    ckpt.save(str(tmp_path), state, 9, data_state={"seed": 0})
    jm = jax_build(jax_get_arch(ARCH, smoke=True))
    like = jax.eval_shape(lambda: JaxTrainState(
        values(jm.init(jax.random.key(0))),
        jax_adamw.adamw_init(values(jm.init(jax.random.key(0))))))
    got, step, ds = jax_ckpt.restore(str(tmp_path), like)
    assert step == 9 and ds == {"seed": 0} and int(got.opt.step) == 7
    for a, b in ((got.params, state.params), (got.opt.mu, state.opt.mu),
                 (got.opt.nu, state.opt.nu)):
        _assert_tree_close(jax_layout(b), a, 0.0)
    with open(tmp_path / "step_00000009" / "manifest.json") as f:
        assert json.load(f)["num_leaves"] == len(jax.tree.leaves(like))


# ---------------------------------------------------------------------------
# the trainer, the elastic policy and the launcher
# ---------------------------------------------------------------------------


def _trainer(tmp_path, steps, **kw):
    cfg = get_arch(ARCH, smoke=True)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=kw.pop("seq", 32),
                       global_batch=kw.pop("batch", 8), seed=0)
    return Trainer(build(cfg), data, "cpu",
                   adamw.AdamWConfig(**kw["opt"]),
                   TrainerConfig(steps=steps, log_every=1000,
                                 checkpoint_dir=str(tmp_path / "ck"),
                                 checkpoint_every=kw["every"]))


def test_trainer_loss_decreases(tmp_path):
    trainer = _trainer(tmp_path, 30, every=10,
                       opt=dict(lr=1e-2, warmup_steps=2, total_steps=30))
    _, history = trainer.run()
    first = np.mean([h["loss"] for h in history[:5]])
    last = np.mean([h["loss"] for h in history[-5:]])
    assert last < first - 0.1, f"no learning: {first:.3f} -> {last:.3f}"
    assert ckpt.latest_step(str(tmp_path / "ck")) == 30
    assert [h["step"] for h in history] == list(range(1, 31))


def test_trainer_restart_resumes(tmp_path):
    mk = lambda steps: _trainer(  # noqa: E731
        tmp_path, steps, every=5, seq=16, batch=4,
        opt=dict(lr=1e-3, total_steps=20))
    state10, _ = mk(10).run()
    assert ckpt.latest_step(str(tmp_path / "ck")) == 10
    t2 = mk(12)
    state, start = t2.init_or_restore()
    assert start == 10 and int(state.opt.step) == 10
    for a, b in zip(adamw.leaves(state.params),
                    adamw.leaves(state10.params)):
        assert torch.equal(a, b)
    _, hist = t2.run(state, start)
    assert [h["step"] for h in hist] == [11, 12]


def test_elastic_copy_matches_jax():
    for n, mp, pods in ((512, 16, 2), (496, 16, None), (64, 8, 3)):
        got = elastic.plan_restart(n, model_parallel=mp, want_pods=pods)
        want = jax_elastic.plan_restart(n, model_parallel=mp,
                                        want_pods=pods)
        assert (got.shape, got.axes, got.devices_used) == (
            want.shape, want.axes, want.devices_used)
    assert elastic.rebalance_batch(100, 7) == jax_elastic.rebalance_batch(
        100, 7)
    mon = elastic.StragglerMonitor(window=4, threshold=2.0)
    for r in range(4):
        for _ in range(4):
            mon.record(r, 1.0 if r != 3 else 5.0)
    assert mon.stragglers() == [3]


def test_launch_train_main(tmp_path, capsys):
    argv = ["--arch", ARCH, "--smoke", "--steps", "4", "--batch", "2",
            "--seq", "8", "--device", "cpu", "--ckpt", str(tmp_path),
            "--ckpt-every", "2"]
    assert launch_train.main(argv) == 0
    assert "final loss" in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path)) == 4
    # a mesh of 4 ranks needs a process group of 4: torchrun's
    with pytest.raises(ValueError, match="torchrun"):
        launch_train.main(argv + ["--mesh", "2x2"])
