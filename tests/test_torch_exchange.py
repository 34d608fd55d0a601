"""The port's exchange layer on the node-stacked cluster against the JAX
package's SPMD exchanges: the personalized all-to-all on both backends,
the request/reply exchange on the packed and raw wires, the Alt-2 bitset
semi-join, and the top-k merging reduction."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.core import exchange as jex
from repro.core import semijoin as jsj
from repro.core import topk as jtopk
from repro.core.partitioning import RangePartitioning as JaxPart
from repro_torch.core import exchange, semijoin, topk
from repro_torch.core.engine import psum
from repro_torch.core.partitioning import RangePartitioning
from repro_torch.kernels import ops

AXIS = "nodes"


def _spmd(cluster, fn, *arrays):
    f = jax.jit(jax.shard_map(fn, mesh=cluster.mesh,
                              in_specs=tuple(JP(AXIS) for _ in arrays),
                              out_specs=JP(), check_vma=False))
    return jax.tree.map(np.asarray, f(*arrays))


@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.int32, torch.bool])
def test_all_to_all_one_factor_equals_xla(P, dtype):
    x = torch.randint(0, 2 ** 20, (P, P, 5, 3)).to(dtype)
    exchange.reset_wire_bytes()
    a = exchange.all_to_all(x, backend="xla")
    b = exchange.all_to_all(x, backend="one_factor")
    assert torch.equal(a, b)
    assert torch.equal(a, x.transpose(0, 1))
    # each node injects its own (P, 5, 3) operand, twice
    assert (exchange.wire_bytes()["all-to-all"]
            == 2 * P * 5 * 3 * x.element_size())
    with pytest.raises(ValueError, match="backend"):
        exchange.all_to_all(x, backend="ring")


def test_collectives_over_the_node_axis():
    x = torch.tensor([[1, 5], [4, 2], [3, 9]])
    assert torch.equal(psum(x), torch.tensor([8, 16]))
    assert torch.equal(exchange.allreduce_max(x), torch.tensor([4, 9]))
    assert torch.equal(exchange.allreduce_min(x), torch.tensor([1, 2]))
    assert torch.equal(exchange.broadcast_from(x, 2),
                       torch.tensor([[3, 9]] * 3))
    exchange.reset_wire_bytes()
    got = exchange.allgather(x.to(torch.int32))
    assert torch.equal(got, torch.tensor([[1, 5, 4, 2, 3, 9]] * 3,
                                         dtype=torch.int32))
    assert exchange.wire_bytes() == {"all-to-all": 0, "all-gather": 8}
    with pytest.raises(ValueError, match="power-of-two"):
        topk.topk_allreduce(topk.local_topk(x.float(), x, 1))


def _request_case(Pn, seed):
    rows = 32
    total = Pn * rows
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, total, Pn * 48).astype(np.int32)
    mask = rng.random(Pn * 48) < 0.8
    attr = (rng.random(total) < 0.3).astype(np.int32)
    return total, keys, mask, attr


@pytest.mark.parametrize("reply", ["bool", "int32"])
def test_request_reply_matches_jax(cluster, reply):
    """Packed equals raw on both backends, and both equal the JAX
    package's SPMD exchange on the same inputs."""
    Pn = cluster.num_nodes
    total, keys, mask, attr = _request_case(Pn, seed=11)
    jpart = JaxPart(total, Pn)
    jwf = jex.WireFormat.packed_for(total, Pn)
    rdt = jnp.bool_ if reply == "bool" else jnp.int32

    def fn(k, m, a):
        def lookup(req, req_mask):
            bits = a[jpart.local_index(req)] == 1
            if reply == "bool":
                return bits & req_mask
            return jnp.where(req_mask & bits, req * 3 + 1, 0)

        rep, _ = jex.request_reply(k, m, jpart.owner(k), lookup,
                                   capacity=128, axis=AXIS, wire=jwf,
                                   reply_dtype=rdt)
        return jax.lax.all_gather(rep, AXIS, tiled=True)

    want = _spmd(cluster, fn, jnp.asarray(keys), jnp.asarray(mask),
                 jnp.asarray(attr)).reshape(Pn, -1)

    part = RangePartitioning(total, Pn)
    t_attr = torch.from_numpy(attr).reshape(Pn, -1)

    def lookup(req, req_mask):
        bits = torch.gather(t_attr, 1, part.local_index(req).long()) == 1
        if reply == "bool":
            return bits & req_mask
        return torch.where(req_mask & bits, req * 3 + 1, 0)

    k = torch.from_numpy(keys).reshape(Pn, -1)
    m = torch.from_numpy(mask).reshape(Pn, -1)
    tdt = torch.bool if reply == "bool" else torch.int32
    ops.reset_launch_counts()
    for backend in ("xla", "one_factor"):
        for wire in (exchange.WireFormat.raw(),
                     exchange.WireFormat.packed_for(total, Pn)):
            got, ovf = exchange.request_reply(
                k, m, part.owner(k), lookup, capacity=128, backend=backend,
                reply_dtype=tdt, wire=wire)
            assert not bool(ovf)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{backend} {wire.kind}")
    assert all(v == 0 for v in ops.launch_counts().values())


def test_request_reply_reports_overflow():
    Pn, cap = 4, 3
    part = RangePartitioning(Pn * 10, Pn)
    keys = torch.zeros((Pn, 6), dtype=torch.int32)   # six keys for node 0
    mask = torch.ones((Pn, 6), dtype=torch.bool)
    for wire in (exchange.WireFormat.raw(),
                 exchange.WireFormat.packed_for(Pn * 10, Pn)):
        _, ovf = exchange.request_reply(
            keys, mask, part.owner(keys), lambda r, m: m, capacity=cap,
            reply_dtype=torch.bool, wire=wire)
        assert bool(ovf), wire.kind
        _, ovf = exchange.request_reply(
            keys, mask, part.owner(keys), lambda r, m: m, capacity=6,
            reply_dtype=torch.bool, wire=wire)
        assert not bool(ovf), wire.kind


def test_alt2_bitset_matches_jax(cluster):
    Pn = cluster.num_nodes
    rows = 45                                   # pads to 64 bits per node
    rng = np.random.default_rng(5)
    bits = rng.random(Pn * rows) < 0.4
    keys = rng.integers(0, Pn * rows, Pn * 20).astype(np.int32)
    jpart = JaxPart(Pn * rows, Pn)

    def fn(b, k):
        words = jsj.alt2_bitset(b, axis=AXIS)
        return (words, jax.lax.all_gather(jsj.probe(words, k, jpart), AXIS,
                                          tiled=True))

    jwords, jprobe = _spmd(cluster, fn, jnp.asarray(bits), jnp.asarray(keys))
    exchange.reset_wire_bytes()
    words = semijoin.alt2_bitset(torch.from_numpy(bits).reshape(Pn, rows))
    assert exchange.wire_bytes()["all-gather"] == 2 * 4   # 2 words a node
    for p in range(Pn):
        np.testing.assert_array_equal(
            words[p].numpy().astype(np.int32).view(np.uint32), jwords)
    got = semijoin.probe(words, torch.from_numpy(keys).reshape(Pn, -1),
                         RangePartitioning(Pn * rows, Pn))
    np.testing.assert_array_equal(got.numpy().reshape(-1), jprobe)
    np.testing.assert_array_equal(got.numpy().reshape(-1), bits[keys])


# -- top-k ------------------------------------------------------------------


def _topk_lists(seed, k=8, rows=2):
    """Node-stacked descending k-lists with distinct keys, some invalid."""
    rng = np.random.default_rng(seed)
    keys = rng.permutation(1000)[:rows * 2 * k].reshape(2, rows, k)
    vals = np.round(rng.random((2, rows, k)) * 20).astype(np.float32)
    valid = rng.random((2, rows, k)) < 0.8
    out = []
    for i in range(2):
        t = topk.local_topk(torch.from_numpy(vals[i]),
                            torch.from_numpy(keys[i]), k,
                            torch.from_numpy(valid[i]))
        out.append(t)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_merge_topk_is_commutative(seed):
    a, b = _topk_lists(seed)
    ab, ba = topk.merge_topk(a, b), topk.merge_topk(b, a)
    for x, y in zip(ab, ba):
        assert torch.equal(x, y)


@pytest.mark.parametrize("with_mask", [False, True])
def test_local_topk_matches_jax(with_mask):
    rng = np.random.default_rng(7)
    n, k = 300, 20
    vals = np.round(rng.random(n) * 50).astype(np.float32)  # many ties
    keys = rng.permutation(n).astype(np.int32)
    mask = rng.random(n) < 0.6 if with_mask else None
    want = jtopk.local_topk(jnp.asarray(vals), jnp.asarray(keys), k,
                            None if mask is None else jnp.asarray(mask))
    got = topk.local_topk(torch.from_numpy(vals)[None],
                          torch.from_numpy(keys)[None], k,
                          None if mask is None
                          else torch.from_numpy(mask)[None])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def test_topk_allreduce_equals_gather():
    rng = np.random.default_rng(9)
    P, n, k = 8, 50, 10
    vals = torch.from_numpy(rng.random((P, n)).astype(np.float32))
    keys = torch.arange(P * n).reshape(P, n)
    mask = torch.from_numpy(rng.random((P, n)) < 0.5)
    local = topk.local_topk(vals, keys, k, mask)
    merged = topk.topk_allreduce(local)
    gathered = topk.topk_gather(local)
    for m, g in zip(merged, gathered):
        assert torch.equal(m, g.expand(P, k))     # every node has it
    order = np.lexsort((keys.numpy().ravel(), -vals.numpy().ravel(),
                        ~mask.numpy().ravel()))[:k]
    np.testing.assert_array_equal(gathered.keys.numpy(),
                                  keys.numpy().ravel()[order])
