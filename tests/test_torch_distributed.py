"""The port's cluster across processes: W gloo ranks on the CPU, each
holding L = P / W of the P = 8 nodes, against the one-process port, the
JAX package and the float64 oracle.

Four spawns of ``tests/fixtures/torch_dist_worker.py`` run at once, all
ranks with one fixed ``PYTHONHASHSEED`` except where the seeds must
differ:

- ``w4`` (W = 4, L = 2): every collective of ``exchange`` and ``psum``
  on inputs made from a numpy seed, every query of the slice, and the
  OLAP tier: the cubes, prepared batches, EXPLAIN ANALYZE, the serving
  engine (rank 0 leads, the others follow) and ``serve_olap`` with
  ``--serve``, ``--cubes`` and ``--lint``;
- ``w2`` (W = 2, L = 4): the queries and the OLAP tier, the collectives
  over a gloo group of one rank (W = 1, L = 8), and, on rank 0 after the
  group is gone, the one-process port driver, the JAX driver (the
  8-device CPU mesh) and the oracle on the same tables;
- ``mismatch`` (W = 2, two ``PYTHONHASHSEED`` values): the driver must
  raise;
- ``keepalive`` (W = 2): a driver over a group whose timeout is 3 s; rank
  0's engine idles 10 s, then serves one request.

Each collective is held against the same function over all P nodes in
this process: outputs, ``wire_bytes()`` and the collective record equal
(f32 sums within rtol 1e-5: another order).  Each query gives the same
answer on every rank, bit for bit; it equals the one-process port and
the JAX driver exactly in integers, keys, bitsets and bytes and within
rtol 1e-5 in f32, the oracle within rtol 2e-4 (exactly for counts), and
its per-node wire bytes and collective record equal one process's.
Every rank's cubes equal the one-process port's (counts, rows, min and
max exactly, sums within rtol 1e-5) and the JAX package's; batches and
EXPLAIN ANALYZE's semi-join bytes equal the one-process port's (q6_param
also the JAX batch); the leader's answers equal the ranks' sequential
executes of the same requests byte for byte, tier 1 and tier 2 alike (a
float sum across the ranks folds their partials in rank order, so a
coalesced lane sums as the request run alone does), except a coalesced
``q1_offedge`` lane, the lane-mask product, within rtol 2e-4; they equal
one process's as a query does; every follower ran every dispatch the
leader published.  A leader idle for longer than the group's timeout
keeps its followers (keep-alives), and they run its next request.  The
spawns are bounded: a hang fails the test, the init timeout ends the
ranks.  The keep-alive spawn's failure fails only its own test.
"""
from __future__ import annotations

import os
import pathlib
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

from conftest import assert_topk_matches
from fixtures import torch_dist_worker as worker
from repro_torch.tpch import cubes as tpch_cubes

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "fixtures" / "torch_dist_worker.py"
HASH_SEED = "20171"
SPAWNS = {"w4": (4, [HASH_SEED] * 4), "w2": (2, [HASH_SEED] * 2),
          "mismatch": (2, ["1", "2"]), "keepalive": (2, [HASH_SEED] * 2)}
TIMEOUT_S = 300


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn's per-rank results, the spawns running at once."""
    src = str(ROOT / "src")
    base = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
                XLA_FLAGS="--xla_force_host_platform_device_count=8",
                PYTHONPATH=os.pathsep.join(
                    [src] + [p for p in os.environ.get("PYTHONPATH", "")
                             .split(os.pathsep) if p]))
    procs = {}
    for spawn, (world, seeds) in SPAWNS.items():
        out = tmp_path_factory.mktemp(spawn)
        for rank in range(world):
            log = open(out / f"rank{rank}.log", "w")
            procs[(spawn, rank)] = (out, log, subprocess.Popen(
                [sys.executable, str(WORKER), spawn, str(rank), str(world),
                 str(out / "store"), str(out)],
                env=dict(base, PYTHONHASHSEED=seeds[rank]),
                stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for out, log, p in procs.values():
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the ranks did not finish within {TIMEOUT_S} s")
    finally:
        for out, log, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    res = {spawn: [] for spawn in SPAWNS}
    for (spawn, rank), (out, log, p) in sorted(procs.items()):
        text = (out / f"rank{rank}.log").read_text()[-4000:]
        path = out / f"rank{rank}.pkl"
        if spawn == "keepalive":  # its own test reads how it ended
            res[spawn].append((p.returncode, text, path))
            continue
        assert p.returncode == 0 and path.exists(), (
            f"{spawn} rank {rank} exited {p.returncode}:\n{text}")
        with open(path, "rb") as f:
            r = pickle.load(f)
        assert "error" not in r, f"{spawn} rank {rank}:\n{r['error']}"
        res[spawn].append(r)
    return res


def _assert_close(got: dict, want: dict, what: str, rtol: float = 1e-5):
    """Integers, keys, bitsets exactly; f32 within ``rtol``."""
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = np.asarray(got[k])
        w = np.asarray(w)
        assert g.shape == w.shape, f"{what} {k}: {g.shape} vs {w.shape}"
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0,
                                       err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


# -- (a) the collectives ------------------------------------------------------

REPLICATED = {"psum_f32", "psum_i64", "allreduce_max", "allreduce_min"}


@pytest.mark.parametrize("group", ["w4", "w1"])
@pytest.mark.parametrize("case", worker.CASE_NAMES)
def test_collective_matches_node_stacked(runs, case, group):
    ranks = ([r["collectives"]["default"][case] for r in runs["w4"]]
             if group == "w4" else
             [runs["w2"][0]["collectives"]["single"][case]])
    want, want_bytes, want_record = worker.run_case(
        case, worker.case_inputs(case))
    for rank, (out, nbytes, record) in enumerate(ranks):
        assert nbytes == want_bytes, f"rank {rank}"
        assert record == want_record, f"rank {rank}"
    if case in REPLICATED:
        for rank, (out, _, _) in enumerate(ranks):
            _assert_close(out, ranks[0][0], f"rank {rank} vs rank 0",
                          rtol=0)
        got = ranks[0][0]
    else:
        got = {k: np.concatenate([out[k] for out, _, _ in ranks])
               for k in want}
    _assert_close(got, want, case)


# -- (b) the slice --------------------------------------------------------------

TOPK_FIELDS = {"q18": ("out.values", "out.keys", "out.valid"),
               "q3_lazy": ("out.0.values", "out.0.keys", "out.0.valid"),
               "q15_approx": ("out.total_revenue", "out.s_suppkey",
                              "out.valid"),
               "q21": ("out.values", "out.keys", "out.valid")}


def _assert_oracle(name: str, got: dict, oracle) -> None:
    for k, v in got.items():
        if k == "out.overflow" or k.endswith(".overflow") or k == "out.1":
            assert not bool(np.asarray(v).any()), f"{name}: {k}"
    if name in TOPK_FIELDS:
        vals, keys, valid = (got[f] for f in TOPK_FIELDS[name])
        ov, ok = oracle
        n = int(valid.sum())
        assert n > 0 and n == min(int(np.isfinite(ov).sum()), len(vals))
        exact = name in ("q18", "q21")
        assert_topk_matches(vals, keys, valid, ov, ok,
                            rtol=0 if exact else 2e-4, atol=0)
        np.testing.assert_array_equal(keys[:n], ok[:n])
        return
    value = np.asarray(got["out.value"], np.float64).reshape(-1)
    want = np.asarray(oracle, np.float64).reshape(-1)
    if name.startswith("q4"):
        np.testing.assert_array_equal(value, want)
    else:
        np.testing.assert_allclose(value, want, rtol=2e-4, atol=0)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(worker.QUERIES))
def test_query_matches_one_process_jax_and_oracle(runs, name, world):
    ranks = runs[f"w{world}"]
    ref = runs["w2"][0]["reference"]
    assert [r["local_nodes"] for r in ranks] == [8 // world] * world
    outs = [r["queries"][name] for r in ranks]
    got, nbytes, record = outs[0]
    for rank, (out, b, rec) in enumerate(outs[1:], start=1):
        _assert_close(out, got, f"rank {rank} vs rank 0", rtol=0)
        assert (b, rec) == (nbytes, record), f"rank {rank}"
    port, port_bytes, port_record = ref["port"][name]
    assert nbytes == port_bytes
    assert record == port_record
    _assert_close(got, port, "one-process port")
    _assert_close(got, ref["jax"][name], "JAX driver")
    _assert_oracle(name, got, ref["oracle"][name])


# -- (c) the OLAP tier across ranks ------------------------------------------------

def _olap(runs, world: int) -> tuple:
    """Every rank's OLAP record of spawn ``w{world}``, and the one-process
    reference's."""
    return ([r["olap"] for r in runs[f"w{world}"]],
            runs["w2"][0]["reference"]["olap"])


AGGS = {spec.name: {**{m.name: m.agg for m in spec.measures},
                    "__rows": "count"}
        for spec in tpch_cubes.default_specs()}


def _hold_cubes(got: dict, want: dict, what: str, sum_rtol: float = 1e-5):
    """Every rollup of every cube: sums within ``sum_rtol``; counts, rows,
    min and max (the +-inf of empty cells too) exactly."""
    assert sorted(got) == sorted(want) == sorted(AGGS), what
    for name, (rows, rollups) in want.items():
        got_rows, got_rollups = got[name]
        assert got_rows == rows, f"{what} {name}: rows scanned"
        assert sorted(got_rollups) == sorted(rollups), f"{what} {name}"
        for dims, arrays in rollups.items():
            assert sorted(got_rollups[dims]) == sorted(arrays)
            for m, w in arrays.items():
                g = got_rollups[dims][m]
                assert g.shape == w.shape, f"{what} {name} {dims} {m}"
                if AGGS[name][m] == "sum":
                    np.testing.assert_allclose(
                        g, w, rtol=sum_rtol, atol=0,
                        err_msg=f"{what} {name} {dims} {m}")
                else:
                    np.testing.assert_array_equal(
                        g, w, err_msg=f"{what} {name} {dims} {m}")


@pytest.mark.parametrize("world", [2, 4])
def test_cubes_match_one_process_and_jax(runs, world):
    ranks, ref = _olap(runs, world)
    for rank, o in enumerate(ranks):
        _hold_cubes(o["cubes"], ref["cubes"], f"rank {rank}")
    _hold_cubes(ranks[0]["cubes"], ref["jax_cubes"], "JAX build_cube")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(worker.BATCHES))
def test_batch_matches_one_process(runs, name, world):
    ranks, ref = _olap(runs, world)
    want, want_overflow = ref["batches"][name]
    assert want_overflow.shape == (worker.BATCH_LANES,)
    assert not want_overflow.any()
    for rank, o in enumerate(ranks):
        got, overflow = o["batches"][name]
        _assert_close(got, want, f"rank {rank} {name}")
        np.testing.assert_array_equal(overflow, want_overflow)
    if name == "q6_param":
        _assert_close(ranks[0]["batches"][name][0], ref["jax_q6_param"],
                      "the JAX execute_batch")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", worker.EXPLAINED)
def test_explain_analyze_bytes_match_one_process(runs, name, world):
    ranks, ref = _olap(runs, world)
    tier, overflow, a2a = ref["explain"][name]
    assert tier == 2 and not overflow
    assert len(a2a) == 1 and a2a[0] > 0
    for rank, o in enumerate(ranks):
        assert o["explain"][name] == (tier, overflow, a2a), f"rank {rank}"


def _same_bytes(got: dict, want: dict) -> bool:
    return sorted(got) == sorted(want) and all(
        got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        and got[k].tobytes() == want[k].tobytes() for k in want)


@pytest.mark.parametrize("world", [2, 4])
def test_engine_leads_and_ranks_follow(runs, world):
    ranks, ref = _olap(runs, world)
    lead = ranks[0]["engine"]
    assert lead["failed"] == 0, [a for a in lead["answers"] if len(a) == 3]
    assert len(lead["answers"]) == len(ref["sequential"]) == \
        worker.ENGINE_ITEMS
    for i, (got, seq, one) in enumerate(zip(
            lead["answers"], lead["sequential"], ref["sequential"])):
        kind, name, tier, value, overflow = got
        what = f"request {i} ({name})"
        assert (tier, overflow) == (seq[0], False) and not seq[2], what
        assert (tier, overflow) == (one[0], False) and not one[2], what
        # tier 1 reads the same cube as the execute did; a tier-2 lane
        # sums across the ranks in rank order wherever it lies in the
        # batch; a coalesced q1_offedge lane is the lane-mask product
        rtol = 2e-4 if kind == "tier2" else 1e-5
        if kind == "tier2":
            _assert_close(value, seq[1], what, rtol=rtol)
        else:
            assert _same_bytes(value, seq[1]), what
        _assert_close(value, one[1], f"{what}, one process", rtol=rtol)
    assert lead["published"] > 0
    assert lead["dist_calls"]["descriptor"] == lead["published"] + 1
    for rank, o in enumerate(ranks[1:], start=1):
        assert o["engine"]["followed"] == lead["published"], f"rank {rank}"
        assert o["engine"]["dist_calls"] == lead["dist_calls"], \
            f"rank {rank}"


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", list(worker.LAUNCHER))
def test_serve_olap_mode_runs_across_ranks(runs, mode, world):
    ranks, ref = _olap(runs, world)
    outs = [o["launcher"][mode] for o in ranks]
    assert [rc for rc, _ in outs] == [0] * world
    assert [text for _, text in outs[1:]] == [""] * (world - 1)
    text = outs[0][1]
    assert text.count("cluster: 8 nodes") == 1, text
    if mode == "--serve":
        assert "(0 failed)" in text and "rejected 0" in text, text
    elif mode == "--cubes":
        for name, (rows, _) in ref["cubes"].items():
            assert f"cube {name}: " in text and f"from {rows} rows" in text
        for name in tpch_cubes.SERVING_QUERIES:
            assert f"{name:>22s} " in text, text
    else:
        assert "plans verified, 0 with errors/warnings" in text, text


def test_idle_leader_keeps_its_followers(runs):
    ranks = []
    for rank, (rc, text, path) in enumerate(runs["keepalive"]):
        assert rc == 0 and path.exists(), f"rank {rank} exited {rc}:\n{text}"
        with open(path, "rb") as f:
            r = pickle.load(f)
        assert "error" not in r, f"rank {rank}:\n{r['error']}"
        ranks.append(r["keepalive"])
    lead = ranks[0]
    assert lead["timeout_s"] == worker.KEEPALIVE_TIMEOUT_S
    # a keep-alive every quarter of the timeout while the engine idles
    assert lead["keepalives"] >= worker.KEEPALIVE_IDLE_S / (
        worker.KEEPALIVE_TIMEOUT_S / 4) - 2, lead["keepalives"]
    assert lead["published"] == 1
    assert lead["dist_calls"]["descriptor"] == (
        lead["published"] + lead["keepalives"] + 1)
    tier, value, overflow = lead["answer"]
    want_tier, want, want_overflow = lead["sequential"]
    assert (tier, overflow) == (want_tier, want_overflow) == (2, False)
    assert _same_bytes(value, want)
    for rank, o in enumerate(ranks[1:], start=1):
        assert o["followed"] == lead["published"], f"rank {rank}"
        assert o["dist_calls"] == lead["dist_calls"], f"rank {rank}"
        assert _same_bytes(o["sequential"][1], want), f"rank {rank}"


# -- (d) what raises --------------------------------------------------------------

@pytest.mark.parametrize("what", ["p_mod_w", "gloo_on_cuda"])
def test_raises_rather_than_falls_back(runs, what):
    for spawn in ("w2", "w4"):
        for r in runs[spawn]:
            msg = r["errors"][what]
            if what == "p_mod_w":
                assert msg.startswith("ValueError") and "P % W" in msg
            else:
                assert msg.startswith("ValueError") and "nccl" in msg


def test_ranks_with_other_data_raise(runs):
    for r in runs["mismatch"]:
        assert r["mismatch"].startswith("ValueError"), r["mismatch"]
        assert "PYTHONHASHSEED" in r["mismatch"]
