"""Quickstart for the PyTorch port: the paper's hand-written plans on an
8-node cluster stacked on one device, each checked against the float64
oracle.

Generates TPC-H data per node, runs every registered hand plan through
``TPCHDriver.run(name)`` — the local ones (Q1, Q4, Q6, Q18), the semi-join
plans (§3.2.2: Q2, Q3 three ways, Q5, Q11, Q13, Q14) and the distributed
top-k ones (§3.2.5: Q15, Q21) — and holds each answer to its oracle.  Then
it prepares Q6 once (the paper's compile-once model), executes it at two
TPC-H substitution bindings and runs both as one batch.  On the CPU (the
default here) the kernels run their plain PyTorch versions; ``--device
cuda`` runs the CUDA kernels on a GPU.

    PYTHONPATH=src python examples/quickstart_torch.py [--sf 0.02]
"""
import argparse
import time

import numpy as np


def _parts(name, out):
    """(value, overflow) of a plan's raw result: a dict, a (value,
    overflow) pair or a bare value."""
    if isinstance(out, dict):
        out = dict(out)
        return out, bool(out.pop("overflow", False))
    if isinstance(out, tuple) and len(out) == 2 and not hasattr(out,
                                                                "_fields"):
        return out[0], bool(out[1])
    return out, False


def _topk(name, value):
    """(values, keys, valid) of a top-k answer."""
    if isinstance(value, dict):
        fields = {"q2": ("s_acctbal", "part_supp_key"),
                  "q18": ("o_totalprice", "o_orderkey")}.get(
            name, ("total_revenue", "s_suppkey"))
        return tuple(np.asarray(value[f].cpu()) for f in fields + ("valid",))
    return tuple(np.asarray(a.cpu()) for a in value)


def check(driver, name) -> str:
    value, overflow = _parts(name, driver.run(name))
    assert not overflow, f"{name}: an exchange buffer overflowed"
    oracle = driver.oracle(name)
    if isinstance(oracle, tuple):                 # a ranked top-k
        v, keys, valid = _topk(name, value)
        n = int(valid.sum())
        ov, ok = oracle
        assert n == min(int(np.isfinite(ov).sum()), len(v))
        np.testing.assert_allclose(v[:n], ov[:n], rtol=2e-4)
        # f32 sums against float64: keys may swap only where values tie
        tied = np.isclose(ov[:n, None], ov[None, :n], rtol=2e-4).sum(1) > 1
        assert (keys[:n] == ok[:n])[~tied].all(), name
        return f"top {n}: keys {keys[:min(n, 3)].tolist()}"
    got = np.asarray(value.cpu(), np.float64)
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=1e-2)
    head = np.round(got.ravel()[:3], 1).tolist()
    return f"{got.size} values, first {head}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=0.02)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)

    from repro_torch.core.plans import PLANS
    from repro_torch.tpch.driver import TPCHDriver

    t0 = time.monotonic()
    driver = TPCHDriver(args.sf, num_nodes=8, seed=0, device=args.device)
    print(f"cluster: {driver.cluster.num_nodes} nodes stacked on "
          f"{driver.cluster.device} | SF {args.sf} | lineitem rows: "
          f"{driver.tables['lineitem'].num_rows} | generated in "
          f"{time.monotonic() - t0:.1f} s")
    for name in sorted(PLANS):
        t0 = time.monotonic()
        what = check(driver, name)
        print(f"  {name:12s} {what}  ({(time.monotonic() - t0) * 1e3:.0f} "
              f"ms incl. the oracle)")

    # a prepared statement: one lowered plan, any binding
    from repro_torch.tpch import queries as tq

    prep = driver.prepare(tq.q6_param_ir())
    bindings = [tq.default_binding("q6"),
                tq.random_binding("q6", np.random.default_rng(1))]
    for b in bindings:
        ans = prep.execute(b)
        want = driver.oracle("q6", p=tq.oracle_params("q6", b))
        np.testing.assert_allclose(float(ans.value), want, rtol=2e-4)
        print(f"  q6_param     {b} -> {float(ans.value):.1f}")
    batch = prep.execute_batch(bindings)
    for i, b in enumerate(bindings):
        assert float(batch.value[i]) == float(prep.execute(b).value)
    print(f"  q6_param     batch of {len(bindings)} lanes "
          f"{batch.value.reshape(-1).tolist()}, equal to the executes; "
          f"lowerings {driver.compile_events}")
    print("\nall results oracle-checked")


if __name__ == "__main__":
    main()
