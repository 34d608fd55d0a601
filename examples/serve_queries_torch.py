"""Serve batched analytical queries on the PyTorch port (counterpart of
``examples/serve_queries.py``): 13 hand plans bound once, then served in
rounds, with per-query latencies and the sustained throughput.

    PYTHONPATH=src python examples/serve_queries_torch.py [--sf 0.05] \
        [--rounds 5] [--device cuda]

``--device cpu`` runs the kernels' plain PyTorch versions.
"""
import argparse
import time

WORKLOAD = ["q1", "q4", "q6", "q18", "q3", "q3_lazy", "q14", "q15_approx",
            "q2", "q5", "q11", "q13", "q21_late"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=0.05)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", type=str, default=None,
                    help="device the cluster runs on (default: cuda)")
    args = ap.parse_args()

    import torch

    from repro_torch.tpch.driver import TPCHDriver

    driver = TPCHDriver(sf=args.sf, seed=0, device=args.device)
    device = driver.cluster.device

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cols = driver.columns()
    print(f"serving {len(WORKLOAD)} query types on "
          f"{driver.cluster.num_nodes} nodes ({device}), SF {args.sf}")

    # bind once (the paper's precompiled plans), warm, then serve rounds
    fns = {}
    t0 = time.monotonic()
    for q in WORKLOAD:
        fns[q] = driver.compile(q)
        fns[q](cols)
    sync()
    print(f"bound and warmed {len(fns)} plans in "
          f"{time.monotonic() - t0:.1f}s\n")

    lat = {q: [] for q in WORKLOAD}
    t_start = time.monotonic()
    for _ in range(args.rounds):
        for q in WORKLOAD:
            t0 = time.monotonic()
            fns[q](cols)
            sync()
            lat[q].append((time.monotonic() - t0) * 1e3)
    wall = time.monotonic() - t_start
    total = args.rounds * len(WORKLOAD)
    print(f"{'query':>10s} {'p50 ms':>8s} {'best ms':>8s}")
    for q in WORKLOAD:
        s = sorted(lat[q])
        print(f"{q:>10s} {s[len(s)//2]:8.2f} {s[0]:8.2f}")
    print(f"\nthroughput: {total/wall:.1f} queries/s over {total} queries "
          f"({wall:.1f}s wall)")


if __name__ == "__main__":
    main()
