"""Storage, placement and execution of the node-stacked cluster.

Submodules:
  compression   fixed-width bit packing and packed bitsets (§3.2.1)
  partitioning  range + co-partitioning (§3.1)
  columnar      node-stacked column store, PackedColumn residency
  engine        Cluster / PlanContext / psum
  exchange      collectives, personalized all-to-all, wire formats,
                request/reply (§3.2.2, §3.2.6)
  semijoin      Alt-1 request and Alt-2 bitset semi-joins (§3.2.2)
  topk          per-node top-k and the merging reduction (§3.2.3)
  late_materialization  fetch of output-only attributes (§3.2.7)
  aggregation   grouped aggregation (§4.3)
  scancal       roofline choice of packed vs decode scans
"""
