"""Storage, placement and execution of the node-stacked cluster.

Submodules:
  compression   fixed-width bit packing and packed bitsets (§3.2.1)
  partitioning  range + co-partitioning (§3.1)
  columnar      node-stacked column store, PackedColumn residency
  engine        Cluster / PlanContext / psum
  aggregation   grouped aggregation (§4.3)
  scancal       roofline choice of packed vs decode scans
"""
