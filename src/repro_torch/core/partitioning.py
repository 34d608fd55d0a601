"""Range partitioning and co-partitioning (paper §3.1), node-stacked.

Counterpart of ``repro.core.partitioning``.  All tables are range-partitioned
on their primary key: node i owns keys ``[i * rows_per_node, (i+1) *
rows_per_node)`` (0-based dense keys).  In the node-stacked cluster every
per-node quantity carries a leading node axis, so ``my_base`` is the column
``node_ids[:, None] * rows_per_node`` instead of one device's scalar: the
ids of the nodes this process holds (``engine.node_ids``; all P of them
in-process).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RangePartitioning:
    """``total_rows`` dense keys split evenly over ``num_nodes``."""

    total_rows: int
    num_nodes: int

    @property
    def rows_per_node(self) -> int:
        if self.total_rows % self.num_nodes:
            raise ValueError(
                f"range partitioning requires divisible sizes, got "
                f"{self.total_rows} rows over {self.num_nodes} nodes")
        return self.total_rows // self.num_nodes

    def owner(self, key):
        """Node that stores the row with this 0-based dense key."""
        return key // self.rows_per_node

    def local_index(self, key):
        """Row index of ``key`` within its owner's partition."""
        return key % self.rows_per_node

    def base(self, node):
        """First key owned by ``node``."""
        return node * self.rows_per_node

    def my_base(self, device=None) -> torch.Tensor:
        """First key owned by each local node: (L, 1) int64."""
        from repro_torch.core.engine import node_ids  # engine imports us

        return (node_ids(self.num_nodes, device)[:, None]
                * self.rows_per_node)

    def global_keys(self, device=None) -> torch.Tensor:
        """Dense keys of each local node's partition: (L, rows_per_node)
        int64."""
        return self.my_base(device) + torch.arange(self.rows_per_node,
                                                   device=device)


def copartitioned(parent: RangePartitioning,
                  child_fanout: int) -> RangePartitioning:
    """Partitioning of a child table with exactly ``child_fanout`` rows per
    parent row, co-partitioned with ``parent`` (partsupp: 4 per part)."""
    return RangePartitioning(parent.total_rows * child_fanout,
                             parent.num_nodes)
