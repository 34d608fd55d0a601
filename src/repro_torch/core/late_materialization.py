"""Late materialization of output-only attributes (paper §3.2.7),
node-stacked.

Counterpart of ``repro.core.late_materialization``.  Result sets are
small (k rows), so attributes that never feed the computation are fetched
only for the final k keys: every owner contributes its owned rows and one
allreduce over the nodes (``engine.psum``, across ranks too) assembles the
k values.
"""
from __future__ import annotations

import torch

from repro_torch.core.columnar import PackedColumn
from repro_torch.core.engine import node_ids, psum
from repro_torch.core.partitioning import RangePartitioning


def materialize(keys, valid, part: RangePartitioning, local_columns):
    """Fetch attribute values for k replicated global keys.

    keys, valid: (k,).  local_columns: name -> (L, rows_per_node) tensor or
    PackedColumn.  Returns name -> (k,) values.  A packed attribute gathers
    and decodes only the k codes it needs."""
    keys = keys.to(torch.int64)
    nodes = node_ids(part.num_nodes, keys.device)[:, None]
    mine = valid & (part.owner(keys) == nodes)             # (L, k)
    local_idx = torch.where(mine, part.local_index(keys), 0)
    out = {}
    for name, col in local_columns.items():
        if isinstance(col, PackedColumn):
            vals = col.gather(local_idx)
        else:
            vals = torch.gather(col, 1, local_idx)
        contrib = torch.where(mine, vals, torch.zeros_like(vals))
        # exactly one node owns each key: the sum is that node's value
        out[name] = psum(contrib, "late_materialization").to(vals.dtype)
    return out
