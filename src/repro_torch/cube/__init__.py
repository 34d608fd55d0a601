"""Two-tier rollup-cube subsystem.

Counterpart of ``repro.cube``.  Tier 1: dense rollup cubes, pre-aggregated
in ONE scan per cube by a plan over the node-stacked tables (``build``),
served from host memory in microseconds (``router``).  Tier 2: the
engine's lowered per-query plans over the base tables — the fallback for
queries no cube covers.

  spec     CubeSpec / Dimension / Measure declarations
  build    single-pass builder (partials merged over the node axis)
  router   query matcher: covering-rollup selection, slice/marginalize, or
           route to Tier 2
  serving  the two-tier timing protocol (``measure_query``)
"""
from repro_torch.cube.spec import CubeSpec, Dimension, Measure  # noqa: F401
from repro_torch.cube.build import Cube, build_cube, make_build_plan  # noqa: F401
from repro_torch.cube.router import (  # noqa: F401
    AggQuery,
    CubeRouter,
    Filter,
    Match,
    Route,
    derive_agg_query,
)
