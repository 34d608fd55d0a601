"""Serving (counterpart of ``repro.serve``): the language model's
sampling head and engine, and the OLAP serving tier.

  sampling     the §3.2.3 distributed top-k head, across the ranks of a
               mesh or over stacked vocab shards in one process
  engine       make_serve_step / decode_loop, with or without a mesh
  olap_engine  OLAPEngine: continuous batching over prepared plans
  workload     the mixed request stream and its load generators

``OLAPEngine`` and ``AdmissionError`` are imported lazily, so importing
this package stays cheap for the sampling-only callers.
"""
from repro_torch.serve.sampling import (  # noqa: F401
    distributed_topk_sample,
    topk_logits,
)

__all__ = ["distributed_topk_sample", "topk_logits", "OLAPEngine",
           "AdmissionError"]


def __getattr__(name):
    if name in ("OLAPEngine", "AdmissionError"):
        from repro_torch.serve import olap_engine

        return getattr(olap_engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
