"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``), their
wrappers, plain PyTorch versions (``ref``) and the dispatch (``ops``).

  scan_filter   B1, predicate-on-packed scan
  grouped_agg   B2, fused filter + grouped aggregation
  wire_codec    B3, Elias–Fano wire codec and validity bitsets
  flash_attention   B7, flash-attention forward (prefill, training)
  flash_attention_bwd  B8, its backward (training)
  decode_attention  B9, one-token attention over a float or int8 cache
  build         nvcc build + ctypes loading of ``csrc/*.cu``
"""
