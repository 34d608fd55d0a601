"""Serving of the language model (counterpart of ``repro.serve``'s
sampling head and engine).

  sampling  the §3.2.3 distributed top-k head over stacked vocab shards
  engine    make_serve_step / decode_loop
"""
