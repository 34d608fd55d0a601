"""The language-model substrate of the port, dense family (counterpart of
``repro.models``).

  config       ModelConfig (a copy of the JAX package's)
  params       parameter initialisation on a torch.Generator
  layers       norms, rope, attention (B7 through kernels.ops), MLP
  transformer  parameters, KV caches (bf16 / int8), prefill, decode
  model        the Model facade (init, cast, hidden, prefill, decode)
  convert      params_from_jax: the JAX parameter tree -> the port's
"""
