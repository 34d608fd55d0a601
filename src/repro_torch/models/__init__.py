"""The language-model substrate of the port, every family of the JAX
package (counterpart of ``repro.models``).

  config       ModelConfig (a copy of the JAX package's)
  params       parameter initialisation on a torch.Generator
  layers       norms, rope, attention (B7 through kernels.ops), MLP
  moe          the MoE block: routing, sort-based dispatch, expert FFN
  moe_dispatch the expert-parallel MoE block over the all-to-all
  transformer  parameters, KV caches (bf16 / int8), prefill, decode
  ssm          mamba2: the chunked SSD, its O(1) decode state
  hybrid       recurrentgemma: RG-LRU and local attention, a ring buffer
  encdec       whisper: encoder, decoder with cross attention, their cache
  vlm          paligemma: patch projection, the bidirectional image prefix
  model        the Model facade (init, cast, hidden, prefill, decode)
  convert      params_from_jax: the JAX parameter tree -> the port's
"""
