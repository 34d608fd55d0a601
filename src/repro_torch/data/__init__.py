"""Data pipeline of the port (counterpart of ``repro.data``)."""
from repro_torch.data.synthetic import SyntheticLM, zipf_tokens  # noqa: F401
