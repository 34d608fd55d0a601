"""Architecture configurations the port serves (counterpart of
``repro.configs``)."""
from repro_torch.configs.registry import ARCHS, SHAPES, get_arch  # noqa: F401
