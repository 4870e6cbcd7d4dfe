"""Architecture configs (one module per ported arch) + registry."""

from .base import ARCHS, ModelConfig, get_config, register  # noqa: F401
