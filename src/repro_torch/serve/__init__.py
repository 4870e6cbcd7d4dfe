"""Serving layer: batched prefill/decode engine + AMQ-guarded prefix cache."""

from .engine import ServeEngine  # noqa: F401
from .prefix_cache import PrefixCache, prefix_key  # noqa: F401
