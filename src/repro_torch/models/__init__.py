"""The serving model: dense GQA transformer blocks (port of ``repro.models``)."""

from .model import Model, build_model  # noqa: F401
