"""H2O-Danube3-4B [arXiv:2401.16818] — llama+mistral mix, SWA (per assignment)."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="h2o_danube3_4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=10000.0,
    tie_embeddings=False,
))
