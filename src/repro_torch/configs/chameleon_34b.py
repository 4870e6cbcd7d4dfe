"""Chameleon-34B [arXiv:2405.09818] — early-fusion token backbone, QK-norm.

VQ image tokenization is stubbed: inputs are already fused token ids over
the shared 65536 vocab (text + image codebook), per the assignment's
"backbone only" rule.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="chameleon_34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    rope_theta=10000.0,
    tie_embeddings=False,
))
