"""Mamba-2 130M [arXiv:2405.21060] — attention-free SSD."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2_130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=1,                # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,                     # no separate MLP: in-proj expands 2x
    vocab_size=50280,
    attention="none",
    ssm=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,            # -> 24 SSD heads
    ssm_chunk=256,
    conv1d_width=4,
    tie_embeddings=True,
))
