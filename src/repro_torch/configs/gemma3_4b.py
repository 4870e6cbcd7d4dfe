"""Gemma-3 4B [hf:google/gemma-3-4b-pt] — 5:1 local:global, 128k-capable, QK-norm."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3_4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    local_global_pattern=("local",) * 5 + ("global",),
    sliding_window=1024,
    qk_norm=True,
    act="gelu",
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
))
