"""Gemma-2 2B [arXiv:2408.00118; hf] — alternating local/global attn, softcaps."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2_2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    local_global_pattern=("local", "global"),
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10000.0,
))
