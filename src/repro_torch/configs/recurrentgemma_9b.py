"""RecurrentGemma-9B [arXiv:2402.19427] — Griffin: RG-LRU + local attn, 2:1."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma_9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,             # MQA in the attention blocks
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "attn"),
    sliding_window=2048,
    rglru_width=4096,
    act="gelu",
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10000.0,
))
