"""Qwen1.5-4B [hf:Qwen/Qwen1.5-4B] — QKV bias, 152k vocab."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1_5_4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
))
