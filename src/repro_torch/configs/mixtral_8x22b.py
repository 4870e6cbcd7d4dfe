"""Mixtral-8x22B [arXiv:2401.04088; hf] — 8 experts top-2, SWA (per assignment)."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral_8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    sliding_window=4096,        # Mistral-lineage SWA
    moe=True,
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=16384,
    router_fn="softmax",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
))
