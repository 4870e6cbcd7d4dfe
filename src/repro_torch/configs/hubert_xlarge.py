"""HuBERT X-Large [arXiv:2106.07447] — encoder-only; conv frontend stubbed.

The modality frontend (strided conv feature extractor) is a stub: the
model takes precomputed frame embeddings [B, S, d_model]
(``Model.encode(frames)``);
vocab=504 is the masked-prediction codebook. No decode step exists
(encoder-only): ``prefill``, ``decode_step`` and ``ServeEngine`` raise.
"""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hubert_xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,               # bidirectional encoder
    act="gelu",
    frontend="frames",
    tie_embeddings=False,
    rope_theta=10000.0,
))
