"""DeepSeek-V3 671B [arXiv:2412.19437; hf] — MLA + 1 shared/256 routed top-8 MoE + MTP."""

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek_v3_671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,           # MLA: per-head K/V expanded from the latent
    d_ff=2048,                  # per assignment (expert width; first 3 dense)
    vocab_size=129280,
    attention="mla",
    mla_q_lora_rank=1536,
    mla_kv_lora_rank=512,
    mla_qk_rope_dim=64,
    mla_qk_nope_dim=128,
    mla_v_dim=128,
    head_dim=192,               # qk_nope + qk_rope
    moe=True,
    num_experts=256,
    experts_per_token=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    first_dense_layers=3,
    router_fn="sigmoid",        # aux-loss-free sigmoid routing
    mtp_heads=1,                # multi-token prediction module
    rope_theta=10000.0,
    tie_embeddings=False,
))
