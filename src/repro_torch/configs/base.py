"""Model configuration schema + architecture registry.

Port of ``repro.configs.base``: :class:`ModelConfig` has the same fields,
defaults, ``layer_kinds``, ``segments``, ``param_count`` and ``reduced()``
(a copy: the port imports nothing of the JAX package). One ``<arch>.py``
per architecture registers its full-size config; :func:`get_config`
resolves all ten and raises ``KeyError`` for any other name.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # --- attention variants -------------------------------------------------
    attention: str = "gqa"      # gqa | mla | none
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None      # SWA width (all local layers)
    # pattern of ("local"|"global") repeated over layers, e.g. gemma3 5:1
    local_global_pattern: Optional[Tuple[str, ...]] = None
    attn_softcap: Optional[float] = None      # gemma2: 50.0
    final_softcap: Optional[float] = None     # gemma2: 30.0
    qk_norm: bool = False
    causal: bool = True                       # False = encoder (hubert)

    # --- MLA (deepseek) ------------------------------------------------------
    mla_q_lora_rank: int = 0
    mla_kv_lora_rank: int = 0
    mla_qk_rope_dim: int = 0
    mla_qk_nope_dim: int = 0
    mla_v_dim: int = 0
    mla_absorb: bool = True      # absorbed decode (§Perf); False = naive

    # --- MoE -----------------------------------------------------------------
    moe: bool = False
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0               # deepseek: 3 dense layers
    router_fn: str = "softmax"                # softmax | sigmoid
    capacity_factor: float = 1.25

    # --- SSM (mamba2) ----------------------------------------------------
    ssm: bool = False
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv1d_width: int = 4

    # --- hybrid (recurrentgemma) ----------------------------------------
    # block pattern tuple of "rglru"|"attn" repeated across layers
    block_pattern: Optional[Tuple[str, ...]] = None
    rglru_width: int = 0

    # --- heads / embedding -----------------------------------------------
    mtp_heads: int = 0                        # deepseek MTP modules
    tie_embeddings: bool = True
    embed_scale: bool = False                 # gemma: scale embeds by sqrt(d)
    act: str = "silu"
    norm_eps: float = 1e-6

    # --- modality frontend stub -------------------------------------------
    frontend: str = "none"                    # none | frames (audio stub)

    # --- compute tiling -----------------------------------------------------
    chunk_q: int = 512
    chunk_k: int = 1024
    loss_chunk: int = 512        # seq-chunked CE (never materialize full
    #                              fp32 logits — see model.Model.loss)
    remat_policy: str = "full"   # full | dots | none

    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    # --- layer-kind derivation ------------------------------------------
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer mixer kind: attn / attn_local / mla / ssm / rglru (+_moe)."""
        kinds = []
        for i in range(self.num_layers):
            if self.ssm:
                kind = "ssm"
            elif self.block_pattern:
                kind = self.block_pattern[i % len(self.block_pattern)]
                if kind == "attn":
                    kind = "attn_local" if self.sliding_window else "attn"
            elif self.attention == "mla":
                kind = "mla"
            elif self.local_global_pattern:
                kind = ("attn_local"
                        if self.local_global_pattern[
                            i % len(self.local_global_pattern)] == "local"
                        else "attn")
            elif self.sliding_window:
                kind = "attn_local"
            else:
                kind = "attn"
            if self.moe and i >= self.first_dense_layers:
                kind += "+moe"
            elif self.d_ff > 0:
                kind += "+mlp"
            kinds.append(kind)
        return tuple(kinds)

    def segments(self) -> Tuple[Tuple[str, int], ...]:
        """Group consecutive identical layer-kind *periods* for lax.scan.

        Returns ((period_kinds..., repeat), ...) where each segment scans
        ``repeat`` times over a stacked period of len(period) layers.
        """
        kinds = self.layer_kinds()
        # find smallest period that tiles a maximal prefix run
        segs = []
        i = 0
        n = len(kinds)
        while i < n:
            best = (1, 1)  # (period_len, repeats)
            for plen in range(1, min(8, n - i) + 1):
                period = kinds[i:i + plen]
                reps = 1
                while (i + (reps + 1) * plen <= n
                       and kinds[i + reps * plen: i + (reps + 1) * plen]
                       == period):
                    reps += 1
                if plen * reps > best[0] * best[1]:
                    best = (plen, reps)
            plen, reps = best
            segs.append((kinds[i:i + plen], reps))
            i += plen * reps
        return tuple(segs)

    # --- parameter count (for roofline MODEL_FLOPS) ----------------------
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.head_dim_()
        total = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d
        for kind in self.layer_kinds():
            if kind.startswith("mla"):
                rq, rkv = self.mla_q_lora_rank, self.mla_kv_lora_rank
                dn, dr, dv = (self.mla_qk_nope_dim, self.mla_qk_rope_dim,
                              self.mla_v_dim)
                total += d * rq + rq * self.num_heads * (dn + dr)
                total += d * rkv + d * dr
                total += rkv * self.num_heads * (dn + dv)
                total += self.num_heads * dv * d
            elif kind.startswith("attn"):
                total += d * self.num_heads * hd * 2  # wq, wo
                total += d * self.num_kv_heads * hd * 2
            elif kind.startswith("ssm"):
                d_in = self.ssm_expand * d
                total += d * (2 * d_in + 2 * self.ssm_state + self.ssm_heads)
                total += d_in * d
            elif kind.startswith("rglru"):
                W = self.rglru_width or d
                total += 2 * d * W + 2 * W * W + W * d
            if kind.endswith("+moe"):
                e = self.num_experts if not active_only else \
                    self.experts_per_token
                total += 3 * (e + self.num_shared_experts) * d * self.moe_d_ff
                total += d * self.num_experts  # router
            elif kind.endswith("+mlp"):
                total += 3 * d * self.d_ff
        return total

    # --- smoke-test reduction ---------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        pattern_len = len(self.local_global_pattern or self.block_pattern
                          or (1,))
        layers = max(2, min(2 * pattern_len, 6))
        if self.first_dense_layers:
            layers = max(layers, self.first_dense_layers + 1)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=layers,
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=32,
            d_ff=0 if self.d_ff == 0 else 256,
            vocab_size=512,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else None,
            mla_q_lora_rank=min(self.mla_q_lora_rank, 64) or 0,
            mla_kv_lora_rank=min(self.mla_kv_lora_rank, 32) or 0,
            # qk dim (24) deliberately != v dim (32): catches qk/v head-dim
            # conflation bugs the full-size MLA config exposes
            mla_qk_rope_dim=8 if self.mla_qk_rope_dim else 0,
            mla_qk_nope_dim=16 if self.mla_qk_nope_dim else 0,
            mla_v_dim=32 if self.mla_v_dim else 0,
            num_experts=min(self.num_experts, 8),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=64 if self.moe else 0,
            capacity_factor=8.0 if self.moe else self.capacity_factor,
            ssm_state=min(self.ssm_state, 32) if self.ssm else 0,
            ssm_head_dim=16 if self.ssm else 64,
            ssm_chunk=32,
            rglru_width=64 if self.rglru_width else 0,
            chunk_q=32,
            chunk_k=64,
        )


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCHS = (
    "deepseek_v3_671b",
    "mixtral_8x22b",
    "h2o_danube3_4b",
    "qwen1_5_4b",
    "gemma2_2b",
    "gemma3_4b",
    "hubert_xlarge",
    "chameleon_34b",
    "recurrentgemma_9b",
    "mamba2_130m",
)
# The architectures whose config module the port has: all of them.
PORTED = ARCHS

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    """Look up an architecture config by registry name (hyphen or underscore)."""
    key = name.replace("-", "_")
    if key not in _REGISTRY:
        if key not in PORTED:
            raise KeyError(f"unknown architecture {name!r}; known: {ARCHS}")
        importlib.import_module(f"repro_torch.configs.{key}")
    return _REGISTRY[key]
