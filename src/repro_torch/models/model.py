"""Model facade: parameters, the forward, prefill and decode.

Port of ``repro.models.model``: :class:`Model` is an ``nn.Module`` that
holds its parameters (the JAX ``Model`` is functional and takes them as
an argument), drawn from an explicit ``torch.Generator`` on its device.
Parameters do not require gradients, so serving builds no autograd
graph. It runs every registered architecture: the decoders (attention,
MLA, SSM and RG-LRU mixers; MLP, MoE or no FFN) serve through
``prefill`` / ``decode_step``, and the ``frames`` encoder
(``hubert_xlarge``) runs ``encode``. ``loss`` and its chunked cross
entropy wait for the training path (ROADMAP queue A item 16e), and with
them DeepSeek-V3's multi-token-prediction block: the JAX ``init`` builds
it for ``mtp_heads``, but only its ``loss`` reads it, so the port's model
has none.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core.device import resolve_device
from . import transformer as T
from .layers import (dense_apply, dense_init, embed_apply, embed_init,
                     embed_logits, rmsnorm_apply, rmsnorm_init, softcap)


class Model(nn.Module):
    """``embed`` (none for the ``frames`` frontend), ``layers`` (one block
    each), ``final_norm`` and, without tied embeddings or with the
    ``frames`` frontend, ``head``.

    ``device`` defaults to the generator's device, else the GPU (raising
    when there is none; pass ``device="cpu"`` for the CPU). Parameters are
    drawn from ``generator`` (a ``torch.Generator`` on that device), by
    default one seeded with ``seed``.
    """

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        if device is None and generator is not None:
            device = generator.device
        device = resolve_device(device)
        gen = generator or torch.Generator(device=device).manual_seed(seed)
        frames = cfg.frontend == "frames"
        self.embed = (None if frames else
                      embed_init(gen, cfg.vocab_size, cfg.d_model, device=device))
        self.layers = T.stack_init(gen, cfg, device)
        self.final_norm = rmsnorm_init(cfg.d_model, device)
        self.head = (dense_init(gen, cfg.d_model, cfg.vocab_size, device=device)
                     if frames or not cfg.tie_embeddings else None)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    # -- shared pieces ----------------------------------------------------
    def _serving(self):
        if self.cfg.frontend == "frames":
            raise ValueError("encoder-only arch has no autoregressive serve")

    def _embed(self, tokens):
        x = embed_apply(self.embed, tokens)
        if self.cfg.embed_scale:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        return x

    def _logits(self, x):
        x = rmsnorm_apply(self.final_norm, x, self.cfg.norm_eps)
        if self.head is not None:
            logits = dense_apply(self.head, x).float()
        else:
            logits = embed_logits(self.embed, x)
        return softcap(logits, self.cfg.final_softcap)

    # -- the forward without caches ------------------------------------------
    def forward(self, batch) -> torch.Tensor:
        """batch: ``{"tokens": int [B, S]}``, or ``{"frames": [B, S,
        d_model]}`` for the ``frames`` frontend (cast to bf16). Returns the
        last layer's output [B, S, d_model], before the final norm."""
        if self.cfg.frontend == "frames":
            x = torch.as_tensor(batch["frames"], device=self.device).to(
                torch.bfloat16)
        else:
            x = self._embed(torch.as_tensor(batch["tokens"],
                                            device=self.device))
        B, S = x.shape[0], x.shape[1]
        positions = torch.arange(S, device=x.device).expand(B, S)
        return T.stack_apply(self.layers, self.cfg, x, positions=positions)

    def encode(self, frames) -> torch.Tensor:
        """The encoder's logits for ``frames`` [B, S, d_model]: float32
        [B, S, vocab]."""
        return self._logits(self.forward({"frames": frames}))

    # -- serving ------------------------------------------------------------
    def prefill(self, tokens):
        """tokens: int [B, S]. Full-sequence forward building caches.

        Returns (next-token logits float32 [B, V], caches: one a layer,
        bf16: a KVCache, or an MLACache for an MLA layer; an SSMCache or
        RGLRUCache, whose state is float32, for a recurrent layer).
        """
        self._serving()
        tokens = torch.as_tensor(tokens, device=self.device)
        x = self._embed(tokens)
        B, S = x.shape[0], x.shape[1]
        positions = torch.arange(S, device=x.device).expand(B, S)
        x, caches = T.stack_prefill(self.layers, self.cfg, x,
                                    positions=positions)
        logits = self._logits(x[:, -1:])[:, 0]
        return logits, caches

    def decode_step(self, token, caches, pos: int):
        """token: int [B]; pos: absolute position of this token. Writes the
        token's keys and values into the attention caches in place (a
        recurrent layer's cache is replaced in the returned list)."""
        self._serving()
        token = torch.as_tensor(token, device=self.device)
        x = self._embed(token[:, None])
        B = x.shape[0]
        positions = torch.full((B, 1), int(pos), dtype=torch.int32,
                               device=x.device)
        x, caches = T.stack_decode(self.layers, self.cfg, x, caches,
                                   positions=positions, cache_pos=int(pos))
        logits = self._logits(x)[:, 0]
        return logits, caches

    def init_caches(self, batch: int, max_len: int):
        return T.init_caches(self.cfg, batch, max_len, self.device)


def build_model(cfg: ModelConfig, *, device=None,
                generator: Optional[torch.Generator] = None,
                seed: int = 0) -> Model:
    return Model(cfg, device=device, generator=generator, seed=seed)
