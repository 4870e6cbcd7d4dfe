"""Model facade: parameters, prefill and decode for the serving path.

Port of ``repro.models.model``: :class:`Model` is an ``nn.Module`` that
holds its parameters (the JAX ``Model`` is functional and takes them as
an argument), drawn from an explicit ``torch.Generator`` on its device.
Parameters do not require gradients, so serving builds no autograd
graph. It serves every decoder whose mixer is attention (GQA or MLA) and
whose FFN is an MLP or MoE. ``forward``, ``loss`` and ``encode`` wait for
the training path (ROADMAP queue A item 16), and with them DeepSeek-V3's
multi-token-prediction block: the JAX ``init`` builds it for
``mtp_heads``, but only its ``loss`` reads it, so the serving model has
none.
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
    """Decoder-only LM: ``embed``, ``layers`` (one block each),
    ``final_norm`` and, without tied embeddings, ``head``.

    ``device`` defaults to the generator's device, else the GPU (raising
    when there is none; pass ``device="cpu"`` for the CPU). Parameters are
    drawn from ``generator`` (a ``torch.Generator`` on that device), by
    default one seeded with ``seed``.
    """

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        if cfg.frontend == "frames":
            raise ValueError("encoder-only arch has no autoregressive serve")
        self.cfg = cfg
        if device is None and generator is not None:
            device = generator.device
        device = resolve_device(device)
        gen = generator or torch.Generator(device=device).manual_seed(seed)
        self.embed = embed_init(gen, cfg.vocab_size, cfg.d_model, device=device)
        self.layers = T.stack_init(gen, cfg, device)
        self.final_norm = rmsnorm_init(cfg.d_model, device)
        self.head = (None if cfg.tie_embeddings else
                     dense_init(gen, cfg.d_model, cfg.vocab_size, device=device))

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    # -- shared pieces ----------------------------------------------------
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

    # -- serving ------------------------------------------------------------
    def prefill(self, tokens):
        """tokens: int [B, S]. Full-sequence forward building caches.

        Returns (next-token logits float32 [B, V], caches: one a layer,
        bf16: a KVCache, or an MLACache for an MLA layer).
        """
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
        token's keys and values into ``caches`` in place."""
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
