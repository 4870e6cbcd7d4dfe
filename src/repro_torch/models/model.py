"""Model facade: parameters, the training forward and loss, prefill and
decode.

Port of ``repro.models.model``: :class:`Model` is an ``nn.Module`` that
holds its parameters (the JAX ``Model`` is functional and takes them as
an argument), drawn from an explicit ``torch.Generator`` on its device.
It runs every registered architecture: the decoders (attention, MLA, SSM
and RG-LRU mixers; MLP, MoE or no FFN) serve through ``prefill`` /
``decode_step``, the ``frames`` encoder (``hubert_xlarge``) runs
``encode``, and every one trains through ``loss`` (the chunked cross
entropy, with DeepSeek-V3's multi-token-prediction block).

Parameters are built without gradients; ``train.init_train_state`` turns
them on (and builds the MTP block: the JAX ``init`` builds it for
``mtp_heads``, but only ``loss`` reads it, so a serving model has none).
``prefill``, ``decode_step`` and ``encode`` run under ``torch.no_grad()``,
so serving builds no autograd graph even on a trainable model.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.device import resolve_device
from . import transformer as T
from .layers import (dense_apply, dense_init, embed_apply, embed_init,
                     embed_logits, rmsnorm_apply, rmsnorm_init, softcap)


class MTP(nn.Module):
    """The multi-token-prediction block: ``norm``, then ``block``."""

    def __init__(self, norm, block):
        super().__init__()
        self.norm, self.block = norm, block


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
        self.mtp = None

    def init_mtp(self, generator: Optional[torch.Generator] = None,
                 seed: int = 0) -> None:
        """Build the multi-token-prediction block (``mtp.norm``,
        ``mtp.block``: one more layer of the last layer's kind) for
        ``cfg.mtp_heads``, drawn from ``generator`` (default: one on the
        model's device seeded with ``seed``); without ``mtp_heads``, or
        when it is built already, nothing."""
        cfg = self.cfg
        if not cfg.mtp_heads or self.mtp is not None:
            return
        gen = generator or torch.Generator(device=self.device).manual_seed(seed)
        self.mtp = MTP(rmsnorm_init(cfg.d_model, self.device),
                       T.block_init(gen, cfg, cfg.layer_kinds()[-1],
                                    self.device))

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

    # -- training forward + loss -------------------------------------------
    def forward(self, batch, *, remat: bool = True) -> torch.Tensor:
        """batch: ``{"tokens": int [B, S]}``, or ``{"frames": [B, S,
        d_model]}`` for the ``frames`` frontend (cast to bf16). Returns the
        last layer's output [B, S, d_model], before the final norm. With
        ``remat`` (and grad mode on) each layer is recomputed in the
        backward by ``cfg.remat_policy``."""
        if self.cfg.frontend == "frames":
            x = torch.as_tensor(batch["frames"], device=self.device).to(
                torch.bfloat16)
        else:
            x = self._embed(torch.as_tensor(batch["tokens"],
                                            device=self.device))
        B, S = x.shape[0], x.shape[1]
        positions = torch.arange(S, device=x.device).expand(B, S)
        return T.stack_apply(self.layers, self.cfg, x, positions=positions,
                             remat=remat)

    def _ce_chunk(self, xc, yc, mc):
        logits = self._logits(xc)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, yc[..., None].long(), dim=-1)[..., 0]
        return torch.sum((logz - gold) * mc), torch.sum(mc)

    def _chunked_ce(self, x, labels, mask=None) -> torch.Tensor:
        """Seq-chunked CE: never materializes [B, S, V] float32 logits.

        Chunks of ``min(loss_chunk, S)`` positions, stepped down until it
        divides S. With grad mode on each chunk runs under
        ``torch.utils.checkpoint``, so the backward recomputes that chunk's
        logits from (x chunk, the readout): one [B, c, V] float32 slab is
        resident, and none of the tied readout's float32 table slabs
        outlive their chunk. Returns sum(nll * mask) / max(sum(mask), 1).
        """
        B, S = labels.shape
        c = min(self.cfg.loss_chunk, S)
        while S % c:
            c -= 1
        mask = (torch.ones((B, S), dtype=torch.float32, device=x.device)
                if mask is None else mask.to(torch.float32))
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, S, c):
            args = (x[:, i:i + c], labels[:, i:i + c], mask[:, i:i + c])
            if torch.is_grad_enabled():
                s, n = checkpoint(self._ce_chunk, *args, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                s, n = self._ce_chunk(*args)
            tot, cnt = tot + s, cnt + n
        return tot / torch.clamp_min(cnt, 1.0)

    def loss(self, batch, *, remat: bool = True) -> torch.Tensor:
        """batch: tokens int [B, S + 1] (causal LM: inputs ``[:, :-1]``,
        labels ``[:, 1:]``) with an optional ``mask`` (1-D: one flag a
        sequence, the dedup mask, broadcast over its labels), or ``frames``
        + ``labels`` (+ ``mask`` [B, S]) for the ``frames`` frontend.
        Returns the mean masked CE, float32; with an MTP block, plus 0.1
        times the block's CE on token t + 2 (unmasked), as the JAX
        package computes it."""
        cfg = self.cfg
        dev = self.device
        if cfg.frontend == "frames":
            x = self.forward(batch, remat=remat)
            mask = batch.get("mask")
            return self._chunked_ce(
                x, torch.as_tensor(batch["labels"], device=dev),
                None if mask is None else torch.as_tensor(mask, device=dev))
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        labels = tokens[:, 1:]
        mask = batch.get("mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=dev)
            if mask.ndim == 1:       # per-sequence dedup mask
                mask = mask[:, None].expand(labels.shape)
        x = self.forward({"tokens": tokens[:, :-1]}, remat=remat)
        total = self._chunked_ce(x, labels, mask)
        if cfg.mtp_heads and self.mtp is not None:
            # Multi-token prediction (DeepSeek-V3 style, simplified): one
            # extra block on the trunk output predicts token t + 2.
            B, S = labels.shape
            pos = torch.arange(S, device=dev).expand(B, S)
            h, _ = T.block_apply(self.mtp.block, cfg, self.mtp.block.kind,
                                 rmsnorm_apply(self.mtp.norm, x),
                                 positions=pos)
            total = total + 0.1 * self._chunked_ce(h[:, :-1], labels[:, 1:])
        return total

    @torch.no_grad()
    def encode(self, frames) -> torch.Tensor:
        """The encoder's logits for ``frames`` [B, S, d_model]: float32
        [B, S, vocab]."""
        return self._logits(self.forward({"frames": frames}, remat=False))

    # -- serving ------------------------------------------------------------
    @torch.no_grad()
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

    @torch.no_grad()
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
