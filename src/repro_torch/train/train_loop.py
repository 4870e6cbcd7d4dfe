"""Training step factory: loss -> grads -> AdamW, with microbatch
accumulation.

Port of ``repro.train.train_loop``. The port's parameters live in the
model (an ``nn.Module``), so ``train_step(model, opt_state, batch)``
updates the model in place and returns it, where the JAX step returns new
parameters; the signature is otherwise the JAX package's, so
``TrainingRunner`` drives either.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models import Model
from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update


def _grads(model: Model, batch, remat: bool) -> tuple:
    """(loss, {name: gradient}) of one batch, each gradient in its
    parameter's dtype (autograd's, as ``jax.grad`` gives them)."""
    names, params = zip(*[(n, p) for n, p in model.named_parameters()
                          if p.requires_grad])
    loss = model.loss(batch, remat=remat)
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), dict(zip(names, grads))


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, remat: bool = True):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt,
    metrics)`` with ``params`` the model (updated in place).

    With ``microbatches > 1`` the batch is split along axis 0 and the
    gradients are accumulated in float32 (the JAX package's ``lax.scan``
    carry); the loss and the gradients are divided by the count. Metrics:
    ``loss``, ``grad_norm`` and ``lr``, float32 tensors on the model's
    device (nothing is read back to the host).
    """

    def train_step(params: Model, opt_state: AdamWState, batch):
        if microbatches == 1:
            loss, grads = _grads(params, batch, remat)
        else:
            def split(x):
                x = torch.as_tensor(x, device=params.device)
                return x.reshape((microbatches, x.shape[0] // microbatches)
                                 + tuple(x.shape[1:]))

            micro = {k: split(x) for k, x in batch.items()}
            loss, grads = None, None
            for i in range(microbatches):
                l_i, g_i = _grads(params, {k: x[i] for k, x in micro.items()},
                                  remat)
                if grads is None:
                    loss = torch.zeros((), dtype=torch.float32,
                                       device=l_i.device)
                    grads = {n: torch.zeros(g.shape, dtype=torch.float32,
                                            device=g.device)
                             for n, g in g_i.items()}
                loss = loss + l_i
                for n, g in g_i.items():
                    grads[n] += g.to(torch.float32)
                del g_i
            loss = loss / microbatches
            grads = {n: g / microbatches for n, g in grads.items()}

        params, opt_state, metrics = adamw_update(opt_cfg, grads, opt_state,
                                                  params)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def init_train_state(model: Model, opt_cfg: AdamWConfig, *,
                     generator: Optional[torch.Generator] = None,
                     seed: int = 0) -> tuple:
    """Make ``model`` trainable: build its MTP block where the config has
    one (drawn from ``generator``, default one seeded with ``seed``), turn
    on every parameter's gradient, and return ``(model, adamw_init(...))``.
    (The JAX ``init_train_state`` draws fresh parameters from a key; the
    port's model holds its own, drawn when it was built.)"""
    model.init_mtp(generator, seed)
    model.requires_grad_(True)
    return model, adamw_init(opt_cfg, model)
