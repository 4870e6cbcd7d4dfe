"""Checkpointing: atomic, resumable, keep-last-k.

Port of ``repro.train.checkpoint``, in its format: one directory per step,
``step_XXXXXXXX/`` with ``arrays.npz`` (the tree's tensors keyed by path;
bf16 widened to float32, cast back on restore, losslessly) and
``meta.json`` (step, aux metadata such as the data cursor and the
straggler summary, the array count). Writes go to a ``.tmp`` directory
and an atomic rename, so a crash mid-write never corrupts the latest
checkpoint, and only the last ``keep`` are kept.

A tree is any nesting of dicts, NamedTuples (``AdamWState``; a
``QTensor`` gives its ``q`` and ``scale``) and modules (a ``Model``
gives its named parameters) over tensors. Keys join the path with
``/``: ``params/layers.0.mixer.wq.w``, ``opt/step``,
``opt/m/embed.table``. They are the port's own names, so a checkpoint
the JAX package wrote does not restore here (nor the reverse).
:func:`restore` copies into the template's tensors in place (the JAX
package returns new arrays) and returns the template.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .optimizer import QTensor


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(key, tensor) of every leaf of ``tree``, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        yield prefix.rstrip("/"), tree
    elif isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield prefix + name, p
    elif isinstance(tree, QTensor):
        yield prefix + "q", tree.q
        yield prefix + "scale", tree.scale
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{prefix}{f}/")
    elif isinstance(tree, dict):
        for k, sub in tree.items():
            yield from _leaves(sub, f"{prefix}{k}/")
    elif tree is not None:
        raise TypeError(f"{prefix or 'tree'}: cannot checkpoint a "
                        f"{type(tree).__name__}")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        # npz cannot hold bf16: widen to float32; restore casts back
        t = t.to(torch.float32)
    return t.cpu().numpy()


def save(ckpt_dir: str, step: int, tree: Any,
         aux: Optional[Dict[str, Any]] = None, keep: int = 3) -> str:
    """Atomically write the checkpoint of ``step``; prune to ``keep``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {key: _to_numpy(t) for key, t in _leaves(tree)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "aux": aux or {},
                   "n_arrays": len(arrays)}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


@torch.no_grad()
def restore(ckpt_dir: str, template: Any,
            step: Optional[int] = None) -> Tuple[Any, int, Dict]:
    """Restore into ``template`` (every key present, shapes equal; each
    array cast to its tensor's dtype and copied in place). Returns
    (template, step, aux)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as arrays:
        for key, t in _leaves(template):
            got = arrays[key]
            assert got.shape == tuple(t.shape), (key, got.shape, tuple(t.shape))
            t.copy_(torch.from_numpy(got).to(t.dtype))
    return template, meta["step"], meta["aux"]
