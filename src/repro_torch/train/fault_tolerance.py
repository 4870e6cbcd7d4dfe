"""Fault tolerance + elasticity utilities.

Port of ``repro.train.fault_tolerance``. The failure model: a host dies
mid-step, the job restarts, and training resumes bit-identically from
the last complete checkpoint.

* ``TrainingRunner`` — checkpointed step loop with resume, per-step
  wall-time tracking (the straggler summary rides the checkpoint's aux),
  and a failure-injection hook for tests. Each step's loss is read back
  to the host (the JAX loop's ``block_until_ready``), so a step's time
  is the card's.
* ``remesh`` — re-places a train state onto a new mesh
  (``core.sharded_filter.Mesh``). The port's mesh holds one device
  (a mesh over distinct devices raises ``NotImplementedError`` where it
  is built, ROADMAP queue A item 13), so the state moves onto that
  device.
* ``StragglerMonitor`` — flags steps slower than k x median.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..core.sharded_filter import Mesh
from . import checkpoint as ckpt
from .optimizer import QTensor


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, window: int = 50):
        self.threshold = threshold
        self.window = window
        self.times: List[float] = []
        self.flagged: List[int] = []

    def record(self, step: int, dt: float):
        self.times.append(dt)
        hist = self.times[-self.window:]
        if len(hist) >= 10:
            med = float(np.median(hist))
            if dt > self.threshold * med:
                self.flagged.append(step)

    def summary(self) -> Dict[str, Any]:
        if not self.times:
            return {}
        return {
            "median_s": float(np.median(self.times)),
            "p99_s": float(np.percentile(self.times, 99)),
            "straggler_steps": self.flagged[-20:],
        }


def remesh(state, old_mesh: Optional[Mesh], new_mesh: Mesh, spec_fn):
    """Re-place a train state onto ``new_mesh`` (elastic shrink / grow).

    ``spec_fn(path, leaf)`` is asked for each leaf's placement, as in the
    JAX package; on the port's one-device mesh every leaf moves to
    ``new_mesh.device`` (a module's parameters in place, other tensors as
    new ones). Returns the state in the same structure."""
    device = new_mesh.device

    def move(tree, path):
        if isinstance(tree, torch.Tensor):
            spec_fn(path, tree)
            return tree.to(device)
        if isinstance(tree, nn.Module):
            for name, p in tree.named_parameters():
                spec_fn(path + (name,), p)
            return tree.to(device)
        if isinstance(tree, QTensor):
            return QTensor(move(tree.q, path + ("q",)),
                           move(tree.scale, path + ("scale",)), tree.shape)
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(move(getattr(tree, f), path + (f,))
                                for f in tree._fields))
        if isinstance(tree, dict):
            return {k: move(v, path + (k,)) for k, v in tree.items()}
        return tree

    return move(state, ())


@dataclasses.dataclass
class TrainingRunner:
    """Checkpointed training loop with resume + failure injection.
    ``ckpt_every <= 0`` writes no checkpoint (a run too large to save)."""

    train_step: Callable  # (params, opt_state, batch) -> (p, o, metrics)
    data_fn: Callable     # (step) -> batch   (stateless-resumable pipeline)
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    fail_at_step: Optional[int] = None  # test hook: raise mid-run

    def run(self, params, opt_state, num_steps: int,
            start_step: int = 0, log_every: int = 10,
            log_fn: Callable[[str], None] = print):
        monitor = StragglerMonitor()
        step = start_step
        while step < num_steps:
            if self.fail_at_step is not None and step == self.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.perf_counter()
            batch = self.data_fn(step)
            params, opt_state, metrics = self.train_step(
                params, opt_state, batch)
            loss = float(metrics["loss"])     # the step's end on the card
            dt = time.perf_counter() - t0
            monitor.record(step, dt)
            step += 1
            if step % log_every == 0:
                log_fn(f"step {step}: loss={loss:.4f} "
                       f"gnorm={float(metrics['grad_norm']):.3f} "
                       f"lr={float(metrics['lr']):.2e} ({dt * 1e3:.0f} ms)")
            if self.ckpt_every > 0 and (step % self.ckpt_every == 0
                                        or step == num_steps):
                ckpt.save(self.ckpt_dir, step,
                          {"params": params, "opt": opt_state},
                          aux={"straggler": monitor.summary(),
                               "data_cursor": step}, keep=self.keep)
        return params, opt_state, monitor

    def resume(self, params_template, opt_template):
        """Restore the latest checkpoint into the templates (in place)."""
        step = ckpt.latest_step(self.ckpt_dir)
        if step is None:
            return params_template, opt_template, 0
        state, step, aux = ckpt.restore(
            self.ckpt_dir, {"params": params_template, "opt": opt_template})
        return state["params"], state["opt"], step
