"""Training entry point: the port's model, optimizer, checkpoints and the
filter-backed dedup, end to end on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_130m \\
        --reduced --steps 100 --batch 8 --seq 256 [--resume] [--dedup]
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1_5_4b \\
        --steps 8 --batch 2 --seq 2048 --dedup --ckpt-every 0

The flags of ``repro.launch.train``, plus ``--device`` (default: the GPU;
without a CUDA device it raises; ``cpu`` runs the kernels' plain
versions) and ``--ckpt-every 0`` (no checkpoint: a run whose state is too
large to save). ``--dedup`` masks duplicate sequences through
``data.dedup.dedup_batch`` on a ``CuckooConfig.for_capacity(..., hash_kind=
"fmix32")`` filter on the same device, so on the card the fused query and
insert kernels run on the training path. Every attention forward runs
kernel #11 and, under full remat, twice a layer a step; every attention
backward the backward kernel. The summary line gives each step's loss,
grad norm and seconds, tokens/s past the first step, the peak of
allocated device memory and the flash kernels' launches a step.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from ..configs import get_config
from ..core import CuckooConfig
from ..data import DataConfig, DedupConfig, dedup_batch
from ..data.pipeline import make_batch, make_frames_batch
from ..kernels import ops
from ..models import build_model
from ..train import (AdamWConfig, TrainingRunner, init_train_state,
                     make_train_step)
from ..train import checkpoint as ckpt


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_130m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints (0: none)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--dedup", action="store_true",
                    help="filter-backed streaming dedup of training data")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' for the "
                         "plain versions of the kernels)")
    return ap.parse_args(argv)


def train(args, log_fn=print) -> dict:
    """Run the training described by ``args`` (see :func:`parse_args`).
    Returns the model, its optimizer state and the run's record: each
    step's ``loss``, ``grad_norm``, seconds (the step alone, its loss read
    back) and flash launches (forward, backward), the dedup's masked
    sequences, ``tokens_per_s`` past the first step and ``peak_bytes``
    (the card's peak of allocated memory; None on the CPU)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    on_cuda = args.device is None or torch.device(args.device).type == "cuda"
    if on_cuda and torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=args.device, seed=args.seed)
    device = model.device
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                          total_steps=args.steps)
    model, opt_state = init_train_state(model, opt_cfg, seed=args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    log_fn(f"arch={cfg.name} params={n_params / 1e6:.1f}M device={device}")

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, batch=args.batch,
                          seq_len=args.seq, seed=args.seed)
    dedup = {"filter": None, "masked": []}
    if args.dedup:
        dcfg = DedupConfig(CuckooConfig.for_capacity(
            max(args.steps * args.batch, 4096), hash_kind="fmix32"))
        dedup["filter"] = dcfg.filter.init(device)

    def data_fn(step):
        if cfg.frontend == "frames":
            return make_frames_batch(data_cfg, step, cfg.d_model, device)
        batch = make_batch(data_cfg, step, device)
        if dedup["filter"] is not None:
            dedup["filter"], batch, stats = dedup_batch(
                dcfg, dedup["filter"], batch)
            dedup["masked"].append(int(stats["duplicates"]))
            if step % 20 == 0:
                log_fn(f"  dedup: {dedup['masked'][-1]} duplicate "
                       f"sequences masked at step {step}")
        return batch

    base_step = make_train_step(model, opt_cfg, microbatches=args.microbatches)
    steps = []

    def step_fn(params, opt, batch):
        before = (ops.LAUNCHES["flash_attention"],
                  ops.LAUNCHES["flash_attention_bwd"])
        t0 = time.perf_counter()
        params, opt, metrics = base_step(params, opt, batch)
        loss = float(metrics["loss"])
        steps.append({"loss": loss, "grad_norm": float(metrics["grad_norm"]),
                      "seconds": time.perf_counter() - t0,
                      "flash_forward": ops.LAUNCHES["flash_attention"]
                      - before[0],
                      "flash_backward": ops.LAUNCHES["flash_attention_bwd"]
                      - before[1]})
        return params, opt, metrics

    runner = TrainingRunner(train_step=step_fn, data_fn=data_fn,
                            ckpt_dir=args.ckpt_dir,
                            ckpt_every=args.ckpt_every)
    start = 0
    if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
        model, opt_state, start = runner.resume(model, opt_state)
        log_fn(f"resumed from step {start}")
    model, opt_state, monitor = runner.run(
        model, opt_state, num_steps=args.steps, start_step=start,
        log_fn=log_fn)
    later = [s["seconds"] for s in steps[1:]]
    tokens = args.batch * args.seq
    return {"model": model, "opt_state": opt_state, "arch": cfg.name,
            "params": n_params, "device": str(device), "start_step": start,
            "steps": steps, "dedup_masked": dedup["masked"],
            "tokens_per_step": tokens,
            "tokens_per_s": tokens * len(later) / sum(later) if later else None,
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
            "straggler": monitor.summary()}


def main(argv=None) -> dict:
    args = parse_args(argv)
    out = train(args)
    first = out["steps"][0] if out["steps"] else None
    print(f"losses: {[round(s['loss'], 4) for s in out['steps']]}")
    if first is not None:
        print(f"first step {first['seconds'] * 1e3:.0f} ms; later steps "
              f"{out['tokens_per_s'] or 0:.0f} tokens/s; flash launches a "
              f"step: {first['flash_forward']} forward, "
              f"{first['flash_backward']} backward")
    if out["peak_bytes"] is not None:
        print(f"peak device memory {out['peak_bytes'] / 2**30:.2f} GiB")
    print("straggler summary:", out["straggler"])
    return out


if __name__ == "__main__":
    main()
