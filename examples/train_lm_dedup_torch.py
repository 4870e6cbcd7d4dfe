"""End-to-end training on the PyTorch port: LM + streaming filter dedup +
checkpoints.

The counterpart of ``examples/train_lm_dedup.py`` on ``repro_torch``, at
its sizes: ``mamba2_130m.reduced()`` for 200 steps (batch 8, 128 tokens,
30 % of the sequences repeats of a canned pool), the cuckoo-filter dedup
stage masking duplicate sequences, checkpoints every 25 steps and a
failure injected half way, after which a second runner resumes from the
last checkpoint. ``--full-100m`` trains a ~100M-parameter model (12
layers of mamba2_130m's width, batch 8, 1024 tokens).

    PYTHONPATH=src python examples/train_lm_dedup_torch.py             # the GPU
    PYTHONPATH=src python examples/train_lm_dedup_torch.py --device cpu --steps 20

``--device-budget-bytes N`` switches the dedup stage to the tiered
device-hot / host-cold filter (``make_deduper``): the dedup keyset may
grow several times past the device budget, old filter levels freezing
into host RAM:

    PYTHONPATH=src python examples/train_lm_dedup_torch.py \\
        --steps 400 --device-budget-bytes 4096

Without a CUDA device it fails unless ``--device cpu`` is given, which
runs the kernels' plain PyTorch versions.
"""

import argparse
import dataclasses
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.core import CuckooConfig
from repro_torch.data import (DataConfig, DedupConfig, dedup_batch,
                              make_batch, make_deduper)
from repro_torch.models import build_model
from repro_torch.train import (AdamWConfig, TrainingRunner, checkpoint,
                               init_train_state, make_train_step)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--device-budget-bytes", type=int, default=None,
                    help="cap the dedup filter's device footprint; older "
                         "levels tier out to host RAM")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU; 'cpu' for the "
                         "plain versions of the kernels)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                         "one)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_lm_dedup_torch: no CUDA device is "
                         "available; run with --device cpu")

    cfg = get_config("mamba2_130m")
    if args.full_100m:
        cfg = dataclasses.replace(cfg, num_layers=12)   # ~100M params
        batch, seq = 8, 1024
    else:
        cfg = cfg.reduced()
        batch, seq = 8, 128

    model = build_model(cfg, device=device, seed=0)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)
    model, opt_state = init_train_state(model, opt_cfg)
    n = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.name} ({n / 1e6:.1f}M params) on {model.device}")

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, batch=batch, seq_len=seq,
                          duplicate_fraction=0.3)
    dup = {"total": 0}

    if args.device_budget_bytes is not None:
        # Beyond-device-memory mode: the tiered handle freezes old levels
        # into host RAM and probes them off the padded hot path.
        deduper = make_deduper(1024, "cuckoo", service_batch=batch,
                               device_budget_bytes=args.device_budget_bytes,
                               device=model.device)

        def data_fn(step):
            batch_, stats = deduper.dedup(make_batch(data_cfg, step,
                                                     model.device))
            dup["total"] += int(stats["duplicates"])
            return batch_
    else:
        dcfg = DedupConfig(CuckooConfig.for_capacity(args.steps * batch + 4096,
                                                     hash_kind="fmix32"))
        dup["filter"] = dcfg.filter.init(model.device)

        def data_fn(step):
            batch_ = make_batch(data_cfg, step, model.device)
            dup["filter"], batch_, stats = dedup_batch(dcfg, dup["filter"],
                                                       batch_)
            dup["total"] += int(stats["duplicates"])
            return batch_

    step_fn = make_train_step(model, opt_cfg)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_example_")
    fail_at = args.steps // 2
    print(f"training {args.steps} steps; injecting a failure at {fail_at} "
          "to demonstrate checkpoint/restart...")
    losses = []

    def log(line):
        losses.append(float(line.split("loss=")[1].split()[0]))
        print(line)

    runner = TrainingRunner(train_step=step_fn, data_fn=data_fn,
                            ckpt_dir=ckpt_dir, ckpt_every=25,
                            fail_at_step=fail_at)
    try:
        runner.run(model, opt_state, num_steps=args.steps, log_every=25,
                   log_fn=log)
    except RuntimeError as e:
        print(f"  !! {e} — restarting from checkpoint")

    runner2 = TrainingRunner(train_step=step_fn, data_fn=data_fn,
                             ckpt_dir=ckpt_dir, ckpt_every=25)
    model, opt_state, start = runner2.resume(model, opt_state)
    print(f"  resumed at step {start}")
    model, opt_state, monitor = runner2.run(model, opt_state,
                                            num_steps=args.steps,
                                            start_step=start, log_every=25,
                                            log_fn=log)
    print(f"done. duplicates masked: {dup['total']}; "
          f"straggler stats: {monitor.summary()}")
    out = {"params": n, "resumed_at": start, "duplicates": dup["total"],
           "losses": losses, "ckpt_dir": ckpt_dir,
           "final_step": checkpoint.latest_step(ckpt_dir)}
    if args.device_budget_bytes is not None:
        deduper.flush()
        h = deduper.handle
        ts = h.tier_stats()
        print(f"tiered dedup: {h.count()} keys over a "
              f"{ts['device_budget_bytes']}B device budget "
              f"(device {ts['device_bytes']}B + host {ts['host_bytes']}B; "
              f"{ts['cold_levels']} cold levels, "
              f"{ts['cold_probe_keys']} cold-probed keys)")
        out["tier_stats"] = ts
        out["keys"] = h.count()
    print(f"final checkpoint: step {out['final_step']} in {ckpt_dir}")
    return out


if __name__ == "__main__":
    main()
