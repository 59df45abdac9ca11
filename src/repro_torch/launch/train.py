"""Training entry point: a restartable loop with checkpointing, heartbeat/straggler
monitoring and optional gradient compression.

  python -m repro_torch.launch.train --arch qwen3-1.7b --preset tiny \\
      --steps 50 --ckpt-dir /tmp/ckpt

The JAX package's flags and presets (``tiny``: the reduced config in
float32; ``100m``: 8 layers of d_model 768, 12 / 4 heads of 64, vocab 32768,
float32; ``full``: the published config), plus ``--device`` (default
``cuda``; ``--device cpu`` runs the plain versions of the kernels). Weights
are random from seed 0; batches come from ``lm_batch_stream`` (seed 1),
which starts again from its first batch on a resumed run, as the
reference's does. With ``--ckpt-dir`` the run saves every ``--ckpt-every``
steps and once at its end, and a rerun resumes after the newest checkpoint.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.synthetic import lm_batch_stream
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.ft import HeartbeatMonitor
from repro_torch.train.optimizer import adamw_init


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen3-1.7b")
    p.add_argument("--preset", default="tiny", choices=["tiny", "100m", "full"])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=20)
    p.add_argument("--compression", default=None, choices=[None, "int8"])
    p.add_argument("--log-every", type=int, default=5)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.preset == "tiny":
        cfg = reduced_config(args.arch, dtype="float32")
    elif args.preset == "100m":
        cfg = reduced_config(
            args.arch, n_layers=8, d_model=768,
            d_ff=2048 if get_config(args.arch).d_ff else 0,
            vocab_size=32768, n_heads=12, n_kv_heads=4, d_head=64,
            dtype="float32")
    else:
        cfg = get_config(args.arch)
    print(f"arch={cfg.name} params~{cfg.param_count():,}")

    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = adamw_init(params)
    start_step = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr is not None and mgr.latest() is not None:
        restored = mgr.restore({"params": params, "opt": opt})
        params, opt = restored["params"], restored["opt"]
        start_step = mgr.latest() + 1
        print(f"restored checkpoint, resuming at step {start_step}")

    step_fn = make_train_step(
        cfg, grad_accum=args.grad_accum, remat=False, lr=args.lr,
        grad_compression=args.compression)
    stream = lm_batch_stream(cfg.vocab_size, args.batch, args.seq, seed=1)
    monitor = HeartbeatMonitor(
        on_straggler=lambda r: print(f"  [straggler] step {r.step}: {r.duration:.2f}s"))

    for step in range(start_step, args.steps):
        batch = next(stream)
        t0 = time.time()
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])  # waits for the step's device work
        monitor.beat(step, time.time() - t0)
        if step % args.log_every == 0 or step == args.steps - 1:
            tok_s = args.batch * args.seq / max(time.time() - t0, 1e-9)
            print(f"step {step:5d} loss {loss:.4f} ({tok_s:,.0f} tok/s)")
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            mgr.save(step, {"params": params, "opt": opt})
    if mgr is not None:
        mgr.save(args.steps - 1, {"params": params, "opt": opt}, blocking=True)
    print("summary:", monitor.summary())
    return params


if __name__ == "__main__":
    main()
