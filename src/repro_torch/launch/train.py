"""Training driver (the JAX package's ``repro.launch.train``).

Trains a registry architecture on the synthetic token stream, on the card
by default (``--device cpu`` for tests); ``--reduced`` trains the reduced
variant.  Weights are drawn from a generator seeded 0 on the device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --reduced --steps 200 --batch 8 --seq 128 --ckpt /tmp/ckpt

``--ckpt`` writes the parameters in the reference's layout
(``models.convert.reference_params``): ``repro.checkpoint.restore`` reads
them, and ``repro_torch.checkpoint.restore`` +
``models.convert.load_reference_params`` load them into a fresh model.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.checkpoint import save
from repro_torch.data.synthetic import make_batch_for
from repro_torch.explore.runner import resolve_device
from repro_torch.models.convert import reference_params
from repro_torch.models.registry import ARCH_IDS, build_model, get_config
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.serving.engine import sync
from repro_torch.training.train_lib import init_params, make_train_step


@dataclasses.dataclass
class TrainRun:
    """What :func:`run` leaves: the trained model, each step's metrics
    (device tensors) and the checkpoint written, if any."""
    model: torch.nn.Module
    metrics: List[Dict[str, torch.Tensor]]
    ckpt: Optional[str] = None


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu for tests)")
    return ap.parse_args(argv)


def run(argv=None) -> TrainRun:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train] {cfg.arch_id}{' (reduced)' if args.reduced else ''}: "
          f"{n_params/1e6:.1f}M params, {args.steps} steps "
          f"batch={args.batch} seq={args.seq}")

    opt = get_optimizer(cfg.optimizer,
                        warmup_cosine(args.lr, args.steps // 10, args.steps))
    opt_state = opt.init(init_params(model))
    step_fn = make_train_step(model, cfg, opt)

    out = TrainRun(model, [])
    t0 = time.time()
    for i in range(args.steps):
        batch = make_batch_for(cfg, args.batch, args.seq, seed=i)
        opt_state, metrics = step_fn(opt_state, batch)
        out.metrics.append(metrics)
        if (i + 1) % args.log_every == 0 or i == 0:
            m = {k: float(v) for k, v in metrics.items()}
            toks = args.batch * args.seq * (i + 1)
            print(f"  step {i+1:5d}  loss={m['loss']:.4f} ce={m['ce']:.4f} "
                  f"gnorm={m.get('grad_norm', 0):.2f} "
                  f"({toks/(time.time()-t0):.0f} tok/s)")
    sync(dev)
    if args.ckpt:
        out.ckpt = save(args.ckpt, reference_params(model), step=args.steps)
        print(f"[train] checkpoint -> {out.ckpt}")
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
