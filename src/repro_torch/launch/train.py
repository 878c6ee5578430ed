"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

The counterpart of the JAX package's ``launch/train.py``: real training
with checkpoint/restart, WSD or cosine schedules, optional gradient
compression with error feedback (``quant_pack`` / ``dequant_unpack`` on
the card), and a crash-recovery path (restore the latest checkpoint and
continue).  Runs on CUDA unless the caller passes ``--device cpu``;
``--remat`` recomputes each block in the backward pass.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.synthetic import make_batch
from repro_torch.distribution.grad_compress import init_ef_state, make_grad_transform
from repro_torch.distribution.optimizer import OptConfig, init_opt_state
from repro_torch.distribution.steps import make_train_step
from repro_torch.models import init_params


def train(arch: str, steps: int = 100, batch: int = 8, seq: int = 128,
          lr: float = 3e-3, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, grad_compress_bits: int = 0,
          resume: bool = True, seed: int = 0, log_every: int = 10,
          device="cuda", remat: bool = False):
    cfg = get_config(arch)
    device = torch.device(device)
    params = init_params(cfg, seed=seed, device=device)
    oc = OptConfig(lr=lr, warmup_steps=max(steps // 10, 5), total_steps=steps,
                   schedule=cfg.lr_schedule, weight_decay=0.01)
    opt_state = init_opt_state(params)

    grad_transform = None
    if grad_compress_bits:
        grad_transform = make_grad_transform(bits=grad_compress_bits)
        opt_state["ef"] = init_ef_state(params)

    step_fn = make_train_step(cfg, oc, remat=remat,
                              grad_transform=grad_transform)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr is not None and resume and mgr.latest_step() is not None:
        restored = mgr.restore({"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        start = mgr.latest_step()
        print(f"[train] resumed from step {start}")

    losses = []
    t0 = time.time()
    for i in range(start, steps):
        tokens, mask = make_batch("mixed", batch, seq, seed=seed * 99991 + i)
        b = {"tokens": torch.as_tensor(tokens).to(device),
             "mask": torch.as_tensor(mask[:, 1:]).to(device)}
        params, opt_state, metrics = step_fn(params, opt_state, b)
        losses.append(float(metrics["loss"]))
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i+1}/{steps} loss={losses[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0)/max(i+1-start,1)*1e3:.0f} ms/step)")
        if mgr is not None and (i + 1) % ckpt_every == 0:
            mgr.save(i + 1, {"params": params, "opt": opt_state},
                     metadata={"loss": losses[-1]}, background=True)
    if mgr is not None:
        mgr.save(steps, {"params": params, "opt": opt_state},
                 metadata={"loss": losses[-1] if losses else float("nan")})
        mgr.wait()
    return params, opt_state, losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-lm")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compress-bits", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--remat", action="store_true")
    args = ap.parse_args(argv)
    _, _, losses = train(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        lr=args.lr, ckpt_dir=args.ckpt_dir or None,
        ckpt_every=args.ckpt_every,
        grad_compress_bits=args.grad_compress_bits, seed=args.seed,
        device=args.device, remat=args.remat)
    print(f"final loss: {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
