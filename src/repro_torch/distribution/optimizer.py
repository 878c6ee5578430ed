"""In-house AdamW with cosine and WSD (minicpm) schedules, in PyTorch.

The counterpart of the JAX package's ``distribution/optimizer.py``: the
same ``OptConfig``, schedule and update, each step in f32 as written
there.  Parameters and the moments are nested dicts of tensors in the
parameters' tree.  ``adamw_update`` updates the parameters and the
moments in place (the JAX package returns new arrays): at full width the
f32 masters, gradients and both moments already take 16 bytes per
parameter, and a second copy of any of them would not fit beside them.
Nothing in the update reads a value back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from repro_torch.models.convert import flatten, leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | wsd | constant
    wsd_stable_frac: float = 0.8  # WSD: fraction of steps at peak LR
    grad_clip: float = 1.0


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    """A Python number as an f32 scalar on ``like``'s device.  Dividing by
    it is the IEEE divide (PyTorch's CUDA divide by a Python scalar
    multiplies by its reciprocal)."""
    # lint: sync-ok(training step, reached from the serving roots only by the name step - one scalar per leaf)
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def schedule_lr(oc: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), an f32 scalar."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / _f32(max(oc.warmup_steps, 1), s), max=1.0)
    if oc.schedule == "constant":
        frac = torch.ones((), dtype=torch.float32, device=s.device)
    elif oc.schedule == "wsd":
        # Warmup -> Stable -> (linear) Decay, the minicpm schedule.
        stable_end = oc.total_steps * oc.wsd_stable_frac
        decay_len = _f32(max(oc.total_steps - stable_end, 1.0), s)
        frac = torch.where(
            s <= _f32(stable_end, s), _f32(1.0, s),
            torch.clamp(1.0 - (s - _f32(stable_end, s)) / decay_len,
                        min=0.0))
    else:  # cosine
        prog = torch.clamp(s / _f32(max(oc.total_steps, 1), s), 0.0, 1.0)
        frac = 0.5 * (1.0 + torch.cos(_f32(torch.pi, s) * prog))
    return _f32(oc.lr, s) * warm * frac


def init_opt_state(params) -> Dict[str, Any]:
    """``mu`` and ``nu`` as f32 zeros in the parameters' tree, ``step`` an
    int32 scalar on their device."""
    dev = leaves(params)[0].device
    # zeros_like keeps a DTensor parameter's placement (the dry-run)
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, state, oc: OptConfig):
    """One AdamW step.  Updates ``params``, ``state["mu"]`` and
    ``state["nu"]`` in place; returns (params, new_state, metrics) with
    ``new_state["step"]`` a new tensor and metrics {"lr", "grad_norm"}."""
    step = state["step"] + 1
    lr = schedule_lr(oc, step)

    gnorm = global_norm(grads)
    scale = (torch.clamp(_f32(oc.grad_clip, gnorm) / (gnorm + 1e-9), max=1.0)
             if oc.grad_clip else 1.0)

    b1, b2 = oc.beta1, oc.beta2
    s = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(_f32(b1, s), s)
    bc2 = 1.0 - torch.pow(_f32(b2, s), s)

    for (_, p), (_, g), (_, mu), (_, nu) in zip(
            flatten(params), flatten(grads), flatten(state["mu"]),
            flatten(state["nu"])):
        g = g.float() * scale
        mu.mul_(b1).add_(g * (1 - b1))              # b1 mu + (1 - b1) g
        nu.mul_(b2).add_(g * (1 - b2) * g)          # b2 nu + (1 - b2) g g
        delta = (mu / bc1).div_(torch.sqrt(nu / bc2).add_(oc.eps))
        delta.add_(p.float() * oc.weight_decay)
        p.copy_(p.float() - delta.mul_(lr))
    new_state = {**state, "step": step}
    return params, new_state, {"lr": lr, "grad_norm": gnorm}
