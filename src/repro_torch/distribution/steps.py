"""Step builders: train_step / prefill_step / decode_step / eval_step.

The counterpart of the JAX package's ``distribution/steps.py``.  Where the
JAX package returns functions for the launcher to jit, these are plain
closures run eagerly; the train step takes its gradients with
``torch.autograd``.  No step reads a value back to the host: metrics come
back as tensors.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distribution.optimizer import OptConfig, adamw_update
from repro_torch.models import decode_step as model_decode
from repro_torch.models import forward, prefill
from repro_torch.models.convert import leaves, tree_map
from repro_torch.utils import dtensor_step

AUX_LOSS_WEIGHT = 0.01


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return logz - gold


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    nll = dtensor_step.nll(_nll, logits.float(), targets)
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def loss_fn(cfg: ModelConfig, params, batch, remat: bool = False):
    """Next-token loss. batch["tokens"] is (B, T+1) unshifted."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits, aux = forward(cfg, params, {**batch, "tokens": inputs},
                          remat=remat)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        # the vision prefix has no next-token targets
        logits = logits[:, batch["patch_embeds"].shape[1]:, :]
    ce = cross_entropy(logits, targets, batch.get("mask"))
    return ce + AUX_LOSS_WEIGHT * aux, {"ce": ce, "aux": aux}


def make_train_step(cfg: ModelConfig, oc: OptConfig, remat: bool = True,
                    grad_transform: Optional[Callable] = None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    The parameters and the optimizer's moments are updated in place
    (``adamw_update``); metrics are {"loss", "ce", "aux", "lr",
    "grad_norm"} as tensors."""

    def step(params, opt_state, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, parts = loss_fn(cfg, live, batch, remat=remat)
        flat = leaves(live)
        grad_of = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
        # pop: once the transform returns, nothing holds the raw gradients
        # (7.7 GB at phase 7b's full width) through the optimizer
        grads = tree_map(lambda p: dtensor_step.grad(grad_of.pop(id(p)), p),
                         live)
        with torch.no_grad():
            if grad_transform is not None:
                grads, opt_state = grad_transform(grads, opt_state)
            params, opt_state, om = adamw_update(params, grads, opt_state, oc)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in parts.items()}, **om}
        return params, opt_state, metrics

    return step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    """(params, batch[, caches]) -> (last-token logits, caches);
    ``caches`` are zeroed buffers to fill (``models.prefill``)."""

    def step(params, batch, caches=None):
        return prefill(cfg, params, batch, max_len=max_len, caches=caches)

    return step


def make_decode_step(cfg: ModelConfig):
    """(params, caches, tokens, pos) -> (logits, caches) — serve_step."""

    def step(params, caches, tokens, pos):
        return model_decode(cfg, params, caches, tokens, pos)

    return step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def step(params, batch):
        loss, parts = loss_fn(cfg, params, batch, remat=False)
        return {"loss": loss, **parts}

    return step
