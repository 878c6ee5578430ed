"""Mamba-1 selective SSM block (falcon-mamba / jamba mixer) in PyTorch:
the JAX package's ``models/ssm.py``.

  h_t = exp(dt_t * A) ⊙ h_{t-1} + dt_t * B_t * x_t
  y_t = C_t · h_t + D ⊙ x_t

with a depthwise causal conv front end and SiLU gating.  The selective
scan is an f32 recurrence over positions, ``utils/scan.py::scan`` here
as ``lax.scan`` is there (a loop on real tensors, one counted step on
the dry-run's shape-only tensors); the carried state {"ssm": (B,
d_inner, n) f32, "conv": (B, d_inner, k-1) bf16} is the attention-free
layers' cache.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import COMPUTE_DTYPE, _einsum_bf16
from repro_torch.utils import dtensor_step
from repro_torch.utils.scan import scan


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           state: Optional[torch.Tensor] = None):
    """x: (B, S, di); w: (di, k).  Returns (y, new_state (B, di, k-1)).
    Each output sums its k taps in f32 in tap order, rounded once to x's
    dtype, as XLA's grouped convolution of bf16 operands does."""
    bsz, s, di = x.shape
    k = w.shape[1]
    xt = x.transpose(1, 2)                                  # (B, di, S)
    pad = (torch.zeros((bsz, di, k - 1), dtype=x.dtype, device=x.device)
           if state is None else state.to(x.dtype))
    xp = torch.cat([pad, xt], dim=-1)                       # (B, di, S+k-1)
    wf = w.to(x.dtype).float()
    xf = xp.float()
    acc = xf[:, :, 0:s] * wf[None, :, 0:1]
    for j in range(1, k):
        acc = acc + xf[:, :, j:j + s] * wf[None, :, j:j + 1]
    y = acc.to(x.dtype) + b.to(x.dtype)[None, :, None]
    new_state = (xp[:, :, -(k - 1):] if k > 1
                 else torch.zeros((bsz, di, 0), dtype=x.dtype,
                                  device=x.device))
    return y.transpose(1, 2), new_state


def _ssm_params(params, cfg: ModelConfig, x_conv: torch.Tensor):
    """Input-dependent (dt, B, C) from the conv output."""
    n, r = cfg.ssm_state, cfg.dt_rank
    proj = _einsum_bf16("bsd,dk->bsk", x_conv, params["x_proj"]).float()
    # over a mesh the contraction over d_inner leaves a pending sum on the
    # "model" axis: reduced here, once, not inside every position's step
    proj = dtensor_step.model_axis_on(proj, None)
    dt_r, b_mat, c_mat = torch.split(proj, [r, n, n], dim=-1)
    pre = (torch.einsum("bsr,rd->bsd", dt_r, params["dt_proj_w"].float())
           + params["dt_proj_b"].float())
    dt = torch.logaddexp(pre, torch.zeros_like(pre))        # jax.nn.softplus
    return dt, b_mat, c_mat


def _scan_step(h, x_t, a):
    """One position of the selective scan: h (B, di, n) f32, the
    position's x, dt (B, di) and B, C (B, n), A (di, n)."""
    xt, dt_t, b_t, c_t = x_t
    da = torch.exp(dt_t[..., None] * a)                     # (B, di, n)
    h = h * da + (dt_t * xt)[..., None] * b_t[:, None, :]
    return h, torch.einsum("bdn,bn->bd", h, c_t)


def apply_mamba(params, cfg: ModelConfig, x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None):
    """Returns (y, new_state); ``state`` (decode) carries the recurrence
    and the conv window from the previous positions."""
    bsz, s, _ = x.shape
    di, n = cfg.d_inner, cfg.ssm_state

    xz = _einsum_bf16("bsd,de->bse", x, params["in_proj"])
    x_in, z = xz[..., :di], xz[..., di:]
    x_conv, new_conv = _causal_depthwise_conv(
        x_in, params["conv_w"], params["conv_b"],
        state["conv"] if state is not None else None)
    xcf = x_conv.float()
    x_conv = (xcf * torch.sigmoid(xcf)).to(COMPUTE_DTYPE)   # jax.nn.silu

    dt, b_mat, c_mat = _ssm_params(params, cfg, x_conv)
    a = -torch.exp(params["a_log"].float())                 # (di, n)
    h = (state["ssm"].float() if state is not None
         else torch.zeros((bsz, di, n), dtype=torch.float32,
                          device=x.device))
    xf = x_conv.float()
    h, y = scan(_scan_step, h, (xf, dt, b_mat, c_mat), (a,))  # y (B, S, di)
    y = y + xf * params["d_skip"].float()
    zf = z.float()
    y = y * (zf * torch.sigmoid(zf))
    out = _einsum_bf16("bsd,de->bse", y, params["out_proj"])
    return out.to(x.dtype), {"ssm": h, "conv": new_conv}


def init_mamba_state(cfg: ModelConfig, batch: int, device="cuda",
                     n=None) -> Dict[str, torch.Tensor]:
    """Zeroed state of one mamba layer (``n`` stacks it for a block)."""
    lead = (n,) if n else ()
    di, k = cfg.d_inner, cfg.ssm_conv
    return {
        "ssm": torch.zeros(lead + (batch, di, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, di, k - 1), dtype=COMPUTE_DTYPE,
                            device=device),
    }
