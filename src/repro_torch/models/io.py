"""Input construction for every (arch × shape × mode) cell, in PyTorch: the
JAX package's ``models/io.py``.

``make_inputs`` returns the tensors each step function consumes, drawn
from numpy's generator exactly as the JAX package draws them, so both
packages get the same inputs from one seed.  Modality front ends are
stubs, as there: audio and vision entries receive precomputed frame and
patch embeddings.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.models.transformer import init_cache


def _arr(shape, dtype, rng: Optional[np.random.Generator], device,
         kind: str = "normal", maxval: int = 2) -> torch.Tensor:
    if torch.device(device).type == "meta":   # shapes only (the dry-run)
        return torch.empty(shape, dtype=dtype, device=device)
    if kind == "tokens":
        a = rng.integers(0, maxval, size=shape)
    elif kind == "ones":
        a = np.ones(shape)
    elif kind == "positions":
        a = np.broadcast_to(np.arange(shape[-1], dtype=np.int32), shape)
    else:
        # f64 draws rounded once to the dtype, as jnp.asarray rounds them
        a = rng.standard_normal(shape) * 0.02
    return torch.as_tensor(np.array(a)).to(device=device, dtype=dtype)


def vision_split(cfg: ModelConfig, seq: int) -> Tuple[int, int]:
    """(S_vis, S_text) for VLM shapes."""
    s_vis = int(seq * cfg.vision_prefix_frac)
    s_vis = min(max(s_vis, 0), seq - 8)
    return s_vis, seq - s_vis


def make_inputs(cfg: ModelConfig, kind: str, seq: int, batch: int,
                seed: int = 0, device="cuda") -> Dict[str, Any]:
    """``kind`` train | prefill | decode.  Returns
       train:   {"batch": {...}}
       prefill: {"batch": {...}, "max_len": int}
       decode:  {"tokens", "pos", "caches"} (``pos`` a scalar).
    ``device="meta"`` gives the shapes only and draws nothing."""
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size
    i32, f32 = torch.int32, torch.float32

    def arr(shape, dtype, kind_="normal", maxval=2):
        return _arr(shape, dtype, rng, device, kind_, maxval)

    def decode(length, **enc):
        caches = init_cache(cfg, batch, max_len=length, device=device, **enc)
        return {"tokens": arr((batch, 1), i32, "tokens", v),
                "pos": torch.tensor(length - 1, dtype=i32, device=device),
                "caches": caches}

    if cfg.encoder_decoder:
        dec = min(cfg.dec_seq, max(seq // 8, 16))
        if kind == "train":
            return {"batch": {
                "frames": arr((batch, seq, cfg.d_model), COMPUTE_DTYPE),
                "tokens": arr((batch, dec + 1), i32, "tokens", v),
                "mask": arr((batch, dec), f32, "ones"),
            }}
        if kind == "prefill":
            return {"batch": {
                "frames": arr((batch, seq, cfg.d_model), COMPUTE_DTYPE),
                "tokens": arr((batch, dec), i32, "tokens", v),
            }, "max_len": dec}
        return decode(dec, enc_len=seq)

    if cfg.family == "vlm":
        s_vis, s_text = vision_split(cfg, seq)
        if kind in ("train", "prefill"):
            b = {
                "tokens": arr((batch, s_text + (1 if kind == "train" else 0)),
                              i32, "tokens", v),
                "patch_embeds": arr((batch, s_vis, cfg.d_model),
                                    COMPUTE_DTYPE),
                "positions": arr((3, batch, seq), i32, "positions"),
            }
            if kind == "train":
                b["mask"] = arr((batch, s_text), f32, "ones")
                return {"batch": b}
            return {"batch": b, "max_len": seq}
        return decode(seq)

    # ---- plain LM families (dense / moe / ssm / hybrid) ----
    if kind == "train":
        return {"batch": {"tokens": arr((batch, seq + 1), i32, "tokens", v),
                          "mask": arr((batch, seq), f32, "ones")}}
    if kind == "prefill":
        return {"batch": {"tokens": arr((batch, seq), i32, "tokens", v)},
                "max_len": seq}
    return decode(seq)


def make_inputs_for_shape(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                          device="cuda"):
    return make_inputs(cfg, shape.kind, shape.seq_len, shape.global_batch,
                       seed=seed, device=device)
