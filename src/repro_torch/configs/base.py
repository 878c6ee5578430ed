"""Model + shape configuration system."""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention features
    qk_norm: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    sliding_window: int = 0          # window size for local layers
    local_global_period: int = 0     # >0: alternate local/global with period 2
    rope_theta: float = 10000.0
    mrope: bool = False              # qwen2-vl 3-section M-RoPE

    # MLP / MoE
    moe: bool = False
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_period: int = 1              # MoE layer every `moe_period` layers
    moe_dense_prefix: int = 0        # first k layers use dense MLP (deepseek)
    capacity_factor: float = 1.25
    moe_impl: str = "einsum"         # einsum (GShard dispatch) | sort

    # SSM (mamba-1)
    ssm: bool = False
    attn_period: int = 0             # hybrid: one attn layer per period (jamba)
    attn_offset: int = 0             # position of the attn layer in the period
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2

    # encoder-decoder (whisper)
    encoder_decoder: bool = False
    enc_layers: int = 0
    dec_seq: int = 448               # decoder length for enc-dec shapes
    frontend: str = "none"           # audio | vision stub

    # vlm stub
    vision_prefix_frac: float = 0.0  # fraction of seq filled by patch embeds

    # misc
    rmsnorm_eps: float = 1e-6
    tie_embeddings: bool = False
    lr_schedule: str = "cosine"      # cosine | wsd (minicpm)
    sub_quadratic: bool = False      # eligible for long_500k

    # ---------------- derived ----------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(self.d_model // 16, 1)

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d
        layers = self.num_layers + (self.enc_layers if self.encoder_decoder else 0)
        attn_params = d * (self.num_heads * hd) + 2 * d * (self.kv_heads * hd) \
            + (self.num_heads * hd) * d
        for i in range(layers):
            if self._layer_kind(i) == "ssm":
                di, s, r = self.d_inner, self.ssm_state, self.dt_rank
                n += d * 2 * di + di * self.ssm_conv + di * (r + 2 * s)
                n += r * di + di * s + di + di * d
            else:
                n += attn_params
        if self.encoder_decoder:  # decoder cross-attention blocks
            n += self.num_layers * attn_params
        if self.d_ff > 0:
            for i in range(layers):
                if self._layer_is_moe(i):
                    n += d * self.num_experts  # router
                    n += self.num_experts * 3 * d * self.d_ff
                    n += self.num_shared_experts * 3 * d * self.d_ff
                else:
                    n += 3 * d * self.d_ff
        return int(n)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts that fire)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        # subtract inactive expert params
        n_moe_layers = sum(1 for i in range(self.num_layers) if self._layer_is_moe(i))
        inactive = (self.num_experts - self.experts_per_token)
        total -= n_moe_layers * inactive * 3 * d * self.d_ff
        return int(total)

    # which layers are what
    def _layer_kind(self, i: int) -> str:
        if self.encoder_decoder:
            return "attn"
        if self.ssm and self.attn_period == 0:
            return "ssm"
        if self.ssm and self.attn_period > 0:
            return "attn" if (i % self.attn_period) == self.attn_offset else "ssm"
        return "attn"

    def _layer_is_moe(self, i: int) -> bool:
        if not self.moe:
            return False
        if i < self.moe_dense_prefix:
            return False
        return ((i - self.moe_dense_prefix) % self.moe_period) == 0

    def _layer_is_local(self, i: int) -> bool:
        if self.local_global_period <= 0:
            return False
        return (i % 2) == 0  # even layers local, odd global (gemma2)

    def layer_specs(self) -> List["LayerSpec"]:
        return [
            LayerSpec(
                kind=self._layer_kind(i),
                moe=self._layer_is_moe(i),
                local=self._layer_is_local(i),
            )
            for i in range(self.num_layers)
        ]

    def scan_period(self) -> int:
        """Length of the repeating layer pattern (for scan-over-layers)."""
        specs = self.layer_specs()
        for period in (1, 2, 4, 8, 16):
            if len(specs) % period:
                continue
            blocks = [tuple(specs[i : i + period]) for i in range(0, len(specs), period)]
            if all(b == blocks[0] for b in blocks):
                return period
        return 0  # irregular — no scan


@dataclass(frozen=True)
class LayerSpec:
    kind: str  # attn | ssm
    moe: bool
    local: bool


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", "train", 4096, 256),
    ShapeSpec("prefill_32k", "prefill", 32768, 32),
    ShapeSpec("decode_32k", "decode", 32768, 128),
    ShapeSpec("long_500k", "decode", 524288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def supported_shapes(cfg: ModelConfig) -> List[str]:
    """Shape cells this arch runs; long_500k only for sub-quadratic archs."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    period = max(cfg.scan_period(), 1)
    n_layers = max(2 * period, period)
    if cfg.encoder_decoder:
        n_layers = 2
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.kv_heads, heads if cfg.kv_heads >= cfg.num_heads else 2))
    return replace(
        cfg,
        name=cfg.name + "-reduced",
        num_layers=n_layers,
        enc_layers=2 if cfg.encoder_decoder else 0,
        d_model=64,
        num_heads=heads,
        kv_heads=kv,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 8) if cfg.moe else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.moe else 0,
        num_shared_experts=min(cfg.num_shared_experts, 1),
        moe_dense_prefix=min(cfg.moe_dense_prefix, 1),
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        ssm_state=min(cfg.ssm_state, 8),
        dec_seq=16 if cfg.encoder_decoder else cfg.dec_seq,
        attn_period=cfg.attn_period,
        attn_offset=min(cfg.attn_offset, max(cfg.attn_period - 1, 0)),
    )
