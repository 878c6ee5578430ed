"""Serving helpers around the model: the reference model, KV extraction and
injection, the dense slot arena and the paged decode arena (DESIGN.md §9,
§12), in PyTorch.

The counterpart of the serving half of the JAX package's
``core/quality.py``.  Caches and pools are updated in place (the JAX
package returns new arrays); the step functions are plain closures where
the JAX package jits.  The quality evaluation and the reference model's
training are not ported yet: :func:`get_reference_model` loads the cached
weights and raises when they are missing.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.kvcache import KVCache
from repro_torch.core.pipeline import DeviceKVCache
from repro_torch.data.synthetic import make_prompt
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models.layers import PagedKV

CACHE_DIR = Path(os.environ.get("REPRO_CACHE_DIR",
                                Path.home() / ".cache" / "repro"))
REF_STEPS = int(os.environ.get("REPRO_REF_STEPS", "400"))


# ---------------------------------------------------------------------------
# Reference model (trained by the JAX package, cached to disk)
# ---------------------------------------------------------------------------
def _params_path(steps: int) -> Path:
    return CACHE_DIR / f"tiny_lm_s{steps}.npz"


def get_reference_model(steps: int = REF_STEPS, seed: int = 0,
                        device="cuda"):
    """Load the cached ``tiny-lm`` reference weights (``arr_i`` in the JAX
    tree's sorted-key flatten order) onto ``device``.  Raises
    FileNotFoundError when the cache is missing: training is not ported."""
    from repro_torch.models.convert import from_flat_arrays

    del seed  # the cache file is keyed by steps, as in the JAX package
    cfg = get_config("tiny-lm")
    path = _params_path(steps)
    if not path.exists():
        raise FileNotFoundError(
            f"{path} is missing; train it with the JAX package "
            f"(repro.core.quality.get_reference_model)")
    with np.load(path) as data:
        arrays = [data[f"arr_{i}"] for i in range(len(data.files))]
    return cfg, from_flat_arrays(arrays, cfg, device)


# ---------------------------------------------------------------------------
# Cache <-> KVCache conversion (attention layers, dense stacks)
# ---------------------------------------------------------------------------
def _attn_layers(cfg):
    """(part, name, block) of every attention layer in flatten order."""
    from repro_torch.models.transformer import plan_stack

    plan = plan_stack(cfg)
    out = [("prefix", f"layer{i}", None)
           for i, spec in enumerate(plan.prefix_specs) if spec.kind == "attn"]
    for blk in range(plan.n_blocks):
        out += [("blocks", f"layer{j}", blk)
                for j, spec in enumerate(plan.period_specs)
                if spec.kind == "attn"]
    return out


def _leaf(caches, part, name, blk, key):
    buf = caches[part][name][key]
    return buf if blk is None else buf[blk]


def extract_kv(cfg, caches, batch_idx: int, upto: int) -> DeviceKVCache:
    """One batch element's attention KV as (L, H, S, D) tensors, left on
    the caches' device in their dtype."""
    ks, vs = [], []
    for part, name, blk in _attn_layers(cfg):
        ks.append(_leaf(caches, part, name, blk, "k")[batch_idx, :upto]
                  .transpose(0, 1))
        vs.append(_leaf(caches, part, name, blk, "v")[batch_idx, :upto]
                  .transpose(0, 1))
    return DeviceKVCache(torch.stack(ks), torch.stack(vs))


def copy_cache_slot(cfg, dst, src, slot: int, src_idx: int = 0):
    """Write row ``src_idx`` of the ``src`` caches into row ``slot`` of the
    ``dst`` arena, in place — how a batch-1 prefill lands in its slot."""
    for part, axis in (("prefix", 0), ("blocks", 1)):
        for name, c in dst[part].items():
            for key in ("k", "v"):
                d, s = c[key], src[part][name][key]
                if axis == 0:
                    d[slot] = s[src_idx].to(d.dtype)
                else:
                    d[:, slot] = s[:, src_idx].to(d.dtype)
    return dst


def _as_tensor(arr, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(arr).to(device=like.device, dtype=like.dtype)


def inject_kv(cfg, caches, batch_idx: int, kv: KVCache):
    """Write a (possibly lossy) KVCache into row ``batch_idx`` of the
    caches, in place."""
    upto = kv.seq
    for li, (part, name, blk) in enumerate(_attn_layers(cfg)):
        for key, arr in (("k", kv.k), ("v", kv.v)):
            buf = _leaf(caches, part, name, blk, key)
            buf[batch_idx, :upto] = _as_tensor(arr[li], buf).transpose(0, 1)
    return caches


# ---------------------------------------------------------------------------
# Paged decode arena (DESIGN.md §12)
# ---------------------------------------------------------------------------
def init_paged_pools(cfg, num_pages: int, page_size: int, group: int,
                     device="cuda"):
    """The paged arena's device pools ``(pool, qcodes, qscales)``:
    ``init_cache``'s tree with (batch, max_len) replaced by (num_pages,
    page_size) — bf16 fp pages — and parallel int8 code and f32 scale
    pools (one scale per ``group`` channels) sharing the SAME page ids.
    Positions below a slot's ``quant_len`` read the quant pools.  Page 0
    is the reserved scratch page."""
    from repro_torch.models.transformer import init_cache

    pool = init_cache(cfg, num_pages, max_len=page_size, device=device)

    def like(fn):
        return {part: {name: {key: fn(t) for key, t in c.items()}
                       for name, c in pool[part].items()}
                for part in ("prefix", "blocks")}

    qcodes = like(lambda t: torch.zeros(t.shape, dtype=torch.int8,
                                        device=t.device))
    qscales = like(lambda t: torch.zeros(
        t.shape[:-1] + (t.shape[-1] // group,), dtype=torch.float32,
        device=t.device))
    return pool, qcodes, qscales


def _pad_rows(x: torch.Tensor, target: int, axis: int) -> torch.Tensor:
    cur = x.shape[axis]
    if cur >= target:
        return x.narrow(axis, 0, target)
    shape = list(x.shape)
    shape[axis] = target - cur
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _device_of(tree) -> torch.device:
    for part in ("prefix", "blocks"):
        for c in tree[part].values():
            return next(iter(c.values())).device
    raise ValueError("empty cache tree")


def _paged_steps(cfg_name: str, page_size: int):
    """The paged arena's step functions for one model config:
    ``(arena, copy)``.

    ``arena(params, pool, qcodes, qscales, bt, quant_len, tokens, pos,
    mask)`` is one masked decode step over every slot: attention reads
    the pages in place through the Hopper ``paged_attention_arena``
    kernel (quant-resident positions below ``quant_len``), then ONLY the
    newly written K/V row of each slot is scattered to its page, in
    place.  Parked rows (mask False) are pinned to the view's last
    position, which maps to the scratch page or the slot's own
    never-attended tail row, so their writes are inert.  Returns (next
    tokens (B,), pool).

    ``copy(pool, src, bt_row, src_idx)`` lands row ``src_idx`` of prefill
    caches in the pages of ``bt_row`` (0 entries spill into scratch).
    """
    from repro_torch.models.transformer import decode_step

    cfg = get_config(cfg_name)
    ps = page_size

    def arena(params, pool, qcodes, qscales, bt, quant_len, tokens, pos,
              mask):
        view_len = bt.shape[1] * ps
        pos = torch.where(mask, pos, view_len - 1).to(torch.int32)
        caches = {part: {name: PagedKV(
            c["k"], c["v"], qcodes[part][name]["k"],
            qscales[part][name]["k"], qcodes[part][name]["v"],
            qscales[part][name]["v"], bt, quant_len)
            for name, c in pool[part].items()}
            for part in ("prefix", "blocks")}
        logits, new = decode_step(cfg, params, caches, tokens, pos)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        p = pos.long()
        page_idx = bt.long().gather(1, (p // ps)[:, None])[:, 0]
        offset = p % ps
        for part in ("prefix", "blocks"):
            for name, upd in new[part].items():
                for key in ("k", "v"):
                    buf = pool[part][name][key]
                    row = upd[key + "_new"][..., 0, :, :].to(buf.dtype)
                    if part == "prefix":
                        buf[page_idx, offset] = row
                    else:
                        buf[:, page_idx, offset] = row
        return torch.where(mask, nxt, torch.zeros_like(nxt)), pool

    def copy(pool, src, bt_row, src_idx):
        pps = bt_row.shape[0]
        idx = bt_row.long()
        for part in ("prefix", "blocks"):
            for name, c in pool[part].items():
                for key in ("k", "v"):
                    p, s = c[key], src[part][name][key]
                    if part == "prefix":
                        row = _pad_rows(s[src_idx], pps * ps, 0)
                        p[idx] = row.reshape(pps, ps, *row.shape[1:]).to(
                            p.dtype)
                    else:
                        row = _pad_rows(s[:, src_idx], pps * ps, 1)
                        p[:, idx] = row.reshape(row.shape[0], pps, ps,
                                                *row.shape[2:]).to(p.dtype)
        return pool

    return arena, copy


def copy_cache_slot_paged(cfg, pool, src, bt_row, page_size: int,
                          src_idx: int = 0):
    """Paged ``copy_cache_slot``: land one prefilled source row in the
    pages of ``bt_row`` (a (PPS,) int32 row; 0 entries spill to scratch)."""
    _, copy = _paged_steps(cfg.name, page_size)
    return copy(pool, src, torch.as_tensor(np.asarray(bt_row),
                                           device=_device_of(pool)),
                src_idx)


def _paged_scatter(cfg, pool, bt_row, k_arr, v_arr, upto: int,
                   page_size: int):
    """Scatter per-layer (L, H, S, X) k/v arrays into a slot's pages, in
    place — the page-map core of ``inject_kv_paged``/
    ``inject_quant_pages``.  Only the first ``ceil(upto / page_size)``
    owned pages are written (partial-page tails are zero-filled; the slot
    is fresh, so nothing real is clobbered)."""
    n_used = -(-upto // page_size)
    rows = torch.as_tensor(np.asarray(bt_row)[:n_used], dtype=torch.long,
                           device=_device_of(pool))
    for key, arr in (("k", k_arr), ("v", v_arr)):
        for li, (part, name, blk) in enumerate(_attn_layers(cfg)):
            buf = pool[part][name][key]
            a = _as_tensor(arr[li], buf).transpose(0, 1)      # (S, H, X)
            a = _pad_rows(a, n_used * page_size, 0)
            pages = a.reshape(n_used, page_size, *a.shape[1:])
            if blk is None:
                buf[rows] = pages
            else:
                buf[blk, rows] = pages
    return pool


def inject_kv_paged(cfg, pool, bt_row, kv: KVCache, page_size: int):
    """Paged ``inject_kv``: write a restored KVCache into a fresh slot's
    pages as a page-map operation."""
    return _paged_scatter(cfg, pool, bt_row, kv.k, kv.v, kv.seq, page_size)


def inject_quant_pages(cfg, qcodes, qscales, bt_row, k_codes, k_scales,
                       v_codes, v_scales, upto: int, page_size: int):
    """Land packed quantized KV straight in the quant page pools — the
    zero-materialization injection path for paged-eligible strategies.
    ``k_codes``/``v_codes`` are (L, H, S, D) signed int8;
    ``k_scales``/``v_scales`` are (L, H, S, D/group) f32 (already
    round-tripped through fp16, so the fused dequant is bit-identical to
    the materialized ``group_dequantize`` + inject path)."""
    new_qc = _paged_scatter(cfg, qcodes, bt_row, k_codes, v_codes, upto,
                            page_size)
    new_qs = _paged_scatter(cfg, qscales, bt_row, k_scales, v_scales, upto,
                            page_size)
    return new_qc, new_qs


# ---------------------------------------------------------------------------
# Dense arena steps
# ---------------------------------------------------------------------------
def _jitted_steps(cfg_name: str, seq: int, batch: int, max_len: int):
    """Returns (prefill, decode, arena_decode) for one config — the JAX
    package's jitted trio, as plain closures.

    ``arena_decode(params, caches, tokens, pos, mask)`` is the masked
    batched decode of the slot arena (DESIGN.md §9): ``tokens`` (B, 1),
    ``pos`` (B,) per-slot next cache positions, ``mask`` (B,) live-slot
    flags.  Every slot advances in ONE model call; parked rows are pinned
    to the scratch position ``max_len - 1``, which no live query position
    ever attends to, so their cache writes are inert.  The next token per
    slot comes from an on-device argmax; the caller pulls the (B,) token
    vector back once per iteration.
    """
    from repro_torch.models import decode_step, prefill

    del seq, batch  # shapes are dynamic here
    cfg = get_config(cfg_name)

    def pre(p, b):
        return prefill(cfg, p, b, max_len=max_len)

    def dec(p, c, t, pos):
        return decode_step(cfg, p, c, t, pos)

    def arena(p, c, t, pos, mask):
        pos = torch.where(mask, pos, max_len - 1).to(torch.int32)
        logits, c = decode_step(cfg, p, c, t, pos)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return torch.where(mask, nxt, torch.zeros_like(nxt)), c

    return pre, dec, arena


def _prompts_for(workload: str, n: int, seq: int, seed: int
                 ) -> Tuple[np.ndarray, List[str]]:
    tok = ByteTokenizer()
    rng = np.random.default_rng(seed)
    rows, answers = [], []
    for _ in range(n):
        prompt, ans = make_prompt(workload, rng, approx_len=seq + 32)
        ids = tok.encode(prompt)
        ids = ids[-seq:] if len(ids) >= seq else tok.pad_to(ids, seq)
        rows.append(ids)
        answers.append(ans)
    return np.stack(rows), answers
