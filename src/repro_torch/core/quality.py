"""The reference model, KV extraction and injection, the dense slot arena
and the paged decode arena (DESIGN.md §9, §12), and the quality
evaluation that scores a strategy by teacher-forced agreement, in
PyTorch.

The counterpart of the JAX package's ``core/quality.py``.  Caches and
pools are updated in place (the JAX package returns new arrays); the step
functions are plain closures where the JAX package jits.  The quality
functions run on the device of the reference parameters, and their
compressed-KV decode goes through the pipeline's device stages.
:func:`get_reference_model` loads the cached ``tiny-lm`` weights and,
when the cache file is missing, trains them on the given device
(:func:`train_reference_model`) and writes the file, in the layout the
JAX package reads.
"""
from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import is_mla
from repro_torch.core.kvcache import KVCache
from repro_torch.core.pipeline import CompressionPipeline, DeviceKVCache
from repro_torch.core.strategy import StrategyConfig, is_identity
from repro_torch.data.synthetic import WORKLOADS, make_batch, make_prompt
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models.layers import PagedKV
from repro_torch.utils.timing import count_bytes, span

CACHE_DIR = Path(os.environ.get("REPRO_CACHE_DIR",
                                Path.home() / ".cache" / "repro"))
REF_STEPS = int(os.environ.get("REPRO_REF_STEPS", "400"))


# ---------------------------------------------------------------------------
# Reference model (trained once, cached to disk)
# ---------------------------------------------------------------------------
def _params_path(steps: int) -> Path:
    return CACHE_DIR / f"tiny_lm_s{steps}.npz"


def train_reference_model(steps: int = REF_STEPS, seed: int = 0,
                          batch: int = 16, seq: int = 256,
                          log_every: int = 0, device="cuda"):
    """Train tiny-lm on the mixed workload soup from the port's seeded
    init (f32 masters) on ``device``; returns (cfg, params, last loss,
    AdamW state).  The JAX package's schedule and batches (its init draws
    other numbers); it returns the first three, and the state lets a
    caller checkpoint the run or go on with it."""
    from repro_torch.distribution.optimizer import OptConfig, init_opt_state
    from repro_torch.distribution.steps import make_train_step
    from repro_torch.models.transformer import init_params

    cfg = get_config("tiny-lm")
    params = init_params(cfg, seed=seed, device=device)
    oc = OptConfig(lr=3e-3, warmup_steps=max(steps // 10, 10),
                   total_steps=steps, schedule="cosine", weight_decay=0.01)
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, oc, remat=False)
    loss = None
    t0 = time.perf_counter()
    for i in range(steps):
        tokens, mask = make_batch("mixed", batch, seq, seed=seed * 100003 + i)
        b = {"tokens": torch.as_tensor(tokens).to(device),
             "mask": torch.as_tensor(mask[:, 1:]).to(device)}
        params, opt_state, metrics = step_fn(params, opt_state, b)
        loss = metrics["loss"]
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i+1}/{steps} loss={float(loss):.3f} "
                  f"({(time.perf_counter() - t0) / (i + 1) * 1e3:.1f} "
                  f"ms/step)")
    return cfg, params, float(loss), opt_state


def get_reference_model(steps: int = REF_STEPS, seed: int = 0,
                        device="cuda"):
    """The ``tiny-lm`` reference weights on ``device``: loaded from the
    cache file (``arr_i`` in the JAX tree's sorted-key flatten order), or
    trained on first use and written there, so either package loads a
    file the other wrote."""
    from repro_torch.models.convert import from_flat_arrays, leaves

    cfg = get_config("tiny-lm")
    path = _params_path(steps)
    if path.exists():
        with np.load(path) as data:
            arrays = [data[f"arr_{i}"] for i in range(len(data.files))]
        return cfg, from_flat_arrays(arrays, cfg, device)
    cfg, params, _, _ = train_reference_model(steps=steps, seed=seed,
                                              device=device)
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{f"arr_{i}": x.detach().cpu().numpy()
                      for i, x in enumerate(leaves(params))})
    return cfg, params


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
    the caches' device in their dtype.  An attention-free stack has no KV
    to extract: refused, as the JAX package's fails on it."""
    layers = _attn_layers(cfg)
    if not layers:
        raise NotImplementedError(f"{cfg.name}: no attention layers, no KV")
    ks, vs = [], []
    for part, name, blk in layers:
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
    if isinstance(arr, torch.Tensor):
        return arr.to(device=like.device, dtype=like.dtype)
    with span("to_device"):
        count_bytes("to_device_bytes", arr)
        # lint: sync-ok(host KV arrays land on the device once per injected request)
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
    # MLA's latent layout holds no quant-resident pages
    # (``strategy.quant_resident``): its code and scale pools are empty.
    q_pages = 0 if is_mla(cfg) else num_pages

    def quant(t, width, dtype):
        """A zero pool like ``t`` (a stacked block leads with its layer
        axis) with ``q_pages`` pages of ``width`` channels."""
        return torch.zeros(t.shape[:-4] + (q_pages,) + t.shape[-3:-1]
                           + (width,), dtype=dtype, device=t.device)

    def like(fn):
        return {part: {name: {key: fn(t) for key, t in c.items()}
                       for name, c in pool[part].items()}
                for part in ("prefix", "blocks")}

    qcodes = like(lambda t: quant(t, t.shape[-1], torch.int8))
    qscales = like(lambda t: quant(t, t.shape[-1] // group, torch.float32))
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


def _paged_caches(pool, qcodes, qscales, bt, quant_len):
    """The decode step's view of the paged arena: one
    :class:`~repro_torch.models.layers.PagedKV` per attention layer,
    read in place by the Hopper kernels."""
    return {part: {name: PagedKV(
        c["k"], c["v"], qcodes[part][name]["k"], qscales[part][name]["k"],
        qcodes[part][name]["v"], qscales[part][name]["v"], bt, quant_len)
        for name, c in pool[part].items()}
        for part in ("prefix", "blocks")}


def _scatter_new_rows(pool, new, bt, pos, page_size: int, s: int) -> None:
    """Write the ``s`` new K/V rows of each slot (positions pos ..
    pos+s-1) to the pages its block table names, in place.  Positions
    beyond a slot's owned pages map to table entry 0, the scratch page."""
    p = pos.long()[:, None] + torch.arange(s, device=pos.device)[None, :]
    page_idx = bt.long().gather(1, p // page_size)              # (B, S)
    offset = p % page_size
    for part in ("prefix", "blocks"):
        for name, upd in new[part].items():
            for key in ("k", "v"):
                buf = pool[part][name][key]
                rows = upd[key + "_new"].to(buf.dtype)    # (·, B, S, H, D)
                if part == "prefix":
                    buf[page_idx, offset] = rows
                else:
                    buf[:, page_idx, offset] = rows


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
        caches = _paged_caches(pool, qcodes, qscales, bt, quant_len)
        logits, new = decode_step(cfg, params, caches, tokens, pos)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        _scatter_new_rows(pool, new, bt, pos, ps, 1)
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


def _paged_verify_steps(cfg_name: str, page_size: int, width: int):
    """The paged multi-token verify step for one config and width
    (DESIGN.md §15): ``verify(params, pool, qcodes, qscales, bt,
    quant_len, tokens, pos, mask)`` widens ``_paged_steps``'s arena decode
    to a ``(B, width)`` query block.  Each live slot feeds ``width`` tokens
    at positions ``pos .. pos+width-1``; attention reads the committed
    prefix in place through the Hopper ``paged_verify_attention_arena``
    kernel and merges the new tokens in closed form, and all ``width``
    greedy argmax outputs come back (B, width) for host-side accept-prefix
    matching.  All ``width`` K/V rows are scattered to each slot's pages;
    positions beyond a slot's ensured span map to block-table entry 0,
    the scratch page no live query reads, so slots verifying fewer drafts
    need no masking.  Parked rows pin to ``view_len - width`` (scratch or
    never-attended tail rows again).  Rejected suffixes are rolled back
    by the caller through ``PageTable.release_tail``; reads are capped at
    each slot's committed ``pos``, so the pages need no scrubbing."""
    from repro_torch.models.transformer import decode_step

    cfg = get_config(cfg_name)
    ps = page_size

    def verify(params, pool, qcodes, qscales, bt, quant_len, tokens, pos,
               mask):
        view_len = bt.shape[1] * ps
        pos = torch.where(mask, pos, view_len - width).to(torch.int32)
        caches = _paged_caches(pool, qcodes, qscales, bt, quant_len)
        logits, new = decode_step(cfg, params, caches, tokens, pos)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)   # (B, width)
        _scatter_new_rows(pool, new, bt, pos, ps, width)
        return torch.where(mask[:, None], nxt, torch.zeros_like(nxt)), pool

    return verify


def copy_cache_slot_paged(cfg, pool, src, bt_row, page_size: int,
                          src_idx: int = 0):
    """Paged ``copy_cache_slot``: land one prefilled source row in the
    pages of ``bt_row`` (a (PPS,) int32 row; 0 entries spill to scratch)."""
    _, copy = _paged_steps(cfg.name, page_size)
    # lint: sync-ok(the slot's block-table row goes to the device once per landed request)
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
    # lint: sync-ok(the slot's page rows go to the device once per landed request)
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


def _verify_steps(cfg_name: str, max_len: int, width: int):
    """The dense multi-token verify step (DESIGN.md §15): ``verify(params,
    caches, tokens, pos, mask)`` widens ``_jitted_steps``'s arena decode to
    a ``(B, width)`` query block.  Each live slot feeds its last committed
    token plus ``width-1`` drafts at positions ``pos .. pos+width-1`` and
    gets all ``width`` greedy argmax outputs back.  Parked rows pin to
    ``max_len - width`` so all ``width`` K/V row writes stay in bounds;
    the writes are inert because reads are capped at each slot's
    committed position, so rejected draft rows are overwritten by later
    steps and never attended to."""
    from repro_torch.models import decode_step

    cfg = get_config(cfg_name)

    def verify(p, c, t, pos, mask):
        pos = torch.where(mask, pos, max_len - width).to(torch.int32)
        logits, c = decode_step(cfg, p, c, t, pos)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)   # (B, width)
        return torch.where(mask[:, None], nxt, torch.zeros_like(nxt)), c

    return verify


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


def _param_device(params) -> torch.device:
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


def _greedy_decode(dec_fn, params, caches, first_tokens: torch.Tensor,
                   start_pos: int, steps: int) -> np.ndarray:
    """Greedy continuation of ``first_tokens`` (B, 1) int32 on the device
    for ``steps`` tokens: (B, steps+1) on the host."""
    toks = first_tokens
    # lint: sync-ok(offline reference decode for agreement scoring)
    out = [toks[:, 0].cpu().numpy()]
    pos = torch.full((toks.shape[0],), start_pos, dtype=torch.int32,
                     device=toks.device)
    for t in range(steps):
        logits, caches = dec_fn(params, caches, toks, pos + t)
        toks = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(
            torch.int32)
        # lint: sync-ok(offline reference decode for agreement scoring)
        out.append(toks[:, 0].cpu().numpy())
    return np.stack(out, axis=1)  # (B, steps+1)


def _teacher_forced_agreement(dec_fn, params, caches, ref_tokens: np.ndarray,
                              start_pos: int) -> float:
    """Relative accuracy without divergence compounding: feed the reference
    continuation, compare each step's argmax against the reference's next
    token (the paper's relative-accuracy analogue)."""
    b, t1 = ref_tokens.shape
    dev = _device_of(caches)
    ref = torch.as_tensor(ref_tokens, dtype=torch.int32, device=dev)
    pos = torch.full((b,), start_pos, dtype=torch.int32, device=dev)
    hits, total = 0, 0
    for t in range(t1 - 1):
        logits, caches = dec_fn(params, caches, ref[:, t:t + 1], pos + t)
        pred = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
        hits += int((pred == ref_tokens[:, t + 1]).sum())
        total += b
    return hits / max(total, 1)


def evaluate_quality(
    strategy: StrategyConfig,
    workloads: Sequence[str] = tuple(WORKLOADS),
    n_prompts: int = 6,
    seq: int = 192,
    decode_tokens: int = 20,
    seed: int = 0,
    ref=None,
    head_scores: Optional[np.ndarray] = None,
    device="cuda",
) -> Dict[str, float]:
    """Per-workload relative accuracy of ``strategy`` on the reference
    model ``ref`` (the cached ``tiny-lm`` on ``device`` when None)."""
    if is_identity(strategy):
        return {w: 1.0 for w in workloads}
    cfg, params = ref if ref is not None else get_reference_model(
        device=device)
    dev = _param_device(params)
    gen_budget = decode_tokens + 2
    pre, dec, _ = _jitted_steps(cfg.name, seq, n_prompts, seq + gen_budget)
    pipe = CompressionPipeline(strategy, head_scores=head_scores, device=dev)

    out: Dict[str, float] = {}
    for wi, w in enumerate(workloads):
        tokens, _ = _prompts_for(w, n_prompts, seq, seed * 7919 + wi)
        logits, caches = pre(params, {"tokens": torch.as_tensor(
            tokens, dtype=torch.int32, device=dev)})
        first = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(
            torch.int32)

        # reference decode (uncompressed KV); it writes only positions
        # >= seq, which the teacher-forced decode rewrites before reading
        ref_toks = _greedy_decode(dec, params, caches, first, seq,
                                  decode_tokens)

        # compressed-KV decode, teacher-forced on the reference tokens
        for b in range(n_prompts):
            kv = extract_kv(cfg, caches, b, upto=seq)
            inject_kv(cfg, caches, b, pipe.decompress(pipe.compress(kv)))
        out[w] = _teacher_forced_agreement(dec, params, caches, ref_toks,
                                           seq)
    return out


def calibrate_head_scores(workload: str = "mixed", n_prompts: int = 4,
                          seq: int = 192, seed: int = 0, ref=None,
                          device="cuda") -> np.ndarray:
    """Data-driven retrieval-head scores (L, H) from real model KV, taken
    on the device of ``ref``'s parameters."""
    cfg, params = ref if ref is not None else get_reference_model(
        device=device)
    dev = _param_device(params)
    pre, _, _ = _jitted_steps(cfg.name, seq, n_prompts, seq + 4)
    ws = list(WORKLOADS) if workload == "mixed" else [workload]
    scores = []
    for wi, w in enumerate(ws):
        tokens, _ = _prompts_for(w, n_prompts, seq, seed + wi)
        _, caches = pre(params, {"tokens": torch.as_tensor(
            tokens, dtype=torch.int32, device=dev)})
        for b in range(min(n_prompts, 2)):
            k = extract_kv(cfg, caches, b, upto=seq).k.float()
            centered = k - k.mean(dim=2, keepdim=True)
            scores.append(torch.sqrt((centered ** 2).mean(dim=(2, 3))))
    return torch.stack(scores).mean(dim=0).cpu().numpy()
