#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Three phases, in order; any failure exits non-zero and no phase's error
is caught:

1. Build: compile every Hopper kernel of ``src/repro_torch/kernels/csrc``
   with nvcc (one process per source, in parallel) into ``build/kernels``.
2. Kernels: on the card, hold each kernel against its plain PyTorch
   version at the main path's shapes (plus int4, ragged-T and
   scratch-page cases), and time it, its plain version and, where one
   PyTorch call computes the same function, that call.
3. Runtime: serve the pinned 8-request pattern PD-separated on the paged
   arena of ``llama3.1-8b`` at full width with seeded random bf16
   weights, count each kernel's launches on that run, and check the
   paged kernel path against the plain path on one full-width decode.

Prints per-request TTFT/JCT/wire bytes/breakdowns, one JSON line of
kernel results, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  Exits with an error, printing no
result, when there is no CUDA device or the port's sources are missing.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3
PEAK_F32_FLOP_S = 67e12       # H100 SXM, f32 outside the tensor cores

# tests/_runtime_scenario.py::SCENARIO: (workload, slo_class, prompt_seed,
# out_tokens, steps before the next submission).  Cold requests plus three
# prefix-pool hits (rids 3, 5, 6).
SCENARIO = [
    ("qalike", "standard", 0, None, 1),
    ("codelike", "interactive", 1, 4, 0),
    ("mathlike", "batch", 2, None, 2),
    ("qalike", "standard", 0, None, 1),
    ("summlike", "standard", 3, 3, 0),
    ("codelike", "interactive", 1, None, 1),
    ("mathlike", "batch", 2, 5, 0),
    ("qalike", "batch", 4, None, 2),
]

ARCH, SEQ, DECODE_TOKENS, PAGE_SIZE, SLOTS = "llama3.1-8b", 1024, 30, 16, 6
GROUP = 64


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and f32
    operations over the f32 peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bf16_ulps(torch, a, b) -> int:
    def ordered(x):
        i = x.float().view(torch.int32) >> 16
        return torch.where(i < 0, -(i & 0x7FFF), i).long()
    return int((ordered(a) - ordered(b)).abs().max())


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def kernel_phase(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref

    cfg = get_config(ARCH)
    hkv, d = cfg.kv_heads, cfg.resolved_head_dim
    gq = cfg.num_heads // cfg.kv_heads
    gen = torch.Generator(device=dev).manual_seed(1)
    results = {}

    # ---- quant_pack: the prefill KV of one request, (L*H*S, D) bf16 ----
    t_main = cfg.num_layers * hkv * SEQ
    worst = 0.0
    cases = [(t_main, 8, torch.bfloat16), (t_main, 4, torch.bfloat16),
             (77, 8, torch.float32), (4097, 4, torch.float32)]
    for t, bits, dt in cases:
        x = (torch.randn(t, d, generator=gen, device=dev) * 3).to(dt)
        codes, scales = ops.quant_pack_op(x, bits=bits, group=GROUP)
        c_ref, s_ref = ref.quant_pack_ref(x, bits, GROUP)
        err = max(float((codes.int() - c_ref.int()).abs().max()),
                  float((scales - s_ref).abs().max()))
        print(f"quant_pack T={t} bits={bits} {str(dt)[6:]}: max|err| {err} "
              f"(tolerance 0: bit for bit)")
        check(err == 0.0, f"quant_pack T={t} bits={bits}")
        worst = max(worst, err)
    x = torch.randn(t_main, d, generator=gen, device=dev).to(torch.bfloat16)
    n = x.numel()
    results["quant_pack"] = dict(
        max_abs_err=worst,
        ms=time_ms(torch, lambda: ops.quant_pack_op(x, bits=8, group=GROUP)),
        plain_ms=time_ms(torch, lambda: ref.quant_pack_ref(x, 8, GROUP)),
        library_ms=None)
    results["quant_pack"]["bound_ms"], results["quant_pack"]["bound_by"] = \
        bound(n * 2 + n + (n // GROUP) * 4, 5 * n)

    # ---- dequant_unpack: the decode-side restore, f32 out ----
    worst = 0.0
    for t, bits, od in [(t_main, 8, torch.float32), (t_main, 4, torch.float32),
                        (77, 8, torch.bfloat16), (4097, 4, torch.bfloat16)]:
        xx = torch.randn(t, d, generator=gen, device=dev) * 3
        codes, scales = ref.quant_pack_ref(xx, bits, GROUP)
        out = ops.dequant_unpack_op(codes, scales, bits=bits, group=GROUP,
                                    out_dtype=od)
        want = ref.dequant_unpack_ref(codes, scales, bits, GROUP, dtype=od)
        err = float((out.float() - want.float()).abs().max())
        print(f"dequant_unpack T={t} bits={bits} -> {str(od)[6:]}: "
              f"max|err| {err} (tolerance 0: bit for bit)")
        check(err == 0.0, f"dequant_unpack T={t} bits={bits}")
        worst = max(worst, err)
    codes, scales = ref.quant_pack_ref(x, 8, GROUP)
    results["dequant_unpack"] = dict(
        max_abs_err=worst,
        ms=time_ms(torch, lambda: ops.dequant_unpack_op(
            codes, scales, bits=8, group=GROUP, out_dtype=torch.float32)),
        plain_ms=time_ms(torch, lambda: ref.dequant_unpack_ref(
            codes, scales, 8, GROUP, torch.float32)),
        library_ms=None)
    results["dequant_unpack"]["bound_ms"], \
        results["dequant_unpack"]["bound_by"] = bound(
            n + (n // GROUP) * 4 + n * 4, n)

    # ---- paged_attention, arena entry: one decode step's layer read ----
    pps = -(-(SEQ + DECODE_TOKENS + 2) // PAGE_SIZE)
    n_pages = SLOTS * pps + 1
    shape = (n_pages, PAGE_SIZE, hkv, d)

    def rnd(scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    kp, vp = rnd(), rnd()
    kc = torch.randint(-128, 128, shape, generator=gen, device=dev,
                       dtype=torch.int8)
    vc = torch.randint(-128, 128, shape, generator=gen, device=dev,
                       dtype=torch.int8)
    grp = torch.rand(shape[:-1] + (d // GROUP,), generator=gen, device=dev)
    ks = (grp * 0.02 + 1e-3).half().float().repeat_interleave(GROUP, -1)
    vs = (grp.flip(0) * 0.02 + 1e-3).half().float().repeat_interleave(
        GROUP, -1)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    bt = perm.reshape(SLOTS, pps).to(torch.int32)
    view = pps * PAGE_SIZE
    # live slots 6..26 tokens into decode, a fresh prefill, a parked row
    lens = torch.tensor([SEQ + 16, SEQ + 6, SEQ, view - 1, SEQ + 26, SEQ],
                        dtype=torch.int32, device=dev)
    qlens = torch.tensor([SEQ, 0, SEQ, 0, 0, SEQ], dtype=torch.int32,
                         device=dev)
    q = torch.randn(SLOTS, hkv, gq, d, generator=gen, device=dev).to(
        torch.bfloat16)
    args = (q, kp, vp, kc, ks, vc, vs, bt, lens, qlens)
    out, m, l = ops.paged_attention_arena_op(*args)
    r_out, r_m, r_l = ref.paged_attention_arena_ref(*args)
    ulps = bf16_ulps(torch, out, r_out)
    m_rel = float(((m - r_m).abs() / r_m.abs().clamp_min(1e-30)).max())
    l_rel = float(((l - r_l).abs() / r_l.abs().clamp_min(1e-30)).max())
    err = float((out.float() - r_out.float()).abs().max())
    print(f"paged_attention_arena B={SLOTS} Hkv={hkv} Gq={gq} D={d} "
          f"pages={n_pages}x{PAGE_SIZE}: out {ulps} bf16 ulps (max|err| "
          f"{err:.3g}; tolerance 2 ulps), m rel {m_rel:.3g}, l rel "
          f"{l_rel:.3g} (tolerance 1e-5)")
    check(ulps <= 2 and m_rel <= 1e-5 and l_rel <= 1e-5,
          "paged_attention_arena vs plain")
    # bytes this data needs: every visible K and V row once, as stored
    seen = lens.long().sum().item()
    quant = torch.minimum(qlens, lens).long().sum().item()
    row = hkv * d
    kv_bytes = 2 * row * ((seen - quant) * 2 + quant * (1 + 4))
    io_bytes = q.numel() * 2 * 2 + m.numel() * 8 + bt.numel() * 4
    flops = 4 * gq * row * seen
    # library yardstick: SDPA over the gathered, dequantized bf16 view
    g = bt.long()
    use_q = (torch.arange(view, device=dev)[None, :]
             < qlens[:, None])[..., None, None]

    def dense_view(pool, codes, scales):
        deq = (codes.float() * scales).to(torch.bfloat16)[g]
        return torch.where(use_q, deq.reshape(SLOTS, view, hkv, d),
                           pool[g].reshape(SLOTS, view, hkv, d)
                           ).transpose(1, 2)

    kview, vview = dense_view(kp, kc, ks), dense_view(vp, vc, vs)
    qs = q.reshape(SLOTS, hkv * gq, 1, d)
    mask = (torch.arange(view, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results["paged_attention"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: ops.paged_attention_arena_op(*args)),
        plain_ms=time_ms(torch, lambda: ref.paged_attention_arena_ref(*args)),
        library_ms=time_ms(torch, lambda: sdpa(qs, kview, vview,
                                               attn_mask=mask,
                                               enable_gqa=True)))
    results["paged_attention"]["bound_ms"], \
        results["paged_attention"]["bound_by"] = bound(kv_bytes + io_bytes,
                                                       flops)

    # ---- paged_attention, Pallas interface: int8 / int4, scratch page ----
    pallas = {}
    pshape = (n_pages, hkv, PAGE_SIZE, d)
    p_lens = torch.tensor([SEQ + 16, 1, SEQ, 17, SEQ + 26, SEQ // 2],
                          dtype=torch.int32,
                          device=dev)
    qf = torch.randn(SLOTS, hkv, gq, d, generator=gen, device=dev)
    for bits in (8, 4):
        kx = torch.randn(pshape, generator=gen, device=dev)
        vx = torch.randn(pshape, generator=gen, device=dev)
        kcq, ksq = ref.quant_pack_ref(kx, bits, GROUP)
        vcq, vsq = ref.quant_pack_ref(vx, bits, GROUP)
        pargs = (qf, kcq, ksq, vcq, vsq, bt, p_lens)
        got = ops.paged_attention_op(*pargs, bits=bits, group=GROUP)
        want = ref.paged_attention_ref(*pargs, bits=bits, group=GROUP)
        perr = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, atol=2e-5, rtol=1e-4))
        # poison the scratch page: unmapped entries and masked tails
        # must stay inert
        kpz, vpz = kcq.clone(), vcq.clone()
        kpz[0] = 0x77 if bits == 4 else 127
        vpz[0] = 0x88 if bits == 4 else -128
        bt0 = bt.clone()
        bt0[1, 1:] = 0
        a = ops.paged_attention_op(qf, kcq, ksq, vcq, vsq, bt0, p_lens,
                                   bits=bits, group=GROUP)
        b = ops.paged_attention_op(qf, kpz, ksq, vpz, vsq, bt0, p_lens,
                                   bits=bits, group=GROUP)
        inert = bool(torch.equal(a, b))
        print(f"paged_attention (Pallas interface) int{bits}: max|err| "
              f"{perr:.3g} (tolerance atol 2e-5 + rtol 1e-4), scratch page "
              f"inert: {inert}")
        check(ok and inert, f"paged_attention int{bits}")
        pallas[f"int{bits}"] = dict(
            max_abs_err=perr,
            ms=time_ms(torch, lambda: ops.paged_attention_op(
                *pargs, bits=bits, group=GROUP)),
            plain_ms=time_ms(torch, lambda: ref.paged_attention_ref(
                *pargs, bits=bits, group=GROUP), iters=5))
    results["paged_attention"]["pallas_interface"] = pallas
    return results


# ---------------------------------------------------------------------------
# Phase 3: the serving runtime at full width
# ---------------------------------------------------------------------------
def runtime_phase(torch, dev):
    """Serve SCENARIO PD-separated on the paged arena; returns
    (runtime, served requests, wall seconds, launch counts)."""
    from repro_torch.configs import get_config
    from repro_torch.core.profiles import Profile
    from repro_torch.core.strategy import StrategyConfig
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models.transformer import (
        decode_step, init_cache, init_params, prefill)
    from repro_torch.serving import GBPS, BandwidthTrace, SchedulerConfig
    from repro_torch.serving.engine import RuntimeConfig, ServingRuntime

    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"{ARCH}: {n_params / 1e9:.3f}B seeded bf16 parameters on {dev} "
          f"in {time.perf_counter() - t0:.1f} s")
    profile = Profile(
        StrategyConfig(quantizer="uniform", key_bits=8, value_bits=8,
                       granularity="per_token", symmetric=True,
                       group_size=GROUP),
        cr=2.0, s_enc=5e8, s_dec=5e8)
    rt = ServingRuntime(
        static_profile=profile,
        # the pool tier holds every prompt's compressed prefix (~67 MB
        # each at full width), so the three repeated prompts hit it
        config=RuntimeConfig(seq=SEQ, decode_tokens=DECODE_TOKENS,
                             mode="pd", paged=True, page_size=PAGE_SIZE,
                             pd_inject_restored=True,
                             store_capacity=1 << 30),
        trace=BandwidthTrace.constant(100 * GBPS),
        scheduler=SchedulerConfig(max_slots=SLOTS, max_prefills_per_step=2,
                                  max_queue=32),
        device=dev)
    rt.model_cfg, rt.params = cfg, params
    # set-up, timed apart: the first prefill and decode step pay cuBLAS's
    # lazy initialisation, which a long-running server pays once
    t0 = time.perf_counter()
    warm_cache = init_cache(cfg, SLOTS, rt.cfg.arena_max_len, device=dev)
    prefill(cfg, params, {"tokens": torch.zeros((1, SEQ), dtype=torch.int32,
                                                device=dev)},
            rt.cfg.arena_max_len)
    decode_step(cfg, params, warm_cache,
                torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev),
                torch.full((SLOTS,), SEQ, dtype=torch.int32, device=dev))
    del warm_cache
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"warm-up (one prefill, one dense decode step): "
          f"{time.perf_counter() - t0:.2f} s")
    reset_launches()
    t0 = time.perf_counter()
    for w, slo_class, seed, out_tokens, steps_after in list(SCENARIO):
        check(rt.submit(w, slo_class=slo_class, prompt_seed=seed,
                        out_tokens=out_tokens) is not None, "admission")
        for _ in range(steps_after):
            rt.step()
    rt.run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return rt, cfg, params, wall, launches()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def check_runtime(rt, cfg) -> None:
    done = sorted(rt.completed, key=lambda r: r.rid)
    check(len(done) == len(SCENARIO), "every request served")
    hits = [r.rid for r in done if r.pool_hit]
    check(hits == [3, 5, 6], f"pool hits {hits}")
    for r, (_, _, _, out_tokens, _) in zip(done, SCENARIO):
        want = (out_tokens or rt.cfg.decode_tokens) + 1
        check(len(r.tokens) == want, f"rid {r.rid}: {len(r.tokens)} tokens")
        check(all(0 <= int(t) < cfg.vocab_size for t in r.tokens),
              f"rid {r.rid}: tokens in vocabulary")
        check(abs(sum(r.breakdown.values()) - r.jct) < 1e-6,
              f"rid {r.rid}: breakdown sums to JCT")
        check(r.wire_bytes > 0, f"rid {r.rid}: wire bytes")
    for dw in rt.decode_workers:
        dw.page_table.check()
        check(dw.page_table.free_pages == dw.page_table.num_pages - 1,
              "every page returned")


def reference_check(torch, rt, cfg, params, dev):
    """One full-width decode step of a served prompt on the card, from the
    wire-restored KV resident in the paged arena as bf16 pages and as
    int8 quant pages: through the Hopper kernel, and through its plain
    version (same arithmetic order, so the logits should agree to the
    last bits).  Also prints the dense-cache path (cuBLAS attention,
    another summation order) for information.  Returns (max |logit
    difference| kernel vs plain, logit scale, plain top-2 gap, argmaxes
    agree)."""
    import repro_torch.models.layers as layers
    from repro_torch.core.kvcache import PageTable
    from repro_torch.core.pipeline import CompressionPipeline
    from repro_torch.core.quality import (
        _prompts_for, extract_kv, init_paged_pools, inject_kv,
        inject_kv_paged, inject_quant_pages)
    from repro_torch.kernels import ref
    from repro_torch.models.transformer import decode_step, init_cache, prefill
    from repro_torch.serving.workers import quant_entry_arrays

    seq, max_len = rt.cfg.seq, rt.cfg.arena_max_len
    strategy = rt.static_profile.strategy
    tokens, _ = _prompts_for(SCENARIO[0][0], 1, seq, SCENARIO[0][2])
    logits, caches = prefill(cfg, params, {"tokens": torch.as_tensor(
        tokens, dtype=torch.int32, device=dev)}, max_len)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    pos = torch.tensor([seq], dtype=torch.int32, device=dev)
    comp = CompressionPipeline(strategy).compress(
        extract_kv(cfg, caches, 0, seq))
    restored = CompressionPipeline(strategy, device=dev).decompress(comp)
    dense = inject_kv(cfg, init_cache(cfg, 1, max_len, device=dev), 0,
                      restored)
    dense_logits = decode_step(cfg, params, dense, tok, pos)[0][0, -1].float()

    page_size = PAGE_SIZE
    pps = -(-max_len // page_size)
    table = PageTable(pps + 1, page_size)
    table.ensure(0, seq + 1)
    row = table.block_row(0, pps)
    bt = torch.as_tensor(row[None], device=dev)
    (kc, ks), (vc, vs) = quant_entry_arrays(comp)

    def paged_logits(quant_len):
        pool, qc, qs = init_paged_pools(cfg, pps + 1, page_size, 1,
                                        device=dev)
        if quant_len:
            qc, qs = inject_quant_pages(cfg, qc, qs, row, kc, ks, vc, vs,
                                        seq, page_size)
        else:
            pool = inject_kv_paged(cfg, pool, row, restored, page_size)
        ql = torch.tensor([quant_len], dtype=torch.int32, device=dev)
        paged = {part: {name: layers.PagedKV(
            c["k"], c["v"], qc[part][name]["k"], qs[part][name]["k"],
            qc[part][name]["v"], qs[part][name]["v"], bt, ql)
            for name, c in pool[part].items()}
            for part in ("prefix", "blocks")}
        return decode_step(cfg, params, paged, tok, pos)[0][0, -1].float()

    err, scale, gap, same = 0.0, 0.0, float("inf"), True
    for quant_len, where in ((0, "bf16 pages"), (seq, "int8 pages")):
        kernel = paged_logits(quant_len)
        kernel_op = layers.paged_attention_arena_op
        layers.paged_attention_arena_op = ref.paged_attention_arena_ref
        try:
            plain = paged_logits(quant_len)
        finally:
            layers.paged_attention_arena_op = kernel_op
        top = torch.topk(plain, 2).values
        e = float((kernel - plain).abs().max())
        err, scale = max(err, e), max(scale, float(plain.abs().max()))
        gap = min(gap, float(top[0] - top[1]))
        same = same and int(kernel.argmax()) == int(plain.argmax())
        d = float((kernel - dense_logits).abs().max())
        print(f"reference check, one full-width decode step from {where}: "
              f"kernel vs plain max|logit diff| {e:.4g} (logit scale "
              f"{float(plain.abs().max()):.4g}, argmax "
              f"{int(kernel.argmax())} vs {int(plain.argmax())}); dense-cache "
              f"path {d:.4g} away, argmax {int(dense_logits.argmax())}")
    return err, scale, gap, same


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} on {name}")

    # ---- 1. build ----
    built = build.timed_build()
    print(f"build: {built['seconds']:.1f} s for {len(build.SIGNATURES)} "
          f"kernel libraries")
    for lib, report in built["reports"].items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {lib}: {line.strip()}")

    # ---- 2. kernels ----
    results = kernel_phase(torch, dev)
    torch.cuda.synchronize()
    for k, r in results.items():
        print(f"{k}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}, library "
              f"{r['library_ms']})")

    # ---- 3. runtime ----
    rt, cfg, params, wall, counts = runtime_phase(torch, dev)
    print(f"runtime: {len(rt.completed)} requests in {wall:.2f} s wall, "
          f"{rt.steps} iterations")
    for r in sorted(rt.completed, key=lambda r: r.rid):
        bd = ", ".join(f"{k}={v * 1e3:.2f}ms" for k, v in r.breakdown.items())
        print(f"  rid {r.rid} {r.workload:9s} hit={int(r.pool_hit)} "
              f"ttft={r.ttft * 1e3:.2f}ms jct={r.jct * 1e3:.2f}ms "
              f"wire_bytes={r.wire_bytes} [{bd}]")
    check_runtime(rt, cfg)
    launches = {"quant_pack": counts["quant_pack_op"],
                "dequant_unpack": counts["dequant_unpack_op"],
                "paged_attention": counts["paged_attention_arena_op"]}
    print(f"launches on the main path: {launches} "
          f"(Pallas-interface entry: {counts['paged_attention_op']})")
    for k, n in launches.items():
        check(n > 0, f"{k} launched on the main path")
    err, scale, gap, same = reference_check(torch, rt, cfg, params, dev)
    tol = 2e-2 + 1.6e-2 * scale
    check(err <= tol and (same or gap <= tol),
          "full-width decode through the kernel agrees with the plain path")

    meta = {
        "quant_pack": ("src/repro_torch/kernels/csrc/quant_pack.cu",
                       "src/repro/kernels/quant_pack.py:76"),
        "dequant_unpack": ("src/repro_torch/kernels/csrc/dequant_unpack.cu",
                           "src/repro/kernels/quant_pack.py:112"),
        "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:150"),
    }
    kernels = []
    for k, (src, replaces) in meta.items():
        entry = {"name": k, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches[k]}
        entry.update(results[k])
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, "nvidia-smi")
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
