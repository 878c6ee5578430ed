#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline DIR]

Five phases, in order; any failure exits non-zero and no phase's error
is caught:

1. Build: compile every Hopper kernel of ``src/repro_torch/kernels/csrc``
   with nvcc (one process per source, in parallel) into ``build/kernels``.
2. Kernels: on the card, hold each kernel against its plain PyTorch
   version at the main path's shapes (plus int4, ragged-T, staircase and
   scratch-page cases; quant_pack and dequant_unpack bit for bit, also
   on ``quant_boundary``'s rows and the scalar path's shapes, quant_pack
   also against the host quantizer; the Hadamard kernel also bit for bit
   against numpy's ``x @ h`` on the host at D 64, 128 and 256), and time
   it, its plain version and, where one PyTorch call computes the same
   function, that call; decode_attention, hadamard, quant_pack and
   dequant_unpack also by their device time per call from torch.profiler
   and the host's enqueue time per call (the last two in six variants,
   each beside its byte bound).
   ``decode_attention``, which no serving path calls, is driven here
   through its public entry: llama3.1-8b's slot-arena decode at full
   width, the harness and test shapes, 32,768 positions, Gq 48, and the
   identity with paged attention over a block table, and at the edges of
   its split of the positions into blocks of 64.  The attention
   kernels are also held at shapes they refused before their caps were
   lifted (16,400 positions, W = 5 over 4,096, Gq 48, 35 verify rows) and
   at the edges of their split across blocks (chunk and stage
   boundaries, short slots, quant_lens mid-chunk, the staircase across a
   chunk), each case launched twice and bit-equal, and each arena entry's
   two CUDA kernels (phase A, phase B) are timed by torch.profiler.  With
   ``--baseline DIR`` (a checkout of another commit, e.g. the parent's
   ``git archive``), the arena attention entries, decode_attention,
   hadamard, quant_pack and dequant_unpack of DIR and of this tree are
   timed at the main shapes in turns.
3. Runtime: serve the pinned 8-request pattern PD-separated on the paged
   arena of ``llama3.1-8b`` at full width with seeded random bf16
   weights, count each kernel's launches on that run, check the paged
   kernel path against the plain path on one full-width decode, time
   one full-width decode step (host enqueue, wall, device busy; with
   ``--baseline``, also with DIR's paged_attention library in turns),
   and split one cold request's compress and decompress stages into the
   kernel, the torch ops around it, the copies and the host codec.
4. Speculative runtime: serve the same pattern the same way with
   speculation, ``spec_k=4``: first with n-gram lookahead (random weights
   repeat no n-gram of their output, so it offers no drafts: recorded,
   not required), then with the two-model draft (the target as its own
   draft), which drafts every step; count the verify kernel's launches on
   that run, check the page tables, and hold one full-width W = 5 verify
   step through the kernel against the plain path.
5. Offline profiling, the controller and one-shot PD serving: one
   full-width prefill's KV through the pipeline's device stages (the
   Hadamard kernel, quant_pack, dequant_unpack) against its host stages
   (equal wire bytes, restored KV within 1e-5 of row scale) for a
   Hadamard + int8 per-token profile and mixhq; then calibrated head
   scores, the baselines and that profile measured on the model's own
   device KV, a short Bayesian search, and ``DisaggregatedEngine``
   batches through the ``ServiceAwareController`` over those profiles at
   1 and 100 Gb/s and with the static mixhq profile; the Hadamard kernel
   must launch on that path.

Prints per-request TTFT/JCT/wire bytes/breakdowns, the speculative run's
verify steps, committed tokens and accept rates beside the plain run's
TTFT and JCT, phase 5's profiles and per-batch breakdowns, one JSON line
of kernel results, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Exits
with an error, printing no result, when there is no CUDA device or the
port's sources are missing.
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
SPEC_K = 4                    # phase 4: verify steps of up to W = 5 tokens


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call: CUDA events around ``iters`` back-to-back
    calls, over the count, the median of three such runs.  Back to back,
    the card does not wait on the host between launches unless the host
    is the slower of the two."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return statistics.median(runs)


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


def device_times(torch, fn, iters: int = 20) -> dict:
    """What one call of ``fn`` costs the card and the host:
    ``device_ms``, the device time per call: each CUDA kernel's mean time
    a launch times its launches a call, summed (torch.profiler over
    ``iters`` back-to-back calls; the profiler on the H100 machine has
    dropped a launch from a window, 19 of 20 seen, which a window's total
    over the calls would count as a faster call); ``kernels_per_call``;
    and ``host_ms``, the host's time to enqueue one call (100 calls
    without a synchronize).  A kernel of ~0.01-0.02 ms behind a ~0.03 ms
    Python wrapper is host-bound under ``time_ms``, so ``device_ms`` is
    the number that judges the kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        fn()
    host_ms = (time.perf_counter() - t0) / 100 * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_kernel, count = {}, 0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA or not e.count:
            continue
        dt = getattr(e, "device_time_total", None)
        name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
        name = name.split("<")[0].split("::")[-1].split()[-1]
        launches = round(e.count / iters)
        by_kernel[name] = by_kernel.get(name, 0.0) + (
            e.cuda_time_total if dt is None else dt) / e.count \
            * launches / 1e3
        count += launches
    check(count > 0, "torch.profiler saw the call's CUDA kernels")
    return dict(device_ms=sum(by_kernel.values()), by_kernel=by_kernel,
                kernels_per_call=count, host_ms=host_ms)


# ---------------------------------------------------------------------------
# Phase 2: quant_pack and dequant_unpack
# ---------------------------------------------------------------------------
QUANT_T = 32 * 8 * SEQ       # one request's K or V of llama3.1-8b, (L·Hkv·S)
QUANT_MAIN = ("quant_pack bf16 int8", "dequant_unpack int8 f32")
_SHORT = {"torch.float32": "f32", "torch.bfloat16": "bf16"}


def quant_pack_sass() -> None:
    """The machine code of quant_pack's main variant (bf16 in, int8 out,
    group 64: segments of 8 lanes, 2 groups a thread, 16 elements), from
    ``cuobjdump -sass`` of the built library: its instruction count and
    the instructions of the IEEE divide, one per element (MUFU.RCP, FFMA,
    FCHK and the call of the slow path).  Static counts: the slow path is
    in them but runs only where FCHK flags an operand."""
    import collections
    import re

    from repro_torch.kernels import build

    tool = Path(build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        print("quant_pack SASS: no cuobjdump beside nvcc")
        return
    out = subprocess.run([str(tool), "-sass",
                          str(build.library_path("quant_pack"))],
                         capture_output=True, text=True, timeout=120).stdout
    for body in re.split(r"\n\s+Function : ", out)[1:]:
        if "quant_pack_vecI13__nv_bfloat16Li8ELi8ELi1ELi2E" not in body:
            continue
        ops = [op.split(".")[0] for op in re.findall(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)",
            body)]
        n = collections.Counter(ops)
        print(f"quant_pack SASS, bf16 in, int8, group 64 (16 elements a "
              f"thread): {len(ops)} instructions; MUFU {n['MUFU']}, FFMA "
              f"{n['FFMA']}, FCHK {n['FCHK']}, CALL {n['CALL']}, F2I "
              f"{n['F2I']}, LDG {n['LDG']}, STG {n['STG']}, SHFL "
              f"{n['SHFL']}")
        return
    check(False, "quant_pack's main variant in its library")


def quant_main_calls(torch, dev, ops):
    """The streaming kernels at the main shape (QUANT_T, 128), group 64,
    through ``ops`` (the module of this tree or of another checkout):
    quant_pack from bf16 (phase 3's input) and f32 (phase 5's, after the
    Hadamard stage) to int8 and from bf16 to int4; dequant_unpack from
    int8 to f32 (phases 3 and 5), int4 to f32 and int8 to bf16.  Each call
    takes the next of three input sets, so its inputs were last touched
    two calls (> 170 MB of traffic) before and are not warm in the 50 MB
    L2.  Returns ({name: call}, {name: bytes the call must move})."""
    import itertools

    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(4)
    n = QUANT_T * 128
    calls, nbytes = {}, {}

    def rotate(fn, sets):
        it = itertools.cycle(sets)
        return lambda: fn(*next(it))

    for dt, bits in ((torch.bfloat16, 8), (torch.float32, 8),
                     (torch.bfloat16, 4)):
        name = f"quant_pack {_SHORT[str(dt)]} int{bits}"
        sets = [((torch.randn(QUANT_T, 128, generator=gen, device=dev)
                  * 3).to(dt),) for _ in range(3)]
        calls[name] = rotate(lambda x, bits=bits: ops.quant_pack_op(
            x, bits=bits, group=GROUP), sets)
        nbytes[name] = n * dt.itemsize + n * bits // 8 + n // GROUP * 4
    for bits, od in ((8, torch.float32), (4, torch.float32),
                     (8, torch.bfloat16)):
        name = f"dequant_unpack int{bits} {_SHORT[str(od)]}"
        sets = [ref.quant_pack_ref(torch.randn(
            QUANT_T, 128, generator=gen, device=dev) * 3, bits, GROUP)
            for _ in range(3)]
        calls[name] = rotate(lambda c, s, bits=bits, od=od:
                             ops.dequant_unpack_op(c, s, bits=bits,
                                                   group=GROUP, out_dtype=od),
                             sets)
        nbytes[name] = n * bits // 8 + n // GROUP * 4 + n * od.itemsize
    return calls, nbytes


def quant_kernel_phase(torch, dev):
    """quant_pack and dequant_unpack against their plain versions and
    quant_pack also against the host quantizer
    (``core/quantizers.py::group_quantize``, the wire contract), all bit
    for bit: ``quant_boundary``'s rows (quotients on and one grid step off
    a .5, where the reciprocal shortcut differs, at +-qmax, all zero,
    below the scale floor) at bits 4 and 8, f32 and bf16 in, groups 32, 64
    and 128, T 1, 77 and 4097, and tiled to the main shape; random rows at
    the main shape; the scalar path's shapes (groups 2, 6 and 10, bf16
    group 4, x or codes at an odd element offset, T 1); every code of
    each quant_pack case restored by dequant_unpack to f32 and bf16; int4
    nibble order.  Then each variant at the main shape
    (``quant_main_calls``): ``time_ms``, device time per call, host
    enqueue per call and share of its byte bound.  Returns the two
    results entries."""
    import numpy as np
    from repro_torch.core.quantizers import group_quantize
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.quant_boundary import (boundary_rows,
                                                    reciprocal_differs)

    f32, bf16 = torch.float32, torch.bfloat16
    worst = {"quant_pack": 0.0, "dequant_unpack": 0.0}

    def hold(x_np, xd, bits, group, label, host=True):
        codes, scales = ops.quant_pack_op(xd, bits=bits, group=group)
        c_ref, s_ref = ref.quant_pack_ref(xd, bits, group)
        err = max(float((codes.int() - c_ref.int()).abs().max()),
                  float((scales - s_ref).abs().max()))
        worst["quant_pack"] = max(worst["quant_pack"], err)
        check(err == 0.0, f"quant_pack {label} = plain")
        if host:
            t, d = x_np.shape
            hc, hs, _ = group_quantize(x_np.reshape(1, t, d), bits,
                                       "per_token", group, True)
            c = ref.unpack_int4_ref(codes) if bits == 4 else codes
            wire = (c.to(torch.int16) + (1 << (bits - 1))).to(torch.uint8)
            check(np.array_equal(wire.cpu().numpy().reshape(hc.shape), hc)
                  and np.array_equal(scales.to(torch.float16).cpu().numpy()
                                     .reshape(hs.shape), hs),
                  f"quant_pack {label} = host quantizer")
        for od in (f32, bf16):
            out = ops.dequant_unpack_op(codes, scales, bits=bits, group=group,
                                        out_dtype=od)
            want = ref.dequant_unpack_ref(codes, scales, bits, group, od)
            e = float((out.float() - want.float()).abs().max())
            worst["dequant_unpack"] = max(worst["dequant_unpack"], e)
            check(torch.equal(out, want),
                  f"dequant_unpack {label} -> {_SHORT[str(od)]}")
        return codes, scales

    # ---- boundary rows: bits x input type x group x T ----
    for bits in (8, 4):
        for dt in (f32, bf16):
            traps = 0
            for group in (32, 64, 128):
                for t in (1, 77, 4097):
                    x = boundary_rows(t, 128, group, bits, dt == bf16,
                                      seed=t + group + bits)
                    xg = x.reshape(-1, group)
                    scale = np.maximum(np.abs(xg).max(1, keepdims=True)
                                       / np.float32((1 << (bits - 1)) - 1),
                                       np.float32(1e-8))
                    traps += int(reciprocal_differs(xg, scale).sum())
                    hold(x, torch.from_numpy(x).to(dev, dt), bits, group,
                         f"boundary int{bits} {_SHORT[str(dt)]} group "
                         f"{group} T={t}")
            print(f"quant_pack boundary rows, int{bits}, {_SHORT[str(dt)]} "
                  f"in, groups 32/64/128 x T 1/77/4097: bit-equal to the "
                  f"plain version and the host quantizer ({traps} codes "
                  f"where x * (1/scale) would differ); dequant_unpack of "
                  f"their codes to f32 and bf16 bit-equal")
    # ---- the main shape: boundary rows tiled, then random rows ----
    for bits, dt in ((8, bf16), (8, f32), (4, bf16), (4, f32)):
        x = np.tile(boundary_rows(4096, 128, GROUP, bits, dt == bf16,
                                  seed=bits), (QUANT_T // 4096, 1))
        hold(x, torch.from_numpy(x).to(dev, dt), bits, GROUP,
             f"main shape boundary int{bits} {_SHORT[str(dt)]}")
    gen = torch.Generator(device=dev).manual_seed(1)
    for bits, dt in ((8, bf16), (4, bf16), (8, f32), (4, f32)):
        xd = (torch.randn(QUANT_T, 128, generator=gen, device=dev)
              * 3).to(dt)
        hold(None, xd, bits, GROUP,
             f"main shape random int{bits} {_SHORT[str(dt)]}", host=False)
    print(f"quant_pack at the main shape ({QUANT_T} x 128, group {GROUP}): "
          f"boundary rows (tiled) and random rows, int8 and int4, f32 and "
          f"bf16 in, bit-equal to the plain version (boundary rows also to "
          f"the host quantizer); dequant_unpack to f32 and bf16 bit-equal")
    # ---- the scalar path: shapes the vector path cannot take ----
    for label, (group, d, t) in {"group 2": (2, 64, 33),
                                 "group 6": (6, 96, 77),
                                 "group 10": (10, 160, 5),
                                 "odd offset": (GROUP, 128, 77),
                                 "T=1": (GROUP, 128, 1),
                                 "group 4": (4, 64, 9)}.items():
        for bits in (8, 4):
            for dt in (f32, bf16):
                x = boundary_rows(t, d, group, bits, dt == bf16, seed=t)
                xd = torch.from_numpy(x).to(dev, dt)
                if label == "odd offset":
                    flat = torch.zeros(t * d + 1, dtype=dt, device=dev)
                    flat[1:] = xd.ravel()
                    xd = flat[1:].view(t, d)
                    check(xd.data_ptr() % 16 != 0, "x at an odd offset")
                codes, scales = hold(x, xd, bits, group,
                                     f"{label} int{bits} {_SHORT[str(dt)]}")
                if label == "odd offset":   # codes at an odd offset
                    flat = torch.zeros(codes.numel() + 1, dtype=codes.dtype,
                                       device=dev)
                    flat[1:] = codes.ravel()
                    shifted = flat[1:].view(codes.shape)
                    for od in (f32, bf16):
                        check(torch.equal(
                            ops.dequant_unpack_op(shifted, scales, bits=bits,
                                                  group=group, out_dtype=od),
                            ref.dequant_unpack_ref(codes, scales, bits,
                                                   group, od)),
                            f"dequant_unpack codes at an odd offset int{bits}")
    print("scalar path (groups 2, 6, 10, bf16 group 4, x and codes at an "
          "odd element offset) and T=1: quant_pack bit-equal to the plain "
          "version and the host quantizer, dequant_unpack to its plain "
          "version")
    # ---- int4 nibble order: byte j = output 2j (low), 2j + 1 (high) ----
    lo = torch.arange(64, device=dev) % 16
    hi = (torch.arange(64, device=dev) * 7 + 3) % 16
    packed = (lo | (hi << 4)).to(torch.uint8).repeat(3, 1)
    sc = torch.tensor([[0.5, 2.0]] * 3, device=dev)
    want = (torch.stack([lo - 8, hi - 8], -1).reshape(128).float()
            * sc[0].repeat_interleave(64))
    for od in (f32, bf16):
        got = ops.dequant_unpack_op(packed, sc, bits=4, group=64,
                                    out_dtype=od)
        check(torch.equal(got.float(), want.expand(3, 128)),
              f"dequant_unpack int4 nibble order -> {_SHORT[str(od)]}")
    print("dequant_unpack int4 nibble order (low nibble first, minus 8): "
          "as stated")

    # ---- time at the main shape ----
    calls, nbytes = quant_main_calls(torch, dev, ops)
    variants = {}
    for name, fn in calls.items():
        dtimes = device_times(torch, fn)
        b = nbytes[name] / PEAK_BYTES_S * 1e3
        variants[name] = dict(
            ms=time_ms(torch, fn), device_ms=dtimes["device_ms"],
            kernels_per_call=dtimes["kernels_per_call"],
            host_ms=dtimes["host_ms"], bound_ms=b,
            share=b / dtimes["device_ms"])
        v = variants[name]
        print(f"{name} at the main shape: {v['device_ms']:.4f} ms of device "
              f"time per call ({v['kernels_per_call']:g} CUDA kernels), "
              f"time_ms {v['ms']:.4f}, host enqueue {v['host_ms']:.4f} ms; "
              f"byte bound {b:.4f} ms ({nbytes[name] / 1e6:.1f} MB), share "
              f"{v['share']:.3f}")
    # the card's practical HBM rate: PyTorch's own copy and fill of the
    # f32 output's size, three buffers in turn
    bufs = [torch.empty(QUANT_T, 128, device=dev) for _ in range(4)]
    turn = iter(range(1 << 30))
    rates = {}
    for name, fn, moved in (
            ("copy_", lambda: bufs[next(turn) % 3].copy_(bufs[3]),
             8 * bufs[3].numel()),
            ("fill_", lambda: bufs[next(turn) % 3].fill_(1.0),
             4 * bufs[3].numel())):
        ms = device_times(torch, fn)["device_ms"]
        rates[name] = moved / ms / 1e9
        print(f"HBM yardstick: torch {name} of {QUANT_T} x 128 f32 "
              f"({moved / 1e6:.1f} MB moved) {ms:.4f} ms of device time, "
              f"{rates[name]:.3f} TB/s")
    del bufs
    xb = (torch.randn(QUANT_T, 128, generator=gen, device=dev)
          * 3).to(bf16)
    codes, scales = ref.quant_pack_ref(xb, 8, GROUP)
    n = xb.numel()
    plain = {"quant_pack": lambda: ref.quant_pack_ref(xb, 8, GROUP),
             "dequant_unpack": lambda: ref.dequant_unpack_ref(
                 codes, scales, 8, GROUP, f32)}
    results = {}
    for k, main, flops in (("quant_pack", QUANT_MAIN[0], 5 * n),
                           ("dequant_unpack", QUANT_MAIN[1], n)):
        v = variants[main]
        results[k] = dict(
            max_abs_err=worst[k], ms=v["ms"],
            plain_ms=time_ms(torch, plain[k]), library_ms=None,
            device_ms=v["device_ms"], host_ms=v["host_ms"],
            kernels_per_call=v["kernels_per_call"],
            variants={name: w for name, w in variants.items()
                      if name.startswith(k)},
            hbm_yardstick_tbs=rates)
        results[k]["bound_ms"], results[k]["bound_by"] = bound(
            nbytes[main], flops)
    return results


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
# Phase 2, continued: the verify kernel's two entries
# ---------------------------------------------------------------------------
def verify_kernel_phase(torch, dev):
    """paged_verify_attention: the arena entry at the speculative main
    path's shapes (W = 2 and 5, bf16 and int8 pages), the Pallas
    interface (int8 / int4, W = 1 against paged_attention, the staircase,
    the scratch page).  Returns its results entry."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref

    cfg = get_config(ARCH)
    hkv, d = cfg.kv_heads, cfg.resolved_head_dim
    gq = cfg.num_heads // cfg.kv_heads
    gen = torch.Generator(device=dev).manual_seed(2)
    pps = -(-(SEQ + DECODE_TOKENS + 2 + SPEC_K) // PAGE_SIZE)
    n_pages = SLOTS * pps + 1
    view = pps * PAGE_SIZE
    shape = (n_pages, PAGE_SIZE, hkv, d)
    kp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
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
    # committed prefixes 6..26 tokens into decode, a fresh prefill, a
    # parked row at view_len - W (set per width below)
    base = [SEQ + 16, SEQ + 6, SEQ, 0, SEQ + 26, SEQ]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    widths, worst = {}, 0.0
    for w in (2, SPEC_K + 1):
        lens = torch.tensor(base[:3] + [view - w] + base[4:],
                            dtype=torch.int32, device=dev)
        q = torch.randn(SLOTS, hkv, gq, w, d, generator=gen,
                        device=dev).to(torch.bfloat16)
        for residency, qlens in (
                ("bf16 pages", torch.zeros(SLOTS, dtype=torch.int32,
                                           device=dev)),
                ("int8 pages", torch.full((SLOTS,), view, dtype=torch.int32,
                                          device=dev)),
                ("mixed", torch.tensor([SEQ, 0, SEQ, 0, 0, SEQ],
                                       dtype=torch.int32, device=dev))):
            args = (q, kp, vp, kc, ks, vc, vs, bt, lens, qlens)
            out, m, l = ops.paged_verify_attention_arena_op(*args)
            r_out, r_m, r_l = ref.paged_verify_attention_arena_ref(*args)
            ulps = bf16_ulps(torch, out, r_out)
            m_rel = float(((m - r_m).abs()
                           / r_m.abs().clamp_min(1e-30)).max())
            l_rel = float(((l - r_l).abs()
                           / r_l.abs().clamp_min(1e-30)).max())
            err = float((out.float() - r_out.float()).abs().max())
            print(f"paged_verify_attention_arena W={w} {residency}: out "
                  f"{ulps} bf16 ulps (max|err| {err:.3g}; tolerance 2 "
                  f"ulps), m rel {m_rel:.3g}, l rel {l_rel:.3g} (tolerance "
                  f"1e-5)")
            check(ulps <= 2 and m_rel <= 1e-5 and l_rel <= 1e-5,
                  f"paged_verify_attention_arena W={w} {residency}")
            worst = max(worst, err)
        # timed on the mixed residency of the main path
        seen = lens.long().sum().item()
        quant = torch.minimum(qlens, lens).long().sum().item()
        row = hkv * d
        kv_bytes = 2 * row * ((seen - quant) * 2 + quant * (1 + 4))
        io_bytes = q.numel() * 2 * 2 + m.numel() * 8 + bt.numel() * 4
        flops = 4 * gq * w * row * seen
        g = bt.long()
        use_q = (torch.arange(view, device=dev)[None, :]
                 < qlens[:, None])[..., None, None]

        def dense_view(pool, codes, scales):
            deq = (codes.float() * scales).to(torch.bfloat16)[g]
            return torch.where(use_q, deq.reshape(SLOTS, view, hkv, d),
                               pool[g].reshape(SLOTS, view, hkv, d)
                               ).transpose(1, 2)

        kview, vview = dense_view(kp, kc, ks), dense_view(vp, vc, vs)
        qs = q.reshape(SLOTS, hkv * gq, w, d)
        mask = (torch.arange(view, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        entry = dict(
            ms=time_ms(torch, lambda: ops.paged_verify_attention_arena_op(
                *args)),
            plain_ms=time_ms(
                torch, lambda: ref.paged_verify_attention_arena_ref(*args),
                iters=5),
            library_ms=time_ms(torch, lambda: sdpa(qs, kview, vview,
                                                   attn_mask=mask,
                                                   enable_gqa=True)))
        entry["bound_ms"], entry["bound_by"] = bound(kv_bytes + io_bytes,
                                                     flops)
        widths[f"W={w}"] = entry

    # ---- the Pallas interface: int8 / int4, W = 1, staircase, scratch ----
    pallas = {}
    pshape = (n_pages, hkv, PAGE_SIZE, d)
    w = SPEC_K + 1
    p_lens = torch.tensor([SEQ + 16, 1, SEQ, 17, SEQ + 26, SEQ // 2],
                          dtype=torch.int32, device=dev)
    qf = torch.randn(SLOTS, hkv, w, gq, d, generator=gen, device=dev)
    for bits in (8, 4):
        kx = torch.randn(pshape, generator=gen, device=dev)
        vx = torch.randn(pshape, generator=gen, device=dev)
        kcq, ksq = ref.quant_pack_ref(kx, bits, GROUP)
        vcq, vsq = ref.quant_pack_ref(vx, bits, GROUP)
        pargs = (qf, kcq, ksq, vcq, vsq, bt, p_lens)
        got = ops.paged_verify_attention_op(*pargs, bits=bits, group=GROUP)
        want = ref.paged_verify_attention_ref(*pargs, bits=bits, group=GROUP)
        perr = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, atol=2e-5, rtol=1e-4))
        one = ops.paged_verify_attention_op(qf[:, :, :1].contiguous(),
                                            *pargs[1:], bits=bits,
                                            group=GROUP)
        dec = ops.paged_attention_op(qf[:, :, 0].contiguous(), *pargs[1:],
                                     bits=bits, group=GROUP)
        w1 = bool(torch.allclose(one[:, :, 0], dec, atol=2e-5, rtol=1e-4))
        # the staircase: the last verify position's K/V moves only the
        # last row
        kz = kcq.clone()
        t = int(p_lens[0]) + w - 2
        kz[bt[0, t // PAGE_SIZE], :, t % PAGE_SIZE] = (
            0x77 if bits == 4 else 127)
        moved = ops.paged_verify_attention_op(qf, kz, *pargs[2:],
                                              bits=bits, group=GROUP)
        blind = bool(torch.equal(moved[0, :, :w - 1], got[0, :, :w - 1])
                     and not torch.equal(moved[0, :, w - 1],
                                         got[0, :, w - 1]))
        # the scratch page, poisoned, behind unmapped entries
        kpz, vpz = kcq.clone(), vcq.clone()
        kpz[0] = 0x77 if bits == 4 else 127
        vpz[0] = 0x88 if bits == 4 else -128
        bt0 = bt.clone()
        bt0[1, 1:] = 0
        a = ops.paged_verify_attention_op(qf, kcq, ksq, vcq, vsq, bt0,
                                          p_lens, bits=bits, group=GROUP)
        b = ops.paged_verify_attention_op(qf, kpz, ksq, vpz, vsq, bt0,
                                          p_lens, bits=bits, group=GROUP)
        inert = bool(torch.equal(a, b))
        print(f"paged_verify_attention (Pallas interface) int{bits} W={w}: "
              f"max|err| {perr:.3g} (tolerance atol 2e-5 + rtol 1e-4), W=1 "
              f"equals paged_attention: {w1}, staircase blind: {blind}, "
              f"scratch page inert: {inert}")
        check(ok and w1 and blind and inert,
              f"paged_verify_attention int{bits}")
        pallas[f"int{bits}"] = dict(
            max_abs_err=perr,
            ms=time_ms(torch, lambda: ops.paged_verify_attention_op(
                *pargs, bits=bits, group=GROUP)),
            plain_ms=time_ms(torch, lambda: ref.paged_verify_attention_ref(
                *pargs, bits=bits, group=GROUP), iters=5))
    main = dict(widths[f"W={SPEC_K + 1}"])
    main["max_abs_err"] = worst
    main["widths"] = widths
    main["pallas_interface"] = pallas
    return main


# ---------------------------------------------------------------------------
# Phase 2, continued: the Hadamard kernel
# ---------------------------------------------------------------------------
def _bits_equal(np, a, b):
    return a.view(np.int32) == b.view(np.int32)


HADAMARD_TILE_ROWS = 32      # hadamard.cu's row tile at D = 128


def hadamard_main_calls(torch, dev, ops):
    """{"hadamard f32": call, "hadamard bf16": call}: ``hadamard_op`` at
    the pipeline's shape (one request's K, (L·Hkv·SEQ, D) of llama3.1-8b),
    f32 and bf16 in, f32 out, through ``ops``: the module of this tree or
    of another checkout.  Also returns the f32 input."""
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(32 * 8 * SEQ, 128, generator=gen, device=dev) * 3
    xb = x.to(torch.bfloat16)
    return {"hadamard f32": lambda: ops.hadamard_op(x, out_dtype=x.dtype),
            "hadamard bf16": lambda: ops.hadamard_op(
                xb, out_dtype=x.dtype)}, x


def clock_under_load(torch, fn, seconds: float = 2.0) -> dict:
    """The SM clock (MHz) and power draw (W) that ``nvidia-smi`` reads
    halfway through ``seconds`` of back-to-back calls of ``fn``: whether
    the card held its clock under the load.  Run after the last
    torch.profiler window: on the card, torch.profiler saw no CUDA kernel
    in a window that followed this query."""
    import threading

    reading = {}

    def query():
        time.sleep(seconds / 2)
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.split(",")
        reading.update(sm_clock_mhz=float(out[0]), power_w=float(out[1]))

    t = threading.Thread(target=query)
    t0 = time.perf_counter()
    t.start()
    while time.perf_counter() - t0 < seconds:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    t.join()
    check(set(reading) == {"sm_clock_mhz", "power_w"}, "nvidia-smi clocks")
    return reading


def hadamard_kernel_phase(torch, dev):
    """hadamard at the pipeline's shape (one request's K, (L·Hkv·SEQ, D)),
    f32 and bf16 in, and at D 4, 8, 64, 256 and 512, T 1, 77, 4097 and one
    below, at and above a whole row tile, against its plain version (max
    |diff| <= 1e-5 of the row's L2 norm) and against numpy's ``x @ h`` on
    the host: bit for bit at D 64, 128 and 256 (one in-order FMA chain per
    output, a BLAS micro-kernel's order; numpy takes a vector routine for
    one row, so T = 1 is held against the product of two copies), the
    share of bit-equal outputs recorded at D 4, 8 and 512 (BLAS may block
    K there); bf16 out must be the f32 result rounded.  Returns (results
    entry, the main shape bit-equal to numpy)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.transforms import hadamard_matrix
    from repro_torch.kernels import ops, ref

    cfg = get_config(ARCH)
    d = cfg.resolved_head_dim
    t_main = cfg.num_layers * cfg.kv_heads * SEQ
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3)

    def data(t, dd, dt):
        x = torch.randn(t, dd, generator=gen, device=dev) * 3
        x[:, 1] *= 40          # an outlier channel, which the rotation spreads
        return x.to(dt)

    tile = HADAMARD_TILE_ROWS
    cases = [(t_main, d, f32), (t_main, d, bf16), (t_main, 64, f32),
             (t_main, 256, bf16), (4097, d, f32), (77, 256, bf16),
             (1, d, f32), (tile - 1, d, bf16), (tile, d, f32),
             (tile + 1, d, f32), (4097, 4, f32), (77, 4, bf16),
             (4097, 8, bf16), (1, 8, f32), (4097, 512, f32),
             (77, 512, bf16), (1, 512, f32)]
    worst, host_exact = 0.0, True
    for t, dd, dt in cases:
        x = data(t, dd, dt)
        got = ops.hadamard_op(x, out_dtype=f32)
        want = ref.hadamard_ref(x, f32)
        diff = (got - want).abs()
        rel = float((diff.amax(dim=1)
                     / x.float().norm(dim=1).clamp_min(1e-30)).max())
        worst = max(worst, float(diff.max()))
        rounded = bool(torch.equal(ops.hadamard_op(x, out_dtype=bf16),
                                   got.to(bf16)))
        xh = x.float().cpu().numpy()
        hm = hadamard_matrix(dd)
        host = (np.concatenate([xh, xh]) @ hm)[:1] if t == 1 else xh @ hm
        g = got.cpu().numpy()
        same = _bits_equal(np, g, host)
        line = (f"hadamard T={t} D={dd} {str(dt)[6:]} in: max|diff| / row "
                f"norm {rel:.3g} against the plain version (tolerance "
                f"1e-5); bf16 out = f32 out rounded: {rounded}; bit-equal "
                f"to numpy x @ h on the host: {float(same.mean())}")
        if not same.all():
            i, j = (int(a[0]) for a in np.nonzero(~same))
            line += (f" (first difference at [{i}, {j}]: kernel "
                     f"{g[i, j]!r}, numpy {host[i, j]!r})")
        print(line)
        check(rel <= 1e-5 and rounded, f"hadamard T={t} D={dd} {dt}")
        if dd in (64, 128, 256):
            check(bool(same.all()), f"hadamard T={t} D={dd} {dt} = numpy")
        if t == t_main and dd == d:
            host_exact = host_exact and bool(same.all())
    calls, x = hadamard_main_calls(torch, dev, ops)
    h = ref.hadamard_table(d, dev)
    n = x.numel()
    nbytes = 2 * n * 4
    entry = dict(
        max_abs_err=worst,
        ms=time_ms(torch, calls["hadamard f32"]),
        plain_ms=time_ms(torch, lambda: ref.hadamard_ref(x, f32)),
        library_ms=time_ms(torch, lambda: torch.matmul(x, h)),
        bf16_in_ms=time_ms(torch, calls["hadamard bf16"]),
        bytes_bound_ms=nbytes / PEAK_BYTES_S * 1e3)
    entry["bound_ms"], entry["bound_by"] = bound(nbytes, 2 * n * d)
    entry.update(device_times(torch, calls["hadamard f32"]))
    entry["bf16_in_device_ms"] = device_times(
        torch, calls["hadamard bf16"])["device_ms"]
    entry["library_device_ms"] = device_times(
        torch, lambda: torch.matmul(x, h))["device_ms"]
    print(f"hadamard at the main shape: {entry['device_ms']:.4f} ms of "
          f"device time per call ({entry['kernels_per_call']:g} CUDA "
          f"kernels), bf16 in {entry['bf16_in_device_ms']:.4f} ms, "
          f"torch.matmul {entry['library_device_ms']:.4f} ms; host "
          f"enqueue {entry['host_ms']:.4f} ms per call")
    return entry, host_exact


# ---------------------------------------------------------------------------
# Phase 2, continued: decode_attention, dense quantized flash-decode
# ---------------------------------------------------------------------------
SLOT_LENS = (SEQ + DECODE_TOKENS + 2, 1040, 600, 17, 1, 1031)
DECODE_SPLIT = 64            # decode_attention.cu's kSplit
# split - 1, split, split + 1, a last split of one position, two full
# splits, one position
SPLIT_EDGE_LENS = (63, 64, 65, 129, 128, 1)


def decode_main_call(torch, dev, ops):
    """{"decode_attention": call}: ``decode_attention_op`` at case (a)'s
    shape (6 slots, Hkv 8, Gq 4, D 128, S 1056), int8 group 64, f32 q,
    block_s 32, every position visible, through ``ops``: the module of
    this tree or of another checkout.  Also returns the call's inputs."""
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(5)
    s = SLOT_LENS[0]
    q = torch.randn(SLOTS, 8, 4, 128, generator=gen, device=dev)
    kv = []
    for _ in range(2):
        kv += list(ref.quant_pack_ref(torch.randn(
            SLOTS, 8, s, 128, generator=gen, device=dev), 8, GROUP))
    args = [q] + kv
    return {"decode_attention": lambda: ops.decode_attention_op(
        *args, bits=8, group=GROUP, block_s=32)}, args


def bf16_close(torch, got, want, atol: float = 2e-5):
    """(bf16 ulps over the elements that differ by more than ``atol``,
    ulps over all): bf16 outputs below 2.6e-3 have a last place finer than
    the f32 sums' order sets, so there the f32 atol holds."""
    def ordered(x):
        i = x.float().view(torch.int32) >> 16
        return torch.where(i < 0, -(i & 0x7FFF), i).long()
    ulps = (ordered(got) - ordered(want)).abs()
    far = ulps[(got.float() - want.float()).abs() > atol]
    return (int(far.max()) if far.numel() else 0), int(ulps.max())


def decode_attention_kernel_phase(torch, dev):
    """decode_attention through its public entry, against its plain
    version: (a) the slot-arena decode of llama3.1-8b at full width, B = 6
    slots of S = SEQ + DECODE_TOKENS + 2 with ragged lengths, int8 and
    int4, f32 and bf16 q; (b) benchmarks/kernel_throughput.py's shape;
    (c) tests/test_kernels.py's three shapes at a static length; (d) a
    32,768-position context; (e) Gq 48 over one KV head; (f) paged
    attention over a block table against decode_attention over the
    gathered view; (g) the edges of the kernel's split of the positions
    into blocks of 64: lengths 63, 64 and 65, a slot whose last split holds
    one position (129), and a static length of 65.  Every case is launched
    twice and the two results must be equal bit for bit (no atomics, one
    combine order).  Tolerances: f32 q atol 2e-5 + rtol 1e-4; bf16 q 1
    bf16 ulp (atol 2e-5 below 2.6e-3, see ``bf16_close``).  The launch
    counts are set to 0 before the cases and read after them.  Returns
    (results entry, launches)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref, reset_launches

    cfg = get_config(ARCH)
    hkv, d = cfg.kv_heads, cfg.resolved_head_dim
    gq = cfg.num_heads // cfg.kv_heads
    gen = torch.Generator(device=dev).manual_seed(4)
    f32, bf16 = torch.float32, torch.bfloat16

    def case(b, h, g, s, dd, bits, group, q_dtype):
        q = torch.randn(b, h, g, dd, generator=gen, device=dev).to(q_dtype)
        kv = []
        for _ in range(2):
            kv += list(ref.quant_pack_ref(torch.randn(
                b, h, s, dd, generator=gen, device=dev), bits, group))
        return [q] + kv

    def plain(args, bits, group, kv_len):
        q, kc, ks, vc, vs = args
        if bits == 4:
            kc, vc = ref.unpack_int4_ref(kc), ref.unpack_int4_ref(vc)
        return ref.decode_attention_ref(q, kc, ks, vc, vs, group, kv_len)

    worst = 0.0

    def hold(label, got, want):
        nonlocal worst
        err = float((got.float() - want.float()).abs().max())
        worst = max(worst, err)
        if got.dtype == f32:
            ok = bool(torch.allclose(got, want, atol=2e-5, rtol=1e-4))
            line = "tolerance atol 2e-5 + rtol 1e-4"
        else:
            far, ulps = bf16_close(torch, got, want)
            ok = far <= 1
            line = (f"{ulps} bf16 ulps, {far} beyond atol 2e-5; tolerance 1 "
                    f"ulp")
        print(f"decode_attention {label}: max|err| {err:.3g} ({line})")
        check(ok, f"decode_attention {label}")

    s_main = SLOT_LENS[0]
    slot_lens = torch.tensor(SLOT_LENS, dtype=torch.int32, device=dev)
    edge_lens = torch.tensor(SPLIT_EDGE_LENS, dtype=torch.int32, device=dev)
    cases = [  # label, (B, Hkv, Gq, S, D), bits, group, block_s, kv_len, q
        *[(f"(a) llama3.1-8b slots int{bits} {str(dt)[6:]} q",
           (SLOTS, hkv, gq, s_main, d), bits, GROUP, 32, slot_lens, dt)
          for bits in (8, 4) for dt in (f32, bf16)],
        ("(b) kernel_throughput shape", (2, 2, 4, 1024, 128), 8, 64, 256,
         None, f32),
        *[(f"(c) test shape {shape} int{bits}", shape, bits, g, blk,
           shape[3] - shape[3] // 4, f32) for bits in (4, 8)
          for shape, g, blk in [((2, 2, 4, 512, 64), 64, 128),
                                ((1, 4, 8, 256, 128), 32, 256),
                                ((3, 1, 2, 1024, 128), 128, 256)]],
        ("(d) 32,768 positions int4", (1, hkv, gq, 32768, d), 4, GROUP, 256,
         32000, f32),
        *[(f"(e) Gq 48 {str(dt)[6:]} q", (1, 1, 48, 2048, d), 8, GROUP, 256,
           None, dt) for dt in (f32, bf16)],
        *[(f"(g) split edges int{bits} {str(dt)[6:]} q",
           (SLOTS, hkv, gq, s_main, d), bits, GROUP, 32, edge_lens, dt)
          for bits, dt in ((8, f32), (4, bf16))],
        ("(g) split edges, static length 65", (2, hkv, gq, 256, d), 8,
         GROUP, 64, DECODE_SPLIT + 1, f32),
    ]
    reset_launches()
    for label, shape, bits, group, blk, kv_len, dt in cases:
        args = case(*shape, bits, group, dt)
        got = ops.decode_attention_op(*args, bits=bits, group=group,
                                      kv_len=kv_len, block_s=blk)
        again = ops.decode_attention_op(*args, bits=bits, group=group,
                                        kv_len=kv_len, block_s=blk)
        check(bool(torch.equal(got, again)),
              f"decode_attention {label}: two launches bit-equal")
        hold(label + ", two launches bit-equal", got,
             plain(args, bits, group, kv_len))
        if isinstance(kv_len, torch.Tensor) and bits == 8 and dt == f32:
            rows = all(torch.equal(ops.decode_attention_op(
                *[t[i:i + 1] for t in args], bits=bits, group=group,
                kv_len=n, block_s=blk)[0], got[i])
                for i, n in enumerate(kv_len.tolist()))
            print(f"decode_attention {label[:3]}: each slot alone at its "
                  f"length equals its row: {rows}")
            check(rows, f"decode_attention {label[:3]} rows")

    # (f) paged attention over a block table = dense over the gathered view
    pps = s_main // PAGE_SIZE
    n_pages = SLOTS * pps + 1
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    bt = perm.reshape(SLOTS, pps).to(torch.int32)
    q = torch.randn(SLOTS, hkv, gq, d, generator=gen, device=dev)
    for bits in (8, 4):
        pools = []
        for _ in range(2):
            pools += list(ref.quant_pack_ref(torch.randn(
                n_pages, hkv, PAGE_SIZE, d, generator=gen, device=dev), bits,
                GROUP))
        paged = ops.paged_attention_op(q, *pools, bt, slot_lens, bits=bits,
                                       group=GROUP)
        dense = [ref._gather_pages(p, bt).contiguous() for p in pools]
        got = ops.decode_attention_op(q, *dense, bits=bits, group=GROUP,
                                      kv_len=slot_lens, block_s=32)
        hold(f"(f) int{bits} = paged_attention over the block table", got,
             paged)
    launches = ops.decode_attention_op.launches

    # timed at (a)'s shape, int8, f32 q, every position visible
    calls, (q, kc, ks, vc, vs) = decode_main_call(torch, dev, ops)
    call = calls["decode_attention"]
    kd = ref.dequantize_ref(kc, ks, GROUP, bf16)
    vd = ref.dequantize_ref(vc, vs, GROUP, bf16)
    qs = q.to(bf16).reshape(SLOTS, hkv * gq, 1, d)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = (lambda: sdpa(qs, kd, vd, enable_gqa=True))
    nbytes = sum(t.numel() * t.element_size() for t in (q, kc, ks, vc, vs))
    nbytes += q.numel() * 4                                   # the output
    entry = dict(
        max_abs_err=worst,
        ms=time_ms(torch, call),
        plain_ms=time_ms(torch, lambda: ref.decode_attention_ref(
            q, kc, ks, vc, vs, GROUP)),
        library_ms=time_ms(torch, library))
    entry["bound_ms"], entry["bound_by"] = bound(
        nbytes, 4 * SLOTS * hkv * gq * d * s_main)
    entry.update(device_times(torch, call))
    entry["library_device_ms"] = device_times(torch, library)["device_ms"]
    print(f"decode_attention at case (a): {entry['device_ms']:.4f} ms of "
          f"device time per call ({entry['kernels_per_call']:g} CUDA "
          f"kernels: {entry['by_kernel']}), SDPA "
          f"{entry['library_device_ms']:.4f} ms; host enqueue "
          f"{entry['host_ms']:.4f} ms per call")
    return entry, launches


def repaired_shapes_phase(torch, dev):
    """The shapes the attention kernels refused before their score rows
    left shared memory and their query rows went to tiles, against their
    plain versions at the main path's tolerances (one layer each): the
    arena decode of llama3.1-8b over 16,400 positions, a W = 5 verify over
    4,096, the Pallas paged_attention at Gq 48 over one KV head, and the
    verify arena at qwen2.5-7b's Hkv 4, Gq 7, W = 5 (35 rows)."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(5)
    d, b = 128, SLOTS

    def arena(hkv, pps, lens, qlens):
        shape = (b * pps + 1, PAGE_SIZE, hkv, d)
        fp = [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2)]
        codes = [torch.randint(-128, 128, shape, generator=gen, device=dev,
                               dtype=torch.int8) for _ in range(2)]
        scales = [torch.rand(shape, generator=gen, device=dev) * 0.02 + 1e-3
                  for _ in range(2)]
        perm = torch.randperm(b * pps, generator=gen, device=dev) + 1
        return (fp[0], fp[1], codes[0], scales[0], codes[1], scales[1],
                perm.reshape(b, pps).to(torch.int32),
                torch.tensor(lens, dtype=torch.int32, device=dev),
                torch.tensor(qlens, dtype=torch.int32, device=dev))

    def hold_arena(label, got, want):
        (out, m, l), (r_out, r_m, r_l) = got, want
        ulps = bf16_ulps(torch, out, r_out)
        m_rel = float(((m - r_m).abs() / r_m.abs().clamp_min(1e-30)).max())
        l_rel = float(((l - r_l).abs() / r_l.abs().clamp_min(1e-30)).max())
        print(f"{label}: out {ulps} bf16 ulps (tolerance 2), m rel "
              f"{m_rel:.3g}, l rel {l_rel:.3g} (tolerance 1e-5)")
        check(ulps <= 2 and m_rel <= 1e-5 and l_rel <= 1e-5, label)

    pools = arena(8, 1025, [16400, 16390, 9000, 1040, 17, 1],
                  [16384, 0, 9000, 1024, 9, 0])
    q = torch.randn(b, 8, 4, d, generator=gen, device=dev).to(torch.bfloat16)
    hold_arena("paged_attention_arena, 16,400 positions (llama3.1-8b)",
               ops.paged_attention_arena_op(q, *pools),
               ref.paged_attention_arena_ref(q, *pools))
    del pools
    for hkv, gq, pps, label in ((8, 4, 256, "4,096 positions"),
                                (4, 7, 67, "Hkv 4 Gq 7 (qwen2.5-7b), 35 rows")):
        view = pps * PAGE_SIZE
        pools = arena(hkv, pps, [view - 5, view // 2, 1030, 1, 17, 600],
                      [SEQ, 0, SEQ, 0, 9, 0])
        q = torch.randn(b, hkv, gq, 5, d, generator=gen,
                        device=dev).to(torch.bfloat16)
        hold_arena(f"paged_verify_attention_arena W=5, {label}",
                   ops.paged_verify_attention_arena_op(q, *pools),
                   ref.paged_verify_attention_arena_ref(q, *pools))
    pools = []
    n_pages = 2 * 128 + 1
    for _ in range(2):
        pools += list(ref.quant_pack_ref(torch.randn(
            n_pages, 1, PAGE_SIZE, d, generator=gen, device=dev), 8, GROUP))
    bt = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1).reshape(
        2, 128).to(torch.int32)
    lens = torch.tensor([2048, 777], dtype=torch.int32, device=dev)
    q = torch.randn(2, 1, 48, d, generator=gen, device=dev)
    got = ops.paged_attention_op(q, *pools, bt, lens, bits=8, group=GROUP)
    want = ref.paged_attention_ref(q, *pools, bt, lens, 8, GROUP)
    err = float((got - want).abs().max())
    print(f"paged_attention (Pallas interface) Gq 48 Hkv 1 (granite-20b): "
          f"max|err| {err:.3g} (tolerance atol 2e-5 + rtol 1e-4)")
    check(bool(torch.allclose(got, want, atol=2e-5, rtol=1e-4)),
          "paged_attention Gq 48")


def split_edges_phase(torch, dev):
    """The split design's edges at the main shapes (6 slots, 8 KV heads,
    Gq 4, D 128; phase A's chunks of 32 positions at W <= 2 and 64 at W =
    5, phase B's stages of 128), through both entries of both attention
    kernels, each launched twice (the two results must be equal bit for
    bit: no atomics, one order per sum) and held against its plain
    version: a length at a chunk and stage boundary and one either side,
    slots shorter than one chunk (lengths 1 and 17), slots whose later
    chunks all lie beyond their length, quant_lens mid-chunk, the parked
    row at view - 1, and W = 2 and 5 verify with the staircase across a
    chunk boundary."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(6)
    hkv, gq, d = 8, 4, 128
    length_sets = {
        "boundaries": ([1024, 1023, 1025, None, 17, 1],
                       [1000, 33, 1025, 0, 9, 0]),
        "short": ([64, 63, 65, 100, 128, 129], [40, 63, 0, 100, 64, 1]),
    }

    def twice(fn, *args, **kw):
        a, b = fn(*args, **kw), fn(*args, **kw)
        a_t = a if isinstance(a, tuple) else (a,)
        b_t = b if isinstance(b, tuple) else (b,)
        return a, all(torch.equal(x, y) for x, y in zip(a_t, b_t))

    for w in (1, 2, SPEC_K + 1):
        pps = -(-(SEQ + DECODE_TOKENS + 2 + (SPEC_K if w > 1 else 0))
                // PAGE_SIZE)
        view = pps * PAGE_SIZE
        n_pages = SLOTS * pps + 1
        shape = (n_pages, PAGE_SIZE, hkv, d)
        fp = [torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2)]
        codes = [torch.randint(-128, 128, shape, generator=gen, device=dev,
                               dtype=torch.int8) for _ in range(2)]
        scales = [torch.rand(shape, generator=gen, device=dev) * 0.02 + 1e-3
                  for _ in range(2)]
        bt = (torch.randperm(n_pages - 1, generator=gen, device=dev)
              + 1).reshape(SLOTS, pps).to(torch.int32)
        qshape = (SLOTS, hkv, gq, d) if w == 1 else (SLOTS, hkv, gq, w, d)
        q = torch.randn(qshape, generator=gen, device=dev).to(torch.bfloat16)
        op, plain = ((ops.paged_attention_arena_op,
                      ref.paged_attention_arena_ref) if w == 1 else
                     (ops.paged_verify_attention_arena_op,
                      ref.paged_verify_attention_arena_ref))
        for name, (kv, qv) in length_sets.items():
            lens = torch.tensor([view - 1 if n is None else n for n in kv],
                                dtype=torch.int32, device=dev)
            qlens = torch.tensor(qv, dtype=torch.int32, device=dev)
            args = (q, fp[0], fp[1], codes[0], scales[0], codes[1],
                    scales[1], bt, lens, qlens)
            (out, m, l), same = twice(op, *args)
            r_out, r_m, r_l = plain(*args)
            ulps = bf16_ulps(torch, out, r_out)
            m_rel = float(((m - r_m).abs()
                           / r_m.abs().clamp_min(1e-30)).max())
            l_rel = float(((l - r_l).abs()
                           / r_l.abs().clamp_min(1e-30)).max())
            print(f"split edges, arena W={w} {name} lengths: out {ulps} "
                  f"bf16 ulps (tolerance 2), m rel {m_rel:.3g}, l rel "
                  f"{l_rel:.3g} (tolerance 1e-5), two launches bit-equal: "
                  f"{same}")
            check(ulps <= 2 and m_rel <= 1e-5 and l_rel <= 1e-5 and same,
                  f"split edges arena W={w} {name}")
        # the Pallas interface: int8 and int4 pools (P, Hkv, PS, D')
        pshape = (n_pages, hkv, PAGE_SIZE, d)
        qf = torch.randn((SLOTS, hkv, gq, d) if w == 1 else
                         (SLOTS, hkv, w, gq, d), generator=gen, device=dev)
        p_lens = ([1024, 1023, 1025, view - 1, 17, 1] if w == 1 else
                  [{2: 63, 5: 62}[w], 1023, 1025 - w, view - w, 17, 1])
        p_lens = torch.tensor(p_lens, dtype=torch.int32, device=dev)
        pop, pplain = ((ops.paged_attention_op, ref.paged_attention_ref)
                       if w == 1 else (ops.paged_verify_attention_op,
                                       ref.paged_verify_attention_ref))
        for bits in (8, 4):
            pools = []
            for _ in range(2):
                pools += list(ref.quant_pack_ref(torch.randn(
                    pshape, generator=gen, device=dev), bits, GROUP))
            got, same = twice(pop, qf, *pools, bt, p_lens, bits=bits,
                              group=GROUP)
            want = pplain(qf, *pools, bt, p_lens, bits=bits, group=GROUP)
            err = float((got - want).abs().max())
            ok = bool(torch.allclose(got, want, atol=2e-5, rtol=1e-4))
            print(f"split edges, Pallas interface W={w} int{bits}: max|err| "
                  f"{err:.3g} (tolerance atol 2e-5 + rtol 1e-4), two "
                  f"launches bit-equal: {same}")
            check(ok and same, f"split edges Pallas W={w} int{bits}")


def attention_main_calls(torch, dev, ops):
    """{"W=1": call, "W=2": call, "W=5": call}: the two arena attention
    entries at the main path's shapes (one decode step's layer read, W = 1;
    verify at W = 2 and 5), through ``ops``: the module of this tree or of
    another checkout."""
    gen = torch.Generator(device=dev).manual_seed(1)
    hkv, gq, d = 8, 4, 128
    calls = {}
    for w in (1, 2, SPEC_K + 1):
        pps = -(-(SEQ + DECODE_TOKENS + 2 + (SPEC_K if w > 1 else 0))
                // PAGE_SIZE)
        shape = (SLOTS * pps + 1, PAGE_SIZE, hkv, d)
        kp, vp = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        kc, vc = (torch.randint(-128, 128, shape, generator=gen, device=dev,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(shape, generator=gen, device=dev) * 0.02 + 1e-3
                  for _ in range(2))
        bt = (torch.randperm(SLOTS * pps, generator=gen, device=dev)
              + 1).reshape(SLOTS, pps).to(torch.int32)
        lens = torch.tensor([SEQ + 16, SEQ + 6, SEQ, pps * PAGE_SIZE - w,
                             SEQ + 26, SEQ], dtype=torch.int32, device=dev)
        qlens = torch.tensor([SEQ, 0, SEQ, 0, 0, SEQ], dtype=torch.int32,
                             device=dev)
        args = (kp, vp, kc, ks, vc, vs, bt, lens, qlens)
        if w == 1:
            q = torch.randn(SLOTS, hkv, gq, d, generator=gen,
                            device=dev).to(torch.bfloat16)
            calls["W=1"] = (lambda q=q, args=args:
                            ops.paged_attention_arena_op(q, *args))
        else:
            q = torch.randn(SLOTS, hkv, gq, w, d, generator=gen,
                            device=dev).to(torch.bfloat16)
            calls[f"W={w}"] = (lambda q=q, args=args:
                               ops.paged_verify_attention_arena_op(q, *args))
    return calls


def main_times(torch, dev, ops):
    """``time_ms`` of the arena attention entries at the main path's
    shapes (``attention_main_calls``), decode_attention at case (a)
    (``decode_main_call``), hadamard at the pipeline's shape, f32 and
    bf16 in (``hadamard_main_calls``), and quant_pack and dequant_unpack
    at the main shape (``quant_main_calls``), through ``ops``; for the two
    main variants of the last (``QUANT_MAIN``) also the device time per
    call (``device_times``), under "<name> device"."""
    calls = dict(attention_main_calls(torch, dev, ops))
    calls.update(decode_main_call(torch, dev, ops)[0])
    calls.update(hadamard_main_calls(torch, dev, ops)[0])
    quant = quant_main_calls(torch, dev, ops)[0]
    calls.update(quant)
    out = {k: time_ms(torch, fn) for k, fn in calls.items()}
    for k in QUANT_MAIN:
        out[f"{k} device"] = device_times(torch, quant[k])["device_ms"]
    return out


def attention_phase_times(torch, dev):
    """Device time per call of each CUDA kernel that one arena attention
    call issues at the main shapes (the split design's phase A,
    ``split_scores``, and phase B, ``split_values``), from torch.profiler
    over 20 back-to-back calls; and the host's time to enqueue one call.
    Returns {"W=1": {"phase_a_ms": .., "phase_b_ms": .., "kernels_per_call":
    .., "host_ms": ..}, ...}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    out = {}
    for w, fn in attention_main_calls(torch, dev, ops).items():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        host_ms = (time.perf_counter() - t0) / 100 * 1e3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        phases, launched = {}, 0
        for e in prof.key_averages():
            dt = getattr(e, "device_time_total", None)
            if dt is None:
                dt = e.cuda_time_total
            for key, name in (("phase_a_ms", "split_scores"),
                              ("phase_b_ms", "split_values")):
                if name in e.key and e.count:
                    phases[key] = dt / e.count / 1e3
                    launched += e.count
        check(set(phases) == {"phase_a_ms", "phase_b_ms"},
              f"profiler saw both phases at {w}")
        out[w] = dict(phases, kernels_per_call=launched / 20,
                      host_ms=host_ms)
        print(f"arena attention {w} at the main shapes: phase A "
              f"{phases['phase_a_ms']:.4f} ms + phase B "
              f"{phases['phase_b_ms']:.4f} ms of device time per call "
              f"(torch.profiler, {launched / 20:g} CUDA kernels per call), "
              f"host enqueue {host_ms:.4f} ms per call")
    return out


def compare_with(torch, baseline: Path):
    """The arena attention entries, decode_attention, hadamard,
    quant_pack and dequant_unpack at the main path's shapes
    (``main_times``), timed from ``baseline`` (a
    checkout of another commit, e.g. ``git archive`` of the parent) and
    from this tree, in turns (baseline, this, this, baseline), each in a
    process of its own on this card."""
    runs = []
    for src in (baseline / "src", ROOT / "src", ROOT / "src",
                baseline / "src"):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--attention-times", str(src)],
            capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0,
              f"timing {src}: {proc.stderr[-2000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for w in runs[0]:
        base = [runs[0][w], runs[3][w]]
        this = [runs[1][w], runs[2][w]]
        what = w if w[0].isalpha() else f"arena attention {w}"
        print(f"{what} at the main shapes: this tree "
              f"{this[0]:.4f} / {this[1]:.4f} ms, {baseline} "
              f"{base[0]:.4f} / {base[1]:.4f} ms (ratio "
              f"{sum(this) / sum(base):.4f})")
    return runs


# ---------------------------------------------------------------------------
# Phase 3: the serving runtime at full width
# ---------------------------------------------------------------------------
def model_setup(torch, dev):
    """Seeded random bf16 weights at full width, and one warm-up prefill
    and decode step (cuBLAS's lazy initialisation, which a long-running
    server pays once).  Returns (cfg, params)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import (
        decode_step, init_cache, init_params, prefill)

    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"{ARCH}: {n_params / 1e9:.3f}B seeded bf16 parameters on {dev} "
          f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    max_len = SEQ + DECODE_TOKENS + 2
    warm_cache = init_cache(cfg, SLOTS, max_len, device=dev)
    prefill(cfg, params, {"tokens": torch.zeros((1, SEQ), dtype=torch.int32,
                                                device=dev)}, max_len)
    decode_step(cfg, params, warm_cache,
                torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev),
                torch.full((SLOTS,), SEQ, dtype=torch.int32, device=dev))
    del warm_cache
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"warm-up (one prefill, one dense decode step): "
          f"{time.perf_counter() - t0:.2f} s")
    return cfg, params


def serve(torch, dev, cfg, params, **spec):
    """Serve SCENARIO PD-separated on the paged arena (``spec``: the
    speculation fields of RuntimeConfig); the launch counts are set to 0
    just before the run and read just after.  Returns (runtime, wall
    seconds, launch counts)."""
    from repro_torch.core.profiles import Profile
    from repro_torch.core.strategy import StrategyConfig
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.serving import GBPS, BandwidthTrace, SchedulerConfig
    from repro_torch.serving.engine import RuntimeConfig, ServingRuntime

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
                             store_capacity=1 << 30, **spec),
        trace=BandwidthTrace.constant(100 * GBPS),
        scheduler=SchedulerConfig(max_slots=SLOTS, max_prefills_per_step=2,
                                  max_queue=32),
        device=dev)
    rt.model_cfg, rt.params = cfg, params
    if dev.type == "cuda":
        torch.cuda.synchronize()
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
    return rt, wall, launches()


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


def release_arenas(torch, rt) -> None:
    """Free a finished runtime's page pools (~3 GB at full width) and a
    draft model's arena before the next phase allocates its own."""
    for dw in rt.decode_workers:
        dw._arena = dw._qcodes = dw._qscales = dw._draft = None
    torch.cuda.empty_cache()


def print_requests(rt, wall) -> None:
    print(f"runtime: {len(rt.completed)} requests in {wall:.2f} s wall, "
          f"{rt.steps} iterations")
    for r in sorted(rt.completed, key=lambda r: r.rid):
        bd = ", ".join(f"{k}={v * 1e3:.2f}ms" for k, v in r.breakdown.items())
        print(f"  rid {r.rid} {r.workload:9s} hit={int(r.pool_hit)} "
              f"ttft={r.ttft * 1e3:.2f}ms jct={r.jct * 1e3:.2f}ms "
              f"wire_bytes={r.wire_bytes} [{bd}]")


def print_speculation(plain, spec) -> None:
    """Per request: the speculative run's TTFT, JCT, verify steps,
    committed tokens and accept rate beside the plain run's TTFT/JCT."""
    base = {r.rid: r for r in plain.completed}
    for r in sorted(spec.completed, key=lambda r: r.rid):
        p = base[r.rid]
        rate = (r.drafts_accepted / r.drafts_offered
                if r.drafts_offered else float("nan"))
        print(f"  rid {r.rid} {r.workload:9s} hit={int(r.pool_hit)} "
              f"ttft={r.ttft * 1e3:.2f}ms (plain {p.ttft * 1e3:.2f}ms) "
              f"jct={r.jct * 1e3:.2f}ms (plain {p.jct * 1e3:.2f}ms) "
              f"decode={r.breakdown['decode'] * 1e3:.2f}ms (plain "
              f"{p.breakdown['decode'] * 1e3:.2f}ms) verify_steps="
              f"{r.verify_steps} committed={r.spec_committed} "
              f"drafts={r.drafts_accepted}/{r.drafts_offered} "
              f"accept_rate={rate:.3f} tokens={list(map(int, r.tokens))}")


def _baseline_library(torch, baseline: Path, name: str):
    """The ctypes library of ``name`` built from ``baseline``'s sources
    with this tree's nvcc flags, with this tree's argument types (the C
    interfaces are the same)."""
    import ctypes

    from repro_torch.kernels import build

    src = baseline / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu"
    out = ROOT / "build" / "baseline" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True,
                          timeout=600)
    check(proc.returncode == 0, f"baseline {name}: {proc.stdout[-2000:]}")
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in build.SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def decode_step_times(torch, dev, cfg, params, baseline=None):
    """One full-width paged decode step of SLOTS slots, as phase 3 runs
    it (lengths 1024-1055, mixed residency, 32 paged_attention_arena
    launches): the host's time to enqueue the step, its wall time ending in
    a sync (medians of 8), and the device's busy time per step from
    torch.profiler.  With ``baseline``, the same step with the baseline's
    paged_attention library in place of this tree's, in turns (this,
    baseline, baseline, this).  Returns {label: [runs]}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.quality import _paged_caches, init_paged_pools
    from repro_torch.kernels import build
    from repro_torch.models.transformer import decode_step

    pps = -(-(SEQ + DECODE_TOKENS + 2) // PAGE_SIZE)
    n_pages = SLOTS * pps + 1
    pool, qc, qs = init_paged_pools(cfg, n_pages, PAGE_SIZE, 1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    bt = (torch.randperm(n_pages - 1, generator=gen, device=dev)
          + 1).reshape(SLOTS, pps).to(torch.int32)
    lens = torch.tensor([SEQ + 16, SEQ + 6, SEQ, pps * PAGE_SIZE - 1,
                         SEQ + 26, SEQ], dtype=torch.int32, device=dev)
    qlens = torch.tensor([SEQ, 0, SEQ, 0, 0, SEQ], dtype=torch.int32,
                         device=dev)
    paged = _paged_caches(pool, qc, qs, bt, qlens)
    tok = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)

    def step():
        return decode_step(cfg, params, paged, tok, lens)

    def measure(label):
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        hosts, walls = [], []
        for _ in range(8):
            t0 = time.perf_counter()
            step()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            hosts.append((t1 - t0) * 1e3)
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                step()
            torch.cuda.synchronize()
        busy = attn = 0.0
        for e in prof.key_averages():
            dt = getattr(e, "self_device_time_total", None)
            if dt is None:
                dt = e.self_cuda_time_total
            busy += dt
            if "split_" in e.key or "paged_attention_kernel" in e.key:
                attn += dt
        run = dict(host_ms=statistics.median(hosts),
                   wall_ms=statistics.median(walls),
                   device_busy_ms=busy / 3 / 1e3, attention_ms=attn / 3 / 1e3)
        print(f"decode step ({label}): host enqueue {run['host_ms']:.2f} ms, "
              f"wall {run['wall_ms']:.2f} ms, device busy "
              f"{run['device_busy_ms']:.2f} ms of which paged attention "
              f"{run['attention_ms']:.2f} ms (torch.profiler)")
        return run

    runs = {"this tree": []}
    if baseline is None:
        runs["this tree"].append(measure("this tree"))
        return runs
    ours = build.load("paged_attention")
    theirs = _baseline_library(torch, baseline, "paged_attention")
    runs[str(baseline)] = []
    try:
        for label, lib in (("this tree", ours), (str(baseline), theirs),
                           (str(baseline), theirs), ("this tree", ours)):
            build._LOADED["paged_attention"] = lib
            runs[label].append(measure(label))
    finally:
        build._LOADED["paged_attention"] = ours
    return runs


def device_ms_of(torch, fn):
    """(fn(), the device time between CUDA events recorded just before
    and just after it, in ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def compress_steps(kv, strategy, clock):
    """``pipeline._device_quantize`` of K and V, step by step, ``clock()``
    (ms, after a synchronize) read between the steps.  Returns ({step:
    ms}, the two payloads)."""
    import torch

    from repro_torch.core import codecs
    from repro_torch.core.pipeline import _lh_index
    from repro_torch.kernels import ops

    steps = dict(kernel=0.0, torch_ops=0.0, copies=0.0, host_codec=0.0,
                 kernel_device=0.0)
    payloads = []
    t = clock()
    for x, bits in ((kv.k, strategy.key_bits), (kv.v, strategy.value_bits)):
        L, H, S, D = x.shape
        (codes, scales), ms = device_ms_of(torch, lambda: ops.quant_pack_op(
            x.reshape(L * H * S, D), bits=bits, group=strategy.group_size))
        steps["kernel_device"] += ms
        t1 = clock()
        if bits == 4:
            u = torch.stack([codes & 0x0F, codes >> 4], dim=-1)
        else:
            u = (codes.to(torch.int16) + (1 << (bits - 1))).to(torch.uint8)
        s16 = scales.to(torch.float16)
        t2 = clock()
        u_host = u.reshape(L * H, S, D).cpu().numpy()
        s16.cpu().numpy()
        t3 = clock()
        payloads.append(codecs.encode_codes(u_host, bits, strategy.codec))
        _lh_index(L, H)
        t4 = clock()
        for k, dt in zip(steps, (t1 - t, t2 - t1, t3 - t2, t4 - t3)):
            steps[k] += dt
        t = t4
    return steps, payloads


def decompress_steps(comp, dev, clock):
    """``pipeline._device_dequantize`` of K and V, step by step, as
    :func:`compress_steps`.  Returns ({step: ms}, the two restored
    tensors)."""
    import torch

    from repro_torch.core import codecs
    from repro_torch.kernels import ops

    steps = dict(host_codec=0.0, copies=0.0, torch_ops=0.0, kernel=0.0,
                 kernel_device=0.0)
    outs = []
    t = clock()
    L, H, S, D = comp.shape
    for w in (comp.k_buckets[0], comp.v_buckets[0]):
        u_host = codecs.decode_codes(w.payload, w.bits, L * H * S * D,
                                     comp.strategy.codec)
        t1 = clock()
        u = torch.from_numpy(u_host).to(dev).reshape(-1, D)
        s = torch.from_numpy(w.scale.reshape(-1, D // w.group_size)).to(dev)
        t2 = clock()
        if w.bits == 4:
            codes = (u[:, 0::2] | (u[:, 1::2] << 4)).contiguous()
        else:
            codes = (u.to(torch.int16) - (1 << (w.bits - 1))).to(torch.int8)
        s = s.float()
        t3 = clock()
        out, ms = device_ms_of(torch, lambda: ops.dequant_unpack_op(
            codes, s, bits=w.bits, group=w.group_size,
            out_dtype=torch.float32))
        outs.append(out)
        steps["kernel_device"] += ms
        t4 = clock()
        for k, dt in zip(steps, (t1 - t, t2 - t1, t3 - t2, t4 - t3)):
            steps[k] += dt
        t = t4
    return steps, outs


def codec_breakdown(torch, dev, cfg, params, strategy):
    """Where one full-width cold request's compress and decompress stages
    spend their time (``strategy``: phase 3's static profile; one
    SEQ-token prefill's device KV, K and V): each stage's wall time as the
    runtime takes it (``workers.compress_kvs`` / ``decompress_kvs``,
    median of three); and the stage redone step by step as
    ``pipeline._device_quantize`` / ``_device_dequantize`` take it, with
    a synchronize after each step: the kernel, the offset, unpack and
    scale-cast torch ops, the copies between device and host, and the
    host codec, beside the time between CUDA events around the
    quant_pack or dequant_unpack launches (on the H100 machine
    torch.profiler recorded no device work in windows around the compress
    stage, three in a row; the kernels' own device time at this shape is
    phase 2's).
    The redone stage must give the stage's payload bytes and restored KV.
    Prints one line per stage; returns the numbers (ms)."""
    from repro_torch.core.quality import _prompts_for, extract_kv
    from repro_torch.models.transformer import prefill
    from repro_torch.serving.workers import compress_kvs, decompress_kvs

    tokens, _ = _prompts_for("qalike", 1, SEQ, 0)
    _, caches = prefill(cfg, params, {"tokens": torch.as_tensor(
        tokens, dtype=torch.int32, device=dev)}, SEQ)
    kv = extract_kv(cfg, caches, 0, SEQ)
    del caches
    walls = {"compress": [], "decompress": []}
    for _ in range(3):
        comps, _, tc = compress_kvs(strategy, [kv])
        restored, td = decompress_kvs(comps, device=dev)
        walls["compress"].append(tc * 1e3)
        walls["decompress"].append(td * 1e3)
    comp = comps[0]

    def clock():
        return _stage_clock(torch, dev) * 1e3

    runs_c, runs_d = [], []
    for _ in range(3):
        steps_c, payloads = compress_steps(kv, strategy, clock)
        check(payloads == [comp.k_buckets[0].payload,
                           comp.v_buckets[0].payload],
              "the compress stage redone step by step gives its bytes")
        steps_d, outs = decompress_steps(comp, dev, clock)
        check(torch.equal(outs[0].reshape(comp.shape), restored[0].k)
              and torch.equal(outs[1].reshape(comp.shape), restored[0].v),
              "the decompress stage redone step by step gives its KV")
        runs_c.append(steps_c)
        runs_d.append(steps_d)
    out = {}
    for stage, runs, kernel in (("compress", runs_c, "quant_pack"),
                                ("decompress", runs_d, "dequant_unpack")):
        steps = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        device = steps.pop("kernel_device")
        wall = statistics.median(walls[stage])
        out[stage] = dict(wall_ms=wall, runs_ms=walls[stage],
                          steps_ms=steps, kernel_device_ms=device)
        print(f"cold request {stage} stage ({ARCH}, one {SEQ}-token "
              f"prefill's K and V, {strategy.short_name()}): wall "
              f"{wall:.2f} ms (median of "
              + " / ".join(f"{x:.2f}" for x in walls[stage])
              + f"); {kernel}'s two launches {device:.4f} ms between "
              f"CUDA events around them (the host's enqueue of each "
              f"included); step by step, medians of three: "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in steps.items())
              + f", sum {sum(steps.values()):.2f} ms")
    return out


def baseline_codec_check(torch, dev, cfg, params, rt, baseline: Path):
    """Phase 3 served again with ``baseline``'s quant_pack and
    dequant_unpack libraries in place of this tree's: every request must
    get the same tokens and the same wire bytes as ``rt``."""
    from repro_torch.kernels import build

    names = ("quant_pack", "dequant_unpack")
    ours = {n: build.load(n) for n in names}
    try:
        for n in names:
            build._LOADED[n] = _baseline_library(torch, baseline, n)
        other, wall, _ = serve(torch, dev, cfg, params)
    finally:
        build._LOADED.update(ours)
    release_arenas(torch, other)

    def served(runtime):
        return {r.rid: (list(map(int, r.tokens)), r.wire_bytes)
                for r in runtime.completed}

    same = served(other) == served(rt)
    print(f"phase 3 with {baseline}'s quant_pack and dequant_unpack: "
          f"{len(other.completed)} requests in {wall:.2f} s wall, the same "
          f"tokens and wire bytes per request: {same}")
    check(same, "phase 3 tokens and wire bytes unchanged by this tree's "
          "quant_pack and dequant_unpack")


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
        _paged_caches, _prompts_for, extract_kv, init_paged_pools, inject_kv,
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
        paged = _paged_caches(pool, qc, qs, bt, ql)
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


def verify_reference_check(torch, strategy, cfg, params, dev):
    """One full-width W = 5 verify step of a served prompt on the card, from
    the wire-restored KV resident in the paged arena as bf16 pages and as
    int8 quant pages: through the verify kernel, and through its plain
    version (the same sums in the same order).  Returns (max |logit
    difference|, logit scale, plain top-2 gap at a differing argmax, every
    row's argmax agrees)."""
    import repro_torch.models.layers as layers
    from repro_torch.core.kvcache import PageTable
    from repro_torch.core.pipeline import CompressionPipeline
    from repro_torch.core.quality import (
        _paged_caches, _prompts_for, extract_kv, init_paged_pools,
        inject_kv_paged, inject_quant_pages)
    from repro_torch.kernels import ref
    from repro_torch.models.transformer import decode_step, prefill
    from repro_torch.serving.workers import quant_entry_arrays

    w = SPEC_K + 1
    seq, max_len = SEQ, SEQ + DECODE_TOKENS + 2 + SPEC_K
    tokens, _ = _prompts_for(SCENARIO[1][0], 1, seq, SCENARIO[1][2])
    logits, caches = prefill(cfg, params, {"tokens": torch.as_tensor(
        tokens, dtype=torch.int32, device=dev)}, max_len)
    first = int(logits[0, -1].argmax())
    # the last committed token, then four draft tokens from the prompt
    block = torch.tensor([[first] + [int(t) for t in tokens[0, -w + 1:]]],
                         dtype=torch.int32, device=dev)
    pos = torch.tensor([seq], dtype=torch.int32, device=dev)
    comp = CompressionPipeline(strategy).compress(
        extract_kv(cfg, caches, 0, seq))
    restored = CompressionPipeline(strategy, device=dev).decompress(comp)
    pps = -(-max_len // PAGE_SIZE)
    table = PageTable(pps + 1, PAGE_SIZE)
    table.ensure(0, seq + w)
    row = table.block_row(0, pps)
    bt = torch.as_tensor(row[None], device=dev)
    (kc, ks), (vc, vs) = quant_entry_arrays(comp)

    def verify_logits(quant_len):
        pool, qc, qs = init_paged_pools(cfg, pps + 1, PAGE_SIZE, 1,
                                        device=dev)
        if quant_len:
            qc, qs = inject_quant_pages(cfg, qc, qs, row, kc, ks, vc, vs,
                                        seq, PAGE_SIZE)
        else:
            pool = inject_kv_paged(cfg, pool, row, restored, PAGE_SIZE)
        ql = torch.tensor([quant_len], dtype=torch.int32, device=dev)
        paged = _paged_caches(pool, qc, qs, bt, ql)
        return decode_step(cfg, params, paged, block, pos)[0][0].float()

    err, scale, gap, same = 0.0, 0.0, 0.0, True
    for quant_len, where in ((0, "bf16 pages"), (seq, "int8 pages")):
        kernel = verify_logits(quant_len)
        kernel_op = layers.paged_verify_attention_arena_op
        layers.paged_verify_attention_arena_op = \
            ref.paged_verify_attention_arena_ref
        try:
            plain = verify_logits(quant_len)
        finally:
            layers.paged_verify_attention_arena_op = kernel_op
        top = torch.topk(plain, 2, dim=-1).values          # (W, 2)
        e = float((kernel - plain).abs().max())
        err, scale = max(err, e), max(scale, float(plain.abs().max()))
        agree = kernel.argmax(-1) == plain.argmax(-1)
        if not bool(agree.all()):
            gap = max(gap, float((top[:, 0] - top[:, 1])[~agree].max()))
        same = same and bool(agree.all())
        print(f"reference check, one full-width W={w} verify step from "
              f"{where}: kernel vs plain max|logit diff| {e:.4g} (logit "
              f"scale {float(plain.abs().max()):.4g}), argmax per row "
              f"{kernel.argmax(-1).tolist()} vs {plain.argmax(-1).tolist()}")
    return err, scale, gap, same


# ---------------------------------------------------------------------------
# Phase 5: offline profiling, the controller and the one-shot PD engine
# ---------------------------------------------------------------------------
P5_SEQ, P5_PROMPTS, P5_DECODE = 192, 4, 8     # profiling's quality runs
P5_BATCH, P5_SERVE_DECODE, P5_ITERS = 4, 20, 4


def _stage_clock(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def hadamard_int8():
    """The device-quantizable Hadamard profile: rotation, then int8
    per-token symmetric group-64 quantization, no entropy codec."""
    from repro_torch.core.strategy import StrategyConfig

    return StrategyConfig(transform="hadamard", quantizer="uniform",
                          key_bits=8, value_bits=8, granularity="per_token",
                          symmetric=True, group_size=GROUP)


def wire_check(torch, dev, cfg, params, host_exact, strategies):
    """One full-width prefill's KV through the pipeline's device stages
    and through its host stages, for each strategy: equal total bytes;
    payload bytes equal when the card's rotation equals numpy's bit for
    bit (else codes differing at <= 1e-4 of positions); restored KV
    within 1e-5 of each row's scale."""
    import numpy as np
    from repro_torch.core.codecs import decode_codes
    from repro_torch.core.pipeline import CompressionPipeline
    from repro_torch.core.quality import _prompts_for, extract_kv
    from repro_torch.models.transformer import prefill

    tokens, _ = _prompts_for("qalike", 1, SEQ, 0)
    _, caches = prefill(cfg, params, {"tokens": torch.as_tensor(
        tokens, dtype=torch.int32, device=dev)}, SEQ)
    kv = extract_kv(cfg, caches, 0, SEQ)
    del caches
    host_kv = kv.to_host()
    for name, strategy in strategies:
        on_card = CompressionPipeline(strategy, device=dev)
        on_host = CompressionPipeline(strategy)
        t0 = _stage_clock(torch, dev)
        comp_d = on_card.compress(kv)
        t1 = _stage_clock(torch, dev)
        rest_d = on_card.decompress(comp_d)
        t2 = _stage_clock(torch, dev)
        comp_h = on_host.compress(host_kv)
        t3 = time.perf_counter()
        rest_h = on_host.decompress(comp_h)
        t4 = time.perf_counter()
        check(comp_d.total_bytes() == comp_h.total_bytes(),
              f"{name}: total bytes")
        n = n_diff = 0
        same = True
        for a, b in zip(comp_d.k_buckets + comp_d.v_buckets,
                        comp_h.k_buckets + comp_h.v_buckets):
            same = same and a.payload == b.payload \
                and np.array_equal(a.scale, b.scale)
            count = int(np.prod(b.codes_shape))
            ca = decode_codes(a.payload, a.bits, count, strategy.codec)
            cb = decode_codes(b.payload, b.bits, count, strategy.codec)
            n += count
            n_diff += int((ca != cb).sum())
        rel = 0.0
        for got, want in ((rest_d.k, rest_h.k), (rest_d.v, rest_h.v)):
            g = got.cpu().numpy()
            row = np.abs(want).max(axis=-1, keepdims=True)
            rel = max(rel, float((np.abs(g - want)
                                  / np.maximum(row, 1e-30)).max()))
        print(f"wire check {name} (one {SEQ}-token prefill, {kv.nbytes_wire()}"
              f" source bytes): {comp_d.total_bytes()} bytes on the card "
              f"and on the host, payload bytes equal: {same}, codes "
              f"differing: {n_diff} of {n}; restored max|diff| / row scale "
              f"{rel:.3g} (tolerance 1e-5); compress {(t1 - t0) * 1e3:.2f} ms"
              f" on the card, {(t3 - t2) * 1e3:.2f} ms on the host; "
              f"decompress {(t2 - t1) * 1e3:.2f} / {(t4 - t3) * 1e3:.2f} ms")
        check(same if host_exact else n_diff <= 1e-4 * n,
              f"{name}: payload bytes")
        check(rel <= 1e-5, f"{name}: restored KV")


def print_batch(label, r) -> None:
    print(f"  {label}: profile {r.profile} kv_bytes={r.kv_bytes} "
          f"wire_bytes={r.wire_bytes} prefill={r.t_prefill * 1e3:.2f}ms "
          f"compress={r.t_compress * 1e3:.2f}ms comm={r.t_comm * 1e3:.2f}ms "
          f"decompress={r.t_decompress * 1e3:.2f}ms "
          f"decode={r.t_decode * 1e3:.2f}ms jct={r.jct * 1e3:.2f}ms "
          f"agreement={r.agreement:.3f}")


def profiling_phase(torch, dev, cfg, params):
    """Calibrate head scores, measure the baselines and a Hadamard + int8
    per-token profile on the model's own device KV, run a short BO search,
    then serve one-shot PD batches through the controller over those
    profiles at 1 and 100 Gb/s and one with the static mixhq profile.  The
    launch counts are set to 0 just before and read just after.  Returns
    the counts."""
    from repro_torch.controller import ServiceAwareController
    from repro_torch.core.quality import (
        _prompts_for, calibrate_head_scores, extract_kv)
    from repro_torch.core.strategy import BASELINES
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.profile_offline import (
        build_profiles, search_and_build)
    from repro_torch.models.transformer import prefill
    from repro_torch.serving.engine import DisaggregatedEngine
    from repro_torch.serving.network import GBPS, BandwidthTrace

    ref = (cfg, params)
    qk = dict(n_prompts=P5_PROMPTS, seq=P5_SEQ, decode_tokens=P5_DECODE)
    _stage_clock(torch, dev)
    reset_launches()
    t0 = time.perf_counter()
    hs = calibrate_head_scores(n_prompts=P5_PROMPTS, seq=P5_SEQ, ref=ref)
    check(hs.shape == (cfg.num_layers, cfg.kv_heads)
          and bool((hs > 0).all()), "head scores")
    tokens, _ = _prompts_for("qalike", 1, P5_SEQ, 1)
    _, caches = prefill(cfg, params, {"tokens": torch.as_tensor(
        tokens, dtype=torch.int32, device=dev)}, P5_SEQ)
    samples = [extract_kv(cfg, caches, 0, P5_SEQ)]
    del caches
    strategies = list(BASELINES.values()) + [hadamard_int8()]
    profiles = build_profiles(strategies, workloads=("qalike",),
                              kv_samples=samples, quality_kwargs=qk,
                              head_scores=hs, ref=ref)
    t1 = time.perf_counter()
    found, frontier = search_and_build(
        workload="qalike", max_iters=P5_ITERS, ref=ref, kv_samples=samples,
        quality_kwargs=qk)
    t2 = time.perf_counter()
    print(f"profiles (KV samples: one {P5_SEQ}-token prefill; quality: "
          f"qalike, {P5_PROMPTS} prompts of {P5_SEQ} tokens, {P5_DECODE} "
          f"teacher-forced tokens), measured in {t1 - t0:.2f} s:")
    for p in profiles + found[1:]:
        print(f"  {p.strategy.short_name():34s} cr={p.cr:.4f} "
              f"s_enc={p.s_enc / 1e9:.4f} GB/s s_dec={p.s_dec / 1e9:.4f} "
              f"GB/s quality={p.quality} mse={p.mse:.4g}")
        check(p.cr > 0 and p.s_enc > 0 and p.s_dec > 0
              and all(0.0 <= q <= 1.0 for q in p.quality.values()),
              f"profile {p.strategy.short_name()}")
    print(f"BO search, max_iters={P5_ITERS}, in {t2 - t1:.2f} s: "
          f"{len(found) - 1} feasible at acc >= 0.97; frontier: "
          + ", ".join(f"{pt.profile.strategy.short_name()} (acc "
                      f"{pt.acc:.3f}, cr {pt.cr:.3f})" for pt in frontier))

    controller = ServiceAwareController(
        {w: profiles + found[1:] for w in WORKLOADS})
    mixhq = next(p for p in profiles if p.strategy == BASELINES["mixhq"])

    def engine(**kw):
        # one engine per link: an engine's goodput estimator carries its
        # link's history from batch to batch
        return DisaggregatedEngine(ref=ref, device=dev, seq=P5_SEQ,
                                   decode_tokens=P5_SERVE_DECODE,
                                   batch=P5_BATCH, **kw)

    # q_min 0: on random weights every lossy profile's agreement is far
    # below a real budget, so the controller chooses on latency alone
    print(f"one-shot PD serving, batch {P5_BATCH} x {P5_SEQ} tokens, "
          f"{P5_SERVE_DECODE} decode tokens, q_min 0:")
    served = [("controller, 1 Gb/s", engine(controller=controller), 1.0),
              ("controller, 100 Gb/s", engine(controller=controller), 100.0),
              ("static mixhq, 1 Gb/s", engine(static_profile=mixhq), 1.0)]
    for i, (label, eng, gbps) in enumerate(served):
        r = eng.serve("qalike", BandwidthTrace.constant(gbps * GBPS),
                      q_min=0.0, seed=i)
        print_batch(label, r)
        check(r.tokens.shape == (P5_BATCH, P5_SERVE_DECODE + 1)
              and bool(((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()),
              f"{label}: tokens")
        check(r.kv_bytes == P5_BATCH * samples[0].nbytes_wire()
              and 0 < r.wire_bytes, f"{label}: bytes")
        check(abs(r.t_prefill + r.t_compress + r.t_comm + r.t_decompress
                  + r.t_decode - r.jct) < 1e-9, f"{label}: JCT parts")
    wall = _stage_clock(torch, dev) - t0
    counts = launches()
    print(f"phase 5: {wall:.2f} s wall; launches "
          f"{counts}")
    for k in ("hadamard_op", "quant_pack_op", "dequant_unpack_op"):
        check(counts[k] > 0, f"{k} launched on the profiling path")
    return counts


def main(argv) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="a checkout of another commit whose arena attention, "
                         "decode_attention, hadamard, quant_pack and "
                         "dequant_unpack kernels are timed beside this "
                         "tree's, in turns")
    ap.add_argument("--attention-times", type=Path, default=None,
                    help=argparse.SUPPRESS)   # one turn of --baseline
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if args.attention_times is not None:
        sys.path.insert(0, str(args.attention_times))
        from repro_torch.kernels import ops
        print(json.dumps(main_times(torch, dev, ops)))
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.kernels import build

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

    quant_pack_sass()

    # ---- 2. kernels ----
    results = kernel_phase(torch, dev)
    results.update(quant_kernel_phase(torch, dev))
    results["paged_verify_attention"] = verify_kernel_phase(torch, dev)
    results["hadamard"], host_exact = hadamard_kernel_phase(torch, dev)
    results["decode_attention"], decode_launches = \
        decode_attention_kernel_phase(torch, dev)
    print(f"launches on the decode_attention path (phase 2's cases): "
          f"{decode_launches}")
    check(decode_launches > 0, "decode_attention launched")
    repaired_shapes_phase(torch, dev)
    split_edges_phase(torch, dev)
    phase_times = attention_phase_times(torch, dev)
    results["paged_attention"]["phase_times"] = phase_times["W=1"]
    results["paged_verify_attention"]["phase_times"] = {
        w: t for w, t in phase_times.items() if w != "W=1"}
    torch.cuda.synchronize()
    for k, r in results.items():
        print(f"{k}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}, library "
              f"{r['library_ms']})")
    for wk, r in results["paged_verify_attention"]["widths"].items():
        print(f"paged_verify_attention_arena {wk}: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}, SDPA {r['library_ms']:.4f} ms)")

    if args.baseline is not None:
        compare_with(torch, args.baseline.resolve())

    # ---- 3. runtime ----
    cfg, params = model_setup(torch, dev)
    rt, wall, counts = serve(torch, dev, cfg, params)
    print_requests(rt, wall)
    check_runtime(rt, cfg)
    launches = {"quant_pack": counts["quant_pack_op"],
                "dequant_unpack": counts["dequant_unpack_op"],
                "paged_attention": counts["paged_attention_arena_op"]}
    print(f"launches on the main path: {launches} "
          f"(Pallas-interface entry: {counts['paged_attention_op']})")
    for k, n in launches.items():
        check(n > 0, f"{k} launched on the main path")
    err, scale, gap, same = reference_check(torch, rt, cfg, params, dev)
    decode_step_times(torch, dev, cfg, params,
                      None if args.baseline is None
                      else args.baseline.resolve())
    tol = 2e-2 + 1.6e-2 * scale
    check(err <= tol and (same or gap <= tol),
          "full-width decode through the kernel agrees with the plain path")
    strategy = rt.static_profile.strategy
    release_arenas(torch, rt)
    codec_breakdown(torch, dev, cfg, params, strategy)
    if args.baseline is not None:
        baseline_codec_check(torch, dev, cfg, params, rt,
                             args.baseline.resolve())

    # ---- 4. speculative runtime ----
    for kind in ("ngram", "model"):
        spec, spec_wall, spec_counts = serve(torch, dev, cfg, params,
                                             spec_k=SPEC_K, spec_kind=kind)
        print(f"speculative runtime ({kind} drafts, spec_k={SPEC_K}): "
              f"{len(spec.completed)} requests in {spec_wall:.2f} s wall "
              f"(plain {wall:.2f} s), {spec.steps} iterations (plain "
              f"{rt.steps})")
        print_speculation(rt, spec)
        check_runtime(spec, cfg)
        if kind == "ngram":
            release_arenas(torch, spec)
    done = spec.completed
    check(sum(r.verify_steps for r in done) > 0, "verify steps taken")
    check(sum(r.drafts_offered for r in done) > 0, "drafts offered")
    launches["paged_verify_attention"] = \
        spec_counts["paged_verify_attention_arena_op"]
    print(f"launches on the speculative path: {spec_counts}")
    check(launches["paged_verify_attention"] > 0,
          "paged_verify_attention launched on the speculative path")
    release_arenas(torch, spec)
    err, scale, gap, same = verify_reference_check(torch, strategy, cfg,
                                                   params, dev)
    tol = 2e-2 + 1.6e-2 * scale
    check(err <= tol and (same or gap <= tol),
          "full-width verify step through the kernel agrees with the plain "
          "path")

    # ---- 5. offline profiling, controller, one-shot PD engine ----
    from repro_torch.core.strategy import BASELINES
    t5 = time.perf_counter()
    wire_check(torch, dev, cfg, params, host_exact,
               [("hadamard-int8", hadamard_int8()),
                ("mixhq", BASELINES["mixhq"])])
    counts = profiling_phase(torch, dev, cfg, params)
    launches["hadamard"] = counts["hadamard_op"]
    print(f"phase 5 with the wire check: {time.perf_counter() - t5:.2f} s "
          f"wall")
    from repro_torch.kernels import ops
    results["hadamard"].update(clock_under_load(
        torch, hadamard_main_calls(torch, dev, ops)[0]["hadamard f32"]))
    print(f"hadamard at the main shape, back to back: SM clock "
          f"{results['hadamard']['sm_clock_mhz']:g} MHz at "
          f"{results['hadamard']['power_w']:g} W")

    meta = {
        "quant_pack": ("src/repro_torch/kernels/csrc/quant_pack.cu",
                       "src/repro/kernels/quant_pack.py:76"),
        "dequant_unpack": ("src/repro_torch/kernels/csrc/dequant_unpack.cu",
                           "src/repro/kernels/quant_pack.py:112"),
        "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:150"),
        "paged_verify_attention": (
            "src/repro_torch/kernels/csrc/paged_verify_attention.cu",
            "src/repro/kernels/paged_verify_attention.py:149"),
        "hadamard": ("src/repro_torch/kernels/csrc/hadamard.cu",
                     "src/repro/kernels/hadamard.py:37"),
        "decode_attention": (
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:137"),
    }
    launches["decode_attention"] = decode_launches
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
    sys.exit(main(sys.argv[1:]))
