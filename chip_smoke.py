#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline DIR]

Ten phases, in order; any failure exits non-zero and no phase's error
is caught:

1. Build: compile every Hopper kernel of ``src/repro_torch/kernels/csrc``
   with nvcc (one process per source, in parallel) into ``build/kernels``.
2. Kernels: on the card, hold each kernel against its plain PyTorch
   version at the main path's shapes (the arena entry also at phase 6's
   four slots per decode worker; plus int4, ragged-T, staircase and
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
   chunk), each case launched twice and bit-equal; both arena entries
   (W = 1 and 5) at deepseek-moe-16b's shape (Hkv 16, Gq 1) and
   llama4-scout's (Hkv 8, Gq 5), equal to the plain version bit for bit
   in two launches; both arena entries with gemma-2's softcap and sliding
   window (cap 50, window 4096) at gemma2-9b's shape (Hkv 8, Gq 2, D
   256) with kv_lens on both sides of the window, and at the window's and
   the cap's edges (windows 1, 2, 16, 17, 40 and past the length, bounds
   mid-chunk and on chunk edges, chunks and stages wholly below, verify
   tokens that see nothing, kv_len 0, a cap with no window), each
   launched twice and bit-equal; the arena entry also with never-used
   slots (kv_len 0: m = -inf, l = 0, out = 0 in the kernel and its plain
   version); and each arena entry's two CUDA kernels (phase A, phase B)
   are timed by torch.profiler, at gemma2's shape windowed and not.
   ``paged_mla_attention`` (deepseek-v2-lite's absorbed decode read) at
   the MLA cell's shape: 16 slots of up to 8,336 positions, one parked,
   against its plain version, launched twice and bit-equal, timed beside
   its bound and by its two CUDA kernels' device time.
   With ``--baseline DIR`` (a checkout of another commit, e.g. the
   parent's ``git archive``), the arena attention entries (also by
   device time, and their outputs held bit-equal to DIR's),
   decode_attention, hadamard, quant_pack and dequant_unpack of DIR and
   of this tree are timed at the main shapes in turns.
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
4b. Sync census: two 1,024-token requests of 8 decode tokens served as
   phase 3 serves them, then the same with n-gram drafts (``spec_k=4``;
   random weights give it no drafts, so the two-model draft runs too),
   under ``torch.cuda.set_sync_debug_mode("warn")`` (reset to 0 in a
   ``finally``): every sync PyTorch sees is charged to its innermost
   frame under ``src/repro_torch``, and the syncs per decode iteration,
   per verify iteration and per cold request (prefill, compress, land)
   are printed by ``file:line``.  Gate: every site seen is a
   ``host-sync`` finding of ``repro_torch.analysis`` on this tree, open
   or suppressed.
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
6. Trace-driven KV-disaggregated serving: 16 events of a
   ``repro_torch.workloads`` trace from ``default_tenants()`` replayed
   (``replay_runtime``) twice through a 2x2 ``ClusterRuntime`` in pool mode
   (load-aware router, paged arena, 4 slots per decode worker, phase 3's
   static profile, worker-local HBM and DRAM tiers over one shared remote
   tier at 100 Gb/s) with the port's KV sanitizer installed: every
   request completes, breakdowns sum to JCT, both page tables drain,
   hits land in a worker-local and in the shared tier, and
   ``paged_attention`` and ``quant_pack`` launch.  The same trace then
   runs through the port's ``Simulator`` with this run's measured
   speeds and on-wire bytes, and the per-request gap is printed.
7. Training, checkpoints and the cross-pod paths: (a) train the
   ``tiny-lm`` reference model on the card (``train_reference_model``,
   400 steps of 16 x 256 from the port's seed-0 init; loss every 50
   steps and ms per step), hold its eval loss on a held-out batch
   against the JAX package's trainer run from the same init (measured
   on the CPU) and its masters and moments to f32, save its parameters
   and AdamW state with ``CheckpointManager`` and restore them onto the
   card bit for bit, and print ``evaluate_quality`` of the Hadamard +
   int8 profile and mixhq on it; (b) five steps of ``llama3.1-8b`` at
   full width, depth cut to 4 layers, batch 4 x 1024, remat, 8-bit
   gradient compression with error feedback: loss, ms per step,
   tokens/s, peak memory and share of the bf16 dense peak per step,
   ``quant_pack`` and ``dequant_unpack`` once per leaf per step, the
   first step's compressed gradients equal to the plain round trip bit
   for bit; (c) two processes on the card in a gloo group:
   ``make_kv_transfer`` of one 1024-token request's full-width KV at
   bits 16, 8 and 4 (the neighbour's cache, or its plain
   quantize-dequantize, bit for bit; bytes sent equal to
   ``transfer_wire_bytes``; ms per transfer) and
   ``make_cross_pod_grad_sync`` of one layer's gradients (equal to the
   plain ring bit for bit).
8. The other model families (phases 3 and 7 freed first): (a) phase 3's
   serving run with ``deepseek-moe-16b`` at full width and depth (28
   layers, 64 routed experts top-6 plus 2 shared, a dense first layer):
   every request completes, breakdowns sum to JCT, page tables drain,
   ``paged_attention`` (Gq 1, 16 KV heads), ``quant_pack`` and
   ``dequant_unpack`` launch; one full-width decode step through the
   kernel against the plain path (phase 3's gate), one step's host
   enqueue, wall and device busy time, cold TTFT and its stages, the
   share of (token, expert) assignments a 1024-token prefill drops at
   capacity_factor 1.25, and the peak memory; (b) each of the other nine
   assigned architectures at full width (depth cut where one card or the
   phase's time requires: ``FAMILY_DEPTH``), one at a time: a prefill of
   256 positions from ``make_inputs`` (whisper's frames, qwen2-vl's
   vision prefix) and a teacher-forced decode step held against the
   full forward's logits (atol 0.15, rtol 0.05 in units of the logits'
   RMS, equal argmax; MoE at capacity_factor 16), with ms per prefill and
   per decode step; (c) ``gemma2-9b`` at full width and depth (42
   layers, a 4,096-position window on every other one, attention cap 50,
   final cap 30), served as phase 3 serves, first with phase 3's
   1,024-token scenario, then with three 5,120-token prompts on three
   slots (the runtime takes one prompt length a RuntimeConfig), so that
   the arena entry cuts the local layers' window: every request
   completes, breakdowns sum to JCT, page tables drain, the three
   kernels launch, the arena entry with the cap on every layer and the
   window on the local ones; one decode step at 5,120 positions through
   the kernel against the plain path (phase 3's gate; the dense gathered
   view printed beside it), one step's times and top kernels, cold TTFT
   stages, peak memory; then a two-layer cut at full width served with
   the two-model draft (``spec_k=4``), which must launch the verify entry
   with the cap and the window; (d) ``deepseek-v2-lite`` at full width
   and depth (27 layers of multi-head latent attention), served as phase
   3 serves: every request completes, page tables drain, pool hits land
   as bf16 latent pages, ``paged_mla_attention`` launches (and the MHA
   arena entry does not), one decode step through it against the plain
   path (phase 3's gate), peak memory.

9. The multi-card path: (a) ``python -m repro_torch.launch.dryrun`` in
   processes of their own (the fake 512-rank group), started after (b)
   and running beside (c) and phase 10: llama3.1-8b's train_4k,
   prefill_32k and decode_32k, tiny-lm's train_4k and decode_32k,
   falcon-mamba-7b's train_4k and decode_32k, jamba-v0.1-52b's train_4k
   and deepseek-moe-16b's train_4k and prefill_32k on the 16x16 and
   2x16x16 meshes, every cell ``[ok]`` with its H100 terms, dominant
   term, useful ratio (in (0, 1], for the attention-free falcon-mamba up
   to N / (N - its embedding tables)) and memory a device printed, and
   llama3.1-8b's decode_32k on 16x16 moving collective bytes; and with
   ``--include-transfer`` llama3.1-8b's decode_32k on 2x16x16 with its
   compressed cross-pod KV migration (4-bit), whose collective bytes, all
   over "pod", equal its quantized cache shards' ``transfer_wire_bytes``;
   (b) llama3.1-8b at full width and
   depth in bf16, a decode step at B 8 over a 4,096-position dense cache
   and a prefill of B 1 x 4,096, and phase 7b's 4-layer train step, each
   timed on the card (CUDA events) beside the report of the same step on
   a 1x1 mesh, and held to no less than 0.95 x t_compute and 0.95 x its
   parameters' bytes over HBM bandwidth; (c) phase 7a's trained model
   restored in a process of its own on a one-rank NCCL group as DTensors
   on a 1x1 ("data", "model") mesh by the port's sharding rules, bit-equal
   to the saved arrays, its eval loss equal to phase 7a's bit for bit.

10. The six ``examples/torch_*.py`` scripts in this process on the card
   at their JAX counterparts' sizes (offline profiling at
   ``OFFLINE_ITERS`` BO iterations), the three that serve or profile the
   reference model on phase 7a's trained tiny-lm, train_small with its
   8-bit gradient compression on: each prints its table, its seconds and
   its kernel launches; torch_quickstart must launch hadamard, and
   torch_train_small quant_pack and dequant_unpack.

Prints per-request TTFT/JCT/wire bytes/breakdowns, the speculative run's
verify steps, committed tokens and accept rates beside the plain run's
TTFT and JCT, phase 5's profiles and per-batch breakdowns, phase 6's
per-request route, tier, TTFT, JCT and breakdown, its stores' tiers and
the simulator's gap, phase 7's training and transfer numbers, phase 8's
serving run and per-family checks, phase 9's report rows beside the
card's times and the restore, phase 10's tables, seconds and launches,
one JSON line of kernel results (with each kernel's launches in phases
6, 7, 8a, 8c, 8d and 10; ``paged_mla_attention``'s main path is 8d's),
the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Exits
with an error, printing no result, when there is no CUDA device or the
port's sources are missing.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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


def rel_err(torch, a, b) -> float:
    """max |a - b| / |b| over the elements, equal ones (also two -inf,
    an empty row's m) counting 0."""
    return float(torch.where(a == b, torch.zeros_like(a),
                             (a - b).abs() / b.abs().clamp_min(1e-30)).max())


def bf16_ulps(torch, a, b) -> int:
    def ordered(x):
        i = x.float().view(torch.int32) >> 16
        return torch.where(i < 0, -(i & 0x7FFF), i).long()
    return int((ordered(a) - ordered(b)).abs().max())


PROFILE_WINDOWS = 5


def profile_window(torch, fn, iters: int, seen):
    """``key_averages()`` of torch.profiler over ``iters`` back-to-back
    calls of ``fn``.  The profiler on the H100 machine has delivered
    fewer than half of a kernel's launches, or none, for some windows, so
    a window for which ``seen`` (given the events) is false is taken
    again, up to PROFILE_WINDOWS windows in all, each retake printed;
    none seen fails the phase."""
    from torch.profiler import ProfilerActivity, profile

    for window in range(1, PROFILE_WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        if seen(events):
            return events
        print(f"torch.profiler window {window} of {PROFILE_WINDOWS} held "
              f"none of the call's CUDA kernels")
    check(False, "torch.profiler saw the call's CUDA kernels")


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

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        fn()
    host_ms = (time.perf_counter() - t0) / 100 * 1e3
    torch.cuda.synchronize()

    def on_device(e):
        return getattr(e, "device_type", None) == DeviceType.CUDA and e.count

    def seen(events):    # every kernel in at least half of the calls
        kernels = [e for e in events if on_device(e)]
        return kernels and all(round(e.count / iters) for e in kernels)

    by_kernel, count = {}, 0
    for e in profile_window(torch, fn, iters, seen):
        if not on_device(e):
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
def arena_case(torch, dev, gen, pps, lens, qlens, released=()):
    """The arena entry's inputs for len(lens) slots of pps pages each over
    a pool of len(lens) * pps + 1 pages (page 0 the scratch page): random
    bf16 fp pools, int8 codes with per-channel f32 scales (group-GROUP
    values, as ``init_paged_pools`` broadcasts them), a permuted block
    table whose ``released`` rows map only the scratch page, bf16
    queries."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    hkv, d = cfg.kv_heads, cfg.resolved_head_dim
    gq = cfg.num_heads // cfg.kv_heads
    b = len(lens)
    n_pages = b * pps + 1
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
    bt = perm.reshape(b, pps).to(torch.int32)
    if released:
        bt[list(released)] = 0
    q = torch.randn(b, hkv, gq, d, generator=gen, device=dev).to(
        torch.bfloat16)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    return q, kp, vp, kc, ks, vc, vs, bt, i32(lens), i32(qlens)


def hold_arena(torch, ops, ref, args):
    """paged_attention_arena_op against its plain version on ``args``:
    out within 2 bf16 ulps, m and l within 1e-5 relative (an empty row's
    m = -inf, l = 0, out = 0 in both).  Returns the kernel's m and out's
    max |err|."""
    q, kp, *_, lens, qlens = args
    out, m, l = ops.paged_attention_arena_op(*args)
    r_out, r_m, r_l = ref.paged_attention_arena_ref(*args)
    ulps = bf16_ulps(torch, out, r_out)
    m_rel, l_rel = rel_err(torch, m, r_m), rel_err(torch, l, r_l)
    err = float((out.float() - r_out.float()).abs().max())
    b, hkv, gq, d = q.shape
    print(f"paged_attention_arena B={b} Hkv={hkv} Gq={gq} D={d} "
          f"pages={kp.shape[0]}x{PAGE_SIZE} kv_lens={lens.tolist()} "
          f"quant_lens={qlens.tolist()}: out {ulps} bf16 ulps (max|err| "
          f"{err:.3g}; tolerance 2 ulps), m rel {m_rel:.3g}, l rel "
          f"{l_rel:.3g} (tolerance 1e-5)")
    check(ulps <= 2 and m_rel <= 1e-5 and l_rel <= 1e-5,
          f"paged_attention_arena vs plain at B={b}")
    return m, err


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
    view = pps * PAGE_SIZE
    # live slots 6..26 tokens into decode, a fresh prefill, a parked row
    args = arena_case(torch, dev, gen, pps,
                      lens=[SEQ + 16, SEQ + 6, SEQ, view - 1, SEQ + 26, SEQ],
                      qlens=[SEQ, 0, SEQ, 0, 0, SEQ])
    q, kp, vp, kc, ks, vc, vs, bt, lens, qlens = args
    n_pages = kp.shape[0]
    m, err = hold_arena(torch, ops, ref, args)
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

    # ---- the arena entry at phase 6's shape: CLUSTER_SLOTS slots over a
    # decode worker's own pool; a hit 19 tokens into decode, a cold slot 4
    # in, a hit at its first step, and a released slot (stale length, its
    # block-table row on the scratch page); then with two never-used
    # slots, which the decode step also passes (kv_len 0: m = -inf, l = 0,
    # out = 0 in the kernel and its plain version alike)
    pps6 = -(-(SEQ + CLUSTER_DECODE_TOKENS + 2) // PAGE_SIZE)
    gen6 = torch.Generator(device=dev).manual_seed(6)
    hold_arena(torch, ops, ref, arena_case(
        torch, dev, gen6, pps6,
        lens=[SEQ + 19, SEQ + 4, SEQ, SEQ + CLUSTER_DECODE_TOKENS],
        qlens=[SEQ, 0, SEQ, 0], released=(3,)))
    m6, _ = hold_arena(torch, ops, ref, arena_case(
        torch, dev, gen6, pps6, lens=[SEQ + 19, 0, SEQ, 0],
        qlens=[SEQ, 0, SEQ, 0], released=(3,)))
    check(bool(torch.isneginf(m6[1]).all() and torch.isneginf(m6[3]).all()),
          "kv_len 0 rows give m = -inf")

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
# Phase 2, continued: multi-head latent attention's decode read
# ---------------------------------------------------------------------------
# The MLA cell's decode step (kvbench's dsv2lite.pd_cold8k.2gbps):
# deepseek-v2-lite's 16 heads over one latent (512) and rope key (64) a
# position, 16 slots of 521 pages of 16 (8,336 positions: an 8,192-token
# prompt and up to 128 output tokens).
MLA_ARCH, MLA_SLOTS, MLA_PPS = "deepseek-v2-lite", 16, 521


def mla_case(torch, dev, gen):
    """paged_mla_attention_op's inputs at the MLA cell's shape: random
    bf16 latent and rope pools over MLA_SLOTS * MLA_PPS + 1 pages (page 0
    the scratch page), a permuted block table, kv_lens from the whole
    view down to 1,024, the last row parked (a stale length, its table
    all the scratch page), bf16 absorbed and rope queries and the
    configuration's softmax scale."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import mla_softmax_scale

    cfg = get_config(MLA_ARCH)
    h, r, pr = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    b, n_pages = MLA_SLOTS, MLA_SLOTS * MLA_PPS + 1
    bf16 = torch.bfloat16
    lat = torch.randn((n_pages, PAGE_SIZE, 1, r), generator=gen,
                      device=dev).to(bf16)
    rope = (torch.randn((n_pages, PAGE_SIZE, 1, pr), generator=gen,
                        device=dev) * 2).to(bf16)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    bt = perm.reshape(b, MLA_PPS).to(torch.int32)
    bt[-1] = 0
    lens = torch.linspace(MLA_PPS * PAGE_SIZE, 1024, b,
                          device=dev).round().to(torch.int32)
    q_abs = (torch.randn((b, h, r), generator=gen, device=dev)
             * 0.05).to(bf16)
    q_pe = (torch.randn((b, h, pr), generator=gen, device=dev)
            * 0.05).to(bf16)
    return q_abs, q_pe, lat, rope, bt, lens, mla_softmax_scale(cfg)


def mla_close(torch, got, want):
    """(out's bf16 ulps where it differs from ``want``'s by more than 1e-4
    of the largest l, m relative error, l relative error) of two
    ``(out, m, l)`` of paged_mla_attention, and whether they are within
    the card tests' tolerances (2 ulps, 1e-5, 1e-4)."""
    (out, m, l), (r_out, r_m, r_l) = got, want
    ulps, _ = bf16_close(torch, out, r_out, atol=1e-4 * float(r_l.max()))
    m_rel, l_rel = rel_err(torch, m, r_m), rel_err(torch, l, r_l)
    return ulps, m_rel, l_rel, ulps <= 2 and m_rel <= 1e-5 and l_rel <= 1e-4


def mla_kernel_phase(torch, dev):
    """paged_mla_attention_op at the MLA cell's shape (``mla_case``)
    against its plain version at the card tests' tolerances: m within
    1e-5 relative, l within 1e-4, out within 2 bf16 ulps where it differs
    by more than 1e-4 of the largest l; the parked row m = -inf, l = 0,
    out = 0; two launches bit-equal.  Times the op, its plain version and
    its two CUDA kernels' device time, beside the bound of the bytes and
    f32 operations this data needs.  Returns the kernel's results
    entry."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(30)
    args = mla_case(torch, dev, gen)
    q_abs, q_pe, lat, rope, bt, lens, _ = args
    out, m, l = ops.paged_mla_attention_op(*args)
    r_out = ref.paged_mla_attention_ref(*args)[0]
    again = ops.paged_mla_attention_op(*args)
    same = all(torch.equal(x, y) for x, y in zip((out, m, l), again))
    ulps, m_rel, l_rel, held = mla_close(
        torch, (out, m, l), ref.paged_mla_attention_ref(*args))
    parked = bool(torch.all(m[-1] == float("-inf")) and torch.all(l[-1] == 0)
                  and torch.all(out[-1] == 0))
    b, h, r = q_abs.shape
    pr = q_pe.shape[-1]
    print(f"paged_mla_attention B={b} H={h} R={r} P={pr} pages="
          f"{lat.shape[0]}x{PAGE_SIZE} kv_lens={lens.tolist()} (row {b - 1} "
          f"parked): out {ulps} bf16 ulps (tolerance 2), m rel {m_rel:.3g} "
          f"(1e-5), l rel {l_rel:.3g} (1e-4), parked row empty: {parked}, "
          f"two launches bit-equal: {same}")
    check(held and parked and same,
          "paged_mla_attention vs plain at the MLA cell's shape")
    # what this data needs: each seen position's latent and rope key once
    # (the parked row sees none), the queries, out, m, l and the tables;
    # per seen position and head, scores over R + P and values over R
    seen = int(lens[:-1].long().sum())
    nbytes = (seen * (r + pr) * 2 + (q_abs.numel() + q_pe.numel()) * 2
              + out.numel() * 2 + (m.numel() + l.numel()) * 4
              + bt.numel() * 4 + lens.numel() * 4)
    flops = 2 * h * (r + pr + r) * seen
    def fn():
        return ops.paged_mla_attention_op(*args)

    dev_t = device_times(torch, fn)
    check(set(dev_t["by_kernel"]) == {"mla_decode_partial",
                                      "mla_decode_combine"},
          f"paged_mla_attention's CUDA kernels: {sorted(dev_t['by_kernel'])}")
    entry = dict(max_abs_err=float((out.float() - r_out.float()).abs().max()),
                 ms=time_ms(torch, fn),
                 plain_ms=time_ms(torch, lambda: ref.paged_mla_attention_ref(
                     *args), iters=5),
                 library_ms=None, device_ms=dev_t["device_ms"],
                 device_by_kernel=dev_t["by_kernel"],
                 host_ms=dev_t["host_ms"],
                 kernels_per_call=dev_t["kernels_per_call"],
                 bytes=nbytes, flops=flops)
    entry["bound_ms"], entry["bound_by"] = bound(nbytes, flops)
    print(f"paged_mla_attention at the MLA cell's shape: {entry['ms']:.4f} "
          f"ms, device {entry['device_ms']:.4f} ms "
          f"({', '.join(f'{k} {v:.4f}' for k, v in dev_t['by_kernel'].items())}"
          f"), bound {entry['bound_ms']:.4f} ms by {entry['bound_by']} "
          f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), share of the "
          f"bound {entry['bound_ms'] / entry['device_ms']:.3f}")
    return entry


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
            m_rel, l_rel = rel_err(torch, m, r_m), rel_err(torch, l, r_l)
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
        m_rel, l_rel = rel_err(torch, m, r_m), rel_err(torch, l, r_l)
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
            m_rel, l_rel = rel_err(torch, m, r_m), rel_err(torch, l, r_l)
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


def family_shapes_phase(torch, dev):
    """The arena entries of both attention kernels at the other families'
    shapes, which phase 8 serves or which an MoE model of the repo has:
    deepseek-moe-16b's (16 KV heads, Gq 1: MHA) and llama4-scout's (8 KV
    heads, Gq 5), head_dim 128, phase 3's six slots and lengths, W = 1
    and W = 5.  Each is launched twice; both launches must equal the
    plain version bit for bit (out, m and l)."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(8)
    d = 128
    for arch, hkv, gq in (("deepseek-moe-16b", 16, 1),
                          ("llama4-scout-17b-a16e", 8, 5)):
        for w in (1, SPEC_K + 1):
            pps = -(-(SEQ + DECODE_TOKENS + 2 + (SPEC_K if w > 1 else 0))
                    // PAGE_SIZE)
            view = pps * PAGE_SIZE
            n_pages = SLOTS * pps + 1
            shape = (n_pages, PAGE_SIZE, hkv, d)
            fp = [torch.randn(shape, generator=gen, device=dev).to(
                torch.bfloat16) for _ in range(2)]
            codes = [torch.randint(-128, 128, shape, generator=gen,
                                   device=dev, dtype=torch.int8)
                     for _ in range(2)]
            scales = [torch.rand(shape, generator=gen, device=dev) * 0.02
                      + 1e-3 for _ in range(2)]
            bt = (torch.randperm(n_pages - 1, generator=gen, device=dev)
                  + 1).reshape(SLOTS, pps).to(torch.int32)
            lens = torch.tensor([SEQ + 16, SEQ + 6, SEQ, view - w,
                                 SEQ + 26 - w, SEQ], dtype=torch.int32,
                                device=dev)
            qlens = torch.tensor([SEQ, 0, SEQ, 0, 0, SEQ], dtype=torch.int32,
                                 device=dev)
            qshape = (SLOTS, hkv, gq, d) if w == 1 else (SLOTS, hkv, gq, w, d)
            q = torch.randn(qshape, generator=gen, device=dev).to(
                torch.bfloat16)
            op, plain = ((ops.paged_attention_arena_op,
                          ref.paged_attention_arena_ref) if w == 1 else
                         (ops.paged_verify_attention_arena_op,
                          ref.paged_verify_attention_arena_ref))
            args = (q, fp[0], fp[1], codes[0], scales[0], codes[1],
                    scales[1], bt, lens, qlens)
            first, second, want = op(*args), op(*args), plain(*args)
            same = all(torch.equal(a, b) for a, b in zip(first, second))
            exact = all(torch.equal(a, b) for a, b in zip(first, want))
            ulps = bf16_ulps(torch, first[0], want[0])
            print(f"{arch} shape (Hkv {hkv}, Gq {gq}, D {d}), arena W={w}: "
                  f"out {ulps} bf16 ulps from the plain version, m and l "
                  f"equal: {all(torch.equal(a, b) for a, b in zip(first[1:], want[1:]))}, "
                  f"two launches bit-equal: {same}")
            check(same and exact, f"{arch} arena W={w} bit for bit")


# ---------------------------------------------------------------------------
# Phase 2, continued: gemma-2's softcap and sliding window in the arena
# ---------------------------------------------------------------------------
GEMMA_ARCH, GEMMA_CAP, GEMMA_WINDOW = "gemma2-9b", 50.0, 4096
GEMMA_HKV, GEMMA_GQ, GEMMA_D = 8, 2, 256          # archs.py:23-28
# one step of five slots on both sides of the window, mixed residency
GEMMA_LENS = [1024, 4095, 4096, 4097, 6000]
GEMMA_QLENS = [1024, 0, 4096, 0, 4096]
# the window's and the cap's edges at gemma-2's shape over 320-position
# views (chunks of 16 positions, stages of 128): (W, window, cap,
# kv_lens); a slot at kv_len 0 in most
WINDOW_EDGES = {
    "window 1 (every row empty)": (1, 1, 50.0, [0, 1, 17, 100, 319, 200]),
    "window 2, no cap": (1, 2, 0.0, [0, 1, 17, 100, 319, 200]),
    "window 16, bounds mid-chunk": (1, 16, 50.0, [0, 40, 100, 319, 24, 7]),
    "window 17, bounds on chunk edges": (1, 17, 50.0,
                                         [48, 64, 96, 0, 17, 1]),
    "window 40, chunks and stages wholly below": (
        1, 40, 50.0, [300, 319, 150, 160, 0, 41]),
    "window past every length": (1, 4096, 50.0, [0, 1, 17, 100, 319, 200]),
    "cap, no window": (1, 0, 50.0, [0, 1, 17, 100, 319, 200]),
    "verify W=5, window 3 (tokens 2-4 see nothing)": (
        5, 3, 50.0, [0, 40, 100, 315, 17, 200]),
    "verify W=5, window 16": (5, 16, 50.0, [48, 64, 96, 315, 17, 1]),
    "verify W=2, window 40, cap 2": (2, 40, 2.0, [300, 318, 150, 160, 0, 41]),
}


def gemma_case(torch, dev, gen, w, pps, lens, qlens):
    """Arena entry inputs at gemma-2's shape (Hkv 8, Gq 2, D 256, pages of
    PAGE_SIZE): len(lens) slots of pps pages over a permuted block table,
    bf16 fp pools, int8 codes with group-GROUP scales broadcast per
    channel, bf16 queries (B, Hkv, Gq, D) or (B, Hkv, Gq, W, D)."""
    b = len(lens)
    n_pages = b * pps + 1
    shape = (n_pages, PAGE_SIZE, GEMMA_HKV, GEMMA_D)
    kp, vp = (torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    kc, vc = (torch.randint(-128, 128, shape, generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = ((torch.rand(shape[:-1] + (GEMMA_D // GROUP,), generator=gen,
                          device=dev) * 0.02 + 1e-3).half().float()
              .repeat_interleave(GROUP, -1) for _ in range(2))
    bt = (torch.randperm(n_pages - 1, generator=gen, device=dev)
          + 1).reshape(b, pps).to(torch.int32)
    qshape = (b, GEMMA_HKV, GEMMA_GQ) + ((w,) if w > 1 else ()) + (GEMMA_D,)
    q = torch.randn(qshape, generator=gen, device=dev).to(torch.bfloat16)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    return q, kp, vp, kc, ks, vc, vs, bt, i32(lens), i32(qlens)


def hold_window_cap(torch, label, args, window, cap):
    """One arena entry (by q's rank) with ``window`` and ``cap`` against
    its plain version on the card: launched twice, bit-equal; out within 2
    bf16 ulps, m and l within 1e-5 relative, as the other arena holds
    (the two agree to the bit where the plain version runs on the card:
    torch.tanh is CUDA's tanhf there and its divide by a tensor the IEEE
    one, as in the kernel).  Returns (out's bf16 ulps, max |err|, rows
    that see nothing)."""
    from repro_torch.kernels import ops, ref

    op, plain = ((ops.paged_attention_arena_op, ref.paged_attention_arena_ref)
                 if args[0].dim() == 4 else
                 (ops.paged_verify_attention_arena_op,
                  ref.paged_verify_attention_arena_ref))
    first = op(*args, window=window, softcap=cap)
    second = op(*args, window=window, softcap=cap)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    (out, m, l), (r_out, r_m, r_l) = first, plain(*args, window, cap)
    ulps = bf16_ulps(torch, out, r_out)
    m_rel, l_rel = rel_err(torch, m, r_m), rel_err(torch, l, r_l)
    err = float((out.float() - r_out.float()).abs().max())
    empty = int(torch.isneginf(m).sum())
    check(empty == int(torch.isneginf(r_m).sum()), f"{label}: empty rows")
    print(f"{label}: out {ulps} bf16 ulps (max|err| {err:.3g}; tolerance "
          f"2), m rel {m_rel:.3g}, l rel {l_rel:.3g} (tolerance 1e-5), "
          f"{empty} empty rows, two launches bit-equal: {same}")
    check(ulps <= 2 and m_rel <= 1e-5 and l_rel <= 1e-5 and same, label)
    return ulps, err, empty


def window_bytes(lens, qlens, window, w, hkv, gq, d, pps):
    """Bytes one arena call must move: each K and V row its rows see
    (inside the window) once, as stored (2 B bf16, or 1 B code + 4 B
    scale), q and out, m and l, the block table."""
    kv = 0
    for n, qn in zip(lens, qlens):
        lo = max(0, n - window + 1) if window else 0
        quant = max(0, min(qn, n) - lo)
        kv += 2 * hkv * d * ((n - lo - quant) * 2 + quant * 5)
    rows = len(lens) * hkv * gq * w
    return kv + rows * d * 2 * 2 + rows * 8 + len(lens) * pps * 4


def gemma_calls(torch, dev):
    """{label: (call, args, window)}: both arena entries at gemma-2's
    main shape (GEMMA_LENS, W 1 and 5), capped, windowed and not."""
    from repro_torch.kernels import ops

    calls = {}
    pps = -(-(max(GEMMA_LENS) + 2 + SPEC_K) // PAGE_SIZE)
    for w in (1, SPEC_K + 1):
        gen = torch.Generator(device=dev).manual_seed(40 + w)
        args = gemma_case(torch, dev, gen, w, pps, GEMMA_LENS, GEMMA_QLENS)
        op = (ops.paged_attention_arena_op if w == 1 else
              ops.paged_verify_attention_arena_op)
        for window in (GEMMA_WINDOW, 0):
            calls[f"W={w} window {window}"] = (
                lambda args=args, window=window, op=op: op(
                    *args, window=window, softcap=GEMMA_CAP), args, window)
    return calls


def window_cap_phase(torch, dev):
    """Both arena entries with gemma-2's softcap and sliding window,
    against their plain versions on the card: at gemma-2's shape (Hkv 8,
    Gq 2, D 256, cap 50, window 4096) with kv_lens on both sides of the
    window, W 1 and 5, then at WINDOW_EDGES; each launched twice,
    bit-equal.  Times the main-shape calls windowed (against the byte
    bound over the positions inside the window, and SDPA over the same
    pre-dequantized view under the same mask) and each CUDA kernel's
    device time windowed and not (cap only) at the same kv_lens: the
    window's skip of the chunks and stages below it.  Returns
    {"W=1": entry, "W=5": entry}."""
    from repro_torch.kernels import ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    pps = -(-(max(GEMMA_LENS) + 2 + SPEC_K) // PAGE_SIZE)
    view = pps * PAGE_SIZE
    out = {}
    calls = gemma_calls(torch, dev)
    for label, (call, args, window) in calls.items():
        w = 1 if args[0].dim() == 4 else args[0].shape[3]
        ulps, err, _ = hold_window_cap(
            torch, f"{GEMMA_ARCH} shape (Hkv {GEMMA_HKV}, Gq {GEMMA_GQ}, D "
            f"{GEMMA_D}) arena W={w}, cap {GEMMA_CAP:g}, window {window}, "
            f"kv_lens {GEMMA_LENS}", args, window, GEMMA_CAP)
        if window == 0:
            continue
        q, kp, vp, kc, ks, vc, vs, bt, lens, qlens = args
        g = bt.long()
        use_q = (torch.arange(view, device=dev)[None, :]
                 < qlens[:, None])[..., None, None]
        b = len(GEMMA_LENS)

        def dense_view(pool, codes, scales):
            deq = (codes.float() * scales).to(torch.bfloat16)[g]
            return torch.where(
                use_q, deq.reshape(b, view, GEMMA_HKV, GEMMA_D),
                pool[g].reshape(b, view, GEMMA_HKV, GEMMA_D)).transpose(1, 2)

        kview, vview = dense_view(kp, kc, ks), dense_view(vp, vc, vs)
        qs = q.reshape(b, GEMMA_HKV * GEMMA_GQ, w, GEMMA_D)
        pos = torch.arange(view, device=dev)
        j = torch.arange(w, device=dev)[None, :, None]
        mask = ((pos < lens[:, None, None])
                & (pos > lens[:, None, None] + j - window))[:, None]
        plain = (ref.paged_attention_arena_ref if w == 1 else
                 ref.paged_verify_attention_arena_ref)
        nbytes = window_bytes(GEMMA_LENS, GEMMA_QLENS, window, w, GEMMA_HKV,
                              GEMMA_GQ, GEMMA_D, pps)
        seen = sum(min(n, window - 1) for n in GEMMA_LENS)
        entry = dict(
            max_abs_err=err, ulps=ulps,
            ms=time_ms(torch, call),
            plain_ms=time_ms(torch, lambda: plain(*args, window, GEMMA_CAP),
                             iters=3, warmup=1),
            library_ms=time_ms(torch, lambda: sdpa(
                qs, kview, vview, attn_mask=mask, enable_gqa=True)))
        entry["bound_ms"], entry["bound_by"] = bound(
            nbytes, 4 * GEMMA_GQ * w * GEMMA_HKV * GEMMA_D * seen)
        out[f"W={w}"] = entry
        del kview, vview
    # the edges, each entry twice
    for label, (w, window, cap, lens) in WINDOW_EDGES.items():
        gen = torch.Generator(device=dev).manual_seed(len(label))
        qlens = [min(n, q) for n, q in zip(lens, [0, 9, 100, 160, 0, 33])]
        hold_window_cap(torch, f"window/cap edge, {label}: kv_lens {lens}",
                        gemma_case(torch, dev, gen, w, 20, lens, qlens),
                        window, cap)
    times = attention_phase_times(torch, dev, {
        k: c for k, (c, _, _) in calls.items()})
    for w in (1, SPEC_K + 1):
        win, full = times[f"W={w} window {GEMMA_WINDOW}"], \
            times[f"W={w} window 0"]
        out[f"W={w}"].update(
            phase_a_ms=win["phase_a_ms"], phase_b_ms=win["phase_b_ms"],
            unwindowed_phase_a_ms=full["phase_a_ms"],
            unwindowed_phase_b_ms=full["phase_b_ms"])
        saved = (full["phase_a_ms"] + full["phase_b_ms"]
                 - win["phase_a_ms"] - win["phase_b_ms"])
        print(f"{GEMMA_ARCH} shape arena W={w}: the window's skip saves "
              f"{saved:.4f} ms of device time a call at kv_lens "
              f"{GEMMA_LENS} ({out[f'W={w}']['ms']:.4f} ms a call "
              f"windowed, bound {out[f'W={w}']['bound_ms']:.4f} ms over "
              f"the positions inside the window, SDPA "
              f"{out[f'W={w}']['library_ms']:.4f} ms, plain "
              f"{out[f'W={w}']['plain_ms']:.2f} ms)")
    return out


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
    attention = attention_main_calls(torch, dev, ops)
    calls = dict(attention)
    calls.update(decode_main_call(torch, dev, ops)[0])
    calls.update(hadamard_main_calls(torch, dev, ops)[0])
    quant = quant_main_calls(torch, dev, ops)[0]
    calls.update(quant)
    out = {k: time_ms(torch, fn) for k, fn in calls.items()}
    for k in QUANT_MAIN:
        out[f"{k} device"] = device_times(torch, quant[k])["device_ms"]
    for k, fn in attention.items():
        out[f"arena attention {k} device"] = device_times(
            torch, fn)["device_ms"]
    # the arena entries' outputs (out, m, l), to hold the two trees' bits
    out["digests"] = {k: hashlib.sha256(b"".join(
        t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
        for t in fn())).hexdigest() for k, fn in attention.items()}
    return out


def attention_phase_times(torch, dev, calls=None):
    """Device time per call of each CUDA kernel that one arena attention
    call issues (the split design's phase A, ``split_scores``, and phase
    B, ``split_values``), from torch.profiler over 20 back-to-back calls;
    and the host's time to enqueue one call; for ``calls`` ({label:
    call}), by default the main shapes' (``attention_main_calls``).
    Returns {"W=1": {"phase_a_ms": .., "phase_b_ms": .., "kernels_per_call":
    .., "host_ms": ..}, ...}."""
    from repro_torch.kernels import ops

    names = ("split_scores", "split_values")
    out = {}
    if calls is None:
        calls = attention_main_calls(torch, dev, ops)
    for w, fn in calls.items():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        host_ms = (time.perf_counter() - t0) / 100 * 1e3
        torch.cuda.synchronize()
        phases, launched = {}, 0
        for e in profile_window(torch, fn, 20, lambda events: all(
                any(n in e.key and e.count >= 10 for e in events)
                for n in names)):
            dt = getattr(e, "device_time_total", None)
            if dt is None:
                dt = e.cuda_time_total
            for key, name in zip(("phase_a_ms", "phase_b_ms"), names):
                if name in e.key and e.count:
                    phases[key] = dt / e.count / 1e3
                    launched += e.count
        check(set(phases) == {"phase_a_ms", "phase_b_ms"},
              f"profiler saw both phases at {w}")
        out[w] = dict(phases, kernels_per_call=launched / 20,
                      host_ms=host_ms)
        print(f"arena attention {w}: phase A "
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
    digests = [r.pop("digests") for r in runs]
    for k in digests[0]:
        same = len({d[k] for d in digests}) == 1
        print(f"arena attention {k} at the main shapes: out, m and l "
              f"bit-equal to {baseline}'s in all four turns: {same}")
        check(same, f"arena attention {k} bit-equal to the baseline")
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
def model_setup(torch, dev, arch=ARCH):
    """Seeded random bf16 weights of ``arch`` at full width, and one
    warm-up prefill and decode step (cuBLAS's lazy initialisation, which a
    long-running server pays once).  Returns (cfg, params)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import (
        decode_step, init_cache, init_params, prefill)

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"{arch}: {n_params / 1e9:.3f}B seeded bf16 parameters on {dev} "
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


def serve(torch, dev, cfg, params, seq=SEQ, slots=SLOTS, scenario=SCENARIO,
          store_capacity=1 << 30, **spec):
    """Serve ``scenario`` PD-separated on the paged arena with ``seq``-token
    prompts and ``slots`` decode slots (``spec``: the speculation fields
    of RuntimeConfig); the launch counts are set to 0 just before the run
    and read just after.  Returns (runtime, wall seconds, launch
    counts)."""
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
        config=RuntimeConfig(seq=seq, decode_tokens=DECODE_TOKENS,
                             mode="pd", paged=True, page_size=PAGE_SIZE,
                             pd_inject_restored=True,
                             store_capacity=store_capacity, **spec),
        trace=BandwidthTrace.constant(100 * GBPS),
        scheduler=SchedulerConfig(max_slots=slots, max_prefills_per_step=2,
                                  max_queue=32),
        device=dev)
    rt.model_cfg, rt.params = cfg, params
    if dev.type == "cuda":
        torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for w, slo_class, seed, out_tokens, steps_after in list(scenario):
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


def check_runtime(rt, cfg, scenario=SCENARIO, hits=(3, 5, 6)) -> None:
    """Every request of ``scenario`` served with its tokens, in the
    vocabulary, breakdowns summing to JCT, wire bytes; the pool hits
    ``hits`` (None: not checked); every page returned."""
    done = sorted(rt.completed, key=lambda r: r.rid)
    check(len(done) == len(scenario), "every request served")
    got = [r.rid for r in done if r.pool_hit]
    check(hits is None or got == list(hits), f"pool hits {got}")
    for r, (_, _, _, out_tokens, _) in zip(done, scenario):
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
    """Free a finished runtime's page pools (~3 GB at full width), its
    decode graphs and a draft model's arena before the next phase
    allocates its own."""
    for dw in rt.decode_workers:
        dw._arena = dw._qcodes = dw._qscales = dw._draft = None
        dw._paged_step = None
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
        if not hasattr(lib, fn):   # an entry the baseline does not have
            continue
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def decode_step_times(torch, dev, cfg, params, baseline=None, seq=SEQ,
                      slots=SLOTS):
    """One full-width paged decode step of ``slots`` slots, as phase 3 runs
    it (lengths seq + 0-31, mixed residency, one paged_attention_arena
    launch a layer): the host's time to enqueue the step, its wall time
    ending in a sync (medians of 8), and the device's busy time per step
    from torch.profiler.  With ``baseline``, the same step with the
    baseline's paged_attention library in place of this tree's, in turns
    (this, baseline, baseline, this).  Returns {label: [runs]}."""
    from repro_torch.core.quality import _paged_caches, init_paged_pools
    from repro_torch.kernels import build
    from repro_torch.models.transformer import decode_step

    pps = -(-(seq + DECODE_TOKENS + 2) // PAGE_SIZE)
    n_pages = slots * pps + 1
    pool, qc, qs = init_paged_pools(cfg, n_pages, PAGE_SIZE, 1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    bt = (torch.randperm(n_pages - 1, generator=gen, device=dev)
          + 1).reshape(slots, pps).to(torch.int32)
    lens = torch.tensor([seq + 16, seq + 6, seq, pps * PAGE_SIZE - 1,
                         seq + 26, seq][:slots], dtype=torch.int32,
                        device=dev)
    qlens = torch.tensor([seq, 0, seq, 0, 0, seq][:slots],
                         dtype=torch.int32, device=dev)
    paged = _paged_caches(pool, qc, qs, bt, qlens)
    tok = torch.zeros((slots, 1), dtype=torch.int32, device=dev)

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
        busy = attn = 0.0
        by_kernel = []
        for e in profile_window(torch, step, 3, lambda events: sum(
                e.count for e in events if "split_scores" in e.key)
                >= 3 * cfg.num_layers / 2):
            dt = getattr(e, "self_device_time_total", None)
            if dt is None:
                dt = e.self_cuda_time_total
            busy += dt
            by_kernel.append((dt, e.key[:60], e.count))
            if "split_" in e.key or "paged_attention_kernel" in e.key:
                attn += dt
        run = dict(host_ms=statistics.median(hosts),
                   wall_ms=statistics.median(walls),
                   device_busy_ms=busy / 3 / 1e3, attention_ms=attn / 3 / 1e3)
        print(f"decode step ({label}): host enqueue {run['host_ms']:.2f} ms, "
              f"wall {run['wall_ms']:.2f} ms, device busy "
              f"{run['device_busy_ms']:.2f} ms of which paged attention "
              f"{run['attention_ms']:.2f} ms (torch.profiler)")
        top = ", ".join(f"{k} {dt / 3 / 1e3:.2f} ms ({n // 3} launches)"
                        for dt, k, n in sorted(by_kernel, reverse=True)[:5])
        print(f"decode step ({label}), device time per step by kernel: "
              f"{top}")
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
    int8 quant pages (MLA's latent layout: bf16 pages alone, as it
    lands): through the Hopper kernel (``paged_attention_arena`` or, for
    MLA, ``paged_mla_attention``), and through its plain version (same
    arithmetic order, so the logits should agree to the last bits).  Also
    prints the dense-cache path (cuBLAS attention, another summation
    order) for information.  Returns (max |logit difference| kernel vs
    plain, logit scale, plain top-2 gap, argmaxes agree)."""
    import repro_torch.models.layers as layers
    from repro_torch.configs.base import is_mla
    from repro_torch.core.kvcache import PageTable
    from repro_torch.core.pipeline import CompressionPipeline
    from repro_torch.core.quality import (
        _paged_caches, _prompts_for, extract_kv, init_paged_pools, inject_kv,
        inject_kv_paged, inject_quant_pages)
    from repro_torch.kernels import ref
    from repro_torch.core.strategy import quant_resident
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
    layouts = [(0, "bf16 pages")]
    if quant_resident(comp):
        (kc, ks), (vc, vs) = quant_entry_arrays(comp)
        layouts.append((seq, "int8 pages"))
    entry = ("paged_mla_attention" if is_mla(cfg)
             else "paged_attention_arena")

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
    for quant_len, where in layouts:
        kernel = paged_logits(quant_len)
        kernel_op = getattr(layers, entry + "_op")
        setattr(layers, entry + "_op", getattr(ref, entry + "_ref"))
        try:
            plain = paged_logits(quant_len)
        finally:
            setattr(layers, entry + "_op", kernel_op)
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
# Phase 4b: the sync census of the serving steps.  Two cold requests of SEQ
# tokens, CENSUS_DECODE decode tokens each, served as phase 3 serves them,
# under torch.cuda.set_sync_debug_mode("warn"): PyTorch warns at every
# synchronizing CUDA operation it sees, and the hook charges each warning
# to the innermost frame under src/repro_torch.  The mode does not see
# every sync (the caching allocator's cudaMalloc, the kernels' ctypes
# libraries), so the gate holds one way only: each site seen here is a
# host-sync finding of repro_torch.analysis, open or suppressed.
# ---------------------------------------------------------------------------
CENSUS_DECODE = 8
CENSUS_SCENARIO = [("qalike", "standard", 0, CENSUS_DECODE, 0),
                   ("codelike", "interactive", 1, CENSUS_DECODE, 0)]
SYNC_WARNING = "called a synchronizing CUDA operation"
# a cold request's stages, by the runtime's function on the stack
COLD_STAGES = (("prefill", "prefill"), ("select_and_compress", "compress"),
               ("decompress_kvs", "land"), ("inject_restored", "land"),
               ("fetch_entry", "land"), ("occupy", "land"))


def sync_census(torch, dev, cfg, params, **spec):
    """Serve CENSUS_SCENARIO (``spec``: RuntimeConfig's speculation
    fields) under sync debug mode "warn".  Returns {"iterations": [(kind,
    Counter of sites)] per decode iteration, kind "decode" or "verify";
    "cold": Counter of (stage, site) outside the iterations; "outside":
    syncs with no frame under src/repro_torch; "cold_requests"; "wall"}.
    A site is "src/repro_torch/<file>:<line>"."""
    import collections
    import traceback
    import warnings

    from repro_torch.serving.workers import DecodeWorker

    ours = str(ROOT / "src" / "repro_torch") + os.sep
    iterations, cold = [], collections.Counter()
    current, outside = [], [0]      # the open decode iteration's [kind, sites]

    def hook(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):
            return shown(message, category, filename, lineno, file, line)
        frames = [f for f in traceback.extract_stack()
                  if f.filename.startswith(ours)]
        if not frames:
            outside[0] += 1
            return
        site = (f"{Path(frames[-1].filename).relative_to(ROOT).as_posix()}"
                f":{frames[-1].lineno}")
        if current:
            current[-1][1][site] += 1
        else:
            names = {f.name for f in frames}
            stage = next((s for n, s in COLD_STAGES if n in names), "other")
            cold[(stage, site)] += 1

    decode_iteration = DecodeWorker.decode_iteration
    verify_iteration = DecodeWorker._verify_iteration

    def counted_decode(self, active):
        current.append(["decode", collections.Counter()])
        try:
            return decode_iteration(self, active)
        finally:
            iterations.append(tuple(current.pop()))

    def counted_verify(self, active, proposals):
        current[-1][0] = "verify"
        return verify_iteration(self, active, proposals)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning
        warnings.showwarning = hook
        DecodeWorker.decode_iteration = counted_decode
        DecodeWorker._verify_iteration = counted_verify
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rt, wall, _ = serve(torch, dev, cfg, params,
                                scenario=CENSUS_SCENARIO, **spec)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            DecodeWorker.decode_iteration = decode_iteration
            DecodeWorker._verify_iteration = verify_iteration
    check_runtime(rt, cfg, CENSUS_SCENARIO, hits=())
    release_arenas(torch, rt)
    return {"iterations": iterations, "cold": cold, "outside": outside[0],
            "cold_requests": sum(not r.pool_hit for r in rt.completed),
            "wall": wall}


def print_census(label, census) -> dict:
    """Print a census's syncs per decode and per verify iteration and per
    cold request, by site.  Returns {kind: syncs per iteration or request}."""
    import collections

    out = {}
    for kind in ("decode", "verify"):
        rows = [c for k, c in census["iterations"] if k == kind]
        if not rows:
            print(f"census {label}: no {kind} iterations")
            continue
        per = [sum(c.values()) for c in rows]
        sites = sum(rows, collections.Counter())
        out[kind] = sum(per) / len(rows)
        print(f"census {label}: {len(rows)} {kind} iterations, "
              f"{out[kind]:g} syncs per iteration (min {min(per)}, max "
              f"{max(per)}); per iteration by site: " + ", ".join(
                  f"{s} x{n / len(rows):g}" for s, n in sorted(sites.items())))
    n = census["cold_requests"]
    out["cold"] = sum(census["cold"].values()) / max(n, 1)
    print(f"census {label}: {out['cold']:g} syncs per cold request ({n} "
          f"cold requests); per request by stage and site: " + ", ".join(
              f"{stage} {s} x{c / max(n, 1):g}"
              for (stage, s), c in sorted(census["cold"].items())))
    print(f"census {label}: {census['outside']} syncs outside "
          f"src/repro_torch (the harness's own), {census['wall']:.2f} s "
          f"wall")
    return out


def census_sites(census) -> set:
    sites = {s for _, c in census["iterations"] for s in c}
    return sites | {s for _, s in census["cold"]}


def census_gate(sites) -> None:
    """Every site seen on the card is a host-sync finding of the port's
    rules on this tree, open or suppressed."""
    from repro_torch.analysis import run_paths

    open_, closed = run_paths([str(ROOT / "src" / "repro_torch")], base=ROOT)
    reported = {f"{f.path}:{f.line}" for f in open_ + closed
                if f.rule == "host-sync"}
    missing = sorted(s for s in sites if s not in reported)
    print(f"census gate: {len(sites)} sites seen on the card, "
          f"{len(sites) - len(missing)} of them host-sync findings of "
          f"repro_torch.analysis ({len(reported)} findings in all); not "
          f"reported: {missing}")
    check(not missing, "every sync site seen on the card is reported by the "
          "port's host-sync rule")


def census_phase(torch, dev, cfg, params) -> dict:
    """Phase 4b: the plain run, then one n-gram speculative run with
    spec_k=SPEC_K; random weights give n-gram lookahead no drafts, so
    when it takes no verify step the two-model draft runs too.  Gated
    by ``census_gate``.  Returns {run: print_census's numbers}."""
    t0 = time.perf_counter()
    out, sites = {}, set()
    runs = [("plain", {}), ("ngram", {"spec_k": SPEC_K, "spec_kind": "ngram"})]
    while runs:
        label, spec = runs.pop(0)
        census = sync_census(torch, dev, cfg, params, **spec)
        out[label] = print_census(label, census)
        sites |= census_sites(census)
        if label == "ngram" and "verify" not in out[label]:
            runs.append(("model", {"spec_k": SPEC_K, "spec_kind": "model"}))
    check("decode" in out["plain"], "the census saw decode iterations")
    check(any("verify" in o for o in out.values()),
          "the census saw verify iterations")
    census_gate(sites)
    print(f"phase 4b: {time.perf_counter() - t0:.2f} s wall")
    return out


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


# Phase 6: the trace-driven KV-disaggregated cluster.  The trace is the
# first CLUSTER_EVENTS events of build_trace(default_tenants(), 30 s,
# seed CLUSTER_SEED): eleven distinct prompts and five repeats.  It is
# replayed twice, the second pass once the first has drained, shifted by
# the cluster's clock.  Each compressed prefix is 69,208,128 bytes at full
# width (int8 codes + f32 group scales), so a worker's hot tier holds
# three and its DRAM one.  The second pass's remote hits do not depend on
# timing: the two workers' local tiers hold eight prefixes, so at least
# three of the eleven live only in the shared tier once the first pass
# has drained, only a fetch brings one back, and the second pass asks for
# each of them.  Its local hits do: on the wall clock the router has no
# queue term, so a repeat goes to the worker holding its prefix only when
# that worker has a free slot.  tests/test_torch_phase6_timing.py
# emulates this clock at tiny-lm size and finds both kinds of hit at every
# stage time from 0.8 to 1.2 times this phase's on an H100, where one pass
# alone misses one kind at some of them.  With 1 GB of DRAM each worker
# would keep every prompt of the trace and no hit could reach the shared
# tier, so DRAM holds one prefix.
CLUSTER_EVENTS, CLUSTER_SEED, CLUSTER_DURATION, CLUSTER_PASSES = \
    16, 2, 30.0, 2
CLUSTER_SLOTS, CLUSTER_DECODE_TOKENS = 4, 20
HOT_TIER_BYTES, DRAM_TIER_BYTES, STORE_BYTES = 256 << 20, 128 << 20, 4 << 30


def served_tier(r, tiers) -> str:
    """The tier that served request ``r``, read off its breakdown: a hit's
    ``comm`` is the holding tier's fetch overhead plus its wire time for
    ``r.wire_bytes`` (constant links here), and the tiers' sums differ.
    "-" for a miss."""
    if not r.pool_hit:
        return "-"
    return min(tiers, key=lambda t: abs(
        t.fetch_overhead + t.trace.transfer_time(0.0, r.wire_bytes)
        - r.breakdown["comm"])).name


def cluster_phase(torch, dev, cfg, params):
    """Phase 6: replay the trace's events CLUSTER_PASSES times through a
    2x2 ``ClusterRuntime`` in pool mode (load-aware router, paged arena of
    CLUSTER_SLOTS slots per decode worker, HBM -> DRAM -> shared remote
    tiers, remote pool at 100 Gb/s, wall-clock node speeds, phase 3's
    profile and prompt length) with the port's KV sanitizer installed,
    then replay the same arrivals through the port's ``Simulator``
    configured with this run's measured speeds and on-wire bytes.  The
    launch counts are set to 0 just before the replay and read just
    after.  Returns them."""
    from repro_torch.analysis import sanitize
    from repro_torch.core.profiles import Profile
    from repro_torch.core.quality import _prompts_for
    from repro_torch.core.strategy import StrategyConfig
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.serving import (
        GBPS, BandwidthTrace, Request, SchedulerConfig, SimConfig, Simulator,
        StaticPolicy, TieredKVStore, default_tier_specs)
    from repro_torch.serving.cluster import ClusterRuntime
    from repro_torch.serving.engine import RuntimeConfig
    from repro_torch.workloads import (
        build_trace, default_tenants, replay_runtime)

    trace = build_trace(default_tenants(), duration=CLUSTER_DURATION,
                        seed=CLUSTER_SEED)
    events = trace.events[:CLUSTER_EVENTS]
    arrivals = []
    print(f"phase 6 trace: default_tenants(), {CLUSTER_DURATION:g} s, seed "
          f"{CLUSTER_SEED}, digest {trace.digest()}; first {len(events)} "
          f"events over {events[-1].t:.3f} s: "
          + " ".join(f"{e.workload}/{e.prefix_group}" for e in events))
    strategy = StrategyConfig(quantizer="uniform", key_bits=8, value_bits=8,
                              granularity="per_token", symmetric=True,
                              group_size=GROUP)
    bandwidth = BandwidthTrace.constant(100 * GBPS)
    t0 = time.perf_counter()
    sanitize.install()
    try:
        rt = ClusterRuntime(
            static_profile=Profile(strategy, cr=2.0, s_enc=5e8, s_dec=5e8),
            config=RuntimeConfig(seq=SEQ,
                                 decode_tokens=CLUSTER_DECODE_TOKENS,
                                 mode="pool", paged=True,
                                 page_size=PAGE_SIZE,
                                 hot_tier_bytes=HOT_TIER_BYTES,
                                 dram_tier_bytes=DRAM_TIER_BYTES,
                                 store_capacity=STORE_BYTES),
            trace=bandwidth,
            scheduler=SchedulerConfig(max_slots=CLUSTER_SLOTS,
                                      max_prefills_per_step=2, max_queue=64),
            n_prefill=2, n_decode=2, router="load_aware",
            slots_per_worker=CLUSTER_SLOTS, device=dev)
        rt.model_cfg, rt.params = cfg, params
        if dev.type == "cuda":
            torch.cuda.synchronize()
        reset_launches()
        t_run = time.perf_counter()
        for _ in range(CLUSTER_PASSES):
            shifted = [dataclasses.replace(e, t=e.t + rt.clock)
                       for e in events]
            arrivals += shifted
            done = replay_runtime(rt, trace, events=shifted)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        counts = launches()
        for dw in rt.decode_workers:
            if dw.page_table is None:     # served nothing: no arena
                continue
            sanitize.check_drained(dw.page_table)
            check(dw.page_table.free_pages == dw.page_table.num_pages - 1,
                  f"decode worker {dw.wid}: every page returned")
    finally:
        sanitize.uninstall()

    print(f"phase 6 runtime: {len(done)} requests in {wall:.2f} s wall, "
          f"{rt.steps} iterations, cluster clock {rt.clock:.3f} s")
    check(len(done) == len(arrivals), "every trace event served")
    tiers = rt.decode_workers[0].store.tiers
    served = {t.name: 0 for t in tiers}
    for r in sorted(done, key=lambda r: r.rid):
        check(abs(sum(r.breakdown.values()) - r.jct) < 1e-6,
              f"rid {r.rid}: breakdown sums to JCT")
        check(all(0 <= int(t) < cfg.vocab_size for t in r.tokens),
              f"rid {r.rid}: tokens in vocabulary")
        tier = served_tier(r, tiers)
        if r.pool_hit:
            served[tier] += 1
        bd = ", ".join(f"{k}={v * 1e3:.2f}ms" for k, v in r.breakdown.items())
        print(f"  rid {r.rid} {r.workload:9s} {r.route} hit={int(r.pool_hit)} "
              f"tier={tier} ttft={r.ttft * 1e3:.2f}ms "
              f"jct={r.jct * 1e3:.2f}ms tokens={len(r.tokens)} "
              f"wire_bytes={r.wire_bytes} [{bd}]")
    tier_hits = {t.name: 0 for t in tiers}
    for dw in rt.decode_workers:
        summary = dw.store.summary()
        print(f"  decode worker {dw.wid} store: {summary}")
        for j, t in enumerate(tiers):
            tier_hits[t.name] += summary[f"tier{j}_{t.name}_hits"]
    print(f"phase 6 hits by tier (the stores' counters): {tier_hits}")
    check(served == tier_hits, "each hit's tier, read off its breakdown, "
                               "agrees with the stores' counters")
    check(tier_hits["hbm"] + tier_hits["dram"] > 0,
          "a hit landed in a worker-local tier")
    check(tier_hits["remote"] > 0, "a hit landed in the shared remote tier")
    print(f"launches on the phase 6 path: {counts}")
    for k in ("paged_attention_arena_op", "quant_pack_op"):
        check(counts[k] > 0, f"{k} launched in phase 6")

    # ---- the same trace through the port's Simulator ----
    cold = [r for r in done if not r.pool_hit]
    hits = [r for r in done if r.pool_hit]
    kv_bytes = statistics.mean(r.kv_bytes for r in done)
    wire = statistics.mean(r.wire_bytes for r in cold)
    prefill_s = statistics.mean(r.breakdown["prefill"] for r in cold)
    # a cold request's pool write: its compress, then the hot tier's link
    # (a wait, when a fetch or another write holds it, and the transfer)
    compress_s = statistics.median(
        r.t_pool_write - tiers[0].trace.transfer_time(0.0, r.wire_bytes)
        for r in cold)
    decompress_s = statistics.mean(r.breakdown["decompress"] for r in hits)
    profile = Profile(strategy, cr=kv_bytes / wire,
                      s_enc=kv_bytes / compress_s,
                      s_dec=kv_bytes / decompress_s)
    print(f"phase 6 measured: prefill {prefill_s * 1e3:.2f} ms per "
          f"{SEQ}-token prompt, compress {compress_s * 1e3:.2f} ms, hit "
          f"landing {decompress_s * 1e3:.2f} ms, {wire:.0f} wire bytes of "
          f"{kv_bytes:.0f} KV bytes per prefix")
    reqs = []
    for rid, e in enumerate(arrivals):
        tokens, _ = _prompts_for(e.workload, 1, SEQ, e.prefix_group)
        reqs.append(Request(
            rid=rid, workload=e.workload, arrival=e.t, ctx_tokens=SEQ,
            out_tokens=min(e.out_tokens, CLUSTER_DECODE_TOKENS),
            kv_bytes=kv_bytes,
            t_slo=e.t_slo, q_min=e.q_min, slo_class=e.slo_class,
            slo_metric=e.slo_metric,
            prefix_key=tuple(int(t) for t in tokens[0])))
    store = TieredKVStore(default_tier_specs(
        STORE_BYTES, bandwidth, hot_bytes=HOT_TIER_BYTES,
        dram_bytes=DRAM_TIER_BYTES), block=rt.cfg.store_block)
    sim = Simulator(SimConfig(scenario="pool", n_prefill=2, n_decode=2,
                              prefill_tok_s=SEQ / prefill_s, paged=False,
                              seed=0),
                    StaticPolicy(profile, "int8-g64"), bandwidth, reqs,
                    store=store).run()
    by_rid = {r.rid: r for r in sim.requests}
    print("phase 6 simulator vs runtime (the card runs the two prefill "
          "workers and the two decode workers one after the other, while "
          "the cluster's clock overlaps them; the simulator's pool "
          "scenario ends at the first token, so its JCT is its TTFT):")
    gaps = []
    for r in sorted(done, key=lambda r: r.rid):
        s_ = by_rid[r.rid]
        gap = s_.ttft / r.ttft - 1.0
        gaps.append(abs(gap))
        print(f"  rid {r.rid} hit={int(r.pool_hit)} sim_hit="
              f"{int(s_.breakdown.get('prefill', 0.0) == 0.0)} ttft runtime "
              f"{r.ttft * 1e3:.2f}ms sim {s_.ttft * 1e3:.2f}ms "
              f"({gap * 100:+.1f}%); jct runtime {r.jct * 1e3:.2f}ms sim "
              f"{s_.jct * 1e3:.2f}ms")
    print(f"phase 6 simulator TTFT gap: median "
          f"{statistics.median(gaps) * 100:.1f}%, max {max(gaps) * 100:.1f}%")
    if dev.type == "cuda":
        release_arenas(torch, rt)
    print(f"phase 6: {time.perf_counter() - t0:.2f} s wall")
    return counts


# ---------------------------------------------------------------------------
# Phase 7: training on the card.  (a) The reference model: tiny-lm with the
# JAX package's defaults from the port's seed-0 init, eval loss on a batch
# no training step sees.  The target is the JAX package's trainer run from
# that same init (tests/torch_reference_loss.py, on the CPU): the same
# numbers to start from and the same schedule, so only the arithmetic
# differs.  Adam turns last-place differences near zero into whole
# updates (ROADMAP Queue 3), so the arithmetic alone moves this loss: the
# card lands 9.7e-3 from the target, the port's CPU runs at 1-8 threads
# within 5.1e-3 of it.  The tolerance is that card gap with half again as
# margin.  A planted fault moves the loss by about as much as the
# arithmetic does, so the band catches some faults only: on an H100 a
# dropped weight decay, bf16 masters, a constant learning rate and a lost
# clip land outside it and no warmup inside; on the CPU only a constant
# learning rate and no warmup land outside.  So tests/test_torch_train.py
# holds the trainer's settings against the JAX package's, and this phase
# checks that the masters and moments are f32.  The JAX-trained cache (its
# own init) is printed beside the target.
# (b) llama3.1-8b at full width, depth cut to TRAIN_LAYERS (f32 masters,
# gradients, both moments and the error feedback take 20 B a parameter:
# 38 GB at 4 layers, 160 GB at 32), TRAIN_STEPS steps with 8-bit
# gradient compression through quant_pack and dequant_unpack.  (c) KV
# transfer and gradient sync between two processes on the card (a gloo
# group: NCCL refuses two ranks on one GPU).
# ---------------------------------------------------------------------------
EVAL_SEED = 999_999
REF_EVAL_TARGET = 0.6406403183937073     # JAX's trainer, the port's init
REF_EVAL_TOL = 0.015
JAX_CACHE_EVAL = 0.6595555543899536      # the JAX-trained cache
# the port's trainer on the CPU at 8, 4, 2 and 1 threads
PORT_CPU_EVALS = (0.6400114893913269, 0.6409062147140503,
                  0.6443520784378052, 0.6456921696662903)
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_BITS = 4, 4, 1024, 5, 8
PEAK_BF16_FLOP_S = 989e12     # H100 SXM, dense bf16 tensor cores


def plain_roundtrip(x, bits: int, dtype):
    """_quant_roundtrip through the kernels' plain versions: quantize,
    scales to f16 and back, dequantize to ``dtype``."""
    from repro_torch.kernels import ref

    gg = min(GROUP, x.shape[-1])
    codes, scale = ref.quantize_ref(x.reshape(-1, x.shape[-1]), bits, gg)
    return ref.dequantize_ref(codes, scale.half().float(), gg,
                              dtype=dtype).reshape(x.shape)


def reference_training(torch, dev, keep_dir: Path):
    """Phase 7a.  Returns (the launch counts of the quality evaluation,
    the eval loss); the trained parameters are saved to ``keep_dir`` for
    phase 9c."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import quality as Q
    from repro_torch.core.strategy import BASELINES
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distribution.steps import make_eval_step
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models.convert import flatten

    t0 = time.perf_counter()
    cfg, params, last, opt = Q.train_reference_model(device=dev,
                                                     log_every=50)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    print(f"phase 7a: tiny-lm trained on {dev}, {Q.REF_STEPS} steps of "
          f"16 x 256 in {train_s:.2f} s ({train_s / Q.REF_STEPS * 1e3:.2f} "
          f"ms/step), last loss {last:.4f}")
    tokens, mask = make_batch("mixed", 16, 256, seed=EVAL_SEED)
    batch = {"tokens": torch.as_tensor(tokens).to(dev),
             "mask": torch.as_tensor(mask[:, 1:]).to(dev)}
    loss = float(make_eval_step(cfg)(params, batch)["loss"])
    print(f"phase 7a eval loss on the held-out batch (seed {EVAL_SEED}): "
          f"{loss:.6f}; target {REF_EVAL_TARGET:.6f} (JAX's trainer from "
          f"the port's init) +- {REF_EVAL_TOL}; the port's CPU runs "
          f"{min(PORT_CPU_EVALS):.6f}-{max(PORT_CPU_EVALS):.6f}; the "
          f"JAX-trained cache {JAX_CACHE_EVAL:.6f}")
    check(abs(loss - REF_EVAL_TARGET) <= REF_EVAL_TOL,
          "the reference model trained on the card reaches the target")
    check(all(x.dtype == torch.float32 for _, x in flatten(
        {"params": params, "mu": opt["mu"], "nu": opt["nu"]})),
        "f32 masters and moments")

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        state = {"params": params, "opt": opt}
        mgr.save(Q.REF_STEPS, state, metadata={"loss": last})
        back = mgr.restore(state, device=dev)
        pairs = list(zip(flatten(state), flatten(back)))
        check(all(a.device == b.device and a.dtype == b.dtype
                  and torch.equal(a, b) for (_, a), (_, b) in pairs),
              "checkpoint restores the trained state bit for bit")
    print(f"phase 7a checkpoint: {len(pairs)} leaves (params and AdamW "
          f"state) saved and restored onto {dev}, bit for bit")
    CheckpointManager(str(keep_dir)).save(
        Q.REF_STEPS, {"params": params},
        metadata={"arch": cfg.name, "eval_loss": loss})

    reset_launches()
    t0 = time.perf_counter()
    for label, strategy in (("hadamard-int8", hadamard_int8()),
                            ("mixhq", BASELINES["mixhq"])):
        acc = Q.evaluate_quality(strategy, ref=(cfg, params), device=dev)
        print(f"phase 7a quality, {label} on the trained model: "
              + ", ".join(f"{w} {a:.4f}" for w, a in acc.items()))
        check(all(0.0 <= a <= 1.0 for a in acc.values()), "accuracies")
    torch.cuda.synchronize()
    counts = launches()
    print(f"phase 7a quality: {time.perf_counter() - t0:.2f} s wall, "
          f"launches {counts}")
    return counts, loss


def full_width_training(torch, dev):
    """Phase 7b.  Returns the launch counts of the training steps."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distribution.grad_compress import (
        init_ef_state, make_grad_transform)
    from repro_torch.distribution.optimizer import OptConfig, init_opt_state
    from repro_torch.distribution.steps import make_train_step
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models.convert import flatten, tree_map
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(get_config(ARCH), num_layers=TRAIN_LAYERS)
    params = init_params(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for _, p in flatten(params))
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    # 6 N T counts the matmuls' parameters: the input embedding is a gather
    n_matmul = n_params - params["embed"]["tok"].numel()
    flop_s = lambda dt: 6 * n_matmul * tokens_per_step / dt  # noqa: E731
    print(f"phase 7b: {ARCH} at full width (d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.kv_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}), depth cut {get_config(ARCH).num_layers} -> "
          f"{cfg.num_layers} layers: {n_params / 1e9:.3f}B f32 parameters, "
          f"{n_matmul / 1e9:.3f}B of them in matmuls; "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, remat, {TRAIN_BITS}-bit "
          f"gradient compression with error feedback")
    opt = init_opt_state(params)
    opt["ef"] = init_ef_state(params)
    compress = make_grad_transform(bits=TRAIN_BITS)
    # the leaves _quant_roundtrip quantizes (every one at llama3.1-8b width)
    quantized = sum(p.ndim > 0 and p.shape[-1] % min(GROUP, p.shape[-1]) == 0
                    for _, p in flatten(params))
    held, marks = [], {}

    def mark(name):     # a CUDA event, to split the step's device time
        marks[name] = torch.cuda.Event(enable_timing=True)
        marks[name].record()

    def checked(grads, state):
        """The transform (between the backward pass and AdamW); on the
        first step, leaf by leaf, each leaf's output held against the
        plain round trip of the same input."""
        mark("compress")
        if held:
            out = compress(grads, state)
        else:
            def leaf(g, e):
                want = plain_roundtrip(g.float() + e, TRAIN_BITS,
                                       torch.float32)
                got = compress({"g": g}, {"ef": {"g": e}})[0]["g"]
                held.append(torch.equal(got, want))
                return got

            out = tree_map(leaf, grads, state["ef"]), state
        mark("adamw")
        return out

    step = make_train_step(cfg, OptConfig(lr=3e-4, warmup_steps=2,
                                          total_steps=TRAIN_STEPS,
                                          weight_decay=0.01),
                           remat=True, grad_transform=checked)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    times = []
    for i in range(TRAIN_STEPS):
        tokens, mask = make_batch("mixed", TRAIN_BATCH, TRAIN_SEQ,
                                  seed=99991 * 7 + i)
        batch = {"tokens": torch.as_tensor(tokens).to(dev),
                 "mask": torch.as_tensor(mask[:, 1:]).to(dev)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mark("start")
        params, opt, m = step(params, opt, batch)
        mark("end")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times.append(dt)
        loss = float(m["loss"])
        check(math.isfinite(loss), "full-width training loss is finite")
        split = ", ".join(
            f"{name} {marks[a].elapsed_time(marks[b]):.1f}"
            for name, a, b in (("forward + backward", "start", "compress"),
                               ("compression", "compress", "adamw"),
                               ("AdamW", "adamw", "end")))
        print(f"phase 7b step {i + 1}: loss {loss:.4f}, {dt * 1e3:.1f} ms"
              f"{' (holds the plain round trip)' if i == 0 else ''} "
              f"({split} ms between CUDA events), "
              f"{tokens_per_step / dt:.0f} tokens/s, max allocated "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, "
              f"{flop_s(dt) / PEAK_BF16_FLOP_S:.4f} of the bf16 dense peak")
    counts = launches()
    steady = statistics.median(times[1:])
    print(f"phase 7b: median of steps 2-{TRAIN_STEPS} {steady * 1e3:.1f} ms "
          f"({tokens_per_step / steady:.0f} tokens/s, "
          f"{flop_s(steady) / PEAK_BF16_FLOP_S:.4f} of 989 TFLOP/s, "
          f"6 N T with N the {n_matmul / 1e9:.3f}B matmul parameters; the "
          f"matmuls with remat's second forward, 8 N T, take "
          f"{8 / 6 * flop_s(1.0) / PEAK_BF16_FLOP_S * 1e3:.1f} ms at that "
          f"peak); launches {counts}; {quantized} quantized leaves a step")
    check(len(held) == quantized and all(held),
          "one step's compressed gradients equal the plain round trip bit "
          "for bit")
    for k in ("quant_pack_op", "dequant_unpack_op"):
        check(counts[k] == TRAIN_STEPS * quantized,
              f"{k} launched once per quantized leaf per step")
    del params, opt, step, compress, m
    torch.cuda.empty_cache()
    return counts


POD_KV_BITS = (16, 8, 4)


def pod_main(torch, rank: int, init: str, dev=None) -> int:
    """One pod of phase 7c's two-process gloo group on cuda:0: ship this
    pod's 1024-token llama3.1-8b KV to the other pod at each bits, sync one
    layer's gradients, and hold both against their plain versions.  Prints
    one JSON line; any failure raises."""
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.distribution.grad_compress import (
        make_cross_pod_grad_sync)
    from repro_torch.distribution.kv_transfer import (
        make_kv_transfer, transfer_wire_bytes)
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models.convert import flatten
    from repro_torch.models.transformer import init_cache, param_shapes

    dev = torch.device("cuda", 0) if dev is None else dev
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=2)
    cfg = get_config(ARCH)
    other = 1 - rank

    def cache_of(pod):
        gen = torch.Generator(device=dev).manual_seed(100 + pod)
        c = init_cache(cfg, 1, SEQ, device=dev)
        for _, x in flatten(c):
            x.copy_(torch.randn(x.shape, generator=gen, device=dev))
        return c

    def grads_of(pod):
        gen = torch.Generator(device=dev).manual_seed(200 + pod)
        layer = {k: {n: s[1:] for n, s in sub.items()}
                 for k, sub in param_shapes(cfg)["blocks"]["layer0"].items()}
        return {k: {n: torch.randn(s, generator=gen, device=dev) * 1e-3
                    for n, s in sub.items()} for k, sub in layer.items()}

    out = {"rank": rank}
    mine, theirs = cache_of(rank), cache_of(other)
    reset_launches()
    for bits in POD_KV_BITS:
        fn = make_kv_transfer(None, bits=bits, group=GROUP)
        got = fn(mine)
        for (path, a), (_, b) in zip(flatten(got), flatten(theirs)):
            want = b if bits == 16 else plain_roundtrip(b, bits, b.dtype)
            check(a.dtype == b.dtype and torch.equal(a, want),
                  f"pod {rank} kv bits {bits} {'/'.join(path)}")
        check(fn.wire_bytes == transfer_wire_bytes(mine, bits, GROUP),
              "bytes sent equal transfer_wire_bytes")
        ms = []
        for _ in range(3):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(mine)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[f"kv{bits}"] = {"wire_bytes": fn.wire_bytes,
                            "ms": statistics.median(ms)}
    g_mine, g_theirs = grads_of(rank), grads_of(other)
    sync = make_cross_pod_grad_sync(None, bits=TRAIN_BITS, group=GROUP)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    avg = sync(g_mine)
    torch.cuda.synchronize()
    out["sync_ms"] = (time.perf_counter() - t0) * 1e3
    two = torch.full((), 2.0, device=dev)
    for (path, a), (_, g), (_, h) in zip(flatten(avg), flatten(g_mine),
                                         flatten(g_theirs)):
        want = (g.float()
                + plain_roundtrip(h, TRAIN_BITS, torch.float32)) / two
        check(torch.equal(a, want), f"pod {rank} grad sync {path}")
    out["sync_elements"] = sum(g.numel() for _, g in flatten(g_mine))
    torch.cuda.synchronize()
    out["launches"] = launches()
    dist.destroy_process_group()
    print(json.dumps(out))
    return 0


def cross_pod_phase(torch):
    """Phase 7c: pod_main in two processes; returns their launch counts,
    summed."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--pod", str(r),
             "--pod-init", str(Path(d) / "init")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in (0, 1)]
        results = []
        for p in procs:
            out, err = p.communicate(timeout=300)
            check(p.returncode == 0,
                  f"pod process exit {p.returncode}:\n{err[-4000:]}")
            results.append(json.loads(out.strip().splitlines()[-1]))
    counts = {}
    for r in results:
        for k, n in r["launches"].items():
            counts[k] = counts.get(k, 0) + n
        for bits in POD_KV_BITS:
            kv = r[f"kv{bits}"]
            print(f"phase 7c pod {r['rank']}: KV of one {SEQ}-token request "
                  f"at bits {bits}: {kv['wire_bytes']} bytes sent, "
                  f"{kv['ms']:.2f} ms per transfer (median of 3)")
        print(f"phase 7c pod {r['rank']}: one layer's gradients "
              f"({r['sync_elements']} f32), {TRAIN_BITS}-bit ring sync "
              f"{r['sync_ms']:.2f} ms")
    print(f"phase 7c: bit for bit against the plain versions in both pods; "
          f"{time.perf_counter() - t0:.2f} s wall; launches {counts}")
    for k in ("quant_pack_op", "dequant_unpack_op"):
        check(counts[k] > 0, f"{k} launched on the cross-pod paths")
    return counts


# ---------------------------------------------------------------------------
# Phase 8: the other model families
# ---------------------------------------------------------------------------
MOE_ARCH = "deepseek-moe-16b"
FAMILY_SEQ = 256
# Depth cuts of phase 8b's timed models (full width always): what one card
# holds beside the phase's time (PERF.md section 4).  jamba's 8 layers are
# one period (1 attention, 7 mamba, 4 MoE layers).  The held models are
# shorter (``held_depth``).
FAMILY_DEPTH = {"granite-20b": 8, "jamba-v0.1-52b": 8, "qwen2-vl-72b": 8,
                "llama4-scout-17b-a16e": 4}
FAMILY_ARCHS = ("qwen3-4b", "gemma2-9b", "granite-20b", "minicpm-2b",
                "jamba-v0.1-52b", "whisper-small", "qwen2-vl-72b",
                "llama4-scout-17b-a16e", "falcon-mamba-7b")


def prefill_drop_share(torch, dev, cfg, params):
    """(dropped, assignments): the (token, expert) assignments that the
    MoE layers' capacity drops in one full-width prefill of SCENARIO[0]'s
    prompt (``moe_assignments`` on each MoE layer's input, as the
    prefill's ``apply_moe`` routes it)."""
    import repro_torch.models.layers as layers
    from repro_torch.core.quality import _prompts_for
    from repro_torch.models.transformer import prefill

    tokens, _ = _prompts_for(SCENARIO[0][0], 1, SEQ, SCENARIO[0][2])
    real, kept = layers.apply_moe, []

    def counting(p, c, x):
        kept.append(layers.moe_assignments(p, c, x)[1])
        return real(p, c, x)

    layers.apply_moe = counting
    try:
        prefill(cfg, params, {"tokens": torch.as_tensor(
            tokens, dtype=torch.int32, device=dev)}, SEQ)
    finally:
        layers.apply_moe = real
    total = sum(k.numel() for k in kept)
    dropped = int(sum((~k).sum() for k in kept))
    return dropped, total


def moe_serving_phase(torch, dev):
    """8a: phase 3's serving run with deepseek-moe-16b at full width and
    depth (27 MoE layers of 64 routed experts top-6 and 2 shared, a dense
    first layer): requests, breakdowns, drained page tables, the three
    kernels' launches, the kernel path against the plain path on one
    decode step, one step's host and device times, the prefill's dropped
    share and the peak memory.  Returns the launch counts of the run."""
    torch.cuda.synchronize(dev)           # a context for the memory stats
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg, params = model_setup(torch, dev, MOE_ARCH)
    print(f"phase 8a: {MOE_ARCH}, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads (KV {cfg.kv_heads}), "
          f"{cfg.num_experts} experts top-{cfg.experts_per_token} + "
          f"{cfg.num_shared_experts} shared, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}")
    rt, wall, counts = serve(torch, dev, cfg, params)
    print_requests(rt, wall)
    check_runtime(rt, cfg)
    for r in sorted(rt.completed, key=lambda r: r.rid):
        if not r.pool_hit:
            stages = {k: round(v * 1e3, 2) for k, v in r.breakdown.items()
                      if k != "decode" and v}
            print(f"phase 8a cold rid {r.rid}: TTFT {r.ttft * 1e3:.2f} ms, "
                  f"stages (ms) {stages}")
    launched = {k: counts[op] for k, op in (
        ("quant_pack", "quant_pack_op"), ("dequant_unpack", "dequant_unpack_op"),
        ("paged_attention", "paged_attention_arena_op"))}
    print(f"launches on the phase 8a path: {launched}")
    for k, n in launched.items():
        check(n > 0, f"{k} launched in phase 8a")
    release_arenas(torch, rt)
    err, scale, gap, same = reference_check(torch, rt, cfg, params, dev)
    tol = 2e-2 + 1.6e-2 * scale
    check(err <= tol and (same or gap <= tol),
          "phase 8a: full-width decode through the kernel agrees with the "
          "plain path")
    decode_step_times(torch, dev, cfg, params)
    dropped, total = prefill_drop_share(torch, dev, cfg, params)
    print(f"phase 8a prefill of {SEQ} tokens at capacity_factor "
          f"{cfg.capacity_factor}: {dropped} of {total} (token, expert) "
          f"assignments dropped ({dropped / total:.4f})")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"phase 8a: peak memory {peak:.2f} GiB; "
          f"{time.perf_counter() - t0:.2f} s wall")
    del rt, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# Phase 8c: gemma2-9b on the paged arena.  The runtime serves one prompt
# length a RuntimeConfig (``seq``, in both packages), so the phase serves
# twice: phase 3's scenario at 1,024 tokens, inside the 4,096-position
# window, then three requests at 5,120 tokens, past it (a multiple of the
# prefill's 1,024-position attention chunk), on three slots: 42 layers x
# 8 KV heads x 256 channels x (2 B fp + 1 B code + 4 B scale) x K and V
# is 1.2 MB a position, 18.6 GB for 967 pages of 16 beside 18.5 GB of
# weights.
GEMMA_LONG_SEQ, GEMMA_LONG_SLOTS = 5120, 3
GEMMA_LONG_SCENARIO = [("qalike", "standard", 0, None, 1),
                       ("codelike", "interactive", 1, None, 2),
                       ("qalike", "batch", 0, None, 0)]
GEMMA_VERIFY_LAYERS = 2       # one local and one global layer
GEMMA_VERIFY_SCENARIO = [("codelike", "interactive", 1, None, 0),
                         ("mathlike", "batch", 2, None, 0)]


def serve_recorded(torch, dev, cfg, params, **kw):
    """``serve`` with the model's two arena entries wrapped so that the
    run records the (window, softcap) pairs it launched each with.
    Returns (runtime, wall seconds, launch counts, {entry: pairs})."""
    import repro_torch.models.layers as layers

    seen, real = {}, {}
    for name in ("paged_attention_arena_op",
                 "paged_verify_attention_arena_op"):
        fn = real[name] = getattr(layers, name)
        seen[name] = set()

        def wrapped(*args, window=0, softcap=0.0, _fn=fn, _seen=seen[name],
                    **kwargs):
            _seen.add((window, softcap))
            return _fn(*args, window=window, softcap=softcap, **kwargs)

        setattr(layers, name, wrapped)
    try:
        rt, wall, counts = serve(torch, dev, cfg, params, **kw)
    finally:
        for name, fn in real.items():
            setattr(layers, name, fn)
    return rt, wall, counts, seen


def gemma2_serving_phase(torch, dev):
    """8c: gemma2-9b at full width and depth served PD-separated on the
    paged arena with phase 3's settings, at 1,024-token and at
    5,120-token prompts (past the local layers' 4,096-position window,
    which the kernels then cut); every request completes, breakdowns sum
    to JCT, page tables drain, the three kernels launch, the attention
    entry with the cap on every layer and the window on the local ones;
    the kernel path against the plain path on one decode step of a
    5,120-token prompt (phase 3's gate; the dense gathered view printed
    beside it), one decode step's times and top kernels at 5,120
    positions, cold TTFT stages, peak memory; then a two-layer cut at
    full width served with the two-model draft (``spec_k=4``), which
    must launch the verify entry with the cap and the window.  Returns
    the launch counts of the three runs, summed."""
    from repro_torch.configs import get_config, register
    from repro_torch.models.transformer import init_params

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg, params = model_setup(torch, dev, GEMMA_ARCH)
    print(f"phase 8c: {GEMMA_ARCH}, {cfg.num_layers} layers (window "
          f"{cfg.sliding_window} on every other), d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads (KV {cfg.kv_heads}), head_dim "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, attention cap {cfg.attn_softcap:g}, final "
          f"cap {cfg.final_softcap:g}")
    check((cfg.attn_softcap, cfg.sliding_window) == (GEMMA_CAP, GEMMA_WINDOW),
          "gemma2-9b's cap and window")
    total, runs = {}, (
        ("1,024-token prompts", dict(), (3, 5, 6)),
        (f"{GEMMA_LONG_SEQ:,}-token prompts",
         dict(seq=GEMMA_LONG_SEQ, slots=GEMMA_LONG_SLOTS,
              scenario=GEMMA_LONG_SCENARIO, store_capacity=8 << 30), None))
    for label, kw, hits in runs:
        rt, wall, counts, seen = serve_recorded(torch, dev, cfg, params,
                                                **kw)
        print(f"phase 8c, {label}:")
        print_requests(rt, wall)
        check_runtime(rt, cfg, kw.get("scenario", SCENARIO), hits)
        for r in sorted(rt.completed, key=lambda r: r.rid):
            if not r.pool_hit:
                stages = {k: round(v * 1e3, 2) for k, v in
                          r.breakdown.items() if k != "decode" and v}
                print(f"phase 8c cold rid {r.rid}: TTFT "
                      f"{r.ttft * 1e3:.2f} ms, stages (ms) {stages}")
        pairs = seen["paged_attention_arena_op"]
        print(f"phase 8c, {label}: launches {counts}; paged_attention_arena "
              f"launched with (window, softcap) {sorted(pairs)}")
        check(pairs == {(GEMMA_WINDOW, GEMMA_CAP), (0, GEMMA_CAP)},
              "phase 8c: the arena entry takes the cap on every layer and "
              "the window on the local ones")
        for k in ("quant_pack_op", "dequant_unpack_op",
                  "paged_attention_arena_op"):
            check(counts[k] > 0, f"{k} launched in phase 8c")
        total = {k: total.get(k, 0) + n for k, n in counts.items()}
        release_arenas(torch, rt)
        if hits is None:
            err, scale, gap, same = reference_check(torch, rt, cfg, params,
                                                    dev)
            tol = 2e-2 + 1.6e-2 * scale
            check(err <= tol and (same or gap <= tol),
                  "phase 8c: full-width decode at 5,120 positions through "
                  "the kernel agrees with the plain path")
        del rt
        gc.collect()
        torch.cuda.empty_cache()
    decode_step_times(torch, dev, cfg, params, seq=GEMMA_LONG_SEQ,
                      slots=GEMMA_LONG_SLOTS)
    print(f"phase 8c: peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # the verify path: a full-width two-layer cut, its own draft
    short = register(dataclasses.replace(
        get_config(GEMMA_ARCH), name=f"{GEMMA_ARCH}-{GEMMA_VERIFY_LAYERS}l",
        num_layers=GEMMA_VERIFY_LAYERS))
    params = init_params(short, seed=0, dtype=torch.bfloat16, device=dev)
    spec, wall, counts, seen = serve_recorded(
        torch, dev, short, params, seq=GEMMA_LONG_SEQ, slots=2,
        scenario=GEMMA_VERIFY_SCENARIO, store_capacity=8 << 30,
        spec_k=SPEC_K, spec_kind="model")
    pairs = seen["paged_verify_attention_arena_op"]
    steps = sum(r.verify_steps for r in spec.completed)
    print(f"phase 8c verify: {short.name} at full width, two-model drafts "
          f"(spec_k={SPEC_K}), {len(spec.completed)} requests of "
          f"{GEMMA_LONG_SEQ:,} tokens in {wall:.2f} s wall, {steps} verify "
          f"steps; launches {counts}; paged_verify_attention_arena launched "
          f"with (window, softcap) {sorted(pairs)}")
    check_runtime(spec, short, GEMMA_VERIFY_SCENARIO, ())
    check(steps > 0 and counts["paged_verify_attention_arena_op"] > 0,
          "phase 8c: verify steps through the verify kernel")
    check(pairs == {(GEMMA_WINDOW, GEMMA_CAP), (0, GEMMA_CAP)},
          "phase 8c: the verify entry takes the cap and the window")
    total = {k: total.get(k, 0) + n for k, n in counts.items()}
    release_arenas(torch, spec)
    del spec, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 8c: {time.perf_counter() - t0:.2f} s wall")
    return total


def mla_serving_phase(torch, dev):
    """8d: phase 3's serving run with ``deepseek-v2-lite`` at full width
    and depth (27 layers of multi-head latent attention, 64 routed experts
    top-6 and 2 shared, a dense first layer 10,944 wide): requests,
    drained page tables, the pool hits landed as bf16 latent pages, the
    launches of ``paged_mla_attention`` (the arena's decode read, in the
    replayed graph; ``paged_attention_arena`` none) and of ``quant_pack``
    and ``dequant_unpack``, and the peak memory.  One decode step of a
    served prompt from its wire-restored latent pages through the kernel:
    each layer's read is held against its plain version on the same
    inputs at the card tests' tolerances (``mla_close``).  The step's
    logits against the plain path's are printed, not held: the kernel
    sums in another order than its plain version (within 2 ulps), and
    with seeded weights a last-bit change of a layer's output flips a
    near-tied top-6 expert choice in a later layer, which moves the
    logits by O(1) (phase 8b's routing flips; the benchmark holds the
    served tokens to the f32 reference).  Returns the launch counts of
    the run."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg, params = model_setup(torch, dev, MLA_ARCH)
    print(f"phase 8d: {MLA_ARCH}, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads over a {cfg.kv_lora_rank} "
          f"latent and a {cfg.qk_rope_head_dim} rope key, "
          f"{cfg.num_experts} experts top-{cfg.experts_per_token} + "
          f"{cfg.num_shared_experts} shared, vocab {cfg.vocab_size}")
    rt, wall, counts = serve(torch, dev, cfg, params)
    print_requests(rt, wall)
    check_runtime(rt, cfg)
    for dw in rt.decode_workers:
        check(not dw._quant_len.any(), "phase 8d: no quant-resident pages")
    launched = {k: counts[op] for k, op in (
        ("quant_pack", "quant_pack_op"), ("dequant_unpack", "dequant_unpack_op"),
        ("paged_mla_attention", "paged_mla_attention_op"),
        ("paged_attention", "paged_attention_arena_op"))}
    print(f"launches on the phase 8d path: {launched}")
    for k in ("quant_pack", "dequant_unpack", "paged_mla_attention"):
        check(launched[k] > 0, f"{k} launched in phase 8d")
    check(launched["paged_attention"] == 0,
          "phase 8d: no MHA arena read on the MLA path")
    release_arenas(torch, rt)
    import repro_torch.models.layers as layers
    from repro_torch.kernels import ref

    kernel_op, moe, held, routed = (layers.paged_mla_attention_op,
                                    layers.apply_moe, [], [])

    def recorded(*args):
        got = kernel_op(*args)
        held.append(mla_close(torch, got, ref.paged_mla_attention_ref(*args)))
        return got

    def recording(p, c, x):       # one-token steps: dense, kernel, plain
        if x.shape[1] == 1:
            routed.append((p, x.clone()))
        return moe(p, c, x)

    layers.paged_mla_attention_op, layers.apply_moe = recorded, recording
    try:
        reference_check(torch, rt, cfg, params, dev)
    finally:
        layers.paged_mla_attention_op, layers.apply_moe = kernel_op, moe
    n = len(routed) // 3
    flips = _routing_flips(torch, cfg, {"forward": routed[2 * n:],
                                        "decode": routed[n:2 * n]})
    print(f"phase 8d: routing flips of the step, kernel against plain path "
          f"(layer, experts only the plain path chose, only the kernel's, "
          f"router logit margin in bf16 ulps): {flips}")
    worst = [max(h[i] for h in held) for i in range(3)]
    print(f"phase 8d: {len(held)} layers' paged_mla_attention reads of the "
          f"step against their plain versions on the same inputs: out "
          f"{worst[0]} bf16 ulps at most (tolerance 2), m rel {worst[1]:.3g} "
          f"(1e-5), l rel {worst[2]:.3g} (1e-4)")
    check(len(held) == cfg.num_layers and all(h[3] for h in held),
          "phase 8d: every layer's MLA kernel read agrees with the plain "
          "version")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"phase 8d: peak memory {peak:.2f} GiB; "
          f"{time.perf_counter() - t0:.2f} s wall")
    del rt, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _bf16_ulps_apart(a: float, b: float) -> float:
    """|a - b| in bf16 ulps of the larger magnitude."""
    m = max(abs(a), abs(b))
    return abs(a - b) / 2.0 ** (math.floor(math.log2(m)) - 7) if m else 0.0


def _teacher_forced(torch, cfg, params, batch, dev):
    """The full forward over ``batch`` and a prefill of all but its last
    token, then the last token's decode step.  Returns (the forward's
    logits at that position, the decode step's, the router inputs of the
    decode position in both, ms per prefill, ms per decode step)."""
    import repro_torch.models.layers as layers
    from repro_torch.models import decode_step, forward, prefill

    tokens = batch["tokens"]
    t = tokens.shape[1] - 1
    full = {k: v for k, v in batch.items() if k in ("frames", "patch_embeds")}
    pos = t + (batch["patch_embeds"].shape[1] if "patch_embeds" in batch
               else 0)
    if cfg.mrope:
        full["positions"] = torch.arange(pos + 1, dtype=torch.int32,
                                         device=dev)[None, None].expand(
                                             3, 1, pos + 1)
    pre = dict(full, tokens=tokens[:, :t])
    if cfg.mrope:
        pre["positions"] = full["positions"][..., :pos]
    real, routed, where = layers.apply_moe, {"forward": [], "decode": []}, []

    def recording(p, c, x):       # the decode position's router input
        if where[-1] in routed:
            row = x[:, pos:pos + 1] if where[-1] == "forward" else x
            routed[where[-1]].append((p, row.clone()))
        return real(p, c, x)

    layers.apply_moe = recording
    try:
        with torch.no_grad():
            where.append("forward")
            logits, _ = forward(cfg, params, dict(full, tokens=tokens))
            want = logits[0, pos].float()
            del logits
            where.append("prefill")
            times = []
            for _ in range(2):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                _, caches = prefill(cfg, params, pre, max_len=pos + 1)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            where.append("decode")
            got = decode_step(cfg, params, caches, tokens[:, t:t + 1],
                              pos)[0][0, 0].float()
            where.append("timing")
            steps = []
            for _ in range(3):    # from the step's own cache: timing only
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                decode_step(cfg, params, caches, tokens[:, t:t + 1], pos)
                torch.cuda.synchronize()
                steps.append((time.perf_counter() - t1) * 1e3)
    finally:
        layers.apply_moe = real
    return (want, got, routed, pos, times[-1],
            statistics.median(steps))


def _routing_flips(torch, cfg, routed):
    """The decode position's routing flips between the forward and the
    decode step, MoE layer by MoE layer: (layer, experts only the forward
    chose, experts only the decode chose, the forward's router logit
    margin between them in bf16 ulps)."""
    import repro_torch.models.layers as layers

    flips = []
    for n, ((p, xf), (_, xd)) in enumerate(zip(routed["forward"],
                                               routed["decode"])):
        ids_f = set(layers.moe_route(p, cfg, xf)[2].flatten().tolist())
        ids_d = set(layers.moe_route(p, cfg, xd)[2].flatten().tolist())
        if ids_f == ids_d:
            continue
        logit = layers._einsum_bf16("...d,de->...e", xf,
                                    p["router"]).float().flatten()
        margin = max(_bf16_ulps_apart(float(logit[i]), float(logit[j]))
                     for i in ids_f - ids_d for j in ids_d - ids_f)
        flips.append((n, sorted(ids_f - ids_d), sorted(ids_d - ids_f),
                      margin))
    return flips


def held_depth(cfg) -> int:
    """The depth of 8b's held model: the shortest prefix of the real layer
    stack that has every kind of layer the architecture has (attention or
    mamba mixer, dense MLP or MoE, local or global attention), and at
    least the JAX test's two layers.  jamba: 5 (mamba with and without
    MoE, then its first attention layer); every other: 2."""
    specs = cfg.layer_specs()
    kinds = set(specs)
    n = 2
    while set(specs[:n]) != kinds:
        n += 1
    return n


def family_check(torch, dev, arch):
    """8b for one architecture at full width, MoE at capacity_factor 16
    (nothing drops): a prefill of FAMILY_SEQ positions from
    ``make_inputs`` (whisper's frames, qwen2-vl's vision prefix) and the
    next token's teacher-forced decode step, timed (ms per prefill and
    per decode step) at the depth one card holds (FAMILY_DEPTH), and held
    against the full forward's logits at that position at ``held_depth``:
    atol 0.15 and rtol 0.05 in units of the logits' RMS, finite, and
    equal argmax unless the forward's top two logits lie within the
    runtime tests' near-tie tolerance (printed).  A random stack amplifies the two paths' last-place
    differences with depth, the JAX package's own included (PERF.md
    section 6; ``tests/torch_family_depth.py``), so the deep model's
    deviation is printed, not held.  Where the held one leaves the gate, an MoE router must
    have sent the token elsewhere at a near tie: each flip is printed
    with its margin, which must be at most one bf16 ulp."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, make_inputs

    base = get_config(arch)
    deep = dataclasses.replace(base, num_layers=FAMILY_DEPTH.get(
        arch, base.num_layers))
    gate = dataclasses.replace(base, num_layers=held_depth(base))
    runs = [("timed", deep)]
    if gate.num_layers < deep.num_layers:
        runs.append(("held", gate))
    else:
        runs = [("timed and held", deep)]
    for role, cfg in runs:
        if cfg.moe:
            cfg = dataclasses.replace(cfg, capacity_factor=16.0)
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in _leaves(params))
        t_init = time.perf_counter() - t0
        batch = make_inputs(cfg, "train", seq=FAMILY_SEQ, batch=1, seed=1,
                            device=dev)["batch"]
        want, got, routed, pos, pre_ms, dec_ms = _teacher_forced(
            torch, cfg, params, batch, dev)
        flips = _routing_flips(torch, cfg, routed) if cfg.moe else []
        del params, routed
        gc.collect()
        torch.cuda.empty_cache()
        # the gate in units of the logits' RMS: about 1 for an untied
        # model, as in the JAX test, and about sqrt(d_model) for minicpm's
        # tied unit-variance embedding, whose rounding errors scale with it
        rms = float(want.square().mean().sqrt())
        err = (got - want).abs() / rms
        beyond = int((err > 0.15 + 0.05 * want.abs() / rms).sum())
        same = int(got.argmax()) == int(want.argmax())
        top1, top2 = (float(v) for v in torch.topk(want, 2).values)
        near_tie = top1 - top2 <= 2e-2 + 1.6e-2 * abs(top1)
        print(f"phase 8b {arch} ({role}): {cfg.num_layers} of "
              f"{base.num_layers} layers, {n_params / 1e9:.3f}B bf16 "
              f"parameters in {t_init:.1f} s; prefill of {pos} positions "
              f"{pre_ms:.2f} ms, decode step {dec_ms:.2f} ms; decode vs "
              f"forward max|diff| {float(err.max()) * rms:.4g} (logit RMS "
              f"{rms:.4g}), {beyond} beyond atol 0.15 + rtol 0.05 in RMS "
              f"units, argmax {int(got.argmax())} vs {int(want.argmax())} "
              f"(the forward's top-2 logits {top1:.4g} / {top2:.4g})")
        for n, only_f, only_d, margin in flips:
            print(f"  MoE layer {n}: the forward routes the token to "
                  f"{only_f}, the decode step to {only_d}; router logit "
                  f"margin {margin:.3g} bf16 ulps")
        check(bool(torch.isfinite(got).all()),
              f"phase 8b {arch}: finite logits")
        if role != "timed":
            # a flipped argmax only at a near tie of the forward's top two
            # (the runtime tests' rule: atol 2e-2 + rtol 1.6e-2 of the top)
            check((beyond == 0 and (same or near_tie)) or (
                bool(flips) and all(m <= 1.0 for *_, m in flips)),
                f"phase 8b {arch}: teacher-forced decode equals the forward")


def families_phase(torch, dev):
    """8b: every other assigned architecture, one model at a time."""
    for arch in FAMILY_ARCHS:
        family_check(torch, dev, arch)


# ---------------------------------------------------------------------------
# Phase 9: the multi-card path (the H100 cost report, elastic restore)
# ---------------------------------------------------------------------------
# 9a: the dry-run's cells, (arch, shapes, meshes, extra options); the fake
# 512-rank group needs a process of its own, as the JAX package's dry-run
# does.  The mamba stacks' scan counts one step times its trip count, the
# MoE einsum form's dispatch and combine are each rank's own product, and
# llama3.1-8b's decode_32k on 2x16x16 also counts the compressed
# cross-pod KV migration (4-bit, group 64)
DRYRUNS = (("llama3.1-8b", "train_4k,prefill_32k,decode_32k", "both", ()),
           ("tiny-lm", "train_4k,decode_32k", "both", ()),
           ("falcon-mamba-7b", "train_4k,decode_32k", "both", ()),
           ("jamba-v0.1-52b", "train_4k", "both", ()),
           ("deepseek-moe-16b", "train_4k,prefill_32k", "both", ()),
           ("llama3.1-8b", "decode_32k", "multi", ("--include-transfer",)))
MESHES = {"both": ("16x16", "2x16x16"), "multi": ("2x16x16",)}
# 9b: steps the card runs for real beside the report's terms
DECODE_B, DECODE_LEN, PREFILL_B, PREFILL_LEN = 8, 4096, 1, 4096
REPORT_CALLS = 10             # a run of calls between CUDA events


def start_dryruns():
    """Phase 9a's dry-runs, started on the host's cores once 9b's
    host-bound steps are timed; 9c and phase 10 run beside them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = {}
    for arch, shapes, meshes, extra in DRYRUNS:
        label = arch + "".join(extra)
        path = ROOT / "build" / f"dryrun_{label}.jsonl"
        path.parent.mkdir(parents=True, exist_ok=True)
        # its output goes to a file, which no pipe buffer can stall
        log = path.with_suffix(".log")
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shapes, "--mesh", meshes, "--out",
                 str(path), *extra],
                cwd=str(ROOT), env=env, stdout=f, stderr=subprocess.STDOUT)
        out[label] = (proc, path, log, arch, shapes.split(","),
                      MESHES[meshes])
    return out


def useful_ceiling(arch: str) -> float:
    """The useful ratio's ceiling: 1, except in an attention-free stack,
    where ``model_flops`` (2 FLOPs a token for every parameter) charges
    the embedding tables, whose lookup does no arithmetic, and the step
    does little besides its products (falcon-mamba's decode: 1.03):
    N / (N - the tables' parameters)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if not (cfg.ssm and cfg.attn_period == 0):
        return 1.0
    n = cfg.param_count()
    tables = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return n / (n - tables)


def transfer_shard_bytes(arch: str, shape_name: str, bits: int = 4) -> int:
    """The bytes one device sends in the cross-pod KV migration of a
    decode cell's caches on 2x16x16: ``transfer_wire_bytes`` of each of
    its cache shards (the shapes ``cache_pspecs`` gives), summed."""
    from repro_torch.configs import SHAPES_BY_NAME, get_config
    from repro_torch.distribution.kv_transfer import transfer_wire_bytes
    from repro_torch.distribution.sharding import cache_pspecs
    from repro_torch.models import init_cache
    from repro_torch.models.convert import leaves

    class Mesh:          # what the rules read of the production mesh
        mesh_dim_names, shape = ("pod", "data", "model"), (2, 16, 16)

    import torch
    cfg, shape = get_config(arch), SHAPES_BY_NAME[shape_name]
    caches = init_cache(cfg, shape.global_batch, shape.seq_len,
                        device="meta")
    sizes = dict(zip(Mesh.mesh_dim_names, Mesh.shape))
    total = 0
    for leaf, spec in zip(leaves(caches),
                          leaves(cache_pspecs(caches, Mesh()))):
        local = [d // math.prod(sizes[a] for a in (
            () if e is None else (e,) if isinstance(e, str) else e))
            for d, e in zip(leaf.shape, spec)]
        total += transfer_wire_bytes(
            {"x": torch.empty(local, dtype=leaf.dtype, device="meta")},
            bits)
    return total


def dryrun_phase(dryruns) -> None:
    """Phase 9a: every cell ``[ok]`` on its production meshes, its terms
    printed, ``0 < useful_ratio <= useful_ceiling``; llama3.1-8b's
    decode_32k on 16x16 shows collective bytes (its KV cache is
    sequence-sharded: 8 KV heads on a 16-way model axis); its migration
    on 2x16x16 moves, all over "pod", the bytes of its quantized cache
    shards."""
    for label, (proc, path, log, arch, shapes, meshes) in dryruns.items():
        proc.wait(timeout=600)
        check(proc.returncode == 0,
              f"dry-run of {label} exit {proc.returncode}:\n"
              f"{log.read_text()[-6000:]}")
        rows = [json.loads(line) for line in path.read_text().splitlines()]
        ok = {(r["shape"], r["mesh"]) for r in rows if r["status"] == "ok"}
        check(ok == {(s, m) for s in shapes for m in meshes},
              f"dry-run of {label}: every cell [ok]")
        ceiling = useful_ceiling(arch)
        for r in rows:
            print(f"phase 9a {arch} x {r['shape']} x {r['mesh']}: dominant "
                  f"{r['dominant']}, t_compute {r['t_compute']:.4e} s, "
                  f"t_memory {r['t_memory']:.4e} s, t_collective "
                  f"{r['t_collective']:.4e} s; per device {r['hlo_flops']:.4e} "
                  f"FLOPs, {r['hlo_bytes']:.4e} B, collectives "
                  f"{r['coll_bytes']:.4e} B {r['coll_breakdown']}; useful "
                  f"{r['useful_ratio']:.4f}; {r['mem_per_device'] / 1e9:.3f} "
                  f"GB a device (fits {r['fits_hbm']}); traced in "
                  f"{r['trace_seconds']:.1f} s")
            check(0 < r["useful_ratio"] <= ceiling,
                  f"{arch} {r['shape']} {r['mesh']}: 0 < useful_ratio <= "
                  f"{ceiling:.4f}")
            if (arch, r["shape"], r["mesh"]) == ("llama3.1-8b", "decode_32k",
                                                 "16x16"):
                check(r["coll_bytes"] > 0, "llama3.1-8b decode_32k on 16x16 "
                      "moves collective bytes (sequence-sharded KV)")
            if "transfer" in r:
                x = r["transfer"]
                want = transfer_shard_bytes(arch, r["shape"])
                print(f"phase 9a {arch} x {x['shape']} x {x['mesh']}: "
                      f"collectives {x['coll_bytes']:.4e} B by axis "
                      f"{x['coll_by_axis']} (the quantized shards: {want} "
                      f"B), t_collective {x['t_collective']:.4e} s, "
                      f"t_memory {x['t_memory']:.4e} s")
                check(x["coll_by_axis"] == {"pod": want}
                      and x["coll_bytes"] == want,
                      f"{label}: the migration moves the quantized shards' "
                      f"bytes over pod")
        if "--include-transfer" in label:
            check(any("transfer" in r for r in rows),
                  f"{label}: a transfer report")


# ---------------------------------------------------------------------------
# Phase 10: the six examples/torch_*.py scripts on the card
# ---------------------------------------------------------------------------
EXAMPLES = ("quickstart", "adaptive_bandwidth", "multi_tenant_serving",
            "offline_profiling", "pd_serving_e2e", "train_small")
EXAMPLES_ON_REF = ("multi_tenant_serving", "offline_profiling",
                   "pd_serving_e2e")
# the JAX scripts' sizes and options: offline_profiling's 30 BO
# iterations (cut where the script's time requires), train_small with
# its gradient compression on (``--grad-bits``, an option of the JAX
# script too), whose quantizer runs as quant_pack and dequant_unpack
OFFLINE_ITERS = 30
EXAMPLE_ARGS = {"offline_profiling": ["--max-iters", str(OFFLINE_ITERS)],
                "train_small": ["--grad-bits", "8"]}


def examples_phase(torch, dev, keep_dir: Path):
    """Phase 10: each ``examples/torch_*.py`` run in this process on the
    card at its JAX counterpart's sizes, the three that serve or profile
    the reference model on phase 7a's trained tiny-lm (restored from
    ``keep_dir``); each prints its table, then its seconds and its
    kernel launches.  torch_quickstart must launch hadamard, and
    torch_train_small (8-bit gradient compression) quant_pack and
    dequant_unpack.  Returns the launches summed over the six."""
    import importlib.util

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import init_params

    mgr = CheckpointManager(str(keep_dir))
    cfg = get_config(mgr.metadata()["arch"])
    params = mgr.restore({"params": init_params(cfg, device="meta")},
                         device=dev)["params"]
    total = {}
    for name in EXAMPLES:
        path = ROOT / "examples" / f"torch_{name}.py"
        spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        argv = ["--device", str(dev)] + EXAMPLE_ARGS.get(name, [])
        kw = {"ref": (cfg, params)} if name in EXAMPLES_ON_REF else {}
        print(f"phase 10 {name}: python examples/torch_{name}.py "
              f"{' '.join(argv)}")
        reset_launches()
        t0 = time.perf_counter()
        res = mod.main(argv, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        print(f"phase 10 {name}: {wall:.2f} s wall; launches {counts}")
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        if name == "quickstart":
            # its 4-bit strategy is asymmetric (the JAX script's), so only
            # the Hadamard stage has a kernel; quant_pack is symmetric
            check(counts["hadamard_op"] > 0, "torch_quickstart launched "
                  "hadamard")
            check(all(r["cr"] > 1 and math.isfinite(r["mae"])
                      for r in res["rows"]), "quickstart: CR and error")
        elif name == "adaptive_bandwidth":
            check(len(res) == 5 and all(math.isfinite(r.mean_jct())
                                        for r in res.values()),
                  "adaptive_bandwidth: five policies simulated")
        elif name in ("multi_tenant_serving", "pd_serving_e2e"):
            rt = res["runtime"]
            check(len(rt.completed) == len(res["requests"]) ==
                  {"multi_tenant_serving": 14, "pd_serving_e2e": 20}[name],
                  f"{name}: every request served")
            check(all(abs(sum(r.breakdown.values()) - r.jct) < 1e-9
                      for r in rt.completed),
                  f"{name}: breakdowns sum to JCT")
        elif name == "offline_profiling":
            check(res["profiles"] and res["frontier"] and res["policy"],
                  "offline_profiling: profiles, frontier and policy")
        else:
            losses = res["losses"]
            check(all(math.isfinite(x) for x in losses)
                  and losses[-1] < losses[0], "train_small: the loss falls")
            for k in ("quant_pack_op", "dequant_unpack_op"):
                check(counts[k] > 0, f"torch_train_small launched {k}")
    return total


def report_vs_card(torch, dev) -> None:
    """Phase 9b: llama3.1-8b at full width and depth in bf16 (a decode
    step at B 8 over a 4,096-position dense cache, a prefill of B 1 x
    4,096) and phase 7b's 4-layer train step (f32 masters, 4 x 1,024,
    remat), each timed on the card beside the report of the same step on
    a 1x1 mesh.  No card beats 0.95 x t_compute or 0.95 x the parameters'
    bytes read once over HBM_BW; t_memory / measured is the unfused
    count's over-count (printed, not gated)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distribution.optimizer import OptConfig, init_opt_state
    from repro_torch.distribution.steps import (
        make_decode_step, make_prefill_step, make_train_step)
    from repro_torch.launch.dryrun import one_device_report
    from repro_torch.launch.roofline import HBM_BW
    from repro_torch.models.convert import flatten
    from repro_torch.models.transformer import init_cache, init_params

    def hold(label, cfg, shape, fn, params):
        report = one_device_report(cfg, shape, name=ARCH)
        ms = time_ms(torch, fn, iters=REPORT_CALLS, warmup=1)
        pbytes = sum(p.numel() * p.element_size() for _, p in flatten(params))
        floor_ms = pbytes / HBM_BW * 1e3
        tc, tm = report.t_compute * 1e3, report.t_memory * 1e3
        print(f"phase 9b {label}: measured {ms:.3f} ms a call (CUDA events, "
              f"median of 3 x {REPORT_CALLS}); report on 1x1: "
              f"{report.hlo_flops:.4e} FLOPs, t_compute {tc:.3f} ms, "
              f"t_memory {tm:.3f} ms ({report.hlo_bytes:.4e} B unfused), "
              f"dominant {report.dominant}; parameters read once "
              f"{pbytes / 1e9:.3f} GB = {floor_ms:.3f} ms; measured / "
              f"t_compute {ms / tc:.3f}, t_memory / measured {tm / ms:.3f}, "
              f"achieved {report.hlo_flops / (ms * 1e-3) / 1e12:.1f} "
              f"TFLOP/s")
        check(ms >= 0.95 * tc, f"9b {label}: measured >= 0.95 x t_compute")
        check(ms >= 0.95 * floor_ms,
              f"9b {label}: measured >= 0.95 x the parameter bytes' floor")

    cfg = get_config(ARCH)
    gen = torch.Generator(device=dev).manual_seed(9)
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    with torch.no_grad():
        caches = init_cache(cfg, DECODE_B, DECODE_LEN, device=dev)
        for _, x in flatten(caches):
            x.normal_(generator=gen)
        tokens = torch.randint(0, cfg.vocab_size, (DECODE_B, 1),
                               generator=gen, device=dev, dtype=torch.int32)
        pos = torch.tensor(DECODE_LEN - 1, dtype=torch.int32, device=dev)
        step = make_decode_step(cfg)
        hold(f"decode B {DECODE_B} over {DECODE_LEN} positions", cfg,
             ShapeSpec("decode", "decode", DECODE_LEN, DECODE_B),
             lambda: step(params, caches, tokens, pos), params)
        del caches
        prompt = {"tokens": torch.randint(
            0, cfg.vocab_size, (PREFILL_B, PREFILL_LEN), generator=gen,
            device=dev, dtype=torch.int32)}
        step = make_prefill_step(cfg, max_len=PREFILL_LEN)
        hold(f"prefill B {PREFILL_B} x {PREFILL_LEN}", cfg,
             ShapeSpec("prefill", "prefill", PREFILL_LEN, PREFILL_B),
             lambda: step(params, prompt), params)
    del params, step
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(cfg, num_layers=TRAIN_LAYERS)
    params = init_params(cfg, seed=0, device=dev)
    opt = init_opt_state(params)
    tokens, mask = make_batch("mixed", TRAIN_BATCH, TRAIN_SEQ, seed=7)
    batch = {"tokens": torch.as_tensor(tokens).to(dev),
             "mask": torch.as_tensor(mask[:, 1:]).to(dev)}
    step = make_train_step(cfg, OptConfig(), remat=True)
    hold(f"train step, {TRAIN_LAYERS} layers, {TRAIN_BATCH} x {TRAIN_SEQ}",
         cfg, ShapeSpec("train", "train", TRAIN_SEQ, TRAIN_BATCH),
         lambda: step(params, opt, batch), params)
    del params, opt, step
    torch.cuda.empty_cache()


def restore_phase(keep_dir: Path, loss7a: float) -> None:
    """Phase 9c: phase 7a's model restored in a process of its own, on a
    one-rank NCCL group, as DTensors on a 1x1 ("data", "model") mesh on
    cuda:0 by the port's rules; bit-equal to the saved arrays, and its
    eval loss from the local tensors equal to phase 7a's."""
    with tempfile.TemporaryDirectory() as d:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--restore-check", str(keep_dir), "--pod-init",
             str(Path(d) / "init")], capture_output=True, text=True,
            timeout=300)
    check(proc.returncode == 0, f"restore process exit {proc.returncode}:"
          f"\n{proc.stderr[-4000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    loss = float.fromhex(got["loss"])
    print(f"phase 9c: {got['leaves']} leaves restored as DTensors "
          f"{got['placements']} on {got['device']} over a one-rank NCCL "
          f"group, {got['bit_equal']} bit-equal to the saved arrays; eval "
          f"loss from the local tensors {loss:.9f} (phase 7a {loss7a:.9f})")
    check(got["dtensors"] == got["bit_equal"] == got["leaves"] > 0,
          "every restored leaf a DTensor on the card, bit-equal")
    check(loss == loss7a, "the restored model's eval loss equals phase 7a's "
          "bit for bit")


def restore_main(torch, ckpt_dir: Path, init: str) -> int:
    """Phase 9c's restoring rank (its own process)."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distribution.sharding import tree_shardings
    from repro_torch.distribution.steps import make_eval_step
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.axes import param_axes
    from repro_torch.models.convert import flatten, tree_map
    from repro_torch.models.transformer import init_params

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0,
                            world_size=1)
    mesh = make_test_mesh(data=1, model=1, device_type="cuda")
    mgr = CheckpointManager(str(ckpt_dir))
    cfg = get_config(mgr.metadata()["arch"])
    template = {"params": init_params(cfg, device="meta")}
    shardings = {"params": tree_shardings(param_axes(cfg),
                                          template["params"], mesh)}
    got = mgr.restore(template, shardings=shardings)
    step_dir = ckpt_dir / f"step_{mgr.latest_step():08d}"
    out = {"leaves": 0, "dtensors": 0, "bit_equal": 0,
           "device": str(dev), "placements": set()}
    for i, (_, x) in enumerate(flatten(got)):
        out["leaves"] += 1
        if isinstance(x, DTensor) and x.device.type == "cuda":
            out["dtensors"] += 1
            out["placements"].add(str(tuple(x.placements)))
        saved = np.load(step_dir / f"leaf_{i:05d}.npy")
        host = x.full_tensor().cpu().numpy()
        if host.dtype == saved.dtype and np.array_equal(host, saved):
            out["bit_equal"] += 1
    out["placements"] = sorted(out["placements"])
    local = tree_map(lambda x: x.to_local(), got["params"])
    tokens, mask = make_batch("mixed", 16, 256, seed=EVAL_SEED)
    batch = {"tokens": torch.as_tensor(tokens).to(dev),
             "mask": torch.as_tensor(mask[:, 1:]).to(dev)}
    out["loss"] = float(make_eval_step(cfg)(local, batch)["loss"]).hex()
    dist.destroy_process_group()
    print(json.dumps(out))
    return 0


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
    ap.add_argument("--pod", type=int, default=None,
                    help=argparse.SUPPRESS)   # one pod of phase 7c
    ap.add_argument("--pod-init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--restore-check", type=Path, default=None,
                    help=argparse.SUPPRESS)   # phase 9c's restoring rank
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if args.pod is not None:
        return pod_main(torch, args.pod, args.pod_init)
    if args.restore_check is not None:
        return restore_main(torch, args.restore_check, args.pod_init)
    if args.attention_times is not None:
        sys.path.insert(0, str(args.attention_times))
        from repro_torch.kernels import ops
        print(json.dumps(main_times(torch, dev, ops)))
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.kernels import build

    t_start = time.perf_counter()
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
    results["paged_mla_attention"] = mla_kernel_phase(torch, dev)
    results["decode_attention"], decode_launches = \
        decode_attention_kernel_phase(torch, dev)
    print(f"launches on the decode_attention path (phase 2's cases): "
          f"{decode_launches}")
    check(decode_launches > 0, "decode_attention launched")
    repaired_shapes_phase(torch, dev)
    split_edges_phase(torch, dev)
    family_shapes_phase(torch, dev)
    gemma = window_cap_phase(torch, dev)
    results["paged_attention"]["gemma2"] = gemma["W=1"]
    results["paged_verify_attention"]["gemma2"] = gemma[f"W={SPEC_K + 1}"]
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

    # ---- 4b. the sync census of the serving steps ----
    census_phase(torch, dev, cfg, params)

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

    # ---- 6. trace-driven KV-disaggregated cluster ----
    counts = cluster_phase(torch, dev, cfg, params)
    # the wrapper each kernel's serving path launches it through
    op_of = {"quant_pack": "quant_pack_op",
             "dequant_unpack": "dequant_unpack_op",
             "paged_attention": "paged_attention_arena_op",
             "paged_verify_attention": "paged_verify_attention_arena_op",
             "hadamard": "hadamard_op",
             "decode_attention": "decode_attention_op",
             "paged_mla_attention": "paged_mla_attention_op"}
    phase6 = {k: counts[op] for k, op in op_of.items()}

    # ---- 7. training, checkpoints and the cross-pod paths ----
    del params, rt, spec
    gc.collect()
    torch.cuda.empty_cache()
    print(f"before phase 7: {torch.cuda.memory_allocated(dev) / 2**30:.2f} "
          f"GiB allocated")
    t7 = time.perf_counter()
    keep = tempfile.TemporaryDirectory()      # phase 7a's model, for 9c
    counts7a, loss7a = reference_training(torch, dev, Path(keep.name))
    per_part = [counts7a, full_width_training(torch, dev),
                cross_pod_phase(torch)]
    print(f"phase 7: {time.perf_counter() - t7:.2f} s wall")
    phase7 = {k: sum(c[op] for c in per_part) for k, op in op_of.items()}

    # ---- 8. the other model families ----
    del per_part
    gc.collect()
    torch.cuda.empty_cache()
    print(f"before phase 8: {torch.cuda.memory_allocated(dev) / 2**30:.2f} "
          f"GiB allocated")
    t8 = time.perf_counter()
    counts = moe_serving_phase(torch, dev)
    phase8 = {k: counts[op] for k, op in op_of.items()}
    families_phase(torch, dev)
    counts = gemma2_serving_phase(torch, dev)
    phase8c = {k: counts[op] for k, op in op_of.items()}
    print(f"launches on the phase 8c path: {phase8c}")
    counts = mla_serving_phase(torch, dev)
    phase8d = {k: counts[op] for k, op in op_of.items()}
    launches["paged_mla_attention"] = phase8d["paged_mla_attention"]
    print(f"phase 8: {time.perf_counter() - t8:.2f} s wall")

    # ---- 9. the multi-card path: the H100 cost report, elastic restore ----
    gc.collect()
    torch.cuda.empty_cache()
    t9 = time.perf_counter()
    report_vs_card(torch, dev)
    dryruns = start_dryruns()         # on the host's cores, beside 9c
    try:                              # and phase 10
        restore_phase(Path(keep.name), loss7a)
        print(f"phase 9b-9c: {time.perf_counter() - t9:.2f} s wall")

        # ---- 10. the six examples/torch_*.py scripts ----
        t10 = time.perf_counter()
        counts = examples_phase(torch, dev, Path(keep.name))
        phase10 = {k: counts[op] for k, op in op_of.items()}
        print(f"launches on the phase 10 path: {phase10}")
        print(f"phase 10: {time.perf_counter() - t10:.2f} s wall (beside "
              f"9a's dry-runs)")
        keep.cleanup()
        t9a = time.perf_counter()
        dryrun_phase(dryruns)
        print(f"phase 9a: {time.perf_counter() - t9a:.2f} s more wall "
              f"after phase 10")
    finally:
        for proc, *_ in dryruns.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"phases 9 and 10: {time.perf_counter() - t9:.2f} s wall")

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
        "paged_mla_attention": (
            "src/repro_torch/kernels/csrc/paged_mla_attention.cu", None),
    }
    launches["decode_attention"] = decode_launches
    kernels = []
    for k, (src, replaces) in meta.items():
        entry = {"name": k, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches[k],
                 "phase6_launches": phase6[k], "phase7_launches": phase7[k],
                 "phase8_launches": phase8[k],
                 "phase8c_launches": phase8c[k],
                 "phase8d_launches": phase8d[k],
                 "phase10_launches": phase10[k]}
        entry.update(results[k])
        kernels.append(entry)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall in all")
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
