"""Worker abstractions of the disaggregated serving runtime, in PyTorch.

The counterpart of the JAX package's ``serving/workers.py``:

* :class:`PrefillWorker` — one prefill engine: real batch-1 prefills, the
  controller/static profile choice and the compression of the KV it emits
  (on the device through ``quant_pack`` for paged-eligible profiles).
* :class:`DecodeWorker` — one decode engine: a fixed-capacity slot arena,
  dense (one cache tree with a leading slot axis) or paged (page pools
  with per-slot block tables, read in place by the Hopper
  ``paged_attention_arena`` kernel), advanced by ONE masked decode step
  per iteration with one batched host pull; plus its KV tier hierarchy.
  With ``spec_k > 0`` an iteration with drafts is ONE masked multi-token
  verify step instead (the paged arena reads through the Hopper
  ``paged_verify_attention_arena`` kernel).

Both read the model through a shared :class:`ModelHandle`, which loads
the cached reference model on first access unless the caller sets
``cfg``/``params`` — so a runtime built for seeded random weights never
needs the cache.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import cache_parts
from repro_torch.controller import Decision, ServiceAwareController, ServiceContext
from repro_torch.core import codecs
from repro_torch.core.kvcache import PageTable
from repro_torch.core.pipeline import (
    CompressedKV,
    CompressionPipeline,
    DeviceKVCache,
    _clock,
    _sync,
)
from repro_torch.core.profiles import Profile
from repro_torch.core.quality import (
    _jitted_steps,
    _paged_steps,
    copy_cache_slot,
    copy_cache_slot_paged,
    extract_kv,
    init_paged_pools,
    inject_kv,
    inject_kv_paged,
    inject_quant_pages,
)
from repro_torch.core.strategy import StrategyConfig, quant_resident
from repro_torch.serving.kvstore import TierSpec
from repro_torch.serving.request import Request
from repro_torch.utils.timing import count, count_bytes, span
from repro_torch.utils.trees import _leaves


def _select_profile(controller: Optional[ServiceAwareController],
                    static_profile: Optional[Profile],
                    ctx: ServiceContext
                    ) -> Tuple[Profile, Optional[Decision]]:
    """Shared controller / static / identity three-way profile choice."""
    if controller is not None:
        d = controller.select(ctx)
        return d.profile, d
    if static_profile is not None:
        return static_profile, None
    from repro_torch.core.profiles import IDENTITY_PROFILE
    return IDENTITY_PROFILE, None


# ---------------------------------------------------------------------------
# Shared PD codec stages
# ---------------------------------------------------------------------------
def compress_kvs(strategy: StrategyConfig, kvs: Sequence[Any]
                 ) -> Tuple[List[Any], int, float]:
    """Compress each KV prefix for the wire (device KV through the
    pipeline's device stages; the clock waits for its device).  Returns
    ``(payloads, wire_bytes, measured_seconds)``."""
    pipe = CompressionPipeline(strategy)
    devices = {kv.k.device for kv in kvs if isinstance(kv, DeviceKVCache)}
    with span("compress"):
        t0 = _clock(devices)
        comps = [pipe.compress(kv) for kv in kvs]
        t_wall = _clock(devices) - t0
    return comps, sum(c.total_bytes() for c in comps), t_wall


def decompress_kvs(comps: Sequence[CompressedKV], device=None
                   ) -> Tuple[List[Any], float]:
    """Restore wire payloads to KV (paged-eligible and Hadamard payloads
    on ``device``, through ``dequant_unpack`` and ``hadamard``, when one
    is given).  Returns ``(kvs, measured_seconds)``."""
    devices = [] if device is None else [device]
    with span("decompress"):
        t0 = _clock(devices)
        kvs = [CompressionPipeline(c.strategy, device=device).decompress(c)
               for c in comps]
        t_wall = _clock(devices) - t0
    return kvs, t_wall


def quant_entry_arrays(comp: CompressedKV):
    """Unpack a paged-eligible :class:`CompressedKV` into page-pool form:
    ``((k_codes, k_scales), (v_codes, v_scales))`` with codes (L, H, S, D)
    signed int8 and scales (L, H, S, D) per-channel f32 (the stored fp16
    group scale broadcast across its group — numerically identical to the
    grouped multiply, so the fused dequant is bit-for-bit equal to
    ``group_dequantize`` + materialized injection).

    Only valid when ``quant_resident(comp)``: one symmetric per-token
    bucket per tensor, codec "none", no transform, one shape."""
    L, H, S, D = comp.shape
    out = []
    for wires in (comp.k_buckets, comp.v_buckets):
        assert len(wires) == 1, "paged-eligible strategies are single-bucket"
        w = wires[0]
        count = int(np.prod(w.codes_shape))
        codes = codecs.decode_codes(w.payload, w.bits, count,
                                    comp.strategy.codec)
        codes = codes.reshape(w.codes_shape)          # (N, S, D) uint8
        signed = (codes.astype(np.int16)
                  - (1 << (w.bits - 1))).astype(np.int8)
        sc = w.scale.astype(np.float32)[..., 0]       # (N, S, D/group)
        sc = np.repeat(sc, w.group_size, axis=2)[:, :, :D]
        arr = np.zeros((L, H, S, D), np.int8)
        sarr = np.zeros((L, H, S, D), np.float32)
        ls, hs = w.lh_index[:, 0], w.lh_index[:, 1]
        arr[ls, hs] = signed
        sarr[ls, hs] = sc
        out.append((arr, sarr))
    return out[0], out[1]


def recompress_entry(entry, profile: Profile) -> Optional[Tuple[Any, int]]:
    """Tier demotion / refetch-smaller hook: really re-encode a stored
    ``(CompressedKV, first, s_dec)`` payload with ``profile``.  Returns
    None when it would not shrink."""
    comp, first, _ = entry.payload
    if comp.strategy == profile.strategy:
        return None
    restored, _ = decompress_kvs([comp])
    comps, wire, _ = compress_kvs(profile.strategy, restored)
    if wire >= entry.wire_bytes:
        return None
    return (comps[0], first, profile.s_dec), wire


# ---------------------------------------------------------------------------
# Runtime configuration / outcomes (fields and defaults are the JAX
# package's, so a config means the same thing in both)
# ---------------------------------------------------------------------------
@dataclass
class RuntimeConfig:
    seq: int = 96                 # prompt tokens (padded/truncated)
    decode_tokens: int = 12       # generation budget per request
    # "pool" = KV-disaggregated prefix caching; "pd" = PD separation (every
    # cold request's compressed KV crosses the wire on the critical path).
    mode: str = "pool"
    # Virtual-clock cost model.  None = measure wall-clock; a float models
    # a loaded cluster (codec stages then follow V/s_enc, V/s_dec, Eq. 1).
    prefill_tok_s: Optional[float] = None
    decode_tok_s: Optional[float] = None
    pool_fetch_overhead: float = 0.002   # pool RPC setup cost (s)
    store_capacity: int = 64 << 20       # wire bytes (remote/pool tier)
    store_block: int = 16
    # KV memory hierarchy; None builds the mode's default tiers.
    tiers: Optional[Sequence[TierSpec]] = None
    hot_tier_bytes: int = 4 << 20
    dram_tier_bytes: int = 16 << 20
    # PD cold path: False lands the prefill worker's exact cache; True
    # injects the wire-restored KV (quality-faithful decode).
    pd_inject_restored: bool = False
    # Paged decode arena (DESIGN.md §12) and its page size; pick a
    # page_size that divides seq + decode_tokens + 2 for dense parity.
    paged: bool = False
    page_size: int = 16
    # Total pool pages incl. the scratch page 0; None sizes it
    # worst-case-safe: n_slots * ceil(max_len / page_size) + 1.
    arena_pages: Optional[int] = None
    # Speculative + lookahead decoding (DESIGN.md §15).  spec_k = 0 keeps
    # the one-token-per-iteration arena decode; spec_k > 0 turns each
    # iteration into a draft phase (up to k tokens per slot) and ONE
    # masked multi-token verify step.
    spec_k: int = 0
    # Draft source: "ngram" (suffix-match lookahead over prompt + output)
    # or "model" (a draft model's own dense arena; here the target's).
    spec_kind: str = "ngram"
    # True: the controller's per-route accept-rate estimate picks each
    # request's k from spec_candidates (capped at spec_k).
    spec_adaptive: bool = False
    spec_candidates: Tuple[int, ...] = (0, 2, 4)

    @property
    def arena_max_len(self) -> int:
        """Arena row length: seq + decode_tokens + 2 (+ spec_k)."""
        return self.seq + self.decode_tokens + 2 + self.spec_k


@dataclass
class ServedRequest:
    """Per-request outcome of the continuous runtime."""

    rid: int
    workload: str
    slo_class: str
    text: str
    tokens: np.ndarray
    profile: str
    pool_hit: bool
    kv_bytes: int
    wire_bytes: int               # bytes this request moved over the wire
    arrival: float
    done: float
    ttft: float
    slot: int = -1                # arena slot that served the request
    route: str = ""               # "p0->d0"; the slot id is local to d0
    # Critical-path decomposition; sums exactly to jct.
    breakdown: Dict[str, float] = field(default_factory=dict)
    # Off-critical-path pool-write cost (pool mode; 0.0 in PD mode).
    t_pool_write: float = 0.0
    slo_metric: str = "jct"
    t_slo: float = 0.0
    slo_violated: bool = False
    # Speculative-decode outcome (DESIGN.md §15): the k this request ran
    # with, verify steps taken, tokens committed by them, and the draft
    # offer/accept tallies behind the controller's accept-rate feedback.
    spec_k: int = 0
    verify_steps: int = 0
    spec_committed: int = 0
    drafts_offered: int = 0
    drafts_accepted: int = 0

    @property
    def jct(self) -> float:
        return self.done - self.arrival

    @property
    def tokens_per_step(self) -> float:
        if self.verify_steps <= 0:
            return 1.0
        return self.spec_committed / self.verify_steps


@dataclass
class Slot:
    """Host-side bookkeeping for one occupied arena slot."""

    req: Request
    idx: int                      # arena slot index (row in the cache tree)
    toks: List[int]               # generated tokens (incl. first)
    pool_hit: bool
    profile: str
    wire_bytes: int
    breakdown: Dict[str, float]
    ttft: float
    route: str = ""               # placement route ("p0->d1")
    pool_write: float = 0.0       # off-path compress+write cost (misses)
    # Controller feedback deferred to _finish (realized critical path).
    ctx: Optional[ServiceContext] = None
    decision: Optional[Decision] = None
    # Speculative decode state: this slot's draft budget and its running
    # verify/accept tallies.
    spec_k: int = 0
    verify_steps: int = 0
    spec_committed: int = 0
    drafts_offered: int = 0
    drafts_accepted: int = 0


class ModelHandle:
    """Shared mutable reference to the serving model on ``device``.
    Workers read (cfg, params) through it at call time, so a
    runtime-level swap reaches every worker.  Reading either before it is
    set loads the cached reference model."""

    def __init__(self, cfg: Any = None, params: Any = None, device="cuda"):
        self.device = torch.device(device)
        self._cfg = cfg
        self._params = params

    def _load(self) -> None:
        if self._cfg is not None or self._params is not None:
            raise RuntimeError("model handle is half set: set both cfg and "
                               "params, or neither")
        from repro_torch.core.quality import get_reference_model
        self._cfg, self._params = get_reference_model(device=self.device)

    @property
    def cfg(self) -> Any:
        if self._cfg is None:
            self._load()
        return self._cfg

    @cfg.setter
    def cfg(self, value: Any) -> None:
        self._cfg = value

    @property
    def params(self) -> Any:
        if self._params is None:
            self._load()
        return self._params

    @params.setter
    def params(self, value: Any) -> None:
        self._params = value


def codec_cost(cfg: RuntimeConfig, measured: float, nbytes: float,
               speed: float) -> float:
    """Codec stage cost: measured wall-clock, or — under the virtual
    clock — modelled from the profile's throughput (V/s, Eq. 1)."""
    if cfg.prefill_tok_s is None:
        return measured
    return 0.0 if speed == float("inf") else nbytes / speed


# ---------------------------------------------------------------------------
# Prefill worker
# ---------------------------------------------------------------------------
class PrefillWorker:
    """One prefill engine of the cluster: runs real batch-1 prefills,
    selects/compresses the KV it ships, and carries the codec-cost model.
    Requests placed on the same worker within an iteration serialize on it
    (the caller threads the ``busy`` offset); distinct workers overlap."""

    def __init__(self, wid: int, model: ModelHandle, cfg: RuntimeConfig,
                 controller: Optional[ServiceAwareController] = None,
                 static_profile: Optional[Profile] = None):
        self.wid = wid
        self.name = f"p{wid}"
        self.model = model
        self.cfg = cfg
        self.controller = controller
        self.static_profile = static_profile
        self._ewma_prefill: Optional[float] = None
        self._pre1 = None

    # ------------------------------------------------------------------
    def _prefill_fn(self):
        if self._pre1 is None:
            self._pre1, _, _ = _jitted_steps(
                self.model.cfg.name, self.cfg.seq, 1, self.cfg.arena_max_len)
        return self._pre1

    def expected_prefill_s(self, ctx_tokens: int) -> float:
        """The router's estimate of this worker's prefill time: exact
        under the virtual clock, EWMA of measured wall-clock otherwise."""
        if self.cfg.prefill_tok_s:
            return ctx_tokens / self.cfg.prefill_tok_s
        return self._ewma_prefill if self._ewma_prefill is not None else 0.0

    # ------------------------------------------------------------------
    def prefill(self, req: Request, tokens: np.ndarray):
        """Real batch-1 prefill.  Returns ``(caches, first_token,
        t_prefill)`` with ``t_prefill`` under the configured cost model.
        Requests carry text prompts only, so an encoder-decoder model
        (whose prefill needs audio frames) is refused, as the JAX
        package's runtime fails on it."""
        if self.model.cfg.encoder_decoder:
            raise NotImplementedError(
                f"{self.model.cfg.name}: the runtime serves text prompts; an "
                "encoder-decoder model needs audio frames")
        with span("prefill"):
            pre1 = self._prefill_fn()
            dev = self.model.device
            # lint: sync-ok(prefill: the prompt goes to the device once per cold request)
            batch = {"tokens": torch.as_tensor(np.asarray(tokens)[None, :],
                                               dtype=torch.int32, device=dev)}
            t0 = time.perf_counter()
            logits, caches = pre1(self.model.params, batch)
            _sync(dev)
            t_wall = time.perf_counter() - t0
            t_prefill = (req.ctx_tokens / self.cfg.prefill_tok_s
                         if self.cfg.prefill_tok_s else t_wall)
            self._ewma_prefill = t_wall if self._ewma_prefill is None \
                else 0.7 * self._ewma_prefill + 0.3 * t_wall
            # lint: sync-ok(one first-token pull per prefill seeds the decode slot)
            first = int(torch.argmax(logits[:, -1, :], dim=-1).cpu()[0])
        return caches, first, t_prefill

    # ------------------------------------------------------------------
    def select_and_compress(self, req: Request, caches, t_prefill: float,
                            bandwidth: float, slo_default: str,
                            route: str = ""):
        """Controller decision + real compression of the prefix KV (left
        on the device; paged-eligible profiles quantize there).  Returns
        ``(comp, ctx, decision, profile, t_compress)``."""
        with span("extract"):
            kv = extract_kv(self.model.cfg, caches, 0, upto=self.cfg.seq)
            for name, part in zip(cache_parts(self.model.cfg), (kv.k, kv.v)):
                count_bytes(f"kv_part_bytes.{name}", part)
        with span("select"):
            t_decode = (req.out_tokens / self.cfg.decode_tok_s
                        if self.cfg.decode_tok_s else 0.0)
            ctx = ServiceContext(
                workload=req.workload, bandwidth=bandwidth,
                t_slo=req.t_slo, q_min=req.q_min, t_model=t_prefill,
                kv_bytes=kv.nbytes_wire(),
                slo_metric=req.resolved_slo_metric(slo_default),
                route=route, decode_time=t_decode)
            profile, decision = _select_profile(self.controller,
                                                self.static_profile, ctx)
        comps, _, t_wall = compress_kvs(profile.strategy, [kv])
        t_compress = codec_cost(self.cfg, t_wall, kv.nbytes_wire(),
                                profile.s_enc)
        return comps[0], ctx, decision, profile, t_compress


# ---------------------------------------------------------------------------
# The paged arena's one-token step at fixed addresses
# ---------------------------------------------------------------------------
class PagedStep:
    """A decode worker's paged one-token step over static inputs.

    The step reads the worker's host state through five fixed buffers,
    in the arena call's order: block tables (n_slots, PPS) int32,
    quant-resident lengths (n_slots,) int32, last tokens (n_slots, 1)
    int32, positions (n_slots,) int32 and the live-slot mask (n_slots,)
    bool.  Each is a host tensor (pinned on CUDA; ``host`` holds numpy
    views of them for the worker to write) and a device tensor that
    :meth:`stage` copies it into without a sync.

    On a CUDA device :meth:`ready` captures the arena call once as one
    CUDA graph and :meth:`run` replays it: the same kernels in the same
    order on the same data, enqueued by one launch.  The graph bakes in
    the addresses of the params, the pools and the buffers, so it is
    tied to the tensors it captured (held by weak reference, so it does
    not keep a released arena alive) and to the step function: when any
    of them is rebound, :meth:`ready` captures again.  On the CPU the
    step runs eagerly through the same buffers."""

    WARMUP = 3      # eager runs on a side stream before a capture

    def __init__(self, n_slots: int, pps: int, device):
        self.device = torch.device(device)
        pin = self.device.type == "cuda"
        specs = (("bt", (n_slots, pps), torch.int32),
                 ("quant_len", (n_slots,), torch.int32),
                 ("tokens", (n_slots, 1), torch.int32),
                 ("pos", (n_slots,), torch.int32),
                 ("mask", (n_slots,), torch.bool))
        self._host = [torch.zeros(shape, dtype=dt, pin_memory=pin)
                      for _, shape, dt in specs]
        self.dev = [torch.zeros(shape, dtype=dt, device=self.device)
                    for _, shape, dt in specs]
        self.host = {name: t.numpy()
                     for (name, _, _), t in zip(specs, self._host)}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Optional[torch.Tensor] = None
        self._fn: Any = None
        self._refs: List[Any] = []
        self._launches: List[Tuple[Any, int]] = []

    def stage(self) -> None:
        """Copy the host buffers to the device, on the current stream."""
        for dev, host in zip(self.dev, self._host):
            dev.copy_(host, non_blocking=True)

    def ready(self, fn, params, pool, qcodes, qscales) -> None:
        """On CUDA, capture ``fn`` over these trees unless the graph
        already holds exactly them."""
        if self.device.type != "cuda":
            return
        leaves = list(_leaves((params, pool, qcodes, qscales)))
        if (self.graph is not None and fn is self._fn
                and len(leaves) == len(self._refs)
                and all(r() is t for r, t in zip(self._refs, leaves))):
            return
        self._capture(fn, (params, pool, qcodes, qscales, *self.dev))
        self._fn = fn
        self._refs = [weakref.ref(t) for t in leaves]

    def _capture(self, fn, args) -> None:
        from repro_torch.kernels.ops import KERNEL_OPS

        self.graph = self._out = None
        with torch.cuda.device(self.device):
            # Every row parked (mask False, block table 0): the warm-up's
            # and the capture's scatters all land on the scratch page.
            for t in self.dev:
                t.zero_()
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                for _ in range(self.WARMUP):
                    fn(*args)
            main.wait_stream(side)
            before = [op.launches for op in KERNEL_OPS]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out, pool = fn(*args)
        if pool is not args[1]:
            raise RuntimeError("the arena step rebound its pool; a graph "
                               "of it cannot replay in place")
        # A capture runs nothing: each wrapper's count of it is moved onto
        # the replays, so a launch counter still counts what ran.
        self._launches = [(op, op.launches - n)
                          for op, n in zip(KERNEL_OPS, before)
                          if op.launches != n]
        for op, n in zip(KERNEL_OPS, before):
            op.launches = n
        self.graph, self._out = graph, out
        count("decode_graph_capture", 1)

    def run(self, fn, params, pool, qcodes, qscales):
        """One step over the staged inputs: the graph's replay after
        :meth:`ready` on CUDA, else ``fn`` itself.  Returns (next tokens
        (n_slots,), pool)."""
        if self.graph is None:
            return fn(params, pool, qcodes, qscales, *self.dev)
        self.graph.replay()
        for op, n in self._launches:
            op.launches += n
        count("decode_graph_replay", 1)
        return self._out, pool


# ---------------------------------------------------------------------------
# Decode worker
# ---------------------------------------------------------------------------
class DecodeWorker:
    """One decode engine of the cluster: a fixed-capacity slot arena
    (leading axis ``n_slots``), a LIFO local slot-id pool, and the
    worker's decode-side KV tier hierarchy."""

    def __init__(self, wid: int, model: ModelHandle, cfg: RuntimeConfig,
                 n_slots: int, store: Any):
        self.wid = wid
        self.name = f"d{wid}"
        self.model = model
        self.cfg = cfg
        self.n_slots = n_slots
        self.store = store
        self.max_len = cfg.arena_max_len
        self.slots: Dict[int, Slot] = {}
        # LIFO so a hot slot's cache row is reused first.
        self.free_slots: List[int] = list(range(n_slots))[::-1]
        self._dec_arena = None
        self._arena: Any = None          # cache tree, leading axis n_slots
        self._positions = np.zeros(n_slots, np.int32)  # next write pos
        self._last_tok = np.zeros(n_slots, np.int32)   # last emitted tok
        # Paged-arena state (cfg.paged): the fp pool replaces the dense
        # arena in self._arena; the parallel quant pools hold pages valid
        # per slot below its _quant_len watermark.
        self.page_table: Optional[PageTable] = None
        self._qcodes: Any = None
        self._qscales: Any = None
        self._quant_len = np.zeros(n_slots, np.int32)
        # Speculative decode state: the draft proposer (built when a
        # speculative slot first lands) and the verify step per width.
        self._draft: Any = None
        self._verify_fns: Dict[int, Any] = {}
        # The paged one-token step's static inputs (and, on CUDA, its
        # graph), built on the first paged step.
        self._paged_step: Optional[PagedStep] = None

    @property
    def _pps(self) -> int:
        """Block-table row length: pages per worst-case slot."""
        return -(-self.max_len // self.cfg.page_size)

    # ------------------------------------------------------------------
    @property
    def free_slot_count(self) -> int:
        return len(self.free_slots)

    @property
    def occupancy(self) -> int:
        return len(self.slots)

    # ------------------------------------------------------------------
    def ensure_arena(self):
        if self._arena is None:
            from repro_torch.models.transformer import init_cache, plan_stack
            plan = plan_stack(self.model.cfg)
            if any(s.kind != "attn"
                   for s in plan.prefix_specs + plan.period_specs):
                raise NotImplementedError(
                    "slot arena masking assumes attention-only caches")
            dev = self.model.device
            if self.cfg.paged:
                num_pages = (self.cfg.arena_pages
                             or self.n_slots * self._pps + 1)
                self.page_table = PageTable(num_pages, self.cfg.page_size)
                # Per-channel scale layout (group=1): any strategy group
                # maps onto it by broadcasting its group scale.
                self._arena, self._qcodes, self._qscales = init_paged_pools(
                    self.model.cfg, num_pages, self.cfg.page_size, group=1,
                    device=dev)
            else:
                self._arena = init_cache(self.model.cfg, self.n_slots,
                                         self.max_len, device=dev)
        return self._arena

    def _arena_fn(self):
        if self._dec_arena is None:
            if self.cfg.paged:
                self._dec_arena, _ = _paged_steps(self.model.cfg.name,
                                                  self.cfg.page_size)
            else:
                _, _, self._dec_arena = _jitted_steps(
                    self.model.cfg.name, self.cfg.seq, self.n_slots,
                    self.max_len)
        return self._dec_arena

    # ------------------------------------------------------------------
    def _block_tables(self, out: Optional[np.ndarray] = None) -> np.ndarray:
        """Every slot's block-table row, 0 past its owned pages (and
        for a free slot), written over ``out`` when given."""
        bt = np.empty((self.n_slots, self._pps), np.int32) if out is None \
            else out
        bt.fill(0)
        for s, owned in self.page_table.pages.items():
            bt[s, :len(owned)] = owned
        return bt

    def copy_from_caches(self, caches, idx: int) -> None:
        """Materialize arena row ``idx`` from a prefill worker's batch-1
        cache (the cold path's slot hand-off)."""
        with span("inject"):
            self.ensure_arena()
            if self.cfg.paged:
                self.page_table.ensure(idx, self.cfg.seq)
                row = self.page_table.block_row(idx, self._pps)
                self._arena = copy_cache_slot_paged(
                    self.model.cfg, self._arena, caches, row,
                    self.cfg.page_size)
                self._quant_len[idx] = 0
                return
            self._arena = copy_cache_slot(self.model.cfg, self._arena,
                                          caches, idx)

    def inject_restored(self, kv, idx: int) -> None:
        """Materialize arena row ``idx`` from a wire-restored KV."""
        with span("inject"):
            self.ensure_arena()
            if self.cfg.paged:
                self.page_table.ensure(idx, kv.seq)
                row = self.page_table.block_row(idx, self._pps)
                self._arena = inject_kv_paged(self.model.cfg, self._arena,
                                              row, kv, self.cfg.page_size)
                self._quant_len[idx] = 0
                return
            self._arena = inject_kv(self.model.cfg, self._arena, idx, kv)

    def fetch_entry(self, entry, idx: int) -> Tuple[int, float]:
        """Land a stored pool entry in arena slot ``idx``.  Returns
        ``(first_token, t_decompress)``.

        Paged arena + paged-eligible stored strategy: the codes and fp16
        group scales scatter STRAIGHT into the quantized page pools — no
        fp16 materialization, so the decompress stage leaves the TTFT
        critical path (the fused dequant runs inside decode attention;
        under the virtual clock the remaining adapter cost models as
        V/inf = 0).  Everything else decompresses (on the device for
        paged-eligible strategies) and injects fp pages/rows."""
        comp, first, s_dec = entry.payload
        if (self.cfg.paged and isinstance(comp, CompressedKV)
                and quant_resident(comp)):
            t0 = time.perf_counter()
            (kc, ks), (vc, vs) = quant_entry_arrays(comp)
            self.ensure_arena()
            seq = comp.shape[2]
            self.page_table.ensure(idx, seq)
            row = self.page_table.block_row(idx, self._pps)
            self._qcodes, self._qscales = inject_quant_pages(
                self.model.cfg, self._qcodes, self._qscales, row,
                kc, ks, vc, vs, seq, self.cfg.page_size)
            self._quant_len[idx] = seq
            _sync(self.model.device)
            t_wall = time.perf_counter() - t0
            return int(first), codec_cost(self.cfg, t_wall,
                                          entry.kv_bytes, float("inf"))
        restored, t_wall = decompress_kvs([comp], device=self.model.device)
        t_decompress = codec_cost(self.cfg, t_wall, entry.kv_bytes, s_dec)
        self.inject_restored(restored[0], idx)
        return int(first), t_decompress

    # ------------------------------------------------------------------
    def draft(self):
        """The worker's draft proposer (cfg.spec_kind), built lazily."""
        if self._draft is None:
            from repro_torch.serving.speculative import ModelDraft, NGramDraft
            if self.cfg.spec_kind == "model":
                self._draft = ModelDraft(self.model, self.cfg.seq,
                                         self.n_slots, self.max_len)
            else:
                self._draft = NGramDraft()
        return self._draft

    def _verify_fn(self, width: int):
        """The multi-token verify step for ``width``, built once per
        speculation width."""
        fn = self._verify_fns.get(width)
        if fn is None:
            from repro_torch.core.quality import (
                _paged_verify_steps,
                _verify_steps,
            )
            if self.cfg.paged:
                fn = _paged_verify_steps(self.model.cfg.name,
                                         self.cfg.page_size, width)
            else:
                fn = _verify_steps(self.model.cfg.name, self.max_len, width)
            self._verify_fns[width] = fn
        return fn

    def occupy(self, slot: Slot, first: int,
               prompt: Optional[Sequence[int]] = None) -> None:
        self.slots[slot.req.rid] = slot
        self._positions[slot.idx] = self.cfg.seq
        self._last_tok[slot.idx] = first
        if slot.spec_k > 0 and prompt is not None:
            self.draft().start(slot.idx, slot.req.rid, prompt, first)

    def release(self, slot: Slot) -> None:
        self.free_slots.append(slot.idx)
        del self.slots[slot.req.rid]
        if self.cfg.paged and self.page_table is not None:
            self.page_table.release(slot.idx)
            self._quant_len[slot.idx] = 0
        if slot.spec_k > 0 and self._draft is not None:
            self._draft.stop(slot.idx, slot.req.rid)

    # ------------------------------------------------------------------
    def decode_iteration(self, active: List[Slot]) -> float:
        """Advance every slot in ``active`` with a SINGLE masked arena call
        and one batched host pull.  Without speculation (or when no slot
        has a draft this round) that is the one-token decode step.  With
        drafts it is ONE multi-token verify step: each slot commits the
        longest draft prefix the target would have emitted plus the bonus
        token (DESIGN.md §15), 1..width tokens per slot.  Returns the
        measured wall seconds.  The one-token step is traced in four spans
        that tile it: ``prepare`` (page growth and the host state's copies
        to the device), ``launch`` (the arena call's enqueue: on a paged
        arena on CUDA, the replay of its graph, :class:`PagedStep`),
        ``pull`` (the token pull, the step's one sync) and ``commit``."""
        with span("decode_iteration"):
            count("decode_slots", len(active))
            proposals: Dict[int, List[int]] = {}
            if self.cfg.spec_k > 0:
                spec = [s for s in active if s.spec_k > 0]
                if spec:
                    items = [(s.idx, s.req.rid, int(self._last_tok[s.idx]),
                              int(self._positions[s.idx])) for s in spec]
                    budgets = {s.idx: s.spec_k for s in spec}
                    proposals = {
                        i: d for i, d in
                        self.draft().propose_all(items, budgets).items()
                        if d}
            if proposals:
                return self._verify_iteration(active, proposals)
            dev = self.model.device

            def dev_t(a):
                # lint: sync-ok(the dense arena's three host-state copies a step; the paged step stages its inputs in pinned buffers)
                return torch.as_tensor(a, device=dev)

            with span("prepare"):
                mask = np.zeros(self.n_slots, bool)
                for slot in active:
                    mask[slot.idx] = True
                dec = self._arena_fn()
                self.ensure_arena()
                if self.cfg.paged:
                    # Grow each live slot to cover this step's write
                    # position — the on-demand allocation that replaces
                    # worst-case sizing.
                    for slot in active:
                        self.page_table.ensure(
                            slot.idx, int(self._positions[slot.idx]) + 1)
                    step = self._paged_step
                    if step is None:
                        step = self._paged_step = PagedStep(
                            self.n_slots, self._pps, dev)
                    step.ready(dec, self.model.params, self._arena,
                               self._qcodes, self._qscales)
                    t0 = time.perf_counter()
                    # The host state goes through the step's pinned
                    # buffers, copied without a sync.  Rewriting them is
                    # safe: the previous step ended in its token pull, so
                    # no copy out of them is still in flight.
                    h = step.host
                    self._block_tables(out=h["bt"])
                    h["quant_len"][:] = self._quant_len
                    h["tokens"][:, 0] = self._last_tok
                    h["pos"][:] = self._positions
                    h["mask"][:] = mask
                    step.stage()
                else:
                    t0 = time.perf_counter()
                    state = (dev_t(self._last_tok[:, None]),
                             dev_t(self._positions), dev_t(mask))
            with span("launch"):
                if self.cfg.paged:
                    nxt, self._arena = step.run(
                        dec, self.model.params, self._arena, self._qcodes,
                        self._qscales)
                else:
                    nxt, self._arena = dec(self.model.params, self._arena,
                                           *state)
            with span("pull"):
                # lint: sync-ok(the step's single sanctioned sync - one batched pull)
                nxt = np.asarray(nxt.cpu())
            wall = time.perf_counter() - t0
            with span("commit"):
                for slot in active:
                    t = int(nxt[slot.idx])
                    slot.toks.append(t)
                    self._last_tok[slot.idx] = t
                    self._positions[slot.idx] += 1
                    if slot.spec_k > 0 and self._draft is not None:
                        self._draft.commit(slot.idx, slot.req.rid, [t])
        return wall

    def _verify_iteration(self, active: List[Slot],
                          proposals: Dict[int, List[int]]) -> float:
        """One masked multi-token verify step over the arena.  Every
        active slot rides along at its own draft length (no drafts = a
        plain one-token step inside the wide call); rejected draft
        positions never advance a slot and, paged, their over-ensured
        tail pages are rolled back before the pages can leak."""
        from repro_torch.serving.speculative import accept_length
        width = max(len(d) for d in proposals.values()) + 1
        mask = np.zeros(self.n_slots, bool)
        toks = np.zeros((self.n_slots, width), np.int32)
        for slot in active:
            mask[slot.idx] = True
            toks[slot.idx, 0] = self._last_tok[slot.idx]
            for j, d in enumerate(proposals.get(slot.idx, [])):
                toks[slot.idx, 1 + j] = d
        fn = self._verify_fn(width)
        self.ensure_arena()
        dev = self.model.device

        def dev_t(a):
            # lint: sync-ok(five host-state copies per verify step - CUDA-graph capture must stage them in pinned buffers)
            return torch.as_tensor(a, device=dev)

        if self.cfg.paged:
            # Ensure through the worst-case commit (all drafts accepted);
            # the rejected tail is released again right after the verify.
            for slot in active:
                need = (int(self._positions[slot.idx]) + 1
                        + len(proposals.get(slot.idx, [])))
                self.page_table.ensure(slot.idx, need)
            t0 = time.perf_counter()
            out, self._arena = fn(
                self.model.params, self._arena, self._qcodes,
                self._qscales, dev_t(self._block_tables()),
                dev_t(self._quant_len), dev_t(toks),
                dev_t(self._positions), dev_t(mask))
        else:
            t0 = time.perf_counter()
            out, self._arena = fn(
                self.model.params, self._arena, dev_t(toks),
                dev_t(self._positions), dev_t(mask))
        # lint: sync-ok(the step's single sanctioned sync - one batched pull)
        out = np.asarray(out.cpu())
        wall = time.perf_counter() - t0
        for slot in active:
            drafts = proposals.get(slot.idx, [])
            row = out[slot.idx]
            a = accept_length(drafts, row)
            needed = slot.req.out_tokens + 1 - len(slot.toks)
            c = min(a + 1, max(needed, 1))
            committed = [int(row[j]) for j in range(c)]
            slot.toks.extend(committed)
            self._last_tok[slot.idx] = committed[-1]
            self._positions[slot.idx] += c
            slot.verify_steps += 1
            slot.spec_committed += c
            slot.drafts_offered += len(drafts)
            slot.drafts_accepted += min(a, c - 1)
            if slot.spec_k > 0 and self._draft is not None:
                self._draft.commit(slot.idx, slot.req.rid, committed)
            if self.cfg.paged and drafts:
                self.page_table.release_tail(
                    slot.idx, int(self._positions[slot.idx]))
        return wall
