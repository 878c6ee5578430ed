"""The paged arena's one-token step through its static inputs
(``serving/workers.py::PagedStep``), on the CPU.

A decode worker stages its host state (block tables, quant-resident
lengths, last tokens, positions, live-slot mask) in fixed buffers and
runs the arena call over them; on a CUDA device the call is one captured
CUDA graph, replayed every step (``tests/test_torch_gpu.py`` holds the
replays against the plain step on the card).  Here the step runs eagerly
through the same buffers.  :func:`drive` serves four requests on one
worker across joins (a prefill cache, a quant-resident pool entry
through ``fetch_entry``, a wire-restored KV), a parked slot, a release
that leaves its slot free for two steps, the freed slot's reuse and page
growth across a page boundary.  Seeded random weights: no cached model
is needed."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

STEPS = 20
PARKED = range(6, 10)            # steps at which C is parked
RELEASE, REJOIN = 10, 12         # A leaves before RELEASE, D joins at REJOIN


def _strategy():
    from repro_torch.core.strategy import StrategyConfig
    return StrategyConfig(quantizer="uniform", key_bits=8, value_bits=8,
                          granularity="per_token", symmetric=True,
                          group_size=16)


def drive(cfg, params, dev, seq: int, each, page_size: int = 16,
          n_slots: int = 4, steps: int = STEPS):
    """Serve four requests on one ``DecodeWorker``'s paged arena for
    ``steps`` one-token steps, calling ``each(dw, active, i, named)`` at
    step ``i`` (it runs ``dw.decode_iteration(active)``).  A (landed from
    its prefill cache) and B (landed quant-resident through
    ``fetch_entry``; an MLA model's latent lands as bf16 pages, which no
    kernel reads as codes) join before step 0, C (a wire-restored KV) before
    step 2; C is parked at steps ``PARKED``; A is released before step
    ``RELEASE`` and D joins its free slot before step ``REJOIN``.  Returns
    the worker, its slots released and its pages checked."""
    from repro_torch.configs.base import is_mla
    from repro_torch.core.quality import _jitted_steps, extract_kv
    from repro_torch.serving.workers import (
        DecodeWorker, ModelHandle, RuntimeConfig, Slot, compress_kvs,
        decompress_kvs)

    rcfg = RuntimeConfig(seq=seq, decode_tokens=steps + 4, mode="pd",
                         paged=True, page_size=page_size)
    dw = DecodeWorker(0, ModelHandle(cfg, params, device=dev), rcfg,
                      n_slots, store=None)
    pre, _, _ = _jitted_steps(cfg.name, seq, 1, rcfg.arena_max_len)
    rng = np.random.default_rng(seq)

    def join(rid, how):
        toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (1, seq)),
                               dtype=torch.int32, device=dev)
        logits, caches = pre(params, {"tokens": toks})
        first = int(torch.argmax(logits[0, -1]))
        idx = dw.free_slots.pop()
        if how == "cache":
            dw.copy_from_caches(caches, idx)
        else:
            comps, wire, _ = compress_kvs(
                _strategy(), [extract_kv(cfg, caches, 0, upto=seq)])
            if how == "quant":
                dw.fetch_entry(SimpleNamespace(
                    payload=(comps[0], first, 5e8), kv_bytes=wire), idx)
                assert dw._quant_len[idx] == (0 if is_mla(cfg) else seq)
            else:
                restored, _ = decompress_kvs(comps, device=dev)
                dw.inject_restored(restored[0], idx)
        slot = Slot(req=SimpleNamespace(rid=rid), idx=idx, toks=[first],
                    pool_hit=how == "quant", profile="", wire_bytes=0,
                    breakdown={}, ttft=0.0)
        dw.occupy(slot, first)
        return slot

    named = {"A": join(0, "cache"), "B": join(1, "quant")}
    for i in range(steps):
        if i == 2:
            named["C"] = join(2, "restored")
        if i == RELEASE:
            dw.release(named.pop("A"))
        if i == REJOIN:
            named["D"] = join(3, "cache")
        active = [s for k, s in sorted(named.items())
                  if not (k == "C" and i in PARKED)]
        each(dw, active, i, named)
    for slot in list(named.values()):
        dw.release(slot)
    dw.page_table.check()
    assert dw.page_table.free_pages == dw.page_table.num_pages - 1
    return dw


def _pages(trees):
    """Every pool leaf without its scratch page 0, where parked rows'
    writes land in whichever order the scatter takes."""
    from repro_torch.utils.trees import _leaves
    out = []
    for tree in trees:
        for part in ("prefix", "blocks"):
            for t in _leaves(tree[part]):
                out.append(t[1:] if part == "prefix" else t[:, 1:])
    return out


def held_to_plain_step(cfg, params, dev, seq, page_size=16, step_hook=None):
    """:func:`drive` with every step held against the plain
    ``_paged_steps`` arena call on copies of the worker's pools, fed the
    host state the step starts from: the committed tokens and every
    non-scratch page equal bit for bit.  ``step_hook(dw, i, n)`` sees
    each step's count of paged attention launches
    (``paged_attention_arena_op``, or ``paged_mla_attention_op`` for an
    MLA model).  Returns the worker."""
    from repro_torch.core.quality import _paged_steps
    from repro_torch.kernels import launches

    arena, _ = _paged_steps(cfg.name, page_size)

    def clone(tree):
        return {part: {name: {k: t.clone() for k, t in c.items()}
                       for name, c in tree[part].items()}
                for part in ("prefix", "blocks")}

    def each(dw, active, i, named):
        dw.ensure_arena()
        for s in active:
            dw.page_table.ensure(s.idx, int(dw._positions[s.idx]) + 1)
        mask = np.zeros(dw.n_slots, bool)
        mask[[s.idx for s in active]] = True
        state = [torch.as_tensor(a, device=dev) for a in (
            dw._block_tables(), dw._quant_len.copy(),
            dw._last_tok[:, None].copy(), dw._positions.copy(), mask)]
        pools = [clone(t) for t in (dw._arena, dw._qcodes, dw._qscales)]
        ops = ("paged_attention_arena_op", "paged_mla_attention_op")
        n0 = sum(launches()[op] for op in ops)
        dw.decode_iteration(active)
        n = sum(launches()[op] for op in ops) - n0
        want, _ = arena(params, *pools, *state)
        want = want.cpu().numpy()
        assert [s.toks[-1] for s in active] == [int(want[s.idx])
                                                for s in active], i
        got = _pages((dw._arena, dw._qcodes, dw._qscales))
        assert all(torch.equal(a, b) for a, b in zip(got, _pages(pools))), i
        if step_hook is not None:
            step_hook(dw, i, n)

    return drive(cfg, params, dev, seq, each, page_size=page_size)


@pytest.fixture(scope="module")
def tiny():
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config("tiny-lm")
    return cfg, init_params(cfg, seed=0, device="cpu")


def test_staged_inputs_are_the_host_state_of_each_step(tiny):
    """After each step the static inputs hold what ``_block_tables()``,
    ``_quant_len``, ``_last_tok``, ``_positions`` and the mask gave at
    that step; a released slot's row is back to 0 while it is free."""
    cfg, params = tiny
    rows = {}

    def each(dw, active, i, named):
        pos, tok = dw._positions.copy(), dw._last_tok.copy()
        qlen = dw._quant_len.copy()
        dw.decode_iteration(active)
        st = dw._paged_step
        assert st.graph is None          # the CPU runs the step eagerly
        mask = np.zeros(dw.n_slots, bool)
        mask[[s.idx for s in active]] = True
        want = (dw._block_tables(), qlen, tok[:, None], pos, mask)
        for name, got, w in zip(st.host, st.dev, want):
            assert got.dtype == {"mask": torch.bool}.get(name, torch.int32)
            assert np.array_equal(got.numpy(), w), (i, name)
        if i == RELEASE - 1:
            rows["A"] = named["A"].idx
            assert st.dev[0][rows["A"]].any()
        if RELEASE <= i < REJOIN:
            assert not st.dev[0][rows["A"]].any()
        if i == REJOIN:
            assert named["D"].idx == rows["A"]
            assert st.dev[0][rows["A"]].any()

    seq = 30                             # pages of 8: a boundary at step 2
    dw = drive(cfg, params, torch.device("cpu"), seq, each, page_size=8)
    assert dw._positions.max() >= seq + 2


@pytest.mark.parametrize("arch", ["tiny-lm", "deepseek-moe-16b-reduced",
                                  "gemma2-9b-reduced",
                                  "deepseek-v2-lite-reduced"])
def test_eager_step_through_the_staging_equals_the_plain_step(arch):
    """The worker's step on the CPU (eager, through the static inputs)
    emits the plain arena call's tokens and writes the same pages, at
    every step of :func:`drive`: the dense-then-MoE period of deepseek's
    cut, gemma2's softcap and window 16 crossed by 30-token prompts,
    deepseek-v2-lite's latent and rope pages."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch)
    params = init_params(cfg, seed=0, device="cpu")
    held_to_plain_step(cfg, params, torch.device("cpu"), 30, page_size=8)
