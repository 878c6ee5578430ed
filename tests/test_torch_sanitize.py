"""The port's KV sanitizer (``repro_torch.analysis.sanitize``) on the
port's own classes.

* The eleven cases of ``tests/test_sanitize.py``: each seeded fault
  (double-release, use-after-release, pages leaked at drain, a clobber of
  a cluster-shared tier) raises with its ``kind``, each clean lifecycle
  stays silent, and install / uninstall behave.
* The port's runtimes under it: the pinned paged scenario in pool and pd
  mode and phase 6's 2x2 pool cluster at tiny-lm size run clean and end
  with every page table drained; a release path seeded to skip its pages
  is caught.
* Each package's sanitizer patches its own classes only.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import sanitize  # noqa: E402
from repro_torch.core.kvcache import PageTable  # noqa: E402
from repro_torch.serving.kvstore import (  # noqa: E402
    KVTier,
    PrefixKVStore,
    TierSpec,
    TieredKVStore,
)

from test_torch_cluster import (  # noqa: E402,F401
    one_thread,
    port_kv_sanitizer,
    port_model,
)

KEY = tuple(range(16))


@pytest.fixture
def san():
    """Install the port's sanitizer for one test (idempotent with a
    module-level install under REPRO_SANITIZE=1)."""
    was = sanitize.enabled()
    sanitize.install()
    yield sanitize
    if not was:
        sanitize.uninstall()


def _shared_tiered(san):
    shared = KVTier(TierSpec("remote", 1 << 20), block=16)
    shared.shared = True
    ts = TieredKVStore([TierSpec("hbm", 1 << 20), shared], block=16)
    assert ts.put(KEY, "payload", 100, now=0.0, tier=1) == 1
    return ts


# ---------------------------------------------------------------------------
# tests/test_sanitize.py, on the port's classes
# ---------------------------------------------------------------------------
def test_double_release_caught(san):
    pt = PageTable(8, 16)
    pt.ensure(3, 32)
    pt.release(3)
    with pytest.raises(san.SanitizerError) as ei:
        pt.release(3)
    assert ei.value.kind == "double-release"


def test_use_after_release_caught(san):
    pt = PageTable(8, 16)
    pt.ensure(2, 16)
    pt.release(2)
    with pytest.raises(san.SanitizerError) as ei:
        pt.block_row(2, 4)
    assert ei.value.kind == "use-after-release"


def test_slot_reuse_is_clean(san):
    pt = PageTable(8, 16)
    for _ in range(3):
        pt.ensure(1, 32)
        assert pt.block_row(1, 4)[0] != 0
        pt.release(1)
    pt.ensure(1, 16)
    pt.block_row(1, 4)
    pt.check()


def test_leaked_pages_at_drain_caught(san):
    pt = PageTable(8, 16)
    pt.ensure(1, 48)
    with pytest.raises(san.SanitizerError) as ei:
        san.check_drained(pt)
    assert ei.value.kind == "leaked-pages"
    assert "slot 1" in str(ei.value)


def test_drain_check_respects_live_slots(san):
    pt = PageTable(8, 16)
    pt.ensure(1, 16)
    san.check_drained(pt, live_slots=[1])
    pt.release(1)
    san.check_drained(pt)


def test_shared_tier_clobber_caught(san):
    ts = _shared_tiered(san)
    with pytest.raises(san.SanitizerError) as ei:
        ts.tiers[1].store.discard(KEY)
    assert ei.value.kind == "shared-clobber"


def test_copy_promotion_out_of_shared_tier_is_clean(san):
    ts = _shared_tiered(san)
    hit = ts.lookup(KEY, now=1.0)
    assert hit is not None and hit.tier.shared
    ts.fetch(hit, ready=1.0)
    assert ts.tiers[1].store.contains(KEY, now=1.0)
    assert ts.tiers[0].store.contains(KEY, now=1.0)
    assert ts.stats.promotions == 1


def test_local_refresh_skips_shared_tier(san):
    ts = _shared_tiered(san)
    ts.put(KEY, "refresh", 120, now=2.0)
    assert ts.tiers[1].store.contains(KEY, now=2.0)


def test_guard_follows_store_swap(san):
    tier = KVTier(TierSpec("remote", 1 << 20), block=16)
    tier.shared = True
    tier.store = PrefixKVStore(1 << 20, block=16)
    tier.store.put(KEY, "p", 10)
    with pytest.raises(san.SanitizerError):
        tier.store.discard(KEY)


def test_uninstall_restores_originals():
    was = sanitize.enabled()
    sanitize.install()
    if not was:
        sanitize.uninstall()
        pt = PageTable(8, 16)
        pt.ensure(1, 16)
        pt.release(1)
        assert pt.release(1) == 0
    else:
        assert sanitize.enabled()


def test_install_is_idempotent(san):
    before = sanitize._orig["PageTable.release"]
    sanitize.install()
    assert sanitize._orig["PageTable.release"] is before


# ---------------------------------------------------------------------------
# The port's runtimes under the port's sanitizer
# ---------------------------------------------------------------------------
def _drained(rt):
    for dw in rt.decode_workers:
        sanitize.check_drained(dw.page_table)
        assert dw.page_table.free_pages == dw.page_table.num_pages - 1


@pytest.mark.parametrize("mode", ["pool", "pd"])
def test_pinned_paged_scenario_is_clean(san, port_model, mode):
    from _runtime_scenario import run_scenario
    from test_torch_runtime import _build
    rt = _build("repro_torch", mode, True, "per_token_int8", port_model,
                device="cpu")
    with one_thread():
        out = run_scenario(rt)
    assert len(out) == 8
    _drained(rt)


def test_two_by_two_pool_cluster_is_clean(san, port_model):
    from test_torch_cluster import Pkg
    from test_torch_workloads import PHASE6_EVENTS, case_replay_phase6_tiny
    with one_thread():
        rt = case_replay_phase6_tiny(
            Pkg("repro_torch", port_model, device="cpu"))["runtimes"]["rt"]
    assert len(rt.completed) == 2 * PHASE6_EVENTS
    assert rt.n_prefill == rt.n_decode == 2
    _drained(rt)


def test_release_path_skipping_pages_is_caught(san, port_model, monkeypatch):
    """Seeded bug in the port's runtime: a decode worker frees a slot id
    but skips ``page_table.release`` — caught at that release."""
    from _runtime_scenario import run_scenario
    from test_torch_runtime import _build

    def leaky(self, slot):
        self.free_slots.append(slot.idx)
        del self.slots[slot.req.rid]

    monkeypatch.setitem(san._orig, "DecodeWorker.release", leaky)
    rt = _build("repro_torch", "pool", True, "per_token_int8", port_model,
                device="cpu")
    with pytest.raises(san.SanitizerError) as ei, one_thread():
        run_scenario(rt)
    assert ei.value.kind == "leaked-pages"


# ---------------------------------------------------------------------------
# Each package's sanitizer patches its own classes only
# ---------------------------------------------------------------------------
def _methods(pkg):
    import importlib
    m = lambda path: importlib.import_module(f"{pkg}.{path}")  # noqa: E731
    pt = m("core.kvcache").PageTable
    kv = m("serving.kvstore")
    return {
        "PageTable.ensure": pt.ensure, "PageTable.release": pt.release,
        "PageTable.release_tail": pt.release_tail,
        "PageTable.block_row": pt.block_row,
        "KVTier.__setattr__": kv.KVTier.__setattr__,
        "PrefixKVStore.discard": kv.PrefixKVStore.discard,
        "DecodeWorker.release": m("serving.workers").DecodeWorker.release,
        "ClusterRuntime.run": m("serving.cluster").ClusterRuntime.run,
    }


@pytest.mark.parametrize("installer,other", [("repro_torch", "repro"),
                                             ("repro", "repro_torch")])
def test_install_leaves_the_other_package_alone(installer, other):
    import importlib
    san_i = importlib.import_module(f"{installer}.analysis.sanitize")
    before_other = _methods(other)
    before_own = _methods(installer)
    was = san_i.enabled()
    san_i.install()
    try:
        assert _methods(other) == before_other
        own = _methods(installer)
        assert own["PageTable.release"] is san_i._pt_release
        assert own["ClusterRuntime.run"] is san_i._rt_run
    finally:
        if not was:
            san_i.uninstall()
    assert _methods(other) == before_other
    if not was:
        assert _methods(installer) == before_own
