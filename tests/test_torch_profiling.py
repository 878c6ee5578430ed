"""The port's offline profiling, quality evaluation, device Hadamard stage
and one-shot PD engine against the JAX package's.

* ``hadamard_op`` (its plain version on the CPU) against the JAX package's
  Pallas kernel in interpret mode: atol 1e-5, as ``tests/test_kernels.py``
  holds the kernel against its oracle (f32 sums in another order).
* The device Hadamard stage (a CPU :class:`DeviceKVCache` through
  ``hadamard_op`` and, for a device-quantizable strategy, ``quant_pack``)
  against the JAX package's host pipeline on the same KV: total bytes
  equal exactly; codes and fp16 scales differ at no more than 1e-4 of
  positions, each by one step (the rotation is one in-order FMA chain per
  output, numpy's order, so the share is 0 where the host BLAS sums in
  that order); restored KV within 1e-5 of each row's scale; the same
  transform metadata.
* ``measure_profile`` on device KV: ``cr`` exactly the JAX package's (it
  is a ratio of byte counts), ``mse`` within rtol 1e-5 (float64 sums on
  the device against numpy's float32 pairwise sums).
* ``profiling/``: ``run_bo``'s evaluated sequence and feasible set, the
  Pareto frontier and the GP posterior (within 1e-12) equal the JAX
  package's on the same inputs.
* ``evaluate_quality``, ``calibrate_head_scores`` and
  ``DisaggregatedEngine.serve`` on ``tiny-lm``: agreement and tokens equal
  the JAX package's except at near ties — a differing prediction is
  allowed only where JAX's top-2 logit gap is at most one bf16 ulp at the
  top logit's magnitude, and each one is printed; head scores within
  rtol 1e-2 (the port's prefill KV differs from XLA's by bf16 flips).
  The JAX model steps run compiled with XLA's excess precision off
  (:func:`_exact`), so each operation rounds at its written dtype, as the
  port computes.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.quality as JQ  # noqa: E402
import repro.serving.engine as JE  # noqa: E402
import repro_torch.core.quality as PQ  # noqa: E402
import repro_torch.serving.engine as PE  # noqa: E402
from repro import profiling as JP  # noqa: E402
from repro.controller import ServiceAwareController as JController  # noqa: E402
from repro.core import codecs as jcodecs  # noqa: E402
from repro.core.kvcache import KVCache as JKV  # noqa: E402
from repro.core.pipeline import CompressionPipeline as JPipe  # noqa: E402
from repro.core.profiles import Profile as JProfile  # noqa: E402
from repro.core.profiles import measure_profile as j_measure  # noqa: E402
from repro.core.strategy import BASELINES as JB  # noqa: E402
from repro.core.strategy import StrategyConfig as JS  # noqa: E402
from repro.core.strategy import enumerate_space, estimate_cr  # noqa: E402
from repro.kernels.ops import hadamard_op as j_hadamard  # noqa: E402
from repro.serving.network import GBPS as JGBPS  # noqa: E402
from repro.serving.network import BandwidthTrace as JTrace  # noqa: E402
from repro_torch import profiling as PP  # noqa: E402
from repro_torch.controller import ServiceAwareController as PController  # noqa: E402
from repro_torch.core.pipeline import CompressionPipeline, DeviceKVCache  # noqa: E402
from repro_torch.core.profiles import Profile as PProfile  # noqa: E402
from repro_torch.core.profiles import measure_profile  # noqa: E402
from repro_torch.core.strategy import StrategyConfig as PS  # noqa: E402
from repro_torch.kernels import hadamard_op, ops  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.serving.network import GBPS, BandwidthTrace  # noqa: E402

SEQ, DECODE, N_PROMPTS = 64, 6, 2
WORKLOADS = ("qalike", "mathlike")


def _p(jcfg):
    """The port's StrategyConfig equal to a JAX one."""
    return PS.from_json(jcfg.to_json())


def _device(kv):
    return DeviceKVCache(torch.from_numpy(kv.k.copy()),
                         torch.from_numpy(kv.v.copy()))


def _kv(seed, d=64, bf16=True):
    kv = JKV.random(num_layers=3, kv_heads=2, seq=37, head_dim=d, seed=seed)
    if bf16:  # what a bf16 prefill cache holds
        def cast(a):
            return torch.from_numpy(a).to(torch.bfloat16).float().numpy()
        kv = JKV(cast(kv.k), cast(kv.v))
    return kv


# ---------------------------------------------------------------------------
# hadamard_op
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("t,d", [(256, 64), (512, 128), (128, 256), (77, 128)])
def test_hadamard_op_matches_jax(t, d, dtype):
    """(77, 128) is a ragged T: the port takes any T, the Pallas kernel
    one block of all 77 rows."""
    rng = np.random.default_rng(t + d)
    x = rng.standard_normal((t, d)).astype(np.float32)
    xt = torch.from_numpy(x)
    if dtype == "bf16":
        xt = xt.to(torch.bfloat16)
        x = xt.float().numpy()
    want = np.asarray(j_hadamard(jax.numpy.asarray(x),
                                 block_tokens=min(128, t), interpret=True))
    before = ops.hadamard_op.launches
    got = hadamard_op(xt, out_dtype=torch.float32)
    assert ops.hadamard_op.launches == before    # CPU: the plain version
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(
        got.numpy(), R.hadamard_ref(xt, torch.float32).numpy())
    assert hadamard_op(xt).dtype == xt.dtype    # out_dtype defaults to x's


def test_hadamard_op_involution_and_shape_checks():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32))
    np.testing.assert_allclose(hadamard_op(hadamard_op(x)).numpy(),
                               x.numpy(), atol=1e-4)
    with pytest.raises(ValueError, match="power of two"):
        hadamard_op(torch.zeros(4, 96))
    with pytest.raises(ValueError):
        hadamard_op(torch.zeros(4, 2, 64))


# ---------------------------------------------------------------------------
# The device Hadamard stage against the JAX host pipeline
# ---------------------------------------------------------------------------
def _codes(wire, codec):
    count = int(np.prod(wire.codes_shape))
    return jcodecs.decode_codes(wire.payload, wire.bits, count, codec) \
        .astype(np.int16)


def _int_uniform(bits, group):
    return JS(transform="hadamard", quantizer="uniform", key_bits=bits,
              value_bits=bits, granularity="per_token", symmetric=True,
              group_size=group)


@pytest.mark.parametrize("seed,jcfg,d,scores", [
    (0, _int_uniform(8, 32), 64, False),
    (1, _int_uniform(4, 32), 64, False),
    (2, dataclasses.replace(_int_uniform(8, 64), codec="zstd3"), 128, False),
    (3, JB["mixhq"], 64, True),
    (4, JB["mixhq"], 64, False),
    (5, _int_uniform(8, 32), 96, False),
], ids=["int8", "int4", "int8_zstd", "mixhq", "mixhq_default_scores",
        "int8_d96"])
def test_device_hadamard_stage_matches_jax_host(seed, jcfg, d, scores):
    kv = _kv(seed, d=d)
    hs = (np.random.default_rng(5).uniform(0.5, 2.0, (3, 2))
          .astype(np.float32) if scores else None)
    want = JPipe(jcfg, head_scores=hs).compress(kv)
    got = CompressionPipeline(_p(jcfg), head_scores=hs).compress(_device(kv))
    assert got.total_bytes() == want.total_bytes()
    assert got.k_ctx == want.k_ctx and got.v_ctx == want.v_ctx
    assert got.k_ctx["kind"] == "hadamard"

    n_code = n_code_diff = n_scale = n_scale_diff = 0
    for gb, wb in zip(got.k_buckets + got.v_buckets,
                      want.k_buckets + want.v_buckets):
        assert (gb.bits, gb.grouping, gb.group_size, gb.codes_shape) == \
            (wb.bits, wb.grouping, wb.group_size, wb.codes_shape)
        np.testing.assert_array_equal(gb.lh_index, wb.lh_index)
        gc, wc = _codes(gb, jcfg.codec), _codes(wb, jcfg.codec)
        assert np.abs(gc - wc).max(initial=0) <= 1
        n_code += gc.size
        n_code_diff += int((gc != wc).sum())
        for ga, wa in ((gb.scale, wb.scale), (gb.zp, wb.zp)):
            if wa is None:
                assert ga is None
                continue
            n_scale += wa.size
            n_scale_diff += int((ga != wa).sum())
    code_share = n_code_diff / n_code
    scale_share = n_scale_diff / max(n_scale, 1)
    assert code_share <= 1e-4 and scale_share <= 1e-4, \
        f"codes differ at {code_share:.3g}, scales at {scale_share:.3g}"

    ref = JPipe(jcfg, head_scores=hs).decompress(want)
    before = ops.hadamard_op.launches
    restored = CompressionPipeline(_p(jcfg), device="cpu").decompress(got)
    assert ops.hadamard_op.launches == before
    assert isinstance(restored, DeviceKVCache)
    for g, w in ((restored.k, ref.k), (restored.v, ref.v)):
        assert tuple(g.shape) == w.shape
        row = np.abs(w).max(axis=-1, keepdims=True)
        err = np.abs(g.numpy() - w)
        assert (err <= 1e-5 * row).all(), float((err / row).max())


def test_device_quantizable_is_the_paged_predicate_without_the_rest():
    from repro_torch.core.strategy import device_quantizable, paged_eligible
    had = _p(_int_uniform(8, 32))
    assert device_quantizable(had, head_dim=64)
    assert not paged_eligible(had, head_dim=64)
    assert paged_eligible(dataclasses.replace(had, transform="none"))
    assert not device_quantizable(had, head_dim=48)
    assert not device_quantizable(_p(JB["mixhq"]))


# ---------------------------------------------------------------------------
# roundtrip / measure_profile on device KV
# ---------------------------------------------------------------------------
def test_roundtrip_accepts_device_kv():
    kv = _device(_kv(2))
    pipe = CompressionPipeline(_p(_int_uniform(8, 32)), device="cpu")
    restored, comp, t_enc, t_dec = pipe.roundtrip(kv)
    assert isinstance(restored, DeviceKVCache)
    assert t_enc > 0 and t_dec > 0
    assert comp.total_bytes() < kv.nbytes_wire()


@pytest.mark.parametrize("name", ["int8_per_token", "hadamard_int8", "mixhq",
                                  "kivi", "identity"])
def test_measure_profile_on_device_kv_matches_jax(name):
    jcfg = {"int8_per_token": JS(quantizer="uniform", key_bits=8,
                                 value_bits=8, granularity="per_token",
                                 symmetric=True, group_size=32),
            "hadamard_int8": _int_uniform(8, 32),
            "mixhq": JB["mixhq"], "kivi": JB["kivi"],
            "identity": JS(key_bits=16, value_bits=16)}[name]
    samples = [_kv(s) for s in (7, 8)]
    want = j_measure(jcfg, samples)
    got = measure_profile(_p(jcfg), [_device(kv) for kv in samples])
    assert got.cr == want.cr
    np.testing.assert_allclose(got.mse, want.mse, rtol=1e-5)
    assert got.s_enc > 0 and got.s_dec > 0


# ---------------------------------------------------------------------------
# profiling/: the numpy copies
# ---------------------------------------------------------------------------
def _synthetic_eval(cfg):
    """tests/test_gp_bo.py's synthetic trade-off: a pure function of cfg."""
    cr = estimate_cr(cfg)
    penalty = 0.004 * cr ** 1.5
    if cfg.transform == "hadamard":
        penalty *= 0.8
    return max(0.0, 1.0 - penalty), cr


@pytest.mark.parametrize("kw", [
    dict(acc_threshold=0.95, max_iters=40, seed=1),
    dict(acc_threshold=0.97, max_iters=30, seed=7, use_pruning=False),
    dict(acc_threshold=0.95, max_iters=25, seed=3, use_encoding=False,
         use_exploration=False),
])
def test_run_bo_matches_jax(kw):
    jspace = enumerate_space("module")
    pspace = [_p(c) for c in jspace]
    jres = JP.run_bo(jspace, _synthetic_eval, JP.BOConfig(**kw))
    pres = PP.run_bo(pspace, _synthetic_eval, PP.BOConfig(**kw))
    assert [o.cfg.key() for o in pres.history] == \
        [o.cfg.key() for o in jres.history]
    assert [(o.cfg.key(), o.acc, o.cr) for o in pres.feasible] == \
        [(o.cfg.key(), o.acc, o.cr) for o in jres.feasible]
    assert pres.iterations == jres.iterations


@pytest.mark.parametrize("seed", [0, 11])
def test_gp_posterior_and_pareto_frontier_match_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (30, 3))
    y = np.sin(x[:, 0]) + 0.3 * x[:, 1] * x[:, 2]
    xq = rng.uniform(-2, 2, (20, 3))
    jm, js = JP.GaussianProcess(length_scale=0.8).fit(x, y).predict(xq)
    pm, ps = PP.GaussianProcess(length_scale=0.8).fit(x, y).predict(xq)
    np.testing.assert_allclose(pm, jm, atol=1e-12, rtol=0)
    np.testing.assert_allclose(ps, js, atol=1e-12, rtol=0)

    vals = [(float(a), float(c), float(lat)) for a, c, lat in zip(
        rng.uniform(0.5, 1, 50), rng.uniform(1, 10, 50),
        rng.uniform(1e-10, 1e-8, 50))]
    jf = JP.pareto_frontier([JP.ParetoPoint(a, c, lat, JProfile(
        JS(), cr=c, s_enc=1.0, s_dec=1.0)) for a, c, lat in vals])
    pf = PP.pareto_frontier([PP.ParetoPoint(a, c, lat, PProfile(
        PS(), cr=c, s_enc=1.0, s_dec=1.0)) for a, c, lat in vals])
    assert [(p.acc, p.cr, p.lat) for p in pf] == \
        [(p.acc, p.cr, p.lat) for p in jf]


# ---------------------------------------------------------------------------
# Quality evaluation and the one-shot engine on tiny-lm
# ---------------------------------------------------------------------------
_COMPILED = {}


def _exact(jitted):
    """``jitted`` compiled with ``xla_allow_excess_precision`` off (one
    executable per argument shapes), called like it."""
    def call(*args):
        leaves, tree = jax.tree_util.tree_flatten(args)
        key = (id(jitted), tree, tuple((np.shape(a), np.result_type(a))
                                       for a in leaves))
        if key not in _COMPILED:
            _COMPILED[key] = jitted.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return _COMPILED[key](*args)
    return call


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().cpu().numpy()
    return np.asarray(a, np.float32)


class _Recorder:
    """Patches a package's ``_greedy_decode`` / ``_teacher_forced_agreement``
    so each call's last-position logits are kept, in call order."""

    def __init__(self, monkeypatch, quality_mod, engine_mod=None):
        self.calls = []
        greedy, tf = quality_mod._greedy_decode, \
            quality_mod._teacher_forced_agreement

        def recording(dec_fn):
            logits = []

            def dec(p, c, t, pos):
                out, c = dec_fn(p, c, t, pos)
                logits.append(_np(out[:, -1, :]))
                return out, c
            return dec, logits

        def greedy_rec(dec_fn, params, caches, first, start, steps):
            dec, logits = recording(dec_fn)
            toks = greedy(dec, params, caches, first, start, steps)
            self.calls.append(("greedy", toks, np.stack(logits, 1), None))
            return toks

        def tf_rec(dec_fn, params, caches, ref_tokens, start):
            dec, logits = recording(dec_fn)
            acc = tf(dec, params, caches, ref_tokens, start)
            self.calls.append(("tf", ref_tokens, np.stack(logits, 1), acc))
            return acc

        monkeypatch.setattr(quality_mod, "_greedy_decode", greedy_rec)
        monkeypatch.setattr(quality_mod, "_teacher_forced_agreement", tf_rec)
        if engine_mod is not None:
            monkeypatch.setattr(engine_mod, "_greedy_decode", greedy_rec)


def _near_tie(logits_row):
    top = np.sort(logits_row)[-2:]
    ulp = 2.0 ** (np.floor(np.log2(abs(float(top[1])))) - 7)
    return float(top[1] - top[0]) <= ulp, float(top[1] - top[0])


def _compare_greedy(jcall, pcall, label, ties):
    """Tokens equal up to each row's first flip, which must be a JAX near
    tie.  Returns per-row stop indices (first differing token, or len)."""
    jt, pt, jl = jcall[1], pcall[1], jcall[2]
    stops = []
    for b in range(jt.shape[0]):
        diff = np.nonzero(jt[b] != pt[b])[0]
        stop = int(diff[0]) if len(diff) else jt.shape[1]
        # the first token comes from the prefill, whose logits are not
        # recorded: it must be equal (at these sizes its top-2 gap is >= 13)
        assert stop > 0, f"{label} row {b}: first token {jt[b, 0]} vs " \
                         f"{pt[b, 0]}"
        if len(diff):
            tie, gap = _near_tie(jl[b, stop - 1])
            assert tie, f"{label} row {b} token {stop}: {jt[b]} vs {pt[b]}, " \
                        f"JAX top-2 gap {gap}"
            ties.append(f"{label} row {b} token {stop}: JAX {jt[b, stop]} "
                        f"port {pt[b, stop]} (gap {gap})")
        stops.append(stop)
    return stops


def _compare_tf(jcall, pcall, stops, label, ties) -> int:
    """Teacher-forced predictions equal before each row's reference flip,
    except at JAX near ties.  Returns how many hits may differ."""
    jl, pl, ref = jcall[2], pcall[2], jcall[1]
    slack = 0
    for b in range(ref.shape[0]):
        n = ref.shape[1] - 1
        for t in range(n):
            if t >= stops[b] - 1:     # the inputs differ from here on
                slack += n - t
                break
            jp, pp = int(jl[b, t].argmax()), int(pl[b, t].argmax())
            if jp != pp:
                tie, gap = _near_tie(jl[b, t])
                assert tie, f"{label} row {b} step {t}: pred {jp} vs {pp}, " \
                            f"JAX top-2 gap {gap}"
                ties.append(f"{label} row {b} step {t}: JAX {jp} port {pp} "
                            f"(gap {gap})")
                slack += 1
    return slack


@pytest.fixture
def exact_jax(monkeypatch):
    orig = JQ._jitted_steps

    def steps(cfg_name, seq, batch, max_len):
        return tuple(_exact(f) for f in orig(cfg_name, seq, batch, max_len))
    monkeypatch.setattr(JQ, "_jitted_steps", steps)
    monkeypatch.setattr(JE, "_jitted_steps", steps)


@pytest.fixture(scope="module")
def port_ref(reference_model):
    return PQ.get_reference_model(device="cpu")


def _quality_profiles():
    return {"int8_per_token": JS(quantizer="uniform", key_bits=8,
                                 value_bits=8, granularity="per_token",
                                 symmetric=True, group_size=32),
            "kivi": JB["kivi"], "mixhq": JB["mixhq"],
            "identity": JS(key_bits=16, value_bits=16)}


def test_calibrate_head_scores_matches_jax(reference_model, port_ref,
                                           exact_jax):
    want = JQ.calibrate_head_scores(n_prompts=2, seq=SEQ,
                                    ref=reference_model)
    got = PQ.calibrate_head_scores(n_prompts=2, seq=SEQ, ref=port_ref)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-2)


@pytest.mark.parametrize("name", list(_quality_profiles()))
def test_evaluate_quality_matches_jax(name, reference_model, port_ref,
                                      exact_jax, monkeypatch):
    jcfg = _quality_profiles()[name]
    hs = JQ.calibrate_head_scores(n_prompts=2, seq=SEQ, ref=reference_model)
    kw = dict(workloads=WORKLOADS, n_prompts=N_PROMPTS, seq=SEQ,
              decode_tokens=DECODE, head_scores=hs)
    jrec = _Recorder(monkeypatch, JQ)
    prec = _Recorder(monkeypatch, PQ)
    want = JQ.evaluate_quality(jcfg, ref=reference_model, **kw)
    before = ops.hadamard_op.launches
    got = PQ.evaluate_quality(_p(jcfg), ref=port_ref, **kw)
    assert ops.hadamard_op.launches == before
    assert set(got) == set(want) == set(WORKLOADS)
    if name == "identity":
        assert got == want == {w: 1.0 for w in WORKLOADS}
        return
    assert len(jrec.calls) == len(prec.calls) == 2 * len(WORKLOADS)
    ties = []
    for wi, w in enumerate(WORKLOADS):
        jg, jt = jrec.calls[2 * wi:2 * wi + 2]
        pg, pt = prec.calls[2 * wi:2 * wi + 2]
        stops = _compare_greedy(jg, pg, f"{name}/{w} reference", ties)
        slack = _compare_tf(jt, pt, stops, f"{name}/{w} teacher-forced",
                            ties)
        total = N_PROMPTS * DECODE
        assert abs(got[w] - want[w]) * total <= slack + 1e-9, \
            (w, got[w], want[w], ties)
    for t in ties:
        print("near tie:", t)


def _engine_profiles(pkg_profile, strategy_cls, baselines_mixhq):
    int8 = strategy_cls(quantizer="uniform", key_bits=8, value_bits=8,
                        granularity="per_token", symmetric=True,
                        group_size=32)
    q = {w: 1.0 for w in ("mathlike", "codelike", "qalike", "summlike")}
    return [
        pkg_profile(strategy_cls(key_bits=16, value_bits=16), cr=1.0,
                    s_enc=float("inf"), s_dec=float("inf"), quality=q),
        pkg_profile(int8, cr=1.9, s_enc=5e9, s_dec=5e9, quality=q),
        pkg_profile(baselines_mixhq, cr=6.0, s_enc=1e9, s_dec=1e9,
                    quality={w: 0.99 for w in q}),
    ]


@pytest.mark.parametrize("mode", ["static_mixhq", "controller"])
def test_disaggregated_engine_matches_jax(mode, reference_model, port_ref,
                                          exact_jax, monkeypatch):
    kw = dict(seq=SEQ, decode_tokens=DECODE, batch=2)
    if mode == "static_mixhq":
        jeng = JE.DisaggregatedEngine(static_profile=JProfile(
            JB["mixhq"], cr=6.0, s_enc=1e9, s_dec=1e9), **kw)
        peng = PE.DisaggregatedEngine(static_profile=PProfile(
            _p(JB["mixhq"]), cr=6.0, s_enc=1e9, s_dec=1e9), ref=port_ref,
            device="cpu", **kw)
    else:
        jprofs = _engine_profiles(JProfile, JS, JB["mixhq"])
        pprofs = _engine_profiles(PProfile, PS, _p(JB["mixhq"]))
        jeng = JE.DisaggregatedEngine(controller=JController(
            {w: jprofs for w in ("mathlike", "codelike", "qalike",
                                 "summlike")}), **kw)
        peng = PE.DisaggregatedEngine(controller=PController(
            {w: pprofs for w in ("mathlike", "codelike", "qalike",
                                 "summlike")}), ref=port_ref, device="cpu",
            **kw)
    jrec = _Recorder(monkeypatch, JQ, JE)
    prec = _Recorder(monkeypatch, PQ, PE)
    ties = []
    for i, (w, gbps) in enumerate((("qalike", 1.0), ("mathlike", 100.0))):
        want = jeng.serve(w, JTrace.constant(gbps * JGBPS), q_min=0.97,
                          seed=i)
        got = peng.serve(w, BandwidthTrace.constant(gbps * GBPS),
                         q_min=0.97, seed=i)
        assert got.profile == want.profile
        assert (got.kv_bytes, got.wire_bytes) == (want.kv_bytes,
                                                  want.wire_bytes)
        assert got.jct == pytest.approx(
            got.t_prefill + got.t_compress + got.t_comm + got.t_decompress
            + got.t_decode, rel=1e-12)
        assert got.t_comm == pytest.approx(want.t_comm, rel=1e-12)
        jref, jtest = jrec.calls[2 * i:2 * i + 2]
        pref, ptest = prec.calls[2 * i:2 * i + 2]
        rstops = _compare_greedy(jref, pref, f"{mode}/{w} reference", ties)
        tstops = _compare_greedy(jtest, ptest, f"{mode}/{w} served", ties)
        np.testing.assert_array_equal(got.tokens, ptest[1])
        if all(s == got.tokens.shape[1] for s in rstops + tstops):
            assert got.agreement == want.agreement
    for t in ties:
        print("near tie:", t)


# ---------------------------------------------------------------------------
# Entry points run on CUDA unless asked for the CPU
# ---------------------------------------------------------------------------
def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run there")
    from repro_torch.launch import profile_offline, serve

    calls = [
        lambda: PE.DisaggregatedEngine(),
        lambda: PQ.evaluate_quality(_p(JB["mixhq"])),
        lambda: PQ.calibrate_head_scores(),
        lambda: profile_offline.build_profiles([_p(JB["kivi"])],
                                               with_quality=False),
        lambda: profile_offline.search_and_build(max_iters=1),
        lambda: serve.main(["--requests", "1"]),
    ]
    for call in calls:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            call()
