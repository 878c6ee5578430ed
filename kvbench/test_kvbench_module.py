"""The configuration's module (``kvb.spec.load_model``): the file's
``"reference"`` key picks it, the check compares the cache part by part
in its order, and on fixed inputs the check reads what it read before the
module took over the model-specific code, bit for bit."""
import json
from dataclasses import asdict
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tinybench
from kvb import check, spec
from kvb.harness import run_cell

SEED = 20260418
SEQ = 64
# (rid, workload, prompt seed, served tokens)
REQS = ((1, "qalike", 11, 6), (2, "codelike", 12, 9))
# check.readings on those inputs before the move (float.hex), recorded with
# torch 2.13.0+cpu on an AVX512 CPU: the port's CPU prefill and the f32
# reference round differently on other builds and CPUs, so elsewhere the
# inputs differ and these values do not apply; the frozen copy of the
# parent's arithmetic below holds the moved code on any machine
RECORDED_ON = ("2.13.0+cpu", "AVX512")
BEFORE = {
    "gap_max": "0x1.877e300000000p+2",
    "gap_mean": "0x1.bd045f3333333p+1",
    "kv_rel_err": "0x1.6814505ac6c7ap-8",
    "kv_rel_err_all": "0x1.be8214fa09a2dp-8",
    "control_gap_max": "0x1.8890800000000p-3",
    "control_gap_mean": "0x1.8e4a666666666p-6",
    "control_kv_rel_err": "0x1.2a5ce66488719p-5",
    "control_kv_rel_err_all": "0x1.9bb13700a0204p-5",
}


def _fixed_inputs(root):
    """Seeded tiny weights; two prompts, one on an int8 and one on the
    identity profile, each payload made from the port's prefill KV by the
    port's CPU pipeline and landed as its bf16 decompression; fixed
    served tokens."""
    from repro_torch.configs import get_config
    from repro_torch.core.pipeline import CompressionPipeline
    from repro_torch.core.profiles import IDENTITY_PROFILE, Profile
    from repro_torch.core.quality import extract_kv
    from repro_torch.core.strategy import StrategyConfig
    from repro_torch.models.transformer import prefill
    from kvb.probe import Landed
    from kvb.weights import make_params
    from reference import prompts

    config = json.loads((root / "configs" / "tiny.json").read_text())
    model = spec.load_model(root, config)
    model_cfg = get_config(config["registry"])
    params = make_params(model_cfg, SEED, "cpu", model.init_scale)
    int8 = Profile(StrategyConfig(
        quantizer="uniform", key_bits=8, value_bits=8,
        granularity="per_token", symmetric=True, group_size=16),
        cr=1.9, s_enc=5e8, s_dec=5e8, quality={})
    rng = np.random.default_rng(7)
    records, landed, served = [], {}, {}
    for (rid, workload, pseed, n), prof in zip(REQS, (int8,
                                                      IDENTITY_PROFILE)):
        ids = prompts.prompt_ids(workload, pseed, SEQ)
        with torch.no_grad():
            _, caches = prefill(model_cfg, params, {
                "tokens": torch.as_tensor(ids[None], dtype=torch.int32)},
                SEQ)
        pipe = CompressionPipeline(prof.strategy, device="cpu")
        comp = pipe.compress(extract_kv(model_cfg, caches, 0, SEQ))
        back = pipe.decompress(comp)
        arena = tuple(torch.as_tensor(np.asarray(x, dtype=np.float32)[0])
                      .to(torch.bfloat16) for x in (back.k, back.v))
        landed[rid] = Landed(rid, profile=prof, payload=comp, arena=arena,
                             prompt=[int(t) for t in ids])
        served[rid] = rng.integers(0, model_cfg.vocab_size, size=n)
        records.append(SimpleNamespace(
            rid=rid, tokens=n,
            req=SimpleNamespace(workload=workload, prompt_seed=pseed)))
    window = SimpleNamespace(records={}, completed=lambda: list(records))
    probe = SimpleNamespace(candidates={r.rid for r in records},
                            landed=landed)
    cell = SimpleNamespace(config=config, model=model,
                           traffic={"prompt_tokens": SEQ},
                           cell={"bandwidth_gbps": 1.0, "sample": 4})
    return cell, window, probe, params, served


def _parent_readings(cell, window, probe, params, served, seed, device):
    """The parent's ``check.readings`` arithmetic for the fixed inputs
    (one chunk, the control read beside it), frozen as it was before the
    model-specific code moved: K and V taken by name, (K, V) sums in that
    order, ``quant.payload_kv`` for the payload."""
    from reference import decoder, prompts, quant

    cfg, seq = cell.config, cell.traffic["prompt_tokens"]
    part = check.sample(window, probe, seed, cell.cell["sample"])
    ids = [prompts.prompt_ids(r.req.workload, r.req.prompt_seed, seq)
           for r in part]
    toks = [served[r.rid] for r in part]
    lens = [len(t) for t in toks]
    cont = np.zeros((len(part), max(max(lens) - 1, 1)), np.int64)
    for b, t in enumerate(toks):
        cont[b, :len(t) - 1] = t[:-1]
    strategies = [asdict(probe.landed[r.rid].profile.strategy) for r in part]
    pay = [quant.payload_kv(probe.landed[r.rid].payload, device)
           for r in part]
    sums = np.zeros((len(part), cfg["num_layers"], 2))
    csums = np.zeros((len(part), cfg["num_layers"], 2))
    ref_kv = {}

    def on_kv(layer, kq, vq):
        for b in range(kq.shape[0]):
            for which, got in ((0, kq[b]), (1, vq[b])):
                want = pay[b][which][layer]
                ref = got.transpose(0, 1)
                sums[b, layer, 0] += float(((want - ref) ** 2).sum())
                sums[b, layer, 1] += float((ref ** 2).sum())
        ref_kv[layer] = (kq, vq)

    def on_kv_low(layer, kq, vq):
        rk, rv = ref_kv.pop(layer)
        for got, ref in ((kq, rk), (vq, rv)):
            csums[:, layer, 0] += ((got - ref) ** 2).sum(
                dim=(1, 2, 3)).cpu().numpy()
            csums[:, layer, 1] += (ref ** 2).sum(dim=(1, 2, 3)).cpu().numpy()

    p_t = torch.as_tensor(np.stack(ids), dtype=torch.long, device=device)
    c_t = torch.as_tensor(cont, device=device)
    with torch.no_grad():
        first, rest = decoder.forward(
            cfg, params, p_t, c_t, strategies,
            on_kv=lambda layer, parts: on_kv(layer, *parts))
        lf, lr = decoder.forward(
            cfg, params, p_t, c_t, strategies, lowp=True,
            on_kv=lambda layer, parts: on_kv_low(layer, *parts))
    gaps = check._gaps(first, rest, toks, lens)
    picks = [[int(lf[b].argmax())]
             + [int(lr[b, i].argmax()) for i in range(lens[b] - 1)]
             for b in range(len(part))]
    cg = check._gaps(first, rest, picks, lens)
    n = sum(len(g) for g in gaps)
    return {"gap_max": max(max(g) for g in gaps),
            "gap_mean": sum(sum(g) for g in gaps) / n,
            "kv_rel_err": check._rel(sums[:, 0]),
            "kv_rel_err_all": check._rel(sums.sum(axis=1)),
            "control_gap_max": max(max(g) for g in cg),
            "control_gap_mean": sum(sum(g) for g in cg) / n,
            "control_kv_rel_err": check._rel(csums[:, 0]),
            "control_kv_rel_err_all": check._rel(csums.sum(axis=1))}


def test_fixed_inputs_read_as_before_the_move(tmp_path):
    """The check's readings through the configuration's module equal the
    parent's arithmetic bit for bit, and where the inputs are the ones
    recorded (``RECORDED_ON``), the parent's recorded readings."""
    cell, window, probe, params, served = _fixed_inputs(
        tinybench.build(tmp_path))
    got = check.readings(cell, window, probe, params, served, SEED, "cpu",
                         lowp=True)
    hexed = {k: float(got[k]).hex() for k in BEFORE}
    want = _parent_readings(cell, window, probe, params, served, SEED, "cpu")
    assert hexed == {k: float(want[k]).hex() for k in BEFORE}
    if (torch.__version__, torch.backends.cpu.get_cpu_capability()) \
            == RECORDED_ON:
        assert hexed == BEFORE
    assert got["landed_mismatch"] == got["prompt_mismatch"] == 0.0
    assert got["sampled"] == 2.0 and got["sampled_tokens"] == 15.0


PLANTED = '''
from reference.decoder import *  # noqa: F401,F403
from reference import decoder


def forward(*args, **kw):
    """The plain forward with one logit of the first request's first
    token raised past every other."""
    first, rest = decoder.forward(*args, **kw)
    first[0, first[0].argmin()] += 1e4
    return first, rest
'''


def _name_module(root, path):
    cfg_path = root / "configs" / "tiny.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["reference"] = path
    cfg_path.write_text(json.dumps(cfg))


def test_the_reference_key_picks_the_module(tmp_path):
    """A configuration naming a module whose forward shifts one logit
    reads not correct, by its gap."""
    root = tinybench.build(tmp_path)
    (root / "reference" / "shifted.py").write_text(PLANTED)
    _name_module(root, "reference/shifted.py")
    cell = spec.load_cell("tiny.pd", root / "BENCHMARK.json", root)
    assert cell.model.__file__ == str(root / "reference" / "shifted.py")
    res = run_cell("tiny.pd", SEED, 2.0, False, "cpu", 0.0,
                   root / "BENCHMARK.json", root, log=lambda s: None)
    assert not res["correct"]
    assert res["checks"]["gap_mean"]["value"] > \
        tinybench.LIMITS["gap_mean"]
    assert res["checks"]["kv_rel_err"]["value"] <= \
        tinybench.LIMITS["kv_rel_err"]


def test_a_missing_module_fails_the_run_naming_the_file(tmp_path):
    root = tinybench.build(tmp_path)
    _name_module(root, "reference/absent.py")
    with pytest.raises(FileNotFoundError, match="absent.py"):
        run_cell("tiny.pd", 1, 0.5, False, "cpu", 0.0,
                 root / "BENCHMARK.json", root)


def _two_parts(seed):
    """A latent layout: one head, parts 512 and 64 wide, 5 positions;
    bf16 values, so a sound landing is exact."""
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn((1, 5, 1, w), generator=g)
                 .bfloat16().float() for w in (512, 64))


def _compare(ref, pay, arena):
    """(kv_rel_err, landed) of one request's single layer: the reference's
    parts (1, S, H, W), the payload's (1, H, S, W), the landed (H, S, W)."""
    sums = np.zeros((1, 1, 2))
    check._add_sums(sums, 0, ref, [pay])
    return check._rel(sums[:, 0]), check._landed_ok(arena, pay)


def test_parts_of_unequal_widths_are_compared_part_by_part():
    ref = _two_parts(3)
    pay = tuple(p.transpose(1, 2) for p in ref)
    arena = tuple(p[0].bfloat16() for p in pay)
    assert _compare(ref, pay, arena) == (0.0, True)
    off = (pay[0], pay[1] * 1.02)
    err, ok = _compare(ref, off, tuple(p[0].bfloat16() for p in off))
    want = 0.02 * float(ref[1].norm() / torch.cat(
        [p.flatten() for p in ref]).norm())
    assert err == pytest.approx(want, rel=1e-4) and ok
    err, ok = _compare(ref, pay, (arena[0], arena[1] * 1.02))
    assert err == 0.0 and not ok
    # a part missing from the landing, or of another width, is no match
    assert not check._landed_ok(arena[:1], pay)
    assert not check._landed_ok(arena[:1] + (arena[1][..., :32],), pay)
