"""Deciding ``correct``: what the timed path produced, against the plain
reference, once the window has closed.

* ``gap_mean``: over a sample of the requests the window finished (drawn
  from the seed, the longest among them), the mean over their served
  tokens of the gap by which a token's reference logit lies below the
  reference's best at its position (``gap_max``, the widest, is read
  beside it).  The reference runs each prompt, quantizes its KV by the
  profile the controller chose, and runs the served tokens over it.  A
  gap is nonzero only where rounding moved the best token, so the mean
  grows with the square of the error, where the widest grows with the
  error and swings with the one near-tie it catches.
* ``kv_rel_err``: for the same requests, the cache the wire payload
  carries (decoded by the reference's own arithmetic) against the
  reference's quantized cache, ||payload - reference|| / ||reference||
  over the layer's parts together, the largest over the sample, in the
  first layer: its cache is the embedding's projection, where the bf16
  forward has not yet drifted from the f32 one, so the number judges the
  wire and the codec.  Over every layer (``kv_rel_err_all``, read beside
  it) the bf16 residual stream's drift (about 6% by the last of
  deepseek-moe-16b's 28 layers) is a third of the fp8 control's, too
  close for a limit between them; the served tokens' gaps judge the
  layers after the first.
* ``landed_mismatch``: sampled requests whose first layer, as the decode
  worker landed it in its paged arena, differs in any part from the
  payload decoded by the reference's arithmetic by more than one bf16
  step (2**-7 of the value) anywhere: the arena stores bf16, so a sound
  landing rounds each value once.  With ``kv_rel_err`` it holds the
  landed cache to the reference's quantize-dequantize.  Its limit is 0.
* ``wire_mismatch``: cold requests whose bytes on the wire, as the
  runtime sent and billed them, differ from the harness's own count of
  their payload, or whose ``comm`` differs from those bytes over the
  cell's bandwidth.  Its limit is 0.
* ``prompt_mismatch``: sampled requests whose prompt, as the prefill was
  given it, differs from the reference's ids of (workload, prompt
  seed).  Its limit is 0.

Everything that depends on the model's layout (the forward, the
payload's decoding, the cache's parts) is the configuration's module's
(``cell.model``; ``kvb.spec.load_model``).  With ``lowp`` the control
reads too: the reference put in the program's place in fp8 (the
module's ``forward`` with ``lowp``), on the same prompts and served
tokens; its gap is that of the token it puts first.
``control_verdict`` holds its readings to the cell's limits of the same
numbers.  A run that finished no request to compare reads NaN, which no
limit passes."""
from __future__ import annotations

import math
from dataclasses import asdict
from typing import Dict, List

import numpy as np
import torch

from reference import prompts

GBPS = 1e9 / 8
CHUNK = 8
BF16_STEP = 2.0 ** -7
# the control's reading of each number it takes the program's place in
CONTROL = {"gap_mean": "control_gap_mean", "kv_rel_err": "control_kv_rel_err"}


def wire_mismatches(window, probe, bandwidth_gbps: float) -> int:
    bad = 0
    rate = bandwidth_gbps * GBPS
    for rec in window.records.values():
        land = probe.landed.get(rec.rid)
        if land is None or land.own_bytes is None \
                or "comm" not in rec.breakdown:
            continue
        own = land.own_bytes
        comm = rec.breakdown["comm"]
        if (land.sent != [float(own)] or rec.wire_bytes != own
                or abs(comm - own / rate) > 1e-9 * max(comm, 1e-12)):
            bad += 1
    return bad


def sample(window, probe, seed: int, n: int) -> List:
    """The finished candidates, the longest first, then others drawn from
    the seed, ``n`` in all."""
    done = [r for r in window.completed() if r.rid in probe.candidates
            and probe.landed[r.rid].payload is not None]
    if not done:
        return []
    done.sort(key=lambda r: (-r.tokens, r.rid))
    rest = done[1:]
    rng = np.random.default_rng([seed & 0xFFFFFFFF,
                                 (seed >> 32) & 0xFFFFFFFF, 9])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [done[0]] + [rest[i] for i in sorted(pick)]


def _landed_ok(arena, pay) -> bool:
    """Whether the landed first layer ``arena`` (its parts, (H, S, W)
    each) is the decoded payload ``pay`` (the parts, (L, H, S, W) f32) to
    one bf16 step."""
    if arena is None or len(arena) != len(pay):
        return False
    for got, want in zip(arena, pay):
        want = want[0]
        if tuple(got.shape) != tuple(want.shape):
            return False
        err = (got.to(want.device).float() - want).abs()
        if bool((err > BF16_STEP * want.abs()).any()):
            return False
    return True


def _add_sums(sums, layer: int, parts, pay) -> None:
    """Add to ``sums`` (request, layer, 2) each request's squared error
    and squared reference in ``layer``, over the cache's parts in order:
    the reference's ``parts`` (B, S, H, W) each against the payloads'
    ``pay`` (a request's parts, (L, H, S, W) each)."""
    for b in range(parts[0].shape[0]):
        for which, part in enumerate(parts):
            want = pay[b][which][layer]
            ref = part[b].transpose(0, 1)
            sums[b, layer, 0] += float(((want - ref) ** 2).sum())
            sums[b, layer, 1] += float((ref ** 2).sum())


def _rel(sq) -> float:
    """Largest ||error|| / ||reference|| over requests, from (request, 2)
    sums of squares."""
    return float(np.sqrt(sq[:, 0] / sq[:, 1]).max())


def _gaps(first, rest, served, lens):
    """Per request: the gap of each served token in logits ``first``
    (B, V) and ``rest`` (B, S1, V)."""
    out = []
    for b, toks in enumerate(served):
        g = [float(first[b].max() - first[b, toks[0]])]
        for i in range(lens[b] - 1):
            row = rest[b, i]
            g.append(float(row.max() - row[toks[i + 1]]))
        out.append(g)
    return out


def readings(cell, window, probe, params, served: Dict[int, np.ndarray],
             seed: int, device, lowp: bool = False) -> Dict[str, float]:
    cfg, model = cell.config, cell.model
    seq = cell.traffic["prompt_tokens"]
    out = {"wire_mismatch": float(wire_mismatches(
        window, probe, cell.cell["bandwidth_gbps"]))}
    picked = sample(window, probe, seed, cell.cell["sample"])
    if not picked:
        # nothing finished: nothing to hold up, and the run is not correct
        out.update(gap_max=math.nan, gap_mean=math.nan,
                   kv_rel_err=math.nan, kv_rel_err_all=math.nan,
                   prompt_mismatch=math.nan, landed_mismatch=math.nan,
                   sampled=0.0, sampled_tokens=0.0)
        return out
    gap_max, kv_err, bad_prompt, bad_landed, tokens = 0.0, 0.0, 0, 0, 0
    c_gap, c_kv, kv_all, c_kv_all = 0.0, 0.0, 0.0, 0.0
    gap_sum, c_gap_sum = 0.0, 0.0
    for at in range(0, len(picked), CHUNK):
        part = picked[at:at + CHUNK]
        ids = [prompts.prompt_ids(r.req.workload, r.req.prompt_seed, seq)
               for r in part]
        for r, p in zip(part, ids):
            if probe.landed[r.rid].prompt != [int(t) for t in p]:
                bad_prompt += 1
        toks = [served[r.rid] for r in part]
        lens = [len(t) for t in toks]
        width = max(max(lens) - 1, 1)
        cont = np.zeros((len(part), width), np.int64)
        for b, t in enumerate(toks):
            cont[b, :len(t) - 1] = t[:-1]
        strategies = [asdict(probe.landed[r.rid].profile.strategy)
                      for r in part]
        pay = [model.payload_parts(probe.landed[r.rid].payload, device)
               for r in part]
        bad_landed += sum(not _landed_ok(probe.landed[r.rid].arena, p)
                          for r, p in zip(part, pay))
        # (request, layer) squared error and squared reference
        sums = np.zeros((len(part), cfg["num_layers"], 2))
        ref_parts = {}

        def on_kv(layer, parts, sums=sums, pay=pay, keep=ref_parts):
            _add_sums(sums, layer, parts, pay)
            if lowp:
                keep[layer] = parts

        p_t = torch.as_tensor(np.stack(ids), dtype=torch.long, device=device)
        c_t = torch.as_tensor(cont, device=device)
        with torch.no_grad():
            first, rest = model.forward(cfg, params, p_t, c_t, strategies,
                                        on_kv=on_kv)
        gaps = _gaps(first, rest, toks, lens)
        tokens += sum(len(g) for g in gaps)
        gap_max = max(gap_max, max(max(g) for g in gaps))
        gap_sum += sum(sum(g) for g in gaps)
        kv_err = max(kv_err, _rel(sums[:, 0]))
        kv_all = max(kv_all, _rel(sums.sum(axis=1)))
        if lowp:
            csums = np.zeros((len(part), cfg["num_layers"], 2))

            def on_kv_low(layer, parts, csums=csums, keep=ref_parts):
                for got, ref in zip(parts, keep.pop(layer)):
                    csums[:, layer, 0] += ((got - ref) ** 2).sum(
                        dim=(1, 2, 3)).cpu().numpy()
                    csums[:, layer, 1] += (ref ** 2).sum(
                        dim=(1, 2, 3)).cpu().numpy()

            with torch.no_grad():
                lf, lr = model.forward(cfg, params, p_t, c_t, strategies,
                                       lowp=True, on_kv=on_kv_low)
            picks = [[int(lf[b].argmax())]
                     + [int(lr[b, i].argmax()) for i in range(lens[b] - 1)]
                     for b in range(len(part))]
            cg = _gaps(first, rest, picks, lens)
            c_gap = max(c_gap, max(max(g) for g in cg))
            c_gap_sum += sum(sum(g) for g in cg)
            c_kv = max(c_kv, _rel(csums[:, 0]))
            c_kv_all = max(c_kv_all, _rel(csums.sum(axis=1)))
            del lf, lr
        del first, rest
    out.update(gap_max=gap_max, gap_mean=gap_sum / tokens,
               kv_rel_err=kv_err, kv_rel_err_all=kv_all,
               prompt_mismatch=float(bad_prompt),
               landed_mismatch=float(bad_landed),
               sampled=float(len(picked)), sampled_tokens=float(tokens))
    if lowp:
        out.update(control_gap_max=c_gap, control_gap_mean=c_gap_sum / tokens,
                   control_kv_rel_err=c_kv, control_kv_rel_err_all=c_kv_all)
    return out


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, {name: [value, limit]}) over the limited readings; a
    reading that is missing or not finite fails."""
    shown = {}
    ok = True
    for name, limit in limits.items():
        v = values.get(name)
        good = (v is not None and math.isfinite(v) and limit is not None
                and v <= limit)
        ok = ok and good
        shown[name] = [v, limit]
    return ok, shown


def control_verdict(values: Dict[str, float],
                    limits: Dict[str, float]) -> tuple:
    """The control's (correct, {name: [value, limit]}): its readings of
    the numbers it takes the program's place in, held to the same
    limits."""
    lim = {n: v for n, v in limits.items() if n in CONTROL}
    return verdict({n: values.get(CONTROL[n]) for n in lim}, lim)
