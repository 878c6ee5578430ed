"""Synthetic workload families with genuinely different sequence statistics.

The paper's Motivation 1 rests on workload-dependent KV statistics: math
(GSM8K), code (HumanEval), summarization (Multi-News), QA (Qasper) have
different request distributions, so the same compression strategy yields
different accuracy/CR per workload.  We reproduce that with four byte-level
generators whose entropy, repetition structure, and long-range dependency
patterns differ:

  - ``mathlike``:  arithmetic chains ("37+25=62;62-18=44;...") — short-range
    exact dependencies, digit-heavy alphabet (high local precision demand).
  - ``codelike``:  keyword/indentation templates — low entropy, heavy
    repetition (compresses well; tolerant to aggressive quantization).
  - ``qalike``:    needle retrieval — "k07=v83. ... Q:k07? A:v83" — long-range
    exact retrieval (sensitive to KV noise in retrieval heads).
  - ``summlike``:  noisy repeated sentences; answer = lead sentence — long
    context, redundant (high compressibility, moderate sensitivity).

Each generator returns (prompt, answer): quality for a compression strategy is
measured as decode agreement / answer accuracy with compressed vs raw KV.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np

Rng = np.random.Generator


@dataclass(frozen=True)
class WorkloadSpec:
    name: str
    gen: Callable[[Rng, int], Tuple[str, str]]
    # Typical context length scale (bytes) for the serving simulator.
    ctx_scale: int
    # Typical output length scale (tokens).
    out_scale: int


def _gen_mathlike(rng: Rng, approx_len: int) -> Tuple[str, str]:
    parts = []
    val = int(rng.integers(10, 99))
    total = 0
    while total < approx_len - 12:
        delta = int(rng.integers(1, 49))
        op = "+" if rng.random() < 0.5 else "-"
        nxt = val + delta if op == "+" else max(val - delta, 1)
        seg = f"{val}{op}{delta}={nxt};"
        parts.append(seg)
        total += len(seg)
        val = nxt
    delta = int(rng.integers(1, 49))
    ans = val + delta
    prompt = "".join(parts) + f"{val}+{delta}="
    return prompt, f"{ans};"


_KEYWORDS = ["def ", "for ", "if ", "ret ", "let ", "fn "]
_NAMES = ["foo", "bar", "baz", "qux", "acc", "tmp", "idx", "val"]


def _gen_codelike(rng: Rng, approx_len: int) -> Tuple[str, str]:
    lines = []
    total = 0
    while total < approx_len - 24:
        kw = _KEYWORDS[int(rng.integers(0, len(_KEYWORDS)))]
        a = _NAMES[int(rng.integers(0, len(_NAMES)))]
        b = _NAMES[int(rng.integers(0, len(_NAMES)))]
        indent = "  " * int(rng.integers(0, 3))
        line = f"{indent}{kw}{a}({b}):\n"
        lines.append(line)
        total += len(line)
    # The answer continues the dominant pattern: a close-paren + return line.
    prompt = "".join(lines) + "  ret "
    ans = _NAMES[int(rng.integers(0, len(_NAMES)))]
    return prompt, f"{ans}\n"


def _gen_qalike(rng: Rng, approx_len: int) -> Tuple[str, str]:
    n_facts = max(2, (approx_len - 16) // 10)
    keys = rng.permutation(100)[: min(n_facts, 100)]
    facts = []
    values = {}
    for k in keys:
        v = int(rng.integers(10, 99))
        values[int(k)] = v
        facts.append(f"k{int(k):02d}=v{v}.")
    needle = int(keys[int(rng.integers(0, len(keys)))])
    prompt = "".join(facts) + f"Q:k{needle:02d}?A:"
    return prompt, f"v{values[needle]}."


_SENTS = [
    "the quick brown fox jumps over the lazy dog",
    "rain falls softly on the quiet harbor town",
    "markets rallied as rates held steady today",
    "the committee approved the final budget plan",
]


def _gen_summlike(rng: Rng, approx_len: int) -> Tuple[str, str]:
    lead = _SENTS[int(rng.integers(0, len(_SENTS)))]
    body = [lead + ". "]
    total = len(body[0])
    while total < approx_len - len(lead) - 16:
        s = _SENTS[int(rng.integers(0, len(_SENTS)))]
        # Noisy repetition: occasionally perturb a word.
        if rng.random() < 0.2:
            s = s.replace(" the ", " a ", 1)
        body.append(s + ". ")
        total += len(s) + 2
    prompt = "".join(body) + "TLDR: "
    return prompt, lead[:24]


WORKLOADS: Dict[str, WorkloadSpec] = {
    "mathlike": WorkloadSpec("mathlike", _gen_mathlike, ctx_scale=512, out_scale=8),
    "codelike": WorkloadSpec("codelike", _gen_codelike, ctx_scale=768, out_scale=8),
    "qalike": WorkloadSpec("qalike", _gen_qalike, ctx_scale=1024, out_scale=6),
    "summlike": WorkloadSpec("summlike", _gen_summlike, ctx_scale=1280, out_scale=16),
}


def make_prompt(workload: str, rng: Rng, approx_len: int = 0) -> Tuple[str, str]:
    spec = WORKLOADS[workload]
    return spec.gen(rng, approx_len or spec.ctx_scale)


def make_batch(
    workload: str,
    batch: int,
    seq_len: int,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens, loss_mask) for LM training on a workload mix.

    ``workload`` may be a name or "mixed".
    """
    from repro_torch.data.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    rng = np.random.default_rng(seed)
    names = list(WORKLOADS) if workload == "mixed" else [workload]
    rows, masks = [], []
    for i in range(batch):
        name = names[int(rng.integers(0, len(names)))]
        prompt, ans = make_prompt(name, rng, approx_len=seq_len)
        ids = tok.encode(prompt + ans)
        row = tok.pad_to(ids, seq_len + 1)
        mask = (row != tok.pad_id).astype(np.float32)
        rows.append(row)
        masks.append(mask)
    return np.stack(rows), np.stack(masks)
