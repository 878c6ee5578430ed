"""Prompt ids of a request, from its ``(workload, prompt_seed)``: a frozen
copy of the arithmetic the serving runtime uses (three synthetic byte
workloads, a byte tokenizer with BOS 257 and PAD 256, the last ``seq``
ids kept or the row padded), so a later change to the program cannot
move what the reference reads."""
from __future__ import annotations

import numpy as np

PAD_ID = 256
BOS_ID = 257

_KEYWORDS = ["def ", "for ", "if ", "ret ", "let ", "fn "]
_NAMES = ["foo", "bar", "baz", "qux", "acc", "tmp", "idx", "val"]


def _mathlike(rng, approx_len: int) -> str:
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
    return "".join(parts) + f"{val}+{delta}="


def _codelike(rng, approx_len: int) -> str:
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
    return "".join(lines) + "  ret "


def _qalike(rng, approx_len: int) -> str:
    n_facts = max(2, (approx_len - 16) // 10)
    keys = rng.permutation(100)[: min(n_facts, 100)]
    facts = []
    for k in keys:
        v = int(rng.integers(10, 99))
        facts.append(f"k{int(k):02d}=v{v}.")
    needle = int(keys[int(rng.integers(0, len(keys)))])
    return "".join(facts) + f"Q:k{needle:02d}?A:"


GENERATORS = {"mathlike": _mathlike, "codelike": _codelike,
              "qalike": _qalike}


def prompt_ids(workload: str, prompt_seed: int, seq: int) -> np.ndarray:
    """The (seq,) int32 prompt of one request."""
    rng = np.random.default_rng(prompt_seed)
    text = GENERATORS[workload](rng, seq + 32)
    ids = [BOS_ID] + list(text.encode("utf-8", errors="replace"))
    if len(ids) >= seq:
        return np.asarray(ids[-seq:], dtype=np.int32)
    out = np.full((seq,), PAD_ID, dtype=np.int32)
    out[:len(ids)] = ids
    return out
