"""Draft proposers + accept utilities for speculative decoding (DESIGN.md
§15), in PyTorch: the counterpart of the JAX package's
``serving/speculative.py``.

The decode arena's speculative path splits each iteration into a cheap
*draft* phase (propose up to ``k`` tokens per slot) and ONE masked
multi-token *verify* step over the whole arena.  Greedy verification
commits the longest draft prefix the target model itself would have
emitted, so the output stream is token-exact with plain decode — drafts
only change how many serial steps it takes to produce it.

Two proposers:

* :class:`NGramDraft` — draft-free lookahead: a per-slot suffix-match
  table over the prompt + already-generated tokens.  The most recent
  earlier occurrence of the current 2-gram (falling back to 1-gram)
  suffix proposes the tokens that followed it — free drafts that hit
  hard on repetitive continuations (code, templated text) and simply
  propose nothing when the history has no match (the slot decodes
  normally that iteration).
* :class:`ModelDraft` — the two-model path: a small draft model runs its
  own dense slot arena in lock-step with the target worker's and
  proposes its greedy continuations.  Rejection recovery is automatic:
  every draft phase starts from the slot's *committed* position and
  token, and the draft cache's garbage beyond that position is never
  attended to (reads are capped at the committed position) and is
  overwritten by the next proposal pass.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch


def accept_length(drafts: Sequence[int], outputs: Sequence[int]) -> int:
    """Longest accepted draft prefix: ``a`` such that ``drafts[j] ==
    outputs[j]`` for all ``j < a``.  ``outputs[j]`` is the target's greedy
    argmax at the position draft ``j`` was fed, so accepting exactly this
    prefix (and emitting ``outputs[a]`` as the bonus token) reproduces the
    sequential greedy stream token for token."""
    a = 0
    for d, o in zip(drafts, outputs):
        if int(d) != int(o):
            break
        a += 1
    return a


# ---------------------------------------------------------------------------
# Draft-free n-gram lookahead
# ---------------------------------------------------------------------------
class NGramDraft:
    """Per-slot suffix-match proposer over prompt + generated history.

    The index maps every n-gram (n <= ``max_ngram``) to the most recent
    position it ended at *that has a continuation*, so a lookup always
    yields at least one follow-on token.  All host-side bookkeeping —
    no model calls, no device syncs."""

    kind = "ngram"

    def __init__(self, max_ngram: int = 2):
        self.max_ngram = max_ngram
        self._hist: Dict[int, List[int]] = {}
        self._index: Dict[int, Dict[Tuple[int, ...], int]] = {}

    # -- lifecycle -----------------------------------------------------
    def start(self, idx: int, rid: int, prompt_tokens: Sequence[int],
              first: int) -> None:
        del idx
        self._hist[rid] = []
        self._index[rid] = {}
        self.commit(0, rid, [int(t) for t in prompt_tokens] + [int(first)])

    def commit(self, idx: int, rid: int, tokens: Sequence[int]) -> None:
        """Append committed tokens, indexing each n-gram that just gained
        a continuation (the gram ending one position back)."""
        del idx
        hist = self._hist[rid]
        index = self._index[rid]
        for t in tokens:
            i = len(hist)           # position the new token will occupy
            for n in range(1, self.max_ngram + 1):
                if i - n >= 0:
                    index[tuple(hist[i - n:i])] = i - 1
            hist.append(int(t))

    def stop(self, idx: int, rid: int) -> None:
        del idx
        self._hist.pop(rid, None)
        self._index.pop(rid, None)

    # -- proposals -----------------------------------------------------
    def propose_all(self, items: Sequence[Tuple[int, int, int, int]],
                    k: Dict[int, int]) -> Dict[int, List[int]]:
        """``items`` is ``(idx, rid, last_tok, pos)`` per live speculative
        slot; ``k[idx]`` its draft budget.  Returns ``{idx: drafts}``
        (possibly shorter than the budget, possibly empty)."""
        out: Dict[int, List[int]] = {}
        for idx, rid, _last, _pos in items:
            hist = self._hist.get(rid)
            index = self._index.get(rid)
            drafts: List[int] = []
            if hist and index:
                for n in range(min(self.max_ngram, len(hist)), 0, -1):
                    p = index.get(tuple(hist[-n:]))
                    if p is not None:
                        drafts = hist[p + 1:p + 1 + k.get(idx, 0)]
                        break
            out[idx] = drafts
        return out


# ---------------------------------------------------------------------------
# Two-model draft path
# ---------------------------------------------------------------------------
class ModelDraft:
    """A draft model running its own dense slot arena beside the target's.

    ``model`` is any object with ``cfg``/``params``/``device`` (a
    :class:`~repro_torch.serving.workers.ModelHandle`); by default the caller
    passes the target's own handle — acceptance is then ~1 and the test
    suite exercises the full two-model dataflow without training a second
    model.  The draft arena mirrors the worker's slot indexing; each
    proposal pass runs ``k_max + 1`` masked batched draft steps (the +1
    writes the last draft's own KV row, so a fully-accepted round leaves
    the draft cache complete through the new committed position)."""

    kind = "model"

    def __init__(self, model: Any, seq: int, n_slots: int, max_len: int):
        self.model = model
        self.seq = seq
        self.n_slots = n_slots
        self.max_len = max_len
        self._caches: Any = None
        self._fns = None
        self._positions = np.zeros(n_slots, np.int32)

    def _jitted(self):
        if self._fns is None:
            from repro_torch.core.quality import _jitted_steps
            self._fns = _jitted_steps(self.model.cfg.name, self.seq,
                                      self.n_slots, self.max_len)
        return self._fns

    def _ensure(self):
        if self._caches is None:
            from repro_torch.models.transformer import init_cache
            self._caches = init_cache(self.model.cfg, self.n_slots,
                                      self.max_len, device=self.model.device)
        return self._caches

    # -- lifecycle -----------------------------------------------------
    def start(self, idx: int, rid: int, prompt_tokens: Sequence[int],
              first: int) -> None:
        del rid, first
        from repro_torch.core.quality import copy_cache_slot
        pre, _, _ = self._jitted()
        self._ensure()
        # lint: sync-ok(draft prefill: the prompt goes to the device once per landed request)
        toks = torch.as_tensor(np.asarray(prompt_tokens, np.int32)[None, :],
                               device=self.model.device)
        _, caches = pre(self.model.params, {"tokens": toks})
        self._caches = copy_cache_slot(self.model.cfg, self._caches,
                                       caches, idx)
        self._positions[idx] = self.seq

    def commit(self, idx: int, rid: int, tokens: Sequence[int]) -> None:
        # The draft cache self-corrects: accepted draft positions already
        # hold the committed tokens' KV, and everything beyond the
        # committed position is masked garbage the next pass overwrites.
        del idx, rid, tokens

    def stop(self, idx: int, rid: int) -> None:
        del rid
        self._positions[idx] = 0

    # -- proposals -----------------------------------------------------
    def propose_all(self, items: Sequence[Tuple[int, int, int, int]],
                    k: Dict[int, int]) -> Dict[int, List[int]]:
        if not items:
            return {}
        _, _, arena = self._jitted()
        self._ensure()
        k_max = max(k.get(idx, 0) for idx, _, _, _ in items)
        if k_max <= 0:
            return {idx: [] for idx, _, _, _ in items}
        mask = np.zeros(self.n_slots, bool)
        toks = np.zeros(self.n_slots, np.int32)
        pos = np.zeros(self.n_slots, np.int32)
        for idx, _rid, last_tok, p in items:
            mask[idx] = True
            toks[idx] = last_tok
            pos[idx] = p
            self._positions[idx] = p
        dev = self.model.device
        # lint: sync-ok(draft pass: the slot mask goes to the device once per verify step - CUDA-graph capture must stage it)
        dmask = torch.as_tensor(mask, device=dev)
        proposals: Dict[int, List[int]] = {idx: [] for idx, _, _, _ in items}
        # k_max proposal steps + one extra that only lands the last
        # draft's KV row (its output is discarded).
        for step in range(k_max + 1):
            nxt, self._caches = arena(
                self.model.params, self._caches,
                torch.as_tensor(toks[:, None], device=dev),  # lint: sync-ok(draft pass: tokens and positions go to the device k+1 times per verify step)
                torch.as_tensor(pos + step, device=dev), dmask)
            # lint: sync-ok(draft-side proposal pull - the k+1 small host reads per verify step are the two-model path's documented cost)
            nxt = np.asarray(nxt.cpu())
            if step < k_max:
                for idx, _rid, _lt, _p in items:
                    if step < k.get(idx, 0):
                        proposals[idx].append(int(nxt[idx]))
            toks = nxt
        return proposals
