"""Character n-gram language model for beam-search shallow fusion.

The reference decodes with acoustic scores only (TF's beam decoder has no
LM hook [ref: core/ctc_utils.py::decode]); production CTC systems of its
era rescored with a character/word n-gram LM inside the prefix beam
(Hannun et al. 2014, "First-pass large vocabulary speech recognition").
This module supplies that capability in a device-friendly shape: the whole LM
is ONE dense ``[S, C]`` log-probability table over base-C positional
context codes, so in-beam scoring is a row gather and the context update
is integer arithmetic — no tries, no hashing, nothing host-side in the
decode loop.

Context encoding (the contract shared with ``ops/beam.py``):

- ``C = n_char`` is the label alphabet size (CTC blank excluded).
- A context is the last ``order-1`` characters, encoded base-C with the
  MOST RECENT character in digit 0::

      state = sum_i char[t-1-i] * C**i,   i in [0, order-2]

- Appending character ``c``::

      state' = (state % C**(order-2)) * C + c      (order >= 2)

  which drops the oldest digit, shifts, and inserts ``c`` at digit 0.
  For ``order == 1`` the single state is 0.
- Text start is padded with ``space_id`` (the word separator), so the
  initial state is the all-space context.

Smoothing is interpolated add-``delta`` across orders (rows are proper
distributions, unlike stupid backoff)::

    p_k(c | ctx) = (count_k(ctx, c) + delta * p_{k-1}(c | ctx[:-1]))
                   / (count_k(ctx) + delta)

with an add-one unigram base, folded into the dense table at fit time.
"""

from __future__ import annotations

import json
from typing import Iterable, Sequence

import numpy as np


class CharNGramLM:
    """Dense char n-gram LM: ``logp[state, c] = log p(c | context state)``.

    ``logp`` has shape ``[C**(order-1), C]`` float32; every row sums to 1
    in probability space.
    """

    def __init__(self, logp: np.ndarray, order: int, space_id: int,
                 vocab: str = ""):
        n_char = logp.shape[1]
        if logp.shape[0] != n_char ** (order - 1):
            raise ValueError(
                f"logp shape {logp.shape} inconsistent with order {order}"
            )
        if not 0 <= space_id < n_char:
            raise ValueError(f"space_id {space_id} outside alphabet")
        self.logp = np.asarray(logp, np.float32)
        self.order = int(order)
        self.n_char = int(n_char)
        self.space_id = int(space_id)
        self.vocab = vocab

    # -- context-state arithmetic (mirrored on-device in ops/beam.py) ----
    def init_state(self) -> int:
        """The all-space start context."""
        s = 0
        for _ in range(self.order - 1):
            s = s * self.n_char + self.space_id
        return s

    def next_state(self, state: int, char: int) -> int:
        if self.order == 1:
            return 0
        mod = self.n_char ** (self.order - 2)
        return (state % mod) * self.n_char + char

    # -- host-side scoring (tests, perplexity, rescoring) ----------------
    def score_ids(self, ids: Sequence[int]) -> float:
        """log P(ids) under the LM (natural log), space-padded start."""
        state, total = self.init_state(), 0.0
        for c in ids:
            total += float(self.logp[state, int(c)])
            state = self.next_state(state, int(c))
        return total

    def perplexity(self, seqs: Iterable[Sequence[int]]) -> float:
        total, n = 0.0, 0
        for ids in seqs:
            total += self.score_ids(ids)
            n += len(ids)
        return float(np.exp(-total / max(n, 1)))

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        meta = json.dumps({
            "order": self.order,
            "space_id": self.space_id,
            "vocab": self.vocab,
        })
        np.savez_compressed(path, logp=self.logp, meta=np.array(meta))

    @classmethod
    def load(cls, path: str) -> "CharNGramLM":
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            return cls(z["logp"], meta["order"], meta["space_id"],
                       meta.get("vocab", ""))


def check_lm_vocab(lm: "CharNGramLM", parser_vocab: str) -> None:
    """Fail loudly when the LM's stored alphabet differs from the run's.

    ops/beam.py can only validate table SIZES; a same-size LM fit on a
    different vocabulary (or a different ordering) would silently look
    up every character's score under the wrong id and quietly degrade
    CER.  LMs saved before the vocab field existed ('' sentinel) pass —
    there is nothing to compare."""
    if lm.vocab and lm.vocab != parser_vocab:
        raise SystemExit(
            f"--lm alphabet mismatch: the LM was fit on vocab "
            f"{lm.vocab!r} but this run decodes with {parser_vocab!r}; "
            "refit the LM on this run's dataset (extras/train_lm.py)"
        )


def fit_ngram_lm(
    seqs: Iterable[Sequence[int]],
    order: int,
    n_char: int,
    space_id: int,
    delta: float = 1.0,
    vocab: str = "",
) -> CharNGramLM:
    """Fit a dense char n-gram LM from id sequences.

    Counts only the top-order n-grams (one ``np.add.at`` pass); every
    lower order's counts are exact marginals over the oldest context
    digit, so the interpolation recursion runs on dense arrays bottom-up.
    """
    if order < 1:
        raise ValueError("order must be >= 1")
    if not 0 <= space_id < n_char:
        raise ValueError(f"space_id {space_id} outside alphabet 0..{n_char-1}")
    s_top = n_char ** (order - 1)
    counts = np.zeros((s_top, n_char), np.float64)
    mod = n_char ** max(order - 2, 0)
    n_seqs = 0
    for ids in seqs:
        ids = np.asarray(ids, np.int64)
        n_seqs += 1
        if ids.size == 0:
            continue
        if ids.min() < 0 or ids.max() >= n_char:
            raise ValueError(
                f"sequence contains ids outside 0..{n_char-1} "
                f"(got min {ids.min()}, max {ids.max()})"
            )
        if order == 1:
            np.add.at(counts, (0, ids), 1.0)
            continue
        # context codes: start at the all-space context, then fold
        states = np.empty(ids.size, np.int64)
        s = 0
        for _ in range(order - 1):
            s = s * n_char + space_id
        for j, c in enumerate(ids):
            states[j] = s
            s = (s % mod) * n_char + c
        np.add.at(counts, (states, ids), 1.0)
    if n_seqs == 0:
        raise ValueError("no training sequences given")

    # unigram base: add-one over total character counts
    cnt_k = counts
    for _ in range(order - 1):  # marginalize to [1, C]
        c_alpha = cnt_k.shape[0] // n_char
        cnt_k = cnt_k.reshape(n_char, c_alpha, n_char).sum(axis=0)
    p = (cnt_k + 1.0) / (cnt_k.sum() + n_char)          # [1, C]

    # interpolate upward: level k has C**(k-1) contexts; its backoff row
    # is the context's most recent k-2 chars = ctx % C**(k-2), i.e. each
    # lower-order row tiles across the oldest-digit axis.
    for k in range(2, order + 1):
        s_k = n_char ** (k - 1)
        cnt_k = counts
        for _ in range(order - k):  # marginalize top counts down to level k
            c_alpha = cnt_k.shape[0] // n_char
            cnt_k = cnt_k.reshape(n_char, c_alpha, n_char).sum(axis=0)
        back = np.tile(p, (s_k // p.shape[0], 1))        # [S_k, C]
        tot = cnt_k.sum(axis=1, keepdims=True)
        p = (cnt_k + delta * back) / (tot + delta)
    return CharNGramLM(
        np.log(p).astype(np.float32), order, space_id, vocab
    )
