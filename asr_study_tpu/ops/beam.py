"""Vectorized CTC prefix beam search, fully on-device.

Replaces the reference's ``tf.nn.ctc_beam_search_decoder`` (C++ op)
[ref: core/ctc_utils.py::decode] with a dense fixed-width formulation that
jits and vmaps (SURVEY.md §7 hard-part 4):

- Beam state is dense arrays: lengths, last-char, rolling prefix hashes,
  and the classic (p_blank, p_nonblank) log-prob split per prefix.
- Each frame expands W beams into W*(1+C) candidates (stay / extend-with-c),
  merges candidates that denote the same prefix, and keeps the top W.
- Prefix identity for merging is a rolling 64-bit hash carried as TWO
  independent 32-bit lanes (different multiplicative constants — uint64 is
  unavailable without jax_enable_x64); a spurious merge needs a
  simultaneous collision in both lanes: ~N^2/2^65 per step, negligible even
  over T=512 x B=32 x W=64 decodes (the single-lane version's ~N^2/2^33
  budget eroded at that scale — VERDICT r1).

Two structural facts let the merge avoid sorts and segment scatters
entirely (an earlier lexsort + segment-logsumexp formulation was far
slower than greedy decoding):

1. Two EXTEND candidates can never denote the same string: extension
   appends exactly one char, so equal results force equal (parent, char),
   i.e. the same candidate.  Beam prefixes are pairwise distinct strings
   (invariant below), so stays are pairwise distinct too.
2. Therefore the only merges are stay(w) == extend(w', c), and each side
   of such a pair is unique: the string of stay(w) determines (w', c).

So the merge is a [W, W*E] two-lane hash equality match (pure elementwise
compare/select): each matched extend's p_nb is absorbed into its stay via
one logadd, matched extends are killed, and uniqueness of beam prefixes
is preserved — which is exactly the invariant fact 1 needs.

The decoded strings never enter the scan carry: the per-frame (parent,
emitted-char) backpointers are stacked outside and one short reverse scan
plus a single masked scatter materializes the [W, T] prefixes at the end.
No dynamic shapes anywhere: one top_k per frame.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from asr_study_tpu.ops.ctc import LOG_EPS, _logadd

# Plain Python ints, cast at trace time: a module-level ``jnp.uint32(...)``
# is an EAGER computation that initializes a jax backend at import, before
# a CLI's ``--platform`` could take effect.
_HASH_MULT = 0x9E3779B1   # golden-ratio multiplier (lane 1)
_HASH_MULT2 = 0x85EBCA77  # murmur3 fmix constant (lane 2)
_HASH_INIT = 1


def _u32_halves(h):
    """uint32 [N] -> two f32 columns < 2^16 (exactly representable, so a
    one-hot HIGHEST selection reproduces the value bit-for-bit)."""
    return (
        (h >> 16).astype(jnp.float32),
        (h & jnp.uint32(0xFFFF)).astype(jnp.float32),
    )


def _u32_join(hi, lo):
    return (
        (jnp.round(hi).astype(jnp.uint32) << 16)
        | jnp.round(lo).astype(jnp.uint32)
    )


def _i32_halves(v):
    """nonnegative int32 [N] -> two f32 half-columns (values like the LM
    context code can exceed 2^24, the f32 exact-integer bound)."""
    return (
        (v >> 16).astype(jnp.float32),
        (v & 0xFFFF).astype(jnp.float32),
    )


def _i32_join(hi, lo):
    return (
        (jnp.round(hi).astype(jnp.int32) << 16)
        | jnp.round(lo).astype(jnp.int32)
    )


def beam_stream_init(beam_width: int, lm_state0: int = 0):
    """Initial beam-scan carry (also the chunk-to-chunk streaming state):
    (lengths, last_char, p_blank, p_nonblank, hash_lane1, hash_lane2,
    lm_state).  ``lm_state0`` is the LM's start context
    (``CharNGramLM.init_state()``); it rides along as zeros when no LM is
    fused."""
    w_idx = jnp.arange(beam_width)
    lengths0 = jnp.zeros((beam_width,), jnp.int32)
    last0 = jnp.full((beam_width,), -1, jnp.int32)
    # Beam 0 = the empty prefix; the rest are dead placeholders with distinct
    # hashes so they never merge with anything live.
    p_b0 = jnp.full((beam_width,), LOG_EPS).at[0].set(0.0)
    p_nb0 = jnp.full((beam_width,), LOG_EPS)
    hash0 = (jnp.uint32(0xDEAD0000) + w_idx.astype(jnp.uint32)).at[0].set(
        _HASH_INIT
    )
    hash0b = (jnp.uint32(0xBEEF0000) + w_idx.astype(jnp.uint32)).at[0].set(
        _HASH_INIT
    )
    lm0 = jnp.full((beam_width,), lm_state0, jnp.int32)
    return (lengths0, last0, p_b0, p_nb0, hash0, hash0b, lm0)


def _make_step(beam_width: int, blank_id: int, vocab: int, prune: int,
               lm_logp=None, lm_order: int = 0,
               lm_alpha: float = 1.0, lm_beta: float = 0.0,
               select: Optional[str] = None):
    """The per-frame beam-update closure shared by the batch decoder and
    the streaming chunk decoder.

    With ``lm_logp`` ([S, vocab-1] dense char-n-gram table, see
    text/lm.py), every extension candidate's score gains
    ``lm_alpha * log p_lm(c | context) + lm_beta`` — classic shallow
    fusion (Hannun et al. 2014).  The LM term folds directly into the
    extension's p_nonblank, so merges, top-k and the returned scores all
    rank by the combined acoustic+LM objective; candidates denoting the
    same string carry identical LM mass, which keeps the stay==extend
    merge logadd exact.  The carried per-beam LM context updates with the
    base-C digit shift shared with ``CharNGramLM.next_state``.

    ``select``: 'onehot' (default, from ASR_BEAM_SELECT) routes the
    winner reshuffle through ONE candidate-field table [W+W*E, 12] and a
    one-hot HIGHEST-precision contraction instead of ~10 per-frame
    per-element gathers.  Selection is exact: floats ride as their own
    columns (a one-hot HIGHEST matmul reproduces f32 bit-for-bit), uint32
    hash lanes and the int32 LM context as two 16-bit half-columns each.
    'gather' keeps the indexed form.  Which is faster on the GPU is not
    measured yet.
    """
    n_char = vocab - 1                      # extensions exclude the blank
    if select is None:
        from asr_study_tpu.utils.env import choice_env

        select = choice_env("ASR_BEAM_SELECT", "onehot",
                            ("onehot", "gather"))
    elif select not in ("onehot", "gather"):
        raise ValueError(
            f"select={select!r}: choose one of ('onehot', 'gather')"
        )
    n_ext = n_char if prune <= 0 else min(prune, n_char)
    w_idx = jnp.arange(beam_width)
    if lm_logp is not None:
        if lm_logp.shape[1] != n_char:
            raise ValueError(
                f"LM alphabet {lm_logp.shape[1]} != decoder's {n_char} "
                "(the LM must be fit on the same label vocabulary, "
                "blank excluded)"
            )
        lm_mod = n_char ** max(lm_order - 2, 0)

    def step(state, inp):
        lengths, last, p_b, p_nb, hashes, hashes2, lm_state = state
        lp, valid = inp                                      # [V], scalar
        lp_blank = lp[blank_id]
        if n_ext < n_char:
            lp_c_1d, chars = jax.lax.top_k(lp[:n_char], n_ext)
            chars = chars.astype(jnp.int32)
        else:
            chars = jnp.arange(n_char, dtype=jnp.int32)
            lp_c_1d = lp[:n_char]

        # --- candidate scores -------------------------------------------
        p_tot = _logadd(p_b, p_nb)                           # [W]
        # stay (emit blank, or repeat last char without a blank between)
        stay_pb = p_tot + lp_blank                           # [W]
        if select == "onehot":
            # floor at LOG_EPS first: a -inf anywhere in lp (e.g.
            # caller-masked classes) would make the unselected products
            # 0.0 * -inf = NaN and poison EVERY row of the contraction;
            # the gather form never touches unselected entries.
            oh_last = jax.nn.one_hot(
                jnp.maximum(last, 0), vocab, dtype=jnp.float32
            )
            lp_sel = jnp.matmul(
                oh_last, jnp.maximum(lp, LOG_EPS),
                precision=jax.lax.Precision.HIGHEST,
            )
        else:
            lp_sel = lp[jnp.maximum(last, 0)]
        lp_last = jnp.where(last >= 0, lp_sel, LOG_EPS)
        stay_pnb = p_nb + lp_last                            # [W]
        # extend with char c: via-blank only if c == last, else from both
        lp_c = lp_c_1d[None, :]                              # [1, E]
        is_last = chars[None, :] == last[:, None]            # [W, E]
        ext_pnb_2d = (
            jnp.where(is_last, p_b[:, None], p_tot[:, None]) + lp_c
        )                                                    # [W, E]
        if lm_logp is not None:
            ctx_rows = jnp.take(lm_logp, lm_state, axis=0)   # [W, C]
            lm_lp = jnp.take(ctx_rows, chars, axis=1)        # [W, E]
            ext_pnb_2d = ext_pnb_2d + lm_alpha * lm_lp + lm_beta
        ext_pnb = ext_pnb_2d.reshape(-1)                     # [W*E]
        ext_h1 = (
            hashes[:, None] * jnp.uint32(_HASH_MULT)
            + (chars[None, :] + 1).astype(jnp.uint32)
        ).reshape(-1)
        ext_h2 = (
            hashes2[:, None] * jnp.uint32(_HASH_MULT2)
            + (chars[None, :] + 1).astype(jnp.uint32)
        ).reshape(-1)

        # --- merge: the ONLY possible merges are stay(w) == extend(w',c)
        # pairs, each 1:1 (module docstring fact 2), found by a two-lane
        # hash match — pure compare/select, no sort/scatter ------------
        eq = (
            (ext_h1[None, :] == hashes[:, None])
            & (ext_h2[None, :] == hashes2[:, None])
        )                                                    # [W, W*E]
        absorbed = jnp.max(
            jnp.where(eq, ext_pnb[None, :], LOG_EPS), axis=1
        )                                                    # <=1 hit each
        stay_pnb = _logadd(stay_pnb, absorbed)
        ext_score = jnp.where(jnp.any(eq, axis=0), LOG_EPS, ext_pnb)
        stay_score = _logadd(stay_pb, stay_pnb)

        # --- keep top W over [W stays | W*E extends] --------------------
        scores = jnp.concatenate([stay_score, ext_score])
        _, sel = jax.lax.top_k(scores, beam_width)

        # per-extension LM context (stay rows keep their parent's)
        if lm_logp is not None and lm_order >= 2:
            ext_lm = (
                (lm_state[:, None] % lm_mod) * n_char + chars[None, :]
            ).reshape(-1).astype(jnp.int32)                  # [W*E]
        else:
            ext_lm = jnp.broadcast_to(
                lm_state[:, None], (beam_width, n_ext)
            ).reshape(-1)

        if select == "onehot":
            # ONE candidate-field table + one-hot contraction instead
            # of ~10 per-element gathers.  Columns:
            # pb, pnb, last, length, parent, emitted-char(-1 for stays),
            # h1hi, h1lo, h2hi, h2lo, lmhi, lmlo — all selections exact
            # (see _u32_halves).
            fw = jnp.float32
            s_h1hi, s_h1lo = _u32_halves(hashes)
            s_h2hi, s_h2lo = _u32_halves(hashes2)
            s_lmhi, s_lmlo = _i32_halves(lm_state)
            # score columns floored at LOG_EPS: -inf would NaN the
            # contraction (0.0 * -inf) — see lp_sel above
            stay_tab = jnp.stack([
                jnp.maximum(stay_pb, LOG_EPS),
                jnp.maximum(stay_pnb, LOG_EPS),
                last.astype(fw), lengths.astype(fw),
                w_idx.astype(fw), jnp.full((beam_width,), -1.0, fw),
                s_h1hi, s_h1lo, s_h2hi, s_h2lo, s_lmhi, s_lmlo,
            ], axis=1)                                       # [W, 12]
            e_h1hi, e_h1lo = _u32_halves(ext_h1)
            e_h2hi, e_h2lo = _u32_halves(ext_h2)
            e_lmhi, e_lmlo = _i32_halves(ext_lm)
            ext_char_col = jnp.broadcast_to(
                chars[None, :].astype(fw), (beam_width, n_ext)
            ).reshape(-1)
            ext_len_col = jnp.broadcast_to(
                (lengths + 1)[:, None].astype(fw), (beam_width, n_ext)
            ).reshape(-1)
            ext_parent_col = jnp.broadcast_to(
                w_idx[:, None].astype(fw), (beam_width, n_ext)
            ).reshape(-1)
            ext_tab = jnp.stack([
                jnp.full_like(ext_pnb, LOG_EPS),
                jnp.maximum(ext_pnb, LOG_EPS),
                ext_char_col, ext_len_col, ext_parent_col, ext_char_col,
                e_h1hi, e_h1lo, e_h2hi, e_h2lo, e_lmhi, e_lmlo,
            ], axis=1)                                       # [W*E, 12]
            tab = jnp.concatenate([stay_tab, ext_tab], axis=0)
            oh = jax.nn.one_hot(
                sel, beam_width * (1 + n_ext), dtype=jnp.float32
            )
            picked = jnp.matmul(
                oh, tab, precision=jax.lax.Precision.HIGHEST
            )                                                # [W, 12]
            new_pb = picked[:, 0]
            new_pnb = picked[:, 1]
            new_last = jnp.round(picked[:, 2]).astype(jnp.int32)
            new_lengths = jnp.round(picked[:, 3]).astype(jnp.int32)
            parent = jnp.round(picked[:, 4]).astype(jnp.int32)
            sel_char = jnp.round(picked[:, 5]).astype(jnp.int32)
            new_h1 = _u32_join(picked[:, 6], picked[:, 7])
            new_h2 = _u32_join(picked[:, 8], picked[:, 9])
            new_lm = _i32_join(picked[:, 10], picked[:, 11])
        else:
            is_stay = sel < beam_width
            eflat = jnp.maximum(sel - beam_width, 0)         # ext cand id
            parent = jnp.where(is_stay, sel, eflat // n_ext)
            ext_char = chars[eflat % n_ext]
            sel_char = jnp.where(is_stay, jnp.int32(-1), ext_char)
            new_last = jnp.where(is_stay, last[parent], ext_char)
            new_lengths = lengths[parent] + (~is_stay).astype(jnp.int32)
            new_pb = jnp.where(is_stay, stay_pb[parent], LOG_EPS)
            new_pnb = jnp.where(
                is_stay, stay_pnb[parent], ext_pnb[eflat]
            )
            new_h1 = jnp.where(is_stay, hashes[parent], ext_h1[eflat])
            new_h2 = jnp.where(is_stay, hashes2[parent], ext_h2[eflat])
            new_lm = jnp.where(is_stay, lm_state[parent], ext_lm[eflat])

        new_state = (
            new_lengths, new_last, new_pb, new_pnb, new_h1, new_h2, new_lm
        )
        # padded frames: carry state through unchanged, emit no char and
        # identity backpointers (the reconstruction walks through them)
        state = jax.tree_util.tree_map(
            lambda n, o: jnp.where(valid, n, o), new_state, state
        )
        bp_parent = jnp.where(valid, parent, w_idx)
        bp_char = jnp.where(valid, sel_char, jnp.int32(-1))
        return state, (bp_parent, bp_char)

    return step


def _materialize(bp_parent, bp_char, pad_id: int):
    """Backpointer rows [T, W] -> (prefixes [W, T], emit_counts [W],
    start_slots [W]).  ``start_slots[w]`` is the beam slot at the START of
    this span that final beam ``w`` descends from — the thread a streaming
    caller uses to splice chunk outputs onto its carried prefixes."""
    t_max, beam_width = bp_parent.shape
    w_idx = jnp.arange(beam_width)

    # walk slots backward, then one masked scatter places each emitted
    # char at its cumulative position
    def back(slots, inp):
        par_t, chr_t = inp
        return par_t[slots], chr_t[slots]

    start_slots, rev_chars = jax.lax.scan(
        back, w_idx, (bp_parent[::-1], bp_char[::-1])
    )
    chars_tw = rev_chars[::-1]                               # [T, W]
    emitted = chars_tw >= 0
    pos = jnp.cumsum(emitted.astype(jnp.int32), axis=0) - 1
    scat_pos = jnp.where(emitted, pos, t_max)                # OOB -> drop
    prefixes = jnp.full((beam_width, t_max), pad_id, jnp.int32)
    prefixes = prefixes.at[
        jnp.broadcast_to(w_idx[None, :], (t_max, beam_width)), scat_pos
    ].set(chars_tw, mode="drop")
    return prefixes, jnp.sum(emitted, axis=0), start_slots


def beam_stream_chunk(
    log_probs: jax.Array,   # [t, V] log-softmax for one chunk
    valid: jax.Array,       # [t] bool frame mask
    state,                  # from beam_stream_init / the previous chunk
    beam_width: int,
    blank_id: int,
    prune: int = 0,
    pad_id: int = -1,
    lm=None,
    lm_alpha: float = 1.0,
    lm_beta: float = 0.0,
):
    """Advance the beam over one chunk (streaming form of the decoder).

    -> (state, chunk_prefixes [W, t], chunk_emits [W], start_slots [W],
    scores [W]): beam ``w`` extends the PREVIOUS chunk's beam
    ``start_slots[w]`` with ``chunk_prefixes[w, :chunk_emits[w]]``.
    Beams are NOT score-ordered (ordering would break the slot threading);
    order by ``scores`` only at end-of-stream.

    ``lm`` (a ``text.lm.CharNGramLM``) enables shallow fusion; the initial
    ``state`` must then come from
    ``beam_stream_init(W, lm.init_state())``.
    """
    step = _make_step(
        beam_width, blank_id, log_probs.shape[-1], prune,
        lm_logp=None if lm is None else jnp.asarray(lm.logp),
        lm_order=0 if lm is None else lm.order,
        lm_alpha=lm_alpha, lm_beta=lm_beta,
    )
    state, (bp_parent, bp_char) = jax.lax.scan(
        step, state, (log_probs, valid)
    )
    prefixes, emits, start_slots = _materialize(bp_parent, bp_char, pad_id)
    scores = _logadd(state[2], state[3])
    return state, prefixes, emits, start_slots, scores


def _decode_single(
    log_probs: jax.Array,   # [T, V] log-softmax, blank = V-1
    length: jax.Array,      # scalar int
    beam_width: int,
    blank_id: int,
    pad_id: int,
    prune: int = 0,         # 0 = exact; else expand only the per-frame
                            # top-`prune` characters (standard pruning)
    lm=None,
    lm_alpha: float = 1.0,
    lm_beta: float = 0.0,
):
    t_max, vocab = log_probs.shape
    step = _make_step(
        beam_width, blank_id, vocab, prune,
        lm_logp=None if lm is None else jnp.asarray(lm.logp),
        lm_order=0 if lm is None else lm.order,
        lm_alpha=lm_alpha, lm_beta=lm_beta,
    )
    frame_valid = jnp.arange(t_max) < length
    state, (bp_parent, bp_char) = jax.lax.scan(
        step,
        beam_stream_init(
            beam_width, 0 if lm is None else lm.init_state()
        ),
        (log_probs, frame_valid),
    )
    lengths, last, p_b, p_nb = state[:4]
    prefixes, _emits, _start = _materialize(bp_parent, bp_char, pad_id)

    scores = _logadd(p_b, p_nb)
    order = jnp.argsort(-scores)
    return prefixes[order], lengths[order], scores[order]


def beam_search_decode(
    logits: jax.Array,          # [B, T, V]
    logit_lengths: jax.Array,   # [B]
    beam_width: int = 16,
    blank_id: Optional[int] = None,
    pad_id: int = -1,
    top_paths: int = 1,
    prune: int = 0,
    lm=None,
    lm_alpha: float = 1.0,
    lm_beta: float = 0.0,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """CTC prefix beam search over a batch.

    Returns (decoded [B, P, T], lengths [B, P], log_scores [B, P]) with
    ``P = top_paths`` beams ordered best-first — the shape of the reference's
    ``decode(..., beam_width=..., top_paths=...)`` API.

    ``prune > 0`` expands only the per-frame top-``prune`` characters
    (standard prefix-beam pruning): candidate count drops from
    W*(1+|V|-1) to W*(1+prune), a large speedup at negligible accuracy
    cost when the acoustic posteriors are peaked.

    ``lm`` (a ``text.lm.CharNGramLM`` over the label alphabet, blank
    excluded) enables shallow fusion: beams rank by
    ``log p_acoustic + lm_alpha * log p_lm + lm_beta * |prefix|`` and the
    returned scores are that combined objective.  The dense LM table rides
    as a jit constant; pruning (acoustic top-K) composes unchanged.
    """
    vocab = logits.shape[-1]
    if blank_id is None:
        blank_id = vocab - 1
    if blank_id != vocab - 1:
        raise ValueError("beam_search_decode requires blank as the last id")
    log_probs = jax.nn.log_softmax(logits, axis=-1)
    log_probs = jnp.transpose(log_probs, (1, 0, 2))          # time-major

    def one(lp_t, ln):
        return _decode_single(
            lp_t, ln, beam_width, blank_id, pad_id, prune=prune,
            lm=lm, lm_alpha=lm_alpha, lm_beta=lm_beta,
        )

    prefixes, lengths, scores = jax.vmap(one, in_axes=(1, 0))(
        log_probs, logit_lengths.astype(jnp.int32)
    )
    # mask tails beyond each prefix length to pad_id
    t_max = prefixes.shape[-1]
    mask = jnp.arange(t_max)[None, None, :] < lengths[..., None]
    prefixes = jnp.where(mask, prefixes, pad_id)
    return (
        prefixes[:, :top_paths],
        lengths[:, :top_paths],
        scores[:, :top_paths],
    )
