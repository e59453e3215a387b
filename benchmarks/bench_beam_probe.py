#!/usr/bin/env python
"""Beam-search stub probe: decompose the prefix-beam decode cost and
bound each attack class (the last hot component without a measured
ceiling — featurizer, fwd/bwd scans, dpack, and CTC all have one).

    python benchmarks/bench_beam_probe.py [--platform cpu] [--small]

Per frame the vmapped scan body of the exact prefix-beam decode runs: one [B, W+W*E] top_k, a [B, W, W*E] two-lane
hash-equality merge (compare/select + one logadd), the candidate score
algebra, and ~8 parent-indexed gathers for the winner reshuffle.

Ladder (identical scan/vmap/shape structure; stubs break decode
semantics by construction — they bound, they don't ship):

- full:     ops/beam.beam_search_decode as SHIPPED (softmax, scan,
            materialize, ordering) — which, since this probe's finding
            landed, means the one-hot winner reshuffle
- scan:     the scan + materialize only, PINNED to the gather-form
            reshuffle (select='gather') — the ladder's baseline anchor:
            every stub below is gather-form, so their deltas are read
            against this arm
- scan_onehot: the same scan with the shipped one-hot reshuffle
            (select='onehot') — scan vs scan_onehot is the one-hot
            vs gather A/B in the stub harness
- notopk:   top_k -> first-W slice (ceiling for ANY selection attack:
            partial top-k, iterative max, bucketed select)
- itermax:  the SHIPPABLE selection candidate: W iterative argmax+mask
            passes (exact top_k semantics, first-index tie order)
            instead of the library top_k over all W*(E+1) candidates
- nomerge:  hash-equality merge dropped (ceiling for merge attacks)
- nogather: winner reshuffle gathers -> identity (parent = slot id;
            ceiling for gather/reindex attacks)
- empty:    carry-through step (scan + vmap structure floor; keeps the
            per-frame input consumption and backpointer emission)

MIN over rounds; reps passes over the set stack scanned inside one
program, so one dispatch + one scalar fetch is amortized over many
batches.  [ref: core/ctc_utils.py::decode
— tf.nn.ctc_beam_search_decoder, the reference's provider of this op.]
"""

import argparse
import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from asr_study_tpu.ops import beam as B                 # noqa: E402
from asr_study_tpu.ops.ctc import LOG_EPS, _logadd      # noqa: E402
from asr_study_tpu.utils.platform import (              # noqa: E402
    setup_compilation_cache,
)


def _stub_step(beam_width: int, blank_id: int, vocab: int, variant: str):
    """ops/beam._make_step with ``variant`` sections stubbed.  Keeps the
    scan carry/backpointer structure and per-frame input consumption
    identical so only the targeted work is removed."""
    n_char = vocab - 1
    n_ext = n_char
    w_idx = jnp.arange(beam_width)

    def step(state, inp):
        lengths, last, p_b, p_nb, hashes, hashes2, lm_state = state
        lp, valid = inp

        if variant == "empty":
            # consume the frame, keep the carry, emit identity pointers
            bump = lp[blank_id] * 0.0
            state = (lengths, last, p_b + bump, p_nb, hashes, hashes2,
                     lm_state)
            return state, (w_idx, jnp.full((beam_width,), -1, jnp.int32))

        lp_blank = lp[blank_id]
        chars = jnp.arange(n_char, dtype=jnp.int32)
        lp_c_1d = lp[:n_char]

        p_tot = _logadd(p_b, p_nb)
        stay_pb = p_tot + lp_blank
        lp_last = jnp.where(last >= 0, lp[jnp.maximum(last, 0)], LOG_EPS)
        stay_pnb = p_nb + lp_last
        lp_c = lp_c_1d[None, :]
        is_last = chars[None, :] == last[:, None]
        ext_pnb_2d = jnp.where(is_last, p_b[:, None], p_tot[:, None]) + lp_c
        ext_pnb = ext_pnb_2d.reshape(-1)
        ext_h1 = (hashes[:, None] * jnp.uint32(B._HASH_MULT)
                  + (chars[None, :] + 1).astype(jnp.uint32)).reshape(-1)
        ext_h2 = (hashes2[:, None] * jnp.uint32(B._HASH_MULT2)
                  + (chars[None, :] + 1).astype(jnp.uint32)).reshape(-1)

        if variant == "nomerge":
            ext_score = ext_pnb
        else:
            eq = ((ext_h1[None, :] == hashes[:, None])
                  & (ext_h2[None, :] == hashes2[:, None]))
            absorbed = jnp.max(
                jnp.where(eq, ext_pnb[None, :], LOG_EPS), axis=1
            )
            stay_pnb = _logadd(stay_pnb, absorbed)
            ext_score = jnp.where(jnp.any(eq, axis=0), LOG_EPS, ext_pnb)
        stay_score = _logadd(stay_pb, stay_pnb)

        scores = jnp.concatenate([stay_score, ext_score])
        if variant == "notopk":
            sel = w_idx + (scores[:beam_width] * 0.0).astype(jnp.int32)
        elif variant == "itermax":
            # SHIPPABLE candidate: k iterative argmax+mask passes (exact
            # top_k semantics incl. first-index tie order) instead of the
            # library top_k's sort of all W*(E+1) candidates.
            def pick(s, _):
                i = jnp.argmax(s)
                return s.at[i].set(-jnp.inf), i
            _, sel = jax.lax.scan(pick, scores, None, length=beam_width)
        else:
            _, sel = jax.lax.top_k(scores, beam_width)
        is_stay = sel < beam_width
        eflat = jnp.maximum(sel - beam_width, 0)
        if variant == "nogather":
            parent = w_idx
            ext_char = chars[w_idx % n_ext]
            new_last = jnp.where(is_stay, last, ext_char)
            new_lengths = lengths + (~is_stay).astype(jnp.int32)
            new_pb = jnp.where(is_stay, stay_pb, LOG_EPS)
            new_pnb = jnp.where(is_stay, stay_pnb, ext_pnb[:beam_width])
            new_h1 = jnp.where(is_stay, hashes, ext_h1[:beam_width])
            new_h2 = jnp.where(is_stay, hashes2, ext_h2[:beam_width])
        else:
            parent = jnp.where(is_stay, sel, eflat // n_ext)
            ext_char = chars[eflat % n_ext]
            new_last = jnp.where(is_stay, last[parent], ext_char)
            new_lengths = lengths[parent] + (~is_stay).astype(jnp.int32)
            new_pb = jnp.where(is_stay, stay_pb[parent], LOG_EPS)
            new_pnb = jnp.where(is_stay, stay_pnb[parent], ext_pnb[eflat])
            new_h1 = jnp.where(is_stay, hashes[parent], ext_h1[eflat])
            new_h2 = jnp.where(is_stay, hashes2[parent], ext_h2[eflat])
        new_lm = lm_state

        new_state = (new_lengths, new_last, new_pb, new_pnb, new_h1,
                     new_h2, new_lm)
        state = jax.tree_util.tree_map(
            lambda n, o: jnp.where(valid, n, o), new_state, state
        )
        bp_parent = jnp.where(valid, parent, w_idx)
        bp_char = jnp.where(valid & ~is_stay, ext_char, jnp.int32(-1))
        return state, (bp_parent, bp_char)

    return step


def stub_decode(log_probs, lengths, beam_width, blank_id, variant):
    """_decode_single with the step swapped; scan/vmap/materialize
    structure mirrors it exactly."""
    t_max, vocab = log_probs.shape[1], log_probs.shape[2]

    if variant == "real":
        stepf = B._make_step(beam_width, blank_id, vocab, 0,
                             select="gather")
    elif variant == "real_onehot":
        stepf = B._make_step(beam_width, blank_id, vocab, 0,
                             select="onehot")
    else:
        stepf = _stub_step(beam_width, blank_id, vocab, variant)

    def one(lp_t, ln):
        frame_valid = jnp.arange(t_max) < ln
        state, (bp_parent, bp_char) = jax.lax.scan(
            stepf, B.beam_stream_init(beam_width), (lp_t, frame_valid)
        )
        prefixes, _e, _s = B._materialize(bp_parent, bp_char, -1)
        return prefixes, _logadd(state[2], state[3])

    lp_tm = jnp.transpose(log_probs, (1, 0, 2))
    prefixes, scores = jax.vmap(one, in_axes=(1, 0))(
        lp_tm, lengths.astype(jnp.int32)
    )
    return prefixes.sum() + scores.sum()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--reps", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--width", type=int, default=16)
    ap.add_argument(
        "--variants", nargs="*",
        default=["full", "scan", "scan_onehot", "notopk", "itermax",
                 "nomerge", "nogather", "empty"],
    )
    args = ap.parse_args()
    if args.platform:
        from asr_study_tpu.utils.platform import select_platform

        select_platform(args.platform)
    setup_compilation_cache()

    T, Bb, V = (32, 4, 8) if args.small else (512, 32, 29)
    W = min(args.width, 4) if args.small else args.width
    n_sets = 2 if args.small else 4
    rng = np.random.RandomState(0)
    logits = jnp.asarray(rng.randn(n_sets, Bb, T, V).astype(np.float32) * 2)
    lp = jax.nn.log_softmax(logits, axis=-1)
    lens = jnp.full((n_sets, Bb), T, jnp.int32)

    def timed(label, fn, stacks):
        @jax.jit
        def loop(*st):
            def one_pass(acc, _):
                def body(a, xs):
                    return a + fn(*xs), None
                acc, _ = jax.lax.scan(body, acc, st)
                return acc, None
            acc, _ = jax.lax.scan(
                one_pass, jnp.float32(0), None, length=args.reps
            )
            return acc

        ref = float(loop(*stacks))
        best = float("inf")
        for _ in range(args.rounds):
            t0 = time.perf_counter()
            got = float(loop(*stacks))
            best = min(best, time.perf_counter() - t0)
        assert got == ref
        ms = best * 1000.0 / (n_sets * args.reps)
        print(f"{label:10s} {ms:8.3f} ms/batch", flush=True)
        return ms

    res = {}
    for v in args.variants:
        if v == "full":
            res[v] = timed(v, lambda lg, ln: jnp.sum(
                B.beam_search_decode(lg, ln, beam_width=W)[2]),
                (logits, lens))
        else:
            vv = {"scan": "real", "scan_onehot": "real_onehot"}.get(v, v)
            res[v] = timed(v, lambda lp_s, ln, vv=vv: stub_decode(
                lp_s, ln, W, V - 1, vv), (lp, lens))

    print(json.dumps({
        "metric": "beam_stub_probe_ms", "unit": "ms/batch",
        "shape": f"T{T}xB{Bb}xV{V}xW{W}", **res,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
