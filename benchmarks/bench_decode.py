#!/usr/bin/env python
"""Internal benchmark: CTC decoding throughput, greedy vs. prefix beam
search at several widths (BASELINE config 4).

    python benchmarks/bench_decode.py [--widths 4 16 64] [--batch 32]
"""

import argparse
import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from asr_study_tpu.ops import beam_search_decode, greedy_decode  # noqa: E402

HOP_S = 0.01


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--time", type=int, default=512)
    ap.add_argument("--vocab", type=int, default=28)
    ap.add_argument("--widths", type=int, nargs="*", default=[4, 16])
    ap.add_argument("--prune", type=int, default=0)
    ap.add_argument("--collapse", type=float, default=0.0,
                    help="blank-collapse threshold (0 = off)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--platform", default=None,
                    help="force a jax platform (e.g. cpu)")
    args = ap.parse_args()
    if args.platform:
        from asr_study_tpu.utils.platform import select_platform

        select_platform(args.platform)

    rng = np.random.RandomState(0)
    # speech-like emissions: ~65% of frames blank-dominated (a trained CTC
    # model's posteriors), so --collapse shows its real effect
    K = 8  # distinct logit tensors scanned inside ONE program: per-call
    #        timing would be dispatch-bound, and a loop-INVARIANT body
    #        would be CSE'd by XLA
    raw = rng.randn(K, args.batch, args.time, args.vocab).astype(np.float32)
    is_blank = rng.rand(K, args.batch, args.time) < 0.65
    raw[..., -1] += np.where(is_blank, 10.0, -10.0)
    stack = jax.device_put(jnp.asarray(raw))
    lengths = jnp.full((args.batch,), args.time, jnp.int32)
    audio_s = args.batch * args.time * HOP_S

    def timed(decode_one):
        """decode_one(logits) -> pytree; returns best seconds/call over
        `iters` runs of a K-deep scan (one dispatch + one scalar fetch)."""
        @jax.jit
        def loop(stack):
            def body(acc, lg):
                leaves = jax.tree_util.tree_leaves(decode_one(lg))
                s = sum(jnp.sum(x).astype(jnp.float32) for x in leaves)
                return acc + s, None
            acc, _ = jax.lax.scan(body, jnp.float32(0), stack)
            return acc
        float(loop(stack))  # compile + warm
        ts = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            float(loop(stack))
            ts.append(time.perf_counter() - t0)
        return min(ts) / K

    results = {
        "greedy": round(
            audio_s / timed(lambda lg: greedy_decode(lg, lengths)), 1
        )
    }
    from asr_study_tpu.ops import blank_collapse

    for w in args.widths:
        if args.collapse > 0:
            def f(lg, w=w):
                lg2, ln2, _ = blank_collapse(
                    lg, lengths, threshold=args.collapse, keep_ratio=0.5,
                )
                return beam_search_decode(
                    lg2, ln2, beam_width=w, prune=args.prune
                )
        else:
            def f(lg, w=w):
                return beam_search_decode(
                    lg, lengths, beam_width=w, prune=args.prune
                )
        tag = f"beam{w}" + (f"_p{args.prune}" if args.prune else "") + (
            f"_c{args.collapse}" if args.collapse else ""
        )
        results[tag] = round(audio_s / timed(f), 1)
    print(json.dumps({
        "metric": "decode_rtf", "unit": "x_realtime_per_chip",
        "batch": args.batch, "time": args.time, **results,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
