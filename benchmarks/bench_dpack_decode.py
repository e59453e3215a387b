#!/usr/bin/env python
"""Internal benchmark: on-chip dpack wire decode, with the pcm16 unpack
for scale.

    python benchmarks/bench_dpack_decode.py [--platform cpu] [--small]

Methodology matches bench.py's chip loop: the bench's 8 wire buffers are
stacked and scanned inside ONE jitted program (repeated --reps times on
distinct data so XLA can't hoist the body), reduced to a checksum; one
dispatch + one scalar fetch per timing round, so neither the per-call
dispatch nor the wire transfer is charged to the decode.  MIN over
--rounds.
"""

import argparse
import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from asr_study_tpu.data import wire                       # noqa: E402
from asr_study_tpu.utils.platform import (                # noqa: E402
    setup_compilation_cache,
)

SR = 16000


def synth_batches(rng, n_batches, batch, seconds):
    batches, total = [], 0.0
    for _ in range(n_batches):
        durs = rng.uniform(*seconds, size=batch)
        wavs = []
        for d in durs:
            n = int(d * SR)
            t = np.arange(n) / SR
            f0 = rng.uniform(80, 250)
            sig = sum(np.sin(2 * np.pi * f0 * (k + 1) * t) / (k + 1)
                      for k in range(4)) + 0.1 * rng.randn(n)
            wavs.append((sig / np.abs(sig).max() * 0.5).astype(np.float32))
        total += float(durs.sum())
        batches.append(wavs)
    return batches, total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--small", action="store_true",
                    help="tiny shapes (CI/CPU smoke)")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--modes", nargs="*", default=["pcm16", "dpack"],
                    help="subset of modes")
    args = ap.parse_args()
    if args.platform:
        from asr_study_tpu.utils.platform import select_platform

        select_platform(args.platform)
    setup_compilation_cache()

    batch = 4 if args.small else 32
    n_batches = 2 if args.small else 8
    seconds = (0.5, 1.0) if args.small else (3.0, 8.0)
    rng = np.random.RandomState(0)
    batches, audio_s = synth_batches(rng, n_batches, batch, seconds)
    n_pad = int(seconds[1] * SR + 2048) // 2048 * 2048

    # shared caps: one compiled program per mode for the whole stack
    cap, scap = wire.dpack_measure(batches, batch)
    d_stack = jnp.asarray(np.stack([
        wire.pack_audio(w, cap, batch=batch, codec="dpack", scap=scap)
        for w in batches
    ]))
    cap16 = max(wire.wire_cap(batch, sum(len(x) for x in w))
                for w in batches)
    p_stack = jnp.asarray(np.stack([
        wire.pack_audio(w, cap16, batch=batch) for w in batches
    ]))

    def timed(label, stack, unpack_fn):
        @jax.jit
        def loop(stack):
            def body(acc, flat):
                wavs, lens = unpack_fn(flat)
                return acc + wavs.sum() + lens.sum().astype(jnp.float32), None
            reps = jnp.concatenate([stack] * args.reps)
            acc, _ = jax.lax.scan(body, jnp.float32(0), reps)
            return acc

        ref = float(loop(stack))                     # compile + warm
        best = float("inf")
        for _ in range(args.rounds):
            t0 = time.perf_counter()
            got = float(loop(stack))                 # fetch = the sync
            best = min(best, time.perf_counter() - t0)
        assert got == ref
        ms = best * 1000.0 / (n_batches * args.reps)
        print(f"{label:14s} {ms:8.3f} ms/batch   "
              f"(checksum {ref:.1f})")
        return ms

    runs = {
        "pcm16": ("pcm16", p_stack,
                  lambda f: wire.unpack_audio(f, batch, n_pad)),
        "dpack": ("dpack", d_stack,
                  lambda f: wire.dpack_unpack(f, batch, n_pad, scap)),
    }
    res = {m: timed(*runs[m]) for m in args.modes}
    # decoded output parity (bit-exact)
    a, _ = jax.jit(lambda f: wire.unpack_audio(f, batch, n_pad))(p_stack[0])
    b, _ = jax.jit(
        lambda f: wire.dpack_unpack(f, batch, n_pad, scap)
    )(d_stack[0])
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    print(json.dumps({
        "metric": "dpack_decode_ms_per_batch", "unit": "ms",
        "audio_s_per_batch": audio_s / n_batches, **res,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
