#!/usr/bin/env python
"""Internal benchmark: CTC training-step throughput (BASELINE config 3).

Measures steady-state steps/s and audio-seconds/s for a deep BLSTM training
step on synthetic bucketed batches.  Not the driver's headline metric
(that's bench.py); used to tune precision / batch / scan options.

    python benchmarks/bench_train.py [--bf16] [--batch 32] [--steps 20]
"""

import argparse
import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from asr_study_tpu.models.zoo import build_model          # noqa: E402
from asr_study_tpu.train.trainer import Trainer, make_optimizer  # noqa: E402

SR = 16000
HOP_S = 0.01


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--time", type=int, default=512, help="frames per utt")
    ap.add_argument("--labels", type=int, default=48)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--runs", type=int, default=1,
                    help="back-to-back timed runs of --steps chained "
                         "steps; steps/s is reported from the MIN wall "
                         "and the max-min spread is reported as band_pct")
    ap.add_argument("--model", default="deep_blstm")
    ap.add_argument("--device_features", default=None,
                    choices=["fbank", "logfbank", "mfcc"],
                    help="feed RAW waveforms and featurize INSIDE the "
                         "train step (train.py --device_features) — "
                         "measures the in-step featurizer cost; --time "
                         "still sets the model's frame count (wav length "
                         "is derived)")
    ap.add_argument("--platform", default=None,
                    help="force a jax platform (e.g. cpu)")
    args = ap.parse_args()
    if args.platform:
        from asr_study_tpu.utils.platform import select_platform

        select_platform(args.platform)

    model = build_model(
        args.model,
        {"num_hiddens": args.hidden, "num_layers": args.layers,
         "dropout": 0.0},
        num_classes=27,
    )
    featurizer = None
    n_feats = 39
    rng = np.random.RandomState(0)
    if args.device_features:
        from asr_study_tpu.features.device import DeviceFeaturizer

        # wav length that yields exactly --time frames (no-center framing:
        # T = 1 + (N - frame_len) // step), rounded up to wire granularity
        n_samples = -(-((args.time - 1) * 160 + 400) // 2048) * 2048
        featurizer = DeviceFeaturizer(kind=args.device_features)
        n_feats = featurizer.num_feats
        inputs = jnp.asarray(
            rng.randn(args.batch, n_samples) * 0.1, jnp.float32
        )
        input_lengths = jnp.full((args.batch,), n_samples, jnp.int32)
    else:
        inputs = jnp.asarray(
            rng.randn(args.batch, args.time, 39), jnp.float32
        )
        input_lengths = jnp.full((args.batch,), args.time, jnp.int32)
    trainer = Trainer(
        model, make_optimizer("adam", 1e-4, 400.0),
        compute_dtype=jnp.bfloat16 if args.bf16 else None,
        featurizer=featurizer,
    )
    state = trainer.init_state(jax.random.PRNGKey(0), n_feats)
    labels = jnp.asarray(
        rng.randint(0, 27, (args.batch, args.labels)), jnp.int32
    )
    label_lengths = jnp.full((args.batch,), args.labels, jnp.int32)
    weights = jnp.ones((args.batch,), jnp.float32)
    key = jax.random.PRNGKey(1)

    def step(state):
        return trainer.train_step(
            state, inputs, input_lengths, labels, label_lengths, weights, key
        )

    state, m = step(state)  # compile
    jax.block_until_ready(m["loss"])
    walls = []
    for _ in range(args.runs):
        t0 = time.perf_counter()
        # Steps chain through `state`, so dispatching all of them and
        # waiting ONLY for the final loss times the whole sequence
        # without serializing dispatch behind completion per step.
        for _ in range(args.steps):
            state, m = step(state)
        jax.block_until_ready(m["loss"])
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    steps_per_s = args.steps / wall
    band_pct = (max(walls) - wall) / wall * 100.0
    audio_s = (
        args.batch * (inputs.shape[1] / SR) if featurizer is not None
        else args.batch * args.time * HOP_S
    )

    # FLOPs model (matmul terms only; elementwise/CTC are <2% here).
    # Per bidirectional layer per direction: input proj T*B*Fin*4H*2 +
    # recurrence T*B*H*4H*2; training ~= 3x forward (grad wrt activations
    # and wrt weights each cost roughly one forward of matmul FLOPs).
    b, t, h, nl = args.batch, args.time, args.hidden, args.layers
    if featurizer is not None:
        t = 1 + (inputs.shape[1] - 400) // 160   # actual model frames
    gates = 3 if "gru" in args.model else 4
    fin = [n_feats] + [2 * h] * (nl - 1)
    fwd_flops = sum(
        2 * (t * b * f * gates * h + t * b * h * gates * h) * 2
        for f in fin
    ) + 2 * t * b * (2 * h) * 28
    train_flops = 3 * fwd_flops
    from asr_study_tpu.utils.platform import peak_flops

    # the device's published dense peak for the matmul precision in use
    # (float32 matmuls run as TF32 at default precision); None on the CPU
    peak = peak_flops("bf16" if args.bf16 else "tf32")
    mfu = train_flops * steps_per_s / peak * 100.0 if peak else None

    print(json.dumps({
        "metric": "train_step_throughput",
        "steps_per_s": round(steps_per_s, 3),
        "runs": args.runs, "steps_per_run": args.steps,
        "band_pct": round(band_pct, 2),
        "runs_steps_per_s": [round(args.steps / w, 2) for w in walls],
        "audio_s_per_s": round(steps_per_s * audio_s, 1),
        "precision": "bf16" if args.bf16 else "f32",
        "loss": float(m["loss"]),
        "flops_per_step": train_flops,
        "mfu_pct": mfu,
        "device_kind": jax.devices()[0].device_kind,
        "batch": args.batch, "time": args.time,
        "model": f"{args.model}-{args.layers}x{args.hidden}",
        "device_features": args.device_features,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
