#!/usr/bin/env python
"""Headline benchmark: RTF (audio-sec / wall-sec / chip) for the full
inference pipeline — feature extraction + BLSTM + CTC greedy decode — on
LapsBM-shaped utterances (BASELINE.json config 2; target > 50x real time
per chip).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
``vs_baseline`` is value / 50 (the north-star target; the reference itself
has no published numbers — BASELINE.md).  Extra keys:

- ``flops_per_batch``: analytic FLOP count of the compiled pipeline
  (DFT + mel/DCT matmuls + BLSTM input/recurrent projections + classifier).
- ``mfu_pct``: achieved FLOP/s over the device's published dense TF32
  peak (utils/platform.py; the model's float32 matmuls run as TF32 at
  default precision, the featurizer's at HIGHEST); null on the CPU.
- ``onchip_ms_per_batch`` / ``rtf_onchip``: per-batch device time with all
  N batches scanned inside ONE jitted program on device-resident inputs
  (no host transfer, no per-call dispatch, one scalar fetch).
- ``device_kind``, ``gpu``: the device as jax reports it, and the card's
  name and power limit as nvidia-smi reports them.

Methodology:
- LapsBM audio is not shipped, so the benchmark synthesizes batches with
  LapsBM-like durations (~3-8 s at 16 kHz), padded to one static bucket
  so a single compiled program serves every batch.
- Audio crosses host->device as ONE flat int16 buffer per batch
  (utterances back to back + offsets, data/wire.py), unpacked to the
  padded [B, T] tensor on device.
- Steady-state throughput over several in-flight batches (async dispatch
  pipelines H2D with compute), ended by fetching every decoded output;
  ROUNDS rounds, min and median wall reported.
- Without an accelerator the benchmark refuses to run, except in smoke
  mode (ASR_BENCH_SMOKE=1: CPU, tiny shapes, numbers meaningless), which
  the test suite uses to exercise the whole code path.
"""

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import jax
import jax.numpy as jnp

from asr_study_tpu.data import wire
from asr_study_tpu.features.device import DeviceFeaturizer
from asr_study_tpu.models.zoo import build_model
from asr_study_tpu.ops.ctc import greedy_decode
from asr_study_tpu.utils.platform import (
    card_name_and_power_limit, peak_flops, setup_compilation_cache,
)

SMOKE = os.environ.get("ASR_BENCH_SMOKE", "") not in ("", "0")
if SMOKE:
    from asr_study_tpu.utils.platform import select_platform

    select_platform("cpu")

SR = 16000
# Wire encoding for the H2D audio transfer (data/wire.py): dpack
# (LOSSLESS delta + per-block bit-packing, decoded on device,
# bit-identical to pcm16), pcm16 (raw), or mulaw (8-bit companded, lossy —
# NOT a headline configuration).
WIRE_CODEC = os.environ.get("ASR_BENCH_WIRE_CODEC", "dpack")
# The round's batches cross to the device in this many coalesced
# transfers: fewer transfers amortize per-transfer setup, more let chunk
# k's compute overlap chunk k+1's transfer.
N_CHUNKS = int(os.environ.get("ASR_BENCH_WIRE_CHUNKS", "2"))
BATCH = 4 if SMOKE else 32
N_BATCHES = 2 if SMOKE else 8
ROUNDS = 2 if SMOKE else 7
SECONDS = (0.5, 1.0) if SMOKE else (3.0, 8.0)  # LapsBM-like durations
TARGET_RTF = 50.0
HIDDEN = 64 if SMOKE else 256
LAYERS = 1 if SMOKE else 2
NUM_CLASSES = 27


def synth_batch(rng: np.random.RandomState):
    """Synthetic speech-like wavs (mixed tones + noise), LapsBM durations."""
    durs = rng.uniform(*SECONDS, size=BATCH)
    wavs = []
    for d in durs:
        n = int(d * SR)
        t = np.arange(n) / SR
        f0 = rng.uniform(80, 250)
        sig = sum(
            np.sin(2 * np.pi * f0 * (k + 1) * t) / (k + 1) for k in range(4)
        )
        sig += 0.1 * rng.randn(n)
        wavs.append((sig / np.abs(sig).max() * 0.5).astype(np.float32))
    return wavs, float(durs.sum())


def pipeline_flops(featurizer, t_frames: int, num_feats: int) -> float:
    """Analytic FLOPs per batch of the compiled pipeline (2*M*N*K per
    matmul; elementwise/reduction terms are <1% and ignored)."""
    b, t = BATCH, t_frames
    frame_len = featurizer.frame_len
    k_bins = featurizer.nfft // 2 + 1
    nfilt = featurizer.nfilt
    ncep = featurizer.num_cep
    fl = 0.0
    fl += 2 * 2.0 * b * t * frame_len * k_bins        # DFT cos+sin matmuls
    fl += 2.0 * b * t * k_bins * nfilt                # mel projection
    fl += 2.0 * b * t * nfilt * ncep                  # DCT
    # BLSTM: per layer per direction, input proj + T recurrent matmuls
    f_in = num_feats
    for _ in range(LAYERS):
        per_dir = (
            2.0 * t * b * f_in * 4 * HIDDEN           # hoisted input proj
            + t * 2.0 * b * HIDDEN * 4 * HIDDEN       # recurrence
        )
        fl += 2 * per_dir                             # bidirectional
        f_in = 2 * HIDDEN
    fl += 2.0 * t * b * f_in * (NUM_CLASSES + 1)      # classifier
    return fl


def main() -> int:
    device = jax.devices()[0]
    if device.platform == "cpu" and not SMOKE:
        print(
            "bench.py measures an accelerator and jax found none; "
            "ASR_BENCH_SMOKE=1 runs the CPU smoke mode",
            file=sys.stderr,
        )
        return 1
    t_start = time.time()
    setup_compilation_cache()
    rng = np.random.RandomState(0)
    raw_batches = []
    total_audio = 0.0
    n_pad = int(SECONDS[1] * SR + 2048) // 2048 * 2048
    for _ in range(N_BATCHES):
        wavs, audio_s = synth_batch(rng)
        total_audio += audio_s
        raw_batches.append(wavs)

    # Ragged one-transfer wire format (data/wire.py — also the predict
    # CLI's --on_device serving path): each batch ships ONE flat int16
    # buffer (length header + utterances back to back); offsets are
    # recomputed on device.  Each batch packs at its own aligned size;
    # the compiled program still sees one static [cap] shape because the
    # device slices cap words starting at the batch's offset, and
    # trailing reads into the NEXT batch's bytes are harmless by
    # construction (dpack reads only its own widths/payload; pcm16/mulaw
    # read only header+samples).
    if WIRE_CODEC == "dpack":
        scap = max(
            wire.dpack_measure([wavs], BATCH)[1] for wavs in raw_batches
        )
        caps = []
        for wavs in raw_batches:
            _, widths, payload, _ = wire.dpack_encode(wavs)
            need = 2 * BATCH + scap // 4096 + payload.shape[0]
            caps.append(-(-need // 256) * 256)
    else:
        scap = None
        caps = [
            wire.wire_cap(BATCH, sum(len(w) for w in wavs), align=256,
                          codec=WIRE_CODEC)
            for wavs in raw_batches
        ]
    cap = max(caps)
    batches = [
        wire.pack_audio(wavs, c, batch=BATCH, codec=WIRE_CODEC,
                        scap=scap)[:c]
        for wavs, c in zip(raw_batches, caps)
    ]
    # Coalesced transfer: the timed region ships the round as N_CHUNKS
    # flat buffers.  Within a chunk the batches ride back to back ordered
    # smallest-first, so the LAST batch is the largest and the
    # [cap]-word device slice at its offset needs (almost) no tail
    # padding.
    per_chunk = -(-N_BATCHES // max(1, N_CHUNKS))
    chunks, chunk_offs = [], []
    for c0 in range(0, N_BATCHES, per_chunk):
        idxs = sorted(range(c0, min(c0 + per_chunk, N_BATCHES)),
                      key=lambda i: caps[i])
        offs = np.cumsum([0] + [caps[i] for i in idxs[:-1]])
        flat = np.concatenate(
            [batches[i] for i in idxs]
            + [np.zeros(cap - caps[idxs[-1]], np.int16)]
        )
        chunks.append(flat)
        chunk_offs.append(offs)

    featurizer = DeviceFeaturizer(kind="mfcc", d=True, dd=True)
    model = build_model(
        "deep_blstm", {"num_hiddens": HIDDEN, "num_layers": LAYERS,
                       "dropout": 0.0},
        num_classes=NUM_CLASSES,
    )
    params = model.init(jax.random.PRNGKey(0), featurizer.num_feats)

    # the on-chip loop repeats the batch set inside the program so one
    # dispatch + one scalar fetch is amortized over many batches
    chip_reps = 1 if SMOKE else 4

    def pipeline(params, flat_i16):
        wavs_f, wav_lengths = wire.unpack_audio(
            flat_i16, BATCH, n_pad, codec=WIRE_CODEC, scap=scap
        )
        feats, feat_lengths = featurizer._transform(wavs_f, wav_lengths)
        logits = model.apply(params, feats, feat_lengths, train=False)
        return greedy_decode(logits, feat_lengths, blank_id=model.blank_id)

    @jax.jit
    def chip_loop(params, flat_stack):
        # All N batches in ONE program: a lax.scan over the stacked wire
        # buffers, reduced to a checksum.  The batches hold distinct
        # audio, so XLA cannot hoist the body.
        def body(acc, flat):
            d, dl = pipeline(params, flat)
            return acc + d.sum() + dl.sum(), None
        reps = jnp.concatenate([flat_stack] * chip_reps)
        acc, _ = jax.lax.scan(body, jnp.int32(0), reps)
        return acc

    infer = jax.jit(pipeline)

    @jax.jit
    def slice_batch(chunk_flat, off):
        # device-side: carve one batch's static [cap] window out of the
        # tightly packed chunk
        return jax.lax.dynamic_slice_in_dim(chunk_flat, off, cap)

    def run_round():
        """Dispatch one full round: per-chunk H2D + per-batch inference.
        Everything is async; fetch() is the sync point."""
        outs = []
        for ch, offs in zip(chunks, chunk_offs):
            dev = jnp.asarray(ch)
            for off in offs:
                outs.append(infer(params, slice_batch(dev, off)))
        return outs

    fetch_pool = ThreadPoolExecutor(16)

    def fetch(outs):
        # the decoded outputs land on the host, as a user needs them
        flat = [a for pair in outs for a in pair]
        got = list(fetch_pool.map(np.asarray, flat))
        return list(zip(got[0::2], got[1::2]))

    fetch(run_round())  # compile + warm every program of the round

    walls = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        fetch(run_round())
        walls.append(time.perf_counter() - t0)

    # ON-CHIP compute: the same N batches scanned inside one jitted
    # program on device-resident inputs — no host transfer, no per-call
    # dispatch, one scalar fetch.
    flat_stack = jax.device_put(jnp.stack([
        jnp.pad(jnp.asarray(f), (0, cap - f.shape[0])) for f in batches
    ]))
    int(chip_loop(params, flat_stack))  # compile + warm
    onchip_walls = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        int(chip_loop(params, flat_stack))  # scalar fetch = the sync
        onchip_walls.append(time.perf_counter() - t0)
    onchip_s = min(onchip_walls) / (N_BATCHES * chip_reps)

    t_frames = int(
        np.ceil((n_pad - featurizer.frame_len) / featurizer.frame_step)
    ) + 1
    fl_batch = pipeline_flops(featurizer, t_frames, featurizer.num_feats)
    peak = peak_flops("tf32", device)
    wall = min(walls)
    rtf = total_audio / wall
    wire_bytes = sum(c.nbytes for c in chunks)
    print(json.dumps({
        "metric": "rtf_feature_blstm_greedy_lapsbm_like",
        "value": rtf,
        "unit": "x_realtime_per_chip",
        "vs_baseline": rtf / TARGET_RTF,
        "featurizer": "xla",
        "flops_per_batch": round(fl_batch),
        "mfu_pct": 100 * fl_batch / onchip_s / peak if peak else None,
        "onchip_ms_per_batch": onchip_s * 1e3,
        "rtf_onchip": total_audio / (onchip_s * N_BATCHES),
        "wall_s_min": wall,
        "wall_s_median": float(np.median(walls)),
        "rounds": ROUNDS,
        "batches_in_flight": N_BATCHES,
        "wire_codec": WIRE_CODEC,
        "wire_mb": wire_bytes / 1e6,
        "wire_chunks": len(chunks),
        "elapsed_s": time.time() - t_start,
        "platform": device.platform,
        "device_kind": device.device_kind,
        "gpu": card_name_and_power_limit(),
        **({"smoke": True} if SMOKE else {}),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
