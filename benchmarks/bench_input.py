#!/usr/bin/env python
"""Internal benchmark: host input-pipeline throughput (batch assembly).

Host-side batch assembly must outpace the jitted train step or
real-corpus training throttles below the synthetic-tensor numbers.
Measures ms/batch for the three batch sources:

- in-memory rows (``DatasetGenerator.flow`` — small splits)
- lazy vlen HDF5 streaming (reference-compatible layout)
- lazy packed .npy streaming (``make_dataset --layout packed``)

Pure host code — no accelerator.

    python benchmarks/bench_input.py [--n 2048] [--batch 32]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from asr_study_tpu.data.dataset_parser import write_h5     # noqa: E402
from asr_study_tpu.data.generator import DatasetGenerator  # noqa: E402


class _SyntheticRows:
    """Feature-parser stand-in: deterministic [T, F] rows keyed by the fake
    utterance path, with duration proportional to T (as real corpora are)."""

    def __init__(self, lens, num_feats):
        self._lens = lens
        self.num_feats = num_feats

    def __call__(self, path):
        i = int(path[1:])
        rng = np.random.default_rng(i)
        return rng.standard_normal(
            (int(self._lens[i]), self.num_feats)
        ).astype(np.float32)

    def __str__(self):
        return "synthetic"


class _Labels:
    vocab = "abc"

    def _clean(self, s):
        return s

    def map(self, s):
        return np.arange(5, dtype=np.int32)

    def is_valid(self, s):
        return True


def _time_epochs(it, epochs):
    for b in it.epoch(seed=0):      # warm: page cache, handles, shapes
        pass
    t0 = time.perf_counter()
    n = 0
    for ep in range(epochs):
        for b in it.epoch(seed=ep):
            n += 1
    return (time.perf_counter() - t0) / n * 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048, help="utterances")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--feats", type=int, default=39)
    ap.add_argument("--min_frames", type=int, default=200)
    ap.add_argument("--max_frames", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    lens = rng.integers(args.min_frames, args.max_frames, size=args.n)
    feat = _SyntheticRows(lens, args.feats)
    utts = [
        {"audio": f"u{i}", "label": "abc", "duration": float(lens[i]) * 0.01}
        for i in range(args.n)
    ]

    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for layout in ("vlen", "packed"):
            # vlen: an HDF5 file; packed: a directory of .npy arrays
            paths[layout] = os.path.join(
                tmp, "vlen.h5" if layout == "vlen" else "packed"
            )
            write_h5(paths[layout], {"train": utts}, feat, _Labels(),
                     layout=layout)

        gen = DatasetGenerator(batch_size=args.batch, shuffle=False)
        results = {
            "in_memory": _time_epochs(
                gen.flow_from_h5(paths["vlen"], "train", lazy=False),
                args.epochs,
            ),
            "lazy_vlen": _time_epochs(
                gen.flow_from_h5(paths["vlen"], "train", lazy=True),
                args.epochs,
            ),
            "lazy_packed": _time_epochs(
                gen.flow_from_h5(paths["packed"], "train", lazy=True),
                args.epochs,
            ),
        }
    for name, ms in results.items():
        print(json.dumps({
            "metric": f"input_pipeline_ms_per_batch_{name}",
            "value": round(ms, 3),
            "unit": "ms_per_batch",
            "batch": args.batch,
            "n_utts": args.n,
        }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
