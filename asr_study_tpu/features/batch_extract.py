"""Batched on-device feature extraction for dataset building.

The reference's dataset build [ref: extras/make_dataset.py] extracts
features one utterance at a time on the host CPU — the slowest stage of
its pipeline on real corpora.  ``DeviceFeatureExtractor`` runs the same
chain on the accelerator in length-bucketed batches: wavs are padded to a
few static shapes (one compiled program per bucket), features come back
trimmed to each utterance's true frame count, in the original order.

Parity note: this is the f32 device chain (device.py),
eps-level equal to the f64 NumPy oracle in the linear domain but with a
documented worst case on near-silent mel channels in the log domain
(tests/test_features_device.py); pass ``log_floor=1e-2`` for tight
(<2e-3) parity, or keep the default host oracle for bit-level
reference-compat datasets.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np

from asr_study_tpu.features.wav import read_wav


class DeviceFeatureExtractor:
    """Drop-in for a host ``Feature`` in dataset building, executing the
    feature chain on the accelerator in batches.

    Accepts the same constructor options as the host classes (kind +
    DeviceFeaturizer kwargs).  ``__call__(audio)`` handles a single
    utterance (API compat; still batched under the hood via
    ``extract_batch``).
    """

    def __init__(self, kind: str = "mfcc", fs: int = 16000,
                 batch: int = 32, align: int = 16384,
                 wire_codec: str = "pcm16", **kw):
        if wire_codec not in ("pcm16", "dpack"):
            raise ValueError(
                f"wire_codec {wire_codec!r}: dataset builds support pcm16 "
                "(default) or dpack (lossless compression, ~25% fewer "
                "wire bytes on speech) — mulaw is lossy and would bake "
                "its quantization into the dataset"
            )
        self.kind = kind
        self.fs = fs
        self.batch = int(batch)
        self.align = int(align)
        self.wire_codec = wire_codec
        self._kw = kw
        self._featurizer = None
        self._serve_cache = {}
        self._pool = None

    def _fetch_pool(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(8)
        return self._pool

    def _build(self):
        if self._featurizer is not None:
            return self._featurizer
        from asr_study_tpu.features.device import DeviceFeaturizer

        self._featurizer = DeviceFeaturizer(
            kind=self.kind, fs=self.fs, **self._kw
        )
        return self._featurizer

    @property
    def num_feats(self) -> int:
        return self._build().num_feats

    def _load(self, audio) -> np.ndarray:
        if isinstance(audio, (str, bytes)):
            return read_wav(audio, sr=self.fs)[0]
        return np.asarray(audio, np.float32)

    def _serve(self, n_rows: int, n_pad: int, scap=None):
        """Jitted wire->features program for one (rows, padded-len[,
        scap]) shape, cached per shape (a fresh closure per call would
        retrace)."""
        featurizer = self._build()
        key = (n_rows, n_pad, scap, id(featurizer))
        if key in self._serve_cache:
            return self._serve_cache[key]
        import jax

        from asr_study_tpu.data import wire

        @jax.jit
        def serve(flat):
            wavs, lens = wire.unpack_audio(
                flat, n_rows, n_pad, codec=self.wire_codec, scap=scap
            )
            return featurizer._transform(wavs, lens)

        self._serve_cache[key] = serve
        return serve

    def extract_batch(self, audios: Sequence) -> List[np.ndarray]:
        """-> per-utterance [T_i, F] float32 arrays, original order.

        Audio crosses host->device in the ragged int16 wire format
        (data/wire.py): no padding bytes, 4x fewer than padded f32.  PCM16
        quantization is a no-op for audio that lived on disk as 16-bit
        wavs (all supported corpora).
        """
        from asr_study_tpu.data import wire

        wavs = [self._load(a) for a in audios]
        # length buckets -> few static shapes (compile cache friendly)
        order = sorted(range(len(wavs)), key=lambda i: len(wavs[i]))
        out: List[np.ndarray] = [None] * len(wavs)  # type: ignore
        # dispatch every bucket first (async), then fetch: transfers of
        # batch k+1 overlap compute of batch k
        pending = []
        for start in range(0, len(order), self.batch):
            idxs = order[start: start + self.batch]
            group = [wavs[i] for i in idxs]
            n_pad = -(-max(len(w) for w in group) // self.align)
            n_pad *= self.align
            total = sum(len(w) for w in group)
            if self.wire_codec == "dpack":
                # scap bucketed COARSELY (16-block granularity): each
                # distinct (n_pad, scap) pair is a compile
                grain = 16 * 4096
                scap = max(grain, -(-total // grain) * grain)
                enc = wire.dpack_encode(group)
                need = 2 * self.batch + scap // 4096 + enc[2].shape[0]
                cap = -(-need // self.align) * self.align
                # ONE host encode per group: sizing and packing share it
                # (pack_audio's dpack branch would re-encode)
                flat = wire.dpack_pack(group, cap, scap,
                                       batch=self.batch, enc=enc)
            else:
                scap = None
                cap = wire.wire_cap(self.batch, total, self.align)
                flat = wire.pack_audio(group, cap, batch=self.batch,
                                       codec=self.wire_codec)
            feats, feat_lens = self._serve(self.batch, n_pad, scap)(flat)
            pending.append((idxs, feats, feat_lens))
        # concurrent fetches overlap the device->host copies; one pool per
        # extractor instance, not per call — write_split calls this once
        # per 256-utterance chunk
        flat_list = [a for (_, f, l) in pending for a in (f, l)]
        got = list(self._fetch_pool().map(np.asarray, flat_list))
        for k, (idxs, _, _) in enumerate(pending):
            feats, feat_lens = got[2 * k], got[2 * k + 1]
            for r, i in enumerate(idxs):
                out[i] = np.ascontiguousarray(
                    feats[r, : int(feat_lens[r])], np.float32
                )
        return out

    def __call__(self, audio) -> np.ndarray:
        return self.extract_batch([audio])[0]

    def __str__(self) -> str:
        # datasets stamp str(parser) into attrs["feature"]; keep the kind
        # name so eval/predict pick the matching host parser by default
        return self.kind
