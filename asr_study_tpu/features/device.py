"""On-device (JAX/XLA) feature extraction: batched wav -> MFCC/log-fbank.

The device counterpart of the NumPy oracle in audio.py (which is the
spec — golden parity tests compare the two).  Design notes:

- The rFFT is a **matmul-DFT**: frames [B*T, frame_len] times fixed cos/sin
  matrices [frame_len, nfft//2+1].  For 25 ms frames that is a 400x257
  matmul per frame, fused by XLA with the windowing and the mel/DCT
  matmuls that follow.  ``jnp.fft.rfft`` (cuFFT on the GPU) is the
  untested alternative.
- Everything is batched and static-shaped: one compiled program per padded
  bucket, variable lengths handled by masking (frames beyond a wav's
  ``num_frames`` are garbage but masked by the returned feat_lengths).
- Deltas use per-utterance edge replication via clipped gathers, matching
  the oracle's ``np.pad(mode='edge')`` exactly even inside padded batches.
- All parity-critical matmuls run at ``precision='highest'`` (plain
  float32; the GPU's default TF32 or bf16 would break the
  bit-for-bit-within-tolerance target, BASELINE.md).

[ref: preprocessing/audio.py] for the chain being mirrored.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from asr_study_tpu.features import audio

_PREC = jax.lax.Precision.HIGHEST

# DFT-matmul precision knob.  Default "highest" (plain float32) keeps the
# parity contract; "high" and "default" trade accuracy for speed (on the
# GPU "default" means TF32 tensor cores).
from asr_study_tpu.utils.env import choice_env

_DFT_PREC = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}[choice_env("ASR_FEAT_MM_PRECISION", "highest",
             ("highest", "high", "default"))]


def device_num_frames(wav_lengths: jax.Array, frame_len: int,
                      frame_step: int, center: bool = False) -> jax.Array:
    """Vector version of audio.num_frames (both framing conventions)."""
    if center:
        return 1 + wav_lengths // frame_step
    # integer ceil-div, NOT a float32 round trip: sample counts above
    # 2^24 lose integer precision in f32 and can come out one frame
    # short of the float64 oracle (audio.num_frames) — exact for any
    # int32 length this way
    extra = (wav_lengths - frame_len + frame_step - 1) // frame_step
    return jnp.where(wav_lengths <= frame_len, 1, 1 + extra)


def _center_pad_batch(pre: jax.Array, wav_lengths: jax.Array, pad: int,
                      pad_mode: str) -> jax.Array:
    """librosa centering for a padded batch [B, N] -> [B, N + 2*pad].

    The left pad is row-independent (every row starts at sample 0); the
    RIGHT reflection pivots on each row's own length, so it is written by
    a per-row dynamic_update_slice (scan — same DMA-friendly idiom as the
    wire unpack).  Matches audio.center_pad exactly for rows longer than
    ``pad`` samples (shorter rows would need numpy's bounce-back
    multi-reflection; real utterances are never < frame_len//2)."""
    b, n = pre.shape
    if pad_mode == "constant":
        return jnp.pad(pre, ((0, 0), (pad, pad)))
    if pad_mode != "reflect":
        raise ValueError(f"unknown pad_mode {pad_mode!r}")
    left = pre[:, 1: pad + 1][:, ::-1]
    body = jnp.pad(pre, ((0, 0), (0, pad)))

    def row(carry, sig_len):
        sig, ln = sig_len
        start = jnp.maximum(ln - 1 - pad, 0)
        tail = jax.lax.dynamic_slice_in_dim(sig, start, pad)[::-1]
        # rows shorter than the window keep zeros instead of reflections
        tail = jnp.where(ln > pad, tail, jnp.zeros_like(tail))
        sig = jax.lax.dynamic_update_slice_in_dim(sig, tail, ln, 0)
        return carry, sig

    _, body = jax.lax.scan(row, 0, (body, wav_lengths))
    return jnp.concatenate([left, body], axis=1)


def _dft_matrices(frame_len: int, nfft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT bases [frame_len, nfft//2+1] (zero-pad to nfft folded
    in: rows beyond frame_len would be zero, so they are simply absent)."""
    n = np.arange(frame_len)[:, None]
    k = np.arange(nfft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / nfft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def _delta_device(feat: jax.Array, lengths: jax.Array, n: int = 2) -> jax.Array:
    """Regression delta with per-utterance edge replication.

    feat [B, T, F], lengths [B] -> [B, T, F]; matches audio.delta row-for-row
    on each utterance's first ``lengths[b]`` frames.

    Gather-free: static shifts + boundary fills are elementwise and fuse
    into one pass, where ``take_along_axis`` over the time axis would be
    a per-element gather.  Frames beyond
    ``lengths[b]`` are garbage (they were edge-clipped before); every
    consumer masks by feat_lengths, and delta-of-delta stays exact on
    real frames because pass 1 is exact on frames ``<= lengths[b]-1``
    and pass 2 clips its reads to that range.
    """
    t_max = feat.shape[1]
    denom = 2.0 * sum(i * i for i in range(1, n + 1))
    last = jnp.maximum(lengths - 1, 0)                       # [B]
    t_idx = jnp.arange(t_max)[None, :, None]                 # [1, T, 1]
    # per-row last valid frame via one-hot contraction (no gather)
    onehot = (
        jnp.arange(t_max)[None, :] == last[:, None]
    ).astype(feat.dtype)                                     # [B, T]
    x_last = jnp.einsum("bt,btf->bf", onehot, feat)[:, None, :]
    x_first = feat[:, :1, :]
    last_b = last[:, None, None]
    out = jnp.zeros_like(feat)
    for k in range(1, n + 1):
        fwd = jnp.concatenate(
            [feat[:, k:, :], jnp.zeros_like(feat[:, :k, :])], axis=1
        )
        fwd = jnp.where(t_idx + k > last_b, x_last, fwd)     # clip to last
        bwd = jnp.concatenate(
            [jnp.broadcast_to(x_first, feat[:, :k, :].shape),
             feat[:, :-k, :]], axis=1
        )                                                    # clip to first
        out = out + k * (fwd - bwd)
    return out / denom


class DeviceFeaturizer:
    """Batched on-device feature extractor.

    ``kind``: 'raw' | 'fbank' | 'logfbank' | 'mfcc'.  Parameters mirror the
    NumPy classes (audio.Raw/FBank/LogFbank/MFCC); ``append_energy=None``
    takes the per-kind oracle default (True for mfcc — replaces c0; False
    for logfbank — appends a log-energy column).  ``mean_norm``/``var_norm``
    apply per-utterance CMVN over each utterance's REAL frames (masked, so
    padded batches match the oracle's unpadded statistics).  Call with a
    padded wav batch::

        feats, feat_lengths = featurizer(wavs [B, N], wav_lengths [B])

    The call is jitted per (B, N) shape; pad N to a few static buckets.
    """

    def __init__(
        self,
        kind: str = "mfcc",
        fs: int = 16000,
        win_len: float = 0.025,
        win_step: float = 0.01,
        nfilt: int = 40,
        nfft: int = 512,
        low_freq: float = 0.0,
        high_freq: Optional[float] = None,
        preemph: float = 0.97,
        htk=audio._UNSET,
        window=audio._UNSET,
        center=audio._UNSET,
        pad_mode: str = "reflect",
        filterbank=audio._UNSET,
        fb_norm=audio._UNSET,
        convention: str = "reference",
        num_cep: int = 13,
        cep_lifter: int = 22,
        append_energy: Optional[bool] = None,
        d: Optional[bool] = None,
        dd: Optional[bool] = None,
        mean_norm: bool = False,
        var_norm: bool = False,
        eps: float = audio.EPS,
        log_floor: float = 0.0,
        dtype=jnp.float32,
    ):
        if kind not in ("raw", "fbank", "logfbank", "mfcc"):
            raise ValueError(f"unknown device feature kind {kind!r}")
        # None = the per-kind oracle default (MFCC appends deltas and
        # replaces c0 with energy by default; LogFbank does neither)
        if append_energy is None:
            append_energy = kind == "mfcc"
        if d is None:
            d = kind == "mfcc"
        if dd is None:
            dd = kind == "mfcc"
        self.kind = kind
        self.fs = fs
        self.frame_len = int(round(win_len * fs))
        self.frame_step = int(round(win_step * fs))
        self.nfilt = nfilt
        self.nfft = nfft
        self.preemph = preemph
        self.convention = convention
        (self.htk, self.window, self.center, self.filterbank,
         self.fb_norm) = audio.resolve_convention(
            convention, htk, window, center, filterbank, fb_norm
        )
        self.pad_mode = pad_mode
        self.num_cep = num_cep
        self.cep_lifter = cep_lifter
        self.append_energy = append_energy
        self.d = d
        self.dd = dd
        self.mean_norm = mean_norm
        self.var_norm = var_norm
        self.eps = eps
        # power-domain floor before any log (audio._SpectralFeature.log_floor)
        self.log_floor = max(
            float(log_floor), float(jnp.finfo(jnp.float32).eps)
        )
        self.dtype = dtype
        if kind == "raw":
            self._call = jax.jit(self._transform)
            return

        # fixed operator tables (host-precomputed in float64, cast f32)
        cos_m, sin_m = _dft_matrices(self.frame_len, nfft)
        self._cos = jnp.asarray(cos_m, dtype)
        self._sin = jnp.asarray(sin_m, dtype)
        self._window = jnp.asarray(
            audio.get_window(self.window)(self.frame_len), dtype
        )
        self._fbank = jnp.asarray(
            audio.mel_filterbank(
                nfilt, nfft, fs, low_freq, high_freq, self.htk,
                construction=self.filterbank, norm=self.fb_norm,
            ).T,
            dtype,
        )  # [nbins, nfilt]
        self._dct = jnp.asarray(
            audio.dct2_ortho_matrix(nfilt, num_cep).T, dtype
        )  # [nfilt, num_cep]
        lift = 1.0 + (cep_lifter / 2.0) * np.sin(
            np.pi * np.arange(num_cep) / cep_lifter
        ) if cep_lifter > 0 else np.ones(num_cep)
        self._lift = jnp.asarray(lift, dtype)
        self._call = jax.jit(self._transform)

    @property
    def num_feats(self) -> int:
        if self.kind == "raw":
            return 1
        if self.kind == "fbank":
            return self.nfilt
        if self.kind == "logfbank":
            base = self.nfilt + (1 if self.append_energy else 0)
            return base * (1 + int(self.d) + int(self.dd))
        return self.num_cep * (1 + int(self.d) + int(self.dd))

    def _finalize(self, out: jax.Array, feat_lengths: jax.Array):
        """Per-utterance CMVN over real frames, then zero the padded tail.

        Matches the oracle's unmasked ``feats.mean(axis=0)`` /
        ``feats.std(axis=0)`` on each utterance's own [T_i, F] slice
        (audio.Feature.__call__); std is mean-shift invariant, so one
        masked variance serves both the normalized and raw-mean cases.
        """
        t_out = out.shape[1]
        maskf = (
            jnp.arange(t_out)[None, :] < feat_lengths[:, None]
        ).astype(out.dtype)[..., None]                        # [B, T, 1]
        if self.mean_norm or self.var_norm:
            n = jnp.maximum(
                feat_lengths.astype(out.dtype), 1.0
            )[:, None, None]
            mu = jnp.sum(out * maskf, axis=1, keepdims=True) / n
            if self.var_norm:
                var = (
                    jnp.sum(((out - mu) * maskf) ** 2, axis=1, keepdims=True)
                    / n
                )
                std = jnp.sqrt(var)
            if self.mean_norm:
                out = out - mu
            if self.var_norm:
                out = out / (std + self.eps)
        return out * maskf, feat_lengths

    def _prep(self, wavs: jax.Array, wav_lengths: jax.Array):
        """Shared signal prep: pre-emphasis,
        per-row zeroing beyond the true length (the oracle pads zeros
        AFTER pre-emphasis), and librosa centering when enabled.  Returns
        (signal, static frame count, per-row frame lengths); framing then
        reads ``signal`` at offsets t*frame_step with a frame_len window
        in BOTH conventions."""
        batch, n_samples = wavs.shape
        pre = jnp.concatenate(
            [wavs[:, :1], wavs[:, 1:] - self.preemph * wavs[:, :-1]], axis=1
        )
        pre = jnp.where(
            jnp.arange(n_samples)[None, :] < wav_lengths[:, None], pre, 0.0
        )
        t_out = int(audio.num_frames(
            n_samples, self.frame_len, self.frame_step, center=self.center
        ))
        feat_lengths = device_num_frames(
            wav_lengths, self.frame_len, self.frame_step, center=self.center
        )
        if self.center:
            pre = _center_pad_batch(
                pre, wav_lengths, self.frame_len // 2, self.pad_mode
            )
        return pre, t_out, feat_lengths

    # -- core (jitted) ----------------------------------------------------
    def _transform(self, wavs: jax.Array, wav_lengths: jax.Array):
        batch, n_samples = wavs.shape
        wavs = wavs.astype(self.dtype)
        wav_lengths = wav_lengths.astype(jnp.int32)
        if self.kind == "raw":
            # [B, N] -> [B, N, 1]; every sample is a frame (audio.Raw)
            return self._finalize(wavs[..., None], wav_lengths)

        pre, t_out, feat_lengths = self._prep(wavs, wav_lengths)
        pad_len = (t_out - 1) * self.frame_step + self.frame_len
        if pad_len > pre.shape[1]:
            pre = jnp.pad(pre, ((0, 0), (0, pad_len - pre.shape[1])))
        idx = (
            jnp.arange(t_out)[:, None] * self.frame_step
            + jnp.arange(self.frame_len)[None, :]
        )
        frames = pre[:, idx] * self._window                  # [B, T, L]

        # matmul-DFT power spectrum
        re = jnp.einsum("btl,lk->btk", frames, self._cos,
                        precision=_DFT_PREC)
        im = jnp.einsum("btl,lk->btk", frames, self._sin,
                        precision=_DFT_PREC)
        pspec = (re * re + im * im) / self.nfft              # [B, T, K]

        energy = jnp.sum(pspec, axis=-1)
        energy = jnp.maximum(energy, jnp.finfo(jnp.float32).eps)
        feat = jnp.einsum("btk,kf->btf", pspec, self._fbank, precision=_PREC)
        feat = jnp.maximum(feat, jnp.finfo(jnp.float32).eps)

        if self.kind == "fbank":
            return self._finalize(feat, feat_lengths)

        # log_floor applies only where a log is taken (matches the oracle:
        # linear fbank stays unfloored beyond the exact-zero eps guard)
        logfeat = jnp.log(jnp.maximum(feat, self.log_floor))
        log_e = jnp.log(jnp.maximum(energy, self.log_floor))
        if self.kind == "mfcc":
            cep = jnp.einsum(
                "btf,fc->btc", logfeat, self._dct, precision=_PREC
            )
            cep = cep * self._lift
            if self.append_energy:
                cep = cep.at[:, :, 0].set(log_e)
            base = cep
        else:  # logfbank
            base = logfeat
            if self.append_energy:
                # appended log-energy column (audio.LogFbank._transform)
                base = jnp.concatenate([base, log_e[..., None]], axis=-1)

        outs = [base]
        if self.d:
            outs.append(_delta_device(outs[-1], feat_lengths))
        if self.dd:
            outs.append(_delta_device(outs[-1], feat_lengths))
        out = jnp.concatenate(outs, axis=-1)
        return self._finalize(out, feat_lengths)

    def __call__(self, wavs, wav_lengths):
        return self._call(jnp.asarray(wavs), jnp.asarray(wav_lengths))
