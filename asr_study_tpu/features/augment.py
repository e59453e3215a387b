"""SpecAugment (Park et al. 2019) — on-device training augmentation.

The reference predates SpecAugment and ships no augmentation; it is the
standard training-time regularizer for exactly this model family
(log-mel/MFCC + BLSTM + CTC), so the rebuild supplies it as a first-class
extension.  XLA-friendly shape: the masks are built with broadcasted
comparisons from a handful of per-(row, mask) uniform draws — static
shapes, no dynamic slices, fully jit/vmap/shard_map-clean — and applied
INSIDE the jitted train step (zero host work, composes with DP/TP because
each device draws from its own folded key).

Semantics per utterance:
- ``freq_masks`` frequency bands, each of width ~ U{0..freq_width},
  start uniform over the valid range — masked to 0 across all frames.
- ``time_masks`` frame spans, each of width ~ U{0..floor(time_ratio *
  length)} (per-utterance adaptive cap, the "adaptive" variant of the
  paper), start uniform within the utterance's VALID frames — padding is
  never counted or masked.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


class SpecAugment:
    """Callable ``(rng, inputs [B,T,F], input_lengths [B]) -> inputs``."""

    def __init__(self, freq_masks: int = 2, freq_width: int = 8,
                 time_masks: int = 2, time_ratio: float = 0.05):
        if freq_masks < 0 or time_masks < 0:
            raise ValueError("mask counts must be >= 0")
        if freq_width < 0:
            raise ValueError(f"freq_width must be >= 0, got {freq_width}")
        if not 0.0 <= time_ratio <= 1.0:
            raise ValueError(
                f"time_ratio must be in [0, 1], got {time_ratio}"
            )
        self.freq_masks = int(freq_masks)
        self.freq_width = int(freq_width)
        self.time_masks = int(time_masks)
        self.time_ratio = float(time_ratio)

    def __repr__(self) -> str:
        return (
            f"SpecAugment(freq_masks={self.freq_masks}, "
            f"freq_width={self.freq_width}, time_masks={self.time_masks}, "
            f"time_ratio={self.time_ratio})"
        )

    def __call__(self, rng, inputs, input_lengths):
        b, t, f = inputs.shape
        keep = jnp.ones((b, t, f), bool)
        k_f, k_t = jax.random.split(rng)

        if self.freq_masks and self.freq_width:
            # widths U{0..W}, starts U{0..F-w} per (row, mask)
            u = jax.random.uniform(k_f, (b, self.freq_masks, 2))
            w_cap = min(self.freq_width, f)
            w = jnp.floor(u[..., 0] * (w_cap + 1)).astype(jnp.int32)
            start = jnp.floor(u[..., 1] * (f - w + 1)).astype(jnp.int32)
            idx = jnp.arange(f)[None, None, :]                 # [1,1,F]
            band = (idx >= start[..., None]) & (
                idx < (start + w)[..., None]
            )                                                  # [B,M,F]
            keep &= ~jnp.any(band, axis=1)[:, None, :]

        if self.time_masks and self.time_ratio > 0:
            lengths = input_lengths.astype(jnp.int32)          # [B]
            u = jax.random.uniform(k_t, (b, self.time_masks, 2))
            w_cap = jnp.floor(
                self.time_ratio * lengths.astype(jnp.float32)
            ).astype(jnp.int32)[:, None]                       # [B,1]
            w = jnp.floor(u[..., 0] * (w_cap + 1)).astype(jnp.int32)
            start = jnp.floor(
                u[..., 1] * (lengths[:, None] - w + 1)
            ).astype(jnp.int32)
            idx = jnp.arange(t)[None, None, :]                 # [1,1,T]
            span = (idx >= start[..., None]) & (
                idx < (start + w)[..., None]
            )                                                  # [B,M,T]
            keep &= ~jnp.any(span, axis=1)[:, :, None]

        return jnp.where(keep, inputs, jnp.zeros((), inputs.dtype))


class WavAugment:
    """Raw-waveform training augmentation: ``(rng, wavs [B,N],
    wav_lengths [B]) -> wavs``.

    The wav-domain companion to SpecAugment for the raw-wav training
    mode (``train.py --device_features``): it runs INSIDE the jitted
    train step, BEFORE the in-step featurizer — zero host work, static
    shapes, composes with DP/TP and SpecAugment.  Per utterance:

    - ``gain_db``: random gain, U[-gain_db, +gain_db] dB (0 = off).
    - ``noise_snr_min/max``: additive white Gaussian noise at an SNR
      drawn U[min, max] dB against the utterance's own RMS over its
      REAL samples; padding samples stay exactly zero (the featurizer's
      frame-length masking assumes it).  Off unless max > 0.
    """

    def __init__(self, gain_db: float = 0.0,
                 noise_snr_min: float = 0.0,
                 noise_snr_max: float = 0.0):
        if gain_db < 0:
            raise ValueError(f"gain_db must be >= 0, got {gain_db}")
        if noise_snr_min and not noise_snr_max:
            # noise is gated on noise_snr_max, so min alone would be a
            # SILENT no-op for the whole training run
            raise ValueError(
                f"noise_snr_min={noise_snr_min} without noise_snr_max "
                "would disable noise entirely; set noise_snr_max too"
            )
        if noise_snr_min > noise_snr_max:
            raise ValueError(
                f"noise_snr_min {noise_snr_min} > noise_snr_max "
                f"{noise_snr_max}"
            )
        self.gain_db = float(gain_db)
        self.noise_snr_min = float(noise_snr_min)
        self.noise_snr_max = float(noise_snr_max)

    def __repr__(self) -> str:
        return (
            f"WavAugment(gain_db={self.gain_db}, "
            f"noise_snr_min={self.noise_snr_min}, "
            f"noise_snr_max={self.noise_snr_max})"
        )

    def __call__(self, rng, wavs, wav_lengths):
        b, n = wavs.shape
        mask = (
            jnp.arange(n)[None, :] < wav_lengths[:, None].astype(jnp.int32)
        )
        k_g, k_s, k_n = jax.random.split(rng, 3)

        if self.gain_db > 0:
            db = jax.random.uniform(
                k_g, (b, 1), minval=-self.gain_db, maxval=self.gain_db
            )
            wavs = wavs * 10.0 ** (db / 20.0)

        if self.noise_snr_max > 0:
            snr = jax.random.uniform(
                k_s, (b, 1), minval=self.noise_snr_min,
                maxval=self.noise_snr_max,
            )
            # RMS over each utterance's real samples (post-gain, so the
            # SNR is against the signal actually fed to the featurizer)
            denom = jnp.maximum(
                jnp.sum(mask, axis=1, keepdims=True).astype(jnp.float32),
                1.0,
            )
            rms = jnp.sqrt(
                jnp.sum(jnp.where(mask, wavs, 0.0) ** 2, axis=1,
                        keepdims=True) / denom
            )
            sigma = rms * 10.0 ** (-snr / 20.0)
            noise = jax.random.normal(k_n, (b, n)) * sigma
            wavs = wavs + jnp.where(mask, noise, 0.0)

        # padding must stay exactly zero whatever the ops above did
        return jnp.where(mask, wavs, 0.0)


def _parse_kv(spec: str, flag: str, keys: dict):
    """Shared ``"k=v,..."`` parser (empty string -> all defaults)."""
    kw = {}
    for part in filter(None, (spec or "").split(",")):
        if "=" not in part:
            raise ValueError(f"{flag} expects 'k=v,...', got {part!r}")
        k, v = part.split("=", 1)
        k = k.strip()
        if k not in keys:
            raise ValueError(
                f"unknown {flag} key {k!r}; have {', '.join(keys)}"
            )
        kw[k] = keys[k](v)
    return kw


def parse_wav_augment(spec: str) -> WavAugment:
    """Build from the CLI's ``"k=v,..."`` string (empty string -> a mild
    default: gain_db=3, noise at SNR U[20, 50] dB).

    Defaults merge per knob GROUP (gain | noise): tuning one group keeps
    the other group's documented default — ``gain_db=6`` still adds the
    default noise (ADVICE r3: replacing ALL defaults on any key silently
    disabled the noise users weren't touching).  Specifying any key of a
    group takes full control of that group, so ``noise_snr_max=0``
    disables noise without tripping the min>max validation.
    """
    kw = _parse_kv(spec, "--wav_augment", {
        "gain_db": float, "noise_snr_min": float, "noise_snr_max": float,
    })
    if "gain_db" not in kw:
        kw["gain_db"] = 3.0
    if not ({"noise_snr_min", "noise_snr_max"} & kw.keys()):
        kw.update(noise_snr_min=20.0, noise_snr_max=50.0)
    return WavAugment(**kw)


def parse_spec_augment(spec: str) -> SpecAugment:
    """Build from the CLI's ``"k=v,..."`` string (empty string -> defaults).

    Keys: freq_masks, freq_width, time_masks, time_ratio.
    """
    return SpecAugment(**_parse_kv(spec, "--spec_augment", {
        "freq_masks": int, "freq_width": int, "time_masks": int,
        "time_ratio": float,
    }))
