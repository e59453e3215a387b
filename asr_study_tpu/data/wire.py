"""One-transfer ragged wire format for batches of variable-length audio.

Replacement for the reference's feed-dict of host-padded numpy
[ref: predict.py, core/dataset_generator.py]: every host->device send
pays a setup cost and rectangular padding wastes transfer bytes, so a
batch of utterances crosses the link as ONE flat int16 buffer —

    [ 2*B-word length header | utt0 samples | utt1 samples | ... ]

- header word 2i   = lengths[i] & 0x7fff      (15-bit low half)
- header word 2i+1 = lengths[i] >> 15         (high half; < 2^30 samples)
- offsets are NOT transmitted: they are the exclusive cumsum of the
  lengths, recomputed on device.

``unpack_audio`` runs inside jit and materializes the padded [B, T]
float32 waveform with per-row contiguous ``dynamic_slice`` copies.

Three codecs (static; both ends must agree):
- ``pcm16`` (default): one 16-bit sample per word, lossless for PCM16.
- ``mulaw``: 8-bit mu-law companding (mu=255, the G.711-style telephony
  curve, ~38 dB SNR), two codes per word — HALF the wire bytes for
  bandwidth-bound serving links; decode happens on device.
- ``dpack``: LOSSLESS delta + per-block bit-packing (FLAC-style fixed
  prediction, device-decodable): the batch's samples ride as one delta
  stream split into 4096-sample blocks, each packed at its own bit
  width.  Decoded samples are bit-identical to pcm16 at ~12-14 bits per
  sample on speech-shaped signals.  Needs a static sample capacity
  (``scap``) shared by both ends — see ``dpack_*`` below.

Bit-exactness vs host-side padding is tested in tests/test_wire.py.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_LOW_BITS = 15
_LOW_MASK = (1 << _LOW_BITS) - 1

_MU = 255.0
_LOG1P_MU = float(np.log1p(_MU))


def mulaw_encode(x: np.ndarray) -> np.ndarray:
    """float waveform [-1, 1] -> int8 mu-law codes [-127, 127] (mu=255,
    the telephony companding curve; ~38 dB SNR on speech)."""
    x = np.clip(np.asarray(x, np.float64), -1.0, 1.0)
    y = np.sign(x) * np.log1p(_MU * np.abs(x)) / _LOG1P_MU
    return np.round(y * 127.0).astype(np.int8)


def mulaw_decode_device(codes: jax.Array) -> jax.Array:
    """int mu-law codes -> float32 waveform (jittable; inverse of
    mulaw_encode up to the 8-bit quantization)."""
    y = codes.astype(jnp.float32) * (1.0 / 127.0)
    return jnp.sign(y) * (jnp.expm1(jnp.abs(y) * _LOG1P_MU) / _MU)


def quantize_pcm16(w: np.ndarray) -> np.ndarray:
    """float waveform -> int16 with round(x * 32768) saturated — the EXACT
    inverse of the read_wav / unpack normalization k -> k/32768 (int16
    passes through untouched)."""
    w = np.asarray(w)
    if w.dtype == np.int16:
        return w
    return np.clip(
        np.round(w.astype(np.float64) * 32768.0), -32768, 32767
    ).astype(np.int16)


def _codec_words(n_samples: int, codec: str) -> int:
    """int16 words occupied by one utterance's samples."""
    if codec == "pcm16":
        return n_samples
    if codec == "mulaw":
        return (n_samples + 1) // 2      # two 8-bit codes per word
    raise ValueError(f"unknown wire codec {codec!r}")


def wire_cap(batch: int, total_samples: int, align: int = 2048,
             codec: str = "pcm16") -> int:
    """Buffer length for ``batch`` utterances totalling ``total_samples``
    samples, rounded up so one compiled program serves many batches."""
    if codec == "mulaw":
        # each utterance rounds up to a word boundary independently
        total_words = (total_samples + batch) // 2 + batch % 2
    else:
        total_words = _codec_words(total_samples, codec)
    cap = 2 * batch + total_words
    return -(-cap // align) * align


def pack_audio(
    wavs: Sequence[np.ndarray], cap: int, batch: int | None = None,
    codec: str = "pcm16", scap: int | None = None,
) -> np.ndarray:
    """Pack int16/float waveforms into one flat int16 wire buffer.

    codec='pcm16': float inputs are quantized with round(x * 32768)
    saturated to [-32768, 32767] — the EXACT inverse of the read_wav /
    unpack_audio normalization k -> k/32768, so audio that lived on disk
    as 16-bit wavs crosses the wire bit-exactly; int16 passes through.  codec='mulaw': samples are companded to 8-bit mu-law and
    packed two per int16 word (low byte first; each utterance starts on a
    word boundary) — HALF the wire bytes, for links where bandwidth is the
    serving bottleneck.  ``batch`` pads the header to a fixed batch size
    (missing rows get length 0), so a partially-filled final batch reuses
    the compiled program.  The codec is static: pass the same value to
    ``unpack_audio``.
    """
    if codec == "dpack":
        if scap is None:
            raise ValueError("codec='dpack' needs scap (see dpack_measure)")
        return dpack_pack(wavs, cap, scap, batch=batch)
    b = batch if batch is not None else len(wavs)
    if len(wavs) > b:
        raise ValueError(f"{len(wavs)} wavs > batch {b}")
    flat = np.zeros((cap,), np.int16)
    pos = 2 * b
    for i, w in enumerate(wavs):
        w = np.asarray(w)
        n = w.shape[0]
        if n >= 1 << 30:
            raise ValueError(f"utterance {i} too long for wire: {n}")
        n_words = _codec_words(n, codec)
        if pos + n_words > cap:
            raise ValueError(
                f"wire overflow: need {pos + n_words}, cap {cap} "
                "(recompute wire_cap for this batch)"
            )
        flat[2 * i] = n & _LOW_MASK
        flat[2 * i + 1] = n >> _LOW_BITS
        if codec == "pcm16":
            if w.dtype != np.int16:
                # round(x * 32768): the exact inverse of k/32768 — the
                # truncating x*32767 variant shifted every disk sample
                # 1 LSB toward zero.  Saturate, don't wrap: samples at or
                # beyond +1.0 must clip (int16 overflow is UB-grade
                # distortion).
                w = np.clip(
                    np.round(w.astype(np.float64) * 32768.0),
                    -32768, 32767,
                ).astype(np.int16)
            flat[pos: pos + n] = w
        else:  # mulaw
            if w.dtype == np.int16:
                w = w.astype(np.float64) / 32768.0
            codes = mulaw_encode(w).astype(np.uint8)
            if n % 2:
                codes = np.concatenate([codes, np.zeros(1, np.uint8)])
            lo = codes[0::2].astype(np.uint16)
            hi = codes[1::2].astype(np.uint16)
            flat[pos: pos + n_words] = (lo | (hi << 8)).astype(np.int16)
        pos += n_words
    return flat


def unpack_audio(
    flat: jax.Array, batch: int, n_pad: int, codec: str = "pcm16",
    scap: int | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """flat int16 wire -> (float32 [batch, n_pad] padded wavs, lengths).

    Jittable; ``batch``, ``n_pad``, ``codec`` (and ``scap`` for dpack) are
    static. Rows are materialized by scanned contiguous dynamic-slices
    (DMA-friendly; see module doc).
    """
    if codec == "dpack":
        if scap is None:
            raise ValueError("codec='dpack' needs scap (see dpack_measure)")
        return dpack_unpack(flat, batch, n_pad, scap)
    if codec not in ("pcm16", "mulaw"):
        raise ValueError(f"unknown wire codec {codec!r}")
    hdr = 2 * batch
    lo = flat[0:hdr:2].astype(jnp.int32)
    hi = flat[1:hdr:2].astype(jnp.int32)
    lengths = lo + (hi << _LOW_BITS)
    t = jnp.arange(n_pad, dtype=jnp.int32)

    if codec == "pcm16":
        offsets = (hdr + jnp.cumsum(lengths) - lengths).astype(jnp.int32)
        padded_flat = jnp.pad(flat, (0, n_pad))

        def row(carry, off_len):
            off, ln = off_len
            seg = jax.lax.dynamic_slice_in_dim(padded_flat, off, n_pad)
            wav = jnp.where(
                t < ln, seg.astype(jnp.float32) * (1.0 / 32768.0), 0.0
            )
            return carry, wav

        _, wavs = jax.lax.scan(row, 0, (offsets, lengths))
        return wavs, lengths

    # mulaw: two 8-bit codes per word, utterances word-aligned
    n_pad_words = (n_pad + 1) // 2
    words = (lengths + 1) >> 1
    offsets = (hdr + jnp.cumsum(words) - words).astype(jnp.int32)
    padded_flat = jnp.pad(flat, (0, n_pad_words))

    def row_mulaw(carry, off_len):
        off, ln = off_len
        seg = jax.lax.dynamic_slice_in_dim(
            padded_flat, off, n_pad_words
        ).astype(jnp.int32)
        lo_b = ((seg & 0xFF) + 128) % 256 - 128          # sign-extend int8
        hi_b = (((seg >> 8) & 0xFF) + 128) % 256 - 128
        codes = jnp.stack([lo_b, hi_b], axis=-1).reshape(2 * n_pad_words)
        wav = mulaw_decode_device(codes[:n_pad])
        return carry, jnp.where(t < ln, wav, 0.0)

    _, wavs = jax.lax.scan(row_mulaw, 0, (offsets, lengths))
    return wavs, lengths


def pack_batches(
    wavs: Sequence[np.ndarray], batch: int, align: int = 2048,
    codec: str = "pcm16",
) -> Tuple[List[np.ndarray], int]:
    """Split ``wavs`` into wire buffers of ``batch`` rows sharing ONE cap
    (= one compiled program). Returns (buffers, cap)."""
    groups = [list(wavs[i: i + batch]) for i in range(0, len(wavs), batch)]
    if not groups:
        return [], wire_cap(batch, 0, align, codec)
    cap = max(
        wire_cap(batch, sum(len(np.asarray(w)) for w in g), align, codec)
        for g in groups
    )
    return [pack_audio(g, cap, batch=batch, codec=codec) for g in groups], cap


# ---------------------------------------------------------------------------
# dpack: lossless delta + per-block bit-packing (device-decodable)
# ---------------------------------------------------------------------------
# A device-decodable answer to "compress the serving wire losslessly"
# [ref: predict.py serving path; the reference feeds raw numpy]: FLAC gets
# its ratio from (a) a fixed linear predictor and (b) Rice entropy coding.
# (a) maps to a device directly; (b)'s variable-length codes do not — bit
# positions become data-dependent per SAMPLE, which forces per-sample
# gathers.  dpack keeps (a) and replaces
# (b) with per-BLOCK fixed-width packing: within a 4096-sample block every
# zigzagged delta is stored at the block's max bit-length.  Cost vs Rice:
# ~1.3 bits/sample on speech-shaped signals (max-of-block vs per-sample
# codes); gain: no per-sample control flow on device.
#
# Block payloads are stored as BIT PLANES (w_j planes of 256 words each;
# v2 layout: plane p, word m, bit i = bit p of sample 256*i + m within
# the block).  This makes the decode layout IDENTICAL for every width:
# each plane expands with the same static shift pattern and a (p < w_j)
# mask drops the planes a block doesn't have — uniform elementwise ops
# XLA fuses into one pass, where the earlier sample-major bitstream
# needed a 17-way per-block lax.switch.  The v2 bit orientation (256i+m,
# not v1's 16m+i) makes the expanded [16, 256] block land in flat sample
# order row-major, so the decode writes samples with no transpose.
#
# Wire layout (int16 words), with B = batch, NBCAP = scap // 4096:
#   [0, 2B)            sample-length header (15-bit split, as pcm16)
#   [2B, 2B + NBCAP)   per-block bit widths w_j in 0..16, one per word
#   [2B + NBCAP, ...)  block payloads back to back; block j occupies
#                      256 * w_j words (4096 samples * w_j bits / 16)
#
# The delta stream runs over the CONCATENATED batch samples (utterance
# boundaries ignored; d[0] = s[0]) and is zero-padded to a block multiple.
# Reconstruction is one int32 cumsum over the flat stream (int16
# wraparound applied after — deltas are stored mod 2^16, so the sum is
# exact mod 2^16 regardless of int32 overflow), then the same per-row
# dynamic-slice extraction as pcm16.
#
# ``scap`` (static sample capacity, a multiple of 4096) is the decode-side
# analog of ``cap``: both ends must agree so one compiled program serves
# every batch.

_DPACK_BLOCK = 4096
_DPACK_GROUP = 16                       # samples per word-aligned group
_DPACK_GPB = _DPACK_BLOCK // _DPACK_GROUP   # 256 words per plane/group


def _dpack_deltas(wavs: Sequence[np.ndarray]) -> Tuple[np.ndarray, list]:
    """Concatenated zigzagged wraparound deltas (uint32) + lengths."""
    lens = [int(np.asarray(w).shape[0]) for w in wavs]
    if sum(lens) == 0:
        return np.zeros((0,), np.uint32), lens
    s = np.concatenate([quantize_pcm16(w) for w in wavs]).astype(np.int32)
    d = np.empty_like(s)
    d[0] = s[0]
    d[1:] = s[1:] - s[:-1]
    d = ((d + 32768) & 0xFFFF) - 32768   # int16 wraparound residual
    return (((d << 1) ^ (d >> 31)).astype(np.uint32)), lens


def dpack_encode(
    wavs: Sequence[np.ndarray], use_native: bool = True,
) -> Tuple[list, np.ndarray, np.ndarray, int]:
    """Encode to (lengths, widths uint8 [nb], payload int16, n_samples).

    The C++ fast path (native/asr_native.cc::asr_dpack_encode_v2) is
    byte-identical to the NumPy
    reference below (tests/test_wire.py); ``use_native=False`` forces the
    reference path.
    """
    lens = [int(np.asarray(w).shape[0]) for w in wavs]
    if use_native and sum(lens):
        from asr_study_tpu.utils import native

        samples = np.concatenate([quantize_pcm16(w) for w in wavs])
        enc = native.dpack_encode(samples)
        if enc is not None:
            widths, payload = enc
            return lens, widths, payload, samples.shape[0]
    u, lens = _dpack_deltas(wavs)
    n = u.shape[0]
    nb = -(-n // _DPACK_BLOCK)
    if nb == 0:
        return lens, np.zeros((0,), np.uint8), np.zeros((0,), np.int16), 0
    u = np.concatenate([u, np.zeros(nb * _DPACK_BLOCK - n, np.uint32)])
    blocks = u.reshape(nb, _DPACK_BLOCK)
    m = blocks.max(axis=1)
    # bit_length of the block max (0 for all-zero blocks)
    widths = np.zeros(nb, np.uint8)
    for b in range(1, 17):
        widths[m >= (1 << (b - 1))] = b
    word_off = _DPACK_GPB * np.concatenate(
        [[0], np.cumsum(widths.astype(np.int64))[:-1]]
    )
    payload = np.zeros(int(_DPACK_GPB * widths.astype(np.int64).sum()),
                       np.uint16)
    shift16 = (1 << np.arange(_DPACK_GROUP, dtype=np.uint32))
    for w in range(1, 17):
        sel = np.nonzero(widths == w)[0]
        if sel.size == 0:
            continue
        # v2 bit planes: plane p, word m, bit i = bit p of sample 256i+m
        v = blocks[sel].reshape(-1, _DPACK_GROUP, _DPACK_GPB)  # [K, i, m]
        bits = ((v[..., None] >> np.arange(w, dtype=np.uint32)) & 1)
        planes = (
            bits.astype(np.uint32) * shift16[None, :, None, None]
        ).sum(1)                                     # [K, 256, w]
        words = planes.transpose(0, 2, 1).astype(np.uint16)  # [K, w, 256]
        idx = (
            word_off[sel][:, None]
            + np.arange(_DPACK_GPB * w, dtype=np.int64)[None, :]
        ).ravel()
        payload[idx] = words.reshape(sel.size, -1).ravel()
    return lens, widths, payload.view(np.int16), n


def dpack_pack(
    wavs: Sequence[np.ndarray], cap: int, scap: int,
    batch: int | None = None, enc=None,
) -> np.ndarray:
    """Pack with the dpack codec into a [cap] int16 buffer.

    ``scap`` is the static sample capacity (a block multiple) the decoder
    was compiled for; the widths region occupies scap/4096 words.
    ``enc`` optionally passes ``dpack_encode(wavs)``'s result so callers
    that already encoded (for capacity sizing) don't pay the host encode
    again.
    """
    if scap % _DPACK_BLOCK:
        raise ValueError(f"scap must be a multiple of {_DPACK_BLOCK}")
    b = batch if batch is not None else len(wavs)
    if len(wavs) > b:
        raise ValueError(f"{len(wavs)} wavs > batch {b}")
    lens, widths, payload, n = enc if enc is not None else dpack_encode(wavs)
    nbcap = scap // _DPACK_BLOCK
    if widths.shape[0] > nbcap:
        raise ValueError(
            f"dpack overflow: {n} samples need {widths.shape[0]} blocks, "
            f"scap {scap} holds {nbcap} (recompute dpack_measure)"
        )
    need = 2 * b + nbcap + payload.shape[0]
    if need > cap:
        raise ValueError(
            f"wire overflow: need {need}, cap {cap} "
            "(recompute dpack_measure for this batch)"
        )
    flat = np.zeros((cap,), np.int16)
    for i, ln in enumerate(lens):
        if ln >= 1 << 30:
            raise ValueError(f"utterance {i} too long for wire: {ln}")
        flat[2 * i] = ln & _LOW_MASK
        flat[2 * i + 1] = ln >> _LOW_BITS
    flat[2 * b: 2 * b + widths.shape[0]] = widths.astype(np.int16)
    flat[2 * b + nbcap: need] = payload
    return flat


def dpack_measure(
    groups: Sequence[Sequence[np.ndarray]], batch: int, align: int = 2048,
) -> Tuple[int, int]:
    """Shared (cap, scap) so ONE compiled program serves every group."""
    scap = _DPACK_BLOCK
    words = 2 * batch
    for g in groups:
        n = sum(int(np.asarray(w).shape[0]) for w in g)
        scap = max(scap, -(-n // _DPACK_BLOCK) * _DPACK_BLOCK)
        _, widths, payload, _ = dpack_encode(g)
        words = max(words, 2 * batch + payload.shape[0])
    cap = -(-(words + scap // _DPACK_BLOCK) // align) * align
    return cap, scap


def probe_link(size_mb: float = 4.0) -> float:
    """Measured host->device round-trip bandwidth estimate, MB/s.

    Times device_put + a 1-element readback for a small and a large
    buffer and differences them, so the per-transfer setup cost doesn't
    masquerade as bandwidth.  This is a
    SELECTION probe (dpack vs pcm16 in ``choose_codec``), not a
    benchmark: it only needs to order "network link" (~tens of MB/s)
    vs "locally attached" (GB/s).  Each size takes the MIN over a few
    round trips — a single congestion spike on either measurement could
    otherwise make dt <= 0 and missteer the selection toward pcm16 on
    the very links where dpack matters most.
    """
    import time

    def rt(n_bytes: int, rounds: int = 3) -> float:
        buf = np.zeros(n_bytes // 2, np.int16)
        best = float("inf")
        for _ in range(rounds):
            t0 = time.perf_counter()
            dev = jax.device_put(buf)
            np.asarray(dev[:1])      # fetch: the only reliable sync
            best = min(best, time.perf_counter() - t0)
        return best

    small = 1 << 16
    large = max(int(size_mb * 2**20), 4 * small)
    rt(small, rounds=1)              # warm dispatch path
    dt = rt(large) - rt(small)
    if dt <= 0:                      # noise won anyway: one more attempt
        dt = rt(large) - rt(small)
    if dt <= 0:                      # below timer/setup resolution
        return float("inf")
    return (large - small) / dt / 2**20


def choose_codec(bandwidth_mbps: float | None = None) -> str:
    """Pick the serving wire codec from measured link bandwidth.

    dpack saves about an eighth of the wire bytes on speech-shaped
    signals but adds an on-device decode; the byte saving can only
    outrun the decode on links slower than about 1 GB/s, i.e. network
    links, not locally attached (PCIe) devices.  The threshold is a
    design estimate, not a measurement on this program's device.
    """
    bw = probe_link() if bandwidth_mbps is None else bandwidth_mbps
    return "dpack" if bw < 1000.0 else "pcm16"


_DPACK_ASM_K = 8     # blocks assembled per scan step (amortizes overhead)


def dpack_unpack(
    flat: jax.Array, batch: int, n_pad: int, scap: int,
) -> Tuple[jax.Array, jax.Array]:
    """dpack wire -> (float32 [batch, n_pad] padded wavs, lengths).

    Jittable; batch/n_pad/scap static.  Bit-identical to the pcm16 path.

    Decode shape: blocks are contiguous in the payload, so a
    scan step slices a WINDOW of _DPACK_ASM_K blocks with one big
    dynamic_slice and carves the K blocks out of it (8x fewer scan steps
    than one block per step).  Thanks to the bit-plane payload layout,
    the bit unpacking itself needs NO per-block control flow: every
    block's plane p sits at the same 256-word offset, each plane expands
    with one static shift pattern, and a (p < width) mask drops the
    planes a block doesn't have — 16 uniform elementwise passes XLA
    fuses into one, instead of the sample-major layout's 17-way
    per-block lax.switch.
    """
    if scap % _DPACK_BLOCK:
        raise ValueError(f"scap must be a multiple of {_DPACK_BLOCK}")
    nbcap = scap // _DPACK_BLOCK
    hdr = 2 * batch
    lo = flat[0:hdr:2].astype(jnp.int32)
    hi = flat[1:hdr:2].astype(jnp.int32)
    lengths = lo + (hi << _LOW_BITS)

    widths = flat[hdr: hdr + nbcap].astype(jnp.int32)
    csum = jnp.cumsum(widths)
    word_off = (hdr + nbcap + _DPACK_GPB * (csum - widths)).astype(
        jnp.int32
    )

    # 1) assemble padded [nbcap, 16, 256] plane words, K blocks/step
    k_asm = min(_DPACK_ASM_K, nbcap)
    nb_pad = -(-nbcap // k_asm) * k_asm
    off_p = jnp.pad(word_off, (0, nb_pad - nbcap)).reshape(-1, k_asm)
    win = (k_asm + 1) * _DPACK_GPB * 16
    src = jnp.pad(flat, (0, win)).astype(jnp.int32) & 0xFFFF

    def asm(carry, offs):
        w0 = jax.lax.dynamic_slice_in_dim(src, offs[0], win)
        rows = [
            jax.lax.dynamic_slice_in_dim(
                w0, offs[j] - offs[0], _DPACK_GPB * 16
            )
            for j in range(k_asm)
        ]
        return carry, jnp.stack(rows)

    _, blocks = jax.lax.scan(asm, 0, off_p)
    planes = blocks.reshape(nb_pad, 16, _DPACK_GPB)[:nbcap]

    # 2) branch-free bit-plane expansion (one fused elementwise pass)
    # v2 orientation: u[b, i, m] = block sample 256i+m, so the
    # reshape below IS flat sample order (no transpose)
    shifts = jnp.arange(_DPACK_GROUP, dtype=jnp.int32)
    u = jnp.zeros((nbcap, _DPACK_GROUP, _DPACK_GPB), jnp.int32)
    for p in range(16):
        bit = (planes[:, p, None, :] >> shifts[None, :, None]) & 1
        u = u + jnp.where(widths[:, None, None] > p, bit << p, 0)
    u = u.reshape(scap)
    d = (u >> 1) ^ -(u & 1)                         # un-zigzag
    c = jnp.cumsum(d)        # int32 wraps; exact mod 2^16 (see above)
    wrapped = ((c + 32768) & 0xFFFF) - 32768
    samples = wrapped.astype(jnp.float32) * (1.0 / 32768.0)

    samples = jnp.pad(samples, (0, n_pad))

    offsets = (jnp.cumsum(lengths) - lengths).astype(jnp.int32)
    t = jnp.arange(n_pad, dtype=jnp.int32)

    def row(carry, off_len):
        off, ln = off_len
        seg = jax.lax.dynamic_slice_in_dim(samples, off, n_pad)
        wav = jnp.where(t < ln, seg, 0.0)
        return carry, wav

    _, wavs = jax.lax.scan(row, 0, (offsets, lengths))
    return wavs, lengths
