"""Ragged one-transfer wire format (data/wire.py): bit-exactness vs
host-side padding, partial batches, overflow guards."""

import jax
import numpy as np
import pytest

from asr_study_tpu.data import wire


def _wavs(seed=0, n=5, lo=1000, hi=9000):
    rng = np.random.RandomState(seed)
    return [
        (rng.randn(rng.randint(lo, hi)) * 0.3).astype(np.float32)
        for _ in range(n)
    ]


def _host_padded(wavs, batch, n_pad):
    out = np.zeros((batch, n_pad), np.float32)
    lens = np.zeros((batch,), np.int32)
    for i, w in enumerate(wavs):
        # saturating round(x*32768) quantization (the wire's definition;
        # exact inverse of the k/32768 wav normalization)
        q = np.clip(
            np.round(w.astype(np.float64) * 32768.0), -32768, 32767
        ).astype(np.int16)
        out[i, : len(w)] = q.astype(np.float32) / 32768.0
        lens[i] = len(w)
    return out, lens


class TestRoundtrip:
    def test_bit_exact_vs_host_padding(self):
        wavs = _wavs()
        b, n_pad = len(wavs), 10240
        cap = wire.wire_cap(b, sum(len(w) for w in wavs))
        flat = wire.pack_audio(wavs, cap)
        got, lens = jax.jit(
            wire.unpack_audio, static_argnums=(1, 2)
        )(flat, b, n_pad)
        want, want_lens = _host_padded(wavs, b, n_pad)
        np.testing.assert_array_equal(np.asarray(lens), want_lens)
        np.testing.assert_array_equal(np.asarray(got), want)

    def test_int16_passthrough(self):
        rng = np.random.RandomState(1)
        wavs = [(rng.randn(3000) * 8000).astype(np.int16)]
        cap = wire.wire_cap(1, 3000)
        flat = wire.pack_audio(wavs, cap)
        got, lens = wire.unpack_audio(flat, 1, 4096)
        assert int(lens[0]) == 3000
        np.testing.assert_array_equal(
            np.asarray(got)[0, :3000],
            wavs[0].astype(np.float32) / 32768.0,
        )

    def test_partial_final_batch(self):
        """Fewer wavs than the batch: missing rows come back length 0."""
        wavs = _wavs(n=3)
        batch, n_pad = 8, 10240
        cap = wire.wire_cap(batch, sum(len(w) for w in wavs))
        flat = wire.pack_audio(wavs, cap, batch=batch)
        got, lens = wire.unpack_audio(flat, batch, n_pad)
        lens = np.asarray(lens)
        assert list(lens[3:]) == [0] * 5
        assert np.all(np.asarray(got)[3:] == 0.0)
        want, _ = _host_padded(wavs, batch, n_pad)
        np.testing.assert_array_equal(np.asarray(got), want)

    def test_long_utterance_header_split(self):
        """Lengths above 2^15 must survive the 15-bit header split."""
        n = (1 << 15) + 12345
        wavs = [np.zeros((n,), np.int16)]
        flat = wire.pack_audio(wavs, wire.wire_cap(1, n))
        _, lens = wire.unpack_audio(flat, 1, -(-n // 2048) * 2048)
        assert int(lens[0]) == n


class TestGuards:
    def test_overflow_raises(self):
        wavs = _wavs(n=2)
        with pytest.raises(ValueError, match="overflow"):
            wire.pack_audio(wavs, cap=64)

    def test_too_many_wavs_raises(self):
        with pytest.raises(ValueError, match="> batch"):
            wire.pack_audio(_wavs(n=3), cap=1 << 16, batch=2)


class TestPackBatches:
    def test_shared_cap_and_contents(self):
        wavs = _wavs(n=10)
        bufs, cap = wire.pack_batches(wavs, batch=4)
        assert len(bufs) == 3
        assert all(b.shape == (cap,) for b in bufs)
        n_pad = 10240
        rows = []
        for k, buf in enumerate(bufs):
            got, lens = wire.unpack_audio(buf, 4, n_pad)
            rows.extend(
                np.asarray(got)[i] for i in range(min(4, len(wavs) - 4 * k))
            )
        want, _ = _host_padded(wavs, 10, n_pad)
        np.testing.assert_array_equal(np.stack(rows), want)

    def test_empty(self):
        bufs, cap = wire.pack_batches([], batch=4)
        assert bufs == [] and cap > 0


class TestMulawCodec:
    def test_encode_decode_roundtrip_snr(self):
        """mu-law is lossy: check the companding round trip reaches the
        expected ~38 dB SNR on speech-like signals, and is monotonic."""
        rng = np.random.RandomState(3)
        t = np.arange(16000) / 16000.0
        x = (0.5 * np.sin(2 * np.pi * 200 * t)
             + 0.1 * rng.randn(16000)).astype(np.float32)
        x = np.clip(x, -1.0, 1.0)
        codes = wire.mulaw_encode(x)
        assert codes.dtype == np.int8
        y = np.asarray(wire.mulaw_decode_device(codes))
        snr = 10 * np.log10(np.mean(x**2) / np.mean((x - y) ** 2))
        assert snr > 30.0, snr
        # monotone: larger sample -> larger-or-equal code
        xs = np.linspace(-1, 1, 1001)
        cs = wire.mulaw_encode(xs)
        assert np.all(np.diff(cs.astype(int)) >= 0)

    def test_wire_roundtrip_matches_host_decode(self):
        """Device unpack of a mulaw wire buffer must equal the host-side
        encode->decode chain exactly (the quantization is the codec; the
        wire adds no further error), including odd lengths and partial
        batches."""
        wavs = _wavs(seed=7, n=3, lo=999, hi=4001)
        wavs[0] = wavs[0][:1001]                     # force odd length
        b, n_pad = 4, 4608                           # partial batch of 4
        cap = wire.wire_cap(b, sum(len(w) for w in wavs), codec="mulaw")
        flat = wire.pack_audio(wavs, cap, batch=b, codec="mulaw")
        got, lens = jax.jit(
            wire.unpack_audio, static_argnums=(1, 2, 3)
        )(flat, b, n_pad, "mulaw")
        got = np.asarray(got)
        assert int(lens[3]) == 0 and np.all(got[3] == 0.0)
        for i, w in enumerate(wavs):
            want = np.asarray(
                wire.mulaw_decode_device(
                    wire.mulaw_encode(np.clip(w, -1, 1))
                )
            )
            np.testing.assert_allclose(
                got[i, : len(w)], want, rtol=0, atol=1e-7
            )
            assert np.all(got[i, len(w):] == 0.0)

    def test_wire_bytes_halved(self):
        wavs = _wavs(seed=5)
        total = sum(len(w) for w in wavs)
        cap16 = wire.wire_cap(len(wavs), total, align=1)
        cap8 = wire.wire_cap(len(wavs), total, align=1, codec="mulaw")
        assert cap8 <= cap16 // 2 + 2 * len(wavs)


class TestDpackCodec:
    """Lossless delta + per-block bit-packing (the r3 wire codec): device
    decode must be BIT-IDENTICAL to the pcm16 path on any input."""

    def _roundtrip(self, wavs, batch=None, n_pad=10240):
        b = batch if batch is not None else len(wavs)
        cap, scap = wire.dpack_measure([wavs], b)
        flat = wire.pack_audio(wavs, cap, batch=b, codec="dpack",
                               scap=scap)
        got, lens = jax.jit(
            wire.unpack_audio, static_argnums=(1, 2, 3, 4)
        )(flat, b, n_pad, "dpack", scap)
        cap16 = wire.wire_cap(b, sum(len(np.asarray(w)) for w in wavs))
        want, wlens = wire.unpack_audio(
            wire.pack_audio(wavs, cap16, batch=b), b, n_pad
        )
        np.testing.assert_array_equal(np.asarray(lens), np.asarray(wlens))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        return flat, cap, cap16

    def test_bit_exact_speechlike(self):
        """Tonal+noise signals (the bench's shape) — and the packed wire
        must actually be smaller than pcm16."""
        rng = np.random.RandomState(0)
        wavs = []
        for _ in range(4):
            n = rng.randint(8000, 30000)
            t = np.arange(n) / 16000.0
            f0 = rng.uniform(80, 250)
            sig = sum(np.sin(2 * np.pi * f0 * (k + 1) * t) / (k + 1)
                      for k in range(4)) + 0.1 * rng.randn(n)
            wavs.append((sig / np.abs(sig).max() * 0.5).astype(np.float32))
        _, cap, cap16 = self._roundtrip(wavs, n_pad=30720)
        assert cap < 0.95 * cap16, (cap, cap16)

    def test_bit_exact_adversarial(self):
        """Worst cases: full-scale alternation (max wraparound deltas),
        DC extremes, uniform full-range noise, odd lengths around the
        4096-sample block boundary, empty and zero-length rows."""
        rng = np.random.RandomState(1)
        wavs = [
            np.tile(np.array([32767, -32768], np.int16), 3000),
            np.full(4095, 32767, np.int16),
            np.full(4097, -32768, np.int16),
            (rng.rand(5000).astype(np.float32) * 2 - 1),
            np.zeros(0, np.float32),
            np.zeros(4096, np.int16),
            np.array([1.5, -1.5, 0.5], np.float32),   # saturation
        ]
        self._roundtrip(wavs)

    def test_partial_batch_rows(self):
        wavs = _wavs(n=3)
        b, n_pad = 8, 10240
        cap, scap = wire.dpack_measure([wavs], b)
        flat = wire.pack_audio(wavs, cap, batch=b, codec="dpack",
                               scap=scap)
        got, lens = wire.unpack_audio(flat, b, n_pad, codec="dpack",
                                      scap=scap)
        assert list(np.asarray(lens)[3:]) == [0] * 5
        assert np.all(np.asarray(got)[3:] == 0.0)

    def test_xla_decode_width_extremes_match_pcm16(self):
        """The XLA decode must be bit-identical to the pcm16 reference on
        block-boundary/width edge cases."""
        rng = np.random.RandomState(9)
        wavs = [
            (rng.randn(rng.randint(3000, 12000)) * 0.3).astype(np.float32)
            for _ in range(3)
        ]
        # width extremes inside one batch: all-zero block (w=0), tiny
        # deltas (w=1-2), full-scale alternation (w=16)
        wavs += [np.zeros(4096, np.int16),
                 np.ones(4097, np.int16),
                 np.tile(np.array([32767, -32768], np.int16), 2100)]
        b = len(wavs)
        n_pad = -(-max(len(np.asarray(w)) for w in wavs) // 2048) * 2048
        cap, scap = wire.dpack_measure([wavs], b)
        flat = wire.pack_audio(wavs, cap, batch=b, codec="dpack",
                               scap=scap)
        unpack = jax.jit(wire.dpack_unpack, static_argnums=(1, 2, 3))
        got, lens = unpack(flat, b, n_pad, scap)
        want, want_lens = wire.unpack_audio(
            wire.pack_audio(wavs, wire.wire_cap(
                b, sum(len(np.asarray(w)) for w in wavs)), batch=b),
            b, n_pad,
        )
        np.testing.assert_array_equal(np.asarray(lens),
                                      np.asarray(want_lens))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    @pytest.mark.parametrize("n", [100, 3 * 4096 - 7, 8 * 4096,
                                   9 * 4096 + 5, 17 * 4096 + 1])
    def test_xla_decode_single_and_ragged_block_counts(self, n):
        """Block counts below, at and past the decode's blocks-per-scan-
        step window (1, 3, 8, 10, 18 blocks) must decode exactly."""
        rng = np.random.RandomState(11)
        wavs = [(rng.randn(n) * 0.2).astype(np.float32)]
        n_pad = -(-n // 2048) * 2048
        cap, scap = wire.dpack_measure([wavs], 1)
        flat = wire.pack_audio(wavs, cap, batch=1, codec="dpack",
                               scap=scap)
        got, lens = wire.dpack_unpack(flat, 1, n_pad, scap)
        want, _ = wire.unpack_audio(
            wire.pack_audio(wavs, wire.wire_cap(1, n)), 1, n_pad
        )
        assert int(lens[0]) == n
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def test_native_encoder_matches_numpy(self):
        """The C++ fast path must be BYTE-identical to the NumPy
        reference (skips if the native lib can't build)."""
        from asr_study_tpu.utils import native

        if not native.available():
            pytest.skip("native lib unavailable")
        rng = np.random.RandomState(2)
        wavs = [(rng.randn(rng.randint(500, 9000)) * 0.3
                 ).astype(np.float32) for _ in range(5)]
        wavs += [np.tile(np.array([32767, -32768], np.int16), 2000),
                 np.zeros(0, np.float32), np.full(4097, -5, np.int16)]
        a = wire.dpack_encode(wavs, use_native=False)
        b = wire.dpack_encode(wavs, use_native=True)
        assert a[0] == b[0] and a[3] == b[3]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])

    def test_randomized_roundtrips(self):
        """Property test: 12 random batch compositions (lengths around
        block boundaries, int16/float dtypes, extreme amplitudes, empty
        rows) must all decode bit-identical to pcm16."""
        rng = np.random.RandomState(42)
        for trial in range(12):
            wavs = []
            for _ in range(rng.randint(1, 6)):
                n = int(rng.choice([
                    0, 1, 15, 16, 17, 4095, 4096, 4097,
                    rng.randint(1, 20000),
                ]))
                if rng.rand() < 0.5:
                    w = rng.randint(-32768, 32768, n).astype(np.int16)
                else:
                    w = (rng.randn(n) * rng.choice([0.01, 0.3, 2.0])
                         ).astype(np.float32)
                wavs.append(w)
            n_pad = -(-max(
                [len(np.asarray(w)) for w in wavs] + [1]
            ) // 2048) * 2048
            self._roundtrip(wavs, n_pad=n_pad)

    def test_guards(self):
        wavs = _wavs(n=2)
        with pytest.raises(ValueError, match="multiple"):
            wire.dpack_pack(wavs, cap=1 << 16, scap=1000)
        with pytest.raises(ValueError, match="needs scap"):
            wire.pack_audio(wavs, cap=1 << 16, codec="dpack")
        with pytest.raises(ValueError, match="needs scap"):
            wire.unpack_audio(np.zeros(64, np.int16), 2, 64, codec="dpack")
        with pytest.raises(ValueError, match="overflow"):
            wire.dpack_pack(wavs, cap=1 << 16, scap=4096)   # blocks > scap
        with pytest.raises(ValueError, match="overflow"):
            cap, scap = wire.dpack_measure([wavs], 2)
            wire.dpack_pack(wavs, cap=64, scap=scap)


def test_pcm16_saturates_not_wraps():
    """Float samples beyond +-1 must clip to full scale, not wrap around
    (int16 cast overflow)."""
    w = np.array([1.5, -1.5, 0.5], np.float32)
    cap = wire.wire_cap(1, 3)
    flat = wire.pack_audio([w], cap)
    got, _ = jax.jit(wire.unpack_audio, static_argnums=(1, 2))(flat, 1, 8)
    got = np.asarray(got)[0]
    assert got[0] > 0.99 and got[1] < -0.99
    assert abs(got[2] - 0.5) < 1e-4


def test_pcm16_exact_inverse_of_wav_normalization():
    """Disk sample k -> read_wav's k/32768 -> wire -> unpack must return
    k/32768 EXACTLY for every representable k (the truncating x*32767
    quantizer shifted every nonzero sample 1 LSB toward zero)."""
    k = np.array(
        [-32768, -32767, -100, -1, 0, 1, 99, 12345, 32766, 32767],
        np.int32,
    )
    w = (k.astype(np.float32) / 32768.0).astype(np.float32)
    cap = wire.wire_cap(1, len(w))
    flat = wire.pack_audio([w], cap)
    got, lens = wire.unpack_audio(flat, 1, 1024)
    np.testing.assert_array_equal(np.asarray(got)[0, : len(w)], w)
    # and samples at/above full scale saturate instead of wrapping
    hot = np.array([1.5, -1.5, 1.0, -1.0], np.float32)
    flat2 = wire.pack_audio([hot], wire.wire_cap(1, 4))
    got2, _ = wire.unpack_audio(flat2, 1, 1024)
    np.testing.assert_array_equal(
        np.asarray(got2)[0, :4],
        np.array([32767, -32768, 32767, -32768], np.float32) / 32768.0,
    )


def test_choose_codec_policy():
    """Adaptive serving codec: network-speed links take dpack (bytes
    dominate), locally attached devices take pcm16 (the on-device decode
    premium dominates).  The 1 GB/s threshold is wire.py's design
    estimate."""
    assert wire.choose_codec(65.0) == "dpack"      # a network link
    assert wire.choose_codec(999.0) == "dpack"
    assert wire.choose_codec(1000.0) == "pcm16"
    assert wire.choose_codec(8000.0) == "pcm16"    # PCIe-attached


def test_probe_link_returns_bandwidth():
    bw = wire.probe_link(size_mb=0.5)
    assert bw > 0.0                                # inf allowed (CPU)
