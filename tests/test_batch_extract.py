"""Batched on-device dataset featurization (features/batch_extract.py):
order preservation across length bucketing, parity vs the per-utterance
device path, and the make_dataset --device CLI flow."""

import numpy as np
import pytest

from asr_study_tpu.features import audio
from asr_study_tpu.features.batch_extract import DeviceFeatureExtractor
from asr_study_tpu.features.device import DeviceFeaturizer


def _wavs(seed=0, n=7):
    rng = np.random.RandomState(seed)
    # bounded like real disk audio: PCM16 can't represent |x| > 1 (the
    # wire saturates; unbounded noise would diverge from the float oracle)
    return [
        np.clip(rng.randn(rng.randint(2000, 20000)) * 0.3, -0.95, 0.95)
        .astype(np.float32)
        for _ in range(n)
    ]


def _pcm16(w):
    """The wire's PCM16 round trip (bit-exact for disk wavs)."""
    q = np.clip(np.round(w.astype(np.float64) * 32768.0), -32768, 32767)
    return q.astype(np.int16).astype(np.float32) / 32768.0


def test_extract_batch_matches_device_featurizer():
    """Bucketed/batched wire extraction must equal one-at-a-time device
    calls on the PCM16-quantized audio, in the ORIGINAL order (bucketing
    sorts by length internally)."""
    wavs = _wavs()
    ex = DeviceFeatureExtractor(
        kind="mfcc", batch=3, align=2048
    )
    got = ex.extract_batch(wavs)
    dev = DeviceFeaturizer(kind="mfcc")
    for w, g in zip(wavs, got):
        n_pad = -(-len(w) // 2048) * 2048
        buf = np.zeros((1, n_pad), np.float32)
        buf[0, : len(w)] = _pcm16(w)
        feats, fl = dev(buf, np.array([len(w)], np.int32))
        want = np.asarray(feats)[0, : int(fl[0])]
        assert g.shape == want.shape
        np.testing.assert_allclose(g, want, rtol=1e-4, atol=5e-4)


def test_extract_batch_dpack_matches_pcm16():
    """The dpack wire is lossless: extraction over it must be
    BIT-identical to the pcm16 wire (same device program, same samples)."""
    wavs = _wavs()
    a = DeviceFeatureExtractor(
        kind="mfcc", batch=3, align=2048
    ).extract_batch(wavs)
    b = DeviceFeatureExtractor(
        kind="mfcc", batch=3, align=2048, wire_codec="dpack",
    ).extract_batch(wavs)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    import pytest

    with pytest.raises(ValueError, match="lossy"):
        DeviceFeatureExtractor(kind="mfcc", wire_codec="mulaw")


def test_extract_close_to_host_oracle():
    wavs = _wavs(seed=3, n=3)
    ex = DeviceFeatureExtractor(
        kind="mfcc", batch=2, log_floor=1e-2
    )
    got = ex.extract_batch(wavs)
    host = audio.MFCC(log_floor=1e-2)
    for w, g in zip(wavs, got):
        want = host(w)
        assert g.shape == want.shape
        np.testing.assert_allclose(g, want, rtol=1e-3, atol=5e-3)


def test_make_dataset_device_cli(tmp_path):
    """`make_dataset --device` end to end on the dummy corpus: the dataset
    is structurally identical to the host build and features match within
    the f32-vs-f64 tolerance."""
    from asr_study_tpu.cli.make_dataset import main as make_main
    from asr_study_tpu.data.corpora import Dummy

    corpus_dir = str(tmp_path / "corpus")
    Dummy(corpus_dir)  # generates the wavs deterministically
    host_h5 = str(tmp_path / "host.h5")
    dev_h5 = str(tmp_path / "dev.h5")
    # log_floor in BOTH builds: the dummy corpus has near-silent frames
    # where unfloored f32-vs-f64 log features legitimately diverge (the
    # documented worst case); the floor is the supported way to build
    # device datasets with tight host parity
    base = ["--parser", "dummy", "--dataset_dir", corpus_dir,
            "--input_parser", "mfcc",
            "--input_params", '{"log_floor": 1e-2}']
    assert make_main(base + ["--output", host_h5]) == 0
    assert make_main(
        base + ["--output", dev_h5, "--device", "--device_batch", "4"]
    ) == 0
    from asr_study_tpu.data.dataset_parser import (
        dataset_splits, read_attrs, read_h5,
    )

    assert dataset_splits(host_h5) == dataset_splits(dev_h5)
    for split in dataset_splits(host_h5):
        ah, ad = read_attrs(host_h5, split), read_attrs(dev_h5, split)
        assert ah["num_feats"] == ad["num_feats"]
        assert ah["feature"] == ad["feature"]
        xh, _, th, _ = read_h5(host_h5, split)
        xd, _, td, _ = read_h5(dev_h5, split)
        assert th == td
        for a, b in zip(xh, xd):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=5e-3)
