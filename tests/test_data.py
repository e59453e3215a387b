import json
import os

import numpy as np
import pytest

from asr_study_tpu.data import (
    BRSD,
    CSLU,
    DatasetGenerator,
    Dummy,
    LapsBM,
    Sid,
    VoxForge,
    read_h5,
)
from asr_study_tpu.features.audio import MFCC
from asr_study_tpu.features.wav import write_wav
from asr_study_tpu.text import CharParser


def _wav(path, dur=0.2, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    sig = 0.1 * rng.standard_normal(int(sr * dur)).astype(np.float32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_wav(path, sig, sr)


# -- corpus layouts ----------------------------------------------------------

def test_lapsbm_layout(tmp_path):
    root = tmp_path / "laps"
    for spk in ("LapsBM-F004", "LapsBM-M001"):
        for i in range(2):
            _wav(str(root / spk / f"LapsBM_{i:04d}.wav"), seed=i)
            (root / spk / f"LapsBM_{i:04d}.txt").write_text(f"frase número {i}")
    utts = list(LapsBM(str(root))._iter())
    assert len(utts) == 4
    assert {u["speaker"] for u in utts} == {"LapsBM-F004", "LapsBM-M001"}
    assert all(u["split"] == "test" for u in utts)


def test_voxforge_layout(tmp_path):
    root = tmp_path / "vf"
    sub = root / "anon-20120401-abc"
    (sub / "etc").mkdir(parents=True)
    (sub / "etc" / "PROMPTS").write_text(
        "pt-br/anon-20120401-abc/mfc/pt001 ola mundo\npt002 tudo bem\nmissing xx\n"
    )
    _wav(str(sub / "wav" / "pt001.wav"))
    _wav(str(sub / "wav" / "pt002.wav"), seed=1)
    utts = list(VoxForge(str(root))._iter())
    assert len(utts) == 2
    assert utts[0]["label"] == "ola mundo"
    assert utts[0]["speaker"] == "anon"


def test_sid_layout(tmp_path):
    root = tmp_path / "sid"
    spk = root / "Spkr001"
    spk.mkdir(parents=True)
    (spk / "prompts.txt").write_text("1=bom dia\n2= boa tarde\n")
    _wav(str(spk / "F001.wav"))
    _wav(str(spk / "F002.wav"), seed=1)
    _wav(str(spk / "F003.wav"), seed=2)  # no prompt -> skipped
    utts = list(Sid(str(root))._iter())
    assert len(utts) == 2
    assert utts[0]["label"] == "bom dia"


def test_cslu_layout(tmp_path):
    root = tmp_path / "cslu"
    _wav(str(root / "speech" / "00" / "spk1" / "a.wav"))
    t = root / "trans" / "00" / "spk1"
    t.mkdir(parents=True)
    (t / "a.txt").write_text("alô")
    utts = list(CSLU(str(root))._iter())
    assert len(utts) == 1
    assert utts[0]["label"] == "alô"


def test_brsd_combination(tmp_path):
    root = tmp_path / "brsd"
    # lapsbm part
    _wav(str(root / "lapsbm" / "LapsBM-F001" / "u0.wav"))
    (root / "lapsbm" / "LapsBM-F001" / "u0.txt").write_text("teste laps")
    # voxforge part
    sub = root / "voxforge" / "spk-1"
    (sub / "etc").mkdir(parents=True)
    (sub / "etc" / "PROMPTS").write_text("x1 fala brasil\n")
    _wav(str(sub / "wav" / "x1.wav"))
    utts = list(BRSD(str(root))._iter())
    splits = {u["split"] for u in utts}
    assert len(utts) == 2
    assert "test" in splits  # lapsbm
    assert splits - {"test"} <= {"train", "valid"}


def test_dummy_generates(tmp_path):
    d = Dummy(str(tmp_path / "dummy"), n=10)
    utts = list(d.iter_utterances())
    assert len(utts) == 10
    assert all(os.path.exists(u["audio"]) for u in utts)
    assert all(u["duration"] > 0 for u in utts)
    assert {u["split"] for u in utts} == {"train", "valid", "test"}
    # deterministic: re-iterating uses the same files
    utts2 = list(d.iter_utterances())
    assert [u["audio"] for u in utts] == [u["audio"] for u in utts2]


def test_synthwords_structured_corpus(tmp_path):
    from asr_study_tpu.data.corpora import SynthWords
    from asr_study_tpu.text.parser import CharParser

    d = SynthWords(str(tmp_path / "synth"), n=20, seed=3)
    utts = list(d.iter_utterances())
    assert len(utts) == 20
    assert {u["split"] for u in utts} == {"train", "valid", "test"}
    parser = CharParser()
    words = SynthWords._WORDS
    for u in utts:
        assert os.path.exists(u["audio"])
        assert parser.is_valid(u["label"])
        assert all(w in words for w in u["label"].split())
    # held-out splits share the train WORD distribution (the point of
    # the corpus): at this tiny n most val/test words occur in train;
    # full overlap needs the real corpus sizes (n >= 400)
    train_words = {w for u in utts if u["split"] == "train"
                   for w in u["label"].split()}
    held_words = {w for u in utts if u["split"] != "train"
                  for w in u["label"].split()}
    assert len(held_words & train_words) >= len(held_words) // 2
    # deterministic per seed: a second parser regenerates identical audio
    d2 = SynthWords(str(tmp_path / "synth2"), n=20, seed=3)
    utts2 = list(d2.iter_utterances())
    assert [u["label"] for u in utts] == [u["label"] for u in utts2]
    a = open(utts[0]["audio"], "rb").read()
    b = open(utts2[0]["audio"], "rb").read()
    assert a == b
    # a different seed gives different transcripts
    d3 = SynthWords(str(tmp_path / "synth3"), n=20, seed=4)
    assert [u["label"] for u in d3.iter_utterances()] != \
        [u["label"] for u in utts]
    # reusing a generated directory with DIFFERENT corpus params must be
    # loud, not a silent reuse of the old corpus (ADVICE r4)
    with pytest.raises(ValueError, match="manifest|generated with"):
        list(SynthWords(str(tmp_path / "synth"), n=40, seed=3)
             .iter_utterances())
    # ... while matching params reuse the directory fine
    again = list(SynthWords(str(tmp_path / "synth"), n=20, seed=3)
                 .iter_utterances())
    assert [u["audio"] for u in again] == [u["audio"] for u in utts]
    # a pre-manifest corpus dir (generated before the manifest existed)
    # is ADOPTED when its wav count matches n — the manifest gets
    # written — and rejected with a size-naming error otherwise
    mpath = tmp_path / "synth" / "_manifest.json"
    os.remove(mpath)
    adopted = list(SynthWords(str(tmp_path / "synth"), n=20, seed=3)
                   .iter_utterances())
    assert [u["audio"] for u in adopted] == [u["audio"] for u in utts]
    assert os.path.exists(mpath)
    os.remove(mpath)
    with pytest.raises(ValueError, match="no.*manifest|holds 20 wavs"):
        list(SynthWords(str(tmp_path / "synth"), n=40, seed=3)
             .iter_utterances())


# -- serialization -----------------------------------------------------------

def test_to_json(tmp_path):
    d = Dummy(str(tmp_path / "dummy"), n=5)
    manifest = str(tmp_path / "m.jsonl")
    n = d.to_json(manifest)
    assert n == 5
    rows = [json.loads(l) for l in open(manifest)]
    assert all("audio" in r and "label" in r for r in rows)


def test_to_h5_roundtrip(tmp_path):
    d = Dummy(str(tmp_path / "dummy"), n=10)
    h5 = str(tmp_path / "data.h5")
    parser = CharParser()
    mfcc = MFCC(d=False, dd=False)
    counts = d.to_h5(h5, mfcc, parser)
    assert sum(counts.values()) == 10
    inputs, labels, texts, durs = read_h5(h5, "train")
    assert len(inputs) == counts["train"]
    assert inputs[0].shape[1] == mfcc.num_feats
    assert parser.imap(labels[0]) == texts[0]
    # feature values roundtrip exactly
    utt0 = sorted(
        [u for u in d.iter_utterances() if u["split"] == "train"],
        key=lambda u: u["audio"],
    )[0]
    np.testing.assert_array_equal(inputs[0], mfcc(utt0["audio"]))


def test_h5_missing_split(tmp_path):
    d = Dummy(str(tmp_path / "dummy"), n=5)
    h5 = str(tmp_path / "data.h5")
    d.to_h5(h5, MFCC(d=False, dd=False))
    with pytest.raises(KeyError):
        read_h5(h5, "nope")


# -- generator ---------------------------------------------------------------

def _fake_rows(n=37, fdim=13, seed=0):
    rng = np.random.default_rng(seed)
    inputs = [
        rng.standard_normal((int(t), fdim)).astype(np.float32)
        for t in rng.integers(50, 400, size=n)
    ]
    labels = [
        rng.integers(0, 27, size=int(l)).astype(np.int32)
        for l in rng.integers(3, 30, size=n)
    ]
    return inputs, labels


def test_generator_shapes_static():
    inputs, labels = _fake_rows()
    gen = DatasetGenerator(batch_size=8, time_multiple=64, label_multiple=16)
    it = gen.flow(inputs, labels)
    batches = list(it.epoch(seed=0))
    assert len(batches) == it.steps_per_epoch == 5
    for b in batches:
        assert b.inputs.shape[0] == 8
        assert b.inputs.shape[1] % 64 == 0
        assert b.labels.shape[1] % 16 == 0
        assert b.inputs.dtype == np.float32
        assert b.labels.dtype == np.int32


def test_generator_masking_and_padding():
    inputs, labels = _fake_rows(n=10)
    gen = DatasetGenerator(batch_size=8)
    batches = sorted(gen.flow(inputs, labels).epoch(0), key=lambda b: -b.weights.sum())
    full, ragged = batches
    assert full.weights.sum() == 8
    assert ragged.weights.sum() == 2
    # padded rows are still valid CTC problems
    assert (ragged.input_lengths > 0).all()
    assert (ragged.label_lengths >= 1).all()
    assert (ragged.input_lengths >= ragged.label_lengths).all()
    # real rows preserve their data
    j = int(np.argmax(full.weights))
    i = int(full.uids[j])
    t = inputs[i].shape[0]
    np.testing.assert_array_equal(full.inputs[j, :t], inputs[i])
    assert full.input_lengths[j] == t


def test_generator_bucketing_reduces_padding_waste():
    inputs, labels = _fake_rows(n=64)

    def padded_frames(sort):
        gen = DatasetGenerator(batch_size=8, sort_by_duration=sort, shuffle=False)
        return sum(b.inputs.shape[1] * b.size for b in gen.flow(inputs, labels).epoch())

    # duration sorting packs similar lengths together -> less padded compute
    assert padded_frames(True) < padded_frames(False)


def test_generator_epoch_shuffles_batch_order():
    inputs, labels = _fake_rows(n=64)
    it = DatasetGenerator(batch_size=8).flow(inputs, labels)
    e1 = [b.uids.tolist() for b in it.epoch(seed=1)]
    e2 = [b.uids.tolist() for b in it.epoch(seed=2)]
    assert sorted(map(tuple, e1)) == sorted(map(tuple, e2))  # same buckets
    assert e1 != e2  # different order


def test_generator_epoch_ordered_is_ascending_duration():
    """epoch(ordered=True) = SortaGrad's first epoch: shortest batches
    first, identical for every seed, with later shuffled epochs
    untouched."""
    inputs, labels = _fake_rows(n=64)
    it = DatasetGenerator(batch_size=8).flow(inputs, labels)

    def real_max_frames(b):
        return int(b.input_lengths[b.weights > 0].max())

    o1 = list(it.epoch(seed=1, ordered=True))
    o2 = list(it.epoch(seed=2, ordered=True))
    assert [b.uids.tolist() for b in o1] == [b.uids.tolist() for b in o2]
    lens = [real_max_frames(b) for b in o1]
    assert lens == sorted(lens)
    # a shuffled epoch still shuffles
    e1 = [b.uids.tolist() for b in it.epoch(seed=1)]
    assert e1 != [b.uids.tolist() for b in o1]


def test_generator_empty_raises():
    with pytest.raises(ValueError):
        DatasetGenerator().flow([], [])


# -- lazy HDF5 streaming -------------------------------------------------------

def _streaming_h5(tmp_path, n=12):
    d = Dummy(str(tmp_path / "dummy"), n=n)
    h5 = str(tmp_path / "data.h5")
    d.to_h5(h5, MFCC(d=False, dd=False), CharParser())
    return h5


def test_flow_from_h5_lazy_matches_in_memory(tmp_path):
    """Per-batch disk reads must produce byte-identical batches to the
    in-memory fast path (same order, same packing, same padding)."""
    h5 = _streaming_h5(tmp_path)
    gen = DatasetGenerator(batch_size=4, shuffle=False)
    mem = gen.flow_from_h5(h5, "train", lazy=False)
    lazy = gen.flow_from_h5(h5, "train", lazy=True)
    assert mem.num_feats == lazy.num_feats
    assert mem.steps_per_epoch == lazy.steps_per_epoch
    for bm, bl in zip(mem.epoch(seed=3), lazy.epoch(seed=3)):
        np.testing.assert_array_equal(bm.inputs, bl.inputs)
        np.testing.assert_array_equal(bm.input_lengths, bl.input_lengths)
        np.testing.assert_array_equal(bm.labels, bl.labels)
        np.testing.assert_array_equal(bm.label_lengths, bl.label_lengths)
        np.testing.assert_array_equal(bm.weights, bl.weights)
        np.testing.assert_array_equal(bm.uids, bl.uids)
        assert bm.texts == bl.texts


def _packed_h5(tmp_path, n=12):
    d = Dummy(str(tmp_path / "dummy"), n=n)
    h5 = str(tmp_path / "packed.h5")
    d.to_h5(h5, MFCC(d=False, dd=False), CharParser(), layout="packed")
    return h5


def test_packed_layout_roundtrip(tmp_path):
    """Packed datasets hold the same utterances as vlen files (modulo the
    duration-sorted row order) and read back value-identical features."""
    from asr_study_tpu.data.dataset_parser import read_attrs, read_h5

    vlen_h5 = _streaming_h5(tmp_path)
    packed_h5 = _packed_h5(tmp_path)
    vi, vl, vt, vd = read_h5(vlen_h5, "train")
    pi, pl, pt, pd = read_h5(packed_h5, "train")
    assert sorted(vt) == sorted(pt)
    assert np.all(np.diff(pd) >= 0)  # duration-sorted on disk
    by_text = {t: (x, y) for x, y, t in zip(vi, vl, vt)}
    for x, y, t in zip(pi, pl, pt):
        np.testing.assert_array_equal(x, by_text[t][0])
        np.testing.assert_array_equal(y, by_text[t][1])
    assert os.path.isdir(packed_h5)
    assert read_attrs(packed_h5, "train")["layout"] == "packed"
    assert read_attrs(vlen_h5, "train")["layout"] == "vlen"
    offs = np.load(os.path.join(packed_h5, "train", "offsets.npy"))
    flat = np.load(os.path.join(packed_h5, "train", "inputs_flat.npy"))
    assert offs[-1] == flat.shape[0]


def test_packed_lazy_matches_in_memory(tmp_path):
    """Streaming a packed file per batch produces byte-identical batches
    to loading it fully (same order, packing, padding)."""
    h5 = _packed_h5(tmp_path)
    gen = DatasetGenerator(batch_size=4, shuffle=False)
    mem = gen.flow_from_h5(h5, "train", lazy=False)
    lazy = gen.flow_from_h5(h5, "train", lazy=True)
    assert mem.steps_per_epoch == lazy.steps_per_epoch
    for bm, bl in zip(mem.epoch(seed=3), lazy.epoch(seed=3)):
        np.testing.assert_array_equal(bm.inputs, bl.inputs)
        np.testing.assert_array_equal(bm.input_lengths, bl.input_lengths)
        np.testing.assert_array_equal(bm.labels, bl.labels)
        np.testing.assert_array_equal(bm.weights, bl.weights)
        np.testing.assert_array_equal(bm.uids, bl.uids)


def test_packed_feature_rows_interface(tmp_path):
    """H5FeatureRows over a packed file: row access, reordered and
    non-contiguous pack_into (exercises the run-coalescing reads)."""
    from asr_study_tpu.data.dataset_parser import H5FeatureRows, read_h5

    h5 = _packed_h5(tmp_path, n=8)
    rows = H5FeatureRows(h5, "train")
    inputs, _, _, _ = read_h5(h5, "train")
    assert len(rows) == len(inputs)
    for i in range(len(rows)):
        assert rows.row_length(i) == inputs[i].shape[0]
        np.testing.assert_array_equal(rows[i], inputs[i])
    t_pad = max(x.shape[0] for x in inputs) + 3
    for idx in (np.arange(len(inputs))[::-1],  # reversed, one run
                np.array([0, 2, 3, 1]),        # out-of-order, one run
                np.array([5, 0, 3, 2]),        # non-contiguous: 3 runs
                np.arange(len(inputs))):       # ascending, one run
        out = np.zeros((len(idx), t_pad, rows.num_feats), np.float32)
        rows.pack_into(idx, out)
        for j, i in enumerate(idx):
            t = inputs[i].shape[0]
            np.testing.assert_array_equal(out[j, :t], inputs[i])
            assert np.all(out[j, t:] == 0)
    rows.close()


@pytest.mark.parametrize("layout", ["vlen", "packed"])
def test_pack_into_defines_uninitialized_buffer(tmp_path, layout):
    """pack_into owns the whole output buffer: tails and ragged padding
    rows must be zeroed even when the caller passes garbage (the
    generator passes np.empty on the lazy path)."""
    from asr_study_tpu.data.dataset_parser import H5FeatureRows, read_h5

    h5 = (_packed_h5 if layout == "packed" else _streaming_h5)(tmp_path, n=6)
    rows = H5FeatureRows(h5, "train")
    inputs, _, _, _ = read_h5(h5, "train")
    n = len(inputs)
    t_pad = max(x.shape[0] for x in inputs) + 7
    out = np.full((n + 2, t_pad, rows.num_feats), np.nan, np.float32)
    rows.pack_into(np.arange(n), out)
    assert np.isfinite(out).all()
    for j in range(n):
        t = inputs[j].shape[0]
        np.testing.assert_array_equal(out[j, :t], inputs[j])
        assert np.all(out[j, t:] == 0)
    assert np.all(out[n:] == 0)
    rows.close()


def test_packed_layout_with_batched_extractor(tmp_path):
    """make_dataset --device uses chunked extract_batch calls; the packed
    writer's sequential-append bookkeeping must hold across chunks."""
    from asr_study_tpu.data.dataset_parser import read_h5, write_split

    rng = np.random.default_rng(0)
    rows = [rng.standard_normal((int(t), 7)).astype(np.float32)
            for t in rng.integers(5, 40, size=11)]

    class BatchedFeat:
        num_feats = 7

        def extract_batch(self, paths):
            return [rows[int(p[1:])] for p in paths]

        def __str__(self):
            return "batched-fake"

    utts = [{"audio": f"u{i}", "label": "abc", "duration": rows[i].shape[0]}
            for i in range(len(rows))]
    h5 = str(tmp_path / "p")
    write_split(os.path.join(h5, "train"), utts, BatchedFeat(),
                CharParser(), chunk=4, layout="packed")
    with open(os.path.join(h5, "dataset.json"), "w") as f:
        json.dump({"layout": "packed", "splits": ["train"]}, f)
    inputs, _, _, durs = read_h5(h5, "train")
    assert len(inputs) == len(rows)
    by_len = sorted(rows, key=lambda r: r.shape[0])
    for got, want in zip(inputs, by_len):
        np.testing.assert_array_equal(got, want)


def test_write_split_rejects_unknown_layout(tmp_path):
    d = Dummy(str(tmp_path / "dummy"), n=3)
    with pytest.raises(ValueError, match="layout"):
        d.to_h5(str(tmp_path / "x.h5"), MFCC(d=False, dd=False),
                CharParser(), layout="columnar")


def test_flow_from_h5_auto_threshold(tmp_path):
    """The auto mode streams splits whose feature payload exceeds
    max_in_memory_bytes and keeps smaller ones in memory."""
    from asr_study_tpu.data.dataset_parser import H5FeatureRows

    h5 = _streaming_h5(tmp_path)
    small = DatasetGenerator(batch_size=4).flow_from_h5(h5, "train")
    assert isinstance(small.inputs, list)          # fits -> in memory
    tiny_budget = DatasetGenerator(batch_size=4, max_in_memory_bytes=1)
    streamed = tiny_budget.flow_from_h5(h5, "train")
    assert isinstance(streamed.inputs, H5FeatureRows)


def test_h5_feature_rows_interface(tmp_path):
    from asr_study_tpu.data.dataset_parser import H5FeatureRows, read_h5

    h5 = _streaming_h5(tmp_path, n=6)
    rows = H5FeatureRows(h5, "train")
    inputs, _, _, _ = read_h5(h5, "train")
    assert len(rows) == len(inputs)
    assert rows.num_feats == inputs[0].shape[1]
    assert rows.nbytes == sum(x.nbytes for x in inputs)
    for i in range(len(rows)):
        assert rows.row_length(i) == inputs[i].shape[0]
        np.testing.assert_array_equal(rows[i], inputs[i])
    # pack_into: whole-batch read lands rows in order with zero padding
    t_pad = max(x.shape[0] for x in inputs) + 5
    out = np.zeros((len(inputs), t_pad, rows.num_feats), np.float32)
    rows.pack_into(np.arange(len(inputs))[::-1], out)
    for j, i in enumerate(reversed(range(len(inputs)))):
        np.testing.assert_array_equal(out[j, : inputs[i].shape[0]], inputs[i])
        assert np.all(out[j, inputs[i].shape[0]:] == 0)
    rows.close()
