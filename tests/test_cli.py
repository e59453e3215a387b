"""CLI plumbing: arg parsing, make_dataset main, registry error UX."""

import json

import pytest

from asr_study_tpu.cli.eval import build_argparser as eval_parser
from asr_study_tpu.cli.make_dataset import main as make_dataset_main
from asr_study_tpu.data.dataset_parser import dataset_splits
from asr_study_tpu.cli.predict import build_argparser as predict_parser
from asr_study_tpu.cli.train import build_argparser as train_parser
from asr_study_tpu.utils.registry import get_from_module


def test_train_argparser_defaults():
    args = train_parser().parse_args(["--dataset", "d.h5"])
    assert args.model == "graves2006"
    assert args.opt == "adam"
    assert args.batch_size == 32
    assert not args.resume


def test_eval_predict_argparsers():
    a = eval_parser().parse_args(["--dataset", "d.h5", "--save", "r"])
    assert a.split == "test" and a.beam_width == 0
    p = predict_parser().parse_args(["--save", "r", "x.wav", "y.wav"])
    assert p.wavs == ["x.wav", "y.wav"]


def test_make_dataset_main(tmp_path, capsys):
    out = str(tmp_path / "d.h5")
    rc = make_dataset_main([
        "--parser", "dummy",
        "--dataset_dir", str(tmp_path / "corpus"),
        "--output", out,
        "--input_parser", "mfcc",
        "--to_json", str(tmp_path / "m.json"),
    ])
    assert rc == 0
    assert "train" in dataset_splits(out)
    manifest = [
        json.loads(line) for line in open(tmp_path / "m.json")
    ]
    assert len(manifest) == 16
    assert all("label" in u and "audio" in u for u in manifest)


def test_make_dataset_corpus_params(tmp_path):
    """--corpus_params forwards JSON kwargs to the corpus constructor
    (synthwords/dummy sizing without pre-generating the directory)."""
    out = str(tmp_path / "s.h5")
    rc = make_dataset_main([
        "--parser", "synthwords",
        "--dataset_dir", str(tmp_path / "synth"),
        "--corpus_params", '{"n": 12, "seed": 2}',
        "--output", out,
        "--input_parser", "mfcc",
    ])
    assert rc == 0
    import os
    wavs = [f for f in os.listdir(tmp_path / "synth")
            if f.endswith(".wav")]
    assert len(wavs) == 12
    assert set(dataset_splits(out)) == {"train", "valid", "test"}


def test_export_weights_roundtrip(tmp_path):
    """extras/export_weights.py: run dir -> single npz, bit-exact."""
    import numpy as np

    from asr_study_tpu.cli.train import main as train_main
    from extras.export_weights import main as export_main

    out = str(tmp_path / "d.h5")
    rc = make_dataset_main([
        "--parser", "dummy", "--dataset_dir", str(tmp_path / "corpus"),
        "--output", out, "--input_parser", "mfcc",
    ])
    assert rc == 0
    rc = train_main([
        "--platform", "cpu", "--dataset", out,
        "--model", "graves2006", "--params", "num_hiddens=8",
        "--epochs", "1", "--batch_size", "10", "--num_devices", "1",
        "--save", str(tmp_path / "run"),
    ])
    assert rc == 0
    npz = str(tmp_path / "m.npz")
    rc = export_main([
        "--save", str(tmp_path / "run"), "--output", npz, "--verify",
    ])
    assert rc == 0
    with np.load(npz) as z:
        import json as _json

        meta = _json.loads(str(z["__meta__"]))
        assert meta["model"] == "graves2006"
        assert any(k.endswith("/wx") for k in z.files)


@pytest.mark.parametrize("layout", ["packed", "vlen"])
def test_make_dataset_packed_layout(tmp_path, layout):
    """--layout packed (the default) writes a directory of .npy arrays
    that needs no h5py; --layout vlen the reference-compatible HDF5."""
    import os

    from asr_study_tpu.data.dataset_parser import read_attrs

    out = str(tmp_path / "d")
    rc = make_dataset_main([
        "--parser", "dummy",
        "--dataset_dir", str(tmp_path / "corpus"),
        "--output", out,
        "--input_parser", "mfcc",
        "--layout", layout,
    ])
    assert rc == 0
    assert os.path.isdir(out) == (layout == "packed")
    assert read_attrs(out, "train")["layout"] == layout
    if layout == "packed":
        train = os.path.join(out, "train")
        assert {"inputs_flat.npy", "offsets.npy"} <= set(os.listdir(train))
    else:
        import h5py

        with h5py.File(out) as f:
            assert "inputs" in f["train"]


def test_json_manifest_flow(tmp_path):
    """to_json manifest -> flow_from_json with on-the-fly features."""
    from asr_study_tpu.cli.data_flow import flow_from_arg
    from asr_study_tpu.data.corpora import Dummy
    from asr_study_tpu.data.generator import DatasetGenerator
    from asr_study_tpu.text.parser import CharParser

    corpus = Dummy(str(tmp_path / "corpus"), n=6)
    manifest = str(tmp_path / "m.json")
    corpus.to_json(manifest)
    gen = DatasetGenerator(batch_size=4)
    it = flow_from_arg(
        gen, manifest, None, CharParser(), "mfcc", None
    )
    assert it.num_samples == 6
    batch = next(iter(it.epoch(0)))
    assert batch.inputs.shape[-1] == 39  # mfcc + deltas
    assert batch.texts is not None and batch.texts[0]


@pytest.mark.parametrize("wire_codec", ["pcm16", "dpack", "mulaw", "auto"])
def test_predict_on_device_batching(tmp_path, wire_codec):
    """--on_device glue: wire batching, batch stitching, and partial-tail
    truncation, for both wire codecs.  A stub acoustic model emits logits
    that peak at class (num_frames mod 20), so the greedy decode
    deterministically encodes each row's frame count — any row
    misordering/misalignment through pack_batches/unpack_audio shows up
    as a wrong token."""
    import argparse

    import jax
    import jax.numpy as jnp
    import numpy as np

    from asr_study_tpu.cli.predict import _predict_on_device
    from asr_study_tpu.features import audio
    from asr_study_tpu.features.wav import write_wav

    rng = np.random.RandomState(0)
    paths, want = [], []
    for i, n in enumerate([3000, 5000, 4000, 7000, 3500]):  # 2 batches @3
        p = str(tmp_path / f"u{i}.wav")
        write_wav(p, (rng.randn(n) * 0.2).astype(np.float32))
        paths.append(p)
        want.append(audio.num_frames(n, 400, 160) % 20)

    class StubModel:
        blank_id = 26

        def apply(self, params, feats, lengths, train=False):
            b, t, _ = feats.shape
            cls = (lengths % 20).astype(jnp.int32)          # [B]
            return jax.nn.one_hot(
                jnp.broadcast_to(cls[:, None], (b, t)), 27
            ) * 10.0

    class StubState:
        params = {}

    args = argparse.Namespace(
        wavs=paths, input_parser="mfcc", beam_width=0, batch_size=3,
        wire_codec=wire_codec, lm_alpha=1.0, lm_beta=0.0,
    )
    dec, lens = _predict_on_device(args, StubModel(), StubState(), {})
    assert dec.shape[0] == len(paths) and lens.shape[0] == len(paths)
    assert list(lens) == [1] * len(paths)  # repeats collapse to one token
    assert [int(dec[i, 0]) for i in range(len(paths))] == want


def test_registry_error_lists_names():
    with pytest.raises(KeyError) as e:
        get_from_module("model", "definitely_not_a_model")
    assert "graves2006" in str(e.value)
    with pytest.raises(KeyError) as e:
        get_from_module("corpus", "nope")
    assert "lapsbm" in str(e.value)


def test_eval_data_parallel_matches_single(tmp_path, capsys):
    """eval.py --num_devices 8 shard_maps batches over the virtual mesh
    and must reproduce the single-device metrics exactly.  The run is
    saved with a schedule-bearing optimizer (lr_decay): regression for
    load_run crashing on any opt_state structure it didn't rebuild."""
    import jax

    from asr_study_tpu.cli.eval import main as eval_main
    from asr_study_tpu.data.corpora import Dummy
    from asr_study_tpu.data.generator import DatasetGenerator
    from asr_study_tpu.features.audio import MFCC
    from asr_study_tpu.models.zoo import build_model
    from asr_study_tpu.text.parser import CharParser
    from asr_study_tpu.train.checkpoint import CheckpointManager
    from asr_study_tpu.train.trainer import Trainer, make_optimizer

    h5 = str(tmp_path / "d.h5")
    lp = CharParser()
    Dummy(str(tmp_path / "corpus"), n=8).to_h5(h5, MFCC(), lp)
    it = DatasetGenerator(batch_size=8).flow_from_h5(h5, "test")
    model = build_model(
        "graves2006", {"num_hiddens": 8}, num_classes=lp.num_classes
    )
    trainer = Trainer(
        model, make_optimizer("adam", 1e-3, 400.0,
                              lr_decay=0.9, decay_steps=5)
    )
    state = trainer.init_state(jax.random.PRNGKey(0), it.num_feats)
    ckpt = CheckpointManager(str(tmp_path / "run"))
    ckpt.save(state, metrics={"val_loss": 1.0}, hparams={
        "model": "graves2006", "params": "num_hiddens=8",
        "num_feats": it.num_feats, "num_classes": lp.num_classes,
        "lr_decay": 0.9,
    })

    argv = ["--dataset", h5, "--split", "test",
            "--save", str(tmp_path / "run"), "--batch_size", "8",
            "--platform", "cpu"]
    assert eval_main(argv) == 0
    out1 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert eval_main(argv + ["--num_devices", "8"]) == 0
    out8 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out8["num_utts"] == out1["num_utts"]
    assert out8["cer"] == pytest.approx(out1["cer"], abs=1e-9)
    assert out8["wer"] == pytest.approx(out1["wer"], abs=1e-9)
    assert out8["loss"] == pytest.approx(out1["loss"], rel=1e-5)

    # beam decode under shard_map too (per-row vmap inside the shard)
    assert eval_main(argv + ["--beam_width", "4"]) == 0
    outb1 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert eval_main(argv + ["--beam_width", "4", "--num_devices", "8"]) == 0
    outb8 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert outb8["cer"] == pytest.approx(outb1["cer"], abs=1e-9)
    assert outb8["loss"] == pytest.approx(outb1["loss"], rel=1e-5)


def test_train_lm_and_eval_fusion(tmp_path, capsys):
    """extras/train_lm.py -> eval --lm: fit a char LM on the dummy
    corpus' transcripts, then run LM-fused beam eval end to end."""
    import jax

    from asr_study_tpu.cli.eval import main as eval_main
    from asr_study_tpu.cli.train_lm import main as train_lm_main
    from asr_study_tpu.data.corpora import Dummy
    from asr_study_tpu.data.generator import DatasetGenerator
    from asr_study_tpu.features.audio import MFCC
    from asr_study_tpu.models.zoo import build_model
    from asr_study_tpu.text.lm import CharNGramLM
    from asr_study_tpu.text.parser import CharParser
    from asr_study_tpu.train.checkpoint import CheckpointManager
    from asr_study_tpu.train.trainer import Trainer, make_optimizer

    h5 = str(tmp_path / "d.h5")
    lp = CharParser()
    Dummy(str(tmp_path / "corpus"), n=8).to_h5(h5, MFCC(), lp)

    lm_path = str(tmp_path / "lm.npz")
    rc = train_lm_main([
        "--dataset", h5, "--splits", "train",
        "--order", "2", "--output", lm_path, "--held_out", "test",
    ])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["num_sequences"] > 0
    assert report["train_perplexity"] > 1.0
    assert "held_out_perplexity" in report
    lm = CharNGramLM.load(lm_path)
    assert lm.n_char == lp.num_classes
    assert lm.space_id == lp.char_to_id[" "]

    it = DatasetGenerator(batch_size=8).flow_from_h5(h5, "test")
    model = build_model(
        "graves2006", {"num_hiddens": 8}, num_classes=lp.num_classes
    )
    trainer = Trainer(model, make_optimizer())
    state = trainer.init_state(jax.random.PRNGKey(0), it.num_feats)
    ckpt = CheckpointManager(str(tmp_path / "run"))
    ckpt.save(state, metrics={"val_loss": 1.0}, hparams={
        "model": "graves2006", "params": "num_hiddens=8",
        "num_feats": it.num_feats, "num_classes": lp.num_classes,
    })

    argv = ["--dataset", h5, "--split", "test",
            "--save", str(tmp_path / "run"), "--batch_size", "8",
            "--platform", "cpu", "--beam_width", "4",
            "--lm", lm_path, "--lm_alpha", "0.5", "--lm_beta", "0.2"]
    assert eval_main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["decoder"] == "beam4+lm"
    assert out["lm"]["order"] == 2

    # --lm without beam decoding is a loud config error
    with pytest.raises(SystemExit):
        eval_main(["--dataset", h5, "--split", "test",
                   "--save", str(tmp_path / "run"), "--platform", "cpu",
                   "--lm", lm_path])


def test_train_lm_from_text_file(tmp_path, capsys):
    from asr_study_tpu.cli.train_lm import main as train_lm_main
    from asr_study_tpu.text.lm import CharNGramLM

    txt = tmp_path / "corpus.txt"
    txt.write_text("ola tudo bem\ncomo vai voce\n\nnão é válido???\n")
    out = str(tmp_path / "lm.npz")
    rc = train_lm_main([
        "--text", str(txt), "--order", "3", "--output", out,
    ])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the accented line normalizes cleanly ("nao e valido") but the '?'s
    # make it invalid -> skipped; 2 valid lines remain
    assert report["num_sequences"] == 2
    lm = CharNGramLM.load(out)
    assert lm.order == 3 and lm.logp.shape == (27 * 27, 27)


def test_train_lm_from_json_manifest(tmp_path, capsys):
    """--dataset with a to_json JSON-LINES manifest (the project's
    manifest format): split filtering and label parsing must work — a
    regression for the r5 review finding that this path parsed the file
    as one split-keyed dict and crashed on every real manifest."""
    from asr_study_tpu.cli.train_lm import main as train_lm_main
    from asr_study_tpu.data.corpora import Dummy

    d = Dummy(str(tmp_path / "corpus"), n=8)
    n_train = sum(
        1 for u in d.iter_utterances() if u["split"] == "train"
    )
    for ext in (".json", ".jsonl"):
        manifest = str(tmp_path / f"m{ext}")
        d.to_json(manifest)
        out = str(tmp_path / f"lm{ext}.npz")
        rc = train_lm_main([
            "--dataset", manifest, "--splits", "train",
            "--order", "2", "--output", out, "--held_out", "test",
        ])
        assert rc == 0
        report = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1]
        )
        assert report["num_sequences"] == n_train
        assert "held_out_perplexity" in report


def test_parity_snapshot_roundtrip(tmp_path):
    """extras/parity_snapshot.py: create -> verify must pass, and the
    committed artifact (parity/oracle_v1.npz) must match the current
    oracle — the regression set for the 'bit-for-bit within tolerance'
    north-star clause (VERDICT r2 #5)."""
    import os
    import sys
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "extras"))
    from parity_snapshot import main as snap_main

    out = str(tmp_path / "snap.npz")
    assert snap_main(["create", "--out", out]) == 0
    assert snap_main(["verify", out]) == 0
    committed = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "parity", "oracle_v1.npz")
    assert snap_main(["verify", committed]) == 0
