"""On-device featurization training (``Trainer(featurizer=...)`` /
``train.py --device_features``): raw padded waveforms enter the train
step and the whole wav->features->model->CTC->backward chain is ONE XLA
program.  Parity oracle: the SAME featurizer run standalone on the same
wavs, with the features then fed to a featurizer-less Trainer — both
paths must produce identical losses and updated parameters.

[ref: preprocessing/audio.py + train.py — the reference precomputes
features on host because its DSP is the expensive stage; on an
accelerator the featurizer is in-step matmul work, so raw-wav training
is the flow this mode adds.]
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from asr_study_tpu.features.device import DeviceFeaturizer
from asr_study_tpu.models.zoo import build_model
from asr_study_tpu.train.trainer import Trainer, make_mesh, make_optimizer


def _wav_batch(key, batch=4, n=4096):
    """Ragged [B, N, 1] raw batch (the generator's raw-feature layout)."""
    wavs = jax.random.normal(key, (batch, n)) * 0.1
    lens = jnp.asarray(
        ([n, n - 511, n - 1024, 2048] * batch)[:batch], jnp.int32
    )
    t = jnp.arange(n)
    wavs = jnp.where(t[None, :] < lens[:, None], wavs, 0.0)
    return wavs[..., None], lens


def _labels(key, batch, l=3, num_classes=4):
    return (
        jax.random.randint(key, (batch, l), 0, num_classes),
        jnp.full((batch,), l, jnp.int32),
    )


def _trainer(featurizer=None, mesh=None, input_dim=39):
    model = build_model(
        "graves2006", {"num_hiddens": 8}, num_classes=4
    )
    tx = make_optimizer("adam", 5e-3, clipnorm=10.0)
    tr = Trainer(model, tx, mesh=mesh, donate_state=False,
                 featurizer=featurizer)
    state = tr.init_state(jax.random.PRNGKey(0), input_dim=input_dim)
    return tr, state


class TestFeaturizerHook:
    def test_train_step_matches_precomputed_features(self):
        feat = DeviceFeaturizer(kind="mfcc")
        wavs, wav_lens = _wav_batch(jax.random.PRNGKey(1))
        labels, label_lens = _labels(jax.random.PRNGKey(2), wavs.shape[0])
        weights = jnp.ones((wavs.shape[0],), jnp.float32)
        rng = jax.random.PRNGKey(3)

        tr_raw, state = _trainer(featurizer=feat,
                                 input_dim=feat.num_feats)
        s_raw, m_raw = tr_raw.train_step(
            state, wavs, wav_lens, labels, label_lens, weights, rng
        )

        feats, feat_lens = feat(wavs[..., 0], wav_lens)
        tr_pre, _ = _trainer(featurizer=None, input_dim=feat.num_feats)
        s_pre, m_pre = tr_pre.train_step(
            state, feats, feat_lens, labels, label_lens, weights, rng
        )

        np.testing.assert_allclose(
            float(m_raw["loss"]), float(m_pre["loss"]), rtol=1e-6
        )
        for a, b in zip(jax.tree_util.tree_leaves(s_raw.params),
                        jax.tree_util.tree_leaves(s_pre.params)):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=2e-5, atol=1e-7
            )

    def test_eval_step_matches_precomputed_features(self):
        feat = DeviceFeaturizer(kind="logfbank", nfilt=8, d=False,
                                dd=False)
        wavs, wav_lens = _wav_batch(jax.random.PRNGKey(4))
        labels, label_lens = _labels(jax.random.PRNGKey(5), wavs.shape[0])
        weights = jnp.ones((wavs.shape[0],), jnp.float32)

        tr_raw, state = _trainer(featurizer=feat,
                                 input_dim=feat.num_feats)
        out_raw = tr_raw.eval_step(
            state, wavs, wav_lens, labels, label_lens, weights
        )
        feats, feat_lens = feat(wavs[..., 0], wav_lens)
        tr_pre, _ = _trainer(featurizer=None, input_dim=feat.num_feats)
        out_pre = tr_pre.eval_step(
            state, feats, feat_lens, labels, label_lens, weights
        )
        np.testing.assert_allclose(
            float(out_raw["loss"]), float(out_pre["loss"]), rtol=1e-6
        )
        assert float(out_raw["num_seqs"]) == float(out_pre["num_seqs"])

    def test_dp_mesh_matches_single_device(self):
        assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
        feat = DeviceFeaturizer(kind="mfcc", d=False, dd=False)
        wavs, wav_lens = _wav_batch(jax.random.PRNGKey(6), batch=8)
        labels, label_lens = _labels(jax.random.PRNGKey(7), 8)
        weights = jnp.ones((8,), jnp.float32)
        rng = jax.random.PRNGKey(8)

        tr_one, state = _trainer(featurizer=feat,
                                 input_dim=feat.num_feats)
        s1, m1 = tr_one.train_step(
            state, wavs, wav_lens, labels, label_lens, weights, rng
        )
        tr_dp, state_dp = _trainer(featurizer=feat, mesh=make_mesh(2),
                                   input_dim=feat.num_feats)
        s2, m2 = tr_dp.train_step(
            state_dp, wavs, wav_lens, labels, label_lens, weights, rng
        )
        np.testing.assert_allclose(
            float(m1["loss"]), float(m2["loss"]), rtol=1e-5
        )
        for a, b in zip(jax.tree_util.tree_leaves(s1.params),
                        jax.tree_util.tree_leaves(s2.params)):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6
            )


class TestDeviceFeaturesCLI:
    @pytest.fixture(scope="class")
    def raw_run(self, tmp_path_factory):
        """make_dataset --input_parser raw -> train --device_features."""
        from asr_study_tpu.cli.make_dataset import main as make_main
        from asr_study_tpu.cli.train import main as train_main

        root = tmp_path_factory.mktemp("devfeat")
        h5 = str(root / "raw.h5")
        rc = make_main([
            "--parser", "dummy", "--dataset_dir", str(root / "corpus"),
            "--output", h5, "--input_parser", "raw",
        ])
        assert rc == 0
        run = str(root / "run")
        rc = train_main([
            "--dataset", h5, "--model", "graves2006",
            "--params", "num_hiddens=8", "--epochs", "2",
            "--batch_size", "4", "--num_devices", "1",
            "--save", run, "--log_every", "1",
            "--device_features", "mfcc",
            "--device_feature_params", '{"d": false, "dd": false}',
            "--platform", "cpu",
        ])
        assert rc == 0
        return h5, run, str(root / "corpus")

    def test_train_records_feature_chain(self, raw_run):
        import json
        import os

        _h5, run, _corpus = raw_run
        with open(os.path.join(run, "meta.json")) as f:
            hp = json.load(f)["hparams"]
        assert hp["device_features"] == "mfcc"
        assert hp["num_feats"] == 13   # mfcc, no deltas

    def test_eval_uses_recorded_featurizer(self, raw_run, capsys):
        import json

        from asr_study_tpu.cli.eval import main as eval_main

        h5, run, _corpus = raw_run
        rc = eval_main([
            "--dataset", h5, "--split", "test", "--save", run,
            "--platform", "cpu",
        ])
        assert rc == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["num_utts"] > 0 and np.isfinite(out["loss"])

    def test_eval_rejects_feature_dataset(self, raw_run, tmp_path):
        from asr_study_tpu.cli.eval import main as eval_main
        from asr_study_tpu.cli.make_dataset import main as make_main

        _h5, run, corpus = raw_run
        mfcc_h5 = str(tmp_path / "mfcc.h5")
        rc = make_main([
            "--parser", "dummy", "--dataset_dir", corpus,
            "--output", mfcc_h5, "--input_parser", "mfcc",
        ])
        assert rc == 0
        with pytest.raises(SystemExit, match="raw-waveform"):
            eval_main([
                "--dataset", mfcc_h5, "--split", "test", "--save", run,
                "--platform", "cpu",
            ])

    def test_predict_defaults_to_recorded_features(self, raw_run, capsys):
        import glob
        import json

        from asr_study_tpu.cli.predict import main as predict_main

        _h5, run, corpus = raw_run
        wav = sorted(glob.glob(corpus + "/*.wav"))[0]
        rc = predict_main(["--save", run, "--platform", "cpu", wav])
        assert rc == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        # the recorded no-deltas chain yields 13-dim features, matching
        # the 13-input model — with the CLI's mfcc DEFAULTS (39 dims)
        # this apply would raise a shape error instead
        assert "transcript" in out

    def test_train_rejects_feature_dataset(self, raw_run, tmp_path):
        from asr_study_tpu.cli.make_dataset import main as make_main
        from asr_study_tpu.cli.train import main as train_main

        _h5, _run, corpus = raw_run
        mfcc_h5 = str(tmp_path / "mfcc2.h5")
        rc = make_main([
            "--parser", "dummy", "--dataset_dir", corpus,
            "--output", mfcc_h5, "--input_parser", "mfcc",
        ])
        assert rc == 0
        with pytest.raises(SystemExit, match="raw-waveform"):
            train_main([
                "--dataset", mfcc_h5, "--epochs", "1",
                "--batch_size", "4", "--num_devices", "1",
                "--save", str(tmp_path / "r"),
                "--device_features", "mfcc", "--platform", "cpu",
            ])

    def test_predict_explicit_parser_drops_recorded_params(self, raw_run,
                                                           capsys):
        """An explicit --input_parser wins over the recorded chain, and
        the recorded device_feature_params must NOT ride along (they
        belong to the recorded parser).  Explicit parser + explicit
        params reproduces the 13-dim chain and decodes fine."""
        import glob
        import json

        from asr_study_tpu.cli.predict import main as predict_main

        _h5, run, corpus = raw_run
        wav = sorted(glob.glob(corpus + "/*.wav"))[0]
        rc = predict_main([
            "--save", run, "--platform", "cpu",
            "--input_parser", "mfcc",
            "--input_params", '{"d": false, "dd": false}', wav,
        ])
        assert rc == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert "transcript" in out

    def test_eval_data_parallel_matches_single(self, raw_run, capsys):
        """The featurizer runs INSIDE eval's shard_map under --num_devices;
        sharded metrics must match the single-device run."""
        import json

        from asr_study_tpu.cli.eval import main as eval_main

        h5, run, _corpus = raw_run
        argv = ["--dataset", h5, "--split", "test", "--save", run,
                "--platform", "cpu", "--batch_size", "8"]
        assert eval_main(argv) == 0
        single = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1]
        )
        assert eval_main(argv + ["--num_devices", "2"]) == 0
        dp = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert dp["num_utts"] == single["num_utts"]
        assert abs(dp["loss"] - single["loss"]) < 1e-3
        assert dp["cer"] == single["cer"]


class TestFeaturizerWithTP:
    def test_dp_tp_mesh_train_step(self):
        """The in-step featurizer composes with the 2-D (data, model)
        tensor-parallel mesh: features are computed per data-shard and the
        TP recurrence consumes them unchanged."""
        assert len(jax.devices()) >= 4
        from asr_study_tpu.train.trainer import make_mesh

        feat = DeviceFeaturizer(kind="mfcc", d=False, dd=False)
        model = build_model("deep_blstm",
                            {"num_hiddens": 8, "num_layers": 1},
                            num_classes=4)
        tx = make_optimizer("adam", 5e-3, clipnorm=10.0)
        mesh = make_mesh(2, model_devices=2)
        tr = Trainer(model, tx, mesh=mesh, donate_state=False,
                     featurizer=feat)
        state = tr.init_state(jax.random.PRNGKey(0),
                              input_dim=feat.num_feats)
        wavs = jax.random.normal(jax.random.PRNGKey(1), (4, 4096)) * 0.1
        lens = jnp.full((4,), 4096, jnp.int32)
        labels = jax.random.randint(jax.random.PRNGKey(2), (4, 3), 0, 4)
        llens = jnp.full((4,), 3, jnp.int32)
        state, m = tr.train_step(
            state, wavs[..., None], lens, labels, llens,
            jnp.ones((4,), jnp.float32), jax.random.PRNGKey(3),
        )
        assert np.isfinite(float(m["loss"]))
        assert int(state.step) == 1
