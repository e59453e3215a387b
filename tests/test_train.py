"""Training subsystem: jitted step, DP mesh parity, checkpoint/resume,
dummy-corpus end-to-end (SURVEY.md §4 integration + distributed strategy)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr_study_tpu.data.corpora import Dummy
from asr_study_tpu.data.generator import DatasetGenerator
from asr_study_tpu.features.audio import MFCC
from asr_study_tpu.models.zoo import build_model
from asr_study_tpu.text.parser import CharParser
from asr_study_tpu.train.checkpoint import CheckpointManager
from asr_study_tpu.train.loop import fit
from asr_study_tpu.train.trainer import Trainer, make_mesh, make_optimizer


def _toy_batch(key, batch=8, t=12, feats=5, l=3, num_classes=4):
    k1, k2 = jax.random.split(key)
    return dict(
        inputs=jax.random.normal(k1, (batch, t, feats)),
        input_lengths=jnp.full((batch,), t, jnp.int32),
        labels=jax.random.randint(k2, (batch, l), 0, num_classes),
        label_lengths=jnp.full((batch,), l, jnp.int32),
        weights=jnp.ones((batch,), jnp.float32),
    )


def _toy_trainer(mesh=None, num_classes=4, hidden=8, donate=True):
    model = build_model(
        "graves2006", {"num_hiddens": hidden}, num_classes=num_classes
    )
    tx = make_optimizer("adam", 5e-3, clipnorm=10.0)
    return model, Trainer(model, tx, mesh=mesh, donate_state=donate)


class TestTrainStep:
    def test_loss_decreases_on_fixed_batch(self):
        _, trainer = _toy_trainer()
        state = trainer.init_state(jax.random.PRNGKey(0), input_dim=5)
        b = _toy_batch(jax.random.PRNGKey(1))
        rng = jax.random.PRNGKey(2)
        losses = []
        for _ in range(30):
            state, m = trainer.train_step(
                state, b["inputs"], b["input_lengths"], b["labels"],
                b["label_lengths"], b["weights"], rng,
            )
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0] * 0.7, losses[::10]
        assert int(state.step) == 30

    def test_bf16_mixed_precision(self):
        model = build_model(
            "graves2006", {"num_hiddens": 8}, num_classes=4
        )
        tx = make_optimizer("adam", 5e-3, clipnorm=10.0)
        t32 = Trainer(model, tx, donate_state=False)
        t16 = Trainer(
            model, tx, donate_state=False, compute_dtype=jnp.bfloat16
        )
        state = t32.init_state(jax.random.PRNGKey(0), input_dim=5)
        b = _toy_batch(jax.random.PRNGKey(1))
        rng = jax.random.PRNGKey(2)
        args = (
            b["inputs"], b["input_lengths"], b["labels"],
            b["label_lengths"], b["weights"], rng,
        )
        s32, m32 = t32.train_step(state, *args)
        s16, m16 = t16.train_step(state, *args)
        # bf16 forward should be close to f32 (not exact), grads finite,
        # and master params stay f32
        assert abs(float(m32["loss"]) - float(m16["loss"])) < 0.5
        for leaf in jax.tree_util.tree_leaves(s16.params):
            assert leaf.dtype == jnp.float32
            assert np.all(np.isfinite(np.asarray(leaf)))

    def test_padded_rows_do_not_affect_loss(self):
        # donate_state=False: the same state is fed to two train_step calls
        _, trainer = _toy_trainer(donate=False)
        state = trainer.init_state(jax.random.PRNGKey(0), input_dim=5)
        b = _toy_batch(jax.random.PRNGKey(1))
        w_half = b["weights"].at[4:].set(0.0)
        # corrupt the zero-weighted rows; loss must not change
        bad_inputs = b["inputs"].at[4:].set(999.0)
        _, m1 = trainer.train_step(
            state, b["inputs"], b["input_lengths"], b["labels"],
            b["label_lengths"], w_half, jax.random.PRNGKey(2),
        )
        _, m2 = trainer.train_step(
            state, bad_inputs, b["input_lengths"], b["labels"],
            b["label_lengths"], w_half, jax.random.PRNGKey(2),
        )
        np.testing.assert_allclose(
            float(m1["loss"]), float(m2["loss"]), rtol=1e-5
        )


class TestDataParallel:
    def test_mesh_matches_single_device(self):
        assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
        b = _toy_batch(jax.random.PRNGKey(1))
        rng = jax.random.PRNGKey(2)

        _, t_single = _toy_trainer(mesh=None)
        s_single = t_single.init_state(jax.random.PRNGKey(0), input_dim=5)
        s1, m1 = t_single.train_step(
            s_single, b["inputs"], b["input_lengths"], b["labels"],
            b["label_lengths"], b["weights"], rng,
        )

        mesh = make_mesh(8)
        _, t_dp = _toy_trainer(mesh=mesh)
        s_dp = t_dp.init_state(jax.random.PRNGKey(0), input_dim=5)
        s8, m8 = t_dp.train_step(
            s_dp, b["inputs"], b["input_lengths"], b["labels"],
            b["label_lengths"], b["weights"], rng,
        )
        np.testing.assert_allclose(
            float(m1["loss"]), float(m8["loss"]), rtol=1e-5
        )
        flat1 = jax.tree_util.tree_leaves(s1.params)
        flat8 = jax.tree_util.tree_leaves(s8.params)
        for a, c in zip(flat1, flat8):
            np.testing.assert_allclose(a, c, rtol=1e-4, atol=1e-5)

    def test_mesh_ragged_weights_match_single_device(self):
        """Zero-weight padding rows landing unevenly across shards: the
        psum'd weighted-sum/weight-sum formulation must reproduce the
        single-device weighted mean exactly (a per-shard mean-of-means
        would not)."""
        b = _toy_batch(jax.random.PRNGKey(1))
        # 5 real rows: shards 0-4 get one real row each, shards 5-7 only
        # padding — weight sums differ per shard.
        w = jnp.asarray([1, 1, 1, 1, 1, 0, 0, 0], jnp.float32)
        rng = jax.random.PRNGKey(2)

        _, t_single = _toy_trainer(mesh=None)
        s_single = t_single.init_state(jax.random.PRNGKey(0), input_dim=5)
        s1, m1 = t_single.train_step(
            s_single, b["inputs"], b["input_lengths"], b["labels"],
            b["label_lengths"], w, rng,
        )

        mesh = make_mesh(8)
        _, t_dp = _toy_trainer(mesh=mesh)
        s_dp = t_dp.init_state(jax.random.PRNGKey(0), input_dim=5)
        s8, m8 = t_dp.train_step(
            s_dp, b["inputs"], b["input_lengths"], b["labels"],
            b["label_lengths"], w, rng,
        )
        np.testing.assert_allclose(
            float(m1["loss"]), float(m8["loss"]), rtol=1e-5
        )
        for a, c in zip(
            jax.tree_util.tree_leaves(s1.params),
            jax.tree_util.tree_leaves(s8.params),
        ):
            np.testing.assert_allclose(a, c, rtol=1e-4, atol=1e-5)

    def test_eval_step_on_mesh(self):
        mesh = make_mesh(8)
        _, trainer = _toy_trainer(mesh=mesh)
        state = trainer.init_state(jax.random.PRNGKey(0), input_dim=5)
        b = _toy_batch(jax.random.PRNGKey(1))
        out = trainer.eval_step(
            state, b["inputs"], b["input_lengths"], b["labels"],
            b["label_lengths"], b["weights"],
        )
        assert np.isfinite(float(out["loss"]))
        assert float(out["num_seqs"]) == 8


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        _, trainer = _toy_trainer()
        state = trainer.init_state(jax.random.PRNGKey(0), input_dim=5)
        b = _toy_batch(jax.random.PRNGKey(1))
        state, _ = trainer.train_step(
            state, b["inputs"], b["input_lengths"], b["labels"],
            b["label_lengths"], b["weights"], jax.random.PRNGKey(2),
        )
        mgr = CheckpointManager(str(tmp_path / "run"))
        mgr.save(state, metrics={"val_loss": 1.5}, hparams={"model": "toy"})

        fresh = trainer.init_state(jax.random.PRNGKey(99), input_dim=5)
        restored = mgr.restore(fresh)
        assert int(restored.step) == 1
        for a, c in zip(
            jax.tree_util.tree_leaves(state.params),
            jax.tree_util.tree_leaves(restored.params),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
        meta = json.load(open(tmp_path / "run" / "meta.json"))
        assert meta["hparams"]["model"] == "toy"
        assert meta["history"][0]["val_loss"] == 1.5

    def test_resume_trajectory_matches_uninterrupted(self, tmp_path):
        """Crash-resume parity: 3 steps -> checkpoint -> (simulated crash)
        restore in a FRESH trainer -> 3 more steps must land bit-identical
        to 6 uninterrupted steps.  This is the guarantee behind
        ``train.py --resume auto`` (SURVEY.md §5.3/§5.4): recovery replays
        the exact trajectory, not merely a nearby one."""
        def steps(trainer, state, n, key):
            b = _toy_batch(jax.random.PRNGKey(1))
            loss = None
            for _ in range(n):
                state, m = trainer.train_step(
                    state, b["inputs"], b["input_lengths"], b["labels"],
                    b["label_lengths"], b["weights"], key,
                )
                loss = float(m["loss"])
            return state, loss

        key = jax.random.PRNGKey(2)
        _, trainer_a = _toy_trainer()
        straight = trainer_a.init_state(jax.random.PRNGKey(0), input_dim=5)
        straight, loss_straight = steps(trainer_a, straight, 6, key)

        _, trainer_b = _toy_trainer()
        part = trainer_b.init_state(jax.random.PRNGKey(0), input_dim=5)
        part, _ = steps(trainer_b, part, 3, key)
        mgr = CheckpointManager(str(tmp_path / "run"))
        mgr.save(part, metrics={"val_loss": 9.9})

        # "crash": everything below uses fresh objects + the checkpoint
        _, trainer_c = _toy_trainer()
        blank = trainer_c.init_state(jax.random.PRNGKey(7), input_dim=5)
        resumed = CheckpointManager(str(tmp_path / "run")).restore(blank)
        assert int(resumed.step) == 3
        resumed, loss_resumed = steps(trainer_c, resumed, 3, key)

        assert int(resumed.step) == int(straight.step) == 6
        assert loss_resumed == loss_straight
        for a, c in zip(
            jax.tree_util.tree_leaves(straight.params),
            jax.tree_util.tree_leaves(resumed.params),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
        for a, c in zip(
            jax.tree_util.tree_leaves(straight.opt_state),
            jax.tree_util.tree_leaves(resumed.opt_state),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(c))

    def test_cross_topology_resume(self, tmp_path):
        """Full TrainState resume across DEVICE TOPOLOGIES (VERDICT r2
        weak #8): save under an 8-device DP mesh, restore and continue on
        1 device — and the reverse — matching the uninterrupted
        trajectory.  DP steps are bit-comparable to single-device steps by
        design (weighted-sum psum), so the trajectories must agree."""
        def steps(trainer, state, n, key):
            b = _toy_batch(jax.random.PRNGKey(1))
            args_fn = lambda v: (  # shard batch fields onto the mesh
                jax.device_put(v, trainer.batch_sharding)
                if trainer.batch_sharding is not None else v
            )
            loss = None
            for _ in range(n):
                state, m = trainer.train_step(
                    state, args_fn(b["inputs"]), args_fn(b["input_lengths"]),
                    args_fn(b["labels"]), args_fn(b["label_lengths"]),
                    args_fn(b["weights"]), key,
                )
                loss = float(m["loss"])
            return state, loss

        key = jax.random.PRNGKey(2)
        _, straight_tr = _toy_trainer(donate=False)
        straight = straight_tr.init_state(jax.random.PRNGKey(0), input_dim=5)
        straight, loss_straight = steps(straight_tr, straight, 4, key)

        for first_mesh in (True, False):
            mesh = make_mesh(8)
            _, tr_a = _toy_trainer(mesh=mesh if first_mesh else None,
                                   donate=False)
            part = tr_a.init_state(jax.random.PRNGKey(0), input_dim=5)
            part, _ = steps(tr_a, part, 2, key)
            run = str(tmp_path / f"run_{first_mesh}")
            mgr = CheckpointManager(run)
            mgr.save(part, metrics={"val_loss": 1.0})

            # resume on the OTHER topology
            _, tr_b = _toy_trainer(mesh=None if first_mesh else mesh,
                                   donate=False)
            blank = tr_b.init_state(jax.random.PRNGKey(7), input_dim=5)
            resumed = CheckpointManager(run).restore(blank)
            assert int(resumed.step) == 2
            resumed, loss_resumed = steps(tr_b, resumed, 2, key)
            assert int(resumed.step) == 4
            np.testing.assert_allclose(
                loss_resumed, loss_straight, rtol=1e-5,
                err_msg=f"mesh_first={first_mesh}",
            )
            for a, c in zip(
                jax.tree_util.tree_leaves(straight.params),
                jax.tree_util.tree_leaves(resumed.params),
            ):
                np.testing.assert_allclose(
                    np.asarray(a), np.asarray(c), rtol=1e-5, atol=1e-7
                )

    def test_restore_params_warm_start(self, tmp_path):
        """restore_params loads ONLY the weights (for --init_from): a
        fresh optimizer/step, and it works regardless of the checkpoint's
        optimizer structure; shape mismatches fail loudly."""
        _, trainer = _toy_trainer()
        state = trainer.init_state(jax.random.PRNGKey(0), input_dim=5)
        b = _toy_batch(jax.random.PRNGKey(1))
        state, _ = trainer.train_step(
            state, b["inputs"], b["input_lengths"], b["labels"],
            b["label_lengths"], b["weights"], jax.random.PRNGKey(2),
        )
        mgr = CheckpointManager(str(tmp_path / "run"))
        mgr.save(state, metrics={"val_loss": 1.5})

        src = CheckpointManager(str(tmp_path / "run"))
        fresh = trainer.init_state(jax.random.PRNGKey(99), input_dim=5)
        warm = src.restore_params(fresh.params, best=True)
        for a, c in zip(
            jax.tree_util.tree_leaves(state.params),
            jax.tree_util.tree_leaves(warm),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(c))

        other = trainer.init_state(jax.random.PRNGKey(0), input_dim=7)
        with pytest.raises(ValueError, match="shape mismatch"):
            src.restore_params(other.params)


class TestProfileFlag:
    def test_profiler_trace_written(self, tmp_path):
        """fit(profile=True) captures a jax.profiler trace without crashing
        (SURVEY.md §5.1 — the tracing hook the reference never had)."""
        from asr_study_tpu.data.generator import DatasetGenerator

        _, trainer = _toy_trainer()
        state = trainer.init_state(jax.random.PRNGKey(0), input_dim=5)
        rng = np.random.RandomState(0)
        feats = [rng.randn(12, 5).astype(np.float32) for _ in range(8)]
        labels = [rng.randint(0, 4, size=3).astype(np.int32) for _ in range(8)]
        gen = DatasetGenerator(batch_size=4, min_time=12, time_multiple=4)
        it = gen.flow(feats, labels)
        from asr_study_tpu.train.loop import fit

        fit(
            trainer, state, it, epochs=8, log_dir=str(tmp_path),
            profile=True, profile_steps=(2, 4), log_every=100,
        )
        trace_dir = tmp_path / "trace"
        assert trace_dir.exists()
        assert any(trace_dir.rglob("*"))


class TestCheckpointRetention:
    def test_latest_survives_worse_metrics(self, tmp_path):
        """Regression: a best_fn-managed single store deletes newer-but-
        worse checkpoints, silently breaking resume-from-latest (observed:
        150-epoch run resumed at step 96)."""
        _, trainer = _toy_trainer(donate=False)
        state = trainer.init_state(jax.random.PRNGKey(0), input_dim=5)
        b = _toy_batch(jax.random.PRNGKey(1))
        mgr = CheckpointManager(str(tmp_path / "run"), max_to_keep=2)
        # val_loss IMPROVES then WORSENS: best is step 2, latest must be 4
        vals = [3.0, 1.0, 2.5, 4.0]
        for v in vals:
            state, _ = trainer.train_step(
                state, b["inputs"], b["input_lengths"], b["labels"],
                b["label_lengths"], b["weights"], jax.random.PRNGKey(2),
            )
            mgr.save(state, metrics={"val_loss": v})
        assert mgr.latest_step == 4
        assert mgr.best_step == 2
        fresh = trainer.init_state(jax.random.PRNGKey(9), input_dim=5)
        assert int(mgr.restore(fresh).step) == 4
        assert int(mgr.restore(fresh, best=True).step) == 2


    def test_best_metric_val_ler(self, tmp_path):
        """CheckpointManager(best_metric='val_ler') retains the lowest-LER
        step even when val_loss says otherwise (train.py --monitor)."""
        _, trainer = _toy_trainer(donate=False)
        state = trainer.init_state(jax.random.PRNGKey(0), input_dim=5)
        b = _toy_batch(jax.random.PRNGKey(1))
        mgr = CheckpointManager(str(tmp_path / "run"), max_to_keep=2,
                                best_metric="val_ler")
        # loss keeps improving but LER bottoms out at step 2
        metrics = [(3.0, 0.9), (2.0, 0.4), (1.0, 0.7), (0.5, 0.8)]
        for loss, ler in metrics:
            state, _ = trainer.train_step(
                state, b["inputs"], b["input_lengths"], b["labels"],
                b["label_lengths"], b["weights"], jax.random.PRNGKey(2),
            )
            mgr.save(state, metrics={"val_loss": loss, "val_ler": ler})
        assert mgr.latest_step == 4
        assert mgr.best_step == 2


@pytest.mark.slow
class TestEndToEnd:
    def test_dummy_corpus_pipeline(self, tmp_path):
        """make-dataset -> train -> loss drops -> eval decodes
        (the reference's dummy-corpus smoke role [ref: datasets/dummy.py])."""
        corpus = Dummy(str(tmp_path / "corpus"), n=8)
        h5 = str(tmp_path / "data.h5")
        label_parser = CharParser()
        # Dummy assigns its own round-robin splits (train/valid/test)
        counts = corpus.to_h5(h5, MFCC(), label_parser)
        assert counts["train"] >= 4

        gen = DatasetGenerator(batch_size=8)
        it = gen.flow_from_h5(h5, "train")
        model = build_model(
            "graves2006", {"num_hiddens": 16},
            num_classes=label_parser.num_classes,
        )
        trainer = Trainer(model, make_optimizer("adam", 5e-3, 10.0))
        state = trainer.init_state(jax.random.PRNGKey(0), it.num_feats)
        ckpt = CheckpointManager(str(tmp_path / "run"))
        state = fit(
            trainer, state, it, valid_iter=it, epochs=6, ckpt=ckpt,
            hparams={"model": "graves2006"}, log_dir=str(tmp_path / "run"),
        )
        hist = ckpt.meta["history"]
        assert hist[-1]["val_loss"] < hist[0]["val_loss"]
        # eval path produces strings
        res = trainer.run_eval(state, it.epoch())
        assert 0.0 <= res["ler"]
        assert os.path.exists(tmp_path / "run" / "train_metrics.csv")

    def test_packed_lazy_training_matches_vlen(self, tmp_path):
        """Training over a packed-layout lazy stream is bit-identical to
        in-memory vlen training (same loss trajectory): the layout is an
        IO detail, not a numerics one."""
        corpus = Dummy(str(tmp_path / "corpus"), n=8)
        label_parser = CharParser()
        vlen_h5 = str(tmp_path / "vlen.h5")
        packed_h5 = str(tmp_path / "packed.h5")
        corpus.to_h5(vlen_h5, MFCC(), label_parser)
        corpus.to_h5(packed_h5, MFCC(), label_parser, layout="packed")

        def losses(h5, lazy):
            gen = DatasetGenerator(batch_size=4, shuffle=False)
            it = gen.flow_from_h5(h5, "train", lazy=lazy)
            model = build_model(
                "graves2006", {"num_hiddens": 16},
                num_classes=label_parser.num_classes,
            )
            trainer = Trainer(model, make_optimizer("adam", 5e-3, 10.0),
                              donate_state=False)
            state = trainer.init_state(jax.random.PRNGKey(0), it.num_feats)
            out = []
            for ep in range(2):
                for b in it.epoch(seed=ep):
                    state, m = trainer.train_step(
                        state, jnp.asarray(b.inputs),
                        jnp.asarray(b.input_lengths),
                        jnp.asarray(b.labels),
                        jnp.asarray(b.label_lengths),
                        jnp.asarray(b.weights), jax.random.PRNGKey(ep),
                    )
                    out.append(float(m["loss"]))
            return out

        # packed files are duration-sorted on disk, but the generator
        # duration-sorts every flow, so batch composition is identical
        assert losses(packed_h5, lazy=True) == losses(vlen_h5, lazy=False)

    def test_train_cli_dp_tp(self, tmp_path):
        """train.py --num_devices 2 --tp_devices 2 runs end to end on the
        virtual mesh (DP x tensor-parallel recurrence)."""
        from asr_study_tpu.cli.train import main as train_main

        corpus = Dummy(str(tmp_path / "corpus"), n=8)
        h5 = str(tmp_path / "data.h5")
        corpus.to_h5(h5, MFCC(), CharParser())
        rc = train_main([
            "--platform", "cpu", "--dataset", h5,
            "--model", "deep_blstm", "--params", "num_hiddens=8,num_layers=1",
            "--epochs", "2", "--batch_size", "4",
            "--num_devices", "2", "--tp_devices", "2",
            "--save", str(tmp_path / "run_tp"), "--log_every", "1",
        ])
        assert rc == 0
        meta = json.load(open(tmp_path / "run_tp" / "meta.json"))
        assert meta["hparams"]["tp_devices"] == 2
        assert len(meta["history"]) == 2

        # checkpoints from a mesh run must restore on a DIFFERENT device
        # set: eval in a fresh single-device process (a target-less orbax
        # restore used to replay the saved 4-device sharding and fail)
        import subprocess
        import sys as _sys

        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        out = subprocess.run(
            [_sys.executable, os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "eval.py"),
             "--platform", "cpu", "--dataset", h5, "--split", "test",
             "--save", str(tmp_path / "run_tp")],
            capture_output=True, text=True, timeout=560, env=env,
        )
        assert out.returncode == 0, out.stderr[-2000:]
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        assert np.isfinite(rec["loss"])


def test_grad_accumulation_matches_big_batch():
    """accum_steps=2 over two equal fully-weighted micro-batches lands on
    the same parameters as one optimizer step on the combined batch: the
    per-micro weighted-mean gradients average to the big-batch mean."""
    model = build_model(
        "graves2006", {"num_hiddens": 8}, num_classes=4
    )
    big = _toy_batch(jax.random.PRNGKey(7), batch=8)

    def half(i):
        return {k: v[4 * i: 4 * (i + 1)] for k, v in big.items()}

    def run(accum, batches):
        tx = make_optimizer("adam", 5e-3, clipnorm=10.0, accum_steps=accum)
        trainer = Trainer(model, tx, donate_state=False)
        state = trainer.init_state(jax.random.PRNGKey(0), input_dim=5)
        for b in batches:
            state, _ = trainer.train_step(
                state, b["inputs"], b["input_lengths"], b["labels"],
                b["label_lengths"], b["weights"], jax.random.PRNGKey(0),
            )
        return state.params

    p_accum = run(2, [half(0), half(1)])
    p_big = run(1, [big])
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, atol=2e-6),
        p_accum, p_big,
    )


def test_grad_accumulation_under_dp_mesh():
    """MultiSteps composes with the shard_map DP step: two accumulated
    micro-batches on a 2-device mesh match the single-device big batch."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    model = build_model("graves2006", {"num_hiddens": 8}, num_classes=4)
    big = _toy_batch(jax.random.PRNGKey(11), batch=8)

    def half(i):
        return {k: v[4 * i: 4 * (i + 1)] for k, v in big.items()}

    def run(mesh, accum, batches):
        tx = make_optimizer("adam", 5e-3, clipnorm=10.0, accum_steps=accum)
        trainer = Trainer(model, tx, mesh=mesh, donate_state=False)
        state = trainer.init_state(jax.random.PRNGKey(0), input_dim=5)
        for b in batches:
            state, _ = trainer.train_step(
                state, b["inputs"], b["input_lengths"], b["labels"],
                b["label_lengths"], b["weights"], jax.random.PRNGKey(0),
            )
        return state.params

    p_dp = run(make_mesh(2), 2, [half(0), half(1)])
    p_ref = run(None, 1, [big])
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=1e-4
        ),
        p_dp, p_ref,
    )


def test_make_optimizer_rejects_bad_accum():
    with pytest.raises(ValueError, match="accum_steps"):
        make_optimizer("adam", accum_steps=0)


def test_reduce_on_plateau_scales_updates():
    """plateau_factor halves the update once the windowed loss has been
    stale for plateau_patience windows (Keras ReduceLROnPlateau idiom);
    the trainer feeds the loss via update(..., value=...)."""
    import optax

    tx = make_optimizer("adam", lr=1.0, clipnorm=0.0,
                        plateau_factor=0.5, plateau_patience=2,
                        plateau_window=1)
    tx = optax.with_extra_args_support(tx)
    params = {"w": jnp.zeros((3,))}
    grads = {"w": jnp.ones((3,))}
    st = tx.init(params)
    mags = []
    for _ in range(8):
        upd, st = tx.update(grads, st, params, value=jnp.float32(1.0))
        mags.append(float(-upd["w"][0]))
    # adam's bias-corrected magnitude for a constant grad is the LR; the
    # constant (never-improving) loss must have triggered >= one halving
    assert mags[0] == pytest.approx(1.0, rel=1e-3)
    assert mags[-1] <= 0.5 * mags[0] + 1e-6
    # an improving loss never triggers
    tx2 = optax.with_extra_args_support(make_optimizer(
        "adam", lr=1.0, clipnorm=0.0,
        plateau_factor=0.5, plateau_patience=2, plateau_window=1,
    ))
    st2 = tx2.init(params)
    for i in range(8):
        upd, st2 = tx2.update(grads, st2, params,
                              value=jnp.float32(10.0 - i))
    assert float(-upd["w"][0]) == pytest.approx(1.0, rel=1e-3)


def test_plateau_with_accumulation_composes():
    """reduce_on_plateau inside MultiSteps: extra args flow through and
    the scale still engages on a stale loss."""
    import optax

    tx = optax.with_extra_args_support(make_optimizer(
        "sgd", lr=1.0, clipnorm=0.0, accum_steps=2,
        plateau_factor=0.5, plateau_patience=1, plateau_window=1,
    ))
    params = {"w": jnp.zeros((3,))}
    grads = {"w": jnp.ones((3,))}
    st = tx.init(params)
    mags = []
    for _ in range(12):   # 6 optimizer applies
        upd, st = tx.update(grads, st, params, value=jnp.float32(1.0))
        m = float(-upd["w"][0])
        if m:             # micro-steps emit zero updates
            mags.append(m)
    assert mags[0] == pytest.approx(1.0, rel=1e-3)
    assert mags[-1] < 0.6 * mags[0]


def test_make_optimizer_rejects_bad_plateau():
    with pytest.raises(ValueError, match="plateau_factor"):
        make_optimizer("adam", plateau_factor=1.5, plateau_patience=2)
    with pytest.raises(ValueError, match="plateau_patience"):
        make_optimizer("adam", plateau_factor=0.5)


def test_lr_decay_schedule():
    """make_optimizer(lr_decay, decay_steps) applies staircase decay:
    SGD update magnitude halves after decay_steps optimizer steps."""
    import optax

    from asr_study_tpu.train.trainer import make_optimizer

    # adam's bias-corrected update magnitude for a CONSTANT gradient is
    # exactly the learning rate, which makes the staircase visible
    tx = make_optimizer("adam", lr=1.0, clipnorm=0.0,
                        lr_decay=0.5, decay_steps=2)
    params = {"w": jnp.zeros((3,))}
    grads = {"w": jnp.ones((3,))}
    st = tx.init(params)
    seen = []
    for _ in range(4):
        upd, st = tx.update(grads, st, params)
        seen.append(float(-upd["w"][0]))
        params = optax.apply_updates(params, upd)
    assert seen[0] == pytest.approx(1.0, rel=1e-3)
    assert seen[1] == pytest.approx(1.0, rel=1e-3)
    assert seen[2] == pytest.approx(0.5, rel=1e-3)
    assert seen[3] == pytest.approx(0.5, rel=1e-3)
    with pytest.raises(ValueError, match="lr_decay"):
        make_optimizer("sgd", lr_decay=1.5, decay_steps=2)


def test_early_stopping(tmp_path, capsys):
    """fit() stops once val_loss stops improving for `patience` epochs
    (lr=0 makes every epoch's val_loss identical)."""
    from asr_study_tpu.train.loop import fit
    from asr_study_tpu.train.trainer import make_optimizer

    h5 = str(tmp_path / "d.h5")
    label_parser = CharParser()
    Dummy(str(tmp_path / "corpus"), n=9).to_h5(h5, MFCC(), label_parser)
    gen = DatasetGenerator(batch_size=3)
    train_it = gen.flow_from_h5(h5, "train")
    valid_it = gen.flow_from_h5(h5, "valid")

    model = build_model(
        "graves2006", {"num_hiddens": 8},
        num_classes=label_parser.num_classes,
    )
    from asr_study_tpu.train.trainer import Trainer

    trainer = Trainer(model, make_optimizer("sgd", lr=0.0, clipnorm=0.0))
    state = trainer.init_state(jax.random.PRNGKey(0), train_it.num_feats)
    out = fit(trainer, state, train_it, valid_it, epochs=10,
              early_stop_patience=2)
    # epoch 0 sets best; epochs 1-2 are stale -> stop after 3 epochs
    assert int(out.step) == 3 * train_it.steps_per_epoch
    assert "early stop" in capsys.readouterr().err


class TestSortaGrad:
    """--sortagrad: the FIRST epoch of training runs in ascending-duration
    batch order; later epochs (and resumed runs) shuffle as usual."""

    class _Recording:
        """Delegates to a real DatasetIterator, recording epoch() kwargs."""

        def __init__(self, it):
            self._it = it
            self.ordered_calls = []

        def __getattr__(self, name):
            return getattr(self._it, name)

        def epoch(self, seed=None, ordered=False):
            self.ordered_calls.append(ordered)
            return self._it.epoch(seed=seed, ordered=ordered)

    def _fit(self, state=None, sortagrad=True, epochs=2):
        from asr_study_tpu.data.generator import DatasetGenerator
        from asr_study_tpu.train.loop import fit

        rng = np.random.RandomState(0)
        inputs = [
            rng.randn(8 + 4 * i, 5).astype(np.float32) for i in range(8)
        ]
        labels = [
            rng.randint(0, 4, (2,)).astype(np.int32) for _ in range(8)
        ]
        it = self._Recording(
            DatasetGenerator(batch_size=4).flow(inputs, labels)
        )
        _, trainer = _toy_trainer(donate=False)
        if state is None:
            state = trainer.init_state(jax.random.PRNGKey(0), input_dim=5)
        state = fit(trainer, state, it, epochs=epochs, seed=0,
                    log_every=100, sortagrad=sortagrad)
        return it.ordered_calls, state

    def test_first_epoch_ordered_then_shuffled(self):
        calls, state = self._fit(sortagrad=True)
        assert calls == [True, False]

    def test_off_by_default_and_resume_never_reorders(self):
        calls, state = self._fit(sortagrad=False)
        assert calls == [False, False]
        # resumed run (step > 0): sortagrad must NOT re-order epoch 0
        calls2, _ = self._fit(state=state, sortagrad=True)
        assert calls2 == [False, False]
