"""On-disk formats that need nothing beyond NumPy: the checkpoint .npz
files (train/checkpoint.py) and the packed dataset directory
(data/dataset_parser.py)."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from asr_study_tpu.data.dataset_parser import (
    dataset_splits, read_h5, read_h5_meta, write_h5,
)
from asr_study_tpu.text.parser import CharParser
from asr_study_tpu.train.checkpoint import CheckpointManager
from asr_study_tpu.train.trainer import TrainState


def _state(step, scale=1.0, dtype=jnp.float32):
    params = {"layer": {"w": jnp.full((3, 2), scale, dtype),
                        "b": jnp.arange(2, dtype=dtype)}}
    opt_state = (jnp.zeros((3, 2), jnp.float32), jnp.int32(step))
    return TrainState(params=params, opt_state=opt_state,
                      step=jnp.int32(step))


def test_checkpoint_files_are_complete_npz(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(_state(step), metrics={"val_loss": 10.0 - step})
    files = sorted(os.listdir(tmp_path / "ckpt"))
    assert files == ["2.npz", "3.npz"]                 # retention
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path / "best"))
    with np.load(tmp_path / "ckpt" / "3.npz") as z:
        assert "['params']['layer']['w']" in z.files
        assert "['opt_state'][1]" in z.files
    best = json.load(open(tmp_path / "best" / "best.json"))
    assert best == {"step": 3, "metric": "val_loss", "value": 7.0}


def test_bf16_leaves_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _state(5, scale=1.5, dtype=jnp.bfloat16)
    mgr.save(state)
    got = mgr.restore(_state(0, dtype=jnp.bfloat16))
    assert int(got.step) == 5
    assert got.params["layer"]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(got.params["layer"]["w"], np.float32), 1.5
    )
    warm = mgr.restore_params(_state(0, dtype=jnp.bfloat16).params)
    assert warm["layer"]["b"].dtype == jnp.bfloat16


def test_best_mode_max(tmp_path):
    mgr = CheckpointManager(str(tmp_path), best_metric="acc", mode="max")
    for step, acc in ((1, 0.2), (2, 0.9), (3, 0.5)):
        mgr.save(_state(step), metrics={"acc": acc})
    assert mgr.best_step == 2 and mgr.latest_step == 3
    assert sorted(os.listdir(tmp_path / "best")) == ["2.npz", "best.json"]
    with pytest.raises(ValueError, match="mode"):
        CheckpointManager(str(tmp_path / "x"), mode="up")


def test_restore_params_rejects_other_tree(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(1))
    other = {"layer": {"v": jnp.zeros((3, 2)), "b": jnp.zeros((2,))}}
    with pytest.raises(ValueError, match="param tree mismatch"):
        mgr.restore_params(other)
    with pytest.raises(ValueError, match="different model or optimizer"):
        mgr.restore(TrainState(params=other, opt_state=(),
                               step=jnp.int32(0)))
    with pytest.raises(FileNotFoundError, match="no BEST"):
        CheckpointManager(str(tmp_path / "empty")).restore_params(
            other, best=True)


class _Feat:
    num_feats = 2

    def __call__(self, path):
        n = int(path[1:])
        return np.arange(2 * n, dtype=np.float32).reshape(n, 2)

    def __str__(self):
        return "fake"


def _rows(n):
    return [{"audio": f"u{i + 1}", "label": "ab", "duration": float(i + 1)}
            for i in range(n)]


def test_packed_store_rewrite_replaces(tmp_path):
    path = str(tmp_path / "d")
    write_h5(path, {"train": _rows(3), "test": _rows(1)}, _Feat(),
             CharParser(), layout="packed")
    assert dataset_splits(path) == ["train", "test"]
    write_h5(path, {"train": _rows(2)}, _Feat(), CharParser(),
             layout="packed")
    assert dataset_splits(path) == ["train"]
    inputs, labels, texts, durs = read_h5(path, "train")
    assert [x.shape for x in inputs] == [(1, 2), (2, 2)]
    assert texts == ["ab", "ab"] and list(durs) == [1.0, 2.0]
    with pytest.raises(KeyError, match="no split 'test'"):
        read_h5_meta(path, "test")


def test_packed_store_refuses_foreign_directory(tmp_path):
    foreign = tmp_path / "mine"
    foreign.mkdir()
    (foreign / "notes.txt").write_text("keep me")
    with pytest.raises(FileExistsError, match="not a packed dataset"):
        write_h5(str(foreign), {"train": _rows(1)}, _Feat(), CharParser(),
                 layout="packed")
    assert (foreign / "notes.txt").read_text() == "keep me"
