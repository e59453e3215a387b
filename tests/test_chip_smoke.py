"""chip_smoke.py on the CPU: it must refuse to run without a GPU (non-zero
exit, no ``ok`` line), and its phases and parity comparisons are
rehearsed here at tiny sizes, CPU against CPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import jax

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *args, cwd=REPO):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script, *args], capture_output=True, text=True,
        timeout=300, env=env, cwd=cwd,
    )


def _assert_refused(out):
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_exits_nonzero_without_a_gpu():
    out = _run(os.path.join(REPO, "chip_smoke.py"))
    _assert_refused(out)
    assert out.stdout == ""
    assert "needs a GPU" in out.stderr


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    _assert_refused(_run(str(tmp_path / "chip_smoke.py"), cwd=tmp_path))


def test_rejects_unknown_arguments():
    out = _run(os.path.join(REPO, "chip_smoke.py"), "--four-card")
    _assert_refused(out)
    assert "unknown arguments" in out.stderr


# -- parity comparisons, CPU against CPU at tiny shapes -----------------------

def _cpu():
    return jax.devices("cpu")[0]


def test_parity_featurizer():
    r = cs.parity_featurizer(_cpu(), batch=2, frames=40)
    assert r["shape"] == [2, 40, 39]
    assert r["log_floor"]["max_abs"] < 2e-3


def test_parity_forward():
    r = cs.parity_forward(_cpu(), _cpu(), batch=2, frames=16, feats=5,
                          hidden=8, layers=1)
    assert r["highest_rel_max"] < 1e-4
    assert r["frames_compared"] > 0


def test_parity_ctc():
    r = cs.parity_ctc(_cpu(), _cpu(), batch=2, frames=20, labels=4,
                      vocab=5)
    assert r["optax_loss_rel"] < 1e-5 and r["optax_grad_rel"] < 1e-5
    assert r["scan_ref_grad_rel"] == 0.0


def test_parity_decode():
    r = cs.parity_decode(_cpu(), _cpu(), batch=2, frames=20, vocab=5,
                         beam=4)
    assert r == {"greedy": "identical", "beam4": "identical"}


def test_parity_dpack():
    r = cs.parity_dpack(_cpu(), batch=2, seconds=(0.2, 0.5))
    assert r["bit_exact"]


# -- the main-path phases, shrunk ---------------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """make_datasets + train_runs on a 40-utterance corpus and a 1 x 16
    model, batch 8 (4 steps per epoch); the sizes stay shrunk for every
    test of this module."""
    saved = (cs.N_UTTS, cs.BATCH, cs.MODEL_PARAMS)
    cs.N_UTTS, cs.BATCH, cs.MODEL_PARAMS = 40, 8, "num_hiddens=16,num_layers=1"
    wd = str(tmp_path_factory.mktemp("smoke"))
    try:
        made = cs.make_datasets(wd)
        trained = cs.train_runs(wd)
        yield wd, made, trained
    finally:
        cs.N_UTTS, cs.BATCH, cs.MODEL_PARAMS = saved


def test_train_phase(trained):
    _, made, r = trained
    assert made["train_utts"] == 32
    assert r["resumed_to_step"] == 12
    assert [s for s, _ in r["f32_epoch_losses"]] == [4, 8]
    assert json.dumps(r)          # the phase line must serialize


def test_eval_phase(trained):
    wd, _, _ = trained
    r = cs.eval_runs(wd)
    assert set(r) == {"greedy", "beam16", "beam16_lm"}
    assert all(v["num_utts"] == 4 for v in r.values())


def test_predict_phase(trained):
    wd, _, _ = trained
    r = cs.predict_runs(wd)
    assert set(r) == {"host", "on_device", "stream"}
    assert all(len(v) == 4 for v in r.values())


def test_raw_training_phase(trained):
    wd, _, _ = trained
    r = cs.raw_training(wd)
    assert r["steps"] == 4


def test_four_cards_path_on_the_virtual_mesh(trained, tmp_path, capsys,
                                             monkeypatch):
    """--four-cards' comparisons on four of the suite's virtual CPU
    devices: 4-way DP and a 2x2 TP run against one device, eval on 4.
    Two layers, so the model has dropout, which the comparison turns off
    (each card draws its own masks)."""
    monkeypatch.setattr(cs, "MODEL_PARAMS", "num_hiddens=16,num_layers=2")
    cs.four_cards(str(tmp_path), cs.Phases("cpu", "virtual mesh"))
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith('{"phase"')]
    assert [l["phase"] for l in lines] == [
        "make_dataset", "train_1", "train_dp4_vs_1", "train_tp2x2_vs_1",
        "eval_4_vs_1",
    ]
    assert lines[2]["result"]["loss_rel_max"] < 1e-5
    assert lines[3]["result"]["loss_rel_max"] < 1e-5
