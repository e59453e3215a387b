import pytest

from asr_study_tpu.utils import HParams


def test_hparams_defaults():
    hp = HParams(num_hiddens=256, num_layers=3, dropout=0.2, bidirectional=True)
    assert hp.num_hiddens == 256
    assert hp.get("missing", 7) == 7
    with pytest.raises(AttributeError):
        _ = hp.missing


def test_hparams_parse_kv():
    hp = HParams(num_hiddens=256, dropout=0.2, name="blstm", bi=True)
    hp.parse("num_hiddens=512,dropout=0.5,name=gru,bi=false")
    assert hp.num_hiddens == 512
    assert hp.dropout == 0.5
    assert hp.name == "gru"
    assert hp.bi is False


def test_hparams_parse_json():
    hp = HParams(a=1).parse('{"a": 2, "b": "x"}')
    assert hp.a == 2
    assert hp.b == "x"


def test_hparams_roundtrip():
    hp = HParams(a=1, b="x")
    assert HParams.from_dict(hp.to_dict()).a == 1


def test_metric_writer_csv_widening_and_tensorboard(tmp_path):
    """Per-step rows first, epoch-summary keys later: the CSV header must
    widen (not drop the new columns), and tensorboard=True must produce an
    event file alongside."""
    import csv
    import glob

    from asr_study_tpu.utils.metrics_writer import MetricWriter

    w = MetricWriter(str(tmp_path), "train", tensorboard=True)
    w.write(1, {"loss": 2.0})
    w.write(2, {"loss": 1.5, "val_loss": 3.0, "val_ler": 0.9})
    w.close()

    with open(tmp_path / "train_metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert "val_loss" in rows[0]            # widened header
    assert rows[1]["val_loss"] == "3.0"
    events = glob.glob(str(tmp_path / "tb" / "events.*"))
    assert events, "no tensorboard event file written"


def test_choice_env_validates(monkeypatch):
    from asr_study_tpu.utils.env import choice_env

    monkeypatch.delenv("ASR_TEST_KNOB", raising=False)
    assert choice_env("ASR_TEST_KNOB", "auto", ("auto", "scan")) == "auto"
    monkeypatch.setenv("ASR_TEST_KNOB", "scan")
    assert choice_env("ASR_TEST_KNOB", "auto", ("auto", "scan")) == "scan"
    monkeypatch.setenv("ASR_TEST_KNOB", "typo")
    with pytest.raises(ValueError, match="ASR_TEST_KNOB.*auto, scan"):
        choice_env("ASR_TEST_KNOB", "auto", ("auto", "scan"))
