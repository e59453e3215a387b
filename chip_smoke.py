#!/usr/bin/env python
"""End-to-end smoke run of the speech pipeline on one NVIDIA GPU.

    python chip_smoke.py               # one card: main path + parity
    python chip_smoke.py --four-cards  # four cards: DP / TP / eval parity

One card: drives the main path through the CLIs' ``main(argv)`` entry
points, in this process and one after another (a JAX process reserves
most of the card's memory, so a child process could not open it):
make_dataset (synthwords corpus, mfcc, packed layout) -> train (f32,
resume, bf16) -> eval (greedy, beam 16, beam 16 + char LM) -> predict
(host features, --on_device, --stream on a unidirectional model) ->
raw-wav training with in-step device features.  The model is the
flagship ``deep_blstm`` at its defaults (3 bidirectional LSTM layers x
256, 27 classes), batch 32, random weights from seed 0.  Then the parity
phase compares the GPU with the CPU backend of the same process at real
widths (B=32, T=512, 39 features): featurizer vs the NumPy oracle,
forward logits at HIGHEST and default (TF32) precision, CTC loss and
gradient vs ``optax.ctc_loss``, greedy and beam-16 transcripts, dpack
decode vs pcm16; the last phase runs the same comparisons at small
shapes as the pytest tests marked ``gpu`` (tests/test_gpu.py).

``--four-cards`` runs only the multi-card path and what it is compared
with: train.py on 4 data-parallel cards vs 1 card, a 2x2 tensor-parallel
run vs 1 card, and eval.py on 4 cards vs 1.

Every phase prints one JSON line (wall time, result, device kind, the
card's name and power limit); any failure ends the run with a non-zero
exit and no ``ok`` line.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Work files go to ``runs/chip_smoke`` under the checkout.
"""

from __future__ import annotations

import contextlib
import csv
import io
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
B, T, F, L = 32, 512, 39, 48       # parity shapes: batch, frames, feats, labels
# main-path sizes: the synthwords corpus (8:1:1 train/valid/test), the
# batch, and --params for deep_blstm ("" = its defaults, 3 x 256); a CPU
# rehearsal shrinks them
N_UTTS = 400
BATCH = 32
MODEL_PARAMS = ""


class Phases:
    """Runs named phases, printing one JSON line each."""

    def __init__(self, device_kind: str, card: str):
        self.device_kind = device_kind
        self.card = card

    def run(self, name: str, fn, *args, **kw):
        t0 = time.perf_counter()
        result = fn(*args, **kw)
        print(json.dumps({
            "phase": name,
            "wall_s": time.perf_counter() - t0,
            "result": result,
            "device_kind": self.device_kind,
            "gpu": self.card,
        }), flush=True)
        return result


def cli(main, argv) -> list:
    """Run a CLI ``main(argv)`` in-process; -> the JSON lines it printed
    on stdout.  Its stderr passes through."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"{main.__module__}.main{argv} returned {rc}")
    return [json.loads(l) for l in buf.getvalue().splitlines()
            if l.startswith("{")]


def logged_losses(run_dir: str, key: str = "loss") -> list:
    """(step, value) rows of a run's train_metrics.csv: per-step "loss"
    rows (every --log_every steps) or per-epoch "train_loss" rows."""
    with open(os.path.join(run_dir, "train_metrics.csv"), newline="") as f:
        return [(int(r["step"]), float(r[key])) for r in csv.DictReader(f)
                if r.get(key)]


def finite(rows) -> bool:
    return bool(rows) and all(v == v and abs(v) < 1e30 for _, v in rows)


def last_step(run_dir: str) -> int:
    with open(os.path.join(run_dir, "meta.json")) as f:
        return int(json.load(f)["last_step"])


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- the main path, through the CLIs -----------------------------------------

def _params(*extra: str) -> list:
    p = ",".join(x for x in (MODEL_PARAMS,) + extra if x)
    return ["--params", p] if p else []


def _steps_per_epoch() -> int:
    return -(-(N_UTTS * 8 // 10) // BATCH)


def _corpus_args(wd: str) -> list:
    return ["--parser", "synthwords",
            "--dataset_dir", os.path.join(wd, "corpus"),
            "--corpus_params", json.dumps({"n": N_UTTS, "seed": 0}),
            "--layout", "packed"]


def make_datasets(wd: str) -> dict:
    from asr_study_tpu.cli.make_dataset import main as make_dataset

    common = _corpus_args(wd)
    cli(make_dataset, common + ["--output", os.path.join(wd, "mfcc"),
                                "--input_parser", "mfcc"])
    cli(make_dataset, common + ["--output", os.path.join(wd, "raw"),
                                "--input_parser", "raw"])
    from asr_study_tpu.data.dataset_parser import read_h5_meta

    shapes = read_h5_meta(os.path.join(wd, "mfcc"), "train")[0]
    check(shapes.shape[0] == N_UTTS * 8 // 10 and int(shapes[0, 1]) == F,
          f"train split {shapes.shape}")
    return {"train_utts": int(shapes.shape[0]),
            "frames_min": int(shapes[:, 0].min()),
            "frames_max": int(shapes[:, 0].max())}


def train_runs(wd: str) -> dict:
    from asr_study_tpu.cli.train import main as train

    data = os.path.join(wd, "mfcc")
    base = ["--dataset", data, "--model", "deep_blstm",
            "--batch_size", str(BATCH), "--log_every", "5", "--seed", "0"]
    base += _params()
    spe = _steps_per_epoch()
    run = os.path.join(wd, "run")
    cli(train, base + ["--epochs", "2", "--save", run])
    losses = logged_losses(run)
    epochs = logged_losses(run, "train_loss")
    check(finite(losses) and finite(epochs), f"non-finite loss {losses}")
    check(epochs[-1][1] < epochs[0][1], f"loss did not fall: {epochs}")
    step_f32 = last_step(run)
    check(step_f32 == 2 * spe, f"f32 run ended at step {step_f32}")

    cli(train, base + ["--epochs", "1", "--save", run, "--resume"])
    step_resumed = last_step(run)
    check(step_resumed == 3 * spe, f"resume ended at step {step_resumed}")
    resumed = [r for r in logged_losses(run, "train_loss") if r[0] > step_f32]
    check(finite(resumed), f"resumed epoch loss {resumed}")

    run_bf16 = os.path.join(wd, "run_bf16")
    cli(train, base + ["--epochs", "1", "--save", run_bf16, "--bf16"])
    bf16 = logged_losses(run_bf16, "train_loss")
    check(finite(bf16), f"bf16 epoch loss {bf16}")
    return {"f32_step_losses": losses, "f32_epoch_losses": epochs,
            "resumed_to_step": step_resumed, "resumed_epoch_losses": resumed,
            "bf16_epoch_losses": bf16}


def eval_runs(wd: str) -> dict:
    from asr_study_tpu.cli.eval import main as evaluate
    from asr_study_tpu.cli.train_lm import main as train_lm

    base = ["--dataset", os.path.join(wd, "mfcc"), "--split", "test",
            "--save", os.path.join(wd, "run"), "--batch_size", str(BATCH)]
    out = {}
    for name, extra in (("greedy", []), ("beam16", ["--beam_width", "16"])):
        r = cli(evaluate, base + extra)[-1]
        check(0.0 <= r["cer"] and r["loss"] == r["loss"], f"{name}: {r}")
        out[name] = {k: r[k] for k in ("cer", "wer", "loss", "num_utts")}
    lm = os.path.join(wd, "lm3.npz")
    cli(train_lm, ["--dataset", os.path.join(wd, "mfcc"),
                   "--splits", "train", "--order", "3", "--output", lm])
    r = cli(evaluate, base + ["--beam_width", "16", "--lm", lm])[-1]
    check(0.0 <= r["cer"], f"beam16+lm: {r}")
    out["beam16_lm"] = {k: r[k] for k in ("cer", "wer", "loss", "num_utts")}
    return out


def predict_runs(wd: str) -> dict:
    from asr_study_tpu.cli.predict import main as predict
    from asr_study_tpu.cli.train import main as train

    corpus = os.path.join(wd, "corpus")
    wavs = [os.path.join(corpus, f"synth_{i:05d}.wav") for i in (9, 19, 29, 39)]
    out = {}
    for name, extra in (("host", []), ("on_device", ["--on_device",
                                                     "--batch_size", "4"])):
        got = cli(predict, ["--save", os.path.join(wd, "run")] + extra + wavs)
        check([g["file"] for g in got] == wavs, f"{name}: {got}")
        out[name] = [g["transcript"] for g in got]
    run_uni = os.path.join(wd, "run_uni")
    cli(train, ["--dataset", os.path.join(wd, "mfcc"),
                "--model", "deep_blstm", "--batch_size", str(BATCH),
                "--epochs", "1", "--save", run_uni]
        + _params("bidirectional=false"))
    got = cli(predict, ["--save", run_uni, "--stream",
                        "--chunk_seconds", "1.0"] + wavs)
    check([g["file"] for g in got] == wavs, f"stream: {got}")
    out["stream"] = [g["transcript"] for g in got]
    return out


def raw_training(wd: str) -> dict:
    from asr_study_tpu.cli.train import main as train

    run = os.path.join(wd, "run_raw")
    cli(train, ["--dataset", os.path.join(wd, "raw"), "--model", "deep_blstm",
                "--batch_size", str(BATCH), "--epochs", "1", "--save", run,
                "--device_features", "mfcc", "--log_every", "5"]
        + _params())
    losses = logged_losses(run, "train_loss")
    check(finite(losses), f"raw-wav epoch loss {losses}")
    return {"epoch_losses": losses, "steps": last_step(run)}


# -- parity: a device against the CPU reference -------------------------------

def _speechlike_wavs(rng, batch: int, n_max: int):
    import numpy as np

    lens = rng.integers(n_max // 2, n_max + 1, size=batch)
    lens[0] = n_max
    wavs = np.zeros((batch, n_max), np.float32)
    for i, n in enumerate(lens):
        t = np.arange(n) / 16000.0
        f0 = rng.uniform(80, 250)
        sig = sum(np.sin(2 * np.pi * f0 * (k + 1) * t) / (k + 1)
                  for k in range(4)) + 0.1 * rng.standard_normal(n)
        wavs[i, :n] = sig / np.abs(sig).max() * 0.5
    return wavs, lens.astype(np.int32)


def parity_featurizer(dev, batch: int = B, frames: int = T) -> dict:
    """XLA featurizer (mfcc + delta + delta-delta) on ``dev`` vs the
    float64 NumPy oracle, with the bounds tests/test_features_device.py
    holds the chain to: with a power floor (``log_floor=1e-2``) the parity
    is elementwise, rtol 1e-4 and atol 2e-3.  Without the floor, float32
    and float64 logs of near-silent mel channels diverge without bound
    (the documented worst case, which the DCT spreads over a frame's
    cepstra), so the default chain's deviation is reported, not held to
    a bound."""
    import jax
    import numpy as np

    from asr_study_tpu.features import audio
    from asr_study_tpu.features.device import DeviceFeaturizer

    rng = np.random.default_rng(0)
    wavs, lens = _speechlike_wavs(rng, batch, (frames - 1) * 160 + 400)
    out = {"shape": None}
    for name, kw in (("log_floor", {"log_floor": 1e-2}), ("default", {})):
        feats, flen = jax.jit(DeviceFeaturizer(kind="mfcc", **kw)._transform)(
            jax.device_put(wavs, dev), jax.device_put(lens, dev)
        )
        feats, flen = np.asarray(feats), np.asarray(flen)
        out["shape"] = list(feats.shape)
        oracle = audio.MFCC(**kw)
        max_err, max_med = 0.0, 0.0
        for i in range(batch):
            want = oracle(wavs[i, : lens[i]])
            got = feats[i, : int(flen[i])]
            check(got.shape == want.shape, f"row {i}: {got.shape}")
            if kw:
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)
            max_err = max(max_err, float(np.abs(got - want).max()))
            max_med = max(max_med, float(np.median(np.abs(got - want))))
        out[name] = {"max_abs": max_err, "max_median_abs": max_med}
    out["tolerance"] = "log_floor chain: rtol 1e-4, atol 2e-3; default: none"
    return out


def _model_inputs(batch, frames, feats, hidden, layers, seed=0):
    import jax
    import numpy as np

    from asr_study_tpu.models.zoo import build_model

    model = build_model("deep_blstm", {"num_hiddens": hidden,
                                       "num_layers": layers}, num_classes=27)
    params = model.init(jax.random.PRNGKey(seed), feats)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, frames, feats)).astype(np.float32)
    lens = rng.integers(frames // 2, frames + 1, size=batch).astype(np.int32)
    lens[0] = frames
    return model, params, x, lens


def _on(dev, tree):
    import jax

    return jax.device_put(tree, dev)


def parity_forward(dev, ref, batch: int = B, frames: int = T,
                   feats: int = F, hidden: int = 256, layers: int = 3) -> dict:
    """Forward log-probs of ``deep_blstm`` on ``dev`` vs ``ref``:

    - both under HIGHEST precision: within 1e-4 of the largest |log-prob|
      (only the order of float32 sums and the transcendental
      implementations differ);
    - ``dev`` at default precision (TF32 tensor cores on the GPU, whose
      operands keep 10 mantissa bits, relative rounding 2^-11 ~ 4.9e-4)
      vs ``ref`` at HIGHEST: the rounding of every input projection and
      recurrent matmul feeds the next frame through 3 layers x 512
      steps, so the log-probs may move by up to 2e-2 absolute.
    """
    import jax
    import numpy as np

    model, params, x, lens = _model_inputs(batch, frames, feats, hidden,
                                           layers)
    fwd = jax.jit(lambda p, x, l: jax.nn.log_softmax(
        model.apply(p, x, l, train=False), axis=-1))
    valid = np.arange(frames)[None, :] < lens[:, None]
    args = (params, x, lens)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(fwd(*_on(ref, args)))[valid]
        got_hi = np.asarray(fwd(*_on(dev, args)))[valid]
    got_def = np.asarray(fwd(*_on(dev, args)))[valid]
    scale = float(np.abs(want).max())
    rel_hi = float(np.abs(got_hi - want).max()) / scale
    abs_def = float(np.abs(got_def - want).max())
    check(rel_hi < 1e-4, f"HIGHEST forward rel diff {rel_hi}")
    check(abs_def < 2e-2, f"default-precision log-prob diff {abs_def}")
    return {"highest_rel_max": rel_hi, "highest_tolerance": 1e-4,
            "default_abs_max_logprob": abs_def, "default_tolerance": 2e-2,
            "frames_compared": int(valid.sum())}


def parity_ctc(dev, ref, batch: int = B, frames: int = T,
               labels: int = L, vocab: int = 28) -> dict:
    """Scan CTC loss and d(sum loss)/d(logits) on ``dev`` vs
    ``optax.ctc_loss`` on ``ref``, both in float32.  Loss: within 1e-5 of
    the largest |loss|.  Gradient: within 1e-3 of the largest |grad|,
    because float32 itself is that far off at T=512: against float64 on
    the CPU the scan's gradient deviates by 2.5e-4 and optax's by 4.9e-4
    of the largest |grad| (both agree with each other to 1e-12 in
    float64).  The same scan on ``ref`` is also compared: its loss
    within 1e-5, its gradient within 1e-4 (an H100 against the CPU
    differed by 3.6e-5: the devices round exp/log differently, and the
    recursion carries that through 512 frames)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from asr_study_tpu.ops.ctc import ctc_loss

    rng = np.random.default_rng(1)
    logits = rng.standard_normal((batch, frames, vocab)).astype(np.float32)
    lens = rng.integers(max(frames // 2, 2 * labels + 1), frames + 1,
                        size=batch).astype(np.int32)
    lab = rng.integers(0, vocab - 1, size=(batch, labels)).astype(np.int32)
    lab_lens = rng.integers(labels // 2, labels + 1, size=batch)
    lab_lens = lab_lens.astype(np.int32)

    def ours(lg):
        return ctc_loss(lg, lens, lab, lab_lens)

    def theirs(lg):
        pad_t = (np.arange(frames)[None] >= lens[:, None]).astype(np.float32)
        pad_l = (np.arange(labels)[None] >= lab_lens[:, None])
        return optax.ctc_loss(lg, pad_t, lab, pad_l.astype(np.float32),
                              blank_id=vocab - 1)

    def loss_and_grad(fn, d):
        f = jax.jit(lambda lg: (fn(lg), jax.grad(lambda z: fn(z).sum())(lg)))
        with jax.default_device(d):
            loss, grad = f(jax.device_put(logits, d))
        return np.asarray(loss), np.asarray(grad)

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    got_l, got_g = loss_and_grad(ours, dev)
    want_l, want_g = loss_and_grad(theirs, ref)
    same_l, same_g = loss_and_grad(ours, ref)
    out = {"optax_loss_rel": rel(got_l, want_l),
           "optax_grad_rel": rel(got_g, want_g),
           "scan_ref_loss_rel": rel(got_l, same_l),
           "scan_ref_grad_rel": rel(got_g, same_g),
           "tolerance": {"loss": 1e-5, "optax_grad": 1e-3,
                         "scan_ref_grad": 1e-4},
           "mean_loss": float(want_l.mean())}
    check(out["optax_loss_rel"] < 1e-5 and out["scan_ref_loss_rel"] < 1e-5,
          f"CTC loss {out}")
    check(out["optax_grad_rel"] < 1e-3, f"CTC grad vs optax {out}")
    check(out["scan_ref_grad_rel"] < 1e-4, f"CTC grad vs {ref} {out}")
    return out


def parity_decode(dev, ref, batch: int = B, frames: int = T,
                  vocab: int = 28, beam: int = 16) -> dict:
    """Greedy and beam-``beam`` decodes of the same emissions on ``dev``
    and ``ref`` must be identical.  The emissions are speech-like (about
    65% blank-dominated frames, as a trained CTC model emits) so the
    comparison is not decided by float32 ties."""
    import jax
    import numpy as np

    from asr_study_tpu.ops import beam_search_decode, greedy_decode

    rng = np.random.default_rng(2)
    logits = rng.standard_normal((batch, frames, vocab)).astype(np.float32)
    blank = rng.random((batch, frames)) < 0.65
    logits[..., -1] += np.where(blank, 6.0, -6.0)
    lens = rng.integers(frames // 2, frames + 1, size=batch).astype(np.int32)

    greedy = jax.jit(lambda lg, l: greedy_decode(lg, l))
    beamd = jax.jit(lambda lg, l: beam_search_decode(lg, l,
                                                     beam_width=beam)[:2])
    out = {}
    for name, fn in (("greedy", greedy), (f"beam{beam}", beamd)):
        got = [np.asarray(a) for a in fn(*_on(dev, (logits, lens)))]
        want = [np.asarray(a) for a in fn(*_on(ref, (logits, lens)))]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        out[name] = "identical"
    return out


def parity_dpack(dev, batch: int = B, seconds=(3.0, 8.0)) -> dict:
    """dpack wire decode on ``dev`` is bit-identical to the pcm16 path."""
    import jax
    import numpy as np

    from asr_study_tpu.data import wire

    rng = np.random.default_rng(3)
    n_max = int(seconds[1] * 16000)
    wavs, lens = _speechlike_wavs(rng, batch, n_max)
    rows = [wavs[i, : lens[i]] for i in range(batch)]
    n_pad = -(-n_max // 2048) * 2048
    cap, scap = wire.dpack_measure([rows], batch)
    d = wire.pack_audio(rows, cap, batch=batch, codec="dpack", scap=scap)
    cap16 = wire.wire_cap(batch, int(lens.sum()))
    p = wire.pack_audio(rows, cap16, batch=batch)
    got, got_l = jax.jit(
        lambda f: wire.dpack_unpack(f, batch, n_pad, scap)
    )(jax.device_put(d, dev))
    want, want_l = jax.jit(
        lambda f: wire.unpack_audio(f, batch, n_pad)
    )(jax.device_put(p, dev))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(got_l), np.asarray(want_l))
    return {"bit_exact": True, "samples": int(lens.sum()),
            "dpack_bytes": int(d.nbytes), "pcm16_bytes": int(p.nbytes)}


def gpu_tests() -> dict:
    """The card-only tests (pytest marker ``gpu``), in this process; the
    repo's conftest is left out because it pins jax to the CPU."""
    import pytest

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = pytest.main([os.path.join(REPO, "tests", "test_gpu.py"),
                          "-m", "gpu", "--noconftest", "-q",
                          "-p", "no:cacheprovider"])
    summary = buf.getvalue().strip().splitlines()[-1]
    check(rc == 0 and "passed" in summary and "skipped" not in summary,
          f"gpu tests: rc={rc}: {buf.getvalue()[-3000:]}")
    return {"summary": summary}


def parity(dev, ref) -> dict:
    return {
        "featurizer": parity_featurizer(dev),
        "forward": parity_forward(dev, ref),
        "ctc": parity_ctc(dev, ref),
        "decode": parity_decode(dev, ref),
        "dpack": parity_dpack(dev),
    }


# -- four cards ---------------------------------------------------------------

def _final_params(run_dir: str) -> dict:
    import numpy as np

    from asr_study_tpu.train.checkpoint import CheckpointManager

    step = CheckpointManager(run_dir).latest_step
    with np.load(os.path.join(run_dir, "ckpt", f"{step}.npz")) as z:
        return {k: z[k] for k in z.files if k.startswith("['params']")}


def four_cards(wd: str, phases: Phases) -> None:
    """Data-parallel (4x1) and tensor-parallel (2x2) training and
    4-card eval against one card, same seed and batches.

    Dropout is off: a multi-card step folds the card index into the
    dropout key (decorrelated masks per card), so with dropout the runs
    are different samples, not the same computation.

    Tolerances: the cards sum gradients in another order than one card
    (per-card partial sums, then an all-reduce) and TF32 matmuls round
    differently at other per-card shapes, so trajectories drift at float
    precision; Adam divides by sqrt(v) and so enlarges the relative
    drift of small gradients.  After 10 steps the logged losses must
    agree within 1e-3 relative and every parameter within 2e-3 absolute
    (2 Adam steps of the 1e-3 learning rate).  Eval only reduces per-card
    sums: CER identical, loss within 1e-5 relative.
    """
    import numpy as np

    from asr_study_tpu.cli.eval import main as evaluate
    from asr_study_tpu.cli.make_dataset import main as make_dataset
    from asr_study_tpu.cli.train import main as train

    data = os.path.join(wd, "mfcc")
    phases.run("make_dataset", cli, make_dataset, _corpus_args(wd) + [
        "--output", data, "--input_parser", "mfcc"])
    base = ["--dataset", data, "--model", "deep_blstm",
            "--batch_size", str(BATCH), "--epochs", "1", "--log_every", "1",
            "--seed", "0"] + _params("dropout=0.0")

    one = os.path.join(wd, "run_one")
    phases.run("train_1", cli, train,
               base + ["--num_devices", "1", "--save", one])

    def compare(name, cards):
        run = os.path.join(wd, f"run_{name}")
        cli(train, base + cards + ["--save", run])
        la = np.array([l for _, l in logged_losses(one)])
        lb = np.array([l for _, l in logged_losses(run)])
        pa, pb = _final_params(one), _final_params(run)
        loss_rel = float(np.abs(la - lb).max() / np.abs(la).max())
        param_abs = max(float(np.abs(pa[k] - pb[k]).max()) for k in pa)
        check(la.shape == lb.shape and loss_rel < 1e-3,
              f"{name}: loss trajectories {la} vs {lb}")
        check(param_abs < 2e-3, f"{name}: params differ by {param_abs}")
        return {"steps": int(la.size), "loss_rel_max": loss_rel,
                "loss_tolerance": 1e-3, "param_abs_max": param_abs,
                "param_tolerance": 2e-3,
                "final_loss": [float(la[-1]), float(lb[-1])]}

    phases.run("train_dp4_vs_1", compare, "dp4", ["--num_devices", "4"])
    phases.run("train_tp2x2_vs_1", compare, "tp2x2",
               ["--num_devices", "2", "--tp_devices", "2"])

    def eval_compare():
        argv = ["--dataset", data, "--split", "test",
                "--batch_size", str(BATCH), "--save", one]
        r1 = cli(evaluate, argv + ["--num_devices", "1"])[-1]
        r4 = cli(evaluate, argv + ["--num_devices", "4"])[-1]
        loss_rel = abs(r1["loss"] - r4["loss"]) / abs(r1["loss"])
        check(r1["cer"] == r4["cer"], f"CER {r1} vs {r4}")
        check(loss_rel < 1e-5, f"eval loss {r1} vs {r4}")
        return {"cer": [r1["cer"], r4["cer"]], "loss_rel": loss_rel,
                "loss_tolerance": 1e-5}

    phases.run("eval_4_vs_1", eval_compare)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    unknown = [a for a in argv if a != "--four-cards"]
    if unknown:
        print(f"unknown arguments {unknown}; usage: chip_smoke.py "
              "[--four-cards]", file=sys.stderr)
        return 2
    four = "--four-cards" in argv

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; jax found {devices[0].platform!r} "
              "devices (did the CUDA plugin fail to load?)", file=sys.stderr)
        return 2
    if four and len(devices) < 4:
        print(f"--four-cards needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from asr_study_tpu.utils.platform import (
        card_name_and_power_limit, setup_compilation_cache,
    )

    setup_compilation_cache()
    card = card_name_and_power_limit() or "nvidia-smi not available"
    print(card, flush=True)
    phases = Phases(devices[0].device_kind, card)
    wd = os.path.join(REPO, "runs", "chip_smoke")
    shutil.rmtree(wd, ignore_errors=True)
    os.makedirs(wd)
    if four:
        four_cards(wd, phases)
    else:
        phases.run("make_dataset", make_datasets, wd)
        phases.run("train", train_runs, wd)
        phases.run("eval", eval_runs, wd)
        phases.run("predict", predict_runs, wd)
        phases.run("train_raw_device_features", raw_training, wd)
        phases.run("parity", parity, devices[0], jax.devices("cpu")[0])
        phases.run("gpu_tests", gpu_tests)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
