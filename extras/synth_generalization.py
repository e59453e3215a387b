#!/usr/bin/env python
"""Held-out generalization experiment on the SynthWords structured corpus.

    python extras/synth_generalization.py --workdir /tmp/gen [--platform cpu]

Produces the four comparisons VERDICT r3 asked for (Next #4), each on
data the model never saw, from one reproducible script:

(a) val CER DECREASES over training (trajectory from the run's CSV);
(b) beam search beats greedy decoding on held-out data;
(c) char-LM shallow fusion (LM fit on the TRAIN transcripts) beats
    plain beam search;
(d) augmentation (SpecAugment) narrows the train/val gap.

The corpus (data/corpora.py::SynthWords) shares its word list and Zipf
word distribution across train/valid/test but not word sequences, so
these effects are measurable — unlike the Dummy corpus, whose random
transcripts make val divergence structural.

Prints one JSON line with every number (the corpus is small by design;
on a CPU the run takes about an hour).
"""

import argparse
import contextlib
import csv
import io
import json
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def run_eval(h5, run, split, beam=0, lm=None, lm_alpha=0.8):
    from asr_study_tpu.cli.eval import main as eval_main

    argv = ["--dataset", h5, "--split", split, "--save", run, "--best"]
    if beam:
        argv += ["--beam_width", str(beam)]
    if lm:
        argv += ["--lm", lm, "--lm_alpha", str(lm_alpha)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = eval_main(argv)
    assert rc == 0, f"eval failed: {argv}"
    line = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")][-1]
    return json.loads(line)


def val_trajectory(run):
    path = os.path.join(run, "train_metrics.csv")
    rows = [r for r in csv.DictReader(open(path)) if r.get("val_ler")]
    return [float(r["val_ler"]) for r in rows]


def median_steps_per_s(run):
    path = os.path.join(run, "train_metrics.csv")
    vals = sorted(
        float(r["steps_per_s"]) for r in csv.DictReader(open(path))
        if r.get("steps_per_s")
    )
    return vals[len(vals) // 2] if vals else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--model", default="deep_blstm")
    ap.add_argument("--params", default="num_hiddens=128,num_layers=2")
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--beam", type=int, default=16)
    ap.add_argument("--lm_order", type=int, default=4)
    ap.add_argument("--lm_alpha", type=float, default=0.8)
    ap.add_argument("--spec_augment", default="",
                    help="SpecAugment spec for the augmented run "
                         "(default: the flag's documented defaults)")
    args = ap.parse_args(argv)
    if args.platform:
        from asr_study_tpu.utils.platform import select_platform

        select_platform(args.platform)

    from asr_study_tpu.cli.make_dataset import main as make_main
    from asr_study_tpu.cli.train import main as train_main
    from asr_study_tpu.cli.train_lm import main as train_lm_main

    wd = args.workdir
    os.makedirs(wd, exist_ok=True)
    h5 = os.path.join(wd, "synth.h5")
    if not os.path.exists(h5):
        rc = make_main([
            "--parser", "synthwords",
            "--dataset_dir", os.path.join(wd, "corpus"),
            "--corpus_params",
            json.dumps({"n": args.n, "seed": args.seed}),
            "--output", h5, "--input_parser", "mfcc",
        ])
        assert rc == 0

    common = [
        "--dataset", h5, "--model", args.model, "--params", args.params,
        "--epochs", str(args.epochs), "--batch_size", str(args.batch_size),
        "--monitor", "val_ler", "--log_every", "5", "--seed", "1",
    ]
    runs = {}
    for name, extra in (("base", []),
                        ("aug", ["--spec_augment", args.spec_augment])):
        run = os.path.join(wd, name)
        runs[name] = run
        # completion = one history row per requested epoch — meta.json
        # alone appears at the FIRST epoch's save, so an interrupted run
        # would otherwise be treated as finished and publish numbers
        # from an undertrained model (r5 review).  An incomplete run
        # resumes for exactly the missing epochs.
        mpath = os.path.join(run, "meta.json")
        done_epochs = 0
        if os.path.exists(mpath):
            with open(mpath) as f:
                done_epochs = len(json.load(f).get("history", []))
        if done_epochs < args.epochs:
            cont = (["--resume"] if done_epochs else []) + [
                "--epochs", str(args.epochs - done_epochs)
            ]
            rc = train_main(common + ["--save", run] + extra + cont)
            assert rc == 0, f"train {name} failed"

    lm = os.path.join(wd, "lm.npz")
    if not os.path.exists(lm):
        rc = train_lm_main([
            "--dataset", h5, "--splits", "train",
            "--order", str(args.lm_order), "--output", lm,
            "--held_out", "valid",
        ])
        assert rc == 0

    out = {"n": args.n, "epochs": args.epochs, "beam": args.beam,
           "lm_order": args.lm_order, "lm_alpha": args.lm_alpha,
           "params": args.params,
           "train_steps_per_s_median": median_steps_per_s(runs["base"])}
    traj = val_trajectory(runs["base"])
    out["val_ler_trajectory_first_mid_last"] = [
        round(traj[0], 4), round(traj[len(traj) // 2], 4),
        round(traj[-1], 4),
    ]
    out["val_ler_decreases"] = bool(min(traj[-3:]) < traj[0] * 0.5)

    for name, run in runs.items():
        for split in ("train", "valid", "test"):
            g = run_eval(h5, run, split)
            out[f"{name}_{split}_greedy_cer"] = round(g["cer"], 4)
        b = run_eval(h5, run, "test", beam=args.beam)
        out[f"{name}_test_beam_cer"] = round(b["cer"], 4)
        bl = run_eval(h5, run, "test", beam=args.beam, lm=lm,
                      lm_alpha=args.lm_alpha)
        out[f"{name}_test_beam_lm_cer"] = round(bl["cer"], 4)
        bl_wer = bl.get("wer")
        out[f"{name}_test_beam_lm_wer"] = round(bl_wer, 4)
        out[f"{name}_test_greedy_wer"] = round(
            run_eval(h5, run, "test")["wer"], 4)

    out["gap_base"] = round(
        out["base_valid_greedy_cer"] - out["base_train_greedy_cer"], 4)
    out["gap_aug"] = round(
        out["aug_valid_greedy_cer"] - out["aug_train_greedy_cer"], 4)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
