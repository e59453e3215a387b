"""Training CLI [ref: train.py].

Example::

    python train.py --dataset data.h5 --model graves2006 \
        --params "num_hiddens=128,num_layers=2" --epochs 20 --save runs/exp1
"""

from __future__ import annotations

import argparse
import os
import sys

import jax

from asr_study_tpu.data.generator import DatasetGenerator
from asr_study_tpu.models.zoo import build_model
from asr_study_tpu.train.checkpoint import CheckpointManager
from asr_study_tpu.train.loop import fit
from asr_study_tpu.train.trainer import Trainer, make_mesh, make_optimizer


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a CTC acoustic model")
    p.add_argument("--dataset", required=True,
                   help="HDF5 dataset path, or a .json manifest (features "
                        "extracted on the fly with --input_parser)")
    p.add_argument("--input_parser", default="mfcc",
                   help="feature extractor for .json datasets")
    p.add_argument("--input_params", default=None,
                   help="feature kwargs as JSON for .json datasets")
    p.add_argument("--model", default="graves2006")
    p.add_argument("--params", default=None,
                   help='hparam overrides, e.g. "num_hiddens=256,num_layers=3"')
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--opt", default="adam")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--clipnorm", type=float, default=400.0)
    p.add_argument("--lr_decay", type=float, default=0.0,
                   help="staircase LR decay per epoch, e.g. 0.95 "
                        "(0 = constant lr)")
    p.add_argument("--lr_plateau", type=float, default=0.0,
                   help="scale LR by this factor when the epoch-averaged "
                        "train loss plateaus (Keras ReduceLROnPlateau "
                        "idiom; 0 = off)")
    p.add_argument("--lr_patience", type=int, default=3,
                   help="epochs without improvement before --lr_plateau "
                        "fires")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient accumulation: apply the optimizer once "
                        "per N micro-batches (effective batch = N x "
                        "batch_size at one micro-batch's memory)")
    p.add_argument("--early_stop", type=int, default=0,
                   help="stop when --monitor has not improved for N "
                        "epochs (0 = off)")
    p.add_argument("--monitor", default="val_loss",
                   choices=["val_loss", "val_ler"],
                   help="validation metric driving BOTH the 'best' "
                        "checkpoint and --early_stop (the Keras "
                        "ModelCheckpoint/EarlyStopping monitor idiom; "
                        "lower is better for both choices)")
    p.add_argument("--save", default=None,
                   help="checkpoint/log dir (default: auto-named from the "
                        "model + non-default args, like the reference)")
    p.add_argument("--resume", nargs="?", const="latest", default="",
                   choices=["", "latest", "auto"],
                   help="resume from the latest checkpoint in --save: "
                        "'latest' (bare --resume; errors if none exists) or "
                        "'auto' (resume when a checkpoint exists, otherwise "
                        "start fresh — crash-safe restart loops)")
    p.add_argument("--init_from", default=None,
                   help="warm-start the model weights from another run dir "
                        "(its best checkpoint if kept, else latest); the "
                        "optimizer starts fresh at step 0 — for fine-tuning "
                        "across runs/optimizers, unlike --resume")
    p.add_argument("--num_devices", type=int, default=0,
                   help="data-parallel devices (0 = all available)")
    p.add_argument("--tp_devices", type=int, default=1,
                   help="tensor-parallel shards per replica (gate-dim "
                        "sharded recurrence, lstm/gru cells; total devices "
                        "= num_devices x tp_devices)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", action="store_true",
                   help="capture a jax.profiler trace of early steps")
    p.add_argument("--tensorboard", action="store_true",
                   help="also write TensorBoard event files to "
                        "<run>/tb (CSV is always written)")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--platform", default=None,
                   help="force a jax platform (cpu|gpu); default = env")
    p.add_argument("--check_nans", action="store_true",
                   help="enable jax_debug_nans (fail fast on NaN, slower)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (f32 master weights + loss)")
    p.add_argument("--vocab", default=None,
                   help="label vocabulary: preset name (pt_br, "
                        "pt_br_apostrophe) or literal characters; default "
                        "= the dataset's stored vocabulary (HDF5) or the "
                        "pt_br preset. Must match an HDF5 dataset's "
                        "stored vocabulary")
    p.add_argument("--device_features", nargs="?", const="mfcc",
                   default=None,
                   choices=["fbank", "logfbank", "mfcc"],
                   help="train directly from a RAW-waveform dataset "
                        "(make_dataset --input_parser raw): features of "
                        "this kind are extracted on the accelerator "
                        "INSIDE the jitted train step — no feature "
                        "precompute, feature hyperparameters swappable "
                        "per run (bare flag = mfcc)")
    p.add_argument("--device_feature_params", default=None,
                   help='feature kwargs as JSON for --device_features, '
                        'e.g. \'{"nfilt": 80, "d": true}\'')
    p.add_argument("--sortagrad", action="store_true",
                   help="first epoch in ascending-duration batch order "
                        "(SortaGrad, Deep Speech 2): short, easy CTC "
                        "alignments stabilize warm-up; later epochs "
                        "shuffle as usual")
    p.add_argument("--wav_augment", nargs="?", const="", default=None,
                   help="raw-waveform augmentation during training "
                        "(needs --device_features): per-utterance random "
                        "gain + additive white noise, on device inside "
                        "the train step; optionally 'gain_db=3,"
                        "noise_snr_min=20,noise_snr_max=50' (bare flag = "
                        "those defaults; setting only one group, gain or "
                        "noise, keeps the other group's default)")
    p.add_argument("--spec_augment", nargs="?", const="", default=None,
                   help="SpecAugment feature masking during training; "
                        "optionally 'freq_masks=2,freq_width=8,"
                        "time_masks=2,time_ratio=0.05' (bare flag = "
                        "those defaults)")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from asr_study_tpu.utils.platform import (
        select_platform, setup_compilation_cache,
    )

    select_platform(args.platform)
    setup_compilation_cache()
    if args.check_nans:
        jax.config.update("jax_debug_nans", True)
    if args.save is None:
        # run naming from non-default args [ref: utils/generic_utils.py]
        defaults = build_argparser().parse_args(
            ["--dataset", args.dataset]
        )
        tags = [args.model]
        for k in ("params", "batch_size", "opt", "lr", "clipnorm", "bf16",
                  "lr_decay", "early_stop", "accum_steps", "lr_plateau"):
            v = getattr(args, k)
            # `is not False`, NOT `not in (None, False)`: 0 == False in
            # Python, so a falsy-zero override (--clipnorm 0) must still
            # tag the run dir or it collides with the default run's
            if v != getattr(defaults, k) and v is not None and v is not False:
                tags.append(f"{k}={v}")
        safe = "".join(
            c if c.isalnum() or c in "=._-" else "_" for c in "_".join(tags)
        )
        args.save = os.path.join("runs", safe)
        print(f"run dir: {args.save}", file=sys.stderr)
    from asr_study_tpu.cli.data_flow import parser_for_training

    label_parser = parser_for_training(args.dataset, args.vocab)
    model = build_model(
        args.model, args.params, num_classes=label_parser.num_classes
    )

    avail = len(jax.devices())
    tp = max(1, args.tp_devices)
    if tp > 1:
        from asr_study_tpu.parallel.tp import validate_tp

        try:
            validate_tp(model, tp)
        except ValueError as e:
            raise SystemExit(f"--tp_devices {tp}: {e}") from None
    n_dev = args.num_devices or avail // tp
    if n_dev < 1 or n_dev * tp > avail:
        raise SystemExit(
            f"--num_devices {args.num_devices or n_dev} x --tp_devices "
            f"{tp} but only {avail} device(s) available"
        )
    if args.batch_size % n_dev:
        raise SystemExit(
            f"--batch_size {args.batch_size} not divisible by {n_dev} devices"
        )
    mesh = (
        make_mesh(n_dev, model_devices=tp)
        if n_dev > 1 or tp > 1 else None
    )

    from asr_study_tpu.cli.data_flow import flow_from_arg

    from asr_study_tpu.cli.data_flow import RAW_GEN_KW

    gen_kw = RAW_GEN_KW if args.device_features else {}
    gen = DatasetGenerator(batch_size=args.batch_size, **gen_kw)
    train_it = flow_from_arg(
        gen, args.dataset, "train", label_parser,
        args.input_parser, args.input_params,
    )
    try:
        valid_it = flow_from_arg(
            gen, args.dataset, "valid", label_parser,
            args.input_parser, args.input_params,
        )
    except KeyError:
        valid_it = None     # dataset has no 'valid' split
    except ValueError as e:
        # only the generator's intentional "no usable valid data" signal
        # means train-without-validation; anything else (corrupt wav,
        # feature failure) must surface, not silently drop validation
        if "empty dataset" not in str(e):
            raise
        valid_it = None
    if args.early_stop and valid_it is None:
        raise SystemExit(
            "--early_stop requires a 'valid' split in the dataset "
            "(val_loss drives the stopping decision)"
        )

    tx = make_optimizer(
        args.opt, args.lr, args.clipnorm,
        lr_decay=args.lr_decay,
        # the decay schedule counts optimizer APPLIES, which accumulation
        # makes 1/accum_steps as frequent — keep per-epoch decay semantics
        decay_steps=(
            max(1, train_it.steps_per_epoch // args.accum_steps)
            if args.lr_decay else 0
        ),
        accum_steps=args.accum_steps,
        plateau_factor=args.lr_plateau,
        plateau_patience=args.lr_patience if args.lr_plateau else 0,
        plateau_window=max(1, train_it.steps_per_epoch // args.accum_steps),
    )
    import jax.numpy as jnp

    augment = None
    if args.spec_augment is not None:
        from asr_study_tpu.features.augment import parse_spec_augment

        augment = parse_spec_augment(args.spec_augment)
        print(f"training with {augment}", file=sys.stderr)
    featurizer = None
    if args.device_features:
        from asr_study_tpu.cli.data_flow import device_featurizer_for

        featurizer = device_featurizer_for(
            args.device_features, args.device_feature_params, train_it,
            args.dataset, "--device_features",
        )
        print(
            f"on-device features: {args.device_features} "
            f"({type(featurizer).__name__}, {featurizer.num_feats} dims)",
            file=sys.stderr,
        )
    wav_augment = None
    if args.wav_augment is not None:
        if featurizer is None:
            raise SystemExit(
                "--wav_augment operates on raw waveforms and needs "
                "--device_features"
            )
        from asr_study_tpu.features.augment import parse_wav_augment

        wav_augment = parse_wav_augment(args.wav_augment)
        print(f"training with {wav_augment}", file=sys.stderr)
    trainer = Trainer(
        model, tx, mesh=mesh,
        compute_dtype=jnp.bfloat16 if args.bf16 else None,
        augment=augment, featurizer=featurizer, wav_augment=wav_augment,
    )
    state = trainer.init_state(
        jax.random.PRNGKey(args.seed),
        featurizer.num_feats if featurizer else train_it.num_feats,
    )
    print(model.summary(state.params), file=sys.stderr)
    if args.init_from:
        if args.resume:
            raise SystemExit("--init_from and --resume are exclusive")
        import dataclasses

        src = CheckpointManager(args.init_from)
        # prefer the best checkpoint, fall back to latest LOUDLY (the
        # source run may have trained without a validation metric)
        use_best = src.best_step is not None
        state = dataclasses.replace(
            state, params=src.restore_params(state.params, best=use_best)
        )
        print(
            f"warm-started weights from {args.init_from} "
            f"({'best' if use_best else 'latest'} checkpoint)",
            file=sys.stderr,
        )
    ckpt = CheckpointManager(args.save, best_metric=args.monitor)
    if args.resume:
        if ckpt.latest_step is not None:
            state = ckpt.restore(state)
            print(f"resumed from step {int(state.step)}", file=sys.stderr)
        elif args.resume == "latest":
            raise SystemExit(
                f"--resume: no checkpoint found in {args.save} "
                "(use '--resume auto' to start fresh when none exists)"
            )

    hparams = {
        "model": args.model, "params": args.params,
        "batch_size": args.batch_size, "opt": args.opt, "lr": args.lr,
        "clipnorm": args.clipnorm, "num_devices": n_dev,
        "tp_devices": tp,
        "bf16": args.bf16, "lr_decay": args.lr_decay,
        "early_stop": args.early_stop, "accum_steps": args.accum_steps,
        "lr_plateau": args.lr_plateau,
        "monitor": args.monitor,
        "spec_augment": args.spec_augment,
        "wav_augment": args.wav_augment,
        "sortagrad": args.sortagrad,
        "device_features": args.device_features,
        "device_feature_params": args.device_feature_params,
        "num_feats": (
            featurizer.num_feats if featurizer else train_it.num_feats
        ),
        "num_classes": label_parser.num_classes,
        "vocab": label_parser.vocab,
    }
    fit(
        trainer, state, train_it, valid_it,
        epochs=args.epochs, seed=args.seed, ckpt=ckpt, hparams=hparams,
        log_dir=args.save, log_every=args.log_every, profile=args.profile,
        tensorboard=args.tensorboard, early_stop_patience=args.early_stop,
        sortagrad=args.sortagrad, monitor=args.monitor,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
