"""Evaluation CLI [ref: eval.py]: checkpoint -> decode split -> CER/LER/WER.

Example::

    python eval.py --dataset data.h5 --save runs/exp1 --split test \
        --beam_width 16
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import jax
import numpy as np

from asr_study_tpu.data.generator import DatasetGenerator
from asr_study_tpu.models.zoo import build_model
from asr_study_tpu.ops import beam_search_decode, greedy_decode
from asr_study_tpu.ops.metrics import cer, wer
from asr_study_tpu.text.parser import CharParser
from asr_study_tpu.train.checkpoint import CheckpointManager
from asr_study_tpu.train.trainer import Trainer, make_optimizer


def load_run(save_dir: str, label_parser: CharParser, best: bool = True):
    """Rebuild (model, state) from a training run dir's meta + checkpoint.

    Restores the model PARAMS only (``restore_params``): eval/predict
    never use the optimizer state, and rebuilding the exact optimizer the
    run trained with (schedules, decay flags, ...) just to satisfy the
    checkpoint's opt_state tree structure made every new optimizer option
    an eval-crash hazard — a run trained with ``--lr_decay`` was
    un-evaluable until this decoupling."""
    import dataclasses

    meta_path = os.path.join(save_dir, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    hp = meta.get("hparams", {})
    model = build_model(
        hp.get("model", "graves2006"), hp.get("params"),
        num_classes=hp.get("num_classes", label_parser.num_classes),
    )
    trainer = Trainer(model, make_optimizer())
    state = trainer.init_state(
        jax.random.PRNGKey(0), int(hp.get("num_feats", 39))
    )
    ckpt = CheckpointManager(save_dir)
    state = dataclasses.replace(
        state, params=ckpt.restore_params(state.params, best=best)
    )
    return model, state, hp


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate a trained model")
    p.add_argument("--dataset", required=True,
                   help="HDF5 dataset path or .json manifest")
    p.add_argument("--input_parser", default="mfcc",
                   help="feature extractor for .json datasets")
    p.add_argument("--input_params", default=None)
    p.add_argument("--split", default="test")
    p.add_argument("--save", required=True, help="training run directory")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--beam_width", type=int, default=0,
                   help="0 = greedy decode, >0 = prefix beam search")
    p.add_argument("--beam_prune", type=int, default=0,
                   help="expand only the per-frame top-K chars (0 = exact)")
    p.add_argument("--blank_collapse", type=float, default=0.0,
                   help="collapse blank runs with posterior >= this "
                        "threshold before beam decoding (0 = off)")
    p.add_argument("--keep_ratio", type=float, default=0.6,
                   help="static frame budget for --blank_collapse as a "
                        "fraction of T; overflowing utterances are reported")
    p.add_argument("--lm", default=None,
                   help="char n-gram LM (.npz from train_lm) for "
                        "shallow fusion; needs --beam_width > 0")
    p.add_argument("--lm_alpha", type=float, default=0.8,
                   help="LM weight in the fused beam score")
    p.add_argument("--lm_beta", type=float, default=0.0,
                   help="per-character insertion bonus with --lm")
    p.add_argument("--num_devices", type=int, default=0,
                   help="data-parallel eval over N devices (0/1 = single "
                        "device); batch_size must divide by N")
    p.add_argument("--best", action="store_true",
                   help="use best (val_loss) checkpoint instead of latest")
    p.add_argument("--dump", default=None,
                   help="write per-utterance transcripts to this file")
    p.add_argument("--platform", default=None,
                   help="force a jax platform (cpu|gpu); default = env")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from asr_study_tpu.utils.platform import (
        select_platform, setup_compilation_cache,
    )

    select_platform(args.platform)
    setup_compilation_cache()
    from asr_study_tpu.cli.data_flow import flow_from_arg, parser_from_run

    label_parser = parser_from_run(args.save, args.dataset)
    model, state, hp = load_run(args.save, label_parser, best=args.best)

    from asr_study_tpu.cli.data_flow import RAW_GEN_KW, device_featurizer_for

    gen_kw = RAW_GEN_KW if hp.get("device_features") else {}
    gen = DatasetGenerator(batch_size=args.batch_size, shuffle=False,
                           **gen_kw)
    it = flow_from_arg(
        gen, args.dataset, args.split, label_parser,
        args.input_parser, args.input_params,
    )
    featurizer = None
    if hp.get("device_features"):
        # the run was trained on raw waveforms with in-step featurization
        # (train.py --device_features); rebuild the SAME feature chain
        # from the run's recorded hparams — the dataset must be raw too
        featurizer = device_featurizer_for(
            hp["device_features"], hp.get("device_feature_params"), it,
            args.dataset,
            f"run {args.save} (trained with on-device features)",
        )

    # ONE jitted program per bucket shape: forward + loss + (collapse +)
    # decode all fuse into a single dispatch (an op-by-op decode loop
    # would be dispatch-bound).
    import jax.numpy as jnp

    from asr_study_tpu.ops import blank_collapse
    from asr_study_tpu.ops.ctc import ctc_loss

    # Data-parallel eval: shard_map over a 1-D `data` mesh (params
    # replicated, batch rows sharded, explicit psums) — the same idiom as
    # the Trainer: each device traces its own local-shape program.
    lm = None
    if args.lm:
        if args.beam_width <= 0:
            raise SystemExit("--lm requires --beam_width > 0")
        from asr_study_tpu.text.lm import CharNGramLM, check_lm_vocab

        lm = CharNGramLM.load(args.lm)
        check_lm_vocab(lm, label_parser.vocab)

    n_dev = args.num_devices or 1
    mesh = None
    if n_dev > 1:
        avail = len(jax.devices())
        if n_dev > avail:
            raise SystemExit(
                f"--num_devices {n_dev} but only {avail} device(s) available"
            )
        if args.batch_size % n_dev:
            raise SystemExit(
                f"--batch_size {args.batch_size} not divisible by "
                f"{n_dev} devices"
            )
        from asr_study_tpu.train.trainer import make_mesh

        mesh = make_mesh(n_dev)

    def _eval_core(params, inputs, input_lengths, labels, label_lengths,
                   weights):
        if featurizer is not None:
            inputs, input_lengths = featurizer._transform(
                inputs[..., 0], input_lengths
            )
        logits = model.apply(params, inputs, input_lengths, train=False)
        per_seq = ctc_loss(
            logits, input_lengths, labels, label_lengths,
            blank_id=model.blank_id,
        )
        loss_sum = jnp.sum(per_seq * weights)
        w_sum = jnp.sum(weights)
        if mesh is not None:
            loss_sum = jax.lax.psum(loss_sum, "data")
            w_sum = jax.lax.psum(w_sum, "data")
        loss = loss_sum / jnp.maximum(w_sum, 1.0)
        dropped = jnp.zeros_like(input_lengths)
        if args.beam_width > 0:
            dec_logits, dec_lengths = logits, input_lengths
            if args.blank_collapse > 0:
                dec_logits, dec_lengths, dropped = blank_collapse(
                    logits, input_lengths, blank_id=model.blank_id,
                    threshold=args.blank_collapse,
                    keep_ratio=args.keep_ratio,
                )
            dec, lens, _ = beam_search_decode(
                dec_logits, dec_lengths, beam_width=args.beam_width,
                blank_id=model.blank_id, prune=args.beam_prune,
                lm=lm, lm_alpha=args.lm_alpha, lm_beta=args.lm_beta,
            )
            dec, lens = dec[:, 0], lens[:, 0]
        else:
            dec, lens = greedy_decode(
                logits, input_lengths, blank_id=model.blank_id
            )
        return loss, dec, lens, dropped

    params = state.params
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        batched, repl = P("data"), P()
        eval_batch = jax.jit(jax.shard_map(
            _eval_core, mesh=mesh,
            in_specs=(repl,) + (batched,) * 5,
            out_specs=(repl, batched, batched, batched),
            check_vma=False,
        ))
        # checkpoint restore committed the params to one device;
        # replicate them onto the mesh (as Trainer.init_state does)
        params = jax.device_put(params, NamedSharding(mesh, P()))
    else:
        eval_batch = jax.jit(_eval_core)

    from concurrent.futures import ThreadPoolExecutor

    fetch_pool = ThreadPoolExecutor(4)
    hyps, refs = [], []
    tot_loss, tot_n = 0.0, 0
    overflow_utts = 0
    for b in it.epoch():
        outs = eval_batch(
            params, b.inputs, b.input_lengths, b.labels,
            b.label_lengths, b.weights,
        )
        # pooled fetches overlap the four device->host copies
        loss, dec, lens, dropped = fetch_pool.map(np.asarray, outs)
        n = int(b.weights.sum())
        tot_loss += float(loss) * n
        tot_n += n
        n_over = int(np.count_nonzero(dropped * b.weights))
        if n_over:
            overflow_utts += n_over
            print(
                f"warning: blank_collapse dropped frames on {n_over} "
                f"utterance(s) in this batch — raise --keep_ratio "
                f"(currently {args.keep_ratio})",
                file=sys.stderr,
            )
        for i in range(b.size):
            if b.weights[i] == 0:
                continue
            hyps.append(label_parser.imap(dec[i, : lens[i]]))
            refs.append(
                b.texts[i] if b.texts
                else label_parser.imap(b.labels[i, : b.label_lengths[i]])
            )

    results = {
        "split": args.split,
        "num_utts": tot_n,
        "loss": tot_loss / max(tot_n, 1),
        "cer": cer(hyps, refs),
        "wer": wer(hyps, refs),
        "decoder": (f"beam{args.beam_width}" + ("+lm" if lm else ""))
        if args.beam_width else "greedy",
    }
    if lm is not None:
        results["lm"] = {"path": args.lm, "order": lm.order,
                         "alpha": args.lm_alpha, "beta": args.lm_beta}
    if args.blank_collapse > 0:
        results["blank_collapse_overflow_utts"] = overflow_utts
    if args.dump:
        with open(args.dump, "w") as f:
            for h, r in zip(hyps, refs):
                f.write(json.dumps({"hyp": h, "ref": r}) + "\n")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
