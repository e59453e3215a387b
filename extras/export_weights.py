#!/usr/bin/env python
"""Export a training run's weights to one framework-independent .npz.

A run directory couples the weights to the optimizer state and the
checkpoint retention layout; this flattens the best (or latest)
checkpoint's params into a single
``.npz`` keyed by tree path (``rnn/layers/0/rnn/fw/wx`` ...) plus a JSON
sidecar with the hparams/vocab needed to rebuild the model — a portable,
inspectable artifact for serving hand-off or cross-framework comparison.

    python extras/export_weights.py --save runs/exp1 --output model.npz
    python extras/export_weights.py --load model.npz   # inventory

The export round-trips: ``--verify`` reloads the npz and checks every
array against the checkpoint bit for bit.
"""

import argparse
import json
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def _flatten(params):
    import jax

    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    out = {}
    for path, leaf in flat:
        key = "/".join(
            str(getattr(p, "key", getattr(p, "idx", p))) for p in path
        )
        out[key] = np.asarray(leaf)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--save", help="training run directory to export")
    ap.add_argument("--output", help="output .npz path")
    ap.add_argument("--load", help="inventory an exported .npz and exit")
    ap.add_argument("--latest", action="store_true",
                    help="export the latest checkpoint instead of best")
    ap.add_argument("--verify", action="store_true",
                    help="reload the npz and compare bit-for-bit")
    ap.add_argument("--platform", default="cpu",
                    help="jax platform for the restore (default cpu)")
    args = ap.parse_args(argv)

    if args.load:
        with np.load(args.load) as z:
            meta = json.loads(str(z["__meta__"]))
            print(json.dumps(meta, indent=1))
            total = 0
            for k in sorted(z.files):
                if k == "__meta__":
                    continue
                total += z[k].size
                print(f"{k:48s} {str(z[k].shape):16s} {z[k].dtype}")
            print(f"total params: {total:,}")
        return 0

    if not (args.save and args.output):
        raise SystemExit("need --save and --output (or --load)")

    from asr_study_tpu.utils.platform import select_platform

    select_platform(args.platform)
    from asr_study_tpu.cli.data_flow import parser_from_run
    from asr_study_tpu.cli.eval import load_run

    label_parser = parser_from_run(args.save)
    model, state, hp = load_run(
        args.save, label_parser, best=not args.latest
    )
    arrays = _flatten(state.params)
    meta = {
        "model": hp.get("model"),
        "params": hp.get("params"),
        "num_feats": hp.get("num_feats"),
        "num_classes": hp.get("num_classes"),
        "vocab": label_parser.vocab,
        "blank_id": model.blank_id,
        "source_run": args.save,
    }
    np.savez(args.output, __meta__=json.dumps(meta), **arrays)
    n = sum(a.size for a in arrays.values())
    print(f"exported {len(arrays)} arrays ({n:,} params) to {args.output}")

    if args.verify:
        with np.load(args.output) as z:
            for k, a in arrays.items():
                np.testing.assert_array_equal(z[k], a)
        print("verify: bit-exact round trip")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
