"""Dataset build CLI [ref: extras/make_dataset.py]: corpus dir -> dataset.

Example::

    python make_dataset.py --parser lapsbm --dataset_dir /data/lapsbm \
        --output lapsbm --input_parser mfcc
"""

from __future__ import annotations

import argparse
import json

from asr_study_tpu.text.parser import CharParser
from asr_study_tpu.utils.registry import get_from_module


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Build a feature dataset")
    p.add_argument("--parser", required=True,
                   help="corpus name (lapsbm|voxforge|sid|cslu|brsd|dummy)")
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--output", required=True,
                   help="output path: a directory (packed layout) or an "
                        ".h5 file (vlen layout)")
    p.add_argument("--corpus_params", default=None,
                   help="corpus-parser kwargs as JSON, e.g. "
                        '\'{"n": 400, "seed": 1}\' for the synthetic '
                        "parsers (dummy, synthwords)")
    p.add_argument("--input_parser", default="mfcc")
    p.add_argument("--input_params", default=None,
                   help='feature kwargs as JSON, e.g. \'{"d": true, "dd": true}\'')
    p.add_argument("--to_json", default=None,
                   help="also write a JSON manifest to this path")
    p.add_argument("--device", action="store_true",
                   help="extract features on the accelerator in length-"
                        "bucketed batches (features/batch_extract.py) — "
                        "orders of magnitude faster than the host oracle "
                        "on real corpora; f32 chain, see parity note")
    p.add_argument("--device_batch", type=int, default=32,
                   help="utterances per device batch with --device")
    p.add_argument("--device_wire_codec", default="pcm16",
                   choices=("pcm16", "dpack"),
                   help="--device wire encoding: pcm16 (raw) or dpack "
                        "(lossless compression, ~25% fewer host->device "
                        "bytes on speech)")
    p.add_argument("--platform", default=None,
                   help="force a jax platform (cpu|gpu); default = env")
    p.add_argument("--vocab", default=None,
                   help="label vocabulary: preset name (pt_br, "
                        "pt_br_apostrophe) or literal characters "
                        "(default pt_br: a-z + space). Stored in the "
                        "dataset; train/eval/predict reconstruct it "
                        "automatically")
    p.add_argument("--layout", default="packed", choices=("vlen", "packed"),
                   help="'packed' (default: a directory of .npy arrays, "
                        "one contiguous duration-sorted [sum_T, F] matrix "
                        "+ offsets) or 'vlen' (the reference-compatible "
                        "HDF5 file, one vlen row per utterance; needs "
                        "h5py); see data/dataset_parser.py")
    return p

def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.platform:
        from asr_study_tpu.utils.platform import select_platform

        select_platform(args.platform)
    from asr_study_tpu.utils.platform import setup_compilation_cache

    # like every other CLI: --device extraction jits one program per
    # length bucket; the persistent cache makes rebuild reruns fast
    setup_compilation_cache()
    corpus_kw = json.loads(args.corpus_params) if args.corpus_params else {}
    corpus = get_from_module("corpus", args.parser)(
        args.dataset_dir, **corpus_kw
    )
    feat_kw = json.loads(args.input_params) if args.input_params else {}
    if args.device:
        from asr_study_tpu.features.batch_extract import (
            DeviceFeatureExtractor,
        )

        input_parser = DeviceFeatureExtractor(
            kind=args.input_parser, batch=args.device_batch,
            wire_codec=args.device_wire_codec, **feat_kw
        )
    else:
        input_parser = get_from_module(
            "feature", args.input_parser
        )(**feat_kw)
    from asr_study_tpu.text.parser import resolve_vocab

    label_parser = CharParser(resolve_vocab(args.vocab))
    if args.to_json:
        n = corpus.to_json(args.to_json)
        print(f"wrote {n} utterances to {args.to_json}")
    counts = corpus.to_h5(args.output, input_parser, label_parser,
                          layout=args.layout)
    print(f"wrote {counts} utterances to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
