"""Fit a character n-gram LM for beam-search shallow fusion.

Trains on a built dataset's transcripts (the usual flow: the same dataset
or JSON manifest the acoustic model trains on) or on plain-text lines, and
writes a dense ``.npz`` table consumed by ``eval.py --lm`` /
``predict.py --lm`` (text/lm.py).

Example::

    python -m asr_study_tpu.cli.train_lm --dataset data \
        --splits train valid --order 3 --output runs/lm3.npz
"""

from __future__ import annotations

import argparse
import json
import sys

from asr_study_tpu.text.lm import fit_ngram_lm
from asr_study_tpu.text.parser import CharParser


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Fit a char n-gram LM")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--dataset",
                     help="dataset path or .json manifest; transcripts "
                          "come from the chosen splits' labels")
    src.add_argument("--text",
                     help="plain text file, one sentence per line")
    p.add_argument("--splits", nargs="+", default=["train"],
                   help="dataset splits to fit on (default: train)")
    p.add_argument("--order", type=int, default=3,
                   help="n-gram order (context = order-1 chars)")
    p.add_argument("--delta", type=float, default=1.0,
                   help="interpolated add-delta smoothing strength")
    p.add_argument("--output", required=True, help="output .npz path")
    p.add_argument("--held_out", default=None,
                   help="optional split (with --dataset) or text file to "
                        "report perplexity on")
    return p


def _dataset_texts(path: str, splits, parser: CharParser):
    """Transcripts from a built dataset, as id sequences."""
    if path.endswith(".json") or path.endswith(".jsonl"):
        # JSON-lines manifest (the DatasetParser.to_json format, same as
        # flow_from_json): one utterance per line, missing 'split'
        # fields count as 'train'
        wanted = set(splits)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                entry = json.loads(line)
                if (entry.get("split", "train") in wanted
                        and parser.is_valid(entry["label"])):
                    yield parser(entry["label"])
        return
    from asr_study_tpu.data.dataset_parser import dataset_splits, read_h5_meta

    have = dataset_splits(path)
    for split in splits:
        if split not in have:
            raise SystemExit(
                f"split '{split}' not in {path} (has: {', '.join(have)})"
            )
        for t in read_h5_meta(path, split)[2]:
            yield parser(t)


def _text_file_ids(path: str, parser: CharParser):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and parser.is_valid(line):
                yield parser(line)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.dataset:
        # the dataset's stored vocabulary (its label ids were minted with
        # it); an LM over a different alphabet would mis-score every beam
        from asr_study_tpu.cli.data_flow import dataset_vocab

        stored = dataset_vocab(args.dataset)
        parser = CharParser(stored) if stored is not None else CharParser()
    else:
        parser = CharParser()
    if args.dataset:
        seqs = list(_dataset_texts(args.dataset, args.splits, parser))
    else:
        seqs = list(_text_file_ids(args.text, parser))
    if not seqs:
        raise SystemExit("no transcripts found to fit on")
    lm = fit_ngram_lm(
        seqs, order=args.order, n_char=parser.num_classes,
        space_id=parser.char_to_id[" "], delta=args.delta,
        vocab=parser.vocab,
    )
    lm.save(args.output)
    report = {
        "output": args.output,
        "order": args.order,
        "num_sequences": len(seqs),
        "num_chars": int(sum(len(s) for s in seqs)),
        "train_perplexity": lm.perplexity(seqs),
    }
    if args.held_out:
        if args.dataset:
            held = list(
                _dataset_texts(args.dataset, [args.held_out], parser)
            )
        else:
            held = list(_text_file_ids(args.held_out, parser))
        if held:
            report["held_out_perplexity"] = lm.perplexity(held)
        else:
            print("warning: empty held-out set", file=sys.stderr)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
