"""Shared CLI helpers: resolve --dataset into a DatasetIterator, and
reconstruct the exact training vocabulary for a dataset/run.

Supports both on-disk formats of the data layer: prebuilt feature datasets
(fast path, the make_dataset output) and JSON-lines manifests
(DatasetParser.to_json) with on-the-fly feature extraction.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from asr_study_tpu.data.generator import DatasetGenerator, DatasetIterator
from asr_study_tpu.text.parser import CharParser
from asr_study_tpu.utils.registry import get_from_module


def dataset_vocab(dataset: str) -> Optional[str]:
    """The vocabulary a dataset was built with (its splits' ``vocab``
    attr [ref: preprocessing/text.py — the reference hardcodes one
    alphabet; here the dataset is self-describing]).  None for JSON
    manifests (features and labels are parsed on the fly) or datasets
    predating the attr."""
    if dataset.endswith(".json") or dataset.endswith(".jsonl"):
        return None
    from asr_study_tpu.data.dataset_parser import dataset_splits, read_attrs

    for split in dataset_splits(dataset):
        v = read_attrs(dataset, split).get("vocab")
        if v is not None:
            return v
    return None


def parser_for_training(dataset: str, vocab_arg: Optional[str] = None
                        ) -> CharParser:
    """Label parser for a training run: the dataset's stored vocabulary
    is authoritative (its label ids were minted with it); an explicit
    --vocab must MATCH it — a mismatch would silently train against the
    wrong alphabet, which is exactly the bug this guards against."""
    from asr_study_tpu.text.parser import resolve_vocab

    stored = dataset_vocab(dataset)
    if vocab_arg:
        requested = resolve_vocab(vocab_arg)
        if stored is not None and requested != stored:
            raise SystemExit(
                f"--vocab {vocab_arg!r} resolves to {requested!r} but the "
                f"dataset was built with {stored!r}; rebuild the dataset "
                "or drop --vocab (the stored vocabulary is used "
                "automatically)"
            )
        return CharParser(requested)
    return CharParser(stored) if stored is not None else CharParser()


def parser_from_run(save_dir: str, dataset: Optional[str] = None
                    ) -> CharParser:
    """Label parser for eval/predict/export: the RUN's recorded vocabulary
    (meta.json hparams) is authoritative — it is the alphabet the model's
    classifier was trained over; falls back to the dataset's stored vocab,
    then the default."""
    meta_path = os.path.join(save_dir, "meta.json")
    vocab = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            vocab = json.load(f).get("hparams", {}).get("vocab")
    if vocab is None and dataset:
        vocab = dataset_vocab(dataset)
    return CharParser(vocab) if vocab else CharParser()


# raw-sample rows bucket like feature rows: 10240 samples = 64 frames of
# the default 10 ms hop, the feature datasets' 64-frame buckets (each
# bucket is a fresh compile of the whole train step, 20-40 s on an H100
# for the flagship model — 128 ms buckets minted one per batch)
RAW_GEN_KW = dict(time_multiple=10240, min_time=10240)


def device_featurizer_for(kind: str, params_json: Optional[str], it,
                          dataset: str, context: str):
    """Reconstruct the on-device feature chain for a raw-waveform
    iterator — ONE policy for train (``--device_features``) and eval
    (the run's recorded hparams), so the two can't drift: same raw-
    dataset guard, same JSON param parse."""
    if it.num_feats != 1:
        raise SystemExit(
            f"{context} needs a raw-waveform dataset "
            f"(make_dataset --input_parser raw); {dataset} stores "
            f"{it.num_feats}-dim features"
        )
    from asr_study_tpu.features.device import DeviceFeaturizer

    kw = json.loads(params_json) if params_json else {}
    return DeviceFeaturizer(kind=kind, **kw)


def flow_from_arg(
    gen: DatasetGenerator,
    dataset: str,
    split: str,
    label_parser,
    input_parser_name: str = "mfcc",
    input_params: Optional[str] = None,
) -> DatasetIterator:
    if dataset.endswith(".json") or dataset.endswith(".jsonl"):
        kw = json.loads(input_params) if input_params else {}
        feature = get_from_module("feature", input_parser_name)(**kw)
        return gen.flow_from_json(
            dataset, feature, label_parser, split=split
        )
    return gen.flow_from_h5(dataset, split)
