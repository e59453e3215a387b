"""Corpus ingestion base class + on-disk dataset formats.

Mirrors the reference's ``DatasetParser`` ABC [ref: datasets/dataset_parser.py]:
subclasses implement ``_iter()`` yielding utterance dicts
``{audio, label, speaker, duration, split?}``; the base class serializes to a
JSON manifest and/or a feature dataset with one entry per split
(train/valid/test) — the format the batch generator streams.

Packed layout (``layout="packed"``, make_dataset's default): a DIRECTORY of NumPy
arrays, one subdirectory per split, rows written back to back in
duration-sorted order:
    inputs_flat.npy    float32 [sum_T, F]  all rows, frame-contiguous
    offsets.npy        int64 [N + 1]       row i is inputs_flat[offsets[i]:offsets[i+1]]
    shapes.npy         int32 [N, 2]        (T, F) per row
    labels_flat.npy    int32 [sum_L]       label id sequences, back to back
    label_offsets.npy  int64 [N + 1]
    durations.npy      float32 [N]         seconds
    meta.json          {"texts": [...], "attrs": {num_feats, feature, vocab, layout}}
It needs nothing beyond NumPy; ``inputs_flat`` is memory-mapped for
larger-than-memory streaming, where a duration-sorted batch is a handful
of contiguous reads (usually ONE — the generator's stable length sort
reproduces file order).

Vlen layout (``layout="vlen"``): the reference-compatible HDF5 file (needs
``h5py``), one group per split holding
    inputs     vlen float32   flattened [T*F] feature rows
    shapes     int32 [N, 2]   (T, F) per row
    labels     vlen int32     label id sequences
    texts      vlen utf-8     normalized transcripts
    durations  float32 [N]    seconds
  group attrs: num_feats, feature (repr), vocab, layout

Readers tell the two apart by the path: a directory is a packed dataset, a
file is HDF5.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from asr_study_tpu.features.audio import Feature
from asr_study_tpu.features.wav import read_wav
from asr_study_tpu.text.parser import CharParser

log = logging.getLogger(__name__)

SPLITS = ("train", "valid", "test")


class DatasetParser:
    """Walks a corpus directory and yields utterance dicts.

    Subclasses set ``name`` and implement ``_iter()``.  An utterance dict has
    keys: ``audio`` (wav path), ``label`` (transcript string), ``speaker``
    (id string), and optionally ``duration`` (seconds) and ``split``.
    """

    name = "base"
    default_split: Optional[Callable[[dict], str]] = None

    def __init__(self, dataset_dir: str):
        self.dataset_dir = dataset_dir

    def _iter(self) -> Iterator[dict]:
        raise NotImplementedError

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _duration(wav_path: str) -> float:
        sig, sr = read_wav(wav_path, sr=None)
        return len(sig) / float(sr)

    def iter_utterances(self, with_duration: bool = True) -> Iterator[dict]:
        for utt in self._iter():
            if with_duration and "duration" not in utt:
                try:
                    utt["duration"] = self._duration(utt["audio"])
                except Exception as exc:  # unreadable file: skip, don't die
                    log.warning("skipping %s: %s", utt.get("audio"), exc)
                    continue
            yield utt

    # -- export --------------------------------------------------------------

    def to_json(self, json_path: str) -> int:
        """Write a JSON-lines manifest; returns the utterance count."""
        os.makedirs(os.path.dirname(os.path.abspath(json_path)), exist_ok=True)
        n = 0
        with open(json_path, "w") as f:
            for utt in self.iter_utterances():
                f.write(json.dumps(utt) + "\n")
                n += 1
        return n

    def to_h5(
        self,
        h5_path: str,
        input_parser: Feature,
        label_parser: Optional[CharParser] = None,
        split_fn: Optional[Callable[[dict], str]] = None,
        min_duration: float = 0.0,
        max_duration: float = float("inf"),
        layout: str = "vlen",
    ) -> Dict[str, int]:
        """Extract features for every utterance and write the dataset
        (a packed directory or, with ``layout="vlen"``, an HDF5 file).

        ``split_fn(utt) -> 'train'|'valid'|'test'`` assigns splits; defaults to
        the utterance's own ``split`` key, the subclass's ``default_split``,
        then 'train'.
        """
        label_parser = label_parser or CharParser()
        rows: Dict[str, List[dict]] = {s: [] for s in SPLITS}
        for utt in self.iter_utterances():
            dur = utt.get("duration", 0.0)
            if not (min_duration <= dur <= max_duration):
                continue
            if not label_parser.is_valid(utt["label"]):
                log.warning("invalid transcript, skipping: %r", utt["label"])
                continue
            split = utt.get("split")
            if split is None and split_fn is not None:
                split = split_fn(utt)
            if split is None and self.default_split is not None:
                split = self.default_split(utt)
            rows[split or "train"].append(utt)

        write_h5(h5_path, rows, input_parser, label_parser, layout=layout)
        return {split: len(utts) for split, utts in rows.items() if utts}

    def __str__(self) -> str:
        return self.name


_STORE_MARK = "dataset.json"   # top-level marker of a packed dataset


def _is_store(path: str) -> bool:
    return os.path.isdir(path)


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "the vlen layout is an HDF5 file and needs h5py; build a "
            "packed dataset instead (make_dataset --layout packed)"
        ) from e
    return h5py


class _VlenInputWriter:
    """Reference-compatible layout: one vlen float32 row per utterance."""

    def __init__(self, grp, n: int):
        h5py = _h5py()
        vlen_f32 = h5py.special_dtype(vlen=np.dtype("float32"))
        self._dset = grp.create_dataset("inputs", (n,), dtype=vlen_f32)

    def add(self, i: int, feats: np.ndarray) -> None:
        self._dset[i] = feats.reshape(-1)

    def finish(self) -> None:
        pass


class _PackedInputWriter:
    """Packed layout: rows appended back to back into ``inputs_flat.npy``
    with an ``offsets.npy`` index.  Total frames are unknown until every
    feature is extracted, so the rows stream to disk behind a header
    written for zero rows, which ``finish`` rewrites in place with the
    final row count (a .npy header is padded to a fixed 64-byte multiple,
    so both headers have the same length)."""

    def __init__(self, directory: str, n: int):
        self._path = os.path.join(directory, "inputs_flat.npy")
        self._file = open(self._path, "wb")
        self._offsets = np.zeros((n + 1,), np.int64)
        self._count = 0
        self._f_dim = None
        self._header_len = None

    def _write_header(self, rows: int) -> int:
        self._file.seek(0)
        np.lib.format.write_array_header_1_0(self._file, {
            "descr": np.lib.format.dtype_to_descr(np.dtype(np.float32)),
            "fortran_order": False,
            "shape": (rows, self._f_dim),
        })
        return self._file.tell()

    def add(self, i: int, feats: np.ndarray) -> None:
        assert i == self._count, "packed layout requires sequential writes"
        t, f_dim = feats.shape
        if self._f_dim is None:
            self._f_dim = f_dim
            self._header_len = self._write_header(0)
        self._file.write(np.ascontiguousarray(feats, np.float32).tobytes())
        self._offsets[i + 1] = self._offsets[i] + t
        self._count += 1

    def finish(self) -> np.ndarray:
        """Close the feature file; -> the [N + 1] frame offsets."""
        if self._f_dim is None:
            self._file.close()
            np.save(self._path, np.zeros((0, 0), np.float32))
        else:
            rows = int(self._offsets[self._count])
            if self._write_header(rows) != self._header_len:
                raise RuntimeError("npy header changed length")
            self._file.close()
        return self._offsets[: self._count + 1]


def write_split(dest, utts, input_parser, label_parser,
                chunk: int = 256, layout: str = "vlen") -> None:
    """Extract and write one split.  ``dest``: the split's directory for
    the packed layout, an open HDF5 group for the vlen layout."""
    if layout not in ("vlen", "packed"):
        raise ValueError(f"layout must be 'vlen' or 'packed', got {layout!r}")
    if layout == "packed":
        # duration order makes the generator's stable length sort the
        # identity permutation -> every batch is one contiguous read
        utts = sorted(utts, key=lambda u: float(u.get("duration", 0.0)))
        os.makedirs(dest, exist_ok=True)
        d_inputs = _PackedInputWriter(dest, len(utts))
    else:
        d_inputs = _VlenInputWriter(dest, len(utts))
    n = len(utts)
    shapes = np.zeros((n, 2), np.int32)
    labels: List[np.ndarray] = []
    texts: List[str] = []
    durations = np.zeros((n,), np.float32)
    num_feats = None
    # batched accelerator extraction (features/batch_extract.py) goes
    # ``chunk`` utterances at a time, bounding host RAM on big corpora;
    # host Feature parsers keep the one-at-a-time reference flow
    batched = hasattr(input_parser, "extract_batch")
    step = chunk if batched else max(n, 1)
    for c0 in range(0, n, step):
        group = utts[c0: c0 + step]
        feats_list = (
            input_parser.extract_batch([u["audio"] for u in group])
            if batched else None
        )
        for j, utt in enumerate(group):
            i = c0 + j
            feats = (
                feats_list[j] if feats_list is not None
                else input_parser(utt["audio"])
            )
            num_feats = feats.shape[1]
            text = label_parser._clean(utt["label"])
            d_inputs.add(i, np.asarray(feats, np.float32))
            shapes[i] = feats.shape
            labels.append(np.asarray(label_parser.map(text), np.int32))
            texts.append(text)
            durations[i] = utt.get("duration", 0.0)
    offsets = d_inputs.finish()
    attrs = {
        "num_feats": int(num_feats or 0),
        "feature": str(input_parser),
        "vocab": label_parser.vocab,
        "layout": layout,
    }
    if layout == "packed":
        lens = np.array([len(l) for l in labels], np.int64)
        np.save(os.path.join(dest, "offsets.npy"), offsets)
        np.save(os.path.join(dest, "shapes.npy"), shapes)
        np.save(os.path.join(dest, "labels_flat.npy"),
                np.concatenate(labels) if labels else np.zeros(0, np.int32))
        np.save(os.path.join(dest, "label_offsets.npy"),
                np.concatenate([[0], np.cumsum(lens)]).astype(np.int64))
        np.save(os.path.join(dest, "durations.npy"), durations)
        with open(os.path.join(dest, "meta.json"), "w") as f:
            json.dump({"texts": texts, "attrs": attrs}, f)
        return
    h5py = _h5py()
    dest.create_dataset("shapes", data=shapes)
    d_labels = dest.create_dataset(
        "labels", (n,), dtype=h5py.special_dtype(vlen=np.dtype("int32"))
    )
    for i, lab in enumerate(labels):
        d_labels[i] = lab
    dest.create_dataset("texts", data=texts,
                        dtype=h5py.string_dtype(encoding="utf-8"))
    dest.create_dataset("durations", data=durations)
    dest.attrs.update(attrs)


def write_h5(h5_path, split_rows, input_parser, label_parser,
             layout: str = "vlen") -> None:
    """Write pre-collected ``{split: [utt, ...]}`` rows as a dataset at
    ``h5_path``, replacing any dataset already there."""
    if layout not in ("vlen", "packed"):
        raise ValueError(f"layout must be 'vlen' or 'packed', got {layout!r}")
    if _is_store(h5_path):
        if not os.path.exists(os.path.join(h5_path, _STORE_MARK)):
            raise FileExistsError(
                f"{h5_path} is a directory but not a packed dataset; "
                "refusing to overwrite it"
            )
        shutil.rmtree(h5_path)
    if layout == "vlen":
        with _h5py().File(h5_path, "w") as f:
            for split, utts in split_rows.items():
                if utts:
                    write_split(f.create_group(split), utts, input_parser,
                                label_parser, layout=layout)
        return
    if os.path.exists(h5_path):
        os.remove(h5_path)
    os.makedirs(h5_path)
    splits = [s for s, utts in split_rows.items() if utts]
    for split in splits:
        write_split(os.path.join(h5_path, split), split_rows[split],
                    input_parser, label_parser, layout=layout)
    with open(os.path.join(h5_path, _STORE_MARK), "w") as f:
        json.dump({"layout": "packed", "splits": splits}, f)


def dataset_splits(h5_path: str) -> List[str]:
    """The split names a dataset holds."""
    if _is_store(h5_path):
        with open(os.path.join(h5_path, _STORE_MARK)) as f:
            return list(json.load(f)["splits"])
    with _h5py().File(h5_path, "r") as f:
        return list(f)


def read_attrs(h5_path: str, split: str) -> dict:
    """One split's attributes: num_feats, feature, vocab, layout."""
    if _is_store(h5_path):
        return _store_meta(h5_path, split)["attrs"]
    with _h5py().File(h5_path, "r") as f:
        return {
            k: (v.decode() if isinstance(v, bytes) else v)
            for k, v in _split_group(f, h5_path, split).attrs.items()
        }


def _store_dir(h5_path: str, split: str) -> str:
    d = os.path.join(h5_path, split)
    if not os.path.isdir(d):
        raise KeyError(
            f"{h5_path} has no split {split!r}; has {dataset_splits(h5_path)}"
        )
    return d


def _store_meta(h5_path: str, split: str) -> dict:
    with open(os.path.join(_store_dir(h5_path, split), "meta.json")) as f:
        return json.load(f)


def _store_array(h5_path: str, split: str, name: str, mmap: bool = False):
    return np.load(os.path.join(_store_dir(h5_path, split), f"{name}.npy"),
                   mmap_mode="r" if mmap else None)


def read_h5_inputs(h5_path: str, split: str, shapes):
    """Load only the feature rows of a split (either layout) as a list of
    [T, F] float32 arrays; ``shapes`` comes from ``read_h5_meta``."""
    if _is_store(h5_path):
        flat = _store_array(h5_path, split, "inputs_flat")
        offs = _store_array(h5_path, split, "offsets")
        return [flat[offs[i]: offs[i + 1]] for i in range(len(shapes))]
    with _h5py().File(h5_path, "r") as f:
        grp = _split_group(f, h5_path, split)
        return [x.reshape(tuple(s)) for x, s in zip(grp["inputs"][:], shapes)]


def read_h5(h5_path: str, split: str):
    """Load one split into memory:
    -> (list[np.ndarray [T,F]], list[np.ndarray [L]], list[str], np.ndarray [N])."""
    shapes, labels, texts, durations = read_h5_meta(h5_path, split)
    return read_h5_inputs(h5_path, split, shapes), labels, texts, durations


def _split_group(f, h5_path: str, split: str):
    if split not in f:
        raise KeyError(f"{h5_path} has no split {split!r}; has {list(f)}")
    return f[split]


def read_h5_meta(h5_path: str, split: str):
    """Load only the small per-utterance metadata of a split (shapes,
    labels, texts, durations) — the lazy-streaming fast path that leaves
    the feature payload on disk."""
    if _is_store(h5_path):
        texts = _store_meta(h5_path, split)["texts"]
        flat = _store_array(h5_path, split, "labels_flat")
        offs = _store_array(h5_path, split, "label_offsets")
        labels = [flat[offs[i]: offs[i + 1]] for i in range(len(texts))]
        return (_store_array(h5_path, split, "shapes"), labels, texts,
                _store_array(h5_path, split, "durations"))
    with _h5py().File(h5_path, "r") as f:
        grp = _split_group(f, h5_path, split)
        shapes = grp["shapes"][:]
        labels = [np.asarray(l, dtype=np.int32) for l in grp["labels"][:]]
        texts = [
            t.decode("utf-8") if isinstance(t, bytes) else str(t)
            for t in grp["texts"][:]
        ]
        durations = grp["durations"][:]
    return shapes, labels, texts, durations


class H5FeatureRows:
    """Lazy per-row access to one split's feature rows (either layout).

    Streams corpora larger than host memory: only the [N, 2] shapes table
    lives in RAM; feature rows are read per batch (a memory-mapped slice
    of the packed matrix, or one ascending-index h5py read of vlen rows)
    and packed via the C++ ``asr_pack_batch`` when the native lib is
    available.

    Thread-safe: the prefetch worker thread and the main thread may both
    read; a lock serializes access to the shared h5py handle (h5py is not
    concurrency-safe on one handle).
    """

    def __init__(self, h5_path: str, split: str, shapes=None):
        self.h5_path = h5_path
        self.split = split
        self._offsets = None  # packed layout: int64 [N+1] frame offsets
        if shapes is None:
            shapes = read_h5_meta(h5_path, split)[0]
        if _is_store(h5_path):
            self._offsets = _store_array(h5_path, split, "offsets")
        self.shapes = shapes
        self._lock = threading.Lock()
        self._file = None
        self._dset = None

    def __len__(self) -> int:
        return len(self.shapes)

    def row_length(self, i: int) -> int:
        return int(self.shapes[i, 0])

    @property
    def num_feats(self) -> int:
        return int(self.shapes[0, 1]) if len(self.shapes) else 0

    @property
    def nbytes(self) -> int:
        """Total feature payload (float32 bytes) if fully materialized."""
        return int(np.sum(self.shapes[:, 0].astype(np.int64)
                          * self.shapes[:, 1]) * 4)

    def _rows(self):
        if self._dset is None:
            if self._offsets is not None:
                self._dset = _store_array(
                    self.h5_path, self.split, "inputs_flat", mmap=True
                )
            else:
                self._file = _h5py().File(self.h5_path, "r")
                self._dset = self._file[self.split]["inputs"]
        return self._dset

    def __getitem__(self, i: int) -> np.ndarray:
        i = int(i)
        with self._lock:
            dset = self._rows()
            if self._offsets is not None:
                return np.asarray(
                    dset[self._offsets[i]: self._offsets[i + 1]]
                )
            row = dset[i]
        return row.reshape(tuple(self.shapes[i]))

    def _read_rows(self, sidx: np.ndarray):
        """Read rows at ascending indices ``sidx`` -> list of [T, F] arrays.
        Caller holds the lock.  Packed layout coalesces consecutive indices
        into single contiguous reads (the common case — the generator's
        duration-sorted batches — is ONE read per batch)."""
        dset = self._rows()
        if self._offsets is None:
            f_dim = int(self.shapes[0, 1])
            return [r.reshape(-1, f_dim) for r in dset[sidx.tolist()]]
        offs = self._offsets
        rows = []
        start = 0
        while start < len(sidx):
            end = start
            while end + 1 < len(sidx) and sidx[end + 1] == sidx[end] + 1:
                end += 1
            a, b = int(sidx[start]), int(sidx[end])
            run = np.asarray(dset[offs[a]: offs[b + 1]])
            base = offs[a]
            for k in range(start, end + 1):
                i = int(sidx[k])
                rows.append(run[offs[i] - base: offs[i + 1] - base])
            start = end + 1
        return rows

    def pack_into(self, idx, out: np.ndarray) -> None:
        """Read rows ``idx`` and pack them into ``out`` [B, t_pad, F] with
        one disk read for the whole batch (a few for a multi-run packed
        batch).  Fully defines ``out`` — padded tails and rows beyond
        ``len(idx)`` are zeroed, so callers may pass an uninitialized
        buffer.  Uses the native C++ packer when available."""
        idx = np.asarray(idx, np.int64)
        lens = self.shapes[idx, 0].astype(np.int64)
        t_pad = out.shape[1]
        from asr_study_tpu.utils import native

        # packed layout, one contiguous index run (the duration-sorted
        # generator's common case): ONE read, packed straight into
        # ``out`` with no intermediate concatenate/copy
        sidx = np.sort(idx)
        if (
            self._offsets is not None and len(idx)
            and sidx[-1] - sidx[0] == len(sidx) - 1
            and len(np.unique(sidx)) == len(sidx)
        ):
            offs = self._offsets
            base = offs[int(sidx[0])]
            with self._lock:
                src = np.asarray(
                    self._rows()[base: offs[int(sidx[-1]) + 1]]
                )
            if native.pack_batch_into(src, offs[idx] - base, lens, out):
                return
            out[:] = 0  # native unavailable: row views from the one read
            for j, i in enumerate(idx):
                t = min(int(lens[j]), t_pad)
                o = offs[i] - base
                out[j, :t] = src[o: o + t]
            return

        order = np.argsort(idx, kind="stable")   # h5py wants ascending
        with self._lock:
            rows = self._read_rows(idx[order])
        flat = [None] * len(idx)
        for pos, row in zip(order, rows):
            flat[pos] = row
        packed = native.pack_batch(flat, t_pad)
        if packed is not None:
            out[: len(idx)] = packed
            out[len(idx):] = 0
        else:
            out[:] = 0
            for j, row in enumerate(flat):
                t = min(int(lens[j]), t_pad)
                out[j, :t] = row[:t]

    def close(self):
        with self._lock:
            if self._file is not None:
                self._file.close()
            self._file = self._dset = None

    def __del__(self):
        # iterators never close their row source explicitly; release the
        # file handle when the last reference drops
        try:
            self.close()
        except Exception:
            pass
