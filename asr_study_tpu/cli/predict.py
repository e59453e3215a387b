"""Prediction CLI [ref: predict.py]: wav file(s) -> transcript.

Example::

    python predict.py --save runs/exp1 --input_parser mfcc audio1.wav ...

Two serving paths:

- default: host (NumPy oracle) features, matching the reference's
  librosa-on-CPU behavior bit for bit — the parity path.
- ``--on_device``: the accelerator path — ALL batches' raw audio crosses
  to the device in one coalesced ragged int16 wire transfer (data/wire.py;
  optionally dpack-compressed), each batch is sliced out on device, and
  features, acoustic model, and decoding run inside ONE jitted program.
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np

from asr_study_tpu.ops import beam_search_decode, greedy_decode
from asr_study_tpu.utils.registry import get_from_module


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Transcribe wav files")
    p.add_argument("wavs", nargs="+", help="wav file paths")
    p.add_argument("--save", required=True, help="training run directory")
    p.add_argument("--input_parser", default=None,
                   help="feature extractor name (fbank|logfbank|mfcc); "
                        "default = the run's recorded --device_features "
                        "chain when present, else mfcc")
    p.add_argument("--input_params", default=None,
                   help='feature kwargs as JSON, e.g. \'{"d": true}\'')
    p.add_argument("--beam_width", type=int, default=0)
    p.add_argument("--lm", default=None,
                   help="char n-gram LM (.npz from train_lm) for "
                        "shallow fusion; needs --beam_width > 0")
    p.add_argument("--lm_alpha", type=float, default=0.8)
    p.add_argument("--lm_beta", type=float, default=0.0)
    p.add_argument("--best", action="store_true")
    p.add_argument("--on_device", action="store_true",
                   help="extract features on the accelerator (fused "
                        "wire->features->model->decode program)")
    p.add_argument("--batch_size", type=int, default=8,
                   help="utterances per device batch with --on_device")
    p.add_argument("--wire_codec", default="pcm16",
                   choices=("pcm16", "dpack", "mulaw", "auto"),
                   help="--on_device wire encoding: pcm16 (raw), dpack "
                        "(LOSSLESS delta+bit-packing, ~25% fewer bytes "
                        "on speech, bit-identical to pcm16), mulaw "
                        "(8-bit companded, lossy, half the bytes), or "
                        "auto (probe the link: dpack on network-speed "
                        "links where bytes dominate, pcm16 on locally "
                        "attached devices where the decode premium does)")
    p.add_argument("--stream", action="store_true",
                   help="chunked streaming decode with carried recurrent "
                        "state — unbounded-length audio at bounded memory "
                        "(unidirectional models only; asr_study_tpu/"
                        "streaming.py)")
    p.add_argument("--chunk_seconds", type=float, default=10.0,
                   help="audio chunk size for --stream")
    p.add_argument("--platform", default=None,
                   help="force a jax platform (cpu|gpu); default = env")
    return p


def _predict_streaming(args, model, state, feat_kw, label_parser, lm=None):
    from asr_study_tpu.features.wav import read_wav
    from asr_study_tpu.streaming import (
        MultiStreamRecognizer, StreamingRecognizer,
    )

    feature = get_from_module("feature", args.input_parser)(**feat_kw)
    step = max(1, int(args.chunk_seconds * feature.fs))

    def emit(path, ids):
        print(json.dumps({
            "file": path,
            "transcript": label_parser.imap(np.asarray(ids, np.int32)),
        }))

    if len(args.wavs) > 1 and args.beam_width == 0:
        # many files: decode them as CONCURRENT streams — one jitted
        # step per tick over the whole batch (the serving shape)
        wavs = [read_wav(p, sr=feature.fs)[0] for p in args.wavs]
        multi = MultiStreamRecognizer(
            model, state.params, feature, n_streams=len(wavs)
        )
        offs = [0] * len(wavs)
        while any(o < len(w) for o, w in zip(offs, wavs)):
            for i, w in enumerate(wavs):
                if offs[i] < len(w):
                    multi.push(i, w[offs[i]: offs[i] + step])
                    offs[i] += step
            multi.tick()
        for i, path in enumerate(args.wavs):
            emit(path, multi.finish(i))
        return

    for path in args.wavs:
        wav, _sr = read_wav(path, sr=feature.fs)
        rec = StreamingRecognizer(
            model, state.params, feature, beam_width=args.beam_width,
            lm=lm, lm_alpha=args.lm_alpha, lm_beta=args.lm_beta,
        )
        for lo in range(0, max(len(wav), 1), step):
            rec.push(wav[lo: lo + step])
        emit(path, rec.finish())


def _decode(logits, lengths, beam_width: int, blank_id: int,
            lm=None, lm_alpha: float = 1.0, lm_beta: float = 0.0):
    """Greedy or best-path beam decode (optional LM fusion); jit-safe."""
    if beam_width > 0:
        dec, lens, _ = beam_search_decode(
            logits, lengths, beam_width=beam_width, blank_id=blank_id,
            lm=lm, lm_alpha=lm_alpha, lm_beta=lm_beta,
        )
        return dec[:, 0], lens[:, 0]
    return greedy_decode(logits, lengths, blank_id=blank_id)


def _predict_on_device(args, model, state, feat_kw, lm=None):
    """Ragged wire -> device features -> model -> decode, one jit.

    The wire rides the same transport shape the headline bench measures:
    per-batch EXACT-size buffers coalesced into ONE host->device transfer,
    device-side slicing of each batch's static-[cap] window, and pooled
    output fetches.
    """
    from asr_study_tpu.data import wire
    from asr_study_tpu.features.device import DeviceFeaturizer
    from asr_study_tpu.features.wav import read_wav

    if args.wire_codec == "auto":
        import sys

        bw = wire.probe_link()
        args.wire_codec = wire.choose_codec(bw)
        print(
            f"wire_codec auto: measured link ~{bw:.0f} MB/s -> "
            f"{args.wire_codec}",
            file=sys.stderr,
        )

    # resample to the featurizer's rate, like the host/streaming paths —
    # a hard-coded 16 kHz here would silently mis-frame runs trained at
    # any other fs (the wire carries raw samples; the device featurizer
    # interprets them at ITS configured rate)
    fs = int(feat_kw.get("fs", 16000))
    wavs = [read_wav(p, sr=fs)[0] for p in args.wavs]
    batch = max(1, min(args.batch_size, len(wavs)))
    n_pad = -(-max(len(w) for w in wavs) // 2048) * 2048
    groups = [wavs[i: i + batch] for i in range(0, len(wavs), batch)]
    if args.wire_codec == "dpack":
        # ONE host encode per group feeds sizing AND packing (the encode
        # is the expensive host-side step this serving path exists to
        # minimize; it used to run 3x per group)
        encs = [wire.dpack_encode(g) for g in groups]
        scap = max(4096, max(
            -(-n // 4096) * 4096 for *_, n in encs
        ))
        caps = [
            -(-(2 * batch + scap // 4096 + payload.shape[0]) // 256) * 256
            for _, _, payload, _ in encs
        ]
        cap = max(caps)
        bufs = [
            wire.dpack_pack(g, c, scap, batch=batch, enc=e)
            for g, c, e in zip(groups, caps, encs)
        ]
    else:
        scap = None
        caps = [
            wire.wire_cap(batch, sum(len(w) for w in g), align=256,
                          codec=args.wire_codec)
            for g in groups
        ]
        cap = max(caps)
        bufs = [
            wire.pack_audio(g, c, batch=batch, codec=args.wire_codec)
            for g, c in zip(groups, caps)
        ]
    offs = np.cumsum([0] + caps[:-1])
    chunk = np.concatenate(bufs + [np.zeros(cap - caps[-1], np.int16)])

    featurizer = DeviceFeaturizer(kind=args.input_parser, **feat_kw)

    @jax.jit
    def serve(params, flat):
        w, lens = wire.unpack_audio(
            flat, batch, n_pad, codec=args.wire_codec, scap=scap
        )
        feats, feat_lengths = featurizer._transform(w, lens)
        logits = model.apply(params, feats, feat_lengths, train=False)
        return _decode(
            logits, feat_lengths, args.beam_width, model.blank_id,
            lm=lm, lm_alpha=args.lm_alpha, lm_beta=args.lm_beta,
        )

    @jax.jit
    def slice_group(chunk_flat, off):
        return jax.lax.dynamic_slice_in_dim(chunk_flat, off, cap)

    dev_chunk = jnp.asarray(chunk)      # ONE transfer for all batches
    outs = [serve(state.params, slice_group(dev_chunk, off)) for off in offs]

    # pooled fetches overlap the device->host copies
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(np.asarray, [a for pair in outs for a in pair]))
    dec = np.concatenate(got[0::2])[: len(wavs)]
    lens = np.concatenate(got[1::2])[: len(wavs)]
    return dec, lens


def main(argv=None) -> int:
    from asr_study_tpu.cli.eval import load_run  # avoids an import cycle
    from asr_study_tpu.utils.platform import (
        select_platform, setup_compilation_cache,
    )

    args = build_argparser().parse_args(argv)
    select_platform(args.platform)
    setup_compilation_cache()
    from asr_study_tpu.cli.data_flow import parser_from_run

    label_parser = parser_from_run(args.save)
    model, state, hp = load_run(args.save, label_parser, best=args.best)

    # runs trained with in-step on-device features (train.py
    # --device_features) record their feature chain in hparams; use it as
    # the default so plain `predict.py --save run wav...` transcribes with
    # the exact training features.  An explicit --input_parser wins, and
    # then the recorded params do NOT apply (they belong to the recorded
    # parser — one parser's kwargs would crash another's constructor).
    if args.input_parser is None:
        args.input_parser = hp.get("device_features") or "mfcc"
        if args.input_params is None and hp.get("device_features"):
            args.input_params = hp.get("device_feature_params")

    feat_kw = json.loads(args.input_params) if args.input_params else {}

    lm = None
    if args.lm:
        if args.beam_width <= 0:
            raise SystemExit("--lm requires --beam_width > 0")
        from asr_study_tpu.text.lm import CharNGramLM, check_lm_vocab

        lm = CharNGramLM.load(args.lm)
        check_lm_vocab(lm, label_parser.vocab)

    if args.stream:
        if args.on_device:
            raise SystemExit(
                "--stream is host-featurized decoding; it excludes "
                "--on_device"
            )
        _predict_streaming(args, model, state, feat_kw, label_parser, lm)
        return 0
    if args.on_device:
        dec, lens = _predict_on_device(args, model, state, feat_kw, lm)
    else:
        feature = get_from_module("feature", args.input_parser)(**feat_kw)
        feats = [feature(w).astype(np.float32) for w in args.wavs]
        t_max = max(f.shape[0] for f in feats)
        batch = np.zeros((len(feats), t_max, feats[0].shape[1]), np.float32)
        lengths = np.zeros((len(feats),), np.int32)
        for i, f in enumerate(feats):
            batch[i, : f.shape[0]] = f
            lengths[i] = f.shape[0]

        @jax.jit
        def serve(p, x, l):
            logits = model.apply(p, x, l, train=False)
            return _decode(logits, l, args.beam_width, model.blank_id,
                           lm=lm, lm_alpha=args.lm_alpha,
                           lm_beta=args.lm_beta)

        dec, lens = serve(state.params, batch, lengths)
    dec, lens = np.asarray(dec), np.asarray(lens)
    for i, path in enumerate(args.wavs):
        print(json.dumps(
            {"file": path, "transcript": label_parser.imap(dec[i, : lens[i]])}
        ))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
