#!/usr/bin/env python
"""Device-time breakdown of the main path from one ``jax.profiler`` trace.

    python benchmarks/trace_breakdown.py [--out runs/trace]

Two cells at the benchmarks' shapes:

- inference (bench.py): B=32 LapsBM-like utterances of 3-8 s on the dpack
  wire -> unpack -> mfcc+d+dd featurizer -> 2 x 256 BLSTM forward ->
  greedy decode, and a beam-16 decode of the same logits;
- training (benchmarks/bench_train.py): deep_blstm 3 x 256, B=32, T=512
  frames of 39 features, 48 labels: the recurrence forward, forward +
  backward, CTC loss + gradient, and the whole train step.

Each stage is its own jitted function (``stage_*``), called ``--calls``
times inside the trace with a wait after each call, so its device time
is the sum of the durations of the device events whose ``hlo_module`` is
``jit_stage_*``, divided by the calls.  Two end-to-end windows give the
idle share: the inference round of bench.py (8 batches dispatched,
outputs fetched) and 3 chained train steps.  Each is timed with the
profiler off (min of 3), and ``idle_share_untraced`` is 1 - (device time
of its programs in the trace) / (that wall).  Inside the trace the
windows are marked by host ``TraceAnnotation`` spans, and ``idle_share``
is 1 - (union of device event intervals) / (span); tracing slows the
host that launches the kernels, so that one reads high.

Prints one JSON line; writes it, and a description of the trace's planes
for checking the attribution by hand, to ``--out``/breakdown.json (the
raw trace only with ``--keep_trace``).  Needs a GPU
(``--platform cpu`` runs it on the CPU for testing; its numbers then say
nothing about a device).
"""

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402


def _union_ns(intervals, lo, hi):
    """Total length of the union of [start, end) intervals clipped to
    [lo, hi)."""
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def reduce_trace(path: str, calls: dict, windows=("e2e_inference",
                                                  "e2e_train")):
    """-> (per-stage device ms per call, window idle shares, plane
    description) from one .xplane.pb.  ``calls`` maps stage name -> calls
    made inside the trace."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    per_module, device_events, spans, desc = {}, [], {}, []
    for plane in pd.planes:
        lines = list(plane.lines)
        desc.append({"plane": plane.name,
                     "lines": [l.name for l in lines][:20]})
        is_device = plane.name.startswith("/device:")
        for line in lines:
            for ev in line.events:
                stats = dict(ev.stats)
                module = stats.get("hlo_module")
                if ev.name in windows:
                    spans.setdefault(ev.name, []).append(
                        (ev.start_ns, ev.end_ns))
                if module is None:
                    continue
                # on a GPU the kernels live on the device plane's stream
                # lines; on the CPU the XLA ops run on host threads
                if is_device or plane.name == "/host:CPU":
                    per_module[module] = (per_module.get(module, 0.0)
                                          + ev.duration_ns)
                    device_events.append((ev.start_ns, ev.end_ns))
    stages = {
        name: per_module.get(f"jit_stage_{name}", 0.0) / n / 1e6
        for name, n in calls.items()
    }
    idle = {}
    for name, sp in spans.items():
        lo, hi = min(s for s, _ in sp), max(e for _, e in sp)
        idle[name] = {
            "window_ms": (hi - lo) / 1e6,
            "idle_share": 1.0 - _union_ns(device_events, lo, hi) / (hi - lo),
        }
    return stages, idle, {"planes": desc,
                          "modules_ms": {k: v / 1e6
                                         for k, v in per_module.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="runs/trace")
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--small", action="store_true",
                    help="tiny shapes (CPU test of the code path)")
    ap.add_argument("--keep_trace", action="store_true",
                    help="keep the raw .xplane.pb under --out")
    args = ap.parse_args(argv)
    if args.platform:
        from asr_study_tpu.utils.platform import select_platform

        select_platform(args.platform)
    device = jax.devices()[0]
    if device.platform == "cpu" and not args.platform:
        print("trace_breakdown.py needs an accelerator; --platform cpu "
              "runs it on the CPU", file=sys.stderr)
        return 1
    from asr_study_tpu.data import wire
    from asr_study_tpu.features.device import DeviceFeaturizer
    from asr_study_tpu.models.zoo import build_model
    from asr_study_tpu.ops import beam_search_decode, greedy_decode
    from asr_study_tpu.ops.ctc import ctc_loss
    from asr_study_tpu.train.trainer import Trainer, make_optimizer
    from asr_study_tpu.utils.platform import (
        card_name_and_power_limit, setup_compilation_cache,
    )

    setup_compilation_cache()
    small = args.small
    b = 4 if small else 32
    hid, t_train, n_lab = (16, 32, 4) if small else (256, 512, 48)
    seconds = (0.5, 1.0) if small else (3.0, 8.0)
    rng = np.random.default_rng(0)

    # -- inference cell inputs (bench.py shapes) -----------------------------
    n_pad = int(seconds[1] * 16000 + 2048) // 2048 * 2048
    batches = []
    for _ in range(2 if small else 8):
        wavs = []
        for d in rng.uniform(*seconds, size=b):
            n = int(d * 16000)
            t = np.arange(n) / 16000.0
            f0 = rng.uniform(80, 250)
            sig = sum(np.sin(2 * np.pi * f0 * (k + 1) * t) / (k + 1)
                      for k in range(4)) + 0.1 * rng.standard_normal(n)
            wavs.append((sig / np.abs(sig).max() * 0.5).astype(np.float32))
        batches.append(wavs)
    cap, scap = wire.dpack_measure(batches, b)
    flats = [jnp.asarray(wire.pack_audio(w, cap, batch=b, codec="dpack",
                                         scap=scap)) for w in batches]
    featurizer = DeviceFeaturizer(kind="mfcc", d=True, dd=True)
    infer_model = build_model("deep_blstm", {"num_hiddens": hid,
                                             "num_layers": 2,
                                             "dropout": 0.0}, num_classes=27)
    infer_params = infer_model.init(jax.random.PRNGKey(0), 39)

    def stage_unpack(flat):
        return wire.unpack_audio(flat, b, n_pad, codec="dpack", scap=scap)

    def stage_featurizer(wavs, lens):
        return featurizer._transform(wavs, lens)

    def stage_recurrence_infer(params, feats, lens):
        return infer_model.apply(params, feats, lens, train=False)

    def stage_greedy(logits, lens):
        return greedy_decode(logits, lens)

    def stage_beam16(logits, lens):
        return beam_search_decode(logits, lens, beam_width=16)[:2]

    def stage_pipeline(params, flat):
        w, l = stage_unpack(flat)
        f, fl = stage_featurizer(w, l)
        return stage_greedy(stage_recurrence_infer(params, f, fl), fl)

    # -- training cell inputs (bench_train.py shapes) ------------------------
    train_model = build_model("deep_blstm", {"num_hiddens": hid,
                                             "num_layers": 3,
                                             "dropout": 0.0}, num_classes=27)
    trainer = Trainer(train_model, make_optimizer("adam", 1e-4, 400.0),
                      donate_state=False)
    state = trainer.init_state(jax.random.PRNGKey(0), 39)
    x = jnp.asarray(rng.standard_normal((b, t_train, 39)), jnp.float32)
    x_lens = jnp.full((b,), t_train, jnp.int32)
    labels = jnp.asarray(rng.integers(0, 27, (b, n_lab)), jnp.int32)
    label_lens = jnp.full((b,), n_lab, jnp.int32)
    weights = jnp.ones((b,), jnp.float32)
    cot = jnp.asarray(rng.standard_normal((b, t_train, 28)), jnp.float32)

    def stage_recurrence_fwd(params, x, lens):
        return train_model.apply(params, x, lens, train=False)

    def stage_recurrence_fwd_bwd(params, x, lens):
        return jax.grad(lambda p: jnp.sum(
            train_model.apply(p, x, lens, train=False) * cot))(params)

    def stage_ctc(logits, lens, labels, label_lens):
        return jax.value_and_grad(lambda z: jnp.mean(
            ctc_loss(z, lens, labels, label_lens)))(logits)

    def stage_train_step(state, key):
        return trainer._train_step(state, x, x_lens, labels, label_lens,
                                   weights, key)

    fns = {f.__name__[len("stage_"):]: jax.jit(f) for f in (
        stage_unpack, stage_featurizer, stage_recurrence_infer,
        stage_greedy, stage_beam16, stage_pipeline, stage_recurrence_fwd,
        stage_recurrence_fwd_bwd, stage_ctc, stage_train_step)}
    key = jax.random.PRNGKey(1)
    wv, wl = fns["unpack"](flats[0])
    feats, fl = fns["featurizer"](wv, wl)
    logits = fns["recurrence_infer"](infer_params, feats, fl)
    t_logits = fns["recurrence_fwd"](state.params, x, x_lens)
    args_of = {
        "unpack": (flats[0],), "featurizer": (wv, wl),
        "recurrence_infer": (infer_params, feats, fl),
        "greedy": (logits, fl), "beam16": (logits, fl),
        "pipeline": (infer_params, flats[0]),
        "recurrence_fwd": (state.params, x, x_lens),
        "recurrence_fwd_bwd": (state.params, x, x_lens),
        "ctc": (t_logits, x_lens, labels, label_lens),
        "train_step": (state, key),
    }
    t0 = time.perf_counter()
    for name, fn in fns.items():               # compile + warm every stage
        jax.block_until_ready(fn(*args_of[name]))
    compile_s = time.perf_counter() - t0

    n_chain = 3

    def e2e_inference():
        outs = [fns["pipeline"](infer_params, f) for f in flats]
        [np.asarray(a) for pair in outs for a in pair]

    def e2e_train():
        s = state
        for _ in range(n_chain):
            s, m = fns["train_step"](s, key)
        jax.block_until_ready(m["loss"])

    # the windows' walls with the profiler off: tracing thousands of
    # small kernels per step slows the host that launches them
    walls = {}
    for name, fn in (("e2e_inference", e2e_inference),
                     ("e2e_train", e2e_train)):
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            runs.append(time.perf_counter() - t0)
        walls[name] = min(runs) * 1e3

    os.makedirs(args.out, exist_ok=True)
    trace_dir = os.path.join(args.out, "xplane")
    jax.profiler.start_trace(trace_dir)
    for name, fn in fns.items():
        for _ in range(args.calls):
            jax.block_until_ready(fn(*args_of[name]))
    with jax.profiler.TraceAnnotation("e2e_inference"):
        e2e_inference()
    with jax.profiler.TraceAnnotation("e2e_train"):
        e2e_train()
    jax.profiler.stop_trace()

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    calls = {name: args.calls for name in fns}
    calls["pipeline"] += len(flats)
    calls["train_step"] += n_chain
    stages, idle, desc = reduce_trace(path, calls)
    stages["recurrence_bwd"] = (stages["recurrence_fwd_bwd"]
                                - stages["recurrence_fwd"])
    # device time of each window's programs over its untraced wall
    busy = {"e2e_inference": len(flats) * stages["pipeline"],
            "e2e_train": n_chain * stages["train_step"]}
    for name, wall in walls.items():
        idle.setdefault(name, {}).update({
            "wall_ms_untraced": wall,
            "device_ms": busy[name],
            "idle_share_untraced": 1.0 - busy[name] / wall,
        })
    rec = {
        "metric": "device_ms_per_call",
        "stages": stages,
        "windows": idle,
        "calls": calls,
        "compile_s": compile_s,
        "trace_mb": os.path.getsize(path) / 1e6,
        "platform": device.platform,
        "device_kind": device.device_kind,
        "gpu": card_name_and_power_limit(),
    }
    with open(os.path.join(args.out, "breakdown.json"), "w") as f:
        json.dump({**rec, "trace": desc}, f, indent=1)
    if not args.keep_trace:
        import shutil

        shutil.rmtree(trace_dir)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
