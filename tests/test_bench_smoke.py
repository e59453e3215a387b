"""Benchmark entry points run their full code path on the CPU at tiny
shapes: bench.py in smoke mode (ASR_BENCH_SMOKE=1), the others with
--platform cpu.  The numbers they print there mean nothing."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_bench_smoke_runs_and_prints_json():
    env = dict(os.environ, ASR_BENCH_SMOKE="1")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        capture_output=True, text=True, timeout=560, env=env, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    line = out.stdout.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec["metric"] == "rtf_feature_blstm_greedy_lapsbm_like"
    assert rec["smoke"] is True
    assert rec["value"] > 0
    assert rec["onchip_ms_per_batch"] > 0
    assert rec["flops_per_batch"] > 0
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 50.0, rel=1e-3)
    assert rec["platform"] == "cpu" and rec["mfu_pct"] is None
    assert rec["wall_s_min"] <= rec["wall_s_median"]


def test_bench_refuses_to_measure_the_cpu():
    """Outside smoke mode bench.py measures an accelerator; finding none
    it fails instead of timing the CPU."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("ASR_BENCH")}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        capture_output=True, text=True, timeout=560, env=env, cwd=REPO,
    )
    assert out.returncode != 0
    assert out.stdout == ""
    assert "found none" in out.stderr


@pytest.mark.slow
def test_bench_train_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks", "bench_train.py"),
         "--platform", "cpu", "--batch", "2", "--time", "32",
         "--labels", "4", "--hidden", "8", "--layers", "1", "--steps", "3"],
        capture_output=True, text=True, timeout=560, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["metric"] == "train_step_throughput"
    assert rec["steps_per_s"] > 0
    assert np.isfinite(rec["loss"])


def test_bench_input_runs():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks", "bench_input.py"),
         "--n", "64", "--batch", "8", "--epochs", "1"],
        capture_output=True, text=True, timeout=560, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    recs = [json.loads(l) for l in out.stdout.strip().splitlines()]
    names = {r["metric"] for r in recs}
    assert names == {
        "input_pipeline_ms_per_batch_in_memory",
        "input_pipeline_ms_per_batch_lazy_vlen",
        "input_pipeline_ms_per_batch_lazy_packed",
    }
    assert all(r["value"] > 0 for r in recs)


@pytest.mark.slow
def test_bench_beam_probe_runs_on_cpu():
    out = subprocess.run(
        [sys.executable,
         os.path.join(REPO, "benchmarks", "bench_beam_probe.py"),
         "--platform", "cpu", "--small", "--reps", "2", "--rounds", "2",
         "--variants", "full", "scan", "empty"],
        capture_output=True, text=True, timeout=560, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["metric"] == "beam_stub_probe_ms"
    for k in ("full", "scan", "empty"):
        assert rec[k] > 0


@pytest.mark.slow
def test_bench_stream_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks", "bench_stream.py"),
         "--platform", "cpu", "--seconds", "2", "--chunk_seconds", "0.5",
         "--hidden", "16", "--layers", "1", "--chunk_frames", "32"],
        capture_output=True, text=True, timeout=560, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["metric"] == "streaming_inference"
    assert rec["rtf_stream"] > 0 and rec["rtf_batch"] > 0
    assert rec["first_chunk_latency_ms"] > 0


@pytest.mark.slow
def test_bench_decode_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks", "bench_decode.py"),
         "--platform", "cpu", "--batch", "2", "--time", "16",
         "--vocab", "6", "--widths", "2", "--iters", "1"],
        capture_output=True, text=True, timeout=560, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["metric"] == "decode_rtf"
    assert rec["greedy"] > 0
    assert rec["beam2"] > 0
