"""Device plumbing (utils/platform.py): the peak table, platform selection
and the compile-cache placement."""

import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

import jax

from asr_study_tpu.utils import platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dev(platform_name, kind):
    return SimpleNamespace(platform=platform_name, device_kind=kind)


@pytest.mark.parametrize("dtype,want", [
    ("bf16", 989e12), ("tf32", 495e12), ("fp32", 67e12),
])
def test_peak_of_a_known_card(dtype, want):
    dev = _dev("gpu", "NVIDIA H100 80GB HBM3")
    assert platform.peak_flops(dtype, dev) == want


def test_unknown_accelerator_has_no_default_peak():
    with pytest.raises(KeyError, match="no published peak"):
        platform.peak_flops("bf16", _dev("gpu", "Some Future Card"))
    with pytest.raises(KeyError, match="no published peak"):
        platform.peak_flops("fp8", _dev("gpu", "NVIDIA H100 80GB HBM3"))


def test_cpu_has_no_peak():
    assert platform.peak_flops("bf16", jax.devices("cpu")[0]) is None
    assert platform.peak_flops() is None       # tests run on the CPU


def test_select_platform_accepts_the_running_backend():
    # backends are up (conftest); asking for the one in use is a no-op,
    # as when a CLI's main() runs twice in one process
    jax.devices()
    platform.select_platform("cpu")
    platform.select_platform(None)
    with pytest.raises(RuntimeError, match="already runs on 'cpu'"):
        platform.select_platform("gpu")


def test_select_platform_gpu_matches_a_cuda_backend(monkeypatch):
    """A CUDA backend registers as 'cuda' but reports 'gpu' as the
    default backend: a second --platform gpu in one process is fine."""
    from jax._src import xla_bridge

    monkeypatch.setattr(xla_bridge, "_backends", {"cuda": object()})
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    platform.select_platform("gpu")
    with pytest.raises(RuntimeError, match="cannot select platform 'cpu'"):
        platform.select_platform("cpu")


_CACHE_PROBE = r"""
import jax
from asr_study_tpu.utils import platform
platform.setup_compilation_cache()
print(jax.config.jax_compilation_cache_dir)
"""


@pytest.mark.parametrize("env_dir", [None, "/nonexistent/cache/from/env"])
def test_compilation_cache_placement(env_dir):
    """With JAX_COMPILATION_CACHE_DIR set, jax's own reading of it stands
    and nothing is set in code; without it the cache sits at the fixed
    <checkout>/.jax_cache."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE], capture_output=True,
        text=True, timeout=300, env=env, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    got = out.stdout.strip().splitlines()[-1]
    assert got == (env_dir or os.path.join(REPO, ".jax_cache"))


def test_card_query_absent_without_nvidia_smi(monkeypatch):
    import shutil

    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert platform.card_name_and_power_limit() is None
