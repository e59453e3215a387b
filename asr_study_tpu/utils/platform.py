"""Device-platform selection, compile cache and device peaks for the CLIs.

The analog of the reference's ``setup_gpu`` [ref: utils/generic_utils.py]
(which pinned TF to a GPU id): ``select_platform`` updates the jax config
directly, which works as long as no backend has been initialized yet.
"""

from __future__ import annotations

import os
from typing import Optional

# <checkout>/.jax_cache: a fixed path, so reruns hit the same cache (the
# path is part of what jax keys its entries on)
_DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__
    )))),
    ".jax_cache",
)


def setup_compilation_cache() -> None:
    """Enable jax's persistent compilation cache (the scan-heavy programs
    here take a long time to compile on first run).  Where
    ``JAX_COMPILATION_CACHE_DIR`` is set, jax already reads it and no
    directory is set here; otherwise the cache goes to ``.jax_cache`` at
    the root of the checkout."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(_DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", _DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


# Dense peak rates (FLOP/s, no sparsity) by the ``device_kind`` jax
# reports, from NVIDIA's H100 data sheet (SXM part, at the full 700 W
# power limit).  bf16 is the tensor-core rate for bf16 operands, tf32 the
# rate of float32 matmuls at default precision, fp32 the rate of plain
# float32 outside the tensor cores (what HIGHEST-precision matmuls get).
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12},
}


def peak_flops(dtype: str = "bf16", device=None) -> Optional[float]:
    """Published dense peak of ``device`` (default: device 0) for
    ``dtype`` ('bf16' | 'tf32' | 'fp32').  None on the CPU, which has no
    entry; an unknown accelerator is an error, never a guessed default."""
    import jax

    device = device or jax.devices()[0]
    if device.platform == "cpu":
        return None
    try:
        return PEAK_FLOPS[device.device_kind][dtype]
    except KeyError:
        raise KeyError(
            f"no published peak for device_kind={device.device_kind!r} "
            f"({dtype}); add it to utils/platform.py PEAK_FLOPS"
        ) from None


def select_platform(platform: Optional[str]) -> None:
    """Force jax onto ``platform`` ('cpu' | 'gpu'); None = env default.

    Must be called before the first jax computation in the process, or
    after it only to ask for the platform already in use (a CLI's
    ``main`` called twice in one process).
    """
    if not platform:
        return
    import jax

    try:
        from jax._src import xla_bridge as _xb

        started = bool(getattr(_xb, "_backends", {}))
    except Exception:  # private API moved — skip the guard, keep working
        started = False
    if started:
        # jax.config.update would silently leave the running client (and
        # its device placement) in place — e.g. after an eager
        # module-level jnp constant initialized the default backend at
        # import, before "--platform cpu" could apply.  The default
        # backend reports "gpu" for CUDA, whatever name it registered.
        if jax.default_backend() != platform:
            raise RuntimeError(
                f"cannot select platform {platform!r}: jax already runs on "
                f"{jax.default_backend()!r}; call select_platform before "
                "any jax computation (check for module-level eager "
                "jnp/jax calls at import time)"
            )
        return
    jax.config.update("jax_platforms", platform)


def card_name_and_power_limit() -> Optional[str]:
    """What ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints (one line per card, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``);
    None where nvidia-smi is absent.  A card below its maximum power limit
    runs slower under load, so every timing is reported beside this."""
    import shutil
    import subprocess

    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip() or None
