"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Must set the env vars before jax is first imported anywhere (SURVEY.md §4:
``xla_force_host_platform_device_count`` lets multi-device sharding tests
run without accelerators).  The flag is CPU-only.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# If jax was already imported (by a plugin or sitecustomize), the env vars
# above were read too late; override the config directly.  Backends are
# created lazily, so this still lands before any client init.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# keep tests deterministic and quiet
os.environ.setdefault("JAX_TRACEBACK_FILTERING", "off")
# persistent compilation cache: scan-heavy tests are compile-dominated
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/tmp/jax_cache_tests")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
