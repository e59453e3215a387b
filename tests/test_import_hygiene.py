"""Importing the framework must NOT initialize any jax backend.

An eager, module-level jax computation (e.g. ``jnp.uint32(...)`` as a
module constant) initializes the default backend at import — on a GPU
host that reserves most of the card's memory — before a CLI could apply
``--platform cpu``.  Regression: ops/beam.py's hash constants did exactly
this.
"""

import subprocess
import sys

_PROBE = r"""
import sys

import asr_study_tpu.cli.train      # the full CLI import graph
import asr_study_tpu.cli.eval
import asr_study_tpu.cli.predict
import asr_study_tpu.cli.make_dataset
import asr_study_tpu.ops            # ctc/beam/metrics
import asr_study_tpu.models.zoo
import asr_study_tpu.features.device

from jax._src import xla_bridge

started = sorted(getattr(xla_bridge, "_backends", {}) or {})
if started:
    print(f"backends initialized at import: {started}", file=sys.stderr)
    sys.exit(1)
sys.exit(0)
"""


def test_import_does_not_initialize_backend():
    # A fresh interpreter imports every CLI module; no backend may come up.
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE],
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, (
        f"stdout={proc.stdout!r}\nstderr={proc.stderr!r}"
    )
