"""Comparisons that need the card: the GPU against the CPU backend of the
same process, at small shapes.  They skip without a GPU, and so in every
run that loads tests/conftest.py, which pins jax to the CPU.
``python chip_smoke.py`` runs them on the card (its ``gpu_tests`` phase:
``pytest tests/test_gpu.py -m gpu --noconftest``), after its ``parity``
phase has run the same comparisons at the real widths."""

import pytest

import jax

import chip_smoke as cs

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (run python chip_smoke.py on one)")


def _cpu():
    return jax.devices("cpu")[0]


def test_featurizer_on_gpu(gpu):
    cs.parity_featurizer(gpu, batch=4, frames=128)


def test_forward_on_gpu(gpu):
    cs.parity_forward(gpu, _cpu(), batch=4, frames=64, hidden=64, layers=2)


def test_ctc_on_gpu(gpu):
    cs.parity_ctc(gpu, _cpu(), batch=4, frames=64, labels=12)


def test_decode_on_gpu(gpu):
    cs.parity_decode(gpu, _cpu(), batch=4, frames=64, beam=8)


def test_dpack_on_gpu(gpu):
    cs.parity_dpack(gpu, batch=4, seconds=(1.0, 2.0))
