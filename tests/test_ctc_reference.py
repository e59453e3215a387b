"""The scan CTC loss (ops/ctc.py) and its gradient over a grid of frame
counts, label lengths, repeated labels and infeasible targets, against
brute-force enumeration of every alignment and ``optax.ctc_loss``."""

import itertools

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp

from asr_study_tpu.ops.ctc import LOG_EPS, ctc_loss

VOCAB = 3        # two labels + blank
BLANK = VOCAB - 1


def _collapse(path):
    out, prev = [], None
    for s in path:
        if s != prev and s != BLANK:
            out.append(s)
        prev = s
    return out


def brute_force_nll(log_probs, labels):
    """-log sum over every length-T path that collapses to ``labels``;
    inf when none does."""
    t_steps = log_probs.shape[0]
    total = -np.inf
    for path in itertools.product(range(VOCAB), repeat=t_steps):
        if _collapse(path) == list(labels):
            total = np.logaddexp(
                total, sum(log_probs[t, s] for t, s in enumerate(path))
            )
    return -total


# (frames, labels): every label length 0..3, repeats that need a blank
# between them, and targets too long for their frame count
GRID = [
    (1, [0]), (2, [0]), (3, [1]), (4, []), (1, []),
    (3, [0, 1]), (4, [0, 1]), (3, [0, 0]), (5, [0, 0, 1]),
    (6, [1, 0, 1]), (5, [1, 1, 1]), (6, [0, 1, 0]),
    (2, [0, 0]), (4, [1, 1, 1]), (2, [0, 1, 0]),
]


def _problem(t_steps, labels, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((1, t_steps, VOCAB)).astype(np.float32)
    lab = np.zeros((1, 3), np.int32)
    lab[0, : len(labels)] = labels
    return logits, lab


def _optax(logits, t_steps, lab, n_labels):
    t_pad = np.zeros((1, t_steps), np.float32)
    l_pad = (np.arange(lab.shape[1]) >= n_labels)[None].astype(np.float32)
    return optax.ctc_loss(logits, t_pad, lab, l_pad, blank_id=BLANK)


@pytest.mark.parametrize("t_steps,labels", GRID,
                         ids=[f"T{t}-{''.join(map(str, l)) or 'empty'}"
                              for t, l in GRID])
def test_loss_and_grad_vs_brute_force_and_optax(t_steps, labels):
    logits, lab = _problem(t_steps, labels, seed=t_steps + 7 * len(labels))
    lens = np.array([t_steps], np.int32)
    n_lab = np.array([len(labels)], np.int32)

    def ours(lg):
        return ctc_loss(lg, lens, lab, n_lab)[0]

    loss, grad = jax.value_and_grad(ours)(jnp.asarray(logits))
    loss, grad = float(loss), np.asarray(grad)
    assert np.all(np.isfinite(grad))
    log_probs = np.asarray(jax.nn.log_softmax(logits[0].astype(np.float64)))
    want = brute_force_nll(log_probs, labels)
    if not np.isfinite(want):
        # infeasible (too few frames for the labels + required blanks):
        # the loss clamps to -LOG_EPS, keeping every gradient finite
        assert loss == pytest.approx(-LOG_EPS)
        return
    np.testing.assert_allclose(loss, want, rtol=1e-5, atol=1e-5)
    theirs = lambda lg: _optax(lg, t_steps, lab, len(labels))[0]
    np.testing.assert_allclose(loss, float(theirs(logits)), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(grad, np.asarray(jax.grad(theirs)(logits)),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ragged_batch_matches_optax(seed):
    """A batch with ragged frame and label lengths (padding beyond each
    length must not matter) against optax, loss and gradient."""
    rng = np.random.default_rng(seed)
    b, t_steps, vocab, n_lab = 5, 24, 6, 7
    logits = rng.standard_normal((b, t_steps, vocab)).astype(np.float32)
    lens = rng.integers(2 * n_lab + 1, t_steps + 1, size=b).astype(np.int32)
    lab_lens = rng.integers(0, n_lab + 1, size=b).astype(np.int32)
    lab = rng.integers(0, vocab - 1, size=(b, n_lab)).astype(np.int32)
    # garbage beyond each length
    logits[np.arange(t_steps)[None, :] >= lens[:, None]] = 50.0
    t_pad = (np.arange(t_steps)[None] >= lens[:, None]).astype(np.float32)
    l_pad = (np.arange(n_lab)[None] >= lab_lens[:, None]).astype(np.float32)

    def ours(lg):
        return ctc_loss(lg, lens, lab, lab_lens)

    def theirs(lg):
        return optax.ctc_loss(lg, t_pad, lab, l_pad, blank_id=vocab - 1)

    np.testing.assert_allclose(np.asarray(ours(logits)),
                               np.asarray(theirs(logits)), rtol=1e-5)
    g_ours = np.asarray(jax.grad(lambda z: ours(z).sum())(logits))
    g_theirs = np.asarray(jax.grad(lambda z: theirs(z).sum())(logits))
    np.testing.assert_allclose(g_ours, g_theirs, rtol=1e-4, atol=1e-5)
    # frames past each length get no gradient
    assert np.all(g_ours[np.arange(t_steps)[None, :] >= lens[:, None]] == 0)
