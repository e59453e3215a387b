"""Recurrent layers (models/rnn.py ``scan_cell`` via ``RNNLayer``) against an
independent float64 NumPy per-frame loop: every cell kind, uni- and
bidirectional, two widths (100: the reference's graves2006 width, 128),
full and ragged masks; gradients against central finite differences of
that loop; and held (padded) frames, whose cotangents must not reach
any gradient."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from asr_study_tpu.models.rnn import RNNLayer

CELLS = ["lstm", "gru", "ln_lstm", "mi_lstm", "zoneout_lstm"]
T_STEPS, BATCH, FEATS = 7, 3, 5
LENGTHS = {"full": [7, 7, 7], "ragged": [7, 4, 1]}


def _sig(x):
    return 1.0 / (1.0 + np.exp(-x))


def _ln(p, x, eps=1e-5):
    mu = x.mean(-1, keepdims=True)
    var = x.var(-1, keepdims=True)
    return (x - mu) / np.sqrt(var + eps) * p["g"] + p["b"]


def _ln_blocks(p, x, blocks=4):
    xs = np.split(x, blocks, axis=-1)
    gs, bs = np.split(p["g"], blocks), np.split(p["b"], blocks)
    return np.concatenate(
        [_ln({"g": g, "b": b}, v) for v, g, b in zip(xs, gs, bs)], axis=-1
    )


def _np_step(kind, p, carry, x_t):
    """One frame of the cell, float64, eval mode (zoneout interpolates)."""
    if kind == "gru":
        (h,) = carry
        xr, xz, xn = np.split(x_t @ p["wx"], 3, axis=-1)
        hr, hz, hn = np.split(h @ p["wh"], 3, axis=-1)
        br, bz, bn = np.split(p["b"], 3)
        r = _sig(xr + hr + br)
        z = _sig(xz + hz + bz)
        n = np.tanh(xn + r * hn + bn)
        return ((1.0 - z) * n + z * h,)
    h, c = carry
    xp, hp = x_t @ p["wx"], h @ p["wh"]
    if kind == "mi_lstm":
        pre = p["alpha"] * xp * hp + p["beta1"] * xp + p["beta2"] * hp + p["b"]
    elif kind == "ln_lstm":
        pre = _ln_blocks(p["ln_x"], xp) + _ln_blocks(p["ln_h"], hp) + p["b"]
    else:
        pre = xp + hp + p["b"]
    i, f, g, o = np.split(pre, 4, axis=-1)
    c_new = _sig(f) * c + _sig(i) * np.tanh(g)
    c_out = _ln(p["ln_c"], c_new) if kind == "ln_lstm" else c_new
    h_new = _sig(o) * np.tanh(c_out)
    if kind == "zoneout_lstm":       # default rates 0.1 / 0.1
        h_new = 0.9 * h_new + 0.1 * h
        c_new = 0.9 * c_new + 0.1 * c
    return (h_new, c_new)


def np_layer(kind, params, x, lengths, bidirectional):
    """x [T, B, F] float64 -> [T, B, H or 2H]; padded frames hold the
    carry and output zeros."""
    t_steps, batch, _ = x.shape

    def run(p, order):
        hid = p["wh"].shape[0]
        carry = tuple(np.zeros((batch, hid))
                      for _ in range(1 if kind == "gru" else 2))
        out = np.zeros((t_steps, batch, hid))
        for t in order:
            new = _np_step(kind, p, carry, x[t])
            real = (t < np.asarray(lengths))[:, None]
            carry = tuple(np.where(real, n, o) for n, o in zip(new, carry))
            out[t] = np.where(real, carry[0], 0.0)
        return out

    outs = [run(params["fw"], range(t_steps))]
    if bidirectional:
        outs.append(run(params["bw"], range(t_steps - 1, -1, -1)))
    return np.concatenate(outs, axis=-1)


def _setup(kind, hidden, bidirectional, lengths, seed=0):
    layer = RNNLayer(kind, hidden, bidirectional=bidirectional)
    params = layer.init(jax.random.PRNGKey(seed), FEATS)
    rng = np.random.default_rng(seed)
    # non-trivial gains/biases so every parameter matters
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype),
        params,
    )
    x = rng.standard_normal((T_STEPS, BATCH, FEATS)).astype(np.float32)
    mask = (np.arange(T_STEPS)[:, None] < np.asarray(lengths)[None, :])
    mask = mask[..., None].astype(np.float32)
    return layer, params, x, mask


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.mark.parametrize("masks", sorted(LENGTHS))
@pytest.mark.parametrize("hidden", [100, 128])
@pytest.mark.parametrize("bidirectional", [False, True],
                         ids=["uni", "bi"])
@pytest.mark.parametrize("kind", CELLS)
def test_layer_matches_float64_loop(kind, bidirectional, hidden, masks):
    lengths = LENGTHS[masks]
    layer, params, x, mask = _setup(kind, hidden, bidirectional, lengths)
    got = np.asarray(jax.jit(layer.apply)(params, x, mask))
    want = np_layer(kind, _f64(params), x.astype(np.float64), lengths,
                    bidirectional)
    assert got.shape == want.shape == (
        T_STEPS, BATCH, hidden * (2 if bidirectional else 1)
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=3e-5)


def _loss_fn(layer, mask, weights):
    def loss(params, x):
        return jnp.sum(layer.apply(params, x, mask) * weights)
    return loss


@pytest.mark.parametrize("bidirectional", [False, True],
                         ids=["uni", "bi"])
@pytest.mark.parametrize("kind", CELLS)
def test_gradient_matches_finite_differences(kind, bidirectional):
    """<grad, v> of a weighted output sum, for a random direction v over
    every parameter and the inputs, against a central difference of the
    float64 loop."""
    lengths = LENGTHS["ragged"]
    layer, params, x, mask = _setup(kind, 16, bidirectional, lengths,
                                    seed=1)
    rng = np.random.default_rng(2)
    weights = rng.standard_normal(
        (T_STEPS, BATCH, 16 * (2 if bidirectional else 1))
    ).astype(np.float32)
    g_params, g_x = jax.jit(jax.grad(_loss_fn(layer, mask, weights),
                                     argnums=(0, 1)))(params, x)
    v_params = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape), _f64(params)
    )
    v_x = rng.standard_normal(x.shape)
    directional = sum(
        float(np.sum(np.asarray(g, np.float64) * v))
        for g, v in zip(jax.tree_util.tree_leaves(g_params),
                        jax.tree_util.tree_leaves(v_params))
    ) + float(np.sum(np.asarray(g_x, np.float64) * v_x))

    p64, x64, w64 = _f64(params), x.astype(np.float64), weights
    eps = 1e-6

    def loss64(s):
        p = jax.tree_util.tree_map(lambda a, v: a + s * v, p64, v_params)
        out = np_layer(kind, p, x64 + s * v_x, lengths, bidirectional)
        return float(np.sum(out * w64))

    fd = (loss64(eps) - loss64(-eps)) / (2 * eps)
    np.testing.assert_allclose(directional, fd, rtol=2e-3, atol=1e-3)


@pytest.mark.parametrize("bidirectional", [False, True],
                         ids=["uni", "bi"])
@pytest.mark.parametrize("kind", CELLS)
def test_held_frame_cotangents_do_not_leak(kind, bidirectional):
    """Cotangents on padded frames reach nothing: adding them leaves every
    gradient unchanged, and the inputs of padded frames get zero gradient
    (the carry holds there, so they feed no state)."""
    lengths = LENGTHS["ragged"]
    layer, params, x, mask = _setup(kind, 16, bidirectional, lengths,
                                    seed=3)
    rng = np.random.default_rng(4)
    shape = (T_STEPS, BATCH, 16 * (2 if bidirectional else 1))
    w_real = rng.standard_normal(shape).astype(np.float32) * mask
    w_held = w_real + 10.0 * rng.standard_normal(shape).astype(
        np.float32) * (1.0 - mask)
    grad = jax.jit(jax.grad(lambda p, x, w: _loss_fn(layer, mask, w)(p, x),
                            argnums=(0, 1)))
    gp_a, gx_a = grad(params, x, w_real)
    gp_b, gx_b = grad(params, x, w_held)
    for a, b in zip(jax.tree_util.tree_leaves(gp_a),
                    jax.tree_util.tree_leaves(gp_b)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(gx_a), np.asarray(gx_b))
    assert np.all(np.asarray(gx_b) * (1.0 - mask) == 0.0)
    assert np.abs(np.asarray(gx_b) * mask).sum() > 0.0
