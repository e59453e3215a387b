"""Recurrent cells as pure step functions.

The reference implements its custom LSTM variants — layer normalization,
zoneout, multiplicative integration, highway/residual stacking — by overriding
Keras ``Recurrent.step()`` [ref: core/layers.py].  Here each cell is a pure
function designed around one optimization XLA cannot do for us: the
input-side gate projections ``x_t @ Wx`` for ALL timesteps are hoisted out of
the ``lax.scan`` into a single large matmul (``input_proj``), so the device
sees one [T*B, F] x [F, G*H] contraction instead of T small ones; the scan body
only computes the sequential [B, H] x [H, G*H] recurrence.

Cell protocol:
    num_gates                       -> G (gate-block multiplier for Wx/Wh)
    init(key, input_dim)            -> params pytree
    init_carry(batch, dtype)        -> carry pytree
    input_proj(params, x)           -> x @ Wx  (outside-scan hoist), [..., G*H]
    step(params, carry, xp_t, mask_t, key_t, train)
                                    -> (new_carry, out_t [B, H])

``mask_t`` is [B, 1] with 1.0 for real frames; the carry holds (passes
through) on padded frames, which also makes reversed scans over padded
sequences correct (padding is consumed before any real frame updates state).
``key_t`` feeds stochastic cells (zoneout); deterministic cells ignore it.

Gate order everywhere: i, f, g (candidate), o — forget bias is +1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from asr_study_tpu.models.nn import (
    glorot_uniform,
    layer_norm_apply,
    layer_norm_init,
    orthogonal,
)


def _hold(mask_t, new, old):
    """Carry-hold on padded frames."""
    return jnp.where(mask_t > 0, new, old)


def _dot(x, w):
    """Matmul in the weights' dtype (bf16 tensor-core paths under mixed
    precision) with f32 accumulation."""
    return jnp.dot(
        x.astype(w.dtype), w, preferred_element_type=jnp.float32
    )


class LSTMCell:
    """Vanilla LSTM."""

    num_gates = 4

    def __init__(self, hidden: int, dtype=jnp.float32):
        self.hidden = hidden
        self.dtype = dtype

    def init(self, key, input_dim: int):
        kx, kh = jax.random.split(key)
        h, g = self.hidden, self.num_gates
        b = jnp.zeros((g * h,), self.dtype)
        # forget-gate bias = 1 (gate order i,f,g,o)
        b = b.at[h : 2 * h].set(1.0)
        return {
            "wx": glorot_uniform(kx, (input_dim, g * h), self.dtype),
            "wh": orthogonal(kh, (h, g * h), self.dtype),
            "b": b,
        }

    def init_carry(self, batch: int, dtype=None):
        dtype = dtype or self.dtype
        h = self.hidden
        return (jnp.zeros((batch, h), dtype), jnp.zeros((batch, h), dtype))

    def input_proj(self, params, x):
        return _dot(x, params["wx"])

    def _gates(self, params, carry, xp_t):
        h_prev, _ = carry
        hp = _dot(h_prev, params["wh"])
        return xp_t + hp + params["b"]

    def step(self, params, carry, xp_t, mask_t, key_t=None, train: bool = False):
        h_prev, c_prev = carry
        pre = self._gates(params, carry, xp_t)
        i, f, g, o = jnp.split(pre, 4, axis=-1)
        c = jax.nn.sigmoid(f) * c_prev + jax.nn.sigmoid(i) * jnp.tanh(g)
        h = jax.nn.sigmoid(o) * jnp.tanh(c)
        h = _hold(mask_t, h, h_prev)
        c = _hold(mask_t, c, c_prev)
        return (h, c), h


class MILSTMCell(LSTMCell):
    """Multiplicative-integration LSTM (Wu et al. 2016), as in the reference's
    MI variant [ref: core/layers.py]: gate preactivation
    ``alpha * (Wx x * Wh h) + beta1 * (Wx x) + beta2 * (Wh h) + b``.
    """

    def init(self, key, input_dim: int):
        params = super().init(key, input_dim)
        gh = self.num_gates * self.hidden
        params.update(
            alpha=jnp.ones((gh,), self.dtype),
            beta1=jnp.ones((gh,), self.dtype),
            beta2=jnp.ones((gh,), self.dtype),
        )
        return params

    def _gates(self, params, carry, xp_t):
        h_prev, _ = carry
        hp = _dot(h_prev, params["wh"])
        return (
            params["alpha"] * xp_t * hp
            + params["beta1"] * xp_t
            + params["beta2"] * hp
            + params["b"]
        )


class LayerNormLSTMCell(LSTMCell):
    """Layer-norm LSTM (Ba et al. 2016), as in the reference's LN variant
    [ref: core/layers.py]: LN over the x- and h-side gate preactivations
    (separate gains) and over the cell state before the output tanh.
    """

    def init(self, key, input_dim: int):
        params = super().init(key, input_dim)
        gh = self.num_gates * self.hidden
        params["ln_x"] = layer_norm_init(gh, self.dtype)
        params["ln_h"] = layer_norm_init(gh, self.dtype)
        params["ln_c"] = layer_norm_init(self.hidden, self.dtype)
        return params

    @staticmethod
    def _blockwise_ln(ln_params, x, blocks=4):
        """LN applied per gate block so gates normalize independently."""
        parts = jnp.split(x, blocks, axis=-1)
        gp = jnp.split(ln_params["g"], blocks)
        bp = jnp.split(ln_params["b"], blocks)
        return jnp.concatenate(
            [layer_norm_apply({"g": g, "b": b}, p) for p, g, b in zip(parts, gp, bp)],
            axis=-1,
        )

    def step(self, params, carry, xp_t, mask_t, key_t=None, train: bool = False):
        h_prev, c_prev = carry
        hp = _dot(h_prev, params["wh"])
        pre = (
            self._blockwise_ln(params["ln_x"], xp_t)
            + self._blockwise_ln(params["ln_h"], hp)
            + params["b"]
        )
        i, f, g, o = jnp.split(pre, 4, axis=-1)
        c = jax.nn.sigmoid(f) * c_prev + jax.nn.sigmoid(i) * jnp.tanh(g)
        h = jax.nn.sigmoid(o) * jnp.tanh(layer_norm_apply(params["ln_c"], c))
        h = _hold(mask_t, h, h_prev)
        c = _hold(mask_t, c, c_prev)
        return (h, c), h


class ZoneoutLSTMCell(LSTMCell):
    """Zoneout LSTM (Krueger et al. 2017), the reference's zoneout variant
    [ref: core/layers.py]: with prob z, a unit's h/c KEEPS its previous value
    (train: stochastic per unit; eval: deterministic interpolation).
    """

    def __init__(self, hidden: int, zoneout_h: float = 0.1, zoneout_c: float = 0.1,
                 dtype=jnp.float32):
        super().__init__(hidden, dtype)
        self.zoneout_h = zoneout_h
        self.zoneout_c = zoneout_c

    def _zoneout(self, key, new, old, rate, train):
        if rate <= 0.0:
            return new
        if train and key is not None:
            keep_new = jax.random.bernoulli(key, 1.0 - rate, new.shape)
            return jnp.where(keep_new, new, old)
        return (1.0 - rate) * new + rate * old

    def step(self, params, carry, xp_t, mask_t, key_t=None, train: bool = False):
        h_prev, c_prev = carry
        (h, c), _ = super().step(params, carry, xp_t, mask_t)
        if key_t is not None:
            kh, kc = jax.random.split(key_t)
        else:
            kh = kc = None
        h = self._zoneout(kh, h, h_prev, self.zoneout_h, train)
        c = self._zoneout(kc, c, c_prev, self.zoneout_c, train)
        h = _hold(mask_t, h, h_prev)
        c = _hold(mask_t, c, c_prev)
        return (h, c), h


class GRUCell:
    """Vanilla GRU (gate order r, z, n)."""

    num_gates = 3

    def __init__(self, hidden: int, dtype=jnp.float32):
        self.hidden = hidden
        self.dtype = dtype

    def init(self, key, input_dim: int):
        kx, kh = jax.random.split(key)
        h, g = self.hidden, self.num_gates
        return {
            "wx": glorot_uniform(kx, (input_dim, g * h), self.dtype),
            "wh": orthogonal(kh, (h, g * h), self.dtype),
            "b": jnp.zeros((g * h,), self.dtype),
        }

    def init_carry(self, batch: int, dtype=None):
        return (jnp.zeros((batch, self.hidden), dtype or self.dtype),)

    def input_proj(self, params, x):
        return _dot(x, params["wx"])

    def step(self, params, carry, xp_t, mask_t, key_t=None, train: bool = False):
        (h_prev,) = carry
        hp = _dot(h_prev, params["wh"])
        xr, xz, xn = jnp.split(xp_t, 3, axis=-1)
        hr, hz, hn = jnp.split(hp, 3, axis=-1)
        br, bz, bn = jnp.split(params["b"], 3)
        r = jax.nn.sigmoid(xr + hr + br)
        z = jax.nn.sigmoid(xz + hz + bz)
        n = jnp.tanh(xn + r * hn + bn)
        h = (1.0 - z) * n + z * h_prev
        h = _hold(mask_t, h, h_prev)
        return (h,), h


CELLS = {
    "lstm": LSTMCell,
    "gru": GRUCell,
    "ln_lstm": LayerNormLSTMCell,
    "zoneout_lstm": ZoneoutLSTMCell,
    "mi_lstm": MILSTMCell,
}


def make_cell(kind: str, hidden: int, **kw) -> "LSTMCell | GRUCell":
    if kind not in CELLS:
        raise KeyError(f"unknown cell {kind!r}; available: {sorted(CELLS)}")
    return CELLS[kind](hidden, **kw)
