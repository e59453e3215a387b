"""Tensor parallelism for the recurrent stacks (opt-in, mesh axis "model").

Megatron-style gate-dimension sharding adapted to the T-serial recurrence
(SURVEY.md §2.3: TP was N/A for the reference; this is an
extension for wide cells).  Each device on the ``model`` mesh axis owns an
H/n slice of EVERY gate block — parameters are viewed as ``[..., G, H]``
and sliced on H — so the recurrent matmul, the gate nonlinearities, and
the cell state all run on ``[B, H/n]`` locally.  The only cross-device
communication is ONE ``all_gather`` of the ``[B, H/n]`` hidden state per
frame (the next frame's recurrent matmul needs the full h), which rides
the device interconnect; its transpose (a ``psum_scatter``) is inserted by AD in the backward
scan.

Parameters stay REPLICATED: at these model sizes (tens of MB) TP buys
FLOP/latency sharding of the serial recurrence, not parameter memory.
``tp_slice`` therefore carries a custom VJP that reassembles the
full-weight cotangent with a ``psum`` over the model axis — gradients
leave the shard_map replicated across "model", so the Trainer's existing
data-axis psum and replicated optimizer are untouched.

Supported cells: plain LSTM and GRU (the wide-model cells TP is for).
The scan math below mirrors models/cells.py step-for-step; parity is
enforced by tests/test_tp.py against the standard path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.custom_vjp, nondiff_argnums=(1, 2, 3))
def tp_slice(v, num_gates: int, axis_name: str, num_shards: int):
    """``[..., G*H]`` -> this shard's ``[..., G*(H/n)]`` (every gate block
    sliced on its H axis).  Backward reassembles the FULL cotangent with a
    psum over ``axis_name``, so the replicated parameter's gradient is
    identical on every model shard."""
    return _slice_fwd(v, num_gates, axis_name, num_shards)


def _slice_fwd(v, num_gates, axis_name, num_shards):
    gh = v.shape[-1]
    h = gh // num_gates
    hl = h // num_shards
    k = jax.lax.axis_index(axis_name)
    v3 = v.reshape(v.shape[:-1] + (num_gates, h))
    loc = jax.lax.dynamic_slice_in_dim(v3, k * hl, hl, axis=v3.ndim - 1)
    return loc.reshape(v.shape[:-1] + (num_gates * hl,))


def _slice_vjp_fwd(v, num_gates, axis_name, num_shards):
    return _slice_fwd(v, num_gates, axis_name, num_shards), None


def _slice_vjp_bwd(num_gates, axis_name, num_shards, _res, ct):
    hl = ct.shape[-1] // num_gates
    h = hl * num_shards
    k = jax.lax.axis_index(axis_name)
    ct3 = ct.reshape(ct.shape[:-1] + (num_gates, hl))
    full = jnp.zeros(ct.shape[:-1] + (num_gates, h), ct.dtype)
    full = jax.lax.dynamic_update_slice_in_dim(
        full, ct3, k * hl, axis=full.ndim - 1
    )
    full = jax.lax.psum(full, axis_name)
    return (full.reshape(ct.shape[:-1] + (num_gates * h,)),)


tp_slice.defvjp(_slice_vjp_fwd, _slice_vjp_bwd)


def _hold(mask_t, new, old):
    return jnp.where(mask_t > 0, new, old)


def validate_tp(model, num_shards: int) -> None:
    """Fail FAST (for CLI startup) if the model can't run tensor-parallel:
    tp_scan supports plain LSTM/GRU cells with hidden divisible by the
    shard count.  Raises ValueError with the same messages the apply-time
    checks would, so users see them before any compile/init work."""
    from asr_study_tpu.models.cells import GRUCell, LSTMCell

    if num_shards <= 1:
        return
    for layer in model.rnn.layers:
        cell = layer.cell
        if type(cell) not in (LSTMCell, GRUCell):
            raise ValueError(
                f"tensor parallelism supports lstm/gru cells, got "
                f"{type(cell).__name__} — run this cell data-parallel only"
            )
        if cell.hidden % num_shards:
            raise ValueError(
                f"hidden={cell.hidden} not divisible by {num_shards} "
                "model shards"
            )


def tp_scan(cell, params, x, mask, axis_name: str, num_shards: int,
            reverse: bool = False):
    """One direction of a gate-dim-sharded lstm/gru recurrence.

    x [T, B, F] and mask [T, B, 1] replicated across ``axis_name``;
    returns [T, B, H] replicated (each frame's local [B, H/n] state is
    all-gathered).  Must run inside shard_map with ``axis_name`` bound.
    """
    from asr_study_tpu.models.cells import GRUCell, LSTMCell

    kind = type(cell)
    if kind not in (LSTMCell, GRUCell):
        raise ValueError(
            f"tensor parallelism supports lstm/gru cells, got "
            f"{kind.__name__} — run this cell data-parallel only"
        )
    hidden, g = cell.hidden, cell.num_gates
    if hidden % num_shards:
        raise ValueError(
            f"hidden={hidden} not divisible by {num_shards} model shards"
        )
    hl = hidden // num_shards
    k = jax.lax.axis_index(axis_name)

    wx = tp_slice(params["wx"], g, axis_name, num_shards)
    wh = tp_slice(params["wh"], g, axis_name, num_shards)  # rows stay full H
    b = tp_slice(params["b"], g, axis_name, num_shards)

    dot = lambda a, w: jnp.dot(  # noqa: E731 — cells.py::_dot semantics
        a.astype(w.dtype), w, preferred_element_type=jnp.float32
    )
    xp = dot(x, wx) + b                           # [T, B, G*hl]
    batch = x.shape[1]
    if reverse:
        xp, mask_s = xp[::-1], mask[::-1]
    else:
        mask_s = mask

    def local_prev(h_full):
        return jax.lax.dynamic_slice_in_dim(h_full, k * hl, hl, axis=1)

    if kind is LSTMCell:
        def body(carry, inp):
            h_full, c_loc = carry
            xp_t, mask_t = inp
            pre = xp_t + dot(h_full, wh)          # [B, 4*hl]
            i, f, gg, o = jnp.split(pre, 4, axis=-1)
            c = jax.nn.sigmoid(f) * c_loc + jax.nn.sigmoid(i) * jnp.tanh(gg)
            h = jax.nn.sigmoid(o) * jnp.tanh(c)
            h = _hold(mask_t, h, local_prev(h_full))
            c = _hold(mask_t, c, c_loc)
            h_full = jax.lax.all_gather(h, axis_name, axis=1, tiled=True)
            return (h_full, c), h_full

        carry0 = (
            jnp.zeros((batch, hidden), x.dtype),
            jnp.zeros((batch, hl), x.dtype),
        )
    else:  # GRU — gate order r, z, n as in cells.py
        def body(carry, inp):
            (h_full,) = carry
            xp_t, mask_t = inp
            hp = dot(h_full, wh)
            xr, xz, xn = jnp.split(xp_t, 3, axis=-1)
            hr, hz, hn = jnp.split(hp, 3, axis=-1)
            r = jax.nn.sigmoid(xr + hr)
            z = jax.nn.sigmoid(xz + hz)
            n = jnp.tanh(xn + r * hn)
            h_prev = local_prev(h_full)
            h = (1.0 - z) * n + z * h_prev
            h = _hold(mask_t, h, h_prev)
            h_full = jax.lax.all_gather(h, axis_name, axis=1, tiled=True)
            return (h_full,), h_full

        carry0 = (jnp.zeros((batch, hidden), x.dtype),)

    _, outs = jax.lax.scan(body, carry0, (xp, mask_s))
    if reverse:
        outs = outs[::-1]
    return outs * mask


def tp_rnn_layer_apply(layer, params, x, mask, axis_name: str,
                       num_shards: int):
    """TP equivalent of RNNLayer.apply (the all_gather sits on the scan
    boundary)."""
    out_f = tp_scan(layer.cell, params["fw"], x, mask, axis_name,
                    num_shards, reverse=False)
    if not layer.bidirectional:
        return out_f
    out_b = tp_scan(layer.cell, params["bw"], x, mask, axis_name,
                    num_shards, reverse=True)
    return jnp.concatenate([out_f, out_b], axis=-1)
