"""Time-major scan-based RNN layers: uni/bidirectional + stacked with
residual / highway connections.

JAX redesign of the reference's stacked Keras recurrent layers
[ref: core/models.py, core/layers.py]: the recurrence is a ``jax.lax.scan``
over the leading (time) axis of [T, B, ...] arrays; input projections run as
one hoisted matmul per layer/direction (see cells.py).  The backward direction
of a BLSTM is the same scan over time-flipped inputs — the carry-hold masking
in the cells makes this exact for padded batches (padding is consumed before
real frames).
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp

from asr_study_tpu.models import nn
from asr_study_tpu.models.cells import make_cell


def scan_cell(cell, params, xp, mask, key=None, train: bool = False,
              reverse: bool = False, unroll: int = 1, carry0=None,
              return_carry: bool = False):
    """Run one direction of a recurrence.

    xp:   [T, B, G*H]  precomputed input projections
    mask: [T, B, 1]    1.0 on real frames
    ->    [T, B, H]  (or (outs, final_carry) with ``return_carry``)

    ``carry0``/``return_carry`` support STREAMING (chunked) inference
    and are forward-only.
    """
    t_steps, batch = xp.shape[0], xp.shape[1]
    orig_mask = mask
    streaming = carry0 is not None or return_carry
    if streaming and reverse:
        raise ValueError("carry streaming is forward-only")
    if reverse:
        xp, mask = xp[::-1], mask[::-1]
    keys = None
    if key is not None and train:
        keys = jax.random.split(key, t_steps)

    def body(carry, inp):
        if keys is not None:
            xp_t, mask_t, key_t = inp
        else:
            (xp_t, mask_t), key_t = inp, None
        carry, out = cell.step(params, carry, xp_t, mask_t, key_t, train)
        return carry, out

    xs = (xp, mask, keys) if keys is not None else (xp, mask)
    init = cell.init_carry(batch) if carry0 is None else carry0
    carry, outs = jax.lax.scan(body, init, xs, unroll=unroll)
    if reverse:
        outs = outs[::-1]
    outs = outs * orig_mask  # zero padded positions
    return (outs, carry) if return_carry else outs


class RNNLayer:
    """One (optionally bidirectional) recurrent layer."""

    def __init__(self, cell_kind: str, hidden: int, bidirectional: bool = True,
                 unroll: int = 1, **cell_kw):
        self.cell = make_cell(cell_kind, hidden, **cell_kw)
        self.bidirectional = bidirectional
        self.hidden = hidden
        self.unroll = unroll

    @property
    def output_dim(self) -> int:
        return self.hidden * (2 if self.bidirectional else 1)

    def init(self, key, input_dim: int):
        kf, kb = jax.random.split(key)
        params = {"fw": self.cell.init(kf, input_dim)}
        if self.bidirectional:
            params["bw"] = self.cell.init(kb, input_dim)
        return params

    def apply(self, params, x, mask, key=None, train: bool = False,
              tp=None):
        """x: [T, B, F] -> [T, B, output_dim].  ``tp=(axis_name, shards)``
        runs the gate-dim tensor-parallel scan (parallel/tp.py) — only
        valid inside shard_map with that mesh axis bound."""
        if tp is not None and tp[1] > 1:
            from asr_study_tpu.parallel.tp import tp_rnn_layer_apply

            return tp_rnn_layer_apply(self, params, x, mask, *tp) * mask
        kf = kb = None
        if key is not None:
            kf, kb = jax.random.split(key)
        xp_f = self.cell.input_proj(params["fw"], x)
        out_f = scan_cell(self.cell, params["fw"], xp_f, mask, kf, train,
                          reverse=False, unroll=self.unroll)
        if not self.bidirectional:
            return out_f
        xp_b = self.cell.input_proj(params["bw"], x)
        out_b = scan_cell(self.cell, params["bw"], xp_b, mask, kb, train,
                          reverse=True, unroll=self.unroll)
        return jnp.concatenate([out_f, out_b], axis=-1)

    def apply_streaming(self, params, x, mask, carry):
        """One chunk of a forward-only recurrence with carried state:
        x [T, B, F] -> ([T, B, H], new_carry).  Bidirectional layers have
        no streaming form (the backward direction needs the future)."""
        if self.bidirectional:
            raise ValueError(
                "streaming requires a unidirectional layer — build the "
                "model with bidirectional=false"
            )
        xp = self.cell.input_proj(params["fw"], x)
        return scan_cell(
            self.cell, params["fw"], xp, mask, None, False,
            reverse=False, unroll=self.unroll, carry0=carry, return_carry=True,
        )

    def init_stream_carry(self, batch: int):
        return self.cell.init_carry(batch)


class StackedRNN:
    """N recurrent layers with optional inter-layer dropout and skip
    connections ('none' | 'residual' | 'highway'), mirroring the reference's
    highway/residual stacking [ref: core/layers.py].

    Residual: ``out = rnn(x) + proj(x)`` (proj = identity when dims match).
    Highway:  ``out = t * rnn(x) + (1 - t) * proj(x)``, ``t = sigmoid(Wt x)``.
    """

    def __init__(
        self,
        cell_kind: str = "lstm",
        hidden: int = 256,
        num_layers: int = 3,
        bidirectional: bool = True,
        dropout: float = 0.0,
        skip: str = "none",
        unroll: int = 1,
        **cell_kw,
    ):
        if skip not in ("none", "residual", "highway"):
            raise ValueError(f"unknown skip kind {skip!r}")
        self.layers = [
            RNNLayer(cell_kind, hidden, bidirectional, unroll, **cell_kw)
            for _ in range(num_layers)
        ]
        self.dropout = dropout
        self.skip = skip

    @property
    def output_dim(self) -> int:
        return self.layers[-1].output_dim

    def init(self, key, input_dim: int):
        params: List[dict] = []
        dim = input_dim
        for layer in self.layers:
            key, kl, kp, kt = jax.random.split(key, 4)
            p = {"rnn": layer.init(kl, dim)}
            if self.skip != "none":
                if dim != layer.output_dim:
                    p["proj"] = nn.dense_init(kp, dim, layer.output_dim)
                if self.skip == "highway":
                    p["gate"] = nn.dense_init(kt, dim, layer.output_dim)
            params.append(p)
            dim = layer.output_dim
        return {"layers": params}

    def apply(self, params, x, mask, key=None, train: bool = False,
              tp=None):
        """x: [T, B, F] -> [T, B, output_dim]"""
        out = x
        for i, (layer, p) in enumerate(zip(self.layers, params["layers"])):
            if key is not None:
                key, k_rnn, k_drop = jax.random.split(key, 3)
            else:
                k_rnn = k_drop = None
            h = layer.apply(p["rnn"], out, mask, k_rnn, train, tp=tp)
            if self.skip != "none":
                skip_in = (
                    nn.dense_apply(p["proj"], out) if "proj" in p else out
                )
                if self.skip == "residual":
                    h = h + skip_in
                else:  # highway
                    t = jax.nn.sigmoid(nn.dense_apply(p["gate"], out))
                    h = t * h + (1.0 - t) * skip_in
                h = h * mask
            if train and self.dropout > 0 and i < len(self.layers) - 1:
                h = nn.dropout(k_drop, h, self.dropout, train)
            out = h
        return out

    def init_stream_carries(self, batch: int):
        return [l.init_stream_carry(batch) for l in self.layers]

    def apply_streaming(self, params, x, mask, carries):
        """One chunk through the stack with per-layer carried state
        (inference only — dropout off): -> (out, new_carries)."""
        out = x
        new = []
        for layer, p, c in zip(self.layers, params["layers"], carries):
            h, c2 = layer.apply_streaming(p["rnn"], out, mask, c)
            new.append(c2)
            if self.skip != "none":
                skip_in = (
                    nn.dense_apply(p["proj"], out) if "proj" in p else out
                )
                if self.skip == "residual":
                    h = h + skip_in
                else:  # highway
                    t = jax.nn.sigmoid(nn.dense_apply(p["gate"], out))
                    h = t * h + (1.0 - t) * skip_in
                h = h * mask
            out = h
        return out, new
