"""Tiny functional NN primitives (params are plain dict pytrees).

Kept hand-rolled rather than flax so the scan cells control exactly what runs
inside vs. outside ``lax.scan`` (the input-projection hoist in cells.py is the
single biggest BLSTM throughput lever — SURVEY.md §7 hard-part 5).
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp


def glorot_uniform(key, shape, dtype=jnp.float32):
    fan_in, fan_out = shape[-2], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return jax.random.uniform(key, shape, dtype, -limit, limit)


def orthogonal(key, shape, dtype=jnp.float32):
    """Orthogonal init; for (H, G*H) shapes, per-gate orthogonal blocks."""
    rows, cols = shape
    if cols % rows == 0 and cols != rows:
        blocks = []
        for k in jax.random.split(key, cols // rows):
            blocks.append(_orth_square(k, rows, dtype))
        return jnp.concatenate(blocks, axis=1)
    return _orth_square(key, max(rows, cols), dtype)[:rows, :cols]


def _orth_square(key, n, dtype):
    a = jax.random.normal(key, (n, n), jnp.float32)
    q, r = jnp.linalg.qr(a)
    q = q * jnp.sign(jnp.diag(r))[None, :]
    return q.astype(dtype)


def dense_init(key, in_dim: int, out_dim: int, dtype=jnp.float32):
    wkey, _ = jax.random.split(key)
    return {
        "w": glorot_uniform(wkey, (in_dim, out_dim), dtype),
        "b": jnp.zeros((out_dim,), dtype),
    }


def dense_apply(params, x, precision=None):
    w = params["w"]
    return (
        jnp.dot(x.astype(w.dtype), w, precision=precision,
                preferred_element_type=jnp.float32)
        + params["b"]
    )


def layer_norm_init(dim: int, dtype=jnp.float32):
    return {"g": jnp.ones((dim,), dtype), "b": jnp.zeros((dim,), dtype)}


def layer_norm_apply(params, x, eps: float = 1e-5):
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    return (x - mean) * jax.lax.rsqrt(var + eps) * params["g"] + params["b"]


def dropout(key: Optional[jax.Array], x, rate: float, train: bool):
    if not train or rate <= 0.0 or key is None:
        return x
    keep = 1.0 - rate
    mask = jax.random.bernoulli(key, keep, x.shape)
    return jnp.where(mask, x / keep, 0.0)
