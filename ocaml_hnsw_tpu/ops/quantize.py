"""Vector-store quantization (int8-quantized distances, the deep10m config).

Symmetric per-vector int8: x_q = round(x / s), s = max|x| / 127.  The search
loop is bound by its row gathers, so shrinking the row payload 4× (int8)
or 2× (bf16) is the principal QPS lever; distances are always accumulated
in f32 after dequantization, so the only error is the
quantization noise itself (≤ s/2 per coordinate).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def storage_dtype(storage: str):
    return {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}[storage]


def quantize_rows(x: jax.Array, storage: str):
    """f32[B, D] → (stored rows, scales f32[B], dequant norms f32[B]).

    norms are of the *dequantized* values so matmul-form l2 stays consistent
    with what the gather path reconstructs."""
    x = x.astype(jnp.float32)
    if storage == "f32":
        return x, jnp.ones(x.shape[0], jnp.float32), jnp.sum(x * x, axis=1)
    if storage == "bf16":
        xb = x.astype(jnp.bfloat16)
        xd = xb.astype(jnp.float32)
        return xb, jnp.ones(x.shape[0], jnp.float32), jnp.sum(xd * xd, axis=1)
    # int8
    amax = jnp.max(jnp.abs(x), axis=1)
    scale = jnp.where(amax > 0, amax / 127.0, 1.0)
    q = jnp.clip(jnp.round(x / scale[:, None]), -127, 127).astype(jnp.int8)
    xd = q.astype(jnp.float32) * scale[:, None]
    return q, scale, jnp.sum(xd * xd, axis=1)


def dequantize_gathered(rows: jax.Array, scales: jax.Array) -> jax.Array:
    """[B, K, D] stored rows + f32[B, K] scales → f32[B, K, D]."""
    if rows.dtype == jnp.int8:
        return rows.astype(jnp.float32) * scales[:, :, None]
    return rows.astype(jnp.float32)
