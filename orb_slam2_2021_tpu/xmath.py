"""Precision-pinned linear algebra helpers.

On a GPU with tensor cores (A100, H100) an f32 matrix product at JAX's
default precision runs in TF32 — about 10 mantissa bits — and so does
Precision.HIGH. That is fine for image kernels but fatal for Lie-group chains
and bundle-adjustment normal equations (g2o runs double; we run f32 +
HIGHEST, which is full f32). All geometry/optimizer contractions go through
these helpers or pass precision=HIGHEST; the hot perception kernels cast to
bf16 explicitly and accumulate in f32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


def mm(a, b):
    """Matmul at full f32 precision."""
    return jnp.matmul(a, b, precision=HIGHEST)


def einsum(subscripts, *operands):
    """Einsum at full f32 precision."""
    return jnp.einsum(subscripts, *operands, precision=HIGHEST)


def apply_R(R, x):
    """[..., 3, 3] @ [..., 3] -> [..., 3] at full precision."""
    return jnp.einsum("...ij,...j->...i", R, x, precision=HIGHEST)


# --- batched SMALL matmuls --------------------------------------------------
# A dot_general over a large batch of 3x3 / 3x6 operands leaves a matrix
# unit nearly idle. Broadcast-multiply-sum keeps these as exact f32
# elementwise work — the right mapping when the contracted dims are tiny and
# the batch is huge (per-observation Jacobian algebra).

def smm(a, b):
    """[..., m, k] @ [..., k, n] -> [..., m, n] (tiny m/k/n, huge batch)."""
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def smv(a, v):
    """[..., m, k] @ [..., k] -> [..., m]."""
    return jnp.sum(a * v[..., None, :], axis=-1)


def stmv(a, v):
    """[..., k, m]^T-style contraction: sum_k a[..., k, m] * v[..., k]."""
    return jnp.sum(a * v[..., :, None], axis=-2)


def souter(a, b):
    """sum_r a[..., r, m] * b[..., r, n] -> [..., m, n] (J^T J blocks)."""
    return jnp.sum(a[..., :, :, None] * b[..., :, None, :], axis=-3)
