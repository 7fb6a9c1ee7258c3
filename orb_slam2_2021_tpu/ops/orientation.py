"""Intensity-centroid keypoint orientation (IC_Angle).

Behavioral equivalent of ORBextractor's IC_Angle
(/root/reference/src/ORBextractor.cc:75-102): moments m01/m10 over a circular
patch of radius HALF_PATCH_SIZE=15 around each keypoint on its pyramid level;
angle = atan2(m01, m10). Vectorized as one [N, 31, 31] patch gather + masked
moment reduction — no per-keypoint loops.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

HALF_PATCH = 15
PATCH = 2 * HALF_PATCH + 1


@functools.lru_cache(maxsize=1)
def _circular_mask_and_coords():
    # numpy (not jnp): this cache is shared across jit traces, so the values
    # must be host constants — jnp ops inside a trace would cache tracers.
    import numpy as np

    ys = np.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=np.float32)
    dy = ys[:, None] * np.ones((1, PATCH), np.float32)
    dx = ys[None, :] * np.ones((PATCH, 1), np.float32)
    mask = (dy * dy + dx * dx) <= float(HALF_PATCH * HALF_PATCH)
    return mask.astype(np.float32), dy, dx


def gather_patches(image, ys, xs, half: int):
    """[N] int coords -> [N, 2h+1, 2h+1] patches via vmapped dynamic_slice.

    Coordinates are clamped so out-of-range keypoints (invalid slots) read
    the image corner instead of faulting.
    """
    h, w = image.shape
    size = 2 * half + 1
    y0 = jnp.clip(ys - half, 0, h - size)
    x0 = jnp.clip(xs - half, 0, w - size)

    def one(y, x):
        return jax.lax.dynamic_slice(image, (y, x), (size, size))

    return jax.vmap(one)(y0, x0)


def ic_angles(image, ys, xs):
    """Orientation for N keypoints on one pyramid level -> [N] radians."""
    mask, dy, dx = _circular_mask_and_coords()
    patches = gather_patches(image, ys, xs, HALF_PATCH)  # [N, 31, 31]
    wpatch = patches * mask[None]
    m01 = jnp.sum(wpatch * dy[None], axis=(1, 2))
    m10 = jnp.sum(wpatch * dx[None], axis=(1, 2))
    return jnp.arctan2(m01, m10)


@functools.lru_cache(maxsize=1)
def _moment_matrix():
    """[961, 2] host constant: masked (dy, dx) weights -> (m01, m10) matmul."""
    import numpy as np

    mask, dy, dx = _circular_mask_and_coords()
    return np.stack([(mask * dy).reshape(-1), (mask * dx).reshape(-1)], axis=1)


def angles_from_patches(patches):
    """IC angles from pre-gathered [..., 961] patches (31x31 row-major).

    The moment sums become one [N, 961] x [961, 2] matmul (bf16 in, fp32
    accumulate) instead of masked reductions.
    """
    W = jnp.asarray(_moment_matrix(), jnp.bfloat16)
    lead = patches.shape[:-1]
    m = jnp.dot(
        patches.reshape(-1, PATCH * PATCH).astype(jnp.bfloat16), W,
        preferred_element_type=jnp.float32,
    )
    return jnp.arctan2(m[:, 0], m[:, 1]).reshape(lead)
