"""Image-space primitives: pyramid, separable Gaussian blur.

Replaces ORBextractor::ComputePyramid (/root/reference/src/ORBextractor.cc:
1105-1135) and the pre-descriptor GaussianBlur(7x7, sigma=2)
(ORBextractor.cc:1082-1088). Bilinear resize via jax.image; blur as two 1-D
convolutions with fused padding.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp


def pyramid_shapes(height: int, width: int, n_levels: int, scale_factor: float):
    """Static (H_l, W_l) for each level (level 0 = full resolution)."""
    shapes = []
    for lvl in range(n_levels):
        inv = 1.0 / (scale_factor ** lvl)
        shapes.append((max(int(round(height * inv)), 32), max(int(round(width * inv)), 32)))
    return shapes


def build_pyramid(image, n_levels: int, scale_factor: float):
    """[H, W] float32 -> list of [H_l, W_l] float32 (static shapes)."""
    h, w = image.shape
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    levels = [image]
    for lvl in range(1, n_levels):
        prev = levels[-1]
        th, tw = shapes[lvl]
        levels.append(jax.image.resize(prev, (th, tw), method="bilinear"))
    return levels


@functools.lru_cache(maxsize=8)
def _gaussian_kernel(ksize: int, sigma: float):
    # numpy (not jnp): cached across jit traces, so must be a host constant —
    # jnp ops inside a trace would cache tracers (UnexpectedTracerError).
    import numpy as np

    half = ksize // 2
    x = np.arange(-half, half + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / np.sum(k)


def gaussian_blur_batched(images, ksize: int = 7, sigma: float = 2.0):
    """Separable blur over a batch [..., H, W] as shift-multiply-adds.

    k shifted fused multiply-adds per axis are exact f32 elementwise work
    that fuses into one kernel per axis; the conv formulation (below) would
    be a single-channel general convolution, which a GPU may run in TF32.
    """
    k = _gaussian_kernel(ksize, sigma)
    half = ksize // 2
    h, w = images.shape[-2], images.shape[-1]

    x = jnp.pad(images, [(0, 0)] * (images.ndim - 2) + [(half, half), (0, 0)],
                mode="reflect")
    acc = None
    for i in range(ksize):
        term = float(k[i]) * jax.lax.slice_in_dim(x, i, i + h, axis=-2)
        acc = term if acc is None else acc + term
    x = jnp.pad(acc, [(0, 0)] * (images.ndim - 2) + [(0, 0), (half, half)],
                mode="reflect")
    acc = None
    for i in range(ksize):
        term = float(k[i]) * jax.lax.slice_in_dim(x, i, i + w, axis=-1)
        acc = term if acc is None else acc + term
    return acc


def gaussian_blur(image, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur with reflect padding, [H, W] -> [H, W]."""
    k = jnp.asarray(_gaussian_kernel(ksize, sigma))
    half = ksize // 2
    x = jnp.pad(image, ((half, half), (0, 0)), mode="reflect")
    # vertical pass: conv over rows
    x = jax.lax.conv_general_dilated(
        x[None, None, :, :],
        k[None, None, :, None],
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )[0, 0]
    x = jnp.pad(x, ((0, 0), (half, half)), mode="reflect")
    x = jax.lax.conv_general_dilated(
        x[None, None, :, :],
        k[None, None, None, :],
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )[0, 0]
    return x
