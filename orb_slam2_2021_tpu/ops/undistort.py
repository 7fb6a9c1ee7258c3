"""Keypoint undistortion (radial-tangential model).

Equivalent of Frame::UndistortKeyPoints (/root/reference/src/Frame.cc:456-486),
which calls cv::undistortPoints on the detected pixel coordinates so all
downstream geometry (matching windows, triangulation, BA residuals) sees an
ideal pinhole camera. cv::undistortPoints inverts the distortion model by
fixed-point iteration; we do the same with a compile-time-unrolled loop so
the whole [N,2] batch is one fused program inside the frame-build jit —
no per-point host loop.

Model (OpenCV / reference convention, 5 coefficients k1 k2 p1 p2 k3):
    x' = x(1 + k1 r^2 + k2 r^4 + k3 r^6) + 2 p1 x y + p2 (r^2 + 2 x^2)
    y' = y(1 + k1 r^2 + k2 r^4 + k3 r^6) + p1 (r^2 + 2 y^2) + 2 p2 x y
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp


def _model(x, y, dist):
    k1, k2, p1, p2, k3 = dist
    r2 = x * x + y * y
    rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return rad, dx, dy


def distort_points(xy, fx, fy, cx, cy, dist: Sequence[float]):
    """Forward model: ideal pinhole pixel coords -> distorted pixel coords.

    Closed form (no iteration); used for image synthesis and testing."""
    x = (xy[..., 0] - cx) / fx
    y = (xy[..., 1] - cy) / fy
    rad, dx, dy = _model(x, y, dist)
    xd = x * rad + dx
    yd = y * rad + dy
    return jnp.stack([xd * fx + cx, yd * fy + cy], axis=-1)


def undistort_points(xy, fx, fy, cx, cy, dist: Sequence[float], iters: int = 10):
    """Inverse model: distorted pixel coords -> ideal pinhole pixel coords.

    Fixed-point iteration x <- (xd - tangential(x)) / radial(x) starting from
    the distorted coords, exactly cv::undistortPoints' scheme (it runs 5
    iterations; we run 10 for the strong TUM freiburg1 distortion). The loop
    is unrolled at trace time — 10 fused elementwise passes."""
    xd = (xy[..., 0] - cx) / fx
    yd = (xy[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(iters):
        rad, dx, dy = _model(x, y, dist)
        rad = jnp.maximum(rad, 1e-6)
        x = (xd - dx) / rad
        y = (yd - dy) / rad
    return jnp.stack([x * fx + cx, y * fy + cy], axis=-1)
