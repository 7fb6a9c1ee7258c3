"""SO(3): rotation exp/log maps and quaternion conversions.

Batched over arbitrary leading dims; float32 by default (the accelerator's
native width — the reference's g2o runs double on CPU, se3quat.h; we keep angles well-conditioned
with Taylor fallbacks near theta=0 instead).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..xmath import mm

_EPS = 1e-8


def so3_hat(w):
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(w):
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation.

    Uses Taylor expansions for small angles so gradients stay finite.
    """
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    # sin(t)/t and (1-cos t)/t^2 with small-angle Taylor fallback
    small = theta2 < 1e-8
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    W = so3_hat(w)
    W2 = mm(W, W)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R):
    """[..., 3, 3] rotation -> [..., 3] axis-angle (theta in [0, pi]).

    Differentiable at the identity: theta comes from atan2(|vee|/2, cos)
    rather than arccos (whose derivative blows up at cos=1 and would poison
    autodiff through pose-graph residuals at near-zero error).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    # vee of the antisymmetric part
    v = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_t = 0.5 * jnp.sqrt(jnp.sum(v * v, axis=-1) + 1e-24)
    theta = jnp.arctan2(sin_t, cos_t)
    # theta / (2 sin theta), Taylor near 0
    small = theta < 1e-4
    scale = jnp.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_t + _EPS))
    w = v * scale[..., None]
    # Near theta = pi the vee-part vanishes; recover axis from diagonal.
    near_pi = theta > 3.0
    # R = I + 2 sin^2(t/2) (nn^T - I) => diag gives |n_i|. The clip floor is
    # strictly positive: sqrt(0) has an infinite derivative that would poison
    # forward-mode autodiff through the (unselected) where-branch when the
    # rotation is near identity (pose-graph Jacobians hit exactly that).
    nn = jnp.sqrt(jnp.clip((jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1) - cos_t[..., None]) / (1.0 - cos_t[..., None] + _EPS), 1e-12, 1.0))
    # fix signs from off-diagonals
    sx = jnp.sign(jnp.where(jnp.abs(v[..., 0]) > _EPS, v[..., 0], 1.0))
    sy = jnp.sign(R[..., 0, 1] + R[..., 1, 0]) * sx
    sz = jnp.sign(R[..., 0, 2] + R[..., 2, 0]) * sx
    n = nn * jnp.stack([sx, sy, sz], axis=-1)
    w_pi = n * theta[..., None]
    return jnp.where(near_pi[..., None], w_pi, w)


def rot_to_quat(R):
    """[..., 3, 3] -> [..., 4] quaternion (w, x, y, z), w >= 0.

    Shepperd's method via the largest of four candidates, branch-free.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate constructions; pick the numerically safest.
    qw = jnp.sqrt(jnp.clip(1.0 + tr, 0.0, None)) * 0.5
    qx = jnp.sqrt(jnp.clip(1.0 + m00 - m11 - m22, 0.0, None)) * 0.5
    qy = jnp.sqrt(jnp.clip(1.0 - m00 + m11 - m22, 0.0, None)) * 0.5
    qz = jnp.sqrt(jnp.clip(1.0 - m00 - m11 + m22, 0.0, None)) * 0.5

    c0 = jnp.stack([qw, (m21 - m12) / (4 * qw + _EPS), (m02 - m20) / (4 * qw + _EPS), (m10 - m01) / (4 * qw + _EPS)], axis=-1)
    c1 = jnp.stack([(m21 - m12) / (4 * qx + _EPS), qx, (m01 + m10) / (4 * qx + _EPS), (m02 + m20) / (4 * qx + _EPS)], axis=-1)
    c2 = jnp.stack([(m02 - m20) / (4 * qy + _EPS), (m01 + m10) / (4 * qy + _EPS), qy, (m12 + m21) / (4 * qy + _EPS)], axis=-1)
    c3 = jnp.stack([(m10 - m01) / (4 * qz + _EPS), (m02 + m20) / (4 * qz + _EPS), (m12 + m21) / (4 * qz + _EPS), qz], axis=-1)

    cands = jnp.stack([c0, c1, c2, c3], axis=-2)  # [..., 4, 4]
    mags = jnp.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], axis=-1)
    idx = jnp.argmax(mags, axis=-1)
    q = jnp.take_along_axis(cands, idx[..., None, None].repeat(4, axis=-1), axis=-2)[..., 0, :]
    q = q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + _EPS)
    return q * jnp.sign(q[..., :1] + _EPS)


def quat_to_rot(q):
    """[..., 4] quaternion (w, x, y, z) -> [..., 3, 3]."""
    q = q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + _EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )
