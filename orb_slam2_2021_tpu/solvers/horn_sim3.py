"""Horn closed-form similarity alignment + vmapped RANSAC.

Replaces Sim3Solver (/root/reference/src/Sim3Solver.cc): given matched 3-D
points in two camera frames, estimate S12 = (s, R, t) such that
x1 ~ s R x2 + t, by Horn's quaternion method (ComputeSim3, :225-336):
centroid-subtract, M = Pr1 Pr2^T, build the 4x4 N matrix, top eigenvector is
the rotation quaternion; scale from the projection ratio; inliers by
bidirectional image-space chi2 (CheckInliers, :338-362, th 9.21*sigma2).

All RANSAC hypotheses (3-point minimal sets) are evaluated in one vmapped
batch instead of the reference's sequential 5-iteration loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..xmath import HIGHEST, mm


def horn_align(x1, x2, fix_scale: bool):
    """Closed-form Sim3 from 3+ correspondences.

    x1, x2: [M, 3] matched points (frames 1 and 2). Returns (s, R, t) with
    x1 ~ s R x2 + t.
    """
    c1 = jnp.mean(x1, axis=0)
    c2 = jnp.mean(x2, axis=0)
    p1 = x1 - c1
    p2 = x2 - c2
    # R = argmax tr(R^T M), M = sum p1 p2^T  (orthogonal Procrustes; same
    # optimum as Horn's quaternion eigen-decomposition, Sim3Solver.cc:225-336)
    M = jnp.einsum("ni,nj->ij", p1, p2, precision=HIGHEST)  # [3,3]
    U, _, Vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(mm(U, Vt))
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0])).at[2, 2].set(jnp.sign(det))
    R = mm(mm(U, D), Vt)  # rotates frame 2 into frame 1

    # scale (Horn symmetric form; reference uses dot(p1, R p2)/norm2(p2))
    Rp2 = jnp.einsum("ij,nj->ni", R, p2, precision=HIGHEST)
    num = jnp.sum(p1 * Rp2)
    den = jnp.sum(p2 * p2)
    s = jnp.where(fix_scale, 1.0, num / jnp.maximum(den, 1e-12))
    t = c1 - s * jnp.einsum("ij,j->i", R, c2, precision=HIGHEST)
    return s, R, t


def _project(cam_fx, cam_fy, cam_cx, cam_cy, x):
    z = jnp.maximum(x[..., 2], 1e-9)
    u = cam_fx * x[..., 0] / z + cam_cx
    v = cam_fy * x[..., 1] / z + cam_cy
    return jnp.stack([u, v], axis=-1)


def sim3_ransac(
    key,
    x1, x2,              # [N, 3] matched 3-D points in camera frames 1 / 2
    uv1, uv2,            # [N, 2] observed pixels in each image
    sigma2_1, sigma2_2,  # [N] per-match sigma^2 (octave-dependent)
    valid,               # [N] bool
    fx, fy, cx, cy,
    fix_scale: bool,
    n_hyps: int = 128,
    chi2_th: float = 9.21,
):
    """Vmapped 3-point RANSAC. Returns (s, R, t, inliers [N], n_inliers)
    for the best hypothesis (S12: x1 ~ s R x2 + t)."""
    n = x1.shape[0]
    # sample 3 distinct indices per hypothesis among valid entries
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    keys = jax.random.split(key, n_hyps)

    def one_hyp(k):
        idx = jax.random.choice(k, n, shape=(3,), replace=False, p=probs)
        s, R, t = horn_align(x1[idx], x2[idx], fix_scale)
        # bidirectional reprojection check
        x2_in1 = s * jnp.einsum("ij,nj->ni", R, x2, precision=HIGHEST) + t
        sinv = 1.0 / jnp.maximum(s, 1e-12)
        Rinv = R.T
        tinv = -sinv * jnp.einsum("ij,j->i", Rinv, t, precision=HIGHEST)
        x1_in2 = sinv * jnp.einsum("ij,nj->ni", Rinv, x1, precision=HIGHEST) + tinv
        e1 = jnp.sum((uv1 - _project(fx, fy, cx, cy, x2_in1)) ** 2, axis=-1)
        e2 = jnp.sum((uv2 - _project(fx, fy, cx, cy, x1_in2)) ** 2, axis=-1)
        inl = valid & (e1 < chi2_th * sigma2_1) & (e2 < chi2_th * sigma2_2)
        return jnp.sum(inl), s, R, t

    counts, ss, Rs, ts = jax.vmap(one_hyp)(keys)
    best = jnp.argmax(counts)
    s, R, t = ss[best], Rs[best], ts[best]

    # refine on the best hypothesis's inliers with full Horn
    x2_in1 = s * jnp.einsum("ij,nj->ni", R, x2, precision=HIGHEST) + t
    sinv = 1.0 / jnp.maximum(s, 1e-12)
    Rinv = R.T
    tinv = -sinv * jnp.einsum("ij,j->i", Rinv, t, precision=HIGHEST)
    x1_in2 = sinv * jnp.einsum("ij,nj->ni", Rinv, x1, precision=HIGHEST) + tinv
    e1 = jnp.sum((uv1 - _project(fx, fy, cx, cy, x2_in1)) ** 2, axis=-1)
    e2 = jnp.sum((uv2 - _project(fx, fy, cx, cy, x1_in2)) ** 2, axis=-1)
    inl = valid & (e1 < chi2_th * sigma2_1) & (e2 < chi2_th * sigma2_2)

    # weighted full-set Horn on inliers (mask via zero weights: recompute
    # centroids over inliers only)
    w = inl.astype(jnp.float32)
    wsum = jnp.maximum(jnp.sum(w), 3.0)
    c1 = jnp.sum(x1 * w[:, None], axis=0) / wsum
    c2 = jnp.sum(x2 * w[:, None], axis=0) / wsum
    p1 = (x1 - c1) * w[:, None]
    p2 = (x2 - c2) * w[:, None]
    Mm = jnp.einsum("ni,nj->ij", p1, p2, precision=HIGHEST)
    U2, _, Vt2 = jnp.linalg.svd(Mm)
    det2 = jnp.linalg.det(mm(U2, Vt2))
    D2 = jnp.diag(jnp.array([1.0, 1.0, 1.0])).at[2, 2].set(jnp.sign(det2))
    Rr = mm(mm(U2, D2), Vt2)
    Rp2 = jnp.einsum("ij,nj->ni", Rr, p2, precision=HIGHEST)
    sr = jnp.where(
        fix_scale, 1.0,
        jnp.sum(p1 * Rp2) / jnp.maximum(jnp.sum(p2 * p2), 1e-12),
    )
    tr = c1 - sr * jnp.einsum("ij,j->i", Rr, c2, precision=HIGHEST)

    # final inlier count with refined transform
    x2_in1 = sr * jnp.einsum("ij,nj->ni", Rr, x2, precision=HIGHEST) + tr
    srinv = 1.0 / jnp.maximum(sr, 1e-12)
    trinv = -srinv * jnp.einsum("ij,j->i", Rr.T, tr, precision=HIGHEST)
    x1_in2 = srinv * jnp.einsum("ij,nj->ni", Rr.T, x1, precision=HIGHEST) + trinv
    e1 = jnp.sum((uv1 - _project(fx, fy, cx, cy, x2_in1)) ** 2, axis=-1)
    e2 = jnp.sum((uv2 - _project(fx, fy, cx, cy, x1_in2)) ** 2, axis=-1)
    inl = valid & (e1 < chi2_th * sigma2_1) & (e2 < chi2_th * sigma2_2)
    return sr, Rr, tr, inl, jnp.sum(inl)


@functools.lru_cache(maxsize=4)
def make_sim3_ransac(fix_scale: bool, n_hyps: int = 128):
    return jax.jit(
        functools.partial(sim3_ransac, fix_scale=fix_scale, n_hyps=n_hyps)
    )
