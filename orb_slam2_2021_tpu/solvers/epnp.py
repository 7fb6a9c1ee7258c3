"""Camera-pose-from-scratch solver for relocalization (PnP RANSAC).

Fills the role of the reference's EPnP RANSAC (PnPsolver,
/root/reference/src/PnPsolver.cc:66-349): generate absolute-pose hypotheses
from 3D-2D matches with NO initial guess, score by reprojection inliers,
refine on the inlier set, and hand the winner to motion-only LM for polish
(Relocalization, Tracking.cc:1368-1532 does PnP -> PoseOptimization).

Structure vs the reference:
- Hypothesis generation: every RANSAC sample produces TWO pose candidates in
  one vmapped batch — a 6-point normalized DLT (12x12 eigh, general scenes)
  and a plane-induced homography decomposition (9x9 eigh + column
  orthonormalization, exact on planar scenes where the DLT's null space is
  rank-deficient — the configurations EPnP's N=3 beta case handles,
  PnPsolver.cc:492-541). The better-scoring candidate per sample wins.
- The adaptive iteration budget (PnPsolver.cc:127-168 grows iterations until
  the inlier-ratio bound is met, capped at 300) collapses into ONE launch:
  all `n_hyps` >= that cap are evaluated in parallel, so the budget is always
  the fully-grown one.
- Refine (PnPsolver.cc:271-316): the winning pose is re-solved twice on its
  full inlier set (weighted N-point DLT + N-point homography, again taking
  the better), re-classifying inliers in between — the reference's
  Refine-then-recheck loop as two extra fused steps inside the same program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..xmath import HIGHEST, mm

MIN_SAMPLE = 6


def _pose_from_p(p, Xh):
    """Projective 3x4 -> (R, t, ok) by sign fix + orthonormalization."""
    z_proj = mm(Xh, p[2])
    p = jnp.where(jnp.sum(z_proj > 0) >= jnp.sum(z_proj < 0), p, -p)
    M = p[:, :3]
    U, S, Vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(mm(U, Vt))
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0])).at[2, 2].set(jnp.sign(det))
    R = mm(mm(U, D), Vt)
    scale = jnp.mean(S)
    t = p[:, 3] / jnp.maximum(scale, 1e-12)
    ok = scale > 1e-9
    return R, t, ok


def _dlt_pose_n(xw, xn, yn, w):
    """Weighted N-point DLT: [N,3] world, [N] normalized pixel coords, [N]
    weights (0 drops the row) -> (R, t, ok)."""
    n = xw.shape[0]
    zeros = jnp.zeros((n, 4))
    Xh = jnp.concatenate([xw, jnp.ones((n, 1))], axis=1)          # [N,4]
    rows_u = jnp.concatenate([Xh, zeros, -xn[:, None] * Xh], axis=1)
    rows_v = jnp.concatenate([zeros, Xh, -yn[:, None] * Xh], axis=1)
    A = jnp.concatenate([rows_u * w[:, None], rows_v * w[:, None]], axis=0)
    AtA = jnp.einsum("ni,nj->ij", A, A, precision=HIGHEST)
    _, vecs = jnp.linalg.eigh(AtA)
    p = vecs[:, 0].reshape(3, 4)
    return _pose_from_p(p, Xh)


def _plane_frame(xw, w):
    """Weighted plane fit: centroid + orthonormal in-plane basis (e1, e2) and
    normal n via the covariance eigenvectors. Returns (c, E [3,3] cols
    e1|e2|n, planarity = 1 - lam_min/lam_mid)."""
    ws = jnp.maximum(jnp.sum(w), 1e-9)
    c = jnp.sum(xw * w[:, None], axis=0) / ws
    d = (xw - c) * w[:, None]
    C = jnp.einsum("ni,nj->ij", d, d, precision=HIGHEST) / ws
    lam, V = jnp.linalg.eigh(C)  # ascending
    E = jnp.stack([V[:, 2], V[:, 1], V[:, 0]], axis=1)  # e1|e2|n
    planarity = 1.0 - lam[0] / jnp.maximum(lam[1], 1e-12)
    return c, E, planarity


def _homography_pose(xw, xn, yn, w):
    """Plane-induced pose: fit a plane to the (weighted) points, estimate the
    homography plane->normalized-image (9x9 DLT), decompose H = [r1 r2 t]
    into a rigid pose. Exact for coplanar scenes; nonsense (low inlier count,
    auto-rejected) otherwise."""
    c, E, _ = _plane_frame(xw, w)
    uvp = jnp.einsum("ij,nj->ni", E.T, xw - c, precision=HIGHEST)  # [N,3]
    a, b = uvp[:, 0], uvp[:, 1]
    n = xw.shape[0]
    ones = jnp.ones((n,))
    zer = jnp.zeros((n,))
    Ph = jnp.stack([a, b, ones], axis=1)                           # [N,3]
    rows_u = jnp.stack([a, b, ones, zer, zer, zer,
                        -xn * a, -xn * b, -xn], axis=1)
    rows_v = jnp.stack([zer, zer, zer, a, b, ones,
                        -yn * a, -yn * b, -yn], axis=1)
    A = jnp.concatenate([rows_u * w[:, None], rows_v * w[:, None]], axis=0)
    AtA = jnp.einsum("ni,nj->ij", A, A, precision=HIGHEST)
    _, vecs = jnp.linalg.eigh(AtA)
    H = vecs[:, 0].reshape(3, 3)
    # sign: plane points must land in front of the camera
    z_proj = mm(Ph, H[2])
    H = jnp.where(jnp.sum(z_proj > 0) >= jnp.sum(z_proj < 0), H, -H)
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    s = jnp.sqrt(jnp.maximum(
        jnp.linalg.norm(h1) * jnp.linalg.norm(h2), 1e-18
    ))
    r1 = h1 / jnp.maximum(jnp.linalg.norm(h1), 1e-12)
    r2 = h2 - r1 * jnp.dot(r1, h2, precision=HIGHEST)
    r2 = r2 / jnp.maximum(jnp.linalg.norm(r2), 1e-12)
    r3 = jnp.cross(r1, r2)
    Rp = jnp.stack([r1, r2, r3], axis=1)          # plane -> camera
    tp = h3 / s
    # world -> camera: Xc = Rp E^T (X - c) + tp
    R = mm(Rp, E.T)
    t = tp - mm(R, c)
    ok = s > 1e-9
    return R, t, ok


def epnp_ransac(
    key,
    xw, uv,             # [N,3] world points, [N,2] observed pixels
    sigma2,             # [N] per-obs sigma^2
    valid,              # [N]
    fx, fy, cx, cy,
    n_hyps: int = 256,
    chi2_th: float = 5.991,
    refine_rounds: int = 2,
):
    """Vmapped PnP RANSAC + inlier refine. Returns (R, t, inliers [N],
    n_inliers)."""
    n = xw.shape[0]
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    keys = jax.random.split(key, n_hyps)
    xn_all = (uv[:, 0] - cx) / fx
    yn_all = (uv[:, 1] - cy) / fy

    def reproj_inliers(R, t):
        Xc = jnp.einsum("ij,nj->ni", R, xw, precision=HIGHEST) + t
        z = Xc[:, 2]
        zsafe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        u = fx * Xc[:, 0] / zsafe + cx
        v = fy * Xc[:, 1] / zsafe + cy
        e = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
        return valid & (z > 0) & (e < chi2_th * sigma2)

    def one_hyp(k):
        idx = jax.random.choice(k, n, shape=(MIN_SAMPLE,), replace=False, p=probs)
        w = jnp.ones(MIN_SAMPLE)
        xs, xns, yns = xw[idx], xn_all[idx], yn_all[idx]
        Rd, td, okd = _dlt_pose_n(xs, xns, yns, w)
        Rh, th, okh = _homography_pose(xs, xns, yns, w)
        cd = jnp.where(okd, jnp.sum(reproj_inliers(Rd, td)), 0)
        ch = jnp.where(okh, jnp.sum(reproj_inliers(Rh, th)), 0)
        use_h = ch > cd
        R = jnp.where(use_h, Rh, Rd)
        t = jnp.where(use_h, th, td)
        return jnp.maximum(cd, ch), R, t

    counts, Rs, ts = jax.vmap(one_hyp)(keys)
    best = jnp.argmax(counts)
    R, t = Rs[best], ts[best]
    inl = reproj_inliers(R, t)

    # Refine on the inlier set (PnPsolver::Refine, :271-316): weighted
    # N-point re-solve, re-classify, repeat; keep the refined pose only if it
    # does not lose inliers.
    for _ in range(refine_rounds):
        w = inl.astype(jnp.float32) / jnp.sqrt(sigma2)
        Rd, td, okd = _dlt_pose_n(xw, xn_all, yn_all, w)
        Rh, th, okh = _homography_pose(xw, xn_all, yn_all, w)
        cd = jnp.where(okd, jnp.sum(reproj_inliers(Rd, td)), 0)
        ch = jnp.where(okh, jnp.sum(reproj_inliers(Rh, th)), 0)
        use_h = ch > cd
        Rn = jnp.where(use_h, Rh, Rd)
        tn = jnp.where(use_h, th, td)
        cn = jnp.maximum(cd, ch)
        better = cn >= jnp.sum(inl)
        R = jnp.where(better, Rn, R)
        t = jnp.where(better, tn, t)
        inl = reproj_inliers(R, t)

    return R, t, inl, jnp.sum(inl)


@functools.lru_cache(maxsize=2)
def make_pnp_ransac(n_hyps: int = 256):
    return jax.jit(functools.partial(epnp_ransac, n_hyps=n_hyps))
