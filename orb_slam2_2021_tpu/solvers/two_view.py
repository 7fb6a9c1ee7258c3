"""Monocular two-view bootstrap: H/F model selection + reconstruction.

Replaces Initializer (/root/reference/src/Initializer.cc): from matched
keypoints in two frames, RANSAC a homography H and a fundamental F (the
reference runs both in two host threads, :104-109 — here BOTH model families
and ALL hypotheses evaluate in one vmapped batch), score them with the
symmetric transfer errors (CheckHomography :302-383, CheckFundamental
:385-468), pick H if RH = SH/(SH+SF) > 0.40 (:112-118), then decompose
(ReconstructH :620-800 Faugeras 8-motion / ReconstructF :470-620 4-motion)
and cheirality-check every motion hypothesis by batched triangulation
(CheckRT :806-920).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..xmath import HIGHEST, mm

SIGMA = 1.0
TH_H = 5.991
TH_F_SCORE = 5.991
TH_F = 3.841


def _normalize(p):
    """Hartley normalization: [N,2] -> normalized coords + 3x3 transform."""
    mean = jnp.mean(p, axis=0)
    d = jnp.mean(jnp.abs(p - mean), axis=0) + 1e-9
    s = 1.0 / d
    pn = (p - mean) * s
    T = jnp.array(
        [[s[0], 0.0, -mean[0] * s[0]], [0.0, s[1], -mean[1] * s[1]], [0.0, 0.0, 1.0]]
    )
    return pn, T


def _dlt_h(p1, p2, w=None):
    """Homography DLT (p2 ~ H p1); optional per-point weights (refit)."""
    n = p1.shape[0]
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    z = jnp.zeros(n)
    o = jnp.ones(n)
    rows_a = jnp.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], axis=1)
    rows_b = jnp.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], axis=1)
    A = jnp.concatenate([rows_a, rows_b], axis=0)
    ww = jnp.ones(2 * n) if w is None else jnp.concatenate([w, w])
    _, vecs = jnp.linalg.eigh(
        jnp.einsum("ni,n,nj->ij", A, ww, A, precision=HIGHEST)
    )
    return vecs[:, 0].reshape(3, 3)


def _eight_point_f(p1, p2, w=None):
    """8-point fundamental (p2^T F p1 = 0), rank-2 enforced; optional
    weights for a full-inlier refit."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    o = jnp.ones_like(x1)
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], axis=1
    )
    ww = o if w is None else w
    _, vecs = jnp.linalg.eigh(
        jnp.einsum("ni,n,nj->ij", A, ww, A, precision=HIGHEST)
    )
    F = vecs[:, 0].reshape(3, 3)
    U, S, Vt = jnp.linalg.svd(F)
    S = S.at[2].set(0.0)
    return mm(mm(U, jnp.diag(S)), Vt)


def _score_h(H, H_inv, p1, p2, valid, sigma2):
    """CheckHomography: symmetric transfer chi2 score."""
    def transfer(M, a):
        ah = jnp.concatenate([a, jnp.ones((a.shape[0], 1))], axis=1)
        b = mm(ah, M.T)
        return b[:, :2] / jnp.where(jnp.abs(b[:, 2:3]) < 1e-9, 1e-9, b[:, 2:3])

    e12 = jnp.sum((p2 - transfer(H, p1)) ** 2, axis=1) / sigma2
    e21 = jnp.sum((p1 - transfer(H_inv, p2)) ** 2, axis=1) / sigma2
    in12 = (e12 < TH_H) & valid
    in21 = (e21 < TH_H) & valid
    score = jnp.sum(jnp.where(in12, TH_H - e12, 0.0)) + jnp.sum(
        jnp.where(in21, TH_H - e21, 0.0)
    )
    return score, in12 & in21


def _score_f(F, p1, p2, valid, sigma2):
    """CheckFundamental: epipolar distance chi2 score."""
    p1h = jnp.concatenate([p1, jnp.ones((p1.shape[0], 1))], axis=1)
    p2h = jnp.concatenate([p2, jnp.ones((p2.shape[0], 1))], axis=1)
    l2 = p1h @ F.T        # lines in image 2
    l1 = p2h @ F          # lines in image 1
    d2 = (jnp.sum(l2 * p2h, axis=1) ** 2) / (l2[:, 0] ** 2 + l2[:, 1] ** 2 + 1e-12)
    d1 = (jnp.sum(l1 * p1h, axis=1) ** 2) / (l1[:, 0] ** 2 + l1[:, 1] ** 2 + 1e-12)
    c2 = d2 / sigma2
    c1 = d1 / sigma2
    in2 = (c2 < TH_F) & valid
    in1 = (c1 < TH_F) & valid
    score = jnp.sum(jnp.where(in2, TH_F_SCORE - c2, 0.0)) + jnp.sum(
        jnp.where(in1, TH_F_SCORE - c1, 0.0)
    )
    return score, in1 & in2


def _triangulate(P1, P2, p1, p2):
    """Batched DLT triangulation: [N,2]x2 with projection mats [3,4]."""
    A = jnp.stack(
        [
            p1[:, 0:1] * P1[2][None] - P1[0][None],
            p1[:, 1:2] * P1[2][None] - P1[1][None],
            p2[:, 0:1] * P2[2][None] - P2[0][None],
            p2[:, 1:2] * P2[2][None] - P2[1][None],
        ],
        axis=1,
    )
    AtA = jnp.einsum("nij,nik->njk", A, A, precision=HIGHEST)
    _, vecs = jnp.linalg.eigh(AtA)
    xh = vecs[:, :, 0]
    w = xh[:, 3]
    return xh[:, :3] / jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)[:, None]


def _check_rt(R, t, xn1, xn2, valid, fx, fy, sigma2, th2=4.0):
    """CheckRT (:806-920): triangulate in normalized coords, count good
    points (finite, positive depth both views, low reproj error, parallax)."""
    P1 = jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=1)
    P2 = jnp.concatenate([R, t[:, None]], axis=1)
    X = _triangulate(P1, P2, xn1, xn2)
    z1 = X[:, 2]
    Xc2 = mm(X, R.T) + t
    z2 = Xc2[:, 2]
    finite = jnp.all(jnp.isfinite(X), axis=1)
    # parallax between rays
    O2 = -mm(R.T, t)
    r1 = X
    r2 = X - O2[None]
    cosp = jnp.sum(r1 * r2, axis=1) / (
        jnp.linalg.norm(r1, axis=1) * jnp.linalg.norm(r2, axis=1) + 1e-12
    )
    # reprojection error in pixels (normalized * f)
    e1 = (
        (X[:, 0] / jnp.maximum(z1, 1e-9) - xn1[:, 0]) ** 2
        + (X[:, 1] / jnp.maximum(z1, 1e-9) - xn1[:, 1]) ** 2
    ) * fx * fy / sigma2
    e2 = (
        (Xc2[:, 0] / jnp.maximum(z2, 1e-9) - xn2[:, 0]) ** 2
        + (Xc2[:, 1] / jnp.maximum(z2, 1e-9) - xn2[:, 1]) ** 2
    ) * fx * fy / sigma2
    good = (
        valid & finite & (z1 > 0) & (z2 > 0)
        & (cosp < 0.99998) & (e1 < th2) & (e2 < th2)
    )
    # representative parallax: ~50th best (ref takes min(50, n)-th)
    cos_sorted = jnp.sort(jnp.where(good, cosp, 1.0))
    idx = jnp.minimum(50, jnp.maximum(jnp.sum(good) - 1, 0))
    parallax_cos = cos_sorted[idx]
    return jnp.sum(good), good, X, parallax_cos


class TwoViewResult(NamedTuple):
    ok: jnp.ndarray          # scalar bool
    used_h: jnp.ndarray      # scalar bool
    R: jnp.ndarray           # [3,3] pose of frame 2 w.r.t. frame 1 (Tcw2, w=f1)
    t: jnp.ndarray           # [3] (unit-norm translation)
    points: jnp.ndarray      # [N,3] triangulated in frame-1 coords
    good: jnp.ndarray        # [N] bool


def two_view_init(
    key,
    p1, p2,          # [N,2] matched pixel coords (frame1, frame2)
    valid,           # [N]
    fx, fy, cx, cy,
    n_hyps: int = 256,
    min_good: int = 50,
    min_parallax_cos: float = 0.9995,  # ~1.8 deg: small-parallax inits give
    # depth noise that aliases translation into rotation downstream
):
    """Full monocular bootstrap. Returns TwoViewResult."""
    n = p1.shape[0]
    sigma2 = SIGMA * SIGMA
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    keys = jax.random.split(key, n_hyps)

    p1n_all, T1 = _normalize(p1)
    p2n_all, T2 = _normalize(p2)
    T2inv = jnp.linalg.inv(T2)

    def one_hyp(k):
        idx = jax.random.choice(k, n, shape=(8,), replace=False, p=probs)
        Hn = _dlt_h(p1n_all[idx], p2n_all[idx])
        H = mm(mm(T2inv, Hn), T1)
        H = H / jnp.where(jnp.abs(H[2, 2]) < 1e-9, 1e-9, H[2, 2])
        Fn = _eight_point_f(p1n_all[idx], p2n_all[idx])
        F = mm(mm(T2.T, Fn), T1)
        sh, _ = _score_h(H, jnp.linalg.inv(H), p1, p2, valid, sigma2)
        sf, _ = _score_f(F, p1, p2, valid, sigma2)
        return sh, sf, H, F

    sh, sf, Hs, Fs = jax.vmap(one_hyp)(keys)
    bh = jnp.argmax(sh)
    bf = jnp.argmax(sf)
    H = Hs[bh]
    F = Fs[bf]
    SH = sh[bh]
    SF = sf[bf]
    use_h = SH / jnp.maximum(SH + SF, 1e-9) > 0.40

    _, inl_h = _score_h(H, jnp.linalg.inv(H), p1, p2, valid, sigma2)
    _, inl_f = _score_f(F, p1, p2, valid, sigma2)

    # refit the selected model on all its inliers (minimal-sample estimates
    # carry too much noise for a clean decomposition)
    Hn = _dlt_h(p1n_all, p2n_all, inl_h.astype(jnp.float32))
    H_ref = mm(mm(T2inv, Hn), T1)
    H = H_ref / jnp.where(jnp.abs(H_ref[2, 2]) < 1e-9, 1e-9, H_ref[2, 2])
    Fn = _eight_point_f(p1n_all, p2n_all, inl_f.astype(jnp.float32))
    F = mm(mm(T2.T, Fn), T1)
    _, inl_h = _score_h(H, jnp.linalg.inv(H), p1, p2, valid, sigma2)
    _, inl_f = _score_f(F, p1, p2, valid, sigma2)

    K = jnp.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
    Kinv = jnp.linalg.inv(K)
    xn1 = mm(jnp.concatenate([p1, jnp.ones((n, 1))], axis=1), Kinv.T)[:, :2]
    xn2 = mm(jnp.concatenate([p2, jnp.ones((n, 1))], axis=1), Kinv.T)[:, :2]

    # --- motion hypotheses ---
    # from F: E = K^T F K -> 4 motions (DecomposeE, :985-1007)
    E = mm(mm(K.T, F), K)
    U, S, Vt = jnp.linalg.svd(E)
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    Ra = mm(mm(U, W), Vt)
    Rb = mm(mm(U, W.T), Vt)
    Ra = Ra * jnp.sign(jnp.linalg.det(Ra))
    Rb = Rb * jnp.sign(jnp.linalg.det(Rb))
    tf = U[:, 2]
    tf = tf / (jnp.linalg.norm(tf) + 1e-12)
    zero3 = jnp.zeros(3)
    eye3 = jnp.eye(3)
    f_Rs = jnp.stack([Ra, Ra, Rb, Rb, eye3, eye3, eye3, eye3])
    f_ts = jnp.stack([tf, -tf, tf, -tf, zero3, zero3, zero3, zero3])
    f_live = jnp.array([1, 1, 1, 1, 0, 0, 0, 0], jnp.int32)

    # from H: Faugeras & Lustman 8-motion decomposition of A = K^-1 H K
    # (ReconstructH, :620-800)
    A = mm(mm(Kinv, H), K)
    U2, d, Vt2 = jnp.linalg.svd(A)
    sdet = jnp.linalg.det(U2) * jnp.linalg.det(Vt2)
    d1, d2, d3 = d[0], d[1], d[2]
    denom = jnp.maximum(d1 * d1 - d3 * d3, 1e-12)
    x1m = jnp.sqrt(jnp.clip((d1 * d1 - d2 * d2) / denom, 1e-12, None))
    x3m = jnp.sqrt(jnp.clip((d2 * d2 - d3 * d3) / denom, 1e-12, None))
    h_Rs_list, h_ts_list = [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            x1 = e1 * x1m
            x3 = e3 * x3m
            # case d' = +d2
            st = (d1 - d3) * x1 * x3 / jnp.maximum(d2, 1e-12)
            ct = (d1 * x3 * x3 + d3 * x1 * x1) / jnp.maximum(d2, 1e-12)
            Rp = jnp.array([[ct, 0.0, -st], [0.0, 1.0, 0.0], [st, 0.0, ct]])
            tp = jnp.array([x1, 0.0, -x3]) * (d1 - d3)
            h_Rs_list.append(mm(mm(sdet * U2, Rp), Vt2))
            h_ts_list.append(mm(U2, tp))
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            x1 = e1 * x1m
            x3 = e3 * x3m
            # case d' = -d2
            sp = (d1 + d3) * x1 * x3 / jnp.maximum(d2, 1e-12)
            cp = (d3 * x1 * x1 - d1 * x3 * x3) / jnp.maximum(d2, 1e-12)
            Rp = jnp.array([[cp, 0.0, sp], [0.0, -1.0, 0.0], [sp, 0.0, -cp]])
            tp = jnp.array([x1, 0.0, x3]) * (d1 + d3)
            h_Rs_list.append(mm(mm(sdet * U2, Rp), Vt2))
            h_ts_list.append(mm(U2, tp))
    h_Rs = jnp.stack(h_Rs_list)
    h_ts = jnp.stack(h_ts_list)
    h_ts = h_ts / (jnp.linalg.norm(h_ts, axis=1, keepdims=True) + 1e-12)
    h_live = jnp.ones(8, jnp.int32)

    Rs = jnp.where(use_h, h_Rs, f_Rs)
    ts = jnp.where(use_h, h_ts, f_ts)
    live = jnp.where(use_h, h_live, f_live)

    inl = jnp.where(use_h, inl_h, inl_f)

    def eval_motion(R_, t_):
        return _check_rt(R_, t_, xn1, xn2, inl, fx, fy, sigma2)

    n_good, goods, Xs, pcos = jax.vmap(eval_motion)(Rs, ts)
    n_good = n_good * live  # dead pad slots never win
    best = jnp.argmax(n_good)
    n_best = n_good[best]
    # clear winner: best > 0.7 * total and second-best < 0.75 * best (:560-600)
    sorted_counts = jnp.sort(n_good)
    second = sorted_counts[-2]
    ok = (
        (n_best >= min_good)
        & (second < 0.75 * n_best)
        & (pcos[best] < min_parallax_cos)
    )
    return TwoViewResult(
        ok=ok, used_h=use_h, R=Rs[best], t=ts[best],
        points=Xs[best], good=goods[best],
    )


@functools.lru_cache(maxsize=2)
def make_two_view_init(n_hyps: int = 256):
    return jax.jit(functools.partial(two_view_init, n_hyps=n_hyps))
