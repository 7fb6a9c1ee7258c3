"""Sim(3) optimizers: relative refinement + essential-graph pose graph.

Replaces Optimizer::OptimizeSim3 (/root/reference/src/Optimizer.cc:1050-1250)
and Optimizer::OptimizeEssentialGraph (:784-1048) / g2o's
VertexSim3Expmap/EdgeSim3 (types_seven_dof_expmap.h:48-169):

- optimize_sim3_relative: one 7-DoF similarity refined over bidirectional
  reprojection residuals (both images), Gauss-Newton with Huber(sqrt(10)),
  chi2 > 10 outlier gate between rounds — the reference's inlier contract.
- essential_graph_solve: Sim3 pose graph over all keyframes. Per-edge
  residual e = log(S_meas^-1 * S_i * S_j^-1) with left-multiplicative
  tangent updates; per-edge 7x14 Jacobians by forward-mode autodiff
  (vmapped), then Levenberg-Marquardt where each normal-equation solve is a
  matrix-free Jacobi-preconditioned CG over the [K,7] tangent stack —
  scales to thousands of keyframes with only segment-sum/gather traffic
  (no giant dense Hessian), the data-parallel analogue of g2o's sparse solver.

Scale handling: fix_scale=True (stereo/RGBD, Optimizer.cc:811-847) zeroes
the log-scale component of every update.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry.sim3 import sim3_compose, sim3_exp, sim3_inverse, sim3_log
from ..xmath import HIGHEST


# ----------------------------------------------------------------------
# relative Sim3 refine (loop-candidate verification)
# ----------------------------------------------------------------------
def optimize_sim3_relative(
    s0, R0, t0,
    x1, x2,            # [N,3] matched points in camera frames 1 / 2
    uv1, uv2,          # [N,2] pixel observations
    inv_sigma2_1, inv_sigma2_2,
    valid,
    fx, fy, cx, cy,
    fix_scale: bool,
    iters: int = 10,
    chi2_th: float = 10.0,
):
    """Returns (s, R, t, inliers, n_inliers). S12: x1 ~ s R x2 + t."""

    def residuals(s, R, t):
        x2_in1 = s * jnp.einsum("ij,nj->ni", R, x2, precision=HIGHEST) + t
        si, Ri, ti = sim3_inverse(s, R, t)
        x1_in2 = si * jnp.einsum("ij,nj->ni", Ri, x1, precision=HIGHEST) + ti

        def proj(x):
            z = jnp.where(jnp.abs(x[..., 2]) < 1e-9, 1e-9, x[..., 2])
            return jnp.stack([fx * x[..., 0] / z + cx, fy * x[..., 1] / z + cy], axis=-1)

        r1 = (uv1 - proj(x2_in1))  # [N,2]
        r2 = (uv2 - proj(x1_in2))
        return r1, r2

    def chi2s(s, R, t):
        r1, r2 = residuals(s, R, t)
        c1 = jnp.sum(r1 * r1, axis=-1) * inv_sigma2_1
        c2 = jnp.sum(r2 * r2, axis=-1) * inv_sigma2_2
        return c1, c2

    def gn_round(s, R, t, active, n_iters, use_huber):
        def body(carry, _):
            s, R, t, lam = carry

            def r_of_delta(delta):
                ds, dR, dt = sim3_exp(delta)
                sn, Rn, tn = sim3_compose(ds, dR, dt, s, R, t)
                r1, r2 = residuals(sn, Rn, tn)
                return jnp.concatenate([r1, r2], axis=0)  # [2N,2]

            zero = jnp.zeros(7)
            r0 = r_of_delta(zero)
            J = jax.jacfwd(r_of_delta)(zero)  # [2N,2,7]
            w_is2 = jnp.concatenate([inv_sigma2_1, inv_sigma2_2])
            chi = jnp.sum(r0 * r0, axis=-1) * w_is2
            wh = jnp.where(use_huber, jnp.where(chi <= chi2_th, 1.0, jnp.sqrt(chi2_th / jnp.maximum(chi, 1e-12))), 1.0)
            act2 = jnp.concatenate([active, active])
            w = w_is2 * wh * act2
            H = jnp.einsum("nik,n,nil->kl", J, w, J, precision=HIGHEST)
            b = jnp.einsum("nik,n,ni->k", J, w, r0, precision=HIGHEST)
            if fix_scale:
                H = H.at[6, :].set(0.0).at[:, 6].set(0.0).at[6, 6].set(1.0)
                b = b.at[6].set(0.0)
            delta = -jnp.linalg.solve(H + lam * jnp.eye(7), b)
            ds, dR, dt = sim3_exp(delta)
            sn, Rn, tn = sim3_compose(ds, dR, dt, s, R, t)
            cost_old = jnp.sum(chi * wh * act2)
            c1n, c2n = chi2s(sn, Rn, tn)
            cost_new = jnp.sum(jnp.concatenate([c1n, c2n]) * act2)
            improved = cost_new < cost_old
            s = jnp.where(improved, sn, s)
            R = jnp.where(improved, Rn, R)
            t = jnp.where(improved, tn, t)
            lam = jnp.where(improved, lam * 0.5, lam * 4.0)
            return (s, R, t, lam), None

        (s, R, t, _), _ = jax.lax.scan(body, (s, R, t, jnp.float32(1e-4)), None, length=n_iters)
        return s, R, t

    active0 = valid.astype(jnp.float32)
    s, R, t = gn_round(s0, R0, t0, active0, iters // 2, True)
    c1, c2 = chi2s(s, R, t)
    inlier = valid & (c1 <= chi2_th) & (c2 <= chi2_th)
    s, R, t = gn_round(s, R, t, inlier.astype(jnp.float32), iters, False)
    c1, c2 = chi2s(s, R, t)
    inlier = valid & (c1 <= chi2_th) & (c2 <= chi2_th)
    return s, R, t, inlier, jnp.sum(inlier)


@functools.lru_cache(maxsize=2)
def make_sim3_refine(fix_scale: bool):
    return jax.jit(functools.partial(optimize_sim3_relative, fix_scale=fix_scale))


# ----------------------------------------------------------------------
# essential-graph Sim3 pose graph
# ----------------------------------------------------------------------
class PoseGraph(NamedTuple):
    s: jnp.ndarray        # [K]
    R: jnp.ndarray        # [K,3,3]  (S_iw: world -> camera i)
    t: jnp.ndarray        # [K,3]
    edge_i: jnp.ndarray   # [E] int32
    edge_j: jnp.ndarray   # [E] int32
    # measured relative S_ij = S_i * S_j^-1 at edge-creation time
    m_s: jnp.ndarray      # [E]
    m_R: jnp.ndarray      # [E,3,3]
    m_t: jnp.ndarray      # [E,3]
    weight: jnp.ndarray   # [E] float32 (0 = padding)
    fixed: jnp.ndarray    # [K] bool (loop KF, Optimizer.cc:836)


def _edge_residual(delta_i, delta_j, si, Ri, ti, sj, Rj, tj, ms, mR, mt):
    """e = log(M^-1 * (exp(di) Si) * (exp(dj) Sj)^-1): [7]."""
    dsi, dRi, dti = sim3_exp(delta_i)
    dsj, dRj, dtj = sim3_exp(delta_j)
    s_i, R_i, t_i = sim3_compose(dsi, dRi, dti, si, Ri, ti)
    s_j, R_j, t_j = sim3_compose(dsj, dRj, dtj, sj, Rj, tj)
    sji, Rji, tji = sim3_inverse(s_j, R_j, t_j)
    s_rel, R_rel, t_rel = sim3_compose(s_i, R_i, t_i, sji, Rji, tji)
    mi_s, mi_R, mi_t = sim3_inverse(ms, mR, mt)
    es, eR, et = sim3_compose(mi_s, mi_R, mi_t, s_rel, R_rel, t_rel)
    return sim3_log(es, eR, et)


def essential_graph_solve(
    g: PoseGraph,
    fix_scale: bool,
    n_lm_iters: int = 20,
    cg_iters: int = 40,
):
    """LM over the Sim3 pose graph; returns updated (s, R, t)."""
    K = g.s.shape[0]
    E = g.edge_i.shape[0]
    zero2 = (jnp.zeros(7), jnp.zeros(7))

    def edge_r_and_J(s, R, t):
        si, Ri, ti = s[g.edge_i], R[g.edge_i], t[g.edge_i]
        sj, Rj, tj = s[g.edge_j], R[g.edge_j], t[g.edge_j]

        def per_edge(si_, Ri_, ti_, sj_, Rj_, tj_, ms_, mR_, mt_):
            f = lambda di, dj: _edge_residual(di, dj, si_, Ri_, ti_, sj_, Rj_, tj_, ms_, mR_, mt_)
            r = f(*zero2)
            Ji = jax.jacfwd(f, argnums=0)(*zero2)   # [7,7]
            Jj = jax.jacfwd(f, argnums=1)(*zero2)
            return r, Ji, Jj

        return jax.vmap(per_edge)(si, Ri, ti, sj, Rj, tj, g.m_s, g.m_R, g.m_t)

    free = (~g.fixed).astype(jnp.float32)[:, None]  # [K,1]
    scale_mask = jnp.ones(7).at[6].set(0.0) if fix_scale else jnp.ones(7)

    def lm_iter(carry, _):
        s, R, t, lam = carry
        r, Ji, Jj = edge_r_and_J(s, R, t)   # [E,7], [E,7,7], [E,7,7]
        w = g.weight

        # gradient: g_k = sum_e J_e^T w r
        gi = jnp.einsum("eik,e,ei->ek", Ji, w, r, precision=HIGHEST)
        gj = jnp.einsum("eik,e,ei->ek", Jj, w, r, precision=HIGHEST)
        grad = (
            jax.ops.segment_sum(gi, g.edge_i, num_segments=K)
            + jax.ops.segment_sum(gj, g.edge_j, num_segments=K)
        ) * free * scale_mask[None]

        # Jacobi preconditioner diag
        di = jnp.einsum("eik,e,eik->ek", Ji, w, Ji, precision=HIGHEST)
        dj = jnp.einsum("eik,e,eik->ek", Jj, w, Jj, precision=HIGHEST)
        raw_diag = (
            jax.ops.segment_sum(di, g.edge_i, num_segments=K)
            + jax.ops.segment_sum(dj, g.edge_j, num_segments=K)
        )
        damp = lam * jnp.maximum(raw_diag, 1e-6)
        diag = raw_diag + damp + 1e-8  # preconditioner = damped diagonal

        def Hv(v):
            v = v * free * scale_mask[None]
            vi = v[g.edge_i]
            vj = v[g.edge_j]
            u = (
                jnp.einsum("eik,ek->ei", Ji, vi, precision=HIGHEST)
                + jnp.einsum("eik,ek->ei", Jj, vj, precision=HIGHEST)
            ) * w[:, None]
            hi = jnp.einsum("eik,ei->ek", Ji, u, precision=HIGHEST)
            hj = jnp.einsum("eik,ei->ek", Jj, u, precision=HIGHEST)
            out = (
                jax.ops.segment_sum(hi, g.edge_i, num_segments=K)
                + jax.ops.segment_sum(hj, g.edge_j, num_segments=K)
            )
            out = out + damp * v
            return out * free * scale_mask[None]

        b = -grad

        def cg_body(carry2, _):
            x, rr, p = carry2
            Ap = Hv(p)
            pAp = jnp.sum(p * Ap)
            rz = jnp.sum(rr * (rr / diag))
            alpha = rz / jnp.maximum(pAp, 1e-12)
            x = x + alpha * p
            r_new = rr - alpha * Ap
            rz_new = jnp.sum(r_new * (r_new / diag))
            beta = rz_new / jnp.maximum(rz, 1e-12)
            p = r_new / diag + beta * p
            return (x, r_new, p), None

        x0 = jnp.zeros_like(b)
        (delta, _, _), _ = jax.lax.scan(
            cg_body, (x0, b, b / diag), None, length=cg_iters, unroll=True
        )
        delta = delta * free * scale_mask[None]

        # apply candidate
        ds, dR, dt = sim3_exp(delta)
        sn, Rn, tn = sim3_compose(ds, dR, dt, s, R, t)
        cost_old = jnp.sum(jnp.sum(r * r, axis=-1) * w)
        rn, _, _ = edge_r_and_J(sn, Rn, tn)
        cost_new = jnp.sum(jnp.sum(rn * rn, axis=-1) * w)
        improved = cost_new < cost_old
        s = jnp.where(improved, sn, s)
        R = jnp.where(improved, Rn, R)
        t = jnp.where(improved, tn, t)
        lam = jnp.where(improved, lam * 0.5, lam * 4.0)
        return (s, R, t, lam), None

    (s, R, t, _), _ = jax.lax.scan(
        lm_iter, (g.s, g.R, g.t, jnp.float32(1e-4)), None, length=n_lm_iters
    )
    return s, R, t


@functools.lru_cache(maxsize=2)
def make_essential_solver(fix_scale: bool):
    return jax.jit(functools.partial(essential_graph_solve, fix_scale=fix_scale))
