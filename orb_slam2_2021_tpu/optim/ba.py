"""Bundle adjustment with Schur-complement landmark elimination.

Replaces g2o's BlockSolver + LM over EdgeSE3ProjectXYZ graphs as driven by
Optimizer::LocalBundleAdjustment / ::BundleAdjustment
(/root/reference/src/Optimizer.cc:51-240, 454-782;
Thirdparty/g2o/g2o/core/block_solver.hpp:51-123 `_Hschur`/`_DInvSchur`).

Shape-static formulation: the problem is padded tensors
  cameras  : R [C,3,3], t [C,3]  (first n_opt optimizable, rest fixed)
  points   : xw [P,3]
  obs      : cam [O], pt [O], uvr [O,3] (u_r<0 = mono), inv_sigma2 [O], valid [O]
  pt_obs   : [P, Q] indices into the obs list (-1 pad) — per-point fan-in
             used to build the Schur cross terms.

One LM iteration:
  residual/Jacobian blocks for all O observations in parallel;
  U = sum JcT W Jc (per cam, segment_sum), V = sum JpT W Jp (per point),
  W_ip = JcT W Jp (per obs); Schur reduced camera system
  S = U* - sum_p W V*^-1 WT assembled dense [6C, 6C] (local windows are
  <= 64 cams -> a 384x384 dense solve), back-substitution for
  points. Damping on the U/V diagonals; accept/reject step on total
  robust cost. Mirrors the reference's two-phase schedule (5 its with Huber,
  reclassify outliers, 10 its without) via the `phases` argument.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import OptimConfig
from ..geometry.camera import PinholeCamera
from ..geometry.se3 import se3_compose, se3_exp
from ..xmath import HIGHEST, mm, smm, smv
from .robust import (
    huber_weight,
    point_jacobian_pose,
    proj_jacobian_mono,
    proj_jacobian_stereo,
)


class BAProblem(NamedTuple):
    R: jnp.ndarray            # [C, 3, 3] Tcw rotations
    t: jnp.ndarray            # [C, 3]
    xw: jnp.ndarray           # [P, 3]
    obs_cam: jnp.ndarray      # [O] int32
    obs_pt: jnp.ndarray       # [O] int32
    obs_uvr: jnp.ndarray      # [O, 3]; u_r < 0 => mono
    obs_inv_sigma2: jnp.ndarray  # [O]
    obs_valid: jnp.ndarray    # [O] bool
    pt_obs: jnp.ndarray       # [P, Q] int32 obs indices, -1 pad
    cam_free: jnp.ndarray     # [C] bool: optimizable


def _residual_jacobians(cam: PinholeCamera, prob: BAProblem, R, t, xw):
    """Per-observation residual r [O,3], Jc [O,3,6], Jp [O,3,3], chi2 [O]."""
    Rc = jnp.take(R, prob.obs_cam, axis=0)       # [O,3,3]
    tc = jnp.take(t, prob.obs_cam, axis=0)
    Xw = jnp.take(xw, prob.obs_pt, axis=0)
    Xc = smv(Rc, Xw) + tc

    z = Xc[:, 2]
    iz = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * Xc[:, 0] * iz + cam.cx
    v = cam.fy * Xc[:, 1] * iz + cam.cy
    ur = u - cam.bf * iz
    is_stereo = prob.obs_uvr[:, 2] >= 0

    r3 = prob.obs_uvr - jnp.stack([u, v, ur], axis=1)
    r2 = jnp.concatenate([r3[:, :2], jnp.zeros_like(r3[:, :1])], axis=1)
    r = jnp.where(is_stereo[:, None], r3, r2)

    Jproj3 = proj_jacobian_stereo(cam, Xc)       # [O,3,3]
    Jproj2 = proj_jacobian_mono(cam, Xc)         # [O,2,3]
    Jproj2 = jnp.concatenate([Jproj2, jnp.zeros_like(Jproj2[:, :1])], axis=1)
    Jproj = jnp.where(is_stereo[:, None, None], Jproj3, Jproj2)

    Jpose = point_jacobian_pose(Xc)              # [O,3,6]
    Jc = -smm(Jproj, Jpose)
    Jp = -smm(Jproj, Rc)

    chi2 = jnp.sum(r * r, axis=1) * prob.obs_inv_sigma2
    behind = z <= 0
    return r, Jc, Jp, chi2, behind


def _residual_chi2(cam: PinholeCamera, prob: BAProblem, R, t, xw):
    """chi2 [O] and behind [O] only — the LM accept/reject gate needs no
    Jacobians; evaluating them there doubled the per-iteration block math."""
    Rc = jnp.take(R, prob.obs_cam, axis=0)
    tc = jnp.take(t, prob.obs_cam, axis=0)
    Xw = jnp.take(xw, prob.obs_pt, axis=0)
    Xc = smv(Rc, Xw) + tc
    z = Xc[:, 2]
    iz = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * Xc[:, 0] * iz + cam.cx
    v = cam.fy * Xc[:, 1] * iz + cam.cy
    ur = u - cam.bf * iz
    is_stereo = prob.obs_uvr[:, 2] >= 0
    r3 = prob.obs_uvr - jnp.stack([u, v, ur], axis=1)
    r2 = jnp.concatenate([r3[:, :2], jnp.zeros_like(r3[:, :1])], axis=1)
    r = jnp.where(is_stereo[:, None], r3, r2)
    chi2 = jnp.sum(r * r, axis=1) * prob.obs_inv_sigma2
    return chi2, z <= 0


def _total_cost(chi2, w_active, delta2, use_huber):
    rho = jnp.where(
        (chi2 <= delta2) | ~use_huber,
        chi2,
        2.0 * jnp.sqrt(delta2 * jnp.maximum(chi2, 1e-12)) - delta2,
    )
    return jnp.sum(rho * w_active)


def _lm_step(cam, prob: BAProblem, R, t, xw, active, lam, use_huber, cfg: OptimConfig, axis_name=None):
    """One damped step. With axis_name set (inside shard_map over a mesh
    axis), observations/points are sharded per device and the camera-side
    blocks are psum-reduced over the axis — the distributed BA recipe of
    SURVEY.md §5: landmark blocks local, reduced camera system all-reduced
    across the devices."""
    C = prob.R.shape[0]
    P = prob.xw.shape[0]
    O = prob.obs_cam.shape[0]
    Q = prob.pt_obs.shape[1]

    r, Jc, Jp, chi2, behind = _residual_jacobians(cam, prob, R, t, xw)
    is_stereo = prob.obs_uvr[:, 2] >= 0
    delta2 = jnp.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
    wh = jnp.where(use_huber, huber_weight(chi2, delta2), 1.0)
    w = prob.obs_inv_sigma2 * wh * active

    # zero out Jc for fixed cameras so their blocks never enter the system
    free = jnp.take(prob.cam_free, prob.obs_cam)
    Jc = Jc * free[:, None, None]

    # block accumulations
    U = jax.ops.segment_sum(
        jnp.einsum("oik,o,oil->okl", Jc, w, Jc, precision=HIGHEST),
        prob.obs_cam, num_segments=C,
    )  # [C,6,6]
    V = jax.ops.segment_sum(
        jnp.einsum("oik,o,oil->okl", Jp, w, Jp, precision=HIGHEST),
        prob.obs_pt, num_segments=P,
    )  # [P,3,3]
    b_c = jax.ops.segment_sum(
        jnp.einsum("oik,o,oi->ok", Jc, w, r, precision=HIGHEST),
        prob.obs_cam, num_segments=C,
    )  # [C,6]
    b_p = jax.ops.segment_sum(
        jnp.einsum("oik,o,oi->ok", Jp, w, r, precision=HIGHEST),
        prob.obs_pt, num_segments=P,
    )  # [P,3]
    if axis_name is not None:
        U = jax.lax.psum(U, axis_name)
        b_c = jax.lax.psum(b_c, axis_name)
    Wcp = jnp.einsum("oik,o,oil->okl", Jc, w, Jp, precision=HIGHEST)  # [O,6,3]

    # damp
    eyeC = jnp.eye(6, dtype=R.dtype)
    eyeP = jnp.eye(3, dtype=R.dtype)
    U_d = U + lam * eyeC[None] * jnp.maximum(
        jnp.diagonal(U, axis1=1, axis2=2), 1e-6
    )[:, :, None] * eyeC[None] + 1e-8 * eyeC[None]
    V_d = V + lam * eyeP[None] * jnp.maximum(
        jnp.diagonal(V, axis1=1, axis2=2), 1e-6
    )[:, :, None] * eyeP[None] + 1e-8 * eyeP[None]
    V_inv = jnp.linalg.inv(V_d)  # [P,3,3] batched

    # Schur assembly over per-point observation lists
    po = prob.pt_obs                                  # [P,Q]
    po_valid = po >= 0
    po_safe = jnp.clip(po, 0)
    cam_of = jnp.take(prob.obs_cam, po_safe)          # [P,Q]
    W_po = jnp.take(Wcp, po_safe, axis=0) * po_valid[..., None, None]  # [P,Q,6,3]
    Y = jnp.einsum("pqik,pkl->pqil", W_po, V_inv, precision=HIGHEST)   # [P,Q,6,3]

    # S[a,b] -= sum_p Y_a W_b^T ; flatten (a,b) pairs per point
    pair = jnp.einsum("pqik,prlk->pqril", Y, W_po, precision=HIGHEST)  # [P,Q,Q,6,6]
    a_idx = jnp.broadcast_to(cam_of[:, :, None], (P, Q, Q))
    b_idx = jnp.broadcast_to(cam_of[:, None, :], (P, Q, Q))
    flat_ab = (a_idx * C + b_idx).reshape(-1)
    S_corr = jax.ops.segment_sum(
        pair.reshape(-1, 6, 6), flat_ab, num_segments=C * C
    ).reshape(C, C, 6, 6)
    if axis_name is not None:
        S_corr = jax.lax.psum(S_corr, axis_name)

    S = jnp.zeros((C, C, 6, 6), R.dtype)
    S = S.at[jnp.arange(C), jnp.arange(C)].set(U_d)
    S = S - S_corr
    # Schur RHS: b~ = b_c - sum_p Y b_p
    bp_of = jnp.take(b_p, jnp.arange(P), axis=0)       # [P,3]
    y_bp = jnp.einsum("pqik,pk->pqi", Y, bp_of, precision=HIGHEST)  # [P,Q,6]
    b_corr = jax.ops.segment_sum(
        y_bp.reshape(-1, 6), cam_of.reshape(-1), num_segments=C
    )
    if axis_name is not None:
        b_corr = jax.lax.psum(b_corr, axis_name)
    b_schur = b_c - b_corr

    # dense solve of the reduced camera system ([6C, 6C]).
    # Minimum-norm solve via eigendecomposition with a relative cutoff: a
    # monocular problem with too few fixed cameras has an exact scale
    # null-space (similarity gauge), and a plain solve at small lambda
    # random-walks the whole map along it (scale collapse). Zeroing the
    # near-null modes keeps the step in the observable subspace — the f32
    # equivalent of g2o's double-precision damped Cholesky.
    S_dense = S.transpose(0, 2, 1, 3).reshape(C * 6, C * 6)
    free_mask = jnp.repeat(prob.cam_free, 6)
    S_dense = jnp.where(
        (free_mask[:, None] & free_mask[None, :]),
        S_dense,
        jnp.eye(C * 6, dtype=R.dtype),
    )
    rhs = jnp.where(free_mask, -b_schur.reshape(-1), 0.0)
    S_sym = 0.5 * (S_dense + S_dense.T)
    eigw, eigv = jnp.linalg.eigh(S_sym)
    cutoff = jnp.maximum(jnp.max(jnp.abs(eigw)), 1e-12) * 1e-6
    inv_w = jnp.where(eigw > cutoff, 1.0 / eigw, 0.0)
    delta_c = mm(eigv, inv_w * mm(eigv.T, rhs)).reshape(C, 6)
    delta_c = delta_c * prob.cam_free[:, None]

    # back-substitute points: delta_p = -V^-1 (b_p + sum_i W_ip^T delta_c_i)
    dc_of = jnp.take(delta_c, cam_of.reshape(-1), axis=0).reshape(P, Q, 6)
    wt_dc = jnp.einsum("pqik,pqi->pk", W_po, dc_of, precision=HIGHEST)  # [P,3]
    delta_p = -jnp.einsum(
        "pkl,pl->pk", V_inv, b_p + wt_dc, precision=HIGHEST
    )

    # apply
    dR, dt = se3_exp(delta_c)
    R_new, t_new = se3_compose(dR, dt, R, t)
    xw_new = xw + delta_p
    return R_new, t_new, xw_new, chi2, behind, delta2, wh


def ba_solve(
    cam: PinholeCamera,
    prob: BAProblem,
    cfg: OptimConfig,
    iters_phase1: int,
    iters_phase2: int,
    axis_name=None,
):
    """Two-phase LM matching LocalBundleAdjustment's schedule
    (Optimizer.cc:662-712): phase 1 with Huber kernels, chi2 reclassification,
    phase 2 on inliers only. Returns (R, t, xw, obs_inlier)."""

    def phase(R, t, xw, active, lam, n_iters, use_huber):
        def body(carry, _):
            R, t, xw, lam = carry
            Rn, tn, xwn, chi2, behind, delta2, wh = _lm_step(
                cam, prob, R, t, xw, active, lam, use_huber, cfg, axis_name
            )
            cost_old = _total_cost(chi2, active, delta2, use_huber)
            # recompute chi2 at the candidate
            chi2_new, behind_new = _residual_chi2(cam, prob, Rn, tn, xwn)
            cost_new = _total_cost(chi2_new, active, delta2, use_huber)
            if axis_name is not None:
                cost_old = jax.lax.psum(cost_old, axis_name)
                cost_new = jax.lax.psum(cost_new, axis_name)
            improved = cost_new < cost_old
            R = jnp.where(improved, Rn, R)
            t = jnp.where(improved, tn, t)
            xw = jnp.where(improved, xwn, xw)
            lam = jnp.where(improved, lam * 0.5, lam * 4.0)
            return (R, t, xw, lam), None

        (R, t, xw, lam), _ = jax.lax.scan(body, (R, t, xw, lam), None, length=n_iters)
        return R, t, xw, lam

    active0 = prob.obs_valid.astype(jnp.float32)
    lam0 = jnp.float32(cfg.lm_lambda_init)
    R, t, xw = prob.R, prob.t, prob.xw

    R, t, xw, lam = phase(R, t, xw, active0, lam0, iters_phase1, jnp.bool_(True))

    # outlier reclassification (Optimizer.cc:714-736)
    chi2, behind = _residual_chi2(cam, prob, R, t, xw)
    is_stereo = prob.obs_uvr[:, 2] >= 0
    delta2 = jnp.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
    inlier = prob.obs_valid & (chi2 <= delta2) & (~behind)
    active1 = inlier.astype(jnp.float32)

    R, t, xw, _ = phase(R, t, xw, active1, lam0, iters_phase2, jnp.bool_(False))

    chi2, behind = _residual_chi2(cam, prob, R, t, xw)
    inlier = prob.obs_valid & (chi2 <= delta2) & (~behind)
    return R, t, xw, inlier


@functools.lru_cache(maxsize=4)
def make_local_ba(cfg: OptimConfig):
    return jax.jit(
        functools.partial(
            ba_solve,
            cfg=cfg,
            iters_phase1=cfg.local_ba_iters1,
            iters_phase2=cfg.local_ba_iters2,
        )
    )


@functools.lru_cache(maxsize=4)
def make_global_ba(cfg: OptimConfig):
    return jax.jit(
        functools.partial(
            ba_solve, cfg=cfg, iters_phase1=cfg.global_ba_iters, iters_phase2=0
        )
    )
