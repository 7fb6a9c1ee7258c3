"""Matrix-free Schur-complement bundle adjustment with block-Jacobi PCG.

The scalable replacement for the dense reduced-camera solve in optim/ba.py:
the Schur system S = U - W V^-1 W^T is never materialized. Each PCG
application of S costs three segment-sums over the observation list — the
same data-parallel shape as the residual/Jacobian evaluation — so memory is
O(O) in the observation count and the solver handles all-KF global problems
(RunGlobalBundleAdjustment, /root/reference/src/LoopClosing.cc:674-779 ->
Optimizer.cc:51-240) as well as local windows.

Sharded execution: with `axis_name` set (inside shard_map over a mesh axis),
points + observations are sharded per device and every camera-side reduction
(U, b_c, and the correction term inside each PCG matvec) is psum-reduced
across the devices; the camera-state update is computed redundantly on every device. This is
the SURVEY.md §5 distributed-BA recipe with the g2o block-solver Schur
structures (block_solver.hpp:51-123) replaced by collectives.

Divergence from the reference: the loop-closure GBA is run WITH Huber robust
kernels (the reference passes bRobust=false there, LoopClosing.cc:679); our
matcher's outlier profile differs and the robust phase is strictly safer.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import OptimConfig
from ..geometry.camera import PinholeCamera
from ..geometry.se3 import se3_compose, se3_exp
from ..xmath import HIGHEST, smm, smv, souter, stmv
from .ba import BAProblem, _residual_chi2, _residual_jacobians, _total_cost
from .robust import huber_weight


def _blocks(cam, prob: BAProblem, R, t, xw, active, lam, use_huber, cfg, axis_name):
    """Per-iteration block system: damped U/V, V^-1, per-obs W, gradients."""
    C = prob.R.shape[0]
    P = prob.xw.shape[0]

    r, Jc, Jp, chi2, behind = _residual_jacobians(cam, prob, R, t, xw)
    is_stereo = prob.obs_uvr[:, 2] >= 0
    delta2 = jnp.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
    wh = jnp.where(use_huber, huber_weight(chi2, delta2), 1.0)
    w = prob.obs_inv_sigma2 * wh * active

    free = jnp.take(prob.cam_free, prob.obs_cam)
    Jc = Jc * free[:, None, None]

    U = jax.ops.segment_sum(
        jnp.einsum("oik,o,oil->okl", Jc, w, Jc, precision=HIGHEST),
        prob.obs_cam, num_segments=C,
    )
    V = jax.ops.segment_sum(
        jnp.einsum("oik,o,oil->okl", Jp, w, Jp, precision=HIGHEST),
        prob.obs_pt, num_segments=P,
    )
    b_c = jax.ops.segment_sum(
        jnp.einsum("oik,o,oi->ok", Jc, w, r, precision=HIGHEST),
        prob.obs_cam, num_segments=C,
    )
    b_p = jax.ops.segment_sum(
        jnp.einsum("oik,o,oi->ok", Jp, w, r, precision=HIGHEST),
        prob.obs_pt, num_segments=P,
    )
    if axis_name is not None:
        U = jax.lax.psum(U, axis_name)
        b_c = jax.lax.psum(b_c, axis_name)
    Wcp = jnp.einsum("oik,o,oil->okl", Jc, w, Jp, precision=HIGHEST)  # [O,6,3]

    eyeC = jnp.eye(6, dtype=R.dtype)
    eyeP = jnp.eye(3, dtype=R.dtype)
    U_d = U + lam * eyeC[None] * jnp.maximum(
        jnp.diagonal(U, axis1=1, axis2=2), 1e-6
    )[:, :, None] * eyeC[None] + 1e-8 * eyeC[None]
    V_d = V + lam * eyeP[None] * jnp.maximum(
        jnp.diagonal(V, axis1=1, axis2=2), 1e-6
    )[:, :, None] * eyeP[None] + 1e-8 * eyeP[None]
    # fixed cameras: identity block keeps the PCG system well-posed while the
    # free-mask zeroes their updates
    U_d = jnp.where(prob.cam_free[:, None, None], U_d, eyeC[None])
    V_inv = jnp.linalg.inv(V_d)
    return Wcp, U_d, V_inv, b_c, b_p, chi2, behind, delta2


def _cg_lm_step(cam, prob: BAProblem, R, t, xw, active, lam, use_huber,
                cfg: OptimConfig, cg_iters: int, axis_name=None):
    """One damped LM step with PCG on the (implicit) reduced camera system."""
    C = prob.R.shape[0]
    P = prob.xw.shape[0]

    Wcp, U_d, V_inv, b_c, b_p, chi2, behind, delta2 = _blocks(
        cam, prob, R, t, xw, active, lam, use_huber, cfg, axis_name
    )
    free = prob.cam_free[:, None]

    # Schur RHS: b~ = b_c - sum_o W_o (V^-1 b_p)[pt(o)]
    Vb = jnp.einsum("pkl,pl->pk", V_inv, b_p, precision=HIGHEST)      # [P,3]
    y = jnp.einsum("oik,ok->oi", Wcp, jnp.take(Vb, prob.obs_pt, axis=0),
                   precision=HIGHEST)
    b_corr = jax.ops.segment_sum(y, prob.obs_cam, num_segments=C)
    if axis_name is not None:
        b_corr = jax.lax.psum(b_corr, axis_name)
    rhs = -(b_c - b_corr) * free                                       # [C,6]

    def S_apply(x):
        """(U_d - W V^-1 W^T) x without materializing S."""
        xo = jnp.take(x, prob.obs_cam, axis=0)                         # [O,6]
        wtx = jax.ops.segment_sum(
            jnp.einsum("oik,oi->ok", Wcp, xo, precision=HIGHEST),
            prob.obs_pt, num_segments=P,
        )                                                              # [P,3]
        z = jnp.einsum("pkl,pl->pk", V_inv, wtx, precision=HIGHEST)
        zo = jnp.take(z, prob.obs_pt, axis=0)
        corr = jax.ops.segment_sum(
            jnp.einsum("oik,ok->oi", Wcp, zo, precision=HIGHEST),
            prob.obs_cam, num_segments=C,
        )
        if axis_name is not None:
            corr = jax.lax.psum(corr, axis_name)
        out = jnp.einsum("cij,cj->ci", U_d, x, precision=HIGHEST) - corr
        return out * free

    # block-Jacobi preconditioner M^-1 = U_d^-1 (replicated camera side: dot
    # products need no collective even when sharded)
    M_inv = jnp.linalg.inv(U_d)

    def precond(v):
        return jnp.einsum("cij,cj->ci", M_inv, v, precision=HIGHEST) * free

    def dot(a, b):
        return jnp.sum(a * b)

    x0 = jnp.zeros_like(rhs)
    r0 = rhs  # - S_apply(x0) == rhs
    z0 = precond(r0)

    def cg_body(carry, _):
        x, rr, z, p, rz = carry
        Sp = S_apply(p)
        pSp = dot(p, Sp)
        alpha = rz / jnp.where(jnp.abs(pSp) < 1e-20, 1e-20, pSp)
        # guard: if the residual is already ~0 the step is disabled
        alive = rz > 1e-18
        alpha = jnp.where(alive, alpha, 0.0)
        x = x + alpha * p
        rr = rr - alpha * Sp
        z = precond(rr)
        rz_new = dot(rr, z)
        beta = jnp.where(alive, rz_new / jnp.where(rz < 1e-20, 1e-20, rz), 0.0)
        p = z + beta * p
        return (x, rr, z, p, rz_new), None

    (dx, _, _, _, _), _ = jax.lax.scan(
        cg_body, (x0, r0, z0, z0, dot(r0, z0)), None, length=cg_iters,
        unroll=True,  # tiny sequential matvecs: one fused program, no loop
    )
    delta_c = dx * free

    # back-substitution: delta_p = -V^-1 (b_p + W^T delta_c)
    dco = jnp.take(delta_c, prob.obs_cam, axis=0)
    wt_dc = jax.ops.segment_sum(
        jnp.einsum("oik,oi->ok", Wcp, dco, precision=HIGHEST),
        prob.obs_pt, num_segments=P,
    )
    delta_p = -jnp.einsum("pkl,pl->pk", V_inv, b_p + wt_dc, precision=HIGHEST)

    dR, dt = se3_exp(delta_c)
    R_new, t_new = se3_compose(dR, dt, R, t)
    xw_new = xw + delta_p
    return R_new, t_new, xw_new, chi2, behind, delta2


def ba_solve_cg(
    cam: PinholeCamera,
    prob: BAProblem,
    cfg: OptimConfig,
    iters_phase1: int,
    iters_phase2: int,
    axis_name=None,
):
    """Two-phase LM (Huber, chi2-reclassify, plain) with PCG inner solves —
    drop-in for optim.ba.ba_solve; prob.pt_obs is ignored (the CG path never
    needs per-point observation lists). Returns (R, t, xw, obs_inlier)."""
    cg_iters = cfg.cg_iters

    def phase(R, t, xw, active, lam, n_iters, use_huber):
        def body(carry, _):
            R, t, xw, lam = carry
            Rn, tn, xwn, chi2, behind, delta2 = _cg_lm_step(
                cam, prob, R, t, xw, active, lam, use_huber, cfg, cg_iters, axis_name
            )
            cost_old = _total_cost(chi2, active, delta2, use_huber)
            chi2_new, _ = _residual_chi2(cam, prob, Rn, tn, xwn)
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

    chi2, behind = _residual_chi2(cam, prob, R, t, xw)
    is_stereo = prob.obs_uvr[:, 2] >= 0
    delta2 = jnp.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
    inlier = prob.obs_valid & (chi2 <= delta2) & (~behind)

    if iters_phase2 > 0:
        active1 = inlier.astype(jnp.float32)
        R, t, xw, _ = phase(R, t, xw, active1, lam0, iters_phase2, jnp.bool_(False))
        chi2, behind = _residual_chi2(cam, prob, R, t, xw)
        inlier = prob.obs_valid & (chi2 <= delta2) & (~behind)

    return R, t, xw, inlier


@functools.lru_cache(maxsize=4)
def make_local_ba_cg(cfg: OptimConfig):
    return jax.jit(
        functools.partial(
            ba_solve_cg,
            cfg=cfg,
            iters_phase1=cfg.local_ba_iters1,
            iters_phase2=cfg.local_ba_iters2,
        )
    )


# ---------------------------------------------------------------------------
# host-driven single-iteration stepping: the unit the async pipeline can abort
# between iterations (mbStopGBA / mbAbortBA semantics, LoopClosing.cc:604-608,
# Optimizer.cc:67-68)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def make_gba_iteration(cfg: OptimConfig):
    """Jitted single LM iteration for host-driven (abortable) global BA.

    State threaded on host: (R, t, xw, lam). `active` is the float mask of
    participating observations; `use_huber` selects the robust phase.
    """

    def step(cam, prob: BAProblem, R, t, xw, lam, active, use_huber):
        Rn, tn, xwn, chi2, behind, delta2 = _cg_lm_step(
            cam, prob, R, t, xw, active, lam, use_huber, cfg, cfg.cg_iters, None
        )
        cost_old = _total_cost(chi2, active, delta2, use_huber)
        chi2_new, _ = _residual_chi2(cam, prob, Rn, tn, xwn)
        cost_new = _total_cost(chi2_new, active, delta2, use_huber)
        improved = cost_new < cost_old
        R = jnp.where(improved, Rn, R)
        t = jnp.where(improved, tn, t)
        xw = jnp.where(improved, xwn, xw)
        lam = jnp.where(improved, lam * 0.5, lam * 4.0)
        return R, t, xw, lam, cost_new

    return jax.jit(step)


# ---------------------------------------------------------------------------
# PQ layout: the scatter-free local-BA solver.
#
# The flat-layout solver above reduces observations onto cameras/points with
# jax.ops.segment_sum — a scatter-add. Here observations are laid out densely
# per point (obs index o = p*Q + q, Q = local_ba_max_obs_per_point), so
#   - point-side reductions are a reshape + sum over the Q axis, and
#   - camera-side reductions are ONE one-hot matrix product
#     (HIGHEST precision keeps the f32 accumulation exact: weights are 0/1).
# No scatters anywhere. The camera count C stays small for local windows
# (<=128), so the [P*Q, C] one-hot is ~32 MB and each matmul is ~300 MFLOP.
# ---------------------------------------------------------------------------


def _inv3x3(A):
    """Closed-form (adjugate) batched 3x3 inverse — nine fused elementwise
    ops instead of a batched LU solve."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    adj = jnp.stack([
        jnp.stack([A11, A12, A13], -1),
        jnp.stack([A21, A22, A23], -1),
        jnp.stack([A31, A32, A33], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def _inv6x6_spd(M):
    """Batched 6x6 SPD inverse via 3x3 block Schur complement — closed-form
    elementwise math instead of a batched LU solve. Valid for
    the damped normal-equation blocks (symmetric positive definite)."""
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    D = M[..., 3:, 3:]
    Ai = _inv3x3(A)
    AiB = jnp.einsum("...ij,...jk->...ik", Ai, B, precision=HIGHEST)
    S = D - jnp.einsum("...ji,...jk->...ik", B, AiB, precision=HIGHEST)
    Si = _inv3x3(S)
    TR = -jnp.einsum("...ij,...jk->...ik", AiB, Si, precision=HIGHEST)
    TL = Ai - jnp.einsum("...ij,...kj->...ik", TR, AiB, precision=HIGHEST)
    BL = jnp.swapaxes(TR, -1, -2)
    top = jnp.concatenate([TL, TR], axis=-1)
    bot = jnp.concatenate([BL, Si], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _chol3x3(A):
    """Closed-form Cholesky A = L L^T for batched SPD 3x3 — nine elementwise
    ops."""
    a11, a21, a31 = A[..., 0, 0], A[..., 1, 0], A[..., 2, 0]
    a22, a32, a33 = A[..., 1, 1], A[..., 2, 1], A[..., 2, 2]
    l11 = jnp.sqrt(jnp.maximum(a11, 1e-20))
    l21 = a21 / l11
    l31 = a31 / l11
    l22 = jnp.sqrt(jnp.maximum(a22 - l21 * l21, 1e-20))
    l32 = (a32 - l31 * l21) / l22
    l33 = jnp.sqrt(jnp.maximum(a33 - l31 * l31 - l32 * l32, 1e-20))
    z = jnp.zeros_like(l11)
    return jnp.stack([
        jnp.stack([l11, z, z], -1),
        jnp.stack([l21, l22, z], -1),
        jnp.stack([l31, l32, l33], -1),
    ], -2)


def _cam_onehot(prob: BAProblem):
    """[O, C] f32 0/1 assignment matrix (rebuilt per solve, not per step)."""
    C = prob.R.shape[0]
    return (
        (prob.obs_cam[:, None] == jnp.arange(C, dtype=jnp.int32)[None, :])
        & prob.obs_valid[:, None]
    ).astype(jnp.float32)


def _cg_lm_step_pq(cam, prob: BAProblem, onehot, R, t, xw, active, lam,
                   use_huber, cfg: OptimConfig, cg_iters: int):
    """One damped LM step with PCG, PQ layout (see module comment above)."""
    C = prob.R.shape[0]
    P = prob.xw.shape[0]
    O = prob.obs_cam.shape[0]
    Q = O // P

    r, Jc, Jp, chi2, behind = _residual_jacobians(cam, prob, R, t, xw)
    is_stereo = prob.obs_uvr[:, 2] >= 0
    delta2 = jnp.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
    wh = jnp.where(use_huber, huber_weight(chi2, delta2), 1.0)
    w = prob.obs_inv_sigma2 * wh * active

    free_o = jnp.take(prob.cam_free, prob.obs_cam)
    Jc = Jc * free_o[:, None, None]
    Jcw = Jc * w[:, None, None]                                     # [O,3,6]

    # per-obs block algebra as broadcast multiply-sums (souter/stmv/smv:
    # xmath small-matmul helpers); camera-side reductions as one-hot matmuls
    Uo = souter(Jcw, Jc)                                            # [O,6,6]
    U = jnp.einsum("oc,okl->ckl", onehot, Uo, precision=HIGHEST)    # [C,6,6]
    bco = stmv(Jcw, r)                                              # [O,6]
    b_c = jnp.einsum("oc,ok->ck", onehot, bco, precision=HIGHEST)   # [C,6]

    # point-side blocks via reshape-sum over the Q axis (no scatter)
    Jpw = Jp * w[:, None, None]
    Vo = souter(Jpw, Jp)                                            # [O,3,3]
    V = Vo.reshape(P, Q, 3, 3).sum(axis=1)
    bpo = stmv(Jpw, r)
    b_p = bpo.reshape(P, Q, 3).sum(axis=1)

    Wcp = souter(Jcw, Jp)                                           # [O,6,3]

    eyeC = jnp.eye(6, dtype=R.dtype)
    eyeP = jnp.eye(3, dtype=R.dtype)
    U_d = U + lam * eyeC[None] * jnp.maximum(
        jnp.diagonal(U, axis1=1, axis2=2), 1e-6
    )[:, :, None] * eyeC[None] + 1e-8 * eyeC[None]
    V_d = V + lam * eyeP[None] * jnp.maximum(
        jnp.diagonal(V, axis1=1, axis2=2), 1e-6
    )[:, :, None] * eyeP[None] + 1e-8 * eyeP[None]
    U_d = jnp.where(prob.cam_free[:, None, None], U_d, eyeC[None])
    V_inv = _inv3x3(V_d)
    free = prob.cam_free[:, None]

    def pt_gather(z):
        """[P,3] -> per-obs [O,3] (pure broadcast: o = p*Q + q)."""
        return jnp.broadcast_to(z[:, None, :], (P, Q, 3)).reshape(O, 3)

    # Schur RHS: b~ = b_c - sum_o W_o (V^-1 b_p)[pt(o)]
    Vb = smv(V_inv, b_p)
    y = smv(Wcp, pt_gather(Vb))
    b_corr = jnp.einsum("oc,oi->ci", onehot, y, precision=HIGHEST)
    rhs = -(b_c - b_corr) * free

    def S_apply(x):
        xo = jnp.take(x, prob.obs_cam, axis=0)                      # [O,6]
        wtx = stmv(Wcp, xo)                                         # [O,3]
        wtx = wtx.reshape(P, Q, 3).sum(axis=1)                      # [P,3]
        z = smv(V_inv, wtx)
        yo = smv(Wcp, pt_gather(z))
        corr = jnp.einsum("oc,oi->ci", onehot, yo, precision=HIGHEST)
        out = smv(U_d, x) - corr
        return out * free

    M_inv = _inv6x6_spd(U_d)

    def precond(v):
        return smv(M_inv, v) * free

    def dot(a, b):
        return jnp.sum(a * b)

    x0 = jnp.zeros_like(rhs)
    r0 = rhs
    z0 = precond(r0)

    def cg_body(carry, _):
        x, rr, z, p, rz = carry
        Sp = S_apply(p)
        pSp = dot(p, Sp)
        alpha = rz / jnp.where(jnp.abs(pSp) < 1e-20, 1e-20, pSp)
        alive = rz > 1e-18
        alpha = jnp.where(alive, alpha, 0.0)
        x = x + alpha * p
        rr = rr - alpha * Sp
        z = precond(rr)
        rz_new = dot(rr, z)
        beta = jnp.where(alive, rz_new / jnp.where(rz < 1e-20, 1e-20, rz), 0.0)
        p = z + beta * p
        return (x, rr, z, p, rz_new), None

    (dx, _, _, _, _), _ = jax.lax.scan(
        cg_body, (x0, r0, z0, z0, dot(r0, z0)), None, length=cg_iters,
        unroll=True,  # tiny sequential matvecs: one fused program, no loop
    )
    delta_c = dx * free

    dco = jnp.take(delta_c, prob.obs_cam, axis=0)
    wt_dc = stmv(Wcp, dco)
    wt_dc = wt_dc.reshape(P, Q, 3).sum(axis=1)
    delta_p = -smv(V_inv, b_p + wt_dc)

    dR, dt = se3_exp(delta_c)
    R_new, t_new = se3_compose(dR, dt, R, t)
    xw_new = xw + delta_p
    return R_new, t_new, xw_new, chi2, behind, delta2


# Precision of the two large Schur contractions (M~ and S = M~ M~^T) and of
# the RHS correction in the RCS step. On an H100, Precision.HIGH is TF32 and
# HIGHEST is full f32. Measured there at C=128, P=2048, Q=8 against a float64
# reference (max-abs error over max |S|): HIGH 1.7e-5, HIGHEST 3.7e-6,
# 3-pass bf16 4.1e-6; HIGH is the fastest of the three and within the 1e-4
# bound (chip_smoke.py parity phase; CHANGES.md).
SCHUR_PRECISION = jax.lax.Precision.HIGH


def _rcs_blocks(cam, prob: BAProblem, R, t, xw, active, lam, use_huber,
                cfg: OptimConfig):
    """Per-observation and per-point blocks of the damped normal equations
    in the PQ layout (obs index o = p*Q + q)."""
    P = prob.xw.shape[0]
    O = prob.obs_cam.shape[0]
    Q = O // P

    r, Jc, Jp, chi2, behind = _residual_jacobians(cam, prob, R, t, xw)
    is_stereo = prob.obs_uvr[:, 2] >= 0
    delta2 = jnp.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
    wh = jnp.where(use_huber, huber_weight(chi2, delta2), 1.0)
    w = prob.obs_inv_sigma2 * wh * active

    free_o = jnp.take(prob.cam_free, prob.obs_cam)
    Jc = Jc * free_o[:, None, None]
    Jcw = Jc * w[:, None, None]

    Uo = souter(Jcw, Jc)                                            # [O,6,6]
    bco = stmv(Jcw, r)
    Jpw = Jp * w[:, None, None]
    Vo = souter(Jpw, Jp)
    V = Vo.reshape(P, Q, 3, 3).sum(axis=1)
    bpo = stmv(Jpw, r)
    b_p = bpo.reshape(P, Q, 3).sum(axis=1)
    Wcp = souter(Jcw, Jp)                                           # [O,6,3]

    eyeP = jnp.eye(3, dtype=R.dtype)
    V_d = V + lam * eyeP[None] * jnp.maximum(
        jnp.diagonal(V, axis1=1, axis2=2), 1e-6
    )[:, :, None] * eyeP[None] + 1e-8 * eyeP[None]
    V_inv = _inv3x3(V_d)
    return Uo, bco, Wcp, V_inv, b_p, chi2, behind, delta2


def _rcs_schur(prob: BAProblem, onehot_pq, Uo, bco, Wcp, V_inv, b_p, lam,
               precision=SCHUR_PRECISION):
    """Materialize the reduced camera system: S = U_d - W V^-1 W^T
    ([6C, 6C], fixed cameras collapsed to identity rows/cols) and its RHS
    -(b_c - W V^-1 b_p). Returns (S, rhs, U_d)."""
    C = prob.R.shape[0]
    P = prob.xw.shape[0]
    O = prob.obs_cam.shape[0]
    Q = O // P
    dtype = Wcp.dtype

    U = jnp.einsum("oc,okl->ckl", onehot_pq, Uo, precision=HIGHEST)
    b_c = jnp.einsum("oc,ok->ck", onehot_pq, bco, precision=HIGHEST)
    eyeC = jnp.eye(6, dtype=dtype)
    U_d = U + lam * eyeC[None] * jnp.maximum(
        jnp.diagonal(U, axis1=1, axis2=2), 1e-6
    )[:, :, None] * eyeC[None] + 1e-8 * eyeC[None]
    U_d = jnp.where(prob.cam_free[:, None, None], U_d, eyeC[None])
    free = prob.cam_free[:, None]

    # Factor V^-1 = F F^T (F = chol of the inverse) and fold F into the W
    # blocks: Y_o = W_o F_p(o). Then the Schur correction is the symmetric
    # product sum_p M~_p M~_p^T with M~ = sum_q onehot * Y — one [P,C,6,3]
    # intermediate, and both big contractions run as dot_general straight
    # out of the natural layout (no transposes).
    F = _chol3x3(V_inv)
    Yr = jnp.einsum("pqik,pkl->pqil", Wcp.reshape(P, Q, 6, 3), F,
                    precision=HIGHEST)
    oh = onehot_pq.reshape(P, Q, C)
    # M~[p,c,i,k] = sum_q oh[p,q,c] Y[p,q,i,k]
    Mt = jax.lax.dot_general(oh, Yr, (((1,), (1,)), ((0,), (0,))),
                             precision=precision)                 # [P,C,6,3]
    S4 = jax.lax.dot_general(Mt, Mt, (((0, 3), (0, 3)), ((), ())),
                             precision=precision)                 # [C,6,C,6]
    # block-diagonal U_d placed by an exact broadcast multiply, no scatter
    U4 = U_d[:, :, None, :] * jnp.eye(C, dtype=dtype)[:, None, :, None]
    S = (U4 - S4).reshape(6 * C, 6 * C)

    u = jnp.einsum("pkl,pk->pl", F, b_p, precision=HIGHEST)       # F^T b_p
    b_corr = jax.lax.dot_general(Mt, u, (((0, 3), (0, 1)), ((), ())),
                                 precision=precision)             # [C,6]
    rhs = (-(b_c - b_corr) * free).reshape(-1)

    # keep fixed cameras decoupled: their rows/cols collapse to identity
    free_flat = jnp.repeat(prob.cam_free, 6)
    mask2 = free_flat[:, None] & free_flat[None, :]
    S = jnp.where(mask2, S, jnp.eye(6 * C, dtype=dtype))
    return S, rhs * free_flat, U_d


def _cg_lm_step_rcs(cam, prob: BAProblem, onehot_pq, R, t, xw, active, lam,
                    use_huber, cfg: OptimConfig, cg_iters: int,
                    precision=SCHUR_PRECISION):
    """One damped LM step with the reduced camera system MATERIALIZED.

    The matrix-free PQ step above touches the [O, C] one-hot and every [O, .]
    block three times per CG iteration. Here the per-point W blocks are
    contracted into the dense Schur complement S = U_d - W V^-1 W^T
    ([6C, 6C]) with two matrix products once per LM step (the dense form of
    g2o's `_Hschur` block solver, block_solver.hpp:51-123), and the PCG
    iterations run on [6C] vectors at negligible cost. Valid for local
    windows (C <= ~160); global BA above 128 cameras keeps the matrix-free
    path. `precision` is that of the Schur contractions (SCHUR_PRECISION)."""
    C = prob.R.shape[0]
    P = prob.xw.shape[0]
    O = prob.obs_cam.shape[0]
    Q = O // P

    Uo, bco, Wcp, V_inv, b_p, chi2, behind, delta2 = _rcs_blocks(
        cam, prob, R, t, xw, active, lam, use_huber, cfg
    )
    S, rhs, U_d = _rcs_schur(prob, onehot_pq, Uo, bco, Wcp, V_inv, b_p, lam,
                             precision)
    free = prob.cam_free[:, None]
    free_flat = jnp.repeat(prob.cam_free, 6)

    # PCG on the dense (small) system — each iteration is one [6C,6C] matvec
    M_inv = _inv6x6_spd(U_d)

    def precond(v):
        return (smv(M_inv, v.reshape(C, 6)) * free).reshape(-1)

    def dot(a, b):
        return jnp.sum(a * b)

    x0 = jnp.zeros_like(rhs)
    r0 = rhs
    z0 = precond(r0)

    def cg_body(carry, _):
        x, rr, z, p, rz = carry
        Sp = jnp.matmul(S, p, precision=HIGHEST) * free_flat
        pSp = dot(p, Sp)
        alpha = rz / jnp.where(jnp.abs(pSp) < 1e-20, 1e-20, pSp)
        alive = rz > 1e-18
        alpha = jnp.where(alive, alpha, 0.0)
        x = x + alpha * p
        rr = rr - alpha * Sp
        z = precond(rr)
        rz_new = dot(rr, z)
        beta = jnp.where(alive, rz_new / jnp.where(rz < 1e-20, 1e-20, rz), 0.0)
        p = z + beta * p
        return (x, rr, z, p, rz_new), None

    (dx, _, _, _, _), _ = jax.lax.scan(
        cg_body, (x0, r0, z0, z0, dot(r0, z0)), None, length=cg_iters,
        unroll=True,  # tiny sequential matvecs: one fused program, no loop
    )
    delta_c = dx.reshape(C, 6) * free

    # back-substitution: delta_p = -V^-1 (b_p + W^T delta_c)
    dco = jnp.take(delta_c, prob.obs_cam, axis=0)
    wt_dc = stmv(Wcp, dco).reshape(P, Q, 3).sum(axis=1)
    delta_p = -smv(V_inv, b_p + wt_dc)

    dR, dt = se3_exp(delta_c)
    R_new, t_new = se3_compose(dR, dt, R, t)
    xw_new = xw + delta_p
    return R_new, t_new, xw_new, chi2, behind, delta2


def ba_solve_cg_pq(cam, prob: BAProblem, cfg: OptimConfig,
                   iters_phase1: int, iters_phase2: int):
    """PQ-layout two-phase LM — drop-in for ba_solve_cg on problems assembled
    with pq_layout=True (obs index o = p*Q + q)."""
    onehot = _cam_onehot(prob)
    cg_iters = cfg.cg_iters

    def phase(R, t, xw, active, lam, n_iters, use_huber):
        def body(carry, _):
            R, t, xw, lam = carry
            Rn, tn, xwn, chi2, behind, delta2 = _cg_lm_step_rcs(
                cam, prob, onehot, R, t, xw, active, lam, use_huber, cfg, cg_iters
            )
            cost_old = _total_cost(chi2, active, delta2, use_huber)
            chi2_new, _ = _residual_chi2(cam, prob, Rn, tn, xwn)
            cost_new = _total_cost(chi2_new, active, delta2, use_huber)
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

    chi2, behind = _residual_chi2(cam, prob, R, t, xw)
    is_stereo = prob.obs_uvr[:, 2] >= 0
    delta2 = jnp.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
    inlier = prob.obs_valid & (chi2 <= delta2) & (~behind)

    if iters_phase2 > 0:
        active1 = inlier.astype(jnp.float32)
        R, t, xw, _ = phase(R, t, xw, active1, lam0, iters_phase2, jnp.bool_(False))
        chi2, behind = _residual_chi2(cam, prob, R, t, xw)
        inlier = prob.obs_valid & (chi2 <= delta2) & (~behind)

    return R, t, xw, inlier


@functools.lru_cache(maxsize=4)
def make_local_ba_cg_pq(cfg: OptimConfig):
    return jax.jit(
        functools.partial(
            ba_solve_cg_pq,
            cfg=cfg,
            iters_phase1=cfg.local_ba_iters1,
            iters_phase2=cfg.local_ba_iters2,
        )
    )


@functools.lru_cache(maxsize=16)
def make_lm_chunk_pq(cfg: OptimConfig, n_iters: int):
    """Jitted CHUNK of n_iters PQ-layout LM iterations (lax.scan inside one
    program). The abortable local BA steps in chunks instead of single
    iterations, so the host syncs once per chunk rather than once per
    iteration. Abort granularity (mbAbortBA, Optimizer.cc:519-520) coarsens
    to the chunk boundary."""

    def chunk(cam, prob: BAProblem, R, t, xw, lam, active, use_huber):
        onehot = _cam_onehot(prob)

        def body(carry, _):
            R, t, xw, lam = carry
            Rn, tn, xwn, chi2, behind, delta2 = _cg_lm_step_rcs(
                cam, prob, onehot, R, t, xw, active, lam, use_huber, cfg,
                cfg.cg_iters
            )
            cost_old = _total_cost(chi2, active, delta2, use_huber)
            chi2_new, _ = _residual_chi2(cam, prob, Rn, tn, xwn)
            cost_new = _total_cost(chi2_new, active, delta2, use_huber)
            improved = cost_new < cost_old
            R = jnp.where(improved, Rn, R)
            t = jnp.where(improved, tn, t)
            xw = jnp.where(improved, xwn, xw)
            lam = jnp.where(improved, lam * 0.5, lam * 4.0)
            return (R, t, xw, lam), None

        (R, t, xw, lam), _ = jax.lax.scan(
            body, (R, t, xw, lam), None, length=n_iters
        )
        # classification at the chunk's exit state rides along so the caller
        # never needs a separate classify dispatch
        chi2, behind = _residual_chi2(cam, prob, R, t, xw)
        is_stereo = prob.obs_uvr[:, 2] >= 0
        delta2 = jnp.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
        inlier = prob.obs_valid & (chi2 <= delta2) & (~behind)
        return R, t, xw, lam, inlier

    return jax.jit(chunk)


@functools.lru_cache(maxsize=4)
def make_lm_iteration_pq(cfg: OptimConfig):
    """Single PQ-layout LM iteration for the abortable host-stepped local BA
    (mbAbortBA semantics, Optimizer.cc:519-520)."""

    def step(cam, prob: BAProblem, R, t, xw, lam, active, use_huber):
        onehot = _cam_onehot(prob)
        Rn, tn, xwn, chi2, behind, delta2 = _cg_lm_step_pq(
            cam, prob, onehot, R, t, xw, active, lam, use_huber, cfg, cfg.cg_iters
        )
        cost_old = _total_cost(chi2, active, delta2, use_huber)
        chi2_new, _ = _residual_chi2(cam, prob, Rn, tn, xwn)
        cost_new = _total_cost(chi2_new, active, delta2, use_huber)
        improved = cost_new < cost_old
        R = jnp.where(improved, Rn, R)
        t = jnp.where(improved, tn, t)
        xw = jnp.where(improved, xwn, xw)
        lam = jnp.where(improved, lam * 0.5, lam * 4.0)
        return R, t, xw, lam, cost_new

    return jax.jit(step)


@functools.lru_cache(maxsize=4)
def make_classify(cfg: OptimConfig):
    """Jitted chi2 inlier classification at the current state."""

    def classify(cam, prob: BAProblem, R, t, xw):
        chi2, behind = _residual_chi2(cam, prob, R, t, xw)
        is_stereo = prob.obs_uvr[:, 2] >= 0
        delta2 = jnp.where(is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
        return prob.obs_valid & (chi2 <= delta2) & (~behind)

    return jax.jit(classify)
