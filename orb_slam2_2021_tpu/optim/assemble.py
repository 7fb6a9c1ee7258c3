"""Vectorized BA problem assembly from the map store.

Replaces the per-point Python loops that built BAProblem tensors (the
host-side analogue of g2o graph construction in
/root/reference/src/Optimizer.cc:51-122, 456-560) with pure numpy gathers
over the observation reverse index — one fancy-indexing pass regardless of
problem size.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax.numpy as jnp

from .ba import BAProblem


def _bucket(n: int, lo: int) -> int:
    """Round up to a power-of-two bucket (>= lo) to bound jit recompiles."""
    b = lo
    while b < n:
        b *= 2
    return b


def assemble_ba_problem(
    m,                       # MapStore
    cams: np.ndarray,        # [c] keyframe ids (order defines camera slots)
    cam_free: np.ndarray,    # [c] bool
    mp: np.ndarray,          # [p] map point ids
    C_pad: int,
    P_pad: int,
    O_pad: Optional[int] = None,
    Q_pad: Optional[int] = None,
    obs_per_point_cap: Optional[int] = None,
    pq_layout: bool = False,
    device: bool = True,
) -> Tuple[BAProblem, np.ndarray, np.ndarray, np.ndarray]:
    """Build a padded BAProblem from map-store state.

    Returns (prob, obs_kf, obs_feat, obs_mp): the per-observation source
    arrays (length = prob.obs_cam.shape[0]) for outlier write-back; padding
    slots hold -1.

    When Q_pad is given, prob.pt_obs is populated (dense reduced-system
    path); otherwise it is a [P_pad, 1] dummy of -1 (CG path ignores it).
    """
    c, p = len(cams), len(mp)
    assert c <= C_pad and p <= P_pad

    cam_lut = np.full(m.kf_R.shape[0], -1, np.int64)
    cam_lut[cams] = np.arange(c)

    okf = m.mp_obs_kf[mp]                    # [p, obs_cap]
    ofe = m.mp_obs_feat[mp]
    ok = okf >= 0
    ok &= cam_lut[np.clip(okf, 0, None)] >= 0
    if obs_per_point_cap is not None and obs_per_point_cap < okf.shape[1]:
        # keep the first cap observations per point (oldest-first, matching
        # the reverse-index insertion order)
        keep = np.cumsum(ok, axis=1) <= obs_per_point_cap
        ok &= keep

    pt_idx_full = np.broadcast_to(np.arange(p)[:, None], ok.shape)
    flat_pt = pt_idx_full[ok]
    flat_kf = okf[ok]
    flat_fe = ofe[ok].astype(np.int64)
    n_obs = len(flat_pt)
    if O_pad is None:
        O_pad = _bucket(max(n_obs, 1), 128)
    if n_obs > O_pad:
        # drop the tail deterministically (points are ordered by id; callers
        # size O_pad to make this unreachable in practice)
        flat_pt, flat_kf, flat_fe = flat_pt[:O_pad], flat_kf[:O_pad], flat_fe[:O_pad]
        n_obs = O_pad

    obs_cam = np.zeros(O_pad, np.int32)
    obs_pt = np.zeros(O_pad, np.int32)
    obs_uvr = np.full((O_pad, 3), -1.0, np.float32)
    obs_is2 = np.ones(O_pad, np.float32)
    obs_valid = np.zeros(O_pad, bool)
    obs_kf_src = np.full(O_pad, -1, np.int64)
    obs_fe_src = np.full(O_pad, -1, np.int64)
    obs_mp_src = np.full(O_pad, -1, np.int64)

    sigma2 = m.scale_factors.astype(np.float32) ** 2
    obs_cam[:n_obs] = cam_lut[flat_kf]
    obs_pt[:n_obs] = flat_pt
    uv = m.kf_xy[flat_kf, flat_fe]
    ur = m.kf_ur[flat_kf, flat_fe]
    obs_uvr[:n_obs, 0] = uv[:, 0]
    obs_uvr[:n_obs, 1] = uv[:, 1]
    obs_uvr[:n_obs, 2] = ur
    octv = np.clip(m.kf_octave[flat_kf, flat_fe], 0, len(sigma2) - 1)
    obs_is2[:n_obs] = 1.0 / np.maximum(sigma2[octv], 1e-6)
    obs_valid[:n_obs] = True
    obs_kf_src[:n_obs] = flat_kf
    obs_fe_src[:n_obs] = flat_fe
    obs_mp_src[:n_obs] = mp[flat_pt]

    if Q_pad is not None:
        pt_obs = np.full((P_pad, Q_pad), -1, np.int32)
        if n_obs:
            # rank of each observation within its point's (contiguous) run
            starts = np.r_[0, np.nonzero(np.diff(flat_pt))[0] + 1]
            runpos = np.arange(n_obs) - np.repeat(starts, np.diff(np.r_[starts, n_obs]))
            keepq = runpos < Q_pad
            pt_obs[flat_pt[keepq], runpos[keepq]] = np.nonzero(keepq)[0]
    else:
        pt_obs = np.full((P_pad, 1), -1, np.int32)

    if pq_layout:
        # re-scatter the flat observation arrays into the dense per-point
        # layout (obs index o = p*Q + q) consumed by optim.ba_cg's PQ solver:
        # point reductions become reshape-sums and camera reductions one-hot
        # matmuls — no scatters. Requires Q_pad (and callers should
        # pass obs_per_point_cap = Q_pad so nothing silently drops here).
        assert Q_pad is not None
        sel = np.clip(pt_obs, 0, None).reshape(-1)
        val = (pt_obs >= 0).reshape(-1)

        def g(arr, fill):
            out = np.full((P_pad * Q_pad,) + arr.shape[1:], fill, arr.dtype)
            out[val] = arr[sel[val]]
            return out

        obs_cam = g(obs_cam, 0)
        obs_uvr = g(obs_uvr, -1.0)
        obs_is2 = g(obs_is2, 1.0)
        obs_kf_src = g(obs_kf_src, -1)
        obs_fe_src = g(obs_fe_src, -1)
        obs_mp_src = g(obs_mp_src, -1)
        obs_valid = val
        obs_pt = np.repeat(np.arange(P_pad, dtype=np.int32), Q_pad)

    Rb = np.tile(np.eye(3, dtype=np.float32), (C_pad, 1, 1))
    tb = np.zeros((C_pad, 3), np.float32)
    Rb[:c] = m.kf_R[cams]
    tb[:c] = m.kf_t[cams]
    free = np.zeros(C_pad, bool)
    free[:c] = cam_free

    xw = np.zeros((P_pad, 3), np.float32)
    xw[:p] = m.mp_pos[mp]

    # device=False returns host numpy so callers can release the map lock
    # BEFORE paying the uploads (the worker's lock time otherwise blocks the
    # tracking lane for the upload duration); upload_problem converts.
    conv = jnp.asarray if device else (lambda x: x)
    prob = BAProblem(
        R=conv(Rb), t=conv(tb), xw=conv(xw),
        obs_cam=conv(obs_cam), obs_pt=conv(obs_pt),
        obs_uvr=conv(obs_uvr), obs_inv_sigma2=conv(obs_is2),
        obs_valid=conv(obs_valid), pt_obs=conv(pt_obs),
        cam_free=conv(free),
    )
    return prob, obs_kf_src, obs_fe_src, obs_mp_src


def upload_problem(prob: BAProblem) -> BAProblem:
    """Convert a host-assembled (device=False) BAProblem to device arrays."""
    return BAProblem(*(None if v is None else jnp.asarray(v) for v in prob))


def global_problem_shapes(n_cams: int, n_pts: int, n_obs: int) -> Tuple[int, int, int]:
    """Power-of-two padded shapes for the all-KF global problem."""
    return _bucket(n_cams, 64), _bucket(n_pts, 1024), _bucket(n_obs, 4096)
