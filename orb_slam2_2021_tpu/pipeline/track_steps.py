"""Jitted device steps for the tracking front-end.

Each step fuses a matcher pass with the motion-only LM pose solve so one
device launch covers what the reference does in
TrackWithMotionModel/TrackLocalMap (Tracking.cc:887-948, 950-994): matching,
observation assembly, 4x10 LM with chi2 gating.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..geometry.camera import PinholeCamera
from ..frontend.features import Keypoints
from ..frontend.matchers import (
    match_bruteforce_desc,
    match_last_frame,
    match_local_points,
)
from ..optim.pose import PoseObs, pose_optimize
from ..xmath import HIGHEST


def _inv_sigma2(octave, scale_factor, n_levels):
    s2 = jnp.asarray(
        [scale_factor ** (2 * i) for i in range(n_levels)], jnp.float32
    )
    return 1.0 / jnp.take(s2, jnp.clip(octave, 0, n_levels - 1))


def _pose_obs_from_matches(kp: Keypoints, feat_ur, xw_per_feat, bound, cfg: SlamConfig):
    uvr = jnp.concatenate([kp.xy, feat_ur[:, None]], axis=1)
    return PoseObs(
        xw=xw_per_feat,
        uvr=uvr,
        inv_sigma2=_inv_sigma2(kp.octave, cfg.orb.scale_factor, cfg.orb.n_levels),
        valid=bound,
    )


def motion_track_step(
    cam: PinholeCamera,
    kp: Keypoints,
    feat_ur,
    R_pred, t_pred,
    last_xw, last_desc, last_octave, last_angle, last_valid,
    radius,
    cfg: SlamConfig,
):
    """SearchByProjection(cur, last) + PoseOptimization.

    Returns (R, t, match_slot [N] int32 last-frame slot per feature (-1),
    inlier [N] bool, n_inliers).
    """
    best_feat, accept, dist = match_last_frame(
        cam, kp, feat_ur, R_pred, t_pred,
        last_xw, last_desc, last_octave, last_angle, last_valid,
        cfg, radius,
    )
    n = kp.capacity
    # scatter query->feature matches into per-feature arrays
    slot = jnp.full((n,), -1, jnp.int32)
    qidx = jnp.arange(last_xw.shape[0], dtype=jnp.int32)
    slot = slot.at[jnp.where(accept, best_feat, n)].set(
        jnp.where(accept, qidx, -1), mode="drop"
    )
    bound = slot >= 0
    xw = jnp.take(last_xw, jnp.clip(slot, 0), axis=0)

    obs = _pose_obs_from_matches(kp, feat_ur, xw, bound, cfg)
    R, t, inlier, n_in = pose_optimize(cam, R_pred, t_pred, obs, cfg.optim)
    return R, t, slot, inlier, n_in, jnp.sum(bound)


def bow_track_step(
    cam: PinholeCamera,
    kp: Keypoints,
    feat_ur,
    R0, t0,
    lm_xw, lm_desc, lm_angle, lm_valid,
    cfg: SlamConfig,
):
    """TrackReferenceKeyFrame matching + PoseOptimization
    (Tracking.cc:777-819): WINDOW-FREE descriptor matching of the reference
    keyframe's landmarks against the current frame (the reference uses
    SearchByBoW, ORBmatcher.cc:165-293 — descriptor-only with ratio +
    rotation-histogram gates, no projection window), then the 4x10 LM from
    the last pose. This is the recovery path when the motion prior is bad —
    exactly when a projection window is weakest.

    Returns (R, t, match_slot [N] landmark slot per feature (-1), inlier [N],
    n_inliers, n_matched)."""
    best_b, accept, dist = match_bruteforce_desc(
        lm_desc, lm_valid, lm_angle, kp.desc, kp.valid, kp.angle,
    )
    n = kp.capacity
    a = lm_xw.shape[0]
    slot = jnp.full((n,), -1, jnp.int32)
    qidx = jnp.arange(a, dtype=jnp.int32)
    slot = slot.at[jnp.where(accept, best_b, n)].set(
        jnp.where(accept, qidx, -1), mode="drop"
    )
    bound = slot >= 0
    xw = jnp.take(lm_xw, jnp.clip(slot, 0), axis=0)

    obs = _pose_obs_from_matches(kp, feat_ur, xw, bound, cfg)
    R, t, inlier, n_in = pose_optimize(cam, R0, t0, obs, cfg.optim)
    return R, t, slot, inlier, n_in, jnp.sum(bound)


def local_track_step(
    cam: PinholeCamera,
    kp: Keypoints,
    feat_ur,
    R0, t0,
    bound_xw,          # [N, 3] world pos for already-bound features
    bound_mask,        # [N] bool
    mp_pos, mp_normal, mp_min_dist, mp_max_dist, mp_desc, mp_valid,
    cfg: SlamConfig,
    th: float = 1.0,
):
    """SearchLocalPoints + final PoseOptimization (Tracking.cc:950-994).

    Returns (R, t, new_slot [N] int32 local-snapshot slot per feature (-1),
    inlier [N], n_inliers, visible [P]).
    """
    best_feat, accept, dist, visible = match_local_points(
        cam, kp, feat_ur, bound_mask, R0, t0,
        mp_pos, mp_normal, mp_min_dist, mp_max_dist, mp_desc, mp_valid,
        cfg, th,
    )
    n = kp.capacity
    slot = jnp.full((n,), -1, jnp.int32)
    qidx = jnp.arange(mp_pos.shape[0], dtype=jnp.int32)
    slot = slot.at[jnp.where(accept, best_feat, n)].set(
        jnp.where(accept, qidx, -1), mode="drop"
    )
    new_bound = slot >= 0
    xw = jnp.where(
        bound_mask[:, None], bound_xw,
        jnp.take(mp_pos, jnp.clip(slot, 0), axis=0),
    )
    all_bound = bound_mask | new_bound

    obs = _pose_obs_from_matches(kp, feat_ur, xw, all_bound, cfg)
    R, t, inlier, n_in = pose_optimize(cam, R0, t0, obs, cfg.optim)
    return R, t, slot, inlier, n_in, visible


def fused_track_step(
    cam: PinholeCamera,
    kp: Keypoints,
    feat_ur,
    depth,
    last_desc, last_octave, last_angle, last_kp_valid,  # device refs (prev frame)
    last_geom,      # [N, 4] f32: world pos (3) + map-liveness flag
    last_slot,      # [N] i32: local-snapshot slot of each last-frame landmark (-1)
    pose_pack,      # [16] f32: R_pred(9), t_pred(3), radius, depth_th, min_matched
    snap_geom,      # [P, 8] f32: pos(3), normal(3), min_dist, max_dist
    snap_desc,      # [P, 8] u32
    snap_valid,     # [P] bool
    cfg: SlamConfig,
):
    """TrackWithMotionModel + TrackLocalMap in ONE device program
    (Tracking.cc:887-948 then :950-994), with the widened-window retry
    (Tracking.cc:920-927) as a lax.cond instead of a second host dispatch.

    The transfer contract is the point of this fusion: per frame the host
    uploads two small packed arrays (last_geom+last_slot, pose_pack) and pulls
    two packed results; descriptors/angles/octaves of the last frame are
    device-resident refs from the previous frame build, and the local-map
    snapshot is a device-cached upload refreshed only when the map changes.
    Each device->host copy is a host sync, so the step keeps the transfer
    COUNT low, not just the bytes.

    Returns (out_f [30] f32, out_i [N + P] i32):
      out_f = [R_final(9), t_final(3), n_matched_motion, n_in_motion,
               n_in_final, tracked_close, untracked_close, widened_retry,
               R_motion(9), t_motion(3)]
      out_i = [enc (N): -1 unbound / [0,N) last-frame slot / [N,N+P) snapshot
               slot, all post-inlier-gating; visible (P) 0/1]
    """
    R_pred = pose_pack[:9].reshape(3, 3)
    t_pred = pose_pack[9:12]
    radius = pose_pack[12]
    depth_th = pose_pack[13]
    min_matched = pose_pack[14].astype(jnp.int32)

    last_xw = last_geom[:, :3]
    last_valid = (last_geom[:, 3] > 0) & last_kp_valid

    def motion(r):
        R, t, slot, inlier, n_in, n_matched = motion_track_step(
            cam, kp, feat_ur, R_pred, t_pred,
            last_xw, last_desc, last_octave, last_angle, last_valid,
            r, cfg,
        )
        return R, t, slot, inlier, jnp.int32(n_in), jnp.int32(n_matched)

    first = motion(radius)
    widened = first[5] < min_matched
    R1, t1, slot1, inl1, nin1, nm1 = jax.lax.cond(
        widened, lambda: motion(2.0 * radius), lambda: first
    )

    n = kp.capacity
    bound = (slot1 >= 0) & inl1
    bound_xw = jnp.take(last_xw, jnp.clip(slot1, 0), axis=0)

    # exclude points already matched this frame from the local search
    # (SearchLocalPoints skips mnLastFrameSeen == cur, Tracking.cc:1172-1178)
    P = snap_valid.shape[0]
    sel_slot = jnp.where(bound, jnp.take(last_slot, jnp.clip(slot1, 0)), -1)
    already = jnp.zeros(P, bool).at[
        jnp.where(sel_slot >= 0, sel_slot, P)
    ].set(True, mode="drop")
    snap_ok = snap_valid & ~already

    R2, t2, slot2, inl2, nin2, visible = local_track_step(
        cam, kp, feat_ur, R1, t1, bound_xw, bound,
        snap_geom[:, :3], snap_geom[:, 3:6], snap_geom[:, 6], snap_geom[:, 7],
        snap_desc, snap_ok, cfg,
    )

    new_bound = slot2 >= 0
    enc = jnp.where(bound, slot1, jnp.full((n,), -1, jnp.int32))
    enc = jnp.where(new_bound, slot2 + n, enc)
    enc = jnp.where((bound | new_bound) & inl2, enc, -1)

    close = (depth > 0) & (depth < depth_th) & kp.valid
    tracked_close = jnp.sum(close & (enc >= 0))
    untracked_close = jnp.sum(close & (enc < 0))

    f32 = jnp.float32
    out_f = jnp.concatenate([
        R2.reshape(-1), t2,
        jnp.stack([
            nm1.astype(f32), nin1.astype(f32), jnp.asarray(nin2, f32),
            tracked_close.astype(f32), untracked_close.astype(f32),
            widened.astype(f32),
        ]),
        R1.reshape(-1), t1,
    ])
    out_i = jnp.concatenate([enc, visible.astype(jnp.int32)])
    return out_f, out_i


def fused_track_step_packed(
    cam: PinholeCamera,
    kp: Keypoints,
    feat_ur,
    depth,
    last_desc, last_octave, last_angle, last_kp_valid,
    host_pack,      # [N*5 + 16] f32: geom(N*4) | last_slot bitcast (N) | pose_pack(16)
    snap_geom, snap_desc, snap_valid,
    cfg: SlamConfig,
):
    """fused_track_step with ONE packed host upload and ONE packed pull.

    The unpacked fused step pays 3 uploads + 2 pulls per frame. This
    wrapper bitcasts the int lanes through the f32 upload buffer and the
    float lanes through the i32 result buffer so the frame costs exactly one
    of each. Layout documented in _track_fused (tracking.py).
    """
    n = kp.capacity
    last_geom = host_pack[: 4 * n].reshape(n, 4)
    last_slot = jax.lax.bitcast_convert_type(
        host_pack[4 * n : 5 * n], jnp.int32
    )
    pose_pack = host_pack[5 * n :]
    out_f, out_i = fused_track_step(
        cam, kp, feat_ur, depth,
        last_desc, last_octave, last_angle, last_kp_valid,
        last_geom, last_slot, pose_pack,
        snap_geom, snap_desc, snap_valid,
        cfg,
    )
    return jnp.concatenate(
        [jax.lax.bitcast_convert_type(out_f, jnp.int32), out_i]
    )


def frame_pack_step(kp: Keypoints, feat_ur, depth):
    """Pack per-frame arrays for a SINGLE device->host pull pair (f32 + u32)
    at keyframe creation / initialization — the only times the host needs the
    raw feature data."""
    f = jnp.concatenate([
        kp.xy,
        feat_ur[:, None], depth[:, None],
        kp.angle[:, None],
        kp.octave.astype(jnp.float32)[:, None],
        kp.valid.astype(jnp.float32)[:, None],
        kp.response[:, None],
    ], axis=1)
    return f, kp.desc


@functools.lru_cache(maxsize=4)
def make_fused_track_fn(cfg: SlamConfig):
    return jax.jit(functools.partial(fused_track_step, cfg=cfg))


@functools.lru_cache(maxsize=4)
def make_fused_track_packed_fn(cfg: SlamConfig):
    return jax.jit(functools.partial(fused_track_step_packed, cfg=cfg))


@functools.lru_cache(maxsize=4)
def make_frame_pack_fn(cfg: SlamConfig):
    return jax.jit(frame_pack_step)


@functools.lru_cache(maxsize=4)
def make_motion_track_fn(cfg: SlamConfig):
    return jax.jit(functools.partial(motion_track_step, cfg=cfg))


@functools.lru_cache(maxsize=4)
def make_bow_track_fn(cfg: SlamConfig):
    return jax.jit(functools.partial(bow_track_step, cfg=cfg))


@functools.lru_cache(maxsize=4)
def make_local_track_fn(cfg: SlamConfig):
    return jax.jit(functools.partial(local_track_step, cfg=cfg), static_argnames=("th",))
