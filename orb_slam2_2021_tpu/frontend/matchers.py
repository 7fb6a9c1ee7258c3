"""Projection-based matching policies for tracking.

Data-parallel reformulation of ORBmatcher's candidate-loop searches
(/root/reference/src/ORBmatcher.cc) as masked [P, N] matrix reductions:

- match_last_frame: SearchByProjection(F, LastFrame, th)
  (ORBmatcher.cc:1348-1491) — project last frame's landmarks with the
  predicted pose, gate by window/octave/stereo-ur, Hamming argmin +
  rotation-consistency histogram;
- match_local_points: Frame::isInFrustum (Frame.cc:318-374) +
  SearchByProjection(F, vpMapPoints, th) (ORBmatcher.cc:45-133) — frustum
  and scale-band culling, viewing-cos radius, best/second ratio when both
  fall on the same octave;
- match_bruteforce_desc: descriptor-only matching with ratio test +
  rotation histogram (stands in for SearchByBoW until the vocabulary lands;
  same acceptance thresholds, ORBmatcher.cc:165-293).

All return per-query best indices with boolean accept masks, deduplicated so
each frame feature is claimed by at most one landmark.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..geometry.camera import PinholeCamera
from ..ops.hamming import MAX_DIST, hamming_matrix, rotation_histogram_filter
from ..xmath import HIGHEST
from .features import Keypoints

TH_HIGH = 100
TH_LOW = 50


def _dedupe_by_feature(best_feat, accept, dist, n_feats):
    """Resolve conflicts: if several queries claim one frame feature, keep the
    lowest-distance query. Returns (per-query accept mask)."""
    # scatter-min over features
    big = jnp.full((n_feats,), MAX_DIST, jnp.int32)
    d = jnp.where(accept, dist, MAX_DIST)
    feat_min = big.at[best_feat].min(d)
    winner = accept & (d == feat_min[best_feat])
    # break remaining ties (two queries with equal dist on same feature):
    # keep the lowest query index
    qidx = jnp.arange(best_feat.shape[0], dtype=jnp.int32)
    q = jnp.where(winner, qidx, jnp.int32(2**30))
    feat_qmin = jnp.full((n_feats,), 2**30, jnp.int32).at[best_feat].min(q)
    winner = winner & (q == feat_qmin[best_feat])
    return winner


def project_points(cam: PinholeCamera, R, t, xw):
    """World points -> (u, v, u_r, z) with camera pose Tcw."""
    Xc = jnp.einsum("ij,nj->ni", R, xw, precision=HIGHEST) + t
    z = Xc[:, 2]
    iz = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * Xc[:, 0] * iz + cam.cx
    v = cam.fy * Xc[:, 1] * iz + cam.cy
    ur = u - cam.bf * iz
    return u, v, ur, z, Xc


def match_last_frame(
    cam: PinholeCamera,
    kp: Keypoints,
    feat_ur: jnp.ndarray,
    R, t,
    last_xw, last_desc, last_octave, last_angle, last_valid,
    cfg: SlamConfig,
    radius: float,
):
    """[P]-sized last-frame landmark set vs current frame features.

    Returns (best_feat [P], accept [P], dist [P]).
    """
    scale = jnp.asarray(
        [cfg.orb.scale_factor ** i for i in range(cfg.orb.n_levels)], jnp.float32
    )
    u, v, ur, z, _ = project_points(cam, R, t, last_xw)
    in_front = z > 0
    in_img = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)

    r = radius * jnp.take(scale, last_octave)  # [P]
    du = jnp.abs(kp.xy[None, :, 0] - u[:, None])
    dv = jnp.abs(kp.xy[None, :, 1] - v[:, None])
    window = (du <= r[:, None]) & (dv <= r[:, None])
    oct_ok = (
        (kp.octave[None, :] >= last_octave[:, None] - 1)
        & (kp.octave[None, :] <= last_octave[:, None] + 1)
    )
    # stereo gate (ORBmatcher.cc:1411-1414): matched feature's u_r close to
    # the projected one, when the feature has a right match
    ur_ok = (feat_ur[None, :] < 0) | (jnp.abs(feat_ur[None, :] - ur[:, None]) <= r[:, None])

    mask = (
        window & oct_ok & ur_ok
        & last_valid[:, None] & kp.valid[None, :]
        & (in_front & in_img)[:, None]
    )
    dist = hamming_matrix(last_desc, kp.desc)
    d = jnp.where(mask, dist, MAX_DIST)
    best_feat = jnp.argmin(d, axis=1).astype(jnp.int32)
    best_dist = jnp.min(d, axis=1)
    accept = best_dist <= TH_HIGH

    if cfg.matcher.check_orientation:
        matched_angle = jnp.take(kp.angle, best_feat)
        accept = rotation_histogram_filter(
            last_angle, matched_angle, accept,
            cfg.matcher.histo_bins, cfg.matcher.histo_keep,
        )
    accept = _dedupe_by_feature(best_feat, accept, best_dist, kp.capacity)
    return best_feat, accept, best_dist


def match_local_points(
    cam: PinholeCamera,
    kp: Keypoints,
    feat_ur: jnp.ndarray,
    feat_bound: jnp.ndarray,       # [N] bool: feature already has a landmark
    R, t,
    mp_pos, mp_normal, mp_min_dist, mp_max_dist, mp_desc, mp_valid,
    cfg: SlamConfig,
    th: float = 1.0,
):
    """Local-map point search. Returns (best_feat [P], accept [P], dist [P],
    visible [P]) where visible = passed the frustum test (for found/visible
    statistics, Tracking.cc:1180-1190)."""
    scale = jnp.asarray(
        [cfg.orb.scale_factor ** i for i in range(cfg.orb.n_levels)], jnp.float32
    )
    log_scale = jnp.log(jnp.float32(cfg.orb.scale_factor))
    n_levels = cfg.orb.n_levels

    u, v, ur, z, Xc = project_points(cam, R, t, mp_pos)
    # camera center in world frame
    Ow = -jnp.einsum("ji,j->i", R, t, precision=HIGHEST)
    po = mp_pos - Ow[None]
    dist3d = jnp.linalg.norm(po, axis=1) + 1e-9
    # frustum gates (Frame.cc:318-374)
    in_front = z > 0
    in_img = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    band = (dist3d >= 0.8 * mp_min_dist) & (dist3d <= 1.2 * mp_max_dist)
    view_cos = jnp.sum(po * mp_normal, axis=1) / dist3d
    cos_ok = view_cos > 0.5
    visible = mp_valid & in_front & in_img & band & cos_ok

    # predicted octave (MapPoint::PredictScale, MapPoint.cc:415-447)
    pred = jnp.ceil(jnp.log(jnp.maximum(mp_max_dist, 1e-9) / dist3d) / log_scale)
    pred = jnp.clip(pred, 0, n_levels - 1).astype(jnp.int32)

    r_base = jnp.where(view_cos > 0.998, 2.5, 4.0)  # ORBmatcher.cc:135-146
    r = th * r_base * jnp.take(scale, pred)

    du = jnp.abs(kp.xy[None, :, 0] - u[:, None])
    dv = jnp.abs(kp.xy[None, :, 1] - v[:, None])
    window = (du <= r[:, None]) & (dv <= r[:, None])
    oct_ok = (
        (kp.octave[None, :] >= pred[:, None] - 1)
        & (kp.octave[None, :] <= pred[:, None])
    )
    mask = window & oct_ok & visible[:, None] & kp.valid[None, :] & (~feat_bound)[None, :]

    dist = hamming_matrix(mp_desc, kp.desc)
    d = jnp.where(mask, dist, MAX_DIST)
    order2 = jnp.argsort(d, axis=1)[:, :2]
    best_feat = order2[:, 0].astype(jnp.int32)
    best_dist = jnp.take_along_axis(d, order2[:, :1], axis=1)[:, 0]
    second_dist = jnp.take_along_axis(d, order2[:, 1:2], axis=1)[:, 0]
    best_lvl = jnp.take(kp.octave, best_feat)
    second_lvl = jnp.take(kp.octave, order2[:, 1].astype(jnp.int32))

    accept = best_dist <= TH_HIGH
    # ratio gate applies only when best/second land on the same octave
    same_lvl = best_lvl == second_lvl
    ratio_bad = same_lvl & (
        best_dist.astype(jnp.float32) > cfg.matcher.nn_ratio_bow * second_dist.astype(jnp.float32)
    ) & (second_dist < MAX_DIST)
    accept = accept & (~ratio_bad)
    accept = _dedupe_by_feature(best_feat, accept, best_dist, kp.capacity)
    return best_feat, accept, best_dist, visible


def match_bruteforce_desc(
    desc_a, valid_a, angle_a,
    desc_b, valid_b, angle_b,
    nn_ratio: float = 0.75,
    check_orientation: bool = True,
    histo_bins: int = 30,
    histo_keep: int = 3,
    th: int = TH_LOW,
):
    """Descriptor-only matching a->b with ratio + rotation gates.

    Acceptance mirrors SearchByBoW (ORBmatcher.cc:165-293): best < TH_LOW,
    best < ratio * second. Returns (best_b [A], accept [A], dist [A]).
    """
    dist = hamming_matrix(desc_a, desc_b)
    mask = valid_a[:, None] & valid_b[None, :]
    d = jnp.where(mask, dist, MAX_DIST)
    order2 = jnp.argsort(d, axis=1)[:, :2]
    best_b = order2[:, 0].astype(jnp.int32)
    best = jnp.take_along_axis(d, order2[:, :1], axis=1)[:, 0]
    second = jnp.take_along_axis(d, order2[:, 1:2], axis=1)[:, 0]
    accept = (best <= th) & (
        best.astype(jnp.float32) < nn_ratio * second.astype(jnp.float32)
    )
    if check_orientation:
        matched_angle = jnp.take(angle_b, best_b)
        accept = rotation_histogram_filter(angle_a, matched_angle, accept, histo_bins, histo_keep)
    accept = _dedupe_by_feature(best_b, accept, best, desc_b.shape[0])
    return best_b, accept, best
