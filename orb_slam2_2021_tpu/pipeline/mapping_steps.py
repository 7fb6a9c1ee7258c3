"""Jitted device steps for LocalMapping: triangulation and fusion.

- triangulate_pair: SearchForTriangulation's epipolar-constrained descriptor
  matching (/root/reference/src/ORBmatcher.cc:671-839) fused with the SVD/DLT
  triangulation + cheirality/reprojection/scale gates of
  LocalMapping::CreateNewMapPoints (/root/reference/src/LocalMapping.cc:
  211-458), as one masked dense program over feature pairs.
- fuse_project: ORBmatcher::Fuse (/root/reference/src/ORBmatcher.cc:841-991):
  project map points into a keyframe, find the best feature in a radius, and
  report merge/add decisions for the host to apply.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..geometry.camera import PinholeCamera
from ..ops.hamming import MAX_DIST, hamming_matrix
from ..xmath import HIGHEST, mm

TH_LOW = 50
TH_HIGH = 100


class KFView(NamedTuple):
    """Device view of one keyframe's features + pose."""
    xy: jnp.ndarray        # [N, 2]
    ur: jnp.ndarray        # [N]
    depth: jnp.ndarray     # [N]
    octave: jnp.ndarray    # [N]
    desc: jnp.ndarray      # [N, 8]
    valid: jnp.ndarray     # [N] (feature valid AND unbound, for triangulation)
    R: jnp.ndarray         # [3, 3] Tcw
    t: jnp.ndarray         # [3]


def _scale_arrays(cfg: SlamConfig):
    s = jnp.asarray([cfg.orb.scale_factor ** i for i in range(cfg.orb.n_levels)], jnp.float32)
    return s, s * s


def triangulate_pair(cam: PinholeCamera, kf1: KFView, kf2: KFView, cfg: SlamConfig):
    """Match unbound features of kf1 x kf2 on the epipolar constraint and
    triangulate. Returns (match2 [N] int32: kf2 feature per kf1 feature or -1,
    xw [N, 3] world points, ok [N] bool)."""
    scale, sigma2 = _scale_arrays(cfg)
    inv_sigma2 = 1.0 / sigma2

    # relative geometry, camera centers
    R1, t1, R2, t2 = kf1.R, kf1.t, kf2.R, kf2.t
    C1 = -jnp.einsum("ji,j->i", R1, t1, precision=HIGHEST)  # world center of kf1
    C2 = -jnp.einsum("ji,j->i", R2, t2, precision=HIGHEST)
    baseline = jnp.linalg.norm(C2 - C1)

    # Fundamental matrix F12 (LocalMapping::ComputeF12, LocalMapping.cc:545-561)
    R12 = jnp.einsum("ij,kj->ik", R1, R2, precision=HIGHEST)  # R1 * R2^T
    t12 = t1 - jnp.einsum("ij,j->i", R12, t2, precision=HIGHEST)
    tx = jnp.array(
        [
            [0.0, -t12[2], t12[1]],
            [t12[2], 0.0, -t12[0]],
            [-t12[1], t12[0], 0.0],
        ]
    )
    Km = jnp.array(
        [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]]
    )
    Kinv = jnp.linalg.inv(Km)
    F12 = mm(mm(mm(Kinv.T, tx), R12), Kinv)

    # epipolar distance of kf2 candidates from kf1 lines
    ones1 = jnp.ones((kf1.xy.shape[0], 1))
    ones2 = jnp.ones((kf2.xy.shape[0], 1))
    p1 = jnp.concatenate([kf1.xy, ones1], axis=1)  # [N,3]
    p2 = jnp.concatenate([kf2.xy, ones2], axis=1)
    # epipolar line in kf2 for kp1: l = p1^T F12 (CheckDistEpipolarLine,
    # ORBmatcher.cc epipolar helper indexes F12 by column)
    lines = mm(p1, F12)
    num = jnp.einsum("ni,mi->nm", lines, p2, precision=HIGHEST)
    den = lines[:, 0][:, None] ** 2 + lines[:, 1][:, None] ** 2
    dsqr = num * num / jnp.maximum(den, 1e-12)
    epi_ok = dsqr < 3.84 * jnp.take(sigma2, kf2.octave)[None, :]

    # mono features must not be too close to the epipole in kf2
    # (ORBmatcher.cc:770-778): ex,ey = project(C1 into kf2)
    C1_in2 = jnp.einsum("ij,j->i", R2, C1, precision=HIGHEST) + t2
    ex = cam.fx * C1_in2[0] / jnp.maximum(C1_in2[2], 1e-9) + cam.cx
    ey = cam.fy * C1_in2[1] / jnp.maximum(C1_in2[2], 1e-9) + cam.cy
    de = (kf2.xy[:, 0] - ex) ** 2 + (kf2.xy[:, 1] - ey) ** 2
    epipole_ok = (kf2.ur >= 0) | (de >= 100.0 * jnp.take(scale, kf2.octave) ** 2)

    mask = (
        kf1.valid[:, None] & kf2.valid[None, :]
        & epi_ok & epipole_ok[None, :]
    )
    dist = hamming_matrix(kf1.desc, kf2.desc)
    d = jnp.where(mask, dist, MAX_DIST)
    best2 = jnp.argmin(d, axis=1).astype(jnp.int32)
    bestd = jnp.min(d, axis=1)
    matched = bestd <= TH_LOW

    # triangulate matched pairs by DLT (LocalMapping.cc:326-343)
    xy2 = jnp.take(kf2.xy, best2, axis=0)
    oct2 = jnp.take(kf2.octave, best2)
    ur2 = jnp.take(kf2.ur, best2)
    depth2 = jnp.take(kf2.depth, best2)

    xn1 = jnp.stack(
        [(kf1.xy[:, 0] - cam.cx) / cam.fx, (kf1.xy[:, 1] - cam.cy) / cam.fy], axis=1
    )
    xn2 = jnp.stack(
        [(xy2[:, 0] - cam.cx) / cam.fx, (xy2[:, 1] - cam.cy) / cam.fy], axis=1
    )

    # parallax between rays (LocalMapping.cc:300-324)
    ray1 = jnp.einsum("ji,nj->ni", R1, jnp.concatenate([xn1, ones1], axis=1), precision=HIGHEST)
    ray2 = jnp.einsum("ji,nj->ni", R2, jnp.concatenate([xn2, ones2], axis=1), precision=HIGHEST)
    cos_rays = jnp.sum(ray1 * ray2, axis=1) / (
        jnp.linalg.norm(ray1, axis=1) * jnp.linalg.norm(ray2, axis=1) + 1e-12
    )
    # stereo parallax alternatives
    d1 = kf1.depth
    cos_stereo1 = jnp.where(
        d1 > 0, jnp.cos(2.0 * jnp.arctan2(cam.bf / cam.fx / 2.0, d1)), 1.1
    )
    cos_stereo2 = jnp.where(
        depth2 > 0, jnp.cos(2.0 * jnp.arctan2(cam.bf / cam.fx / 2.0, depth2)), 1.1
    )
    cos_stereo = jnp.minimum(cos_stereo1, cos_stereo2)

    # DLT rows: A = [xn1.x*P1_3 - P1_1; xn1.y*P1_3 - P1_2; same for 2]
    P1 = jnp.concatenate([R1, t1[:, None]], axis=1)  # [3,4]
    P2 = jnp.concatenate([R2, t2[:, None]], axis=1)
    A = jnp.stack(
        [
            xn1[:, 0:1] * P1[2] - P1[0][None],
            xn1[:, 1:2] * P1[2] - P1[1][None],
            xn2[:, 0:1] * P2[2] - P2[0][None],
            xn2[:, 1:2] * P2[2] - P2[1][None],
        ],
        axis=1,
    )  # [N,4,4]
    # Linear triangulation with the w=1 gauge: min ||B x + c||^2 over the
    # inhomogeneous coordinates, solved in closed form via the 3x3 normal
    # equations (adjugate inverse — pure elementwise work). The reference
    # takes the full SVD null vector (LocalMapping.cc:326-343); the only
    # configurations where the two differ materially are points near
    # infinity (w ~ 0), which the cheirality/reprojection gates below cull
    # either way. A batched eigh/SVD per KF dispatch would cost far more
    # than this closed form.
    B = A[:, :, :3]                      # [N,4,3]
    cvec = A[:, :, 3]                    # [N,4]
    M = jnp.einsum("nij,nik->njk", B, B, precision=HIGHEST)   # [N,3,3] sym
    rhs = -jnp.einsum("nij,ni->nj", B, cvec, precision=HIGHEST)
    c00 = M[:, 1, 1] * M[:, 2, 2] - M[:, 1, 2] * M[:, 2, 1]
    c01 = M[:, 0, 2] * M[:, 2, 1] - M[:, 0, 1] * M[:, 2, 2]
    c02 = M[:, 0, 1] * M[:, 1, 2] - M[:, 0, 2] * M[:, 1, 1]
    c11 = M[:, 0, 0] * M[:, 2, 2] - M[:, 0, 2] * M[:, 2, 0]
    c12 = M[:, 0, 2] * M[:, 1, 0] - M[:, 0, 0] * M[:, 1, 2]
    c22 = M[:, 0, 0] * M[:, 1, 1] - M[:, 0, 1] * M[:, 1, 0]
    det = M[:, 0, 0] * c00 + M[:, 0, 1] * c01 + M[:, 0, 2] * c02
    w_ok = jnp.abs(det) > 1e-12
    inv_det = 1.0 / jnp.where(w_ok, det, 1.0)
    # M symmetric -> cofactor matrix symmetric -> inverse = C / det
    x_dlt = jnp.stack(
        [
            c00 * rhs[:, 0] + c01 * rhs[:, 1] + c02 * rhs[:, 2],
            c01 * rhs[:, 0] + c11 * rhs[:, 1] + c12 * rhs[:, 2],
            c02 * rhs[:, 0] + c12 * rhs[:, 1] + c22 * rhs[:, 2],
        ],
        axis=1,
    ) * inv_det[:, None]

    use_dlt = (cos_rays < cos_stereo) & (cos_rays > 0) & (cos_rays < 0.9998) & w_ok
    # low-parallax fallback: unproject stereo depth (LocalMapping.cc:345-353)
    z1 = d1
    xw_s1 = jnp.einsum(
        "ji,nj->ni", R1,
        jnp.concatenate([xn1 * z1[:, None], z1[:, None]], axis=1) - t1[None],
        precision=HIGHEST,
    )
    z2 = depth2
    xw_s2 = jnp.einsum(
        "ji,nj->ni", R2,
        jnp.concatenate([xn2 * z2[:, None], z2[:, None]], axis=1) - t2[None],
        precision=HIGHEST,
    )
    use_s1 = (~use_dlt) & (d1 > 0) & (cos_stereo1 < cos_stereo2)
    use_s2 = (~use_dlt) & (~use_s1) & (depth2 > 0)
    xw = jnp.where(use_dlt[:, None], x_dlt, jnp.where(use_s1[:, None], xw_s1, xw_s2))
    has_point = use_dlt | use_s1 | use_s2

    # gates: cheirality + reprojection in both views + scale consistency
    def reproj_ok(R, t, xy, ur, octv, xw):
        Xc = jnp.einsum("ij,nj->ni", R, xw, precision=HIGHEST) + t
        z = Xc[:, 2]
        iz = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        u = cam.fx * Xc[:, 0] * iz + cam.cx
        v = cam.fy * Xc[:, 1] * iz + cam.cy
        urp = u - cam.bf * iz
        isv2 = jnp.take(inv_sigma2, octv)
        e_mono = ((u - xy[:, 0]) ** 2 + (v - xy[:, 1]) ** 2) * isv2
        e_st = e_mono + (urp - ur) ** 2 * isv2
        err_ok = jnp.where(ur >= 0, e_st <= 7.8, e_mono <= 5.991)
        return (z > 0) & err_ok, z

    ok1, z1p = reproj_ok(R1, t1, kf1.xy, kf1.ur, kf1.octave, xw)
    ok2, z2p = reproj_ok(R2, t2, xy2, ur2, oct2, xw)

    # scale consistency (LocalMapping.cc:437-453)
    dist1 = jnp.linalg.norm(xw - C1[None], axis=1)
    dist2 = jnp.linalg.norm(xw - C2[None], axis=1)
    ratio_dist = dist2 / jnp.maximum(dist1, 1e-9)
    ratio_octave = jnp.take(scale, kf1.octave) / jnp.take(scale, oct2)
    rf = 1.5 * cfg.orb.scale_factor
    scale_ok = (ratio_dist * rf > ratio_octave) & (ratio_dist < ratio_octave * rf)

    ok = matched & has_point & ok1 & ok2 & scale_ok & (dist1 > 0) & (dist2 > 0)

    # dedupe kf2 features (two kf1 features claiming one kf2 feature)
    n2 = kf2.xy.shape[0]
    d_sel = jnp.where(ok, bestd, MAX_DIST)
    feat_min = jnp.full((n2,), MAX_DIST, jnp.int32).at[best2].min(d_sel)
    ok = ok & (d_sel == feat_min[best2])
    qidx = jnp.arange(best2.shape[0], dtype=jnp.int32)
    q = jnp.where(ok, qidx, jnp.int32(2**30))
    qmin = jnp.full((n2,), 2**30, jnp.int32).at[best2].min(q)
    ok = ok & (q == qmin[best2])

    return best2, xw, ok, baseline


def fuse_project(
    cam: PinholeCamera,
    kf: KFView,
    mp_pos, mp_normal, mp_min_dist, mp_max_dist, mp_desc, mp_valid,
    cfg: SlamConfig,
    radius_th: float = 3.0,
):
    """Fuse search (ORBmatcher.cc:841-991): returns per-point best feature in
    kf (+accept mask). Host decides merge vs add-observation."""
    scale, sigma2 = _scale_arrays(cfg)
    inv_sigma2 = 1.0 / sigma2
    log_scale = jnp.log(jnp.float32(cfg.orb.scale_factor))
    n_levels = cfg.orb.n_levels

    R, t = kf.R, kf.t
    Xc = jnp.einsum("ij,nj->ni", R, mp_pos, precision=HIGHEST) + t
    z = Xc[:, 2]
    iz = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * Xc[:, 0] * iz + cam.cx
    v = cam.fy * Xc[:, 1] * iz + cam.cy
    ur = u - cam.bf * iz

    Ow = -jnp.einsum("ji,j->i", R, t, precision=HIGHEST)
    po = mp_pos - Ow[None]
    dist3d = jnp.linalg.norm(po, axis=1) + 1e-9
    in_front = z > 0
    in_img = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    band = (dist3d >= 0.8 * mp_min_dist) & (dist3d <= 1.2 * mp_max_dist)
    view_cos = jnp.sum(po * mp_normal, axis=1) / dist3d
    cos_ok = view_cos > 0.5
    visible = mp_valid & in_front & in_img & band & cos_ok

    pred = jnp.ceil(jnp.log(jnp.maximum(mp_max_dist, 1e-9) / dist3d) / log_scale)
    pred = jnp.clip(pred, 0, n_levels - 1).astype(jnp.int32)
    r = radius_th * jnp.take(scale, pred)

    du = jnp.abs(kf.xy[None, :, 0] - u[:, None])
    dv = jnp.abs(kf.xy[None, :, 1] - v[:, None])
    window = (du <= r[:, None]) & (dv <= r[:, None])
    oct_ok = (
        (kf.octave[None, :] >= pred[:, None] - 1)
        & (kf.octave[None, :] <= pred[:, None] + 1)
    )
    # chi2 gate on the candidate (ORBmatcher.cc:913-934)
    e2_mono = (kf.xy[None, :, 0] - u[:, None]) ** 2 + (kf.xy[None, :, 1] - v[:, None]) ** 2
    e2_st = e2_mono + (kf.ur[None, :] - ur[:, None]) ** 2
    isv = jnp.take(inv_sigma2, kf.octave)[None, :]
    chi_ok = jnp.where(kf.ur[None, :] >= 0, e2_st * isv <= 7.8, e2_mono * isv <= 5.99)

    mask = window & oct_ok & chi_ok & visible[:, None] & kf.valid[None, :]
    dist = hamming_matrix(mp_desc, kf.desc)
    d = jnp.where(mask, dist, MAX_DIST)
    best_feat = jnp.argmin(d, axis=1).astype(jnp.int32)
    best_dist = jnp.min(d, axis=1)
    accept = best_dist <= TH_LOW
    return best_feat, accept, best_dist


@functools.lru_cache(maxsize=4)
def make_triangulate_fn(cfg: SlamConfig):
    return jax.jit(functools.partial(triangulate_pair, cfg=cfg))


@functools.lru_cache(maxsize=4)
def make_triangulate_batch_fn(cfg: SlamConfig):
    """vmapped triangulation of ONE keyframe against T stacked neighbor views
    in a single dispatch (CreateNewMapPoints iterates neighbors one by one,
    LocalMapping.cc:227-244; here all T pairs ride one launch instead of T
    device round trips)."""
    f = functools.partial(triangulate_pair, cfg=cfg)
    return jax.jit(jax.vmap(f, in_axes=(None, None, 0)))


def pack_fuse_points(pos, normal, min_dist, max_dist, desc, valid) -> "np.ndarray":
    """Pack the fuse candidate-point arrays into ONE [P, 17] f32 upload
    (pos 3 | normal 3 | min 1 | max 1 | desc-bitcast 8 | valid 1): one
    transfer instead of six."""
    import numpy as _np

    P = pos.shape[0]
    out = _np.empty((P, 17), _np.float32)
    out[:, 0:3] = pos
    out[:, 3:6] = normal
    out[:, 6] = min_dist
    out[:, 7] = max_dist
    out[:, 8:16] = desc.view(_np.float32) if desc.dtype == _np.uint32 \
        else _np.asarray(desc, _np.uint32).view(_np.float32)
    out[:, 16] = valid
    return out


def fuse_project_packed(cam: PinholeCamera, kf: KFView, packed,
                        cfg: SlamConfig, radius_th: float = 3.0):
    """fuse_project taking the single packed candidate buffer."""
    desc = jax.lax.bitcast_convert_type(packed[:, 8:16], jnp.uint32)
    return fuse_project(
        cam, kf, packed[:, 0:3], packed[:, 3:6], packed[:, 6], packed[:, 7],
        desc, packed[:, 16] > 0, cfg=cfg, radius_th=radius_th,
    )


@functools.lru_cache(maxsize=4)
def make_fuse_fn(cfg: SlamConfig):
    return jax.jit(functools.partial(fuse_project, cfg=cfg))


@functools.lru_cache(maxsize=4)
def make_fuse_packed_fn(cfg: SlamConfig):
    return jax.jit(functools.partial(fuse_project_packed, cfg=cfg))


@functools.lru_cache(maxsize=4)
def make_fuse_batch_packed_fn(cfg: SlamConfig):
    f = functools.partial(fuse_project_packed, cfg=cfg)
    return jax.jit(jax.vmap(f, in_axes=(None, 0, None)))


@functools.lru_cache(maxsize=4)
def make_fuse_batch_fn(cfg: SlamConfig):
    """vmapped fuse of one candidate point set into T stacked target views in
    a single dispatch (SearchInNeighbors' forward loop,
    LocalMapping.cc:495-505)."""
    f = functools.partial(fuse_project, cfg=cfg)
    return jax.jit(
        jax.vmap(f, in_axes=(None, 0, None, None, None, None, None, None))
    )
