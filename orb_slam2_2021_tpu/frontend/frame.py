"""Frame assembly: stereo/RGB-D/monocular feature frames.

Replaces the reference's Frame layer (/root/reference/src/Frame.cc):
- stereo constructor (Frame.cc:80-152): both eyes extracted in one jitted
  program (the reference uses two host threads, Frame.cc:113-116 — here XLA
  schedules both extractions in one launch);
- ComputeStereoMatches (Frame.cc:522-700): row-banded Hamming matrix with
  best-match argmin + SAD subpixel parabola refinement + median outlier gate,
  all as masked dense ops;
- ComputeStereoFromRGBD (Frame.cc:702-723);
- the 64x48 feature grid (Frame.cc:279-294, 376-433) is deliberately absent:
  it exists to prune CPU candidate loops, while every search here is already a
  full masked [Q, N] matrix op on the device.

Pose (Tcw) is carried functionally: a Frame is an immutable pytree; tracking
produces new pose arrays rather than mutating.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig
from ..geometry.camera import PinholeCamera
from ..ops.hamming import hamming_matrix, MAX_DIST
from ..ops.image import build_pyramid, pyramid_shapes
from .features import Keypoints, extract_orb

TH_ORB_STEREO = 75  # (TH_HIGH + TH_LOW) / 2, Frame.cc:576


class Frame(NamedTuple):
    kp: Keypoints            # left-eye keypoints (capacity N)
    u_right: jnp.ndarray     # [N] float32; -1 = no stereo match
    depth: jnp.ndarray       # [N] float32; -1 = unknown
    sad_dist: jnp.ndarray    # [N] float32; stereo SAD residual (diagnostics)

    @property
    def n(self) -> int:
        return self.kp.capacity


def _stacked_pyramid(levels, h0: int, w0: int):
    """Zero-pad pyramid levels into one [L, H0, W0] tensor for uniform gathers."""
    stacked = []
    for img in levels:
        h, w = img.shape
        stacked.append(jnp.pad(img, ((0, h0 - h), (0, w0 - w))))
    return jnp.stack(stacked, axis=0)


def _gather_blocks(stacked, oct_, y0, x0, bh: int, bw: int, level_h, level_w):
    """Slice [N, bh, bw] blocks from per-keypoint pyramid levels.

    stacked: [L, H0, W0]; oct_/y0/x0: [N] level coords of the block corner.
    vmapped dynamic_slice reads contiguous rows; block
    corners are clamped inside each level's extent, which shifts (not
    clamps) out-of-range windows — keypoints live >= EDGE_THRESHOLD px
    inside so in practice nothing moves.
    """
    L, H0, W0 = stacked.shape
    y0c = jnp.clip(y0, 0, jnp.take(level_h, oct_) - bh)
    x0c = jnp.clip(x0, 0, jnp.take(level_w, oct_) - bw)
    img2d = stacked.reshape(L * H0, W0)

    def one(o, y, x):
        return jax.lax.dynamic_slice(img2d, (o * H0 + y, x), (bh, bw))

    return jax.vmap(one)(oct_, y0c, x0c)


def stereo_match(
    kpl: Keypoints,
    kpr: Keypoints,
    left_stack,
    right_stack,
    level_h,
    level_w,
    cfg: SlamConfig,
):
    """Per-left-keypoint subpixel right-eye coordinate + depth.

    Behavioral port of Frame::ComputeStereoMatches (Frame.cc:522-700) as
    masked dense ops. Returns (u_right, depth, sad_dist) each [N].
    """
    N = kpl.capacity
    scale = jnp.asarray(
        [cfg.orb.scale_factor ** i for i in range(cfg.orb.n_levels)], jnp.float32
    )
    inv_scale = 1.0 / scale

    uL, vL = kpl.xy[:, 0], kpl.xy[:, 1]
    uR, vR = kpr.xy[:, 0], kpr.xy[:, 1]

    min_z = cfg.bf / cfg.fx  # baseline (Frame.cc:552)
    min_d = 0.0
    max_d = cfg.bf / min_z   # = fx (Frame.cc:554)

    # candidate mask (row band uses the *right* kp's octave: Frame.cc:536)
    row_tol = cfg.stereo.row_slack_levels * jnp.take(scale, kpr.octave)  # [N]
    row_ok = jnp.abs(vL[:, None] - vR[None, :]) <= row_tol[None, :]
    oct_ok = (
        (kpr.octave[None, :] >= kpl.octave[:, None] - 1)
        & (kpr.octave[None, :] <= kpl.octave[:, None] + 1)
    )
    u_ok = (uR[None, :] >= uL[:, None] - max_d) & (uR[None, :] <= uL[:, None] - min_d)
    valid = kpl.valid[:, None] & kpr.valid[None, :]
    mask = row_ok & oct_ok & u_ok & valid

    dist = hamming_matrix(kpl.desc, kpr.desc)
    d = jnp.where(mask, dist, MAX_DIST)
    best_idx = jnp.argmin(d, axis=1)
    best_dist = jnp.min(d, axis=1)
    matched = best_dist < TH_ORB_STEREO

    # ---- SAD subpixel refinement at the left keypoint's octave ----
    w = cfg.stereo.sad_window        # 5 -> 11x11 block
    L = cfg.stereo.search_range      # +-5 sliding
    isc = jnp.take(inv_scale, kpl.octave)
    uL_l = jnp.round(uL * isc).astype(jnp.int32)
    vL_l = jnp.round(vL * isc).astype(jnp.int32)
    uR0_l = jnp.round(jnp.take(uR, best_idx) * isc).astype(jnp.int32)

    size = 2 * w + 1
    wide = 2 * (w + L) + 1

    # slice [N, 11, 11] left patch and [N, 11, 21] right strip; SAD and the
    # parabola refinement accumulate in fp32 (stacks may be bf16)
    patch_l = _gather_blocks(
        left_stack, kpl.octave, vL_l - w, uL_l - w, size, size, level_h, level_w
    ).astype(jnp.float32)
    strip_r = _gather_blocks(
        right_stack, kpl.octave, vL_l - w, uR0_l - w - L, size, wide, level_h, level_w
    ).astype(jnp.float32)

    patch_l = patch_l - patch_l[:, w : w + 1, w : w + 1]  # center-normalize (Frame.cc:611)

    def sad_at(inc):
        sub = jax.lax.dynamic_slice_in_dim(strip_r, L + inc - (-w) - w, size, axis=2) \
            if False else strip_r[:, :, L + inc : L + inc + size]
        sub = sub - sub[:, w : w + 1, w + 0 : w + 1]
        return jnp.sum(jnp.abs(patch_l - sub), axis=(1, 2))

    sads = jnp.stack([sad_at(inc) for inc in range(-L, L + 1)], axis=1)  # [N, 11]
    best_inc_idx = jnp.argmin(sads, axis=1)
    best_sad = jnp.min(sads, axis=1)
    at_border = (best_inc_idx == 0) | (best_inc_idx == 2 * L)

    # parabola refinement (Frame.cc:650-655)
    i1 = jnp.clip(best_inc_idx - 1, 0, 2 * L)
    i3 = jnp.clip(best_inc_idx + 1, 0, 2 * L)
    d1 = jnp.take_along_axis(sads, i1[:, None], axis=1)[:, 0]
    d2 = best_sad
    d3 = jnp.take_along_axis(sads, i3[:, None], axis=1)[:, 0]
    denom = 2.0 * (d1 + d3 - 2.0 * d2)
    delta = jnp.where(jnp.abs(denom) > 1e-6, (d1 - d3) / denom, 0.0)
    delta_ok = (delta >= -1.0) & (delta <= 1.0)

    sc = jnp.take(scale, kpl.octave)
    best_inc = (best_inc_idx - L).astype(jnp.float32)
    u_r_refined = sc * (uR0_l.astype(jnp.float32) + best_inc + delta)

    disparity = uL - u_r_refined
    # disparity in (-1, 0] snaps to 0.01 (Frame.cc:668-671)
    snap = (disparity <= 0.0) & (disparity > -1.0)
    disparity = jnp.where(snap, 0.01, disparity)
    u_r_refined = jnp.where(snap, uL - 0.01, u_r_refined)
    disp_ok = (disparity >= min_d) & (disparity < max_d)

    ok = matched & (~at_border) & delta_ok & disp_ok & kpl.valid

    # median outlier gate: dist < median_gate * median (Frame.cc:686-699)
    sad_masked = jnp.where(ok, best_sad, jnp.inf)
    n_ok = jnp.sum(ok)
    sorted_sad = jnp.sort(sad_masked)
    med_idx = jnp.clip(n_ok // 2, 0, N - 1)
    median = sorted_sad[med_idx]
    ok = ok & (best_sad < cfg.stereo.median_gate * median)

    depth = jnp.where(ok, cfg.bf / jnp.maximum(disparity, 1e-6), -1.0)
    u_right = jnp.where(ok, u_r_refined, -1.0)
    return u_right, depth, jnp.where(ok, best_sad, -1.0)


def build_stereo_frame(image_left, image_right, cfg: SlamConfig):
    """Full stereo frame assembly — one jitted program for both eyes.

    Both eyes' pyramids/FAST/selection/descriptors run as one batch-2
    extraction (the reference spawns two host threads, Frame.cc:113-116);
    the raw pyramid stacks are reused for the SAD subpixel refinement.
    """
    from .features import extract_orb_batched

    kp2, raw_stack = extract_orb_batched(
        jnp.stack([image_left, image_right], axis=0), cfg.orb
    )
    kpl = jax.tree.map(lambda x: x[0], kp2)
    kpr = jax.tree.map(lambda x: x[1], kp2)

    h0, w0 = image_left.shape
    shapes = pyramid_shapes(h0, w0, cfg.orb.n_levels, cfg.orb.scale_factor)
    level_h = jnp.asarray([s[0] for s in shapes], jnp.int32)
    level_w = jnp.asarray([s[1] for s in shapes], jnp.int32)

    u_right, depth, sad = stereo_match(
        kpl, kpr, raw_stack[0], raw_stack[1], level_h, level_w, cfg
    )
    return Frame(kp=kpl, u_right=u_right, depth=depth, sad_dist=sad)


def _undistort_kp(kp, cfg: SlamConfig):
    """Frame::UndistortKeyPoints (Frame.cc:456-486): keypoint coordinates are
    mapped to the ideal pinhole camera when the config carries distortion;
    zero coefficients compile to a no-op (static branch, like the reference's
    mDistCoef.at<float>(0)==0 early-out)."""
    if not any(cfg.dist_coef):
        return kp
    from ..ops.undistort import undistort_points

    xy_un = undistort_points(kp.xy, cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.dist_coef)
    return kp._replace(xy=xy_un)


def build_rgbd_frame(image, depth_map, cfg: SlamConfig, depth_scale: float = 1.0):
    """RGB-D pseudo-stereo (Frame::ComputeStereoFromRGBD, Frame.cc:702-723).

    Depth is read at the RAW detected coordinates (the depth image is aligned
    to the distorted RGB image); the virtual right-eye disparity uses the
    UNDISTORTED x, exactly the reference's mvKeys/mvKeysUn split
    (Frame.cc:708-718)."""
    kp = extract_orb(image, cfg.orb)
    h, w = depth_map.shape
    xs = jnp.clip(jnp.round(kp.xy[:, 0]).astype(jnp.int32), 0, w - 1)
    ys = jnp.clip(jnp.round(kp.xy[:, 1]).astype(jnp.int32), 0, h - 1)
    d = jnp.take(depth_map.reshape(-1), ys * w + xs) * depth_scale
    kp = _undistort_kp(kp, cfg)
    ok = (d > 0) & kp.valid
    u_right = jnp.where(ok, kp.xy[:, 0] - cfg.bf / jnp.maximum(d, 1e-6), -1.0)
    depth = jnp.where(ok, d, -1.0)
    return Frame(kp=kp, u_right=u_right, depth=depth, sad_dist=jnp.full_like(depth, -1.0))


def build_mono_frame(image, cfg: SlamConfig):
    kp = _undistort_kp(extract_orb(image, cfg.orb), cfg)
    neg = jnp.full((kp.capacity,), -1.0, jnp.float32)
    return Frame(kp=kp, u_right=neg, depth=neg, sad_dist=neg)


@functools.lru_cache(maxsize=4)
def make_stereo_frame_fn(cfg: SlamConfig):
    return jax.jit(functools.partial(build_stereo_frame, cfg=cfg))


def build_stereo_frame_from_u8(images_u8, cfg: SlamConfig):
    """Stereo frame assembly from ONE stacked [2, H, W] uint8 upload.

    Shipping the pair as uint8 cuts the per-frame image payload 8x vs two
    float32 uploads (real cameras
    produce 8-bit grayscale anyway — the reference converts to CV_8U mono,
    Tracking.cc:183-208). Cast to f32 on device (free: fused into the
    pyramid build)."""
    return build_stereo_frame(
        images_u8[0].astype(jnp.float32),
        images_u8[1].astype(jnp.float32),
        cfg=cfg,
    )


@functools.lru_cache(maxsize=4)
def make_stereo_frame_u8_fn(cfg: SlamConfig):
    return jax.jit(functools.partial(build_stereo_frame_from_u8, cfg=cfg))
