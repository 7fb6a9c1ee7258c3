"""ORB pyramid feature extraction — the jitted per-image front-end.

Equivalent of ORBextractor::operator()
(/root/reference/src/ORBextractor.cc:1041-1103): pyramid -> FAST per level ->
spatially-bucketed selection (quadtree intent) -> IC orientation -> blurred
rBRIEF descriptors -> keypoint coordinates scaled to level 0.

Device shape: instead of the reference's per-level loops (and its two extraction
host threads for the stereo pair, Frame.cc:113-116), ALL eyes x ALL pyramid
levels are stacked onto one padded canvas tensor [B, L, H, W] and every stage
runs once, batched:
 - FAST evaluates both thresholds from one shared 16-sample ring;
 - per-cell top-k selection is one batched top_k;
 - a single patch gather [B, N, 31, 31] feeds BOTH the IC-orientation moment
   matmul and the rBRIEF two-hot matmul (bf16 matrix products — see
   ops/brief.py).
Orientation is computed on the blurred patch (the reference uses the raw
level, ORBextractor.cc:1080); blur is rotationally symmetric so the IC angle
is preserved while the single gather halves random-access traffic.

Per-level feature budgets follow the reference's geometric split
(ORBextractor.cc ctor: nDesiredFeatures * (1-1/s) / (1-1/s^L) per level).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import OrbConfig
from ..ops.brief import brief_from_patches
from ..ops.fast import fast_detect_batched
from ..ops.image import gaussian_blur_batched, pyramid_shapes
from ..ops.orientation import HALF_PATCH, PATCH, angles_from_patches
from ..ops.select import select_keypoints_batched


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set (capacity = OrbConfig.n_features)."""
    xy: jnp.ndarray        # [N, 2] float32, level-0 pixel coords (x, y)
    response: jnp.ndarray  # [N] float32
    octave: jnp.ndarray    # [N] int32
    angle: jnp.ndarray     # [N] float32 radians
    desc: jnp.ndarray      # [N, 8] uint32 packed 256-bit
    valid: jnp.ndarray     # [N] bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]


def level_feature_counts(n_features: int, n_levels: int, scale_factor: float):
    """Reference's per-level budget split (ORBextractor.cc:60-72)."""
    inv = 1.0 / scale_factor
    total = (1.0 - inv ** n_levels) / (1.0 - inv)
    counts = []
    for lvl in range(n_levels):
        counts.append(int(round(n_features * (inv ** lvl) / total)))
    # fix rounding drift so the sum is exactly n_features
    diff = n_features - sum(counts)
    counts[0] += diff
    return counts


def _canvas_dims(h0: int, w0: int, cell: int):
    return ((h0 + cell - 1) // cell) * cell, ((w0 + cell - 1) // cell) * cell


def build_pyramid_stack(images, cfg: OrbConfig):
    """[B, H, W] -> ([B, L, Hc, Wc] zero-padded canvas stack, extents).

    Level images sit in the top-left corner of a shared canvas whose dims
    are multiples of the selection cell size.
    """
    B, h0, w0 = images.shape
    shapes = pyramid_shapes(h0, w0, cfg.n_levels, cfg.scale_factor)
    Hc, Wc = _canvas_dims(h0, w0, cfg.cell_size)
    slabs = []
    prev = images
    for lvl in range(cfg.n_levels):
        th, tw = shapes[lvl]
        if lvl > 0:
            prev = jax.image.resize(prev, (B, th, tw), method="bilinear")
        slabs.append(jnp.pad(prev, ((0, 0), (0, Hc - th), (0, Wc - tw))))
    # bf16 canvas: intensities 0..255 are exact; resized levels round at
    # ~0.4% — inside the front-end's own noise. Halves every downstream
    # image read (FAST rings, blur, patch slices, stereo SAD).
    stack = jnp.stack(slabs, axis=1).astype(jnp.bfloat16)  # [B, L, Hc, Wc]
    ext_h = np.asarray([s[0] for s in shapes], np.int32)
    ext_w = np.asarray([s[1] for s in shapes], np.int32)
    return stack, ext_h, ext_w


def extract_orb_batched(images, cfg: OrbConfig):
    """[B, H, W] float32 (0..255) -> (Keypoints with leading B, raw_stack).

    raw_stack ([B, L, Hc, Wc]) is returned for reuse by the stereo SAD
    refinement (frame.py) so the pyramid is built exactly once.
    """
    B = images.shape[0]
    L = cfg.n_levels
    counts = level_feature_counts(cfg.n_features, L, cfg.scale_factor)
    raw_stack, ext_h, ext_w = build_pyramid_stack(images, cfg)
    _, _, Hc, Wc = raw_stack.shape

    flat = raw_stack.reshape(B * L, Hc, Wc)
    ext_h_t = jnp.asarray(np.tile(ext_h, B))
    ext_w_t = jnp.asarray(np.tile(ext_w, B))
    strict, relaxed = fast_detect_batched(
        flat, float(cfg.ini_fast_th), float(cfg.min_fast_th),
        cfg.edge_threshold, ext_h_t, ext_w_t,
    )

    n_top = max(counts)
    ys, xs, resp, valid = select_keypoints_batched(strict, relaxed, n_top, cfg.cell_size)
    ys = ys.reshape(B, L, n_top)
    xs = xs.reshape(B, L, n_top)
    resp = resp.reshape(B, L, n_top)
    valid = valid.reshape(B, L, n_top)

    # slice each level's budget off the front (candidates are rank-ordered)
    ys_l, xs_l, resp_l, valid_l, oct_l = [], [], [], [], []
    for lvl in range(L):
        n_l = counts[lvl]
        ys_l.append(ys[:, lvl, :n_l])
        xs_l.append(xs[:, lvl, :n_l])
        resp_l.append(resp[:, lvl, :n_l])
        valid_l.append(valid[:, lvl, :n_l])
        oct_l.append(jnp.full((B, n_l), lvl, jnp.int32))
    ys = jnp.concatenate(ys_l, axis=1)      # [B, N]
    xs = jnp.concatenate(xs_l, axis=1)
    resp = jnp.concatenate(resp_l, axis=1)
    valid = jnp.concatenate(valid_l, axis=1)
    octave = jnp.concatenate(oct_l, axis=1)

    # --- one patch slice-gather from the blurred stack (orientation+BRIEF).
    # vmapped dynamic_slice fetches contiguous 31-px rows instead of an
    # element-wise flat take (random device-memory access per element).
    blur_stack = gaussian_blur_batched(raw_stack)
    eh = jnp.take(jnp.asarray(ext_h), octave)
    ew = jnp.take(jnp.asarray(ext_w), octave)
    y0 = jnp.clip(ys - HALF_PATCH, 0, eh - PATCH)
    x0 = jnp.clip(xs - HALF_PATCH, 0, ew - PATCH)

    def eye_patches(stack_b, oct_b, y0_b, x0_b):
        img2d = stack_b.reshape(L * Hc, Wc)

        def one(o, y, x):
            return jax.lax.dynamic_slice(img2d, (o * Hc + y, x), (PATCH, PATCH))

        return jax.vmap(one)(oct_b, y0_b, x0_b)

    patches = jax.vmap(eye_patches)(
        blur_stack, octave, y0, x0
    ).reshape(B, -1, PATCH * PATCH)

    angle = angles_from_patches(patches)                 # [B, N]
    desc = brief_from_patches(patches, angle)            # [B, N, 8]

    scale = jnp.asarray(
        [cfg.scale_factor ** i for i in range(L)], jnp.float32
    )
    s = jnp.take(scale, octave)
    xy = jnp.stack([xs.astype(jnp.float32) * s, ys.astype(jnp.float32) * s], axis=-1)

    kp = Keypoints(xy=xy, response=resp, octave=octave, angle=angle,
                   desc=desc, valid=valid)
    return kp, raw_stack


def extract_orb(image, cfg: OrbConfig):
    """[H, W] float32 grayscale (0..255) -> Keypoints (single image)."""
    kp, _ = extract_orb_batched(image[None], cfg)
    return jax.tree.map(lambda x: x[0], kp)


@functools.lru_cache(maxsize=8)
def make_extract_fn(cfg: OrbConfig):
    """jit-compiled extractor for a fixed config (shapes fixed by the image)."""
    return jax.jit(functools.partial(extract_orb, cfg=cfg))


def scale_factors(cfg: OrbConfig):
    """Per-octave scale, sigma^2 arrays (KeyFrame/MapPoint scale prediction)."""
    s = np.array([cfg.scale_factor ** i for i in range(cfg.n_levels)], np.float32)
    return jnp.asarray(s), jnp.asarray(s * s)
