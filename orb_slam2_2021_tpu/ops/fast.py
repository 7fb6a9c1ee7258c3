"""FAST-9/16 corner detector as a dense, branch-free map over the image.

Behavioral equivalent of the cv::FAST calls in
ORBextractor::ComputeKeyPointsOctTree (/root/reference/src/ORBextractor.cc:
768-856): segment test on the 16-pixel Bresenham circle (radius 3) requiring
a contiguous arc of >= 9 brighter / darker pixels, a response score, and 3x3
non-max suppression. Instead of per-cell scalar loops, the whole level is
evaluated at once: 16 shifted copies of the image + boolean arc
reductions; NMS via reduce_window max-pooling.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# 16-pixel Bresenham circle of radius 3, clockwise from 12 o'clock
# (standard FAST geometry; (dy, dx) offsets).
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LEN = 9  # FAST-9


def _shifted_ring(image):
    """[H, W] -> [16, H, W]: image sampled at each circle offset.

    Border pixels (within radius 3) read the edge value; callers mask a
    border margin anyway (the reference skips EDGE_THRESHOLD=19 margins).
    """
    pads = []
    for dy, dx in CIRCLE_OFFSETS:
        shifted = jnp.roll(image, shift=(-dy, -dx), axis=(0, 1))
        pads.append(shifted)
    return jnp.stack(pads, axis=0)


def fast_score_map(image, threshold: float):
    """Dense FAST-9 response map. 0 where not a corner.

    Score = max(sum of (brighter - (c+t)) over bright ring pixels,
                sum of ((c-t) - darker) over dark ring pixels)
    restricted to points passing the 9-contiguous segment test — the same
    ranking semantics as OpenCV's FAST score used by the reference for its
    quadtree `response` ordering.
    """
    ring = _shifted_ring(image)  # [16, H, W]
    center = image[None]
    bright = ring > center + threshold
    dark = ring < center - threshold

    # contiguous arc of length >= 9 over the circular sequence
    bright2 = jnp.concatenate([bright, bright[:ARC_LEN - 1]], axis=0)
    dark2 = jnp.concatenate([dark, dark[:ARC_LEN - 1]], axis=0)

    def arc_all(x):
        # AND over sliding window of 9 along axis 0, evaluated at 16 starts
        acc = x[:16]
        for i in range(1, ARC_LEN):
            acc = jnp.logical_and(acc, x[i:i + 16])
        return jnp.any(acc, axis=0)

    is_bright_corner = arc_all(bright2)
    is_dark_corner = arc_all(dark2)
    is_corner = jnp.logical_or(is_bright_corner, is_dark_corner)

    bright_excess = jnp.sum(jnp.where(bright, ring - (center + threshold), 0.0), axis=0)
    dark_excess = jnp.sum(jnp.where(dark, (center - threshold) - ring, 0.0), axis=0)
    score = jnp.maximum(bright_excess, dark_excess)
    return jnp.where(is_corner, score, 0.0)


def nms3x3(score):
    """3x3 non-max suppression; keeps strict local maxima (ties broken by
    keeping the first in raster order via epsilon jitter-free >= on self)."""
    pooled = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where((score >= pooled) & (score > 0.0), score, 0.0)


def _has_arc(m):
    """[..., int32 16-bit ring masks] -> bool: any 9 circularly-consecutive
    set bits. AND of the mask with its 8 circular bit-rotations is nonzero
    iff some start position has bits s..s+8 all set — 16 integer ops per
    pixel instead of materializing [16, ...] boolean stacks."""
    acc = m
    for k in range(1, ARC_LEN):
        rot = ((m >> k) | (m << (16 - k))) & 0xFFFF
        acc = acc & rot
    return acc != 0


def fast_detect_batched(images, ini_threshold: float, min_threshold: float,
                        border: int, ext_h, ext_w):
    """Two-threshold FAST over a batch of (padded) images in ONE fused pass.

    images: [B, H, W]; ext_h/ext_w: [B] int32 valid extents per batch slab
    (stacked pyramid levels sit in the top-left corner of a common canvas).
    Both thresholds share the 16 shifted reads — the reference runs cv::FAST
    twice per empty cell (ORBextractor.cc:812-819). The segment test packs
    the ring comparisons into per-pixel 16-bit masks and checks the
    9-contiguous arc with bit rotations: everything is elementwise work
    XLA fuses into one kernel; nothing [16, B, H, W]-shaped is materialized.
    Returns (strict, relaxed) NMS'd score maps, zero outside
    [border, ext-border).
    """
    B, h, w = images.shape
    zero = jnp.zeros((), images.dtype)
    ms_b = jnp.zeros(images.shape, jnp.int32)
    ms_d = jnp.zeros(images.shape, jnp.int32)
    mr_b = jnp.zeros(images.shape, jnp.int32)
    mr_d = jnp.zeros(images.shape, jnp.int32)
    es_b = es_d = er_b = er_d = jnp.zeros(images.shape, images.dtype)
    for i, (dy, dx) in enumerate(CIRCLE_OFFSETS):
        diff = jnp.roll(images, shift=(-dy, -dx), axis=(1, 2)) - images
        bit = jnp.int32(1 << i)
        bs = diff > ini_threshold
        ds = diff < -ini_threshold
        ms_b = ms_b | jnp.where(bs, bit, 0)
        ms_d = ms_d | jnp.where(ds, bit, 0)
        es_b = es_b + jnp.where(bs, diff - ini_threshold, zero)
        es_d = es_d + jnp.where(ds, -diff - ini_threshold, zero)
        br = diff > min_threshold
        dr = diff < -min_threshold
        mr_b = mr_b | jnp.where(br, bit, 0)
        mr_d = mr_d | jnp.where(dr, bit, 0)
        er_b = er_b + jnp.where(br, diff - min_threshold, zero)
        er_d = er_d + jnp.where(dr, -diff - min_threshold, zero)

    strict = jnp.where(
        _has_arc(ms_b) | _has_arc(ms_d), jnp.maximum(es_b, es_d), 0.0
    )
    relaxed = jnp.where(
        _has_arc(mr_b) | _has_arc(mr_d), jnp.maximum(er_b, er_d), 0.0
    )

    ys = jnp.arange(h, dtype=jnp.int32)[None, :, None]
    xs = jnp.arange(w, dtype=jnp.int32)[None, None, :]
    in_border = (
        (ys >= border) & (ys < ext_h[:, None, None] - border)
        & (xs >= border) & (xs < ext_w[:, None, None] - border)
    )
    strict = jnp.where(in_border, nms3x3_batched(strict), 0.0)
    relaxed = jnp.where(in_border, nms3x3_batched(relaxed), 0.0)
    return strict, relaxed


def nms3x3_batched(score):
    """3x3 NMS over [B, H, W]."""
    pooled = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (1, 3, 3), (1, 1, 1), "SAME"
    )
    return jnp.where((score >= pooled) & (score > 0.0), score, 0.0)


def fast_detect(image, ini_threshold: float, min_threshold: float, border: int):
    """Two-threshold FAST as in the reference: strict threshold, with the
    relaxed threshold as fallback where the strict one found nothing nearby
    (ORBextractor.cc:812-819 retries empty 30px cells with minThFAST).

    Returns a single dense score map combining both: strict scores where any
    strict corner exists in the cell is handled by the bucketed selector
    (ops/select.py); here we return both maps.
    """
    h, w = image.shape
    strict = nms3x3(fast_score_map(image, ini_threshold))
    relaxed = nms3x3(fast_score_map(image, min_threshold))
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    in_border = (
        (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    )
    strict = jnp.where(in_border, strict, 0.0)
    relaxed = jnp.where(in_border, relaxed, 0.0)
    return strict, relaxed
