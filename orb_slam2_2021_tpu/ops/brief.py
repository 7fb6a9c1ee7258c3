"""Rotated BRIEF (rBRIEF) 256-bit descriptors.

Role of ORBextractor::computeOrbDescriptor
(/root/reference/src/ORBextractor.cc:105-151): sample 256 intensity pairs
around the keypoint on the blurred level image, rotated by the keypoint's
orientation, and pack the comparisons into a 256-bit string.

The reference ships OpenCV's learned `bit_pattern_31_` table
(ORBextractor.cc:153-411). We do NOT reuse it: descriptor bit layout needs no
compatibility with any external vocabulary here (we train our own), so the
sampling pattern is generated once from a fixed PRNG seed — isotropic
Gaussian pairs (sigma = patch/5, the original BRIEF recipe) clipped to a disc
of radius 13 so rotated samples stay inside the EDGE_THRESHOLD=19 border the
detector already enforces (13 * sqrt2 < 19).

Sampling all keypoints x 512 points is one flat gather; packing is a
[N, 8, 32] dot with bit weights -> uint32[8] words per descriptor.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

N_BITS = 256
PATTERN_RADIUS = 13.0
PATTERN_SIGMA = 31.0 / 5.0


@functools.lru_cache(maxsize=1)
def brief_pattern():
    """[256, 2, 2] float32: (pair, endpoint, (y, x)). Fixed seed."""
    rng = np.random.default_rng(0x0FB1_5EED)
    pts = []
    while len(pts) < N_BITS * 2:
        p = rng.normal(0.0, PATTERN_SIGMA, size=2)
        if float(p @ p) <= PATTERN_RADIUS * PATTERN_RADIUS:
            pts.append(p)
    # host constant: cached across jit traces (see ops/image._gaussian_kernel)
    return np.asarray(pts, dtype=np.float32).reshape(N_BITS, 2, 2)


@functools.lru_cache(maxsize=1)
def _bit_weights():
    return (np.uint32(1) << np.arange(32, dtype=np.uint32)).astype(np.uint32)


N_BINS = 64          # descriptor-rotation quantization for the matmul path
PATCH_HALF = 15      # sampling patch half-size (shared with orientation)
PATCH_SIDE = 2 * PATCH_HALF + 1


@functools.lru_cache(maxsize=2)
def brief_bin_matrices(n_bins: int = N_BINS):
    """Per-rotation-bin two-hot sampling matrices [n_bins, 961, 256] int8.

    The matrix-product formulation of rBRIEF: for a 31x31 patch flattened to p in
    R^961, bit i under rotation bin b is sign(p @ D[b, :, i]) where D has +1
    at the rotated coordinate of the pair's second endpoint and -1 at the
    first — the dot IS the intensity difference (exact, two nonzeros).
    Quantizing rotation to n_bins=64 moves samples by at most
    13*sin(pi/64) ~ 0.64 px, below the integer rounding the per-sample
    rotation already applies (ORBextractor.cc:117-118 rounds too).
    """
    pat = brief_pattern()  # [256, 2, 2] (y, x)
    D = np.zeros((n_bins, PATCH_SIDE * PATCH_SIDE, N_BITS), np.int8)
    for b in range(n_bins):
        th = 2.0 * np.pi * b / n_bins
        ca, sa = np.cos(th), np.sin(th)
        py = pat[:, :, 0]
        px = pat[:, :, 1]
        ry = np.clip(np.round(px * sa + py * ca).astype(np.int64), -PATCH_HALF, PATCH_HALF)
        rx = np.clip(np.round(px * ca - py * sa).astype(np.int64), -PATCH_HALF, PATCH_HALF)
        idx = (ry + PATCH_HALF) * PATCH_SIDE + (rx + PATCH_HALF)  # [256, 2]
        for i in range(N_BITS):
            D[b, idx[i, 1], i] += 1   # second endpoint: +1
            D[b, idx[i, 0], i] -= 1   # first endpoint:  -1
    return D


def brief_from_patches(patches, angles):
    """Descriptors from pre-gathered patches — the matmul hot path.

    patches: [..., 961] float (31x31 blurred intensities, row-major);
    angles: [...] radians. Returns [..., 8] uint32.

    bits = sign((patch . D_bin)) accumulated over rotation bins with a
    per-keypoint bin mask; every bin's product is a dense [N, 961]x[961, 256]
    bf16 matmul (fp32 accumulation).
    """
    D = brief_bin_matrices()
    lead = patches.shape[:-1]
    p = patches.reshape(-1, PATCH_SIDE * PATCH_SIDE).astype(jnp.bfloat16)
    tau = 2.0 * jnp.pi
    binf = jnp.round(jnp.mod(angles.reshape(-1), tau) / tau * N_BINS)
    bins = jnp.mod(binf.astype(jnp.int32), N_BINS)

    diff = jnp.zeros((p.shape[0], N_BITS), jnp.float32)
    for b in range(N_BINS):
        mask = (bins == b).astype(jnp.bfloat16)[:, None]
        Db = jnp.asarray(D[b], jnp.bfloat16)
        diff = diff + jnp.dot(p * mask, Db, preferred_element_type=jnp.float32)
    bits = diff > 0.0
    words = bits.reshape(-1, 8, 32).astype(jnp.uint32)
    packed = jnp.sum(words * _bit_weights()[None, None, :], axis=-1, dtype=jnp.uint32)
    return packed.reshape(*lead, 8)


def brief_descriptors(blurred, ys, xs, angles):
    """Descriptors for N keypoints on one (blurred) pyramid level.

    blurred: [H, W] float32; ys/xs: [N] int32 level coords; angles: [N] rad.
    Returns [N, 8] uint32 (256 bits packed little-endian per word).
    """
    h, w = blurred.shape
    pat = brief_pattern()  # [256, 2, 2] (y, x)
    ca = jnp.cos(angles)[:, None]  # [N, 1]
    sa = jnp.sin(angles)[:, None]

    py = pat[None, :, :, 0].reshape(1, -1)  # [1, 512]
    px = pat[None, :, :, 1].reshape(1, -1)

    # rotate: row = x sin + y cos, col = x cos - y sin (ORBextractor.cc:117-118 semantics)
    ry = jnp.round(px * sa + py * ca).astype(jnp.int32) + ys[:, None]
    rx = jnp.round(px * ca - py * sa).astype(jnp.int32) + xs[:, None]
    ry = jnp.clip(ry, 0, h - 1)
    rx = jnp.clip(rx, 0, w - 1)

    flat = blurred.reshape(-1)
    vals = jnp.take(flat, ry * w + rx, axis=0)  # [N, 512]
    vals = vals.reshape(vals.shape[0], N_BITS, 2)
    bits = (vals[..., 0] < vals[..., 1])  # [N, 256]

    words = bits.reshape(-1, 8, 32).astype(jnp.uint32)
    packed = jnp.sum(words * _bit_weights()[None, None, :], axis=-1, dtype=jnp.uint32)
    return packed
