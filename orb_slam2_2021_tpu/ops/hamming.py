"""Packed-descriptor Hamming distance kernels.

Replaces ORBmatcher::DescriptorDistance's SWAR popcount
(the reference's src/ORBmatcher.cc:1672-1688) with a matrix-product
formulation: the 256 descriptor bits are unpacked to a {0,1} bf16 matrix once
per side and the full [N, M] distance matrix every matcher policy reduces over
comes from ONE bf16 matmul via

    hamming(a, b) = popcnt(a) + popcnt(b) - 2 * <bits_a, bits_b>.

The dot products accumulate in f32 (preferred_element_type), and {0,1}
values as well as row popcounts (<= 256 = 2^8) are exact in bf16/f32, so the
result is bit-identical to the XOR+popcount formulation (hamming_pair), which
stays the plain reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

MAX_DIST = 256  # descriptors are 256 bits; 256 > any real distance


def hamming_pair(a, b):
    """[..., 8] uint32 vs [..., 8] uint32 -> [...] int32 distances."""
    x = jax.lax.population_count(jnp.bitwise_xor(a, b))
    return jnp.sum(x, axis=-1).astype(jnp.int32)


def unpack_bits(a):
    """[..., 8] uint32 -> [..., 256] bf16 in {0, 1} (little-endian per word)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (a[..., :, None] >> shifts) & jnp.uint32(1)  # [..., 8, 32]
    return bits.reshape(*a.shape[:-1], 256).astype(jnp.bfloat16)


def hamming_matrix(a, b):
    """[N, 8] x [M, 8] -> [N, M] int16 distance matrix (one bf16 matmul).

    int16 halves the dominant HBM traffic (the [N, M] write + its consumer
    read); distances are <= 256 so the narrow type is exact, and every
    consumer reduces/compares (argmin, thresholds) without arithmetic that
    could overflow."""
    A = unpack_bits(a)
    B = unpack_bits(b)
    dot = jax.lax.dot_general(
        A, B, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )
    pa = jnp.sum(A, axis=1, dtype=jnp.float32)
    pb = jnp.sum(B, axis=1, dtype=jnp.float32)
    return (pa[:, None] + pb[None, :] - 2.0 * dot).astype(jnp.int16)


def masked_best2(dist, mask, axis=1):
    """Best and second-best distances (+ best index) under a boolean mask.

    dist: [N, M] int32; mask: [N, M] bool. Invalid entries count as MAX_DIST.
    Returns (best, best_idx, second) along `axis`.
    """
    d = jnp.where(mask, dist, MAX_DIST)
    best_idx = jnp.argmin(d, axis=axis)
    best = jnp.min(d, axis=axis)
    # mask out the best to find second best
    oh = jax.nn.one_hot(best_idx, d.shape[axis], axis=axis, dtype=jnp.bool_)
    d2 = jnp.where(oh, MAX_DIST, d)
    second = jnp.min(d2, axis=axis)
    return best, best_idx, second


def rotation_histogram_filter(angle_a, angle_b, matched_mask, n_bins=30, keep=3):
    """Rotation-consistency check (ORBmatcher.cc:1627-1668 semantics).

    angle_a/angle_b: [N] radians for the two matched sets (angle_b already
    gathered to align with a). matched_mask: [N] bool. Keeps only matches
    whose angle difference falls in the top-`keep` histogram bins.
    """
    two_pi = 2.0 * jnp.pi
    rot = jnp.mod(angle_a - angle_b, two_pi)  # [0, 2pi)
    bins = jnp.floor(rot * (n_bins / two_pi)).astype(jnp.int32)
    bins = jnp.clip(bins, 0, n_bins - 1)
    counts = jnp.sum(
        jax.nn.one_hot(bins, n_bins, dtype=jnp.int32) * matched_mask[:, None].astype(jnp.int32),
        axis=0,
    )
    top_vals, top_idx = jax.lax.top_k(counts, keep)
    in_top = jnp.any(bins[:, None] == top_idx[None, :], axis=1)
    # bins with zero count can appear in top_k when few matches exist; require count>0
    keep_mask = in_top & (jnp.take(counts, bins) > 0)
    return matched_mask & keep_mask
