"""Spatially-bucketed keypoint selection — the data-parallel reformulation of
the reference's quadtree distribution (ORBextractor::DistributeOctTree,
/root/reference/src/ORBextractor.cc:542-766).

The quadtree's intent: spread keypoints uniformly over the image, preferring
response within each spatial region. We reproduce that intent without
divergent control flow: the level is cut into fixed cells; each cell yields
its top-K corners by response; globally we take cells' rank-0 corners first,
then rank-1, ... (lexicographic (rank, -response) order) until the per-level
budget is filled. The two-threshold fallback (strict iniThFAST, relaxed
minThFAST for empty cells, ORBextractor.cc:812-819) is applied per cell.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

K_PER_CELL = 8


def _pad_to_multiple(x, cell: int):
    h, w = x.shape
    ph = (-h) % cell
    pw = (-w) % cell
    if ph or pw:
        x = jnp.pad(x, ((0, ph), (0, pw)))
    return x


def select_keypoints_batched(strict_score, relaxed_score, n_top: int, cell: int):
    """Batched spatial-bucket selection over [B, H, W] score maps.

    Returns (ys, xs, scores, valid) each [B, n_top], the per-slab best
    n_top candidates in lexicographic (cell-rank, -response) order; the
    caller slices each slab's actual per-level budget off the front.
    H and W must be multiples of `cell` (callers pad the canvas).
    """
    B, hp, wp = strict_score.shape
    hc, wc = hp // cell, wp // cell

    def cells(x):
        return (
            x.reshape(B, hc, cell, wc, cell)
            .transpose(0, 1, 3, 2, 4)
            .reshape(B, hc * wc, cell * cell)
        )

    s_cells = cells(strict_score)
    r_cells = cells(relaxed_score)
    has_strict = jnp.max(s_cells, axis=2, keepdims=True) > 0.0
    combined = jnp.where(has_strict, s_cells, r_cells)

    k = min(K_PER_CELL, cell * cell)
    # iterative argmax-and-suppress: k passes of cheap reductions beat
    # lax.top_k's full per-row sort for k << row length (NMS leaves rows
    # nearly empty anyway)
    vals_l, idx_l = [], []
    x = combined
    pos = jnp.arange(x.shape[2], dtype=jnp.int32)[None, None, :]
    for _ in range(k):
        i = jnp.argmax(x, axis=2).astype(jnp.int32)            # [B, C]
        v = jnp.max(x, axis=2)
        vals_l.append(v)
        idx_l.append(i)
        x = jnp.where(pos == i[..., None], -jnp.inf, x)
    # fp32 from here: the (rank, response) lexicographic key needs the
    # rank*1e5 separation to dominate exactly (bf16 scores would alias)
    vals = jnp.stack(vals_l, axis=2).astype(jnp.float32)       # [B, C, k]
    idx = jnp.stack(idx_l, axis=2)
    rank = jnp.arange(k, dtype=jnp.float32)[None, None, :]

    flat_vals = vals.reshape(B, -1)
    flat_rank = jnp.broadcast_to(rank, vals.shape).reshape(B, -1)
    cell_ids = jnp.broadcast_to(
        jnp.arange(hc * wc, dtype=jnp.int32)[None, :, None], vals.shape
    ).reshape(B, -1)
    flat_idx = idx.reshape(B, -1)

    valid = flat_vals > 0.0
    key = jnp.where(valid, -flat_rank * 1e5 + jnp.minimum(flat_vals, 9e4), -jnp.inf)
    n_take = min(n_top, key.shape[1])
    top_keys, top_pos = jax.lax.top_k(key, n_take)             # [B, n_take]

    take = lambda a: jnp.take_along_axis(a, top_pos, axis=1)
    sel_cell = take(cell_ids)
    sel_inner = take(flat_idx)
    sel_val = take(flat_vals)
    sel_valid = jnp.isfinite(top_keys) & (sel_val > 0.0)

    cy = sel_cell // wc
    cx = sel_cell % wc
    ys = cy * cell + sel_inner // cell
    xs = cx * cell + sel_inner % cell
    if n_take < n_top:
        pad = [(0, 0), (0, n_top - n_take)]
        ys, xs = jnp.pad(ys, pad), jnp.pad(xs, pad)
        sel_val, sel_valid = jnp.pad(sel_val, pad), jnp.pad(sel_valid, pad)
    return ys.astype(jnp.int32), xs.astype(jnp.int32), sel_val, sel_valid


def select_keypoints(strict_score, relaxed_score, n_target: int, cell: int):
    """Pick n_target spatially-spread corners from dense score maps.

    Returns (ys, xs, scores, valid): each [n_target]; invalid slots have
    score 0 and valid False.
    """
    h, w = strict_score.shape
    s = _pad_to_multiple(strict_score, cell)
    r = _pad_to_multiple(relaxed_score, cell)
    hp, wp = s.shape
    hc, wc = hp // cell, wp // cell

    def cells(x):
        return x.reshape(hc, cell, wc, cell).transpose(0, 2, 1, 3).reshape(hc * wc, cell * cell)

    s_cells = cells(s)
    r_cells = cells(r)
    # per-cell fallback: use relaxed scores only where no strict corner exists
    has_strict = jnp.max(s_cells, axis=1, keepdims=True) > 0.0
    combined = jnp.where(has_strict, s_cells, r_cells)

    k = min(K_PER_CELL, cell * cell)
    vals, idx = jax.lax.top_k(combined, k)  # [C, k]
    rank = jnp.broadcast_to(jnp.arange(k, dtype=jnp.float32)[None, :], vals.shape)

    # flatten candidates; key prefers low rank, then high response
    flat_vals = vals.reshape(-1)
    flat_rank = rank.reshape(-1)
    cell_ids = jnp.broadcast_to(
        jnp.arange(hc * wc, dtype=jnp.int32)[:, None], vals.shape
    ).reshape(-1)
    flat_idx = idx.reshape(-1)

    valid = flat_vals > 0.0
    key = jnp.where(valid, -flat_rank * 1e5 + jnp.minimum(flat_vals, 9e4), -jnp.inf)
    n_take = min(n_target, key.shape[0])
    top_keys, top_pos = jax.lax.top_k(key, n_take)

    sel_cell = cell_ids[top_pos]
    sel_inner = flat_idx[top_pos]
    sel_val = flat_vals[top_pos]
    sel_valid = jnp.isfinite(top_keys) & (sel_val > 0.0)

    cy = sel_cell // wc
    cx = sel_cell % wc
    iy = sel_inner // cell
    ix = sel_inner % cell
    ys = cy * cell + iy
    xs = cx * cell + ix
    # clamp away padded region (shouldn't fire: padded scores are 0 => invalid)
    sel_valid = sel_valid & (ys < h) & (xs < w)

    if n_take < n_target:
        pad = n_target - n_take
        ys = jnp.pad(ys, (0, pad))
        xs = jnp.pad(xs, (0, pad))
        sel_val = jnp.pad(sel_val, (0, pad))
        sel_valid = jnp.pad(sel_valid, (0, pad))
    return ys.astype(jnp.int32), xs.astype(jnp.int32), sel_val, sel_valid
