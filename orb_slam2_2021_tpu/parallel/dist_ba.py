"""Distributed bundle adjustment over a device mesh.

Sharding layout (the SLAM analogue of data/tensor parallel, SURVEY.md §5
long-context entry):
- landmarks and their observations are sharded over the mesh axis "map"
  (each device owns P/n points and ALL observations of those points — the
  landmark-block elimination is then embarrassingly parallel, exactly like
  g2o's per-landmark Schur elimination but across chips);
- cameras are replicated; the reduced camera system S and rhs are
  psum-reduced across the devices, and the (small) dense solve is computed
  redundantly on every device — cheaper than gathering to one device for
  C <= ~256;
- back-substitution for the owned landmark shard is local.

This is the building block for multi-host local/global BA; the host-side
assembly groups observations by owning point so the shard boundaries are
clean.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import OptimConfig
from ..optim.ba import BAProblem, ba_solve

AXIS = "map"


def _shard_map(f, *, mesh, in_specs, out_specs):
    """Version-portable shard_map with replication checking disabled.

    The local functions psum camera-side reductions explicitly, so outputs
    marked replicated really are — but the checker cannot always prove it.
    JAX renamed the opt-out kwarg check_rep -> check_vma (0.9); try each and
    fall back to no kwarg at all.
    """
    try:
        from jax import shard_map
    except ImportError:  # pragma: no cover - older jax
        from jax.experimental.shard_map import shard_map
    for kw in ({"check_vma": False}, {"check_rep": False}, {}):
        try:
            return shard_map(
                f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, **kw
            )
        except TypeError:
            continue
    raise RuntimeError("no compatible shard_map signature found")


def shard_ba_problem(prob: BAProblem, n_dev: int) -> BAProblem:
    """Re-pad a host-assembled BAProblem so P and O divide n_dev and each
    point's observations live in the same shard as the point.

    Host-side (numpy): observations are re-ordered so that the obs of point
    shard d occupy the d-th O-shard; pt_obs indices are rewritten to the new
    positions. Padding slots get obs_valid=False.
    """
    R = np.asarray(prob.R)
    xw = np.asarray(prob.xw)
    P_ = xw.shape[0]
    Q = prob.pt_obs.shape[1]
    assert P_ % n_dev == 0, "pad points to a multiple of device count first"
    P_loc = P_ // n_dev

    obs_cam = np.asarray(prob.obs_cam)
    obs_pt = np.asarray(prob.obs_pt)
    obs_uvr = np.asarray(prob.obs_uvr)
    obs_is2 = np.asarray(prob.obs_inv_sigma2)
    obs_valid = np.asarray(prob.obs_valid)
    pt_obs = np.asarray(prob.pt_obs)

    # per-device max obs -> uniform local capacity
    owner = obs_pt // P_loc
    O_loc = 0
    for d in range(n_dev):
        O_loc = max(O_loc, int((obs_valid & (owner == d)).sum()))
    O_loc = max(O_loc, Q)  # at least Q
    # round up to a lane-friendly multiple
    O_loc = ((O_loc + 127) // 128) * 128

    n_cam = np.zeros(n_dev * O_loc, np.int32)
    # padded slots must stay shard-consistent: point index inside the owning
    # shard (the local-frame shift in make_dist_ba subtracts d*P_loc, and a
    # global 0 would go negative on shards d>0 and gather garbage)
    n_pt = np.repeat(np.arange(n_dev, dtype=np.int32) * P_loc, O_loc)
    n_uvr = np.full((n_dev * O_loc, 3), -1.0, np.float32)
    n_is2 = np.ones(n_dev * O_loc, np.float32)
    n_valid = np.zeros(n_dev * O_loc, bool)
    n_pt_obs = np.full((P_, Q), -1, np.int32)

    # vectorized shard packing: stable-sort valid obs by owning shard, then
    # rank within each shard gives the local slot
    vi = np.nonzero(obs_valid)[0]
    order = vi[np.argsort(owner[vi], kind="stable")]
    own_sorted = owner[order]
    shard_start = np.searchsorted(own_sorted, np.arange(n_dev))
    rank = np.arange(len(order)) - shard_start[own_sorted]
    pos = own_sorted * O_loc + rank
    remap = np.full(len(obs_cam), -1, np.int64)
    remap[order] = pos
    n_cam[pos] = obs_cam[order]
    n_pt[pos] = obs_pt[order]
    n_uvr[pos] = obs_uvr[order]
    n_is2[pos] = obs_is2[order]
    n_valid[pos] = True
    po_ok = pt_obs >= 0
    n_pt_obs[po_ok] = remap[pt_obs[po_ok]]

    return prob._replace(
        obs_cam=jnp.asarray(n_cam), obs_pt=jnp.asarray(n_pt),
        obs_uvr=jnp.asarray(n_uvr), obs_inv_sigma2=jnp.asarray(n_is2),
        obs_valid=jnp.asarray(n_valid), pt_obs=jnp.asarray(n_pt_obs),
    )


def problem_pspec() -> BAProblem:
    """The canonical partition layout: points/obs sharded over 'map',
    cameras replicated."""
    return BAProblem(
        R=P(), t=P(), xw=P(AXIS),
        obs_cam=P(AXIS), obs_pt=P(AXIS), obs_uvr=P(AXIS),
        obs_inv_sigma2=P(AXIS), obs_valid=P(AXIS),
        pt_obs=P(AXIS), cam_free=P(),
    )


def device_put_sharded_problem(prob: BAProblem, mesh: Mesh) -> BAProblem:
    """ONE explicit placement of a shard_ba_problem output onto the mesh.

    Without this, every jitted dist-step call re-commits the host arrays to
    the required sharding — re-uploading the whole problem per LM
    iteration."""
    return jax.tree.map(
        lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec)),
        prob, problem_pspec(),
    )


def make_dist_ba(cfg: OptimConfig, mesh: Mesh, iters1=None, iters2=None):
    """Build the shard_map-wrapped distributed BA step for a mesh with axis
    'map'. Call with a problem prepared by shard_ba_problem."""
    iters1 = cfg.local_ba_iters1 if iters1 is None else iters1
    iters2 = cfg.local_ba_iters2 if iters2 is None else iters2

    def local_fn(cam, prob: BAProblem):
        # inside shard_map: local obs/pt shards; global indices still valid
        # because cameras are replicated and obs_pt is globally numbered —
        # shift obs_pt/pt_obs into the local frame.
        n_dev = jax.lax.psum(1, AXIS)
        d = jax.lax.axis_index(AXIS)
        P_loc = prob.xw.shape[0]
        O_loc = prob.obs_cam.shape[0]
        prob_local = prob._replace(
            obs_pt=prob.obs_pt - d * P_loc,
            pt_obs=jnp.where(prob.pt_obs >= 0, prob.pt_obs - d * O_loc, -1),
        )
        return ba_solve(cam, prob_local, cfg, iters1, iters2, axis_name=AXIS)

    pspec = BAProblem(
        R=P(), t=P(), xw=P(AXIS),
        obs_cam=P(AXIS), obs_pt=P(AXIS), obs_uvr=P(AXIS),
        obs_inv_sigma2=P(AXIS), obs_valid=P(AXIS),
        pt_obs=P(AXIS), cam_free=P(),
    )
    fn = _shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(), pspec),
        out_specs=(P(), P(), P(AXIS), P(AXIS)),
    )
    return jax.jit(fn)


def make_dist_gba_iteration(cfg: OptimConfig, mesh: Mesh, cam):
    """One host-steppable global-BA LM iteration sharded over the mesh axis
    'map' (points + observations sharded, cameras replicated, camera-side
    reductions psum'd across the devices). The host drives iterations so the abort /
    staleness protocol (mbStopGBA, LoopClosing.cc:604-608) works unchanged in
    the multi-chip configuration. `cam` (python-float PinholeCamera) is
    closed over. Call with a problem prepared by shard_ba_problem."""
    from ..optim.ba import _residual_chi2, _residual_jacobians, _total_cost
    from ..optim.ba_cg import _cg_lm_step

    def local_step(prob: BAProblem, R, t, xw, lam, active, use_huber):
        d = jax.lax.axis_index(AXIS)
        P_loc = prob.xw.shape[0]
        prob_local = prob._replace(obs_pt=prob.obs_pt - d * P_loc)
        Rn, tn, xwn, chi2, behind, delta2 = _cg_lm_step(
            cam, prob_local, R, t, xw, active, lam, use_huber, cfg,
            cfg.cg_iters, AXIS,
        )
        cost_old = jax.lax.psum(
            _total_cost(chi2, active, delta2, use_huber), AXIS
        )
        chi2n, _ = _residual_chi2(cam, prob_local, Rn, tn, xwn)
        cost_new = jax.lax.psum(
            _total_cost(chi2n, active, delta2, use_huber), AXIS
        )
        improved = cost_new < cost_old
        R = jnp.where(improved, Rn, R)
        t = jnp.where(improved, tn, t)
        xw = jnp.where(improved, xwn, xw)
        lam = jnp.where(improved, lam * 0.5, lam * 4.0)
        return R, t, xw, lam, cost_new

    pspec = BAProblem(
        R=P(), t=P(), xw=P(AXIS),
        obs_cam=P(AXIS), obs_pt=P(AXIS), obs_uvr=P(AXIS),
        obs_inv_sigma2=P(AXIS), obs_valid=P(AXIS),
        pt_obs=P(AXIS), cam_free=P(),
    )
    fn = _shard_map(
        local_step,
        mesh=mesh,
        in_specs=(pspec, P(), P(), P(AXIS), P(), P(AXIS), P()),
        out_specs=(P(), P(), P(AXIS), P(), P()),
    )
    return jax.jit(fn)
