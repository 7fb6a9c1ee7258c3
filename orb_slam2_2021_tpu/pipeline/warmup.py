"""Startup precompilation of the engine's device programs.

XLA compiles one executable per program shape; shapes that first appear
mid-run (local-BA size buckets as the map grows, the loop-closure stack at
the first fired loop) cost seconds of compile ON the tracking-critical path.
The reference has no analogue (C++ is AOT), so its startup cost is
vocabulary loading (System.cc:84-98) — ours is jit warmup; both belong at
startup, not mid-run.

warmup_system() runs a tiny synthetic instance of every bucketed program the
pipeline can reach in steady state, and drives a throwaway synchronous
System over a short synthetic sequence at the real shapes (the tracking
lane's programs and the first keyframe's mapping pass), so each program is
compiled (and lands in the persistent compile cache) before the first real
frame. A compile left to the first real keyframe stalls the mapping worker
while tracking runs on without new keyframes. With a warm persistent cache
(jax_compilation_cache_dir) the whole pass is seconds; on a cold machine it
is a one-time multi-minute build.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def _dummy_pq_problem(C: int, P: int, Q: int, rng):
    """Synthetic PQ-layout BAProblem (obs index o = p*Q + q) with sane
    geometry (points in front of the cameras) so the solve is numerically
    ordinary."""
    from ..optim.ba import BAProblem

    O = P * Q
    xw = rng.uniform(-10, 10, (P, 3)).astype(np.float32) + np.array(
        [0, 0, 20], np.float32
    )
    obs_pt = np.repeat(np.arange(P, dtype=np.int32), Q)
    obs_cam = rng.integers(0, C, O).astype(np.int32)
    u = 700.0 * xw[obs_pt, 0] / xw[obs_pt, 2] + 600.0
    v = 700.0 * xw[obs_pt, 1] / xw[obs_pt, 2] + 180.0
    uvr = np.stack([u, v, u - 1.0], 1).astype(np.float32)
    return BAProblem(
        R=jnp.asarray(np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))),
        t=jnp.zeros((C, 3), jnp.float32),
        xw=jnp.asarray(xw),
        cam_free=jnp.asarray(np.arange(C) > 0),
        obs_cam=jnp.asarray(obs_cam),
        obs_pt=jnp.asarray(obs_pt),
        obs_uvr=jnp.asarray(uvr),
        obs_inv_sigma2=jnp.ones(O, jnp.float32),
        obs_valid=jnp.ones(O, bool),
        # production PQ assembly carries a [P, Q] int32 reverse index here
        # (assemble.py:104), and the pytree structure + every leaf shape are
        # part of the jit cache key: a None (or wrong-shaped dummy) warms a
        # program the pipeline never calls (measured: every BA bucket
        # recompiled mid-run despite warmup)
        pt_obs=jnp.full((P, Q), -1, jnp.int32),
    )


def _warm_pipeline(sys_):
    """Drive a throwaway synchronous System (same config, same vocabulary,
    its own map and keyframe database, no loop closing) over a seeded
    synthetic orbit: compiles the u8 frame build, initialization pack,
    reference-KF and fused track steps, and the first keyframe's mapping
    pass (triangulation, fusion, local BA, culling, grid update). The jitted
    programs are shared through the lru-cached factories, so the real System
    starts warm. The drive runs past the max-frames keyframe rule
    (TrackingConfig.max_frames_between_kf), so a second keyframe is made."""
    from ..io.synthetic import SyntheticCylinderWorld, orbit_trajectory
    from ..place.bundle import PlaceRecognition
    from .system import System

    cfg = sys_.cfg
    n_frames = cfg.tracking.max_frames_between_kf + 2
    place = PlaceRecognition(sys_.place.voc) if sys_.place is not None else None
    tmp = System(cfg, place_rec=place, enable_loop_closing=False)
    world = SyntheticCylinderWorld(cfg, seed=1)
    for i, (R, t) in enumerate(orbit_trajectory(n_frames, total_deg=40.0)):
        left, right = world.render(R, t)
        tmp.track_stereo(left, right, timestamp=0.1 * i)
    tmp.shutdown()


def warmup_system(sys_, verbose: bool = False):
    """Precompile the bucketed device programs the running pipeline reaches.

    Covers, beyond the throwaway drive (_warm_pipeline):
    - local-BA chunk programs at every (P, Q) size bucket
      (local_mapping._local_ba bucketing);
    - the host-stepped global-BA iteration at the loop-scale shape buckets
      (optim.assemble.global_problem_shapes);
    - the whole loop-closure stack: BoW pair matcher buckets, Sim3 RANSAC +
      refine buckets, Scw projection matcher, essential-graph solver buckets
      (loop_closing._compute_sim3 / _correct_loop).
    """
    import time as _time

    from ..optim.ba_cg import make_lm_chunk_pq

    cfg = sys_.cfg
    ocfg = cfg.optim
    cam = sys_.tracker.cam
    rng = np.random.default_rng(0)
    fences = []

    def note(label, t0):
        if verbose:
            print(f"[warmup] {label}: {_time.perf_counter() - t0:.1f}s",
                  flush=True)

    t0 = _time.perf_counter()
    _warm_pipeline(sys_)
    note("tracking lane + mapping pass", t0)

    # ---- local-BA chunks at each (C, P, Q) bucket the window can reach
    # (C buckets with the map's growth; huge C x P combos never co-occur) ----
    t0 = _time.perf_counter()
    C_max = ocfg.local_ba_max_cams + ocfg.local_ba_max_fixed
    cp_buckets = [(32, 512), (32, 1024), (32, 2048), (32, 4096),
                  (64, 2048), (64, 4096), (128, 4096)]
    for C, P in cp_buckets:
        C = min(C, C_max)
        P = min(P, ocfg.local_ba_max_points)
        for Q in (4, ocfg.local_ba_max_obs_per_point):
            prob = _dummy_pq_problem(C, P, Q, rng)
            lam = jnp.float32(ocfg.lm_lambda_init)
            active = prob.obs_valid.astype(jnp.float32)
            for n in (ocfg.local_ba_iters1, ocfg.local_ba_iters2):
                f = make_lm_chunk_pq(ocfg, n)
                out = f(cam, prob, prob.R, prob.t, prob.xw, lam, active,
                        jnp.bool_(True))
                fences.append(out[0])
    note("local-BA buckets", t0)

    # ---- global-BA iteration at loop-scale buckets (PQ/RCS path) ----
    t0 = _time.perf_counter()
    gba_chunk = make_lm_chunk_pq(ocfg, 1)
    Qg = ocfg.global_ba_obs_per_point
    for (Cg, Pg) in ((32, 2048), (32, 4096), (64, 4096), (64, 8192)):
        prob = _dummy_pq_problem(Cg, Pg, Qg, rng)
        lam = jnp.float32(ocfg.lm_lambda_init)
        active = prob.obs_valid.astype(jnp.float32)
        out = gba_chunk(cam, prob, prob.R, prob.t, prob.xw, lam, active,
                        jnp.bool_(True))
        fences.append(out[0])
    note("global-BA buckets", t0)

    # ---- loop-closure stack ----
    lc = sys_.loop_closer
    if lc is not None:
        t0 = _time.perf_counter()
        # BoW pair matcher buckets (kf-to-kf bound-feature counts): full
        # cross product — the two sides' counts are independent
        for n1 in (256, 512, 1024, 2048):
            for n2 in (256, 512, 1024, 2048):
                out = lc._match_fn(
                    jnp.zeros((n1, 8), jnp.uint32), jnp.ones(n1, bool),
                    jnp.zeros(n1, jnp.float32),
                    jnp.zeros((n2, 8), jnp.uint32), jnp.ones(n2, bool),
                    jnp.zeros(n2, jnp.float32),
                )
                fences.append(out[0])
        note("loop matcher buckets", t0)

        t0 = _time.perf_counter()
        key = jax.random.PRNGKey(0)
        for pad in (64, 128, 256, 512):
            x = jnp.asarray(rng.uniform(-5, 5, (pad, 3)).astype(np.float32)
                            + np.array([0, 0, 10], np.float32))
            uv = jnp.asarray(rng.uniform(0, 300, (pad, 2)).astype(np.float32))
            s2 = jnp.ones(pad, jnp.float32)
            valid = jnp.ones(pad, bool)
            out = lc._sim3_ransac(key, x, x, uv, uv, s2, s2, valid,
                                  cfg.fx, cfg.fy, cfg.cx, cfg.cy)
            fences.append(out[1])
            out = lc._sim3_refine(out[0], out[1], out[2], x, x, uv, uv,
                                  s2, s2, valid, cfg.fx, cfg.fy, cfg.cx, cfg.cy)
            fences.append(out[1])
        note("sim3 buckets", t0)

        t0 = _time.perf_counter()
        # Scw projection matcher (fixed P=4096 chunk; radius 10.0 as at the
        # ComputeSim3 call site, 3.0/sqrt-free variants share the program)
        from .mapping_steps import KFView

        N = cfg.orb.n_features
        view = KFView(
            xy=jnp.zeros((N, 2), jnp.float32), ur=jnp.full(N, -1.0),
            depth=jnp.full(N, -1.0), octave=jnp.zeros(N, jnp.int32),
            desc=jnp.zeros((N, 8), jnp.uint32), valid=jnp.ones(N, bool),
            R=jnp.eye(3), t=jnp.zeros(3),
        )
        Pf = 4096
        out = lc._fuse_fn(
            cam, view,
            jnp.asarray(rng.uniform(-5, 5, (Pf, 3)).astype(np.float32)
                        + np.array([0, 0, 10], np.float32)),
            jnp.zeros((Pf, 3), jnp.float32), jnp.zeros(Pf, jnp.float32),
            jnp.ones(Pf, jnp.float32), jnp.zeros((Pf, 8), jnp.uint32),
            jnp.ones(Pf, bool), radius_th=10.0,
        )
        fences.append(out[0])
        note("scw projection", t0)

        t0 = _time.perf_counter()
        # essential-graph solver buckets (K, E power-of-two padded)
        from ..optim.sim3_opt import PoseGraph

        for (K, E) in ((32, 256), (32, 512), (64, 512), (64, 1024)):
            g = PoseGraph(
                s=jnp.ones(K), R=jnp.tile(jnp.eye(3), (K, 1, 1)),
                t=jnp.zeros((K, 3)),
                edge_i=jnp.zeros(E, jnp.int32), edge_j=jnp.zeros(E, jnp.int32),
                m_s=jnp.ones(E), m_R=jnp.tile(jnp.eye(3), (E, 1, 1)),
                m_t=jnp.zeros((E, 3)), weight=jnp.zeros(E),
                fixed=jnp.ones(K, bool).at[0].set(True),
            )
            out = lc._essential(g)
            fences.append(out[0])
        note("essential-graph buckets", t0)

    # one fence at the end: compiles are synchronous on first call, so this
    # just drains the (tiny) executions
    for f in fences[-1:]:
        jax.block_until_ready(f)
