"""Scale proof: drive >= 1,500 keyframes / >= 500k map points through the
real add / cull / covisibility / retrieval / BA paths and record cost curves
(VERDICT r1+r2 long-context ask; KITTI 00 is ~1.3k KFs, SURVEY.md §5).

Scripted map growth — keyframes are synthesized directly (no rendering):
a long corridor where each keyframe observes ~400 points shared with its
~8 trajectory neighbors, giving a realistic banded covisibility structure.
Every API exercised is the production one: MapStore.add_keyframe (native
batch observation path), add_map_points_batch, update_connections,
covisible_keyframes, erase_keyframe (mTcp + KFDB erase callback),
KeyFrameDatabase add/detect_loop_candidates, local_map_snapshot, and at
full size one global-BA assembly + 3 matrix-free LM iterations plus one
essential-graph solve over all keyframes.

Usage: python scripts/scale_1500kf.py [n_kf]   (default 1500)
Writes a cost-curve table to stdout and SCALE_1500KF.json at the repo root.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
if os.environ.get("SCALE_PLATFORM"):
    jax.config.update("jax_platforms", os.environ["SCALE_PLATFORM"])
from orb_slam2_2021_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def main():
    n_kf_target = int(sys.argv[1]) if len(sys.argv) > 1 else 1500
    from orb_slam2_2021_tpu.config import kitti_stereo_config
    from orb_slam2_2021_tpu.mapping.map_store import MapStore
    from orb_slam2_2021_tpu.place.bundle import PlaceRecognition

    cfg = kitti_stereo_config()
    m = MapStore(cfg)
    place = PlaceRecognition.load_default()
    kfdb = place.kfdb
    m.on_kf_erased = kfdb.erase
    rng = np.random.default_rng(0)
    n_feat = cfg.orb.n_features

    OBS_PER_KF = 400          # bound features per KF
    NEW_PER_KF = 340          # fresh points per KF (rest re-observed)
    word_pool = rng.integers(0, place.voc.n_words, 4000)

    curves = []
    live_points = []          # ids of recent points for re-observation

    t_all = time.perf_counter()
    for i in range(n_kf_target):
        x = 0.5 * i
        R = np.eye(3, dtype=np.float32)
        t = np.array([-x, 0, 0], np.float32)

        # new points ahead of the camera
        pos = rng.uniform(-4, 4, (NEW_PER_KF, 3)).astype(np.float32)
        pos[:, 0] += x
        pos[:, 2] = rng.uniform(4, 30, NEW_PER_KF)
        desc = rng.integers(0, 2 ** 32, (NEW_PER_KF, 8), dtype=np.uint32)
        t0 = time.perf_counter()
        new_ids = m.add_map_points_batch(pos, desc, first_kf=m.next_kf)
        t_addmp = time.perf_counter() - t0

        # bindings: fresh points + re-observations of recent ones
        n_re = OBS_PER_KF - NEW_PER_KF
        re_ids = (
            np.asarray(live_points[-8 * NEW_PER_KF :], np.int64)
            if live_points else np.zeros(0, np.int64)
        )
        if len(re_ids) >= n_re:
            re_sel = rng.choice(re_ids, n_re, replace=False)
        else:
            re_sel = re_ids
        bind = np.full(n_feat, -1, np.int64)
        slots = rng.choice(n_feat, len(new_ids) + len(re_sel), replace=False)
        bind[slots[: len(new_ids)]] = new_ids
        bind[slots[len(new_ids):]] = re_sel
        live_points.extend(int(v) for v in new_ids)
        if len(live_points) > 16 * NEW_PER_KF:
            live_points = live_points[-16 * NEW_PER_KF :]

        xy = rng.uniform(0, [cfg.width, cfg.height], (n_feat, 2)).astype(np.float32)
        ur = rng.uniform(0, cfg.width, n_feat).astype(np.float32)
        depth = rng.uniform(4, 30, n_feat).astype(np.float32)
        octv = rng.integers(0, cfg.orb.n_levels, n_feat).astype(np.int32)
        ang = rng.uniform(0, 360, n_feat).astype(np.float32)
        fdesc = rng.integers(0, 2 ** 32, (n_feat, 8), dtype=np.uint32)
        valid = np.ones(n_feat, bool)

        t0 = time.perf_counter()
        k = m.add_keyframe(R, t, xy, ur, depth, octv, ang, fdesc, valid, bind,
                           frame_id=i, timestamp=0.1 * i)
        t_addkf = time.perf_counter() - t0

        # retrieval index: structured word sets (neighbors share words)
        words = np.concatenate([
            word_pool[(i * 60 + np.arange(180)) % len(word_pool)],
            rng.integers(0, place.voc.n_words, 120),
        ])
        t0 = time.perf_counter()
        kfdb.add(k, words.astype(np.int64))
        t_kfdb_add = time.perf_counter() - t0

        # periodic work at the real cadences (sampled on the recording
        # iterations so the curves actually capture them)
        t_covis = t_query = t_cull = t_snap = 0.0
        if i % 10 == 9:
            t0 = time.perf_counter()
            _ = m.covisible_keyframes(k)
            t_covis = time.perf_counter() - t0
            t0 = time.perf_counter()
            connected = set(int(v) for v in m.covisible_keyframes(k))
            _ = kfdb.detect_loop_candidates(
                k, 0.01, connected, lambda x: m.covisible_keyframes(x, 10)
            )
            t_query = time.perf_counter() - t0
            t0 = time.perf_counter()
            _ = m.local_map_snapshot(
                np.asarray([k], np.int64), cfg.tracking.local_points_cap
            )
            t_snap = time.perf_counter() - t0
        if i % 25 == 24 and i > 50:
            # cull a mid-age keyframe (erase + mTcp + KFDB erase)
            victim = k - 10
            if m.kf_valid[victim]:
                t0 = time.perf_counter()
                m.erase_keyframe(victim)
                t_cull = time.perf_counter() - t0

        if i % 100 == 99:
            rec = {
                "n_kf": int(m.n_kf),
                "n_mp": int(m.mp_valid.sum()),
                "ms_add_kf": 1e3 * t_addkf,
                "ms_add_points": 1e3 * t_addmp,
                "ms_kfdb_add": 1e3 * t_kfdb_add,
                "ms_covis_query": 1e3 * t_covis,
                "ms_loop_candidates": 1e3 * t_query,
                "ms_snapshot": 1e3 * t_snap,
                "ms_kf_cull": 1e3 * t_cull,
                "elapsed_s": time.perf_counter() - t_all,
            }
            curves.append(rec)
            print({k_: (round(v, 2) if isinstance(v, float) else v)
                   for k_, v in rec.items()}, flush=True)

    # ---- full-map global BA (3 LM iterations) + essential graph ----
    from orb_slam2_2021_tpu.pipeline.loop_closing import LoopClosing

    lc = LoopClosing(cfg, m, kfdb)
    import jax.numpy as jnp
    from orb_slam2_2021_tpu.optim.assemble import (
        assemble_ba_problem, global_problem_shapes,
    )
    from orb_slam2_2021_tpu.optim.ba_cg import make_gba_iteration

    kfs = np.nonzero(m.kf_valid)[0]
    mp = np.nonzero(m.mp_valid)[0]
    mp = mp[m.mp_obs_n[mp] > 0]
    n_obs = int(np.count_nonzero(m.mp_obs_kf[mp] >= 0))
    t0 = time.perf_counter()
    C_pad, P_pad, O_pad = global_problem_shapes(len(kfs), len(mp), n_obs)
    prob, _, _, _ = assemble_ba_problem(
        m, kfs, kfs != kfs[0], mp, C_pad, P_pad, O_pad
    )
    t_assemble = time.perf_counter() - t0
    print(f"GBA problem: C={len(kfs)} P={len(mp)} O={n_obs} "
          f"(padded {C_pad}/{P_pad}/{O_pad}), assembled in {t_assemble:.2f}s",
          flush=True)

    step = make_gba_iteration(cfg.optim)
    from orb_slam2_2021_tpu.geometry.camera import PinholeCamera
    cam = PinholeCamera.create(cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.bf,
                               cfg.width, cfg.height)
    R, t, xw = prob.R, prob.t, prob.xw
    lam = jnp.float32(cfg.optim.lm_lambda_init)
    active = prob.obs_valid.astype(jnp.float32)
    gba_iters = []
    for it in range(3):
        t0 = time.perf_counter()
        R, t, xw, lam, cost = step(cam, prob, R, t, xw, lam, active,
                                   jnp.bool_(True))
        jax.block_until_ready(R)
        gba_iters.append(time.perf_counter() - t0)
        print(f"GBA iter {it}: {gba_iters[-1]:.2f}s  cost={float(cost):.3e}",
              flush=True)

    # essential-graph solve over every keyframe (spanning tree + covis>=100)
    t0 = time.perf_counter()
    lc.loop_edges.setdefault(int(kfs[-1]), set()).add(int(kfs[0]))
    lc._optimize_essential_graph(
        int(kfs[-1]), int(kfs[0]),
        {int(kfs[-1]): (1.0, m.kf_R[kfs[-1]].copy(), m.kf_t[kfs[-1]].copy())},
        {}, {},
    )
    t_essential = time.perf_counter() - t0
    print(f"essential graph over {len(kfs)} KFs: {t_essential:.2f}s", flush=True)

    out = {
        "n_kf_final": int(m.n_kf),
        "n_mp_final": int(m.mp_valid.sum()),
        "n_obs_final": n_obs,
        "curves": curves,
        "gba_assemble_s": t_assemble,
        "gba_iter_s": gba_iters,
        "essential_graph_s": t_essential,
        "total_s": time.perf_counter() - t_all,
        "platform": jax.devices()[0].platform,
    }
    with open("SCALE_1500KF.json", "w") as f:
        json.dump(out, f, indent=1)
    print("wrote SCALE_1500KF.json; total",
          f"{out['total_s']:.0f}s on {out['platform']}")


if __name__ == "__main__":
    main()
