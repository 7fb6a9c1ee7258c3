"""Per-event local-BA timing on the device: drive enough frames that the
shape buckets stabilize, then print every BA event's dispatch/pull time so
cold (bucket-compile) events separate from the steady state."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    from orb_slam2_2021_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from orb_slam2_2021_tpu.config import kitti_stereo_config
    from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld
    from orb_slam2_2021_tpu.pipeline.system import System

    cfg = kitti_stereo_config()
    world = SyntheticStereoWorld(cfg, seed=7)
    poses = []
    pos = np.zeros(3, np.float32)
    ang = 0.0
    for i in range(70):
        # gentle arc so covisibility turns over and buckets grow
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]], np.float32)
        poses.append((R, pos.copy()))
        pos = pos + (R @ np.array([0.3, 0, 0], np.float32))
        ang += 0.004
    print("rendering...", flush=True)
    frames = [world.render(R, t) for (R, t) in poses]
    print("driving...", flush=True)

    sys_ = System(cfg, async_mode=False)
    t0 = time.perf_counter()
    frame_t = []
    for i, (l, r) in enumerate(frames):
        tf = time.perf_counter()
        sys_.track_stereo(l, r, timestamp=i * 0.1)
        frame_t.append(time.perf_counter() - tf)
    total = time.perf_counter() - t0
    sys_.shutdown()

    lm = sys_.local_mapper
    print(f"frames {len(frames)}  total {total:.1f}s  "
          f"median_frame {1e3*np.median(frame_t):.0f} ms  "
          f"fps {len(frames)/total:.2f}")
    for i, e in enumerate(getattr(lm, "ba_events", [])):
        print(f"  BA[{i:2d}] P={e['P']:5d} Q={e['Q']:2d} "
              f"dispatch {e['dispatch_ms']:7.1f} ms  pull {e['pull_ms']:7.1f} ms")
    sect = sorted(lm.sect_times.items(), key=lambda kv: -kv[1])
    for k, v in sect:
        print(f"  [sect] {k:36s} {1e3*v:8.0f} ms total")
    tr = sorted(sys_.tracker.sect_times.items(), key=lambda kv: -kv[1])
    for k, v in tr:
        print(f"  [trk]  {k:36s} {1e3*v:8.0f} ms total")


if __name__ == "__main__":
    main()
