"""CLI dataset driver — the reference's example binary equivalent
(/root/reference/Examples/Stereo/arducam_images.cpp): run the pipeline over a
sequence, print per-frame timing stats at exit (:179-187), save KITTI + TUM
trajectories (:190).

Usage:
  python examples/run_slam.py synthetic [n_frames]         # built-in demo
  python examples/run_slam.py kitti <seq_dir> [--reduced]  # KITTI stereo
  python examples/run_slam.py tum <seq_dir>                # TUM RGB-D

Options:
  --reduced        first 500 frames (scripts/stereo_kitti_red.sh semantics)
  --pace           real-time pacing: sleep to the dataset timestamp schedule
                   (arducam_images.cpp:165-172); prints how many frames the
                   engine was LATE for — the 'keeps up at N fps' check
  --async          threaded pipeline (tracking lane + mapping worker), the
                   reference's thread layout
  --viz <dir>      write frame-overlay + map PNGs (Viewer equivalent)
  --publish        NDJSON TCP pub/sub of os2_pose/os2_pointcloud/os2_gm
                   (prints the port; the reference publishes these over ROS)
  --save-map <f>   save the map checkpoint at shutdown (Map.mapfile)
  --metrics <f>    dump per-frame metrics NDJSON (state, matches, inliers,
                   ms per stage — io/metrics.py schema)
  --profile <dir>  capture a jax.profiler trace over the run
"""

import os
import sys
import time

# allow running as `python examples/run_slam.py` from the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _setup_outputs(sys_):
    """Optional viewer + publisher from CLI flags."""
    viewer, spub, tcp = None, None, None
    if "--viz" in sys.argv:
        from orb_slam2_2021_tpu.viz.viewer import Viewer

        out_dir = sys.argv[sys.argv.index("--viz") + 1]
        viewer = Viewer(sys_, out_dir=out_dir, stride=5)
    if "--publish" in sys.argv:
        from orb_slam2_2021_tpu.io.pubsub import (
            MessageBus, SystemPublisher, TcpPublisher,
            TOPIC_POSE, TOPIC_POINTCLOUD, TOPIC_GRID, TOPIC_GRID_POSE, TOPIC_METRICS,
        )

        bus = MessageBus()
        spub = SystemPublisher(sys_, bus)
        tcp = TcpPublisher(bus, [TOPIC_POSE, TOPIC_POINTCLOUD, TOPIC_GRID,
                                 TOPIC_GRID_POSE, TOPIC_METRICS])
        print(f"publishing NDJSON on 127.0.0.1:{tcp.port}")
    return viewer, spub, tcp


def _per_frame_outputs(viewer, spub, image, ts, i):
    if viewer is not None:
        viewer.update(image)
    if spub is not None:
        spub.publish_frame(ts)
        if i % 10 == 0:
            spub.publish_map(ts)


def _flag_value(name):
    return sys.argv[sys.argv.index(name) + 1] if name in sys.argv else None


class Pacer:
    """Real-time pacing to the dataset timestamp schedule — the reference
    driver sleeps until each frame's capture time and a real camera would
    drop frames the engine is late for (arducam_images.cpp:165-172)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.t0 = None
        self.ts0 = None
        self.late = 0
        self.total = 0
        self.max_late_s = 0.0

    def wait(self, ts: float):
        if not self.enabled:
            return
        now = time.perf_counter()
        if self.t0 is None:
            self.t0, self.ts0 = now, ts
            return
        due = self.t0 + (ts - self.ts0)
        self.total += 1
        if now < due:
            time.sleep(due - now)
        else:
            self.late += 1
            self.max_late_s = max(self.max_late_s, now - due)

    def report(self):
        if self.enabled and self.total:
            print(f"pacing: late on {self.late}/{self.total} frames "
                  f"(max {1e3*self.max_late_s:.0f} ms behind schedule)")


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "synthetic"
    profile_dir = _flag_value("--profile")

    from orb_slam2_2021_tpu.config import (
        kitti_stereo_config, synthetic_config, tum_rgbd_config,
    )
    from orb_slam2_2021_tpu.pipeline.system import System
    from orb_slam2_2021_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if mode == "synthetic":
        from orb_slam2_2021_tpu.io.synthetic import (
            SyntheticStereoWorld, forward_trajectory,
        )
        from orb_slam2_2021_tpu.io.trajectory import ate_rmse

        n = int(sys.argv[2]) if len(sys.argv) > 2 else 60
        cfg = synthetic_config(width=320, height=240)
        world = SyntheticStereoWorld(cfg, seed=3)
        gt = forward_trajectory(n, step=0.12)
        sys_ = System(cfg, profile_dir=profile_dir,
                      async_mode="--async" in sys.argv)
        viewer, spub, tcp = _setup_outputs(sys_)
        pacer = Pacer("--pace" in sys.argv)
        for i, (R, t) in enumerate(gt):
            left, right = world.render(R, t)
            pacer.wait(i * 0.1)
            pose = sys_.track_stereo(left, right, timestamp=i * 0.1)
            _per_frame_outputs(viewer, spub, left, i * 0.1, i)
            state = sys_.tracker.state.name
            print(f"frame {i:04d}: {state} inliers={sys_.tracker.n_inliers_last} "
                  f"kf={sys_.map.n_kf}")
        sys_.shutdown()
        est = sys_.trajectory_kitti()
        gt_mats = []
        for R, t in gt[: len(est)]:
            T = np.eye(4); T[:3, :3] = R; T[:3, 3] = t
            gt_mats.append(T)
        print("ATE RMSE:", ate_rmse(est, gt_mats))
    elif mode == "kitti":
        from orb_slam2_2021_tpu.io.datasets import KittiStereoSequence

        seq = KittiStereoSequence(
            sys.argv[2], max_frames=500 if "--reduced" in sys.argv else None
        )
        cfg = kitti_stereo_config()
        sys_ = System(cfg, profile_dir=profile_dir,
                      async_mode="--async" in sys.argv)
        viewer, spub, tcp = _setup_outputs(sys_)
        pacer = Pacer("--pace" in sys.argv)
        for i, (ts, left, right) in enumerate(seq):
            pacer.wait(ts)
            sys_.track_stereo(left, right, timestamp=ts)
            _per_frame_outputs(viewer, spub, left, ts, i)
        sys_.shutdown()
    elif mode == "tum":
        from orb_slam2_2021_tpu.io.datasets import TumRgbdSequence

        # raw (unscaled) depth: System applies DepthMapFactor itself
        seq = TumRgbdSequence(sys.argv[2], depth_scale=1.0)
        # pick the freiburg calibration from the sequence path (TUM publishes
        # per-camera intrinsics; freiburg1/2 need keypoint undistortion)
        preset = "freiburg3"
        for p in ("freiburg1", "freiburg2", "freiburg3"):
            if p in sys.argv[2]:
                preset = p
        cfg = tum_rgbd_config(preset)
        sys_ = System(cfg, profile_dir=profile_dir,
                      async_mode="--async" in sys.argv)
        pacer = Pacer("--pace" in sys.argv)
        for ts, rgb, depth in seq:
            pacer.wait(ts)
            sys_.track_rgbd(rgb, depth, timestamp=ts)
        sys_.shutdown()
    else:
        raise SystemExit(__doc__)

    stats = sys_.timing_stats()
    if 'pacer' in dir():
        pacer.report()
    print(f"median tracking time: {stats['median_s']:.4f} s")
    print(f"mean tracking time:   {stats['mean_s']:.4f} s")
    sys_.save_trajectory_kitti("trajectory_kitti.txt")
    sys_.save_trajectory_tum("trajectory_tum.txt")
    print("saved trajectory_kitti.txt / trajectory_tum.txt")
    mpath = _flag_value("--metrics")
    if mpath:
        n = sys_.save_metrics_ndjson(mpath)
        print(f"wrote {n} metrics records to {mpath}")
    if "--save-map" in sys.argv:
        path = sys.argv[sys.argv.index("--save-map") + 1]
        sys_.save_map(path)
        print(f"saved map checkpoint to {path}")


if __name__ == "__main__":
    main()
