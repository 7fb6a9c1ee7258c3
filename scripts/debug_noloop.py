"""Measure the orbit run WITHOUT loop closing: aligned + unaligned ATE in
the SLAM frame (gauge pinned at frame 0), to calibrate the loop-improvement
assertion in tests/test_loop.py."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
from orb_slam2_2021_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

from orb_slam2_2021_tpu.config import synthetic_config
from orb_slam2_2021_tpu.io.synthetic import SyntheticCylinderWorld, orbit_trajectory
from orb_slam2_2021_tpu.io.trajectory import ate_rmse
from orb_slam2_2021_tpu.pipeline.system import System


def run(enable_loop):
    cfg = synthetic_config(width=320, height=240)
    world = SyntheticCylinderWorld(cfg, seed=3)
    gt = orbit_trajectory(128, total_deg=560.0, r_orbit=1.5)
    sys_ = System(cfg, enable_loop_closing=enable_loop)
    for i, (R_wc, t_wc) in enumerate(gt):
        left, right = world.render(R_wc, t_wc)
        sys_.track_stereo(left, right, timestamp=i * 0.1)
    sys_.shutdown()
    est = sys_.trajectory_kitti()
    T0 = np.eye(4)
    T0[:3, :3] = gt[0][0]
    T0[:3, 3] = gt[0][1]
    gt_slam = []
    for R_wc, t_wc in gt[: len(est)]:
        T = np.eye(4)
        T[:3, :3] = R_wc
        T[:3, 3] = t_wc
        gt_slam.append(np.linalg.inv(T0) @ T)
    a = ate_rmse(est, gt_slam)
    u = ate_rmse(est, gt_slam, align=False)
    n_loops = sys_.loop_closer.n_loops if sys_.loop_closer else 0
    print(f"loop={enable_loop}: aligned {a:.4f}  unaligned {u:.4f}  "
          f"n_loops={n_loops}", flush=True)


if __name__ == "__main__":
    run(enable_loop=False)
    run(enable_loop=True)
