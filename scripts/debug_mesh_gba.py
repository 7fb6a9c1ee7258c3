"""Quantify the sharded-GBA quality question (test_pipeline_mesh red at
ATE 0.167 vs 0.163 bound): same map, ATE before GBA / after single-device
GBA / after mesh-sharded GBA."""

import copy
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
from orb_slam2_2021_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np
from jax.sharding import Mesh

from orb_slam2_2021_tpu.config import synthetic_config
from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld, forward_trajectory
from orb_slam2_2021_tpu.io.trajectory import ate_rmse
from orb_slam2_2021_tpu.parallel.dist_ba import AXIS
from orb_slam2_2021_tpu.pipeline.system import System


def ate_of(sys_, gt):
    est = sys_.trajectory_kitti()
    gt_mats = []
    for R, t in gt[: len(est)]:
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        gt_mats.append(T)
    return float(ate_rmse(est, gt_mats))


def snapshot(m):
    return (m.kf_R.copy(), m.kf_t.copy(), m.mp_pos.copy())


def restore(m, snap):
    m.kf_R[:], m.kf_t[:], m.mp_pos[:] = snap


def main():
    mesh = Mesh(np.array(jax.devices()[:8]), (AXIS,))
    cfg = synthetic_config(width=320, height=240)
    world = SyntheticStereoWorld(cfg, seed=11)
    gt = forward_trajectory(24, step=0.14)
    sys_ = System(cfg, mesh=mesh)
    for i, (R, t) in enumerate(gt):
        left, right = world.render(R, t)
        sys_.track_stereo(left, right, timestamp=i * 0.1)

    lc = sys_.loop_closer
    print(f"before GBA: ATE {ate_of(sys_, gt):.4f}")
    snap = snapshot(sys_.map)

    lc.mesh = None
    lc._run_global_ba(idx=lc.full_ba_idx)
    print(f"single-dev GBA: ATE {ate_of(sys_, gt):.4f}")

    restore(sys_.map, snap)
    lc.mesh = mesh
    lc._dist_step = None
    lc._run_global_ba(idx=lc.full_ba_idx)
    print(f"sharded GBA:    ATE {ate_of(sys_, gt):.4f}")
    sys_.shutdown()


if __name__ == "__main__":
    main()
