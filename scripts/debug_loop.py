"""Debug harness for the orbit loop-closure regression (VERDICT r3 item 1).

Runs the exact test_loop.py orbit scenario with loop closing enabled and logs,
at every stage of every loop event:
  - which KF matched which loop KF (frame ids, ground-truth arc positions)
  - the accepted Sim3 vs the ground-truth relative pose (scale / rot / trans)
  - keyframe-position RMSE vs ground truth BEFORE correction, after the
    covis-group remap+fusion, after the essential graph, and after global BA.

Ground-truth world == SLAM world here (frame 0 at identity), so raw positional
RMSE over keyframes is meaningful without alignment.
"""

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

from orb_slam2_2021_tpu.config import synthetic_config
from orb_slam2_2021_tpu.io.synthetic import SyntheticCylinderWorld, orbit_trajectory
from orb_slam2_2021_tpu.io.trajectory import ate_rmse
from orb_slam2_2021_tpu.pipeline.system import System
from orb_slam2_2021_tpu.pipeline.loop_closing import LoopClosing


def main():
    cfg = synthetic_config(width=320, height=240)
    world = SyntheticCylinderWorld(cfg, seed=3)
    gt = orbit_trajectory(128, total_deg=560.0, r_orbit=1.5)
    # SLAM world == first camera frame; express GT in that frame:
    # T_slam_i = T0^-1 * T_i (camera-to-world)
    R0 = np.asarray(gt[0][0], np.float64)
    t0 = np.asarray(gt[0][1], np.float64)
    gt_pos = {}
    gt_Tcw = {}
    for i, (R_wc, t_wc) in enumerate(gt):
        Rs = R0.T @ np.asarray(R_wc, np.float64)
        ts = R0.T @ (np.asarray(t_wc, np.float64) - t0)
        gt_pos[i] = ts
        gt_Tcw[i] = (Rs.T, -Rs.T @ ts)

    sys_ = System(cfg, enable_loop_closing=True)
    lc = sys_.loop_closer
    m = sys_.map

    def kf_rmse():
        kfs = np.nonzero(m.kf_valid)[0]
        errs = []
        for k in kfs:
            fid = int(m.kf_frame_id[k])
            if fid not in gt_pos:
                continue
            R, t = m.kf_R[k].astype(np.float64), m.kf_t[k].astype(np.float64)
            twc = -R.T @ t
            errs.append(np.linalg.norm(twc - gt_pos[fid]))
        return float(np.sqrt(np.mean(np.square(errs)))) if errs else float("nan")

    orig_compute = lc._compute_sim3
    orig_correct = lc._correct_loop
    orig_ess = lc._optimize_essential_graph
    orig_gba = lc._run_global_ba

    def compute_sim3(k, candidates):
        print(f"[compute_sim3] k={k} (frame {int(m.kf_frame_id[k])}) "
              f"candidates={[(int(c), int(m.kf_frame_id[c])) for c in candidates]}")
        res = orig_compute(k, candidates)
        if res is not None:
            loop_kf, scw, matched = res
            s, R, t = scw
            fid_k = int(m.kf_frame_id[k])
            fid_l = int(m.kf_frame_id[loop_kf])
            Rg, tg = gt_Tcw[fid_k]
            dR = R.astype(np.float64) @ Rg.T
            ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
            # camera centers: c = -R^T t / s for sim3 [sR|t]
            c_est = -(R.T @ t) / s
            c_gt = gt_pos[fid_k]
            print(f"[compute_sim3] ACCEPT loop_kf={loop_kf} (frame {fid_l}) "
                  f"scale={s:.4f} rot_err_deg={ang:.2f} "
                  f"center_err={np.linalg.norm(c_est - c_gt):.4f} "
                  f"n_proj_matches={int((matched >= 0).sum())}")
            # current (drifted) pose of k for comparison
            c_cur = -(m.kf_R[k].astype(np.float64).T @ m.kf_t[k].astype(np.float64))
            print(f"[compute_sim3] current center err "
                  f"{np.linalg.norm(c_cur - c_gt):.4f}; corrected moves it by "
                  f"{np.linalg.norm(c_est - c_cur):.4f}")
        else:
            print("[compute_sim3] no acceptance")
        return res

    def correct_loop(k, loop_kf, scw, matched):
        print(f"[correct] BEFORE rmse={kf_rmse():.4f}")
        orig_correct(k, loop_kf, scw, matched)
        print(f"[correct] AFTER-ALL rmse={kf_rmse():.4f}")

    def opt_ess(k, loop_kf, corrected, old_poses, moved_by=None):
        print(f"[essential] before (post group-remap+fusion) rmse={kf_rmse():.4f}")
        orig_ess(k, loop_kf, corrected, old_poses, moved_by)
        print(f"[essential] after rmse={kf_rmse():.4f}")

    def run_gba(idx):
        print(f"[gba] before rmse={kf_rmse():.4f}")
        orig_gba(idx)
        print(f"[gba] after rmse={kf_rmse():.4f}")

    lc._compute_sim3 = compute_sim3
    lc._correct_loop = correct_loop
    lc._optimize_essential_graph = opt_ess
    lc._run_global_ba = run_gba

    n_ok = 0
    frame_errs = []
    for i, (R_wc, t_wc) in enumerate(gt):
        left, right = world.render(R_wc, t_wc)
        pose = sys_.track_stereo(left, right, timestamp=i * 0.1)
        if pose is not None:
            n_ok += 1
            R, t = pose
            twc = -np.asarray(R, np.float64).T @ np.asarray(t, np.float64)
            frame_errs.append((i, float(np.linalg.norm(twc - gt_pos[i]))))
        else:
            frame_errs.append((i, float("nan")))
    sys_.shutdown()
    est = sys_.trajectory_kitti()
    gt_mats = []
    for R_wc, t_wc in gt[: len(est)]:
        T = np.eye(4)
        T[:3, :3] = R_wc
        T[:3, 3] = t_wc
        gt_mats.append(T)
    print("per-frame live pose err (m):")
    for i, e in frame_errs:
        if i % 4 == 0 or e > 1.0 or not np.isfinite(e):
            print(f"  f{i:3d}: {e:.3f}")
    print("per-KF raw position err at end:")
    kfs = np.nonzero(m.kf_valid)[0]
    for k in kfs:
        fid = int(m.kf_frame_id[k])
        R, t = m.kf_R[k].astype(np.float64), m.kf_t[k].astype(np.float64)
        twc = -R.T @ t
        print(f"  kf{int(k):3d} (f{fid:3d}): {np.linalg.norm(twc - gt_pos[fid]):.3f}")
    T0 = np.eye(4)
    T0[:3, :3] = R0
    T0[:3, 3] = t0
    gt_slam = [np.linalg.inv(T0) @ T for T in gt_mats]
    raw = [float(np.linalg.norm(T[:3, 3] - gt_slam[i][:3, 3]))
           for i, T in enumerate(est)]
    print("resolved trajectory err: first10=%s last10=%s max=%.3f" % (
        [f"{x:.2f}" for x in raw[:10]], [f"{x:.2f}" for x in raw[-10:]], max(raw)))
    print(f"tracked {n_ok}/{len(gt)}  n_loops={lc.n_loops}  "
          f"final ATE={ate_rmse(est, gt_mats):.4f}  final kf_rmse={kf_rmse():.4f}")


if __name__ == "__main__":
    main()
