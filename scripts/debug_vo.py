"""Per-frame diagnosis of the localization-mode VO drift
(tests/test_tracking_modes.py::test_localization_mode_vo_points red at
0.75 m vs 0.6 bound, VERDICT r3 Weak #5).

Replicates the test scenario and prints, for every VO frame: estimated step
length vs ground truth (0.12 m), inlier count, VO-point count, and the
depth statistics of the spawned temporal points — hunting for a systematic
bias rather than random drift."""

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
from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld, forward_trajectory
from orb_slam2_2021_tpu.pipeline.system import System


def main():
    cfg = synthetic_config(width=320, height=240)
    world = SyntheticStereoWorld(cfg, seed=3)
    gt = list(forward_trajectory(52, step=0.12))

    sys_ = System(cfg)
    if os.environ.get("VO_F32") == "1":
        # A/B: bypass the uint8 upload quantization (1310d5f) — feed the
        # renderer's continuous f32 images through the f32 frame path
        import jax.numpy as jnp

        def track_f32(l, r, timestamp):
            sys_._pre_frame()
            import time as _t
            frame = sys_._frame_fn(jnp.asarray(l, jnp.float32),
                                   jnp.asarray(r, jnp.float32))
            with sys_.map.lock:
                pose = sys_.tracker.track_stereo_frame(
                    frame, sys_._frame_id, timestamp)
            sys_._post_track()
            sys_.tracker._set_metrics(sys_._frame_id, timestamp, False)
            sys_._frame_id += 1
            return pose

        sys_.track_stereo = track_f32
    for i, (R, t) in enumerate(gt[:28]):
        left, right = world.render(R, t)
        sys_.track_stereo(left, right, timestamp=i * 0.1)
    print(f"setup: KFs={sys_.map.n_kf} state={sys_.tracker.state}")

    sys_.activate_localization_mode()
    live = np.nonzero(sys_.map.mp_valid)[0]
    True_valid = sys_.map.mp_valid.copy()
    sys_.map.mp_valid[live[8:]] = False

    tr = sys_.tracker
    prev_c = None
    for j, (R, t) in enumerate(gt[28:44]):
        i = 28 + j
        left, right = world.render(R, t)
        pose = sys_.track_stereo(left, right, timestamp=i * 0.1)
        if pose is None:
            print(f"f{i}: LOST")
            prev_c = None
            continue
        Rcw, tcw = pose
        c = -Rcw.T @ tcw
        step = np.linalg.norm(c - prev_c) if prev_c is not None else float("nan")
        prev_c = c.copy()
        lf = tr.last_frame_data
        n_vo = int((lf["mp"] == tr.VO_ID).sum()) if lf is not None else -1
        err = np.linalg.norm(c - np.asarray(gt[i][1]))
        R_wc_est = Rcw.T
        dRm = R_wc_est @ np.asarray(gt[i][0]).T
        ang = np.degrees(np.arccos(np.clip((np.trace(dRm) - 1) / 2, -1, 1)))
        yaw = np.degrees(np.arctan2(R_wc_est[0, 2], R_wc_est[2, 2]))
        print(f"f{i}: step {step:.4f} (gt 0.1200)  rot_err {ang:.3f}deg "
              f"yaw {yaw:+.3f}  vo_mode={tr.vo_mode}  pos_err {err:.3f}")
    # depth sanity of the final frame's spawnable points
    lf = tr.last_frame_data
    d = lf["depth"]
    v = lf["kp_valid"] & (d > 0)
    print(f"depth: n={v.sum()} median={np.median(d[v]):.2f} "
          f"th={cfg.resolved_depth_th():.2f}")

    # recovery phase: map restored, reloc should snap the drift away
    sys_.map.mp_valid[:] = True_valid
    print("--- map restored ---")
    for j, (R, t) in enumerate(gt[44:]):
        i = 44 + j
        left, right = world.render(R, t)
        pose = sys_.track_stereo(left, right, timestamp=i * 0.1)
        if pose is None:
            print(f"f{i}: LOST  vo_mode={tr.vo_mode}")
            continue
        Rcw, tcw = pose
        c = -Rcw.T @ tcw
        err = np.linalg.norm(c - np.asarray(gt[i][1]))
        print(f"f{i}: pos_err {err:.3f}  vo_mode={tr.vo_mode} "
              f"reloc_at={tr.last_reloc_frame_id}")
    sys_.shutdown()


if __name__ == "__main__":
    main()
