"""Per-kernel device timings (utils/timing.time_device) for the programs
that make up the tracking lane and the per-KF mapping pass — the
decomposition that tells us which kernel to attack for speed-of-light work."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from orb_slam2_2021_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from orb_slam2_2021_tpu.config import kitti_stereo_config
    from orb_slam2_2021_tpu.frontend.frame import make_stereo_frame_u8_fn
    from orb_slam2_2021_tpu.geometry.camera import PinholeCamera
    from orb_slam2_2021_tpu.optim.pose import PoseObs, make_pose_optimizer
    from orb_slam2_2021_tpu.ops.hamming import hamming_matrix
    from orb_slam2_2021_tpu.utils.timing import time_device

    cfg = kitti_stereo_config()
    cam = PinholeCamera.create(cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.bf,
                               cfg.width, cfg.height)
    rng = np.random.default_rng(0)
    n = cfg.orb.n_features
    P = cfg.tracking.local_points_cap

    # frame build (u8 stacked)
    img = rng.integers(0, 255, (2, cfg.height, cfg.width), dtype=np.uint8)
    u8fn = make_stereo_frame_u8_fn(cfg)
    stacked = jnp.asarray(img)
    dt = time_device(lambda: u8fn(stacked).kp.desc, n=8)
    print(f"frame_build_u8:        {1e3*dt:7.2f} ms")

    # hamming N x N and N x P
    a = jnp.asarray(rng.integers(0, 2**32, (n, 8), dtype=np.uint32))
    b = jnp.asarray(rng.integers(0, 2**32, (P, 8), dtype=np.uint32))
    hm = jax.jit(hamming_matrix)
    dt = time_device(lambda: hm(a, a), n=10)
    print(f"hamming {n}x{n}:     {1e3*dt:7.2f} ms")
    dt = time_device(lambda: hm(a, b), n=10)
    print(f"hamming {n}x{P}:     {1e3*dt:7.2f} ms")

    # pose_optimize alone (4 x 10 LM, N obs)
    xw = rng.uniform(-10, 10, (n, 3)).astype(np.float32) + [0, 0, 15]
    z = xw[:, 2]
    u = cfg.fx * xw[:, 0] / z + cfg.cx
    v = cfg.fy * xw[:, 1] / z + cfg.cy
    uvr = np.stack([u, v, u - cfg.bf / z], 1).astype(np.float32)
    obs = PoseObs(
        xw=jnp.asarray(xw), uvr=jnp.asarray(uvr),
        inv_sigma2=jnp.ones(n, jnp.float32),
        valid=jnp.ones(n, bool),
    )
    po = make_pose_optimizer(cfg.optim)
    R0, t0 = jnp.eye(3), jnp.zeros(3)
    dt = time_device(lambda: po(cam, R0, t0, obs)[0], n=10)
    print(f"pose_optimize 4x10:    {1e3*dt:7.2f} ms   (x2 per fused frame)")

    # full fused tracking step
    from orb_slam2_2021_tpu.pipeline.track_steps import make_fused_track_packed_fn

    fused = make_fused_track_packed_fn(cfg)
    frame = u8fn(stacked)
    pack = np.zeros(5 * n + 16, np.float32)
    pack[: 4 * n].reshape(n, 4)[:, :3] = xw
    pack[: 4 * n].reshape(n, 4)[:, 3] = 1.0
    pack[4 * n: 5 * n] = np.arange(n, dtype=np.int32).view(np.float32)
    pack[5 * n: 5 * n + 9] = np.eye(3, dtype=np.float32).reshape(-1)
    pack[5 * n + 12] = 7.0
    pack[5 * n + 13] = 10.0
    pack[5 * n + 14] = 20.0
    snap_geom = jnp.asarray(
        np.concatenate([rng.uniform(-10, 10, (P, 3)).astype(np.float32) + [0, 0, 15],
                        np.tile([0, 0, -1.0], (P, 1)).astype(np.float32),
                        np.full((P, 1), 0.5, np.float32),
                        np.full((P, 1), 40.0, np.float32)], axis=1))
    snap_desc = jnp.asarray(rng.integers(0, 2**32, (P, 8), dtype=np.uint32))
    snap_valid = jnp.ones(P, bool)
    packd = jnp.asarray(pack)
    dt = time_device(lambda: fused(
        cam, frame.kp, frame.u_right, frame.depth,
        frame.kp.desc, frame.kp.octave, frame.kp.angle, frame.kp.valid,
        packd, snap_geom, snap_desc, snap_valid), n=8)
    print(f"fused_track_step:      {1e3*dt:7.2f} ms")

    # vocabulary transform (BoW descent)
    from orb_slam2_2021_tpu.place.bundle import PlaceRecognition

    pr = PlaceRecognition.load_default()
    if pr is not None:
        dt = time_device(lambda: pr.transform(frame.kp.desc, frame.kp.valid), n=8)
        print(f"vocab_transform:       {1e3*dt:7.2f} ms")


if __name__ == "__main__":
    main()
