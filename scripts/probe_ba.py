"""Isolated local-BA solve timing on the current platform: warm-cache
dispatch+pull per bucket shape."""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
from orb_slam2_2021_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import jax.numpy as jnp

from orb_slam2_2021_tpu.config import kitti_stereo_config
from orb_slam2_2021_tpu.geometry.camera import PinholeCamera
from orb_slam2_2021_tpu.optim.ba import BAProblem
from orb_slam2_2021_tpu.optim.ba_cg import make_local_ba_cg_pq

cfg = kitti_stereo_config()
cam = PinholeCamera.create(cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.bf, cfg.width, cfg.height)
ba_fn = make_local_ba_cg_pq(cfg.optim)
rng = np.random.default_rng(0)

def make_prob(C, P, Q):
    O = P * Q
    xw = rng.uniform(-10, 10, (P, 3)).astype(np.float32) + np.array([0, 0, 20], np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    t = rng.uniform(-0.1, 0.1, (C, 3)).astype(np.float32)
    obs_pt = np.repeat(np.arange(P, dtype=np.int32), Q)
    obs_cam = rng.integers(0, C, P * Q).astype(np.int32)
    # project ground truth to build observations
    pc = xw[obs_pt] + t[obs_cam]
    u = cfg.fx * pc[:, 0] / pc[:, 2] + cfg.cx
    v = cfg.fy * pc[:, 1] / pc[:, 2] + cfg.cy
    ur = u - cfg.bf / pc[:, 2]
    uvr = np.stack([u, v, ur], 1).astype(np.float32)
    prob = BAProblem(
        R=jnp.asarray(R), t=jnp.asarray(t), xw=jnp.asarray(xw),
        cam_free=jnp.asarray(np.arange(C) > 0),
        obs_cam=jnp.asarray(obs_cam), obs_pt=jnp.asarray(obs_pt),
        obs_uvr=jnp.asarray(uvr),
        obs_inv_sigma2=jnp.ones(P * Q, jnp.float32),
        obs_valid=jnp.asarray(rng.uniform(size=P * Q) < 0.4),
        pt_obs=None,
    )
    return prob

for (C, P, Q) in [(128, 2048, 8), (128, 4096, 16)]:
    prob = make_prob(C, P, Q)
    t0 = time.perf_counter()
    out = ba_fn(cam, prob)
    jax.block_until_ready(out)
    print(f"C={C} P={P} Q={Q}: first call (compile/load) {time.perf_counter()-t0:.2f}s", flush=True)
    ts_d, ts_p = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        out = ba_fn(cam, prob)
        t1 = time.perf_counter()
        res = jax.device_get(out)
        t2 = time.perf_counter()
        ts_d.append(t1 - t0); ts_p.append(t2 - t1)
    print(f"  warm: dispatch {1e3*np.median(ts_d):7.1f} ms   pull(+exec) {1e3*np.median(ts_p):7.1f} ms")
