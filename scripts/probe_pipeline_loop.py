import time, numpy as np, jax, jax.numpy as jnp, sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from orb_slam2_2021_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
from orb_slam2_2021_tpu.config import kitti_stereo_config
from orb_slam2_2021_tpu.frontend.frame import build_stereo_frame
from orb_slam2_2021_tpu.pipeline.track_steps import make_fused_track_packed_fn
from orb_slam2_2021_tpu.geometry.camera import PinholeCamera

cfg = kitti_stereo_config()
cam = PinholeCamera.create(cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.bf, cfg.width, cfg.height)
frame_fn = jax.jit(lambda u8: build_stereo_frame(
    u8[0].astype(jnp.float32), u8[1].astype(jnp.float32), cfg=cfg))
fused_fn = make_fused_track_packed_fn(cfg)
rng = np.random.default_rng(0)
n = cfg.orb.n_features; P = cfg.tracking.local_points_cap
pack = np.zeros(5 * n + 16, np.float32)
geom = jnp.asarray(rng.uniform(-5, 5, (P, 8)).astype(np.float32))
desc = jnp.asarray(rng.integers(0, 2 ** 32, (P, 8), dtype=np.uint32))
valid = jnp.ones(P, bool)
pack_d = jnp.asarray(pack)
imgs = [rng.integers(0, 255, (2, 376, 1241), dtype=np.uint8) for _ in range(8)]

print("compiling frame_fn...", flush=True)
t0 = time.perf_counter()
f = frame_fn(jnp.asarray(imgs[0]))
jax.block_until_ready(f)
print(f"  frame_fn compile+run {time.perf_counter()-t0:.1f}s", flush=True)

def chain(i):
    f = frame_fn(jnp.asarray(imgs[i % 8]))
    return fused_fn(cam, f.kp, f.u_right, f.depth, f.kp.desc, f.kp.octave,
                    f.kp.angle, f.kp.valid, pack_d, geom, desc, valid)

print("warm fused...", flush=True)
t0 = time.perf_counter()
out = chain(0); jax.block_until_ready(out)
print(f"  fused warm {time.perf_counter()-t0:.1f}s", flush=True)

prev = chain(0); prev.copy_to_host_async()
chain(1)
ts = []
for i in range(2, 22):
    t0 = time.perf_counter()
    out = chain(i)
    out.copy_to_host_async()
    o_prev = np.asarray(prev)
    prev = out
    dt = time.perf_counter() - t0
    ts.append(dt)
    print(f"  frame {i}: {1e3*dt:7.1f} ms", flush=True)
ts = np.array(ts[4:]) * 1e3
print(f"pipelined u8 full-out: median {np.median(ts):.1f} ms/frame "
      f"(mean {ts.mean():.1f}, min {ts.min():.1f}, max {ts.max():.1f})")
