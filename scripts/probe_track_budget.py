"""Microbench the tracking-lane device programs on the current platform:
stereo frame assembly, the packed fused track step, and transfer costs."""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np


def bench(label, fn, *args, iters=20, block=lambda o: o):
    out = fn(*args)
    block(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    block(out)
    dt = (time.perf_counter() - t0) / iters
    print(f"{label:40s} {1e3*dt:8.2f} ms")
    return out


def main():
    import jax
    from orb_slam2_2021_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from orb_slam2_2021_tpu.config import kitti_stereo_config
    from orb_slam2_2021_tpu.frontend.frame import make_stereo_frame_fn
    from orb_slam2_2021_tpu.geometry.camera import PinholeCamera
    from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld
    from orb_slam2_2021_tpu.pipeline.track_steps import (
        make_frame_pack_fn, make_fused_track_packed_fn,
    )

    cfg = kitti_stereo_config()
    cam = PinholeCamera.create(cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.bf,
                               cfg.width, cfg.height)
    world = SyntheticStereoWorld(cfg, seed=7)
    left, right = world.render(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))

    frame_fn = make_stereo_frame_fn(cfg)
    pack_fn = make_frame_pack_fn(cfg)
    fused_fn = make_fused_track_packed_fn(cfg)

    blk = jax.block_until_ready
    print("platform:", jax.devices()[0].platform)

    # 1. host->device image upload
    bench("upload 2 images", lambda: (jnp.asarray(left), jnp.asarray(right)),
          block=blk)
    l_d, r_d = jnp.asarray(left), jnp.asarray(right)

    # 2. stereo frame assembly (extraction both eyes + stereo match)
    frame = bench("stereo frame fn (device)", lambda: frame_fn(l_d, r_d),
                  block=lambda f: blk(f.kp.xy))

    # 3. frame pack pull
    bench("frame pack + pull", lambda: tuple(np.asarray(x) for x in
          pack_fn(frame.kp, frame.u_right, frame.depth)))

    # 4. fused track step
    n = cfg.orb.n_features
    P = cfg.tracking.local_points_cap
    rng = np.random.default_rng(0)
    pack = np.zeros(5 * n + 16, np.float32)
    pack[: 4 * n] = rng.uniform(-5, 5, 4 * n)
    pack[5 * n + 12] = 7.0
    pack[5 * n + 13] = 40.0
    pack[5 * n + 14] = 20.0
    geom = jnp.asarray(rng.uniform(-5, 5, (P, 8)).astype(np.float32))
    desc = jnp.asarray(rng.integers(0, 2**32, (P, 8), dtype=np.uint32))
    valid = jnp.ones(P, bool)
    lf_desc = frame.kp.desc
    pack_d = jnp.asarray(pack)

    def fused():
        return fused_fn(cam, frame.kp, frame.u_right, frame.depth,
                        lf_desc, frame.kp.octave, frame.kp.angle, frame.kp.valid,
                        pack_d, geom, desc, valid)
    bench("fused track step (device only)", fused, block=blk)

    # 5. fused + upload + pull (what _track_fused actually pays)
    def fused_full():
        return np.asarray(fused_fn(
            cam, frame.kp, frame.u_right, frame.depth,
            lf_desc, frame.kp.octave, frame.kp.angle, frame.kp.valid,
            jnp.asarray(pack), geom, desc, valid))
    bench("fused + upload pack + pull", fused_full)

    # 6. whole frame chain as the pipeline runs it
    def chain():
        l, r = jnp.asarray(left), jnp.asarray(right)
        f = frame_fn(l, r)
        host = tuple(np.asarray(x) for x in pack_fn(f.kp, f.u_right, f.depth))
        out = np.asarray(fused_fn(
            cam, f.kp, f.u_right, f.depth,
            lf_desc, f.kp.octave, f.kp.angle, f.kp.valid,
            jnp.asarray(pack), geom, desc, valid))
        return out
    bench("frame chain (upload+extract+pack+fused)", chain, iters=10)


if __name__ == "__main__":
    main()
