"""Stage-level decomposition of the stereo frame build on the device."""

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
    from orb_slam2_2021_tpu.frontend import features as F
    from orb_slam2_2021_tpu.frontend.frame import stereo_match, make_stereo_frame_u8_fn
    from orb_slam2_2021_tpu.ops.fast import fast_detect_batched
    from orb_slam2_2021_tpu.ops.image import gaussian_blur_batched, pyramid_shapes
    from orb_slam2_2021_tpu.ops.select import select_keypoints_batched
    from orb_slam2_2021_tpu.ops.brief import brief_from_patches
    from orb_slam2_2021_tpu.ops.orientation import (HALF_PATCH, PATCH,
                                                    angles_from_patches)
    from orb_slam2_2021_tpu.utils.timing import time_device

    cfg = kitti_stereo_config()
    ocfg = cfg.orb
    rng = np.random.default_rng(0)
    imgs = jnp.asarray(rng.uniform(0, 255, (2, cfg.height, cfg.width)),
                       jnp.float32)

    pyr = jax.jit(lambda x: F.build_pyramid_stack(x, ocfg)[0])
    raw_stack = pyr(imgs)
    print(f"pyramid stack shape {raw_stack.shape}")
    dt = time_device(lambda: pyr(imgs), n=8)
    print(f"build_pyramid_stack:    {1e3*dt:7.2f} ms")

    _, ext_h, ext_w = F.build_pyramid_stack(imgs, ocfg)
    B, L, Hc, Wc = raw_stack.shape
    ext_h_t = jnp.asarray(np.tile(ext_h, B))
    ext_w_t = jnp.asarray(np.tile(ext_w, B))
    flat = raw_stack.reshape(B * L, Hc, Wc)
    fd = jax.jit(lambda f: fast_detect_batched(
        f, float(ocfg.ini_fast_th), float(ocfg.min_fast_th),
        ocfg.edge_threshold, ext_h_t, ext_w_t))
    strict, relaxed = fd(flat)
    dt = time_device(lambda: fd(flat)[0], n=8)
    print(f"fast_detect_batched:    {1e3*dt:7.2f} ms")

    counts = F.level_feature_counts(ocfg.n_features, L, ocfg.scale_factor)
    n_top = max(counts)
    sel = jax.jit(lambda s, r: select_keypoints_batched(s, r, n_top, ocfg.cell_size))
    ys, xs, resp, valid = sel(strict, relaxed)
    dt = time_device(lambda: sel(strict, relaxed)[0], n=8)
    print(f"select_keypoints:       {1e3*dt:7.2f} ms")

    gb = jax.jit(gaussian_blur_batched)
    blur = gb(raw_stack)
    dt = time_device(lambda: gb(raw_stack), n=8)
    print(f"gaussian_blur_batched:  {1e3*dt:7.2f} ms")

    # patch gather + angle + brief on realistic keypoint tensors
    N = ocfg.n_features
    oct_ = jnp.asarray(rng.integers(0, L, (B, N)), jnp.int32)
    y0 = jnp.asarray(rng.integers(0, 300, (B, N)), jnp.int32)
    x0 = jnp.asarray(rng.integers(0, 1100, (B, N)), jnp.int32)

    def gather(blur_stack, octave, y0_, x0_):
        def eye(stack_b, oct_b, yb, xb):
            img2d = stack_b.reshape(L * Hc, Wc)

            def one(o, y, x):
                return jax.lax.dynamic_slice(img2d, (o * Hc + y, x), (PATCH, PATCH))

            return jax.vmap(one)(oct_b, yb, xb)

        return jax.vmap(eye)(blur_stack, octave, y0_, x0_).reshape(B, -1, PATCH * PATCH)

    gf = jax.jit(gather)
    patches = gf(blur, oct_, y0, x0)
    dt = time_device(lambda: gf(blur, oct_, y0, x0), n=8)
    print(f"patch_gather [2,{N}]:   {1e3*dt:7.2f} ms")

    af = jax.jit(angles_from_patches)
    ang = af(patches)
    dt = time_device(lambda: af(patches), n=8)
    print(f"angles_from_patches:    {1e3*dt:7.2f} ms")

    bf = jax.jit(brief_from_patches)
    dt = time_device(lambda: bf(patches, ang), n=8)
    print(f"brief_from_patches:     {1e3*dt:7.2f} ms")

    # full build for reference
    u8fn = make_stereo_frame_u8_fn(cfg)
    u8 = jnp.asarray(rng.integers(0, 255, (2, cfg.height, cfg.width), dtype=np.uint8))
    dt = time_device(lambda: u8fn(u8).kp.desc, n=8)
    print(f"FULL build_stereo:      {1e3*dt:7.2f} ms")


if __name__ == "__main__":
    main()
