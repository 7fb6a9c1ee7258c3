"""Train the packaged 10^5-word ORB vocabulary (k=10, L=5) on a DIVERSE corpus.

The r02 vocabulary (k=10, L=4 = 10^4 words) was trained on 24 seeds of one
procedural texture family — in-distribution with the tests it serves
(VERDICT r2 missing #4). This trainer widens the corpus along every axis we
can generate without real-image egress:

- texture families: smooth value-noise (SyntheticStereoWorld), cylinder-wrap
  value-noise (SyntheticCylinderWorld), plus three structurally different
  generators rendered into the same worlds via texture injection: hard-edged
  Voronoi cells, multi-octave turbulence, and random box/glyph collages;
- geometry: flat walls, depth-bump walls, cylinders of varying radius;
- photometrics: gamma 0.5/1/2, additive Gaussian noise, contrast stretch,
  horizontal flips;
- viewpoints: forward tracks and orbit arcs.

The shipped ORBvoc is 10^6 words trained on real video (KeyFrame.cc:64-66);
10^5 is the largest tree that keeps the packaged artifact small (~3 MB
compressed) while giving ~10x the discriminative capacity of r02's tree.

Usage: PYTHONPATH=/root/repo python scripts/train_vocab_l5.py [target_descs]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
from orb_slam2_2021_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np
import jax.numpy as jnp

from orb_slam2_2021_tpu.config import synthetic_config, OrbConfig
from orb_slam2_2021_tpu.io.synthetic import (
    SyntheticCylinderWorld,
    SyntheticStereoWorld,
    forward_trajectory,
    orbit_trajectory,
)
from orb_slam2_2021_tpu.frontend.features import make_extract_fn
from orb_slam2_2021_tpu.place.vocab import train_vocabulary


# ---------------------------------------------------------------------------
# alternative texture generators (structurally different from the smooth
# value-noise the worlds ship with)
# ---------------------------------------------------------------------------
def voronoi_texture(rng, h, w, n_sites=220):
    """Hard-edged random cells — step edges + corners at all orientations."""
    sy = rng.uniform(0, h, n_sites)
    sx = rng.uniform(0, w, n_sites)
    sv = rng.uniform(30, 225, n_sites).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    best = np.full((h, w), np.inf, np.float32)
    out = np.zeros((h, w), np.float32)
    for i in range(n_sites):
        d = (ys - sy[i]) ** 2 + (xs - sx[i]) ** 2
        m = d < best
        best[m] = d[m]
        out[m] = sv[i]
    return out


def turbulence_texture(rng, h, w, octaves=5):
    """Multi-octave |noise| turbulence — fractal detail at every scale."""
    out = np.zeros((h, w), np.float32)
    amp = 1.0
    for o in range(octaves):
        gh, gw = 4 * 2 ** o + 1, 4 * 2 ** o + 1
        g = rng.standard_normal((gh, gw)).astype(np.float32)
        ys = np.linspace(0, gh - 1.001, h)
        xs = np.linspace(0, gw - 1.001, w)
        y0 = ys.astype(int)[:, None]
        x0 = xs.astype(int)[None, :]
        fy = (ys[:, None] - y0)
        fx = (xs[None, :] - x0)
        v = (g[y0, x0] * (1 - fy) * (1 - fx) + g[y0, x0 + 1] * (1 - fy) * fx
             + g[y0 + 1, x0] * fy * (1 - fx) + g[y0 + 1, x0 + 1] * fy * fx)
        out += np.abs(v) * amp
        amp *= 0.55
    out -= out.min()
    return 255.0 * out / max(out.max(), 1e-6)


def collage_texture(rng, h, w, n_boxes=420):
    """Random overlapping boxes/bars — man-made-scene statistics (axis-aligned
    edges, uniform regions, high-contrast corners)."""
    out = np.full((h, w), float(rng.uniform(60, 190)), np.float32)
    for _ in range(n_boxes):
        bw = int(rng.uniform(3, w // 6))
        bh = int(rng.uniform(3, h // 6))
        x = rng.integers(0, max(w - bw, 1))
        y = rng.integers(0, max(h - bh, 1))
        out[y : y + bh, x : x + bw] = rng.uniform(10, 245)
    return out


def augment(img, rng):
    """Photometric + mirror augmentations of a rendered view."""
    mode = rng.integers(0, 6)
    x = img.astype(np.float32)
    if mode == 1:
        x = 255.0 * (x / 255.0) ** 0.5
    elif mode == 2:
        x = 255.0 * (x / 255.0) ** 2.0
    elif mode == 3:
        x = np.clip(x + rng.normal(0, 8, x.shape), 0, 255)
    elif mode == 4:
        x = np.clip((x - 127.5) * 1.6 + 127.5, 0, 255)
    elif mode == 5:
        x = x[:, ::-1]
    return np.ascontiguousarray(x, np.float32)


def main():
    target = int(sys.argv[1]) if len(sys.argv) > 1 else 600_000
    cfg = synthetic_config(width=480, height=360).replace(
        orb=OrbConfig(n_features=1200, n_levels=4)
    )
    extract = make_extract_fn(cfg.orb)
    rng = np.random.default_rng(7)
    descs = []
    total = 0
    t0 = time.time()

    def harvest(img):
        nonlocal total
        kp = extract(jnp.asarray(img))
        d = np.asarray(kp.desc)[np.asarray(kp.valid)]
        descs.append(d)
        total += len(d)

    seed = 0
    tex_makers = [None, voronoi_texture, turbulence_texture, collage_texture]
    while total < target:
        fam = tex_makers[seed % len(tex_makers)]
        wrng = np.random.default_rng(1000 + seed)
        if seed % 2 == 0:
            world = SyntheticStereoWorld(cfg, seed=200 + seed)
            if fam is not None:
                th, tw = world.texture.shape
                world.texture = fam(wrng, th, tw).astype(np.float32)
            views = list(forward_trajectory(8, step=0.9))
        else:
            world = SyntheticCylinderWorld(
                cfg, seed=200 + seed, radius=float(wrng.uniform(5.0, 12.0))
            )
            if fam is not None:
                th, tw = world.texture.shape
                world.texture = fam(wrng, th, tw).astype(np.float32)
            views = orbit_trajectory(8, total_deg=float(wrng.uniform(30, 120)),
                                     r_orbit=float(wrng.uniform(0.5, 2.5)))
        for (R, t) in views:
            left, _ = world.render(R, t)
            harvest(augment(left, wrng))
        seed += 1
        if seed % 16 == 0:
            print(f"{seed} worlds, {total} descriptors, {time.time()-t0:.0f}s",
                  flush=True)

    corpus = np.concatenate(descs, axis=0)[:target]
    print(f"training k=10 L=5 on {len(corpus)} descriptors "
          f"({seed} worlds, 4 texture families)", flush=True)
    t1 = time.time()
    voc = train_vocabulary(corpus, k=10, L=5, seed=0)
    print(f"trained in {time.time()-t1:.0f}s", flush=True)
    out = "orb_slam2_2021_tpu/data/vocab_k10_L5.npz"
    voc.save(out)
    print("saved", out, flush=True)
    words = voc.transform_np(corpus[:50000])
    print("unique words in 50k sample:", len(np.unique(words)), flush=True)


if __name__ == "__main__":
    main()
