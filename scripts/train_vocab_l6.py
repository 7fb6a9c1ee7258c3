"""Train the production 10^6-word ORB vocabulary (k=10, L=6).

Matches the scale of the vocabulary the reference ships (ORBvoc: k=10 L=6,
/root/reference/Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:241-259,
KeyFrame.cc:64-66). Corpus: every generator family of train_vocab_l5.py
(smooth value-noise, Voronoi cells, turbulence, box collages) PLUS two more
structurally distinct families (Gaussian blob fields, ridged multifractal),
across flat/bumpy/cylinder geometry, photometric + mirror augmentation, and
forward/orbit viewpoints. The curved-grating family is deliberately
EXCLUDED — it is the held-out generalization probe
(tests/test_place_novel_family.py and the bench's novel-texture scenario).

Two phases:
  harvest: render and extract ORB descriptors -> descriptor corpus at
           build/vocab_corpus_l6.npy
  train:   CPU numpy k-medians over the saved corpus (hours; run niced in
           the background) -> orb_slam2_2021_tpu/data/vocab_k10_L6.npz

Usage:
  python scripts/train_vocab_l6.py harvest [target_descs]
  nice python scripts/train_vocab_l6.py train
"""

import os
import sys
import time

_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_here))
sys.path.insert(0, _here)

import jax

MODE = sys.argv[1] if len(sys.argv) > 1 else "harvest"
if MODE == "train":
    # k-medians is pure numpy: stay off the accelerator
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

from train_vocab_l5 import (  # texture generators + augmentation (4 families)
    augment,
    collage_texture,
    turbulence_texture,
    voronoi_texture,
)

def blob_texture(rng, h, w, n_blobs=140):
    """Soft Gaussian blob field — smooth round features, no straight edges."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.full((h, w), 80.0, np.float32)
    for _ in range(n_blobs):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        s = rng.uniform(3, 18)
        a = rng.uniform(-120, 120)
        out += a * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * s * s))
    out -= out.min()
    return 255.0 * out / max(out.max(), 1e-6)


def ridged_texture(rng, h, w, octaves=5):
    """Ridged multifractal (1 - |noise|)^2 — sharp ridge lines at all
    orientations, unlike turbulence's soft creases."""
    out = np.zeros((h, w), np.float32)
    amp = 1.0
    for o in range(octaves):
        gh, gw = 3 * 2 ** o + 1, 3 * 2 ** o + 1
        g = rng.standard_normal((gh, gw)).astype(np.float32)
        ys = np.linspace(0, gh - 1.001, h)
        xs = np.linspace(0, gw - 1.001, w)
        y0 = ys.astype(int)[:, None]
        x0 = xs.astype(int)[None, :]
        fy = ys[:, None] - y0
        fx = xs[None, :] - x0
        v = (g[y0, x0] * (1 - fy) * (1 - fx) + g[y0, x0 + 1] * (1 - fy) * fx
             + g[y0 + 1, x0] * fy * (1 - fx) + g[y0 + 1, x0 + 1] * fy * fx)
        r = (1.0 - np.abs(np.tanh(v))) ** 2
        out += r * amp
        amp *= 0.5
    out -= out.min()
    return 255.0 * out / max(out.max(), 1e-6)


CORPUS = os.path.join(os.path.dirname(_here), "build", "vocab_corpus_l6.npy")


def _bilinear_resize(img, h, w):
    """Cheap numpy bilinear upscale (no cv2 in this image)."""
    ih, iw = img.shape
    ys = np.linspace(0, ih - 1.001, h)
    xs = np.linspace(0, iw - 1.001, w)
    y0 = ys.astype(int)[:, None]
    x0 = xs.astype(int)[None, :]
    fy = ys[:, None] - y0
    fx = xs[None, :] - x0
    return (img[y0, x0] * (1 - fy) * (1 - fx)
            + img[y0, x0 + 1] * (1 - fy) * fx
            + img[y0 + 1, x0] * fy * (1 - fx)
            + img[y0 + 1, x0 + 1] * fy * fx).astype(np.float32)


def _make_texture(fam, rng, th, tw):
    """Generate the family texture at bounded resolution and upscale: the
    cylinder worlds carry multi-megapixel textures (tex_w ~ 2*pi*fx*1.3)
    and the O(sites * pixels) generators took minutes per world at full
    size — the descriptor statistics only need the local structure, which
    survives a 2-4x upscale."""
    gh, gw = min(th, 640), min(tw, 960)
    tex = fam(rng, gh, gw)
    if (gh, gw) != (th, tw):
        tex = _bilinear_resize(tex, th, tw)
    return tex.astype(np.float32)


def train_main():
    corpus = np.load(CORPUS)
    print(f"training k=10 L=6 on {len(corpus)} descriptors", flush=True)
    t1 = time.time()
    voc = train_vocabulary(corpus, k=10, L=6, seed=0)
    print(f"trained in {time.time()-t1:.0f}s", flush=True)
    out = "orb_slam2_2021_tpu/data/vocab_k10_L6.npz"
    voc.save(out)
    print("saved", out, flush=True)
    words = voc.transform_np(corpus[:200000])
    print("unique words in 200k sample:", len(np.unique(words)), flush=True)


def main():
    if MODE == "train":
        train_main()
        return
    target = int(sys.argv[2]) if len(sys.argv) > 2 else 4_000_000
    cfg = synthetic_config(width=560, height=420).replace(
        orb=OrbConfig(n_features=1600, n_levels=4)
    )
    extract = make_extract_fn(cfg.orb)
    descs = []
    total = 0
    t0 = time.time()

    def harvest(img):
        nonlocal total
        kp = extract(jnp.asarray(img))
        d = np.asarray(kp.desc)[np.asarray(kp.valid)]
        descs.append(d)
        total += len(d)

    tex_makers = [None, voronoi_texture, turbulence_texture, collage_texture,
                  blob_texture, ridged_texture]
    seed = 0
    while total < target:
        fam = tex_makers[seed % len(tex_makers)]
        wrng = np.random.default_rng(5000 + seed)
        if seed % 2 == 0:
            world = SyntheticStereoWorld(cfg, seed=900 + seed)
            if fam is not None:
                th, tw = world.texture.shape
                world.texture = _make_texture(fam, wrng, th, tw)
            views = list(forward_trajectory(10, step=0.8))
        else:
            world = SyntheticCylinderWorld(
                cfg, seed=900 + seed, radius=float(wrng.uniform(4.0, 14.0))
            )
            if fam is not None:
                th, tw = world.texture.shape
                world.texture = _make_texture(fam, wrng, th, tw)
            views = orbit_trajectory(10, total_deg=float(wrng.uniform(30, 150)),
                                     r_orbit=float(wrng.uniform(0.5, 3.0)))
        for (R, t) in views:
            left, _ = world.render(R, t)
            harvest(augment(left, wrng))
        seed += 1
        if seed % 16 == 0:
            print(f"{seed} worlds, {total} descriptors, {time.time()-t0:.0f}s",
                  flush=True)

    corpus = np.concatenate(descs, axis=0)[:target]
    del descs
    os.makedirs(os.path.dirname(CORPUS), exist_ok=True)
    np.save(CORPUS, corpus)
    print(f"harvested {len(corpus)} descriptors ({seed} worlds, 6 texture "
          f"families) -> {CORPUS}", flush=True)


if __name__ == "__main__":
    main()
