"""Train the packaged ORB vocabulary.

The reference ships a pre-trained DBoW2 ORBvoc (stripped from this mirror,
.MISSING_LARGE_BLOBS); this is our equivalent trainer (SURVEY.md §7 hard part
'Vocabulary availability'): hierarchical binary k-medians over ORB
descriptors harvested from many synthetic textured worlds. The resulting
tree is small (k=10, L=4 -> 10k words, ~350 KB compressed) and ships inside
the package at orb_slam2_2021_tpu/data/vocab_k10_L4.npz.

Usage: PYTHONPATH=/root/repo python scripts/train_vocab.py [n_worlds]
"""

import sys

import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
from orb_slam2_2021_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np
import jax.numpy as jnp

from orb_slam2_2021_tpu.config import synthetic_config, OrbConfig
from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld, forward_trajectory
from orb_slam2_2021_tpu.frontend.features import make_extract_fn
from orb_slam2_2021_tpu.place.vocab import train_vocabulary


def main():
    n_worlds = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    cfg = synthetic_config(width=480, height=360).replace(
        orb=OrbConfig(n_features=1024, n_levels=4)
    )
    extract = make_extract_fn(cfg.orb)
    descs = []
    for seed in range(n_worlds):
        world = SyntheticStereoWorld(cfg, seed=seed + 100)
        for fi, (R, t) in enumerate(forward_trajectory(3, step=1.5)):
            left, _ = world.render(R, t)
            kp = extract(jnp.asarray(left))
            d = np.asarray(kp.desc)[np.asarray(kp.valid)]
            descs.append(d)
        print(f"world {seed}: total descriptors {sum(len(d) for d in descs)}")
    corpus = np.concatenate(descs, axis=0)
    print("training on", len(corpus), "descriptors")
    voc = train_vocabulary(corpus, k=10, L=4, seed=0)
    out = "orb_slam2_2021_tpu/data/vocab_k10_L4.npz"
    voc.save(out)
    print("saved", out)
    # sanity: word distribution
    words = voc.transform_np(corpus[:5000])
    print("unique words in 5k sample:", len(np.unique(words)))


if __name__ == "__main__":
    main()
