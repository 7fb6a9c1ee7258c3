"""Probe the orbit loop-closure scenario: instrument the detection chain."""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_platforms", "cpu")
from orb_slam2_2021_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np
from orb_slam2_2021_tpu.config import synthetic_config
from orb_slam2_2021_tpu.io.synthetic import SyntheticCylinderWorld, orbit_trajectory
from orb_slam2_2021_tpu.pipeline.system import System
from orb_slam2_2021_tpu.pipeline import loop_closing as lc_mod

# instrument
orig_detect = lc_mod.LoopClosing._detect_loop
def detect(self, k):
    if k < self.last_loop_kf + self.cfg.place.loop_min_kf_gap:
        print(f"KF {k}: gated by min_kf_gap")
        return orig_detect(self, k)
    if k not in self.kfdb.bow:
        print(f"KF {k}: no bow")
        return orig_detect(self, k)
    connected = set(int(x) for x in self.map.covisible_keyframes(k))
    min_score = 1.0
    for nb in connected:
        if nb in self.kfdb.bow:
            min_score = min(min_score, self.kfdb.score(k, nb))
    cands = self.kfdb.detect_loop_candidates(
        k, min_score, connected, lambda x: self.map.covisible_keyframes(x, 10))
    out = orig_detect(self, k)
    print(f"KF {k}: connected={sorted(connected)} min_score={min_score:.3f} "
          f"cands={cands} groups={[ (sorted(g)[:3], c) for g,c in self.consistent_groups ]} enough={out}")
    return out
lc_mod.LoopClosing._detect_loop = detect

orig_sim3 = lc_mod.LoopClosing._compute_sim3
def csim3(self, k, candidates):
    r = orig_sim3(self, k, candidates)
    print(f"  compute_sim3(k={k}, cands={candidates}) -> {'ACCEPT kf=%d' % r[0] if r else 'None'}")
    return r
lc_mod.LoopClosing._compute_sim3 = csim3

cfg = synthetic_config(width=320, height=240)
world = SyntheticCylinderWorld(cfg, seed=3)
gt = orbit_trajectory(128, total_deg=560.0, r_orbit=1.5)
sys_ = System(cfg, enable_loop_closing=True)
n_ok = 0
for i, (R_wc, t_wc) in enumerate(gt):
    left, right = world.render(R_wc, t_wc)
    if sys_.track_stereo(left, right, timestamp=i * 0.1) is not None:
        n_ok += 1
sys_.shutdown()
print("n_ok", n_ok, "/", len(gt))
print("n_loops", sys_.loop_closer.n_loops)
print("n_kfs", int(sys_.map.kf_valid.sum()))
