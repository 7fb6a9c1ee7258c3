"""Probe: per-KF mapping-pass cost decomposition on the device (snapshot /
dispatch / pull / merge) plus tracking-lane latency jitter around KF events
— the mean-vs-median gap that caps e2e fps."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    from orb_slam2_2021_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from orb_slam2_2021_tpu.config import kitti_stereo_config
    from orb_slam2_2021_tpu.io.synthetic import SyntheticCylinderWorld, orbit_trajectory
    from orb_slam2_2021_tpu.pipeline import local_mapping as lm_mod
    from orb_slam2_2021_tpu.pipeline.system import System

    # instrument the mapping pass stages
    orig_pass = lm_mod.LocalMapping._mapping_device_pass
    events = []

    def timed_pass(self, k):
        t0 = time.perf_counter()
        m = self.map
        with m.lock:
            tri = self._snapshot_triangulation(k)
            fuse = self._snapshot_fuse(k)
        t1 = time.perf_counter()
        dev = []
        tri_ms = fuse_ms = 0.0
        if tri is not None:
            neighbors, view1, views2 = tri
            out = self._tri_batch_fn(self.cam, view1, views2)
            dev.append(out[:3])
            tf = time.perf_counter()
            jax.block_until_ready(out[0])
            tri_ms = 1e3 * (time.perf_counter() - tf)
        if fuse is not None:
            _, chunks, args, back = fuse
            for chunk, views in chunks:
                bf_b, acc_b, _ = self._fuse_batch_fn(self.cam, views, args)
                dev.append((acc_b, bf_b))
            for bsel, bargs, view in back:
                best_feat, accept, _ = self._fuse_fn(self.cam, view, bargs)
                dev.append((accept, best_feat))
            tf = time.perf_counter()
            jax.block_until_ready(dev[-1][0])
            fuse_ms = 1e3 * (time.perf_counter() - tf)
        t2 = time.perf_counter()
        if not dev:
            return
        pulled = jax.device_get(dev)
        t3 = time.perf_counter()
        with m.lock:
            i = 0
            if tri is not None:
                match2_b, xw_b, ok_b = pulled[0]
                i = 1
                if m.kf_valid[k]:
                    self._merge_new_points(k, neighbors, match2_b, xw_b, ok_b)
            if fuse is not None:
                _, chunks, args, back = fuse
                fwd_sel = self._fuse_fwd_sel
                for chunk, _views in chunks:
                    acc_b, bf_b = pulled[i]
                    i += 1
                    for ti, kt in enumerate(chunk):
                        if m.kf_valid[kt]:
                            self._merge_fuse(fwd_sel, acc_b[ti], bf_b[ti], kt)
                for bsel, _a, _v in back:
                    accept, best_feat = pulled[i]
                    i += 1
                    if m.kf_valid[k]:
                        self._merge_fuse(bsel, accept, best_feat, k)
                touched = self._fuse_touched
                if len(touched):
                    m.update_point_stats(np.asarray(touched, np.int64))
                if m.kf_valid[k]:
                    m.update_connections(k)
        t4 = time.perf_counter()
        events.append({"snap": t1 - t0, "dispatch": t2 - t1,
                       "pull": t3 - t2, "merge": t4 - t3,
                       "tri_ms": tri_ms, "fuse_ms": fuse_ms})

    lm_mod.LocalMapping._mapping_device_pass = timed_pass

    cfg = kitti_stereo_config()
    world = SyntheticCylinderWorld(cfg, seed=7)
    gt = orbit_trajectory(64, total_deg=280.0, r_orbit=1.5)
    frames = [world.render(R, t) for (R, t) in gt]

    sys_ = System(cfg, async_mode=False)
    ft = []
    nxt = sys_.prefetch_stereo(*frames[0])
    for i in range(len(frames)):
        t0 = time.perf_counter()
        cur = nxt
        if i + 1 < len(frames):
            nxt = sys_.prefetch_stereo(*frames[i + 1])
        sys_.track_stereo(cur, timestamp=i * 0.1)
        ft.append(time.perf_counter() - t0)
    sys_.shutdown()
    ft = np.asarray(ft[8:])
    print(f"frames {len(ft)}  median {1e3*np.median(ft):.0f} ms  "
          f"mean {1e3*ft.mean():.0f} ms  p90 {1e3*np.percentile(ft,90):.0f} ms")
    for i, e in enumerate(events):
        print(f"  map[{i:2d}] snap {1e3*e['snap']:6.1f}  "
              f"tri {e['tri_ms']:6.1f}  fuse {e['fuse_ms']:6.1f}  "
              f"pull {1e3*e['pull']:7.1f}  merge {1e3*e['merge']:6.1f} ms")
    lm = sys_.local_mapper
    for i, e in enumerate(getattr(lm, "ba_events", [])):
        print(f"  BA[{i:2d}] P={e['P']:5d} Q={e['Q']:2d} "
              f"dispatch {e['dispatch_ms']:7.1f}  pull {e['pull_ms']:7.1f} ms")
    for kname, v in sorted(lm.sect_times.items(), key=lambda kv: -kv[1]):
        print(f"  [sect] {kname:30s} {1e3*v:8.0f} ms total")


if __name__ == "__main__":
    main()
