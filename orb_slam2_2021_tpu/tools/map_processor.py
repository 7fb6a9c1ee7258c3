"""Offline saved-map post-processing — the gridmapper tool equivalent.

Mirrors /root/reference/gridmapper/src/MapProcessor.{h,cpp}: load a saved
map (MapProcessor.cpp:5-43), statistical-outlier-filter the point cloud (PCL
StatisticalOutlierRemoval, MapProcessor.h:44), export the point cloud and the
keyframe trajectory, and rasterize a PGM occupancy grid from the saved
keyframes + points (SaveGridMapKITTI, MapProcessor.cpp:45-160, itself the
C++ port of gridmapper/py/pointCloud2GridMap.py).

The filter runs as one jitted kNN pass on device (the PCL version is an
O(N log N) CPU kd-tree loop); everything else is host-side numpy.

CLI:
  python -m orb_slam2_2021_tpu.tools.map_processor <map.npz> [out_dir]
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np

from ..config import SlamConfig
from ..io.persistence import load_map


def statistical_outlier_filter(points: np.ndarray, k: int = 50,
                               std_ratio: float = 1.0) -> np.ndarray:
    """PCL StatisticalOutlierRemoval semantics (setMeanK/setStddevMulThresh,
    gridmapper defaults 50/1.0): drop points whose mean distance to their k
    nearest neighbors exceeds global_mean + std_ratio * global_std.

    Returns a boolean keep-mask [N]. Distances are computed as one [N, N]
    device matrix + top_k — dense device work instead of a kd-tree.
    """
    import jax
    import jax.numpy as jnp

    from ..xmath import mm

    n = len(points)
    if n == 0:
        return np.zeros(0, bool)
    k = min(k, n - 1)
    if k <= 0:
        return np.ones(n, bool)

    @functools.partial(jax.jit, static_argnums=(1,))
    def mean_knn_dist(p, kk):
        sq = jnp.sum(p * p, axis=1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * mm(p, p.T)
        d2 = jnp.maximum(d2, 0.0).at[jnp.arange(p.shape[0]), jnp.arange(p.shape[0])].set(jnp.inf)
        neg_top, _ = jax.lax.top_k(-d2, kk)
        return jnp.mean(jnp.sqrt(-neg_top), axis=1)

    md = np.asarray(mean_knn_dist(np.asarray(points, np.float32), k))
    mu, sd = float(md.mean()), float(md.std())
    return md <= mu + std_ratio * sd


class MapProcessor:
    def __init__(self, map_path: str, cfg: Optional[SlamConfig] = None):
        self.cfg = cfg or SlamConfig()
        self.map, self.next_frame_id = load_map(map_path, self.cfg)

    # ------------------------------------------------------------------
    def point_cloud(self, filtered: bool = True, k: int = 50,
                    std_ratio: float = 1.0) -> np.ndarray:
        pts = self.map.mp_pos[self.map.mp_valid]
        if filtered and len(pts):
            pts = pts[statistical_outlier_filter(pts, k, std_ratio)]
        return pts

    def keyframe_trajectory(self) -> np.ndarray:
        """[K, 8]: timestamp + TUM pose (tx ty tz qx qy qz qw) per KF."""
        from ..geometry.so3 import rot_to_quat

        rows = []
        for k in np.nonzero(self.map.kf_valid)[0]:
            R, t = self.map.kf_R[k], self.map.kf_t[k]
            Rwc = R.T
            twc = -R.T @ t
            q = np.asarray(rot_to_quat(Rwc))  # (w, x, y, z)
            rows.append([self.map.kf_timestamp[k], *twc, q[1], q[2], q[3], q[0]])
        return np.asarray(rows) if rows else np.zeros((0, 8))

    # ------------------------------------------------------------------
    def save_point_cloud_ply(self, path: str, filtered: bool = True):
        """ASCII PLY export (the reference exports PCD via PCL)."""
        pts = self.point_cloud(filtered)
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\n")
            f.write(f"element vertex {len(pts)}\n")
            f.write("property float x\nproperty float y\nproperty float z\n")
            f.write("end_header\n")
            for x, y, z in pts:
                f.write(f"{x:.6f} {y:.6f} {z:.6f}\n")

    def save_trajectory_tum(self, path: str):
        rows = self.keyframe_trajectory()
        with open(path, "w") as f:
            for r in rows:
                f.write(" ".join(f"{v:.6f}" for v in r) + "\n")

    def save_grid_map_pgm(self, path: str, filtered: bool = True,
                          scale: Optional[float] = None):
        """Occupancy-grid PGM from the saved map (SaveGridMapKITTI,
        MapProcessor.cpp:45-160): replay every KF's rays through the
        engine's jitted raycaster, then write free=254 / occupied=0 /
        unknown=205 (the ROS map_saver encoding)."""
        from ..gridmap.grid import GridMapper
        from ..viz.draw import write_pgm

        cfg = self.cfg
        if scale is not None:
            cfg = cfg.replace(gridmap=cfg.gridmap.__class__(
                **{**cfg.gridmap.__dict__, "scale": scale}))
        gm = GridMapper(cfg, self.map)
        if filtered:
            keep = statistical_outlier_filter(self.map.mp_pos[self.map.mp_valid])
            # temporarily mask outliers out of the store for the replay
            valid_backup = self.map.mp_valid.copy()
            idx = np.nonzero(self.map.mp_valid)[0]
            self.map.mp_valid[idx[~keep]] = False
            try:
                gm.reset_and_replay()
            finally:
                self.map.mp_valid[:] = valid_backup
        else:
            gm.reset_and_replay()
        grid = gm.occupancy_grid()
        img = np.full(grid.data.shape, 205, np.uint8)
        img[grid.data == 0] = 254
        img[grid.data == 100] = 0
        write_pgm(path, img)
        return grid


def main(argv=None):
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        raise SystemExit(__doc__)
    map_path = argv[0]
    out_dir = argv[1] if len(argv) > 1 else "."
    os.makedirs(out_dir, exist_ok=True)
    mp = MapProcessor(map_path)
    n_kf = int(mp.map.kf_valid.sum())
    n_mp = int(mp.map.mp_valid.sum())
    print(f"loaded map: {n_kf} keyframes, {n_mp} map points")
    mp.save_point_cloud_ply(os.path.join(out_dir, "pointcloud.ply"))
    mp.save_trajectory_tum(os.path.join(out_dir, "kf_trajectory_tum.txt"))
    mp.save_grid_map_pgm(os.path.join(out_dir, "gridmap.pgm"))
    print(f"wrote pointcloud.ply / kf_trajectory_tum.txt / gridmap.pgm to {out_dir}")


if __name__ == "__main__":
    main()
