"""2-D occupancy-grid mapping (the fork's fourth pipeline stage).

Device-side replacement for GridMapping
(/root/reference/src/GridMapping.cpp): per keyframe, project the camera
center and its map points onto the ground (x, z) grid and ray-cast
visit/occupied counters; on loop closure, reset and replay all keyframes
(GridMapping.cpp:43-60). The Bresenham walk (:232-270) becomes a vectorized
line sampler + scatter-add over all rays at once.
"""

from .grid import GridMapper, OccupancyGrid

__all__ = ["GridMapper", "OccupancyGrid"]
