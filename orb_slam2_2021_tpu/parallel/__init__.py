"""Multi-chip scale-out: device meshes + distributed bundle adjustment.

The reference's only parallelism is shared-memory threads (SURVEY.md §2
parallelism table); this package is the multi-device replacement:
map/landmark blocks sharded over a jax.sharding.Mesh, observation-parallel
residual/Jacobian evaluation, and the reduced camera system psum-reduced
across the devices (the scaling analogue of g2o's single-core Schur
complement).
"""

from .dist_ba import make_dist_ba, shard_ba_problem

__all__ = ["make_dist_ba", "shard_ba_problem"]
