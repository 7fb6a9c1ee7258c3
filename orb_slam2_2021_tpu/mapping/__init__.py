"""Map data model: struct-of-arrays keyframe/landmark store.

Array-based replacement for the reference's pointer-graph map
(/root/reference/src/Map.cc, KeyFrame.cc, MapPoint.cc): instead of
mutex-guarded objects, the map is a set of flat numpy arrays on the host
(single-writer: the mapping thread), from which immutable device snapshots
are cut for the jitted tracking/BA steps (SURVEY.md §2 'snapshot semantics').
"""

from .map_store import MapStore

__all__ = ["MapStore"]
