"""Headless visualization — the reference's Viewer stack without a GUI.

The reference renders with Pangolin (3-D map view, /root/reference/src/
MapDrawer.cc, Viewer.cc) and OpenCV windows (tracked-feature overlay,
FrameDrawer.cc). A production engine on an accelerator runs headless, so the equivalents
here rasterize to numpy RGB images and PNG files; a live consumer can
subscribe to them through orb_slam2_2021_tpu.io.pubsub.
"""

from .frame_drawer import FrameDrawer
from .map_drawer import MapDrawer
from .viewer import Viewer

__all__ = ["FrameDrawer", "MapDrawer", "Viewer"]
