"""Frame-level front-end: ORB extraction, stereo matching, frame assembly.

JAX replacement for the reference's ORBextractor + Frame layer
(/root/reference/src/ORBextractor.cc, src/Frame.cc). All outputs are
fixed-capacity padded arrays with validity masks so downstream jit shapes are
static.
"""

from .features import Keypoints, extract_orb, make_extract_fn
from .frame import Frame, build_stereo_frame, make_stereo_frame_fn

__all__ = [
    "Keypoints", "extract_orb", "make_extract_fn",
    "Frame", "build_stereo_frame", "make_stereo_frame_fn",
]
