"""Dense per-frame compute kernels (JAX/XLA).

JAX replacements for the reference's L1 perception layer
(/root/reference/src/ORBextractor.cc, Frame.cc:522-700, ORBmatcher.cc).
Everything here is shape-static, mask-based, and jit-compiled; keypoint
capacity and pyramid geometry come from `OrbConfig`.
"""
