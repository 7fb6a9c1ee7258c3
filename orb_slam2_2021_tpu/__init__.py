"""Visual SLAM engine on JAX, run on an NVIDIA GPU.

A from-scratch, accelerator-first re-design of the capabilities of the ORB-SLAM2 fork
`lreithmayr/ORB_SLAM2_2021` (reference at /root/reference):

- stereo / RGB-D / monocular tracking
- ORB feature extraction (pyramid FAST + oriented BRIEF) as batched JAX
  kernels with static shapes
- descriptor matching (all search policies) as masked Hamming argmin kernels
- local mapping: triangulation, culling, fusion, local bundle adjustment with
  Schur-complement reduction (JAX Levenberg-Marquardt; replaces g2o)
- place recognition: tensorized binary vocabulary descent + inverted-file
  scoring (replaces DBoW2), EPnP relocalization
- loop closing: Horn Sim3 RANSAC, essential-graph Sim3 pose-graph optimization,
  background full BA
- occupancy-grid mapping as a jitted ray-cast scatter-add
- map checkpoint/restore, KITTI/TUM trajectory export
- multi-device global BA via jax.sharding Mesh + shard_map
  (landmark-sharded, psum-reduced camera system)

The compute path is JAX/XLA; the control plane is a host-side pipeline
mirroring the reference's four concurrent threads (Tracking, LocalMapping,
LoopClosing, GridMapping; /root/reference/src/System.cc:129-164).
"""

__version__ = "0.1.0"
