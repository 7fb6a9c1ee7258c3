"""Lie-group math substrate (SE3/Sim3) and camera models.

JAX replacement for the reference's L0 layer
(/root/reference/Thirdparty/g2o/g2o/types/se3quat.h, sim3.h,
/root/reference/src/Converter.cc). Everything operates on jnp arrays with
arbitrary leading batch dims; poses are (R: [..,3,3], t: [..,3]) pairs, with
quaternion helpers for serialization/export.
"""

from .so3 import (
    so3_exp,
    so3_log,
    so3_hat,
    quat_to_rot,
    rot_to_quat,
)
from .se3 import (
    se3_exp,
    se3_log,
    se3_compose,
    se3_inverse,
    se3_apply,
    se3_identity,
    se3_from_Rt,
    mat44,
    from_mat44,
)
from .sim3 import (
    sim3_exp,
    sim3_log,
    sim3_compose,
    sim3_inverse,
    sim3_apply,
    sim3_identity,
)
from .camera import PinholeCamera, project_stereo, project_mono, backproject

__all__ = [
    "so3_exp", "so3_log", "so3_hat", "quat_to_rot", "rot_to_quat",
    "se3_exp", "se3_log", "se3_compose", "se3_inverse", "se3_apply",
    "se3_identity", "se3_from_Rt", "mat44", "from_mat44",
    "sim3_exp", "sim3_log", "sim3_compose", "sim3_inverse", "sim3_apply",
    "sim3_identity",
    "PinholeCamera", "project_stereo", "project_mono", "backproject",
]
