"""Roofline bounds for the two dominant device kernels.

Each report divides the least time the card could take — the larger of
bytes moved over peak memory bandwidth and operations over the peak rate of
the arithmetic the kernel uses — by the measured time. Peaks come from one
table keyed by `device_kind`; a device that is not in the table is an error,
not a default.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Peaks:
    hbm_bytes_s: float   # device-memory bandwidth
    bf16_flops: float    # dense tensor-core rate, bf16 in / f32 accumulate
    tf32_flops: float    # dense tensor-core rate, TF32
    fp32_flops: float    # f32 outside the tensor cores
    source: str


# NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense rates (no
# sparsity), at the full 700 W power limit.
_H100_SXM = Peaks(3.35e12, 989e12, 495e12, 67e12,
                  "NVIDIA H100 data sheet, SXM5, dense")

PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def peaks_for(device_kind: str) -> Peaks:
    """Peak rates of `device_kind` (jax.Device.device_kind); KeyError if the
    table does not know the device."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no peak rates for device kind {device_kind!r}: add it to "
            "utils.sol.PEAKS with its source"
        ) from None


@dataclass
class SolReport:
    name: str
    achieved_ms: float
    light_ms: float         # max(bytes / bandwidth, flops / peak)
    bytes_moved: float
    flops: float

    @property
    def pct_of_light(self) -> float:
        return 100.0 * self.light_ms / max(self.achieved_ms, 1e-9)

    def as_dict(self):
        return {
            "name": self.name,
            "achieved_ms": self.achieved_ms,
            "light_ms": self.light_ms,
            "pct_of_light": self.pct_of_light,
        }


def _device_peaks() -> Peaks:
    import jax

    return peaks_for(jax.devices()[0].device_kind)


def hamming_matrix_sol(n=2000, m=2000, name=None) -> SolReport:
    """The matcher's core: [N, 8] x [M, 8] uint32 Hamming matrix as one
    bits matrix product ({0,1} bf16, f32 accumulation).

    Traffic: the int16 [N, M] result written once, plus the descriptors.
    Operations: 2 * N * M * 256 on the bf16 tensor cores."""
    import jax
    import jax.numpy as jnp

    from ..ops.hamming import hamming_matrix
    from .timing import time_device

    pk = _device_peaks()
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32))
    b = jnp.asarray(rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32))
    f = jax.jit(hamming_matrix)
    dt = time_device(lambda: f(a, b), n=20)
    bytes_moved = n * m * 2 + (n + m) * 32
    flops = 2.0 * n * m * 256
    light = max(bytes_moved / pk.hbm_bytes_s, flops / pk.bf16_flops)
    return SolReport(name or f"hamming_matrix_{n}x{m}", 1e3 * dt, 1e3 * light,
                     bytes_moved, flops)


def ba_rcs_problem(C=128, P=2048, Q=8, seed=0):
    """Synthetic PQ-layout local-BA problem at KITTI intrinsics: C cameras,
    P points, Q observations per point, observations with 0.5 px noise (so
    the converged cost is well away from zero). Returns (cam, prob, cfg)."""
    import jax.numpy as jnp

    from ..config import kitti_stereo_config
    from ..geometry.camera import PinholeCamera
    from ..optim.ba import BAProblem

    cfg = kitti_stereo_config()
    cam = PinholeCamera.create(cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.bf,
                               cfg.width, cfg.height)
    rng = np.random.default_rng(seed)
    O = P * Q
    xw = rng.uniform(-10, 10, (P, 3)).astype(np.float32) + np.array([0, 0, 20], np.float32)
    obs_pt = np.repeat(np.arange(P, dtype=np.int32), Q)
    obs_cam = rng.integers(0, C, O).astype(np.int32)
    pc = xw[obs_pt] + rng.uniform(-0.1, 0.1, (C, 3)).astype(np.float32)[obs_cam]
    u = cfg.fx * pc[:, 0] / pc[:, 2] + cfg.cx
    v = cfg.fy * pc[:, 1] / pc[:, 2] + cfg.cy
    uvr = (np.stack([u, v, u - cfg.bf / pc[:, 2]], 1)
           + rng.normal(0, 0.5, (O, 3))).astype(np.float32)
    prob = BAProblem(
        R=jnp.asarray(np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))),
        t=jnp.zeros((C, 3), jnp.float32),
        xw=jnp.asarray(xw),
        cam_free=jnp.asarray(np.arange(C) > 0),
        obs_cam=jnp.asarray(obs_cam), obs_pt=jnp.asarray(obs_pt),
        obs_uvr=jnp.asarray(uvr),
        obs_inv_sigma2=jnp.ones(O, jnp.float32),
        obs_valid=jnp.ones(O, bool), pt_obs=None,
    )
    return cam, prob, cfg


def ba_lm_step_sol(C=128, P=2048, Q=8) -> SolReport:
    """One RCS LM step (optim/ba_cg._cg_lm_step_rcs) at the steady local-BA
    bucket. Traffic (f32, produce + consume where materialized):
      per-obs blocks ~105 f32 per obs; the [O, C] one-hot read;
      M~ [P, C, 6, 3] written once and read twice; S [6C, 6C] written.
    Operations: the S product, 2 * (6C)^2 * 3P, at the rate of the
    arithmetic ba_cg.SCHUR_PRECISION selects."""
    import jax
    import jax.numpy as jnp

    from ..optim import ba_cg
    from .timing import time_device

    pk = _device_peaks()
    cam, prob, cfg = ba_rcs_problem(C, P, Q)
    onehot = ba_cg._cam_onehot(prob)
    ocfg = cfg.optim
    # R/t/xw are real arguments: a nullary closure lets XLA constant-fold
    # the whole step into the executable
    step = jax.jit(lambda R, t, xw: ba_cg._cg_lm_step_rcs(
        cam, prob, onehot, R, t, xw,
        prob.obs_valid.astype(jnp.float32), jnp.float32(1e-4),
        jnp.bool_(True), ocfg, ocfg.cg_iters,
    ))
    dt = time_device(lambda: step(prob.R, prob.t, prob.xw), n=20)
    O = P * Q
    bytes_moved = O * 105 * 4 * 2 + O * C * 4 + 3 * C * P * 18 * 4 + 36 * C * C * 4
    flops = 2.0 * (6 * C) * (6 * C) * (3 * P)
    rate = {
        jax.lax.Precision.HIGHEST: pk.fp32_flops,
        jax.lax.Precision.HIGH: pk.tf32_flops,
        jax.lax.Precision.DEFAULT: pk.tf32_flops,
    }.get(ba_cg.SCHUR_PRECISION, pk.bf16_flops / 3)
    light = max(bytes_moved / pk.hbm_bytes_s, flops / rate)
    return SolReport(f"ba_lm_step_C{C}_P{P}_Q{Q}", 1e3 * dt, 1e3 * light,
                     bytes_moved, flops)


def run_all():
    return [hamming_matrix_sol(), hamming_matrix_sol(8192, 8192),
            ba_lm_step_sol()]
