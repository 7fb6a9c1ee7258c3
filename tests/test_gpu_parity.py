"""The card against the CPU in one process, at KITTI width: the comparisons
chip_smoke.py's parity phase makes, as tests. Marked `gpu`: they skip where
JAX has no GPU (see tests/conftest.py for the command that runs them)."""

import jax
import pytest

import chip_smoke
from orb_slam2_2021_tpu.config import kitti_stereo_config
from orb_slam2_2021_tpu.io.synthetic import SyntheticCylinderWorld, orbit_trajectory

pytestmark = pytest.mark.gpu


@pytest.fixture
def orbit():
    cfg = kitti_stereo_config()
    world = SyntheticCylinderWorld(cfg, seed=7)
    gt = orbit_trajectory(144, total_deg=630.0, r_orbit=1.5)[:2]
    return cfg, [world.render(R, t) for R, t in gt], gt


def _cpu():
    return jax.devices("cpu")[0]


def test_frame_build_and_motion_track(gpu_device, orbit):
    cfg, frames, gt = orbit
    chk = chip_smoke.Checks("parity")
    f0 = chip_smoke.parity_frame(chk, cfg, frames[0], gpu_device, _cpu())
    chip_smoke.parity_motion_track(chk, cfg, f0, frames[1], gt[0], gt[1],
                                   gpu_device, _cpu())
    chk.done()


def test_hamming_matrix_exact(gpu_device):
    chk = chip_smoke.Checks("parity")
    chip_smoke.parity_hamming(chk, gpu_device, {})
    chk.done()


def test_local_ba_step(gpu_device):
    chk = chip_smoke.Checks("parity")
    chip_smoke.parity_local_ba(chk, gpu_device, _cpu(), {})
    chk.done()


def test_ransac_solvers(gpu_device):
    chk = chip_smoke.Checks("parity")
    chip_smoke.parity_ransac(chk, kitti_stereo_config(), gpu_device, _cpu())
    chk.done()
