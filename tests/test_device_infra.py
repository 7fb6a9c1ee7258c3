"""What surrounds the device path and runs without a card: the compile-cache
rule, the peak table, the GPU guards of bench.py and chip_smoke.py, the
native library build, the RCS Schur matrix against float64, and
chip_smoke's comparison code run with the CPU on both sides."""

import ctypes
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
import chip_smoke
from orb_slam2_2021_tpu.utils import compile_cache
from orb_slam2_2021_tpu.utils.sol import PEAKS, peaks_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestCompileCache:
    def test_env_dir_is_used_and_no_other_set(self, monkeypatch):
        monkeypatch.setenv(compile_cache.ENV_VAR, "/elsewhere/jax-cache")
        before = jax.config.jax_compilation_cache_dir
        assert compile_cache.enable_compile_cache() == "/elsewhere/jax-cache"
        assert jax.config.jax_compilation_cache_dir == before

    def test_unset_uses_fixed_dir_in_checkout(self, monkeypatch):
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        d = compile_cache.enable_compile_cache()
        assert d == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == d
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


class TestPeaks:
    def test_h100_entry(self):
        p = peaks_for("NVIDIA H100 80GB HBM3")
        assert (p.hbm_bytes_s, p.bf16_flops, p.tf32_flops, p.fp32_flops) == (
            3.35e12, 989e12, 495e12, 67e12)
        assert "data sheet" in p.source

    def test_unknown_device_raises(self):
        assert "cpu" not in PEAKS
        with pytest.raises(KeyError, match="no peak rates"):
            peaks_for(jax.devices("cpu")[0].device_kind)


class TestGpuGuards:
    def test_bench_refuses_cpu(self, monkeypatch):
        monkeypatch.setattr(bench, "SMALL", False)
        with pytest.raises(RuntimeError, match="no GPU"):
            bench._device_fields()

    def test_bench_small_mode_reports_cpu(self, monkeypatch):
        monkeypatch.setattr(bench, "SMALL", True)
        d = bench._device_fields()
        assert d["platform"] == "cpu" and d["card"] == "none"

    def test_chip_smoke_refuses_cpu(self, capsys):
        with pytest.raises(RuntimeError, match="no GPU"):
            chip_smoke.main([])
        assert '"ok"' not in capsys.readouterr().out


class TestNativeBuild:
    def test_builds_into_build_dir_and_rebuilds_on_source_change(self, tmp_path):
        if shutil.which("g++") is None:
            pytest.skip("no g++ on this machine")
        from orb_slam2_2021_tpu import native

        assert native.BUILD_DIR == os.path.join(REPO, "build", "native")
        assert os.path.dirname(native.lib_path()) == native.BUILD_DIR
        src = tmp_path / "map_core.cpp"
        shutil.copy(native.SRC, src)
        out_dir = str(tmp_path / "build")
        first = native.build(str(src), out_dir)
        assert os.path.dirname(first) == out_dir and os.path.exists(first)
        mtime = os.path.getmtime(first)
        assert native.build(str(src), out_dir) == first      # hash unchanged
        assert os.path.getmtime(first) == mtime              # not rebuilt
        with open(src, "a") as f:
            f.write("\n// edited\n")
        second = native.build(str(src), out_dir)
        assert second != first and os.path.exists(second)
        assert hasattr(ctypes.CDLL(second), "covis_counts")
        assert not [p for p in os.listdir(out_dir) if p.endswith(".tmp")]


def test_rcs_schur_matches_float64():
    """_rcs_schur's S = U_d - W V^-1 W^T against the float64 NumPy build
    from the same blocks (f32 on the CPU: ~1e-6 relative)."""
    from orb_slam2_2021_tpu.optim import ba_cg
    from orb_slam2_2021_tpu.utils.sol import ba_rcs_problem

    cam, prob, cfg = ba_rcs_problem(8, 64, 4)
    lam = 1e-3
    active = prob.obs_valid.astype(jnp.float32)

    @jax.jit
    def schur(prob):
        onehot = ba_cg._cam_onehot(prob)
        Uo, bco, Wcp, V_inv, b_p, *_ = ba_cg._rcs_blocks(
            cam, prob, prob.R, prob.t, prob.xw, active, jnp.float32(lam),
            jnp.bool_(True), cfg.optim)
        S, _, _ = ba_cg._rcs_schur(prob, onehot, Uo, bco, Wcp, V_inv, b_p,
                                   jnp.float32(lam))
        return S, onehot, Uo, Wcp, V_inv

    S, onehot, Uo, Wcp, V_inv = jax.device_get(schur(prob))
    S64 = chip_smoke._schur_f64(prob, onehot, Uo, Wcp, V_inv, lam)
    assert S.shape == (48, 48)
    np.testing.assert_allclose(S, S.T, rtol=0, atol=1e-5 * np.abs(S64).max())
    assert np.abs(S - S64).max() <= 1e-5 * np.abs(S64).max()


def test_ransac_parity_checks_pass_cpu_against_cpu():
    from orb_slam2_2021_tpu.config import kitti_stereo_config

    chk = chip_smoke.Checks("parity")
    cpu = jax.devices("cpu")[0]
    chip_smoke.parity_ransac(chk, kitti_stereo_config(), cpu, cpu)
    assert chk.failed == []


def test_sharded_gba_matches_single_device_on_four_cpu_devices(monkeypatch):
    """chip_smoke --four's comparison on a small seeded map over four
    virtual CPU devices: mesh path and single-device path agree."""
    from orb_slam2_2021_tpu.config import kitti_stereo_config

    monkeypatch.setattr(chip_smoke, "kitti_shaped_map", functools.partial(
        chip_smoke.kitti_shaped_map, n_kf=12, new_per_kf=200))
    chip_smoke.phase_four(kitti_stereo_config())
