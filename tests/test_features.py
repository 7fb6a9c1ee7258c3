"""Feature-kernel tests: FAST, selection, orientation, BRIEF, Hamming, stereo.

Golden semantics from SURVEY.md §2 #7-#9 (ORBextractor.cc, Frame.cc,
ORBmatcher.cc); correctness asserted on synthetic imagery with known
structure, not bit-exactness against OpenCV.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orb_slam2_2021_tpu.config import synthetic_config
from orb_slam2_2021_tpu.ops.fast import fast_score_map, nms3x3, fast_detect
from orb_slam2_2021_tpu.ops.select import select_keypoints
from orb_slam2_2021_tpu.ops.orientation import ic_angles
from orb_slam2_2021_tpu.ops.brief import brief_descriptors, brief_pattern
from orb_slam2_2021_tpu.ops.hamming import (
    hamming_pair, hamming_matrix, masked_best2, rotation_histogram_filter, MAX_DIST,
)
from orb_slam2_2021_tpu.ops.image import build_pyramid, gaussian_blur
from orb_slam2_2021_tpu.frontend.features import make_extract_fn, level_feature_counts
from orb_slam2_2021_tpu.frontend.frame import make_stereo_frame_fn
from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld, forward_trajectory


class TestFAST:
    def test_corner_detected(self):
        # bright 5x5 square on dark background: corners of the square fire
        img = np.zeros((64, 64), np.float32)
        img[30:35, 30:35] = 200.0
        score = fast_score_map(jnp.asarray(img), 20.0)
        assert float(jnp.max(score)) > 0
        ys, xs = np.nonzero(np.asarray(score))
        # all detections near the square
        assert (np.abs(ys - 32) <= 4).all() and (np.abs(xs - 32) <= 4).all()

    def test_flat_image_no_corners(self):
        img = jnp.full((64, 64), 100.0)
        score = fast_score_map(img, 10.0)
        assert float(jnp.max(score)) == 0.0

    def test_nms_keeps_single_peak(self):
        s = np.zeros((16, 16), np.float32)
        s[8, 8] = 5.0
        s[8, 9] = 3.0
        out = np.asarray(nms3x3(jnp.asarray(s)))
        assert out[8, 8] == 5.0 and out[8, 9] == 0.0

    def test_two_threshold_fallback(self):
        # weak corner only passes the relaxed threshold
        img = np.full((64, 64), 100.0, np.float32)
        img[30:35, 30:35] = 112.0  # contrast 12: passes th=7, fails th=20
        strict, relaxed = fast_detect(jnp.asarray(img), 20.0, 7.0, 19)
        assert float(jnp.max(strict)) == 0.0
        assert float(jnp.max(relaxed)) > 0.0


class TestSelect:
    def test_spatial_spread(self, rng):
        # two clusters of corners; selection should cover both cells
        score = np.zeros((64, 64), np.float32)
        score[10, 10] = 10.0
        score[10, 12] = 9.0
        score[10, 14] = 8.0
        score[50, 50] = 1.0  # weak but isolated
        ys, xs, vals, valid = select_keypoints(
            jnp.asarray(score), jnp.asarray(score), 2, 32
        )
        got = {(int(y), int(x)) for y, x, v in zip(ys, xs, valid) if v}
        assert (10, 10) in got
        assert (50, 50) in got  # rank-0 of its cell beats rank-1 elsewhere

    def test_respects_budget_and_validity(self):
        score = np.zeros((64, 64), np.float32)
        score[20, 20] = 5.0
        ys, xs, vals, valid = select_keypoints(jnp.asarray(score), jnp.asarray(score), 8, 32)
        assert int(jnp.sum(valid)) == 1


class TestOrientation:
    def test_gradient_angle(self):
        # intensity ramp along +x -> centroid to the right -> angle ~ 0
        img = np.tile(np.arange(64, dtype=np.float32), (64, 1))
        ang = np.asarray(ic_angles(jnp.asarray(img), jnp.asarray([32]), jnp.asarray([32])))
        assert abs(ang[0]) < 0.1
        # ramp along +y -> angle ~ pi/2
        ang2 = np.asarray(ic_angles(jnp.asarray(img.T), jnp.asarray([32]), jnp.asarray([32])))
        assert abs(ang2[0] - np.pi / 2) < 0.1


class TestBRIEF:
    def test_pattern_bounded(self):
        pat = np.asarray(brief_pattern())
        assert pat.shape == (256, 2, 2)
        r = np.linalg.norm(pat, axis=-1)
        assert r.max() <= 13.0 + 1e-5

    def test_descriptor_deterministic_and_discriminative(self, rng):
        img = jnp.asarray(rng.uniform(0, 255, (128, 128)).astype(np.float32))
        blurred = gaussian_blur(img)
        ys = jnp.asarray([40, 40, 80], jnp.int32)
        xs = jnp.asarray([40, 41, 90], jnp.int32)
        ang = jnp.zeros(3)
        d1 = brief_descriptors(blurred, ys, xs, ang)
        d2 = brief_descriptors(blurred, ys, xs, ang)
        assert (np.asarray(d1) == np.asarray(d2)).all()
        # same point ~ similar; distant point ~ dissimilar
        d_same = int(hamming_pair(d1[0], d1[1]))
        d_far = int(hamming_pair(d1[0], d1[2]))
        assert d_same < d_far

    def test_rotation_quasi_invariance(self, rng):
        # IC-angle + rotated sampling must be sign-consistent: descriptors
        # computed with each patch's own IC angle stay close under image
        # rotation, and clearly closer than without compensation.
        from scipy.ndimage import rotate as ndrotate
        base = rng.uniform(0, 255, (96, 96)).astype(np.float32)
        base = np.asarray(gaussian_blur(jnp.asarray(base), 7, 2.0))
        rot = ndrotate(base, 30.0, reshape=False, order=1, mode="nearest")
        c = jnp.asarray([48])
        a0 = ic_angles(jnp.asarray(base), c, c)
        a1 = ic_angles(jnp.asarray(rot), c, c)
        # the IC angle itself must track the rotation (mod 2pi, either sign
        # convention maps 30deg -> +-30deg)
        dang = abs(float(a1[0] - a0[0]))
        dang = min(dang, 2 * np.pi - dang)
        assert abs(dang - np.deg2rad(30.0)) < np.deg2rad(8.0)
        d0 = brief_descriptors(jnp.asarray(base), c, c, a0)
        d1 = brief_descriptors(jnp.asarray(rot), c, c, a1)
        d1b = brief_descriptors(jnp.asarray(rot), c, c, a0)
        dist_comp = int(hamming_pair(d0[0], d1[0]))
        dist_nocomp = int(hamming_pair(d0[0], d1b[0]))
        assert dist_comp < dist_nocomp
        assert dist_comp < 80


class TestHamming:
    def test_pair_known(self):
        a = jnp.asarray([[0xFFFFFFFF] + [0] * 7], jnp.uint32)
        b = jnp.zeros((1, 8), jnp.uint32)
        assert int(hamming_pair(a[0], b[0])) == 32
        m = hamming_matrix(a, b)
        assert int(m[0, 0]) == 32

    def test_masked_best2(self):
        dist = jnp.asarray([[5, 3, 9], [1, 2, 3]], jnp.int32)
        mask = jnp.asarray([[True, True, True], [False, True, True]])
        best, idx, second = masked_best2(dist, mask)
        assert int(best[0]) == 3 and int(idx[0]) == 1 and int(second[0]) == 5
        assert int(best[1]) == 2 and int(idx[1]) == 1 and int(second[1]) == 3

    def test_rotation_histogram(self):
        n = 100
        ang_a = jnp.zeros(n)
        # 90 matches at rotation 0, 10 outliers at rotation pi
        ang_b = jnp.asarray(np.concatenate([np.zeros(90), np.full(10, np.pi)]), jnp.float32)
        mask = jnp.ones(n, bool)
        out = rotation_histogram_filter(ang_a, ang_b, mask, n_bins=30, keep=1)
        assert int(jnp.sum(out[:90])) == 90
        assert int(jnp.sum(out[90:])) == 0


class TestLevelCounts:
    def test_sums_to_total(self):
        counts = level_feature_counts(2000, 8, 1.2)
        assert sum(counts) == 2000
        assert counts[0] > counts[-1]


class TestExtractPipeline:
    def test_extract_on_synthetic(self):
        cfg = synthetic_config(width=320, height=240)
        world = SyntheticStereoWorld(cfg, seed=1)
        R, t = forward_trajectory(1)[0]
        left, right = world.render(R, t)
        kp = make_extract_fn(cfg.orb)(jnp.asarray(left))
        n_valid = int(jnp.sum(kp.valid))
        assert n_valid > 100, f"only {n_valid} keypoints"
        xy = np.asarray(kp.xy)[np.asarray(kp.valid)]
        assert xy[:, 0].max() < cfg.width and xy[:, 1].max() < cfg.height
        # spatial spread: keypoints in all four quadrants
        qx = xy[:, 0] > cfg.width / 2
        qy = xy[:, 1] > cfg.height / 2
        for m in (qx & qy, qx & ~qy, ~qx & qy, ~qx & ~qy):
            assert m.sum() > 5

    def test_stereo_depth_accuracy(self):
        cfg = synthetic_config(width=320, height=240)
        world = SyntheticStereoWorld(cfg, seed=2)
        R, t = forward_trajectory(1)[0]
        left, right = world.render(R, t)
        frame = make_stereo_frame_fn(cfg)(jnp.asarray(left), jnp.asarray(right))
        depth = np.asarray(frame.depth)
        valid = depth > 0
        assert valid.sum() > 50, f"only {valid.sum()} stereo matches"
        # ground truth: intersect each keypoint's pixel ray with the world
        # surface (same fixed point the renderer converges to)
        xy = np.asarray(frame.kp.xy)[valid]
        zs = depth[valid]
        dx = (xy[:, 0] - cfg.cx) / cfg.fx
        dy = (xy[:, 1] - cfg.cy) / cfg.fy
        lam = np.full(len(xy), 8.0)
        for _ in range(10):
            lam = world._depth_at(t[0] + lam * dx, t[1] + lam * dy) - t[2]
        # evaluate in disparity space: relative depth error scales with depth
        # (far points at disparity ~2 px legitimately carry ~10% depth error),
        # so the matcher's quality metric is sub-pixel disparity accuracy
        disp_err = np.abs(cfg.bf / zs - cfg.bf / lam)
        assert np.median(disp_err) < 0.5, f"median disparity err {np.median(disp_err)} px"
        # and close points must still be metrically accurate
        close = lam < 10.0
        if close.sum() > 20:
            rel = (np.abs(zs - lam) / lam)[close]
            assert np.median(rel) < 0.05, f"close-range depth err {np.median(rel)}"


class TestHammingMatrix:
    @pytest.mark.parametrize("n,m", [(1, 1), (127, 129), (2000, 2000)])
    def test_equals_xor_popcount(self, rng, n, m):
        """The bits-matmul form ({0,1} bf16 operands, f32 accumulation) is
        exact: it equals XOR + popcount (hamming_pair) everywhere."""
        import jax.numpy as jnp

        from orb_slam2_2021_tpu.ops.hamming import hamming_matrix, hamming_pair

        a = jnp.asarray(rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32))
        b = jnp.asarray(rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32))
        out = np.asarray(hamming_matrix(a, b)).astype(np.int32)
        ref = np.asarray(hamming_pair(a[:, None, :], b[None, :, :]))
        assert out.shape == (n, m)
        np.testing.assert_array_equal(out, ref)
