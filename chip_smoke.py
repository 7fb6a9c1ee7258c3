"""Smoke test of the stereo SLAM main path on one NVIDIA GPU.

Run from the repository root on a machine with the card:

    python chip_smoke.py          # one card: device, kernel parity, end to end
    python chip_smoke.py --four   # four cards: sharded global BA vs one card

Phases (one process; each prints its own lines before the last):

1. device   — JAX's default device is a GPU (it raises otherwise and never
              carries on on the CPU); the card's name and power limit from
              nvidia-smi; whether the native map-core library was built.
2. parity   — each jitted program of the main path runs on the GPU and on
              `jax.devices("cpu")[0]` in this process with the same inputs,
              at KITTI width (1241x376 stereo, 2000 ORB features, 8 levels):
              stereo frame build, the Hamming matrix, the motion-track step,
              one local-BA LM step (Schur matrix against float64 NumPy, at the
              three candidate precisions), Horn Sim3 RANSAC, EPnP RANSAC.
3. e2e      — System(kitti_stereo_config(), async_mode=True), warmup(), then
              the first 60 frames of the headline orbit through
              prefetch_stereo/track_stereo_prefetch, then the loop closer's
              global BA on the map the drive built. Asserts 0 LOST frames,
              >= 3 keyframes, >= 1 local-BA and >= 1 global-BA iteration, and
              ATE under 2 % of the path length; prints timings as information.

With --four only the sharded global BA runs: a seeded KITTI-shaped map
(~150 keyframes of 2000 features, ~50k points, <= 16 observations each) is
solved with the same number of LM iterations on a 1-D mesh of four GPUs and
on one GPU through the single-device path; final cost and poses must agree.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed phase raises, so the exit code is non-zero and no such line is
printed.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

import jax
import jax.numpy as jnp

from orb_slam2_2021_tpu.utils.compile_cache import enable_compile_cache
from orb_slam2_2021_tpu.utils.device import card_info, require_gpu

N_DRIVE = 60          # frames of the headline orbit driven end to end
ATE_FRAC = 0.02       # ATE bound as a share of the path length


def _u8(img):
    return np.clip(img, 0, 255).astype(np.uint8)


def _on(dev, fn, *args):
    """Run fn with its array arguments committed to `dev`; host result."""
    args = [jax.device_put(a, dev) if isinstance(a, (np.ndarray, jax.Array))
            else a for a in args]
    return jax.device_get(fn(*args))


def _rot_angle(Ra, Rb):
    """Angle (rad) between two rotations, from the chord ||Ra - Rb||_F =
    2 sqrt(2) sin(angle / 2); well conditioned near zero, unlike arccos."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(2.0 * np.arcsin(min(1.0, d / (2.0 * np.sqrt(2.0)))))


def _tcw(R_wc, t_wc):
    R_wc = np.asarray(R_wc, np.float32)
    return R_wc.T, -R_wc.T @ np.asarray(t_wc, np.float32)


class Checks:
    """Collects the comparisons of one phase; raises after printing all."""

    def __init__(self, phase):
        self.phase = phase
        self.failed = []

    def __call__(self, name, ok, detail):
        print(f"[{self.phase}] {name}: {detail} -> {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            self.failed.append(name)

    def done(self):
        if self.failed:
            raise AssertionError(f"{self.phase} failed: {self.failed}")


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_device():
    dev = require_gpu()
    card = card_info()
    from orb_slam2_2021_tpu import native

    print(f"[device] platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())} card={card} "
          f"native_map_core={native.HAVE_NATIVE}", flush=True)
    return dev, card


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def parity_frame(chk, cfg, pair, dev, ref):
    """Stereo frame build from one uint8 pair. Blur and resize sums run in
    another order on the GPU, so near-threshold FAST corners, near-tie BRIEF
    pairs (compared in bf16) and near-tie stereo candidates may flip."""
    from orb_slam2_2021_tpu.frontend.frame import make_stereo_frame_u8_fn

    fn = make_stereo_frame_u8_fn(cfg)
    u8 = np.stack([_u8(pair[0]), _u8(pair[1])])
    fg = _on(dev, fn, u8)
    fc = _on(ref, fn, u8)
    vg, vc = np.asarray(fg.kp.valid), np.asarray(fc.kp.valid)
    ng, nc = int(vg.sum()), int(vc.sum())
    chk("frame.n_valid", abs(ng - nc) <= max(2, 0.01 * nc),
        f"gpu={ng} cpu={nc} |diff|={abs(ng - nc)} tol=max(2, 1%)")

    def keyed(f, v):
        xy = np.asarray(f.kp.xy)[v]
        octv = np.asarray(f.kp.octave)[v]
        idx = np.nonzero(v)[0]
        return {(int(o), float(x), float(y)): int(i)
                for o, (x, y), i in zip(octv, xy, idx)}

    kg, kc = keyed(fg, vg), keyed(fc, vc)
    common = sorted(set(kg) & set(kc))
    share = len(common) / max(nc, 1)
    chk("frame.same_positions", share >= 0.97,
        f"share={share:.5f} tol>=0.97")
    ig = np.array([kg[k] for k in common], np.int64)
    ic = np.array([kc[k] for k in common], np.int64)
    from orb_slam2_2021_tpu.ops.hamming import hamming_pair

    hd = np.asarray(hamming_pair(jnp.asarray(np.asarray(fg.kp.desc)[ig]),
                                 jnp.asarray(np.asarray(fc.kp.desc)[ic])))
    chk("frame.desc_hamming", hd.mean() <= 4.0 and np.percentile(hd, 99) <= 32,
        f"mean={hd.mean():.4f} p99={np.percentile(hd, 99):.1f} max={hd.max()} "
        f"tol mean<=4 p99<=32 bits")
    ug, uc = np.asarray(fg.u_right)[ig], np.asarray(fc.u_right)[ic]
    both = (ug >= 0) & (uc >= 0)
    du = np.abs(ug[both] - uc[both])
    agree = float(((ug >= 0) == (uc >= 0)).mean())
    far = float((du > 1.0).mean()) if du.size else 0.0
    chk("frame.u_right",
        du.size > 0 and np.median(du) <= 0.01 and far <= 0.02 and agree >= 0.98,
        f"n={du.size} median|d|={np.median(du) if du.size else -1:.2e} "
        f"max|d|={du.max() if du.size else -1:.3f} share>1px={far:.4f} "
        f"stereo_agree={agree:.4f} tol median<=0.01px share>1px<=0.02 "
        f"agree>=0.98")
    return fc


def parity_hamming(chk, dev, timings):
    """hamming_matrix ({0,1} bf16 operands, f32 accumulation) against XOR +
    popcount: exact, no tolerance. Both forms are timed on the card."""
    from orb_slam2_2021_tpu.ops.hamming import hamming_matrix, hamming_pair
    from orb_slam2_2021_tpu.utils.timing import time_device

    mat = jax.jit(hamming_matrix)
    xor = jax.jit(lambda a, b: hamming_pair(a[:, None, :], b[None, :, :]))
    rng = np.random.default_rng(1)
    for n in (2000, 8192):
        a = jax.device_put(rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32), dev)
        b = jax.device_put(rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32), dev)
        if n == 2000:
            dm = np.asarray(mat(a, b)).astype(np.int32)
            dx = np.asarray(xor(a, b))
            err = int(np.abs(dm - dx).max())
            chk("hamming_matrix_2000x2000", err == 0,
                f"max|matmul - xor_popcount|={err} tol=0 (exact)")
        timings[f"hamming_bits_matmul_{n}"] = 1e3 * time_device(lambda: mat(a, b), n=20)
        timings[f"hamming_xor_popcount_{n}"] = 1e3 * time_device(lambda: xor(a, b), n=20)
    print("[parity] hamming_timings_ms: " + " ".join(
        f"{k}={v:.4f}" for k, v in timings.items() if k.startswith("hamming")),
        flush=True)


def parity_motion_track(chk, cfg, f0, pair1, gt0, gt1, dev, ref):
    """Fused motion-track step (SearchByProjection against the previous
    frame + pose optimization), fed frame 0's stereo points and frame 1's
    keypoints built on the CPU. Pose optimization runs in f32 with HIGHEST
    contractions on both devices; only reduction order differs, which can
    move a borderline chi2 inlier."""
    from orb_slam2_2021_tpu.frontend.frame import make_stereo_frame_u8_fn
    from orb_slam2_2021_tpu.geometry.camera import PinholeCamera
    from orb_slam2_2021_tpu.pipeline.track_steps import make_motion_track_fn

    cam = PinholeCamera.create(cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.bf,
                               cfg.width, cfg.height)
    f1 = _on(ref, make_stereo_frame_u8_fn(cfg),
             np.stack([_u8(pair1[0]), _u8(pair1[1])]))
    kp0 = f0.kp
    depth0 = np.asarray(f0.depth)
    valid0 = np.asarray(kp0.valid) & (depth0 > 0)
    xy0 = np.asarray(kp0.xy)
    z = np.where(valid0, depth0, 1.0)
    xc = np.stack([(xy0[:, 0] - cfg.cx) * z / cfg.fx,
                   (xy0[:, 1] - cfg.cy) * z / cfg.fy, z], 1)
    R_wc0, t_wc0 = gt0
    xw = (xc @ np.asarray(R_wc0).T + t_wc0).astype(np.float32)
    R1, t1 = _tcw(*gt1)
    # prediction: frame 1's pose perturbed by ~0.3 deg and 2 cm
    w = np.deg2rad(0.3)
    Rp = np.array([[np.cos(w), 0, np.sin(w)], [0, 1, 0],
                   [-np.sin(w), 0, np.cos(w)]], np.float32) @ R1
    tp = (t1 + np.array([0.02, 0.0, -0.01], np.float32)).astype(np.float32)
    fn = make_motion_track_fn(cfg)
    args = (f1.kp, np.asarray(f1.u_right), Rp, tp, xw, np.asarray(kp0.desc),
            np.asarray(kp0.octave), np.asarray(kp0.angle), valid0,
            np.float32(cfg.tracking.motion_search_radius))

    def run(d):
        a = jax.tree.map(lambda x: jax.device_put(x, d), args)
        return jax.device_get(fn(cam, *a))

    Rg, tg, _, _, ng, mg = run(dev)
    Rc, tc, _, _, nc, mc = run(ref)
    dR, dt = _rot_angle(Rg, Rc), float(np.abs(tg - tc).max())
    dn = abs(int(ng) - int(nc))
    eR, et = _rot_angle(Rg, R1), float(np.abs(tg - t1).max())
    chk("motion_track",
        dR <= 1e-3 and dt <= 1e-2 and dn <= max(3, 0.01 * int(nc))
        and int(ng) >= 50 and eR <= np.deg2rad(0.3) and et <= 0.05,
        f"inliers gpu={int(ng)} cpu={int(nc)} matched={int(mg)}/{int(mc)} "
        f"|dR|={dR:.2e}rad |dt|={dt:.2e}m vs_gt R={eR:.2e}rad t={et:.2e}m "
        f"tol |dR|<=1e-3 |dt|<=1e-2 |dn|<=max(3,1%)")


def _schur_f64(prob, onehot, Uo, Wcp, V_inv, lam):
    """Float64 NumPy reference of the reduced camera system S built from
    the same per-observation blocks: S = blockdiag(U_d) - sum_p A_p V_p^-1
    A_p^T with A_p[c] = sum_q [cam(p,q) = c] W_pq."""
    C = prob.R.shape[0]
    P = prob.xw.shape[0]
    Q = prob.obs_cam.shape[0] // P
    oh = np.asarray(onehot, np.float64).reshape(P, Q, C)
    W = np.asarray(Wcp, np.float64).reshape(P, Q, 6, 3)
    Vi = np.asarray(V_inv, np.float64)
    A = np.einsum("pqc,pqik->pcik", oh, W)                       # [P,C,6,3]
    B = np.einsum("pcik,pkl->pcil", A, Vi)
    Af = A.transpose(1, 2, 0, 3).reshape(6 * C, 3 * P)
    Bf = B.transpose(1, 2, 0, 3).reshape(6 * C, 3 * P)
    corr = Bf @ Af.T
    U = np.einsum("oc,okl->ckl", np.asarray(onehot, np.float64),
                  np.asarray(Uo, np.float64))
    eye = np.eye(6)
    d = np.maximum(np.diagonal(U, axis1=1, axis2=2), 1e-6)
    U_d = U + lam * eye[None] * d[:, :, None] + 1e-8 * eye[None]
    free = np.asarray(prob.cam_free)
    U_d = np.where(free[:, None, None], U_d, eye[None])
    S = -corr
    for c in range(C):
        S[6 * c:6 * c + 6, 6 * c:6 * c + 6] += U_d[c]
    ff = np.repeat(free, 6)
    return np.where(ff[:, None] & ff[None, :], S, np.eye(6 * C))


def parity_local_ba(chk, dev, ref, timings):
    """The RCS LM step at C=128, P=2048, Q=8, at each candidate precision of
    its Schur contractions: S against float64 (bound 1e-4 relative), the
    step time, and the robust cost after 15 accept/reject LM iterations
    against the same solve on the CPU in full f32 (bound 1e-3 relative: a
    converged f32 solve differs only by reduction order). The chosen form
    (ba_cg.SCHUR_PRECISION) must meet both bounds."""
    from orb_slam2_2021_tpu.optim import ba_cg
    from orb_slam2_2021_tpu.optim.ba import _residual_chi2, _total_cost
    from orb_slam2_2021_tpu.utils.sol import ba_rcs_problem
    from orb_slam2_2021_tpu.utils.timing import time_device

    cam, prob, cfg = ba_rcs_problem(128, 2048, 8)
    ocfg = cfg.optim
    lam = 1e-4
    active = prob.obs_valid.astype(jnp.float32)
    n_iters = ocfg.local_ba_iters1 + ocfg.local_ba_iters2

    def schur(prec):
        def f(prob, R, t, xw):
            onehot = ba_cg._cam_onehot(prob)
            Uo, bco, Wcp, V_inv, b_p, *_ = ba_cg._rcs_blocks(
                cam, prob, R, t, xw, active, jnp.float32(lam),
                jnp.bool_(True), ocfg)
            S, rhs, _ = ba_cg._rcs_schur(prob, onehot, Uo, bco, Wcp, V_inv,
                                         b_p, jnp.float32(lam), prec)
            return S, onehot, Uo, Wcp, V_inv
        return jax.jit(f)

    def step(prec):
        return jax.jit(lambda prob, R, t, xw: ba_cg._cg_lm_step_rcs(
            cam, prob, ba_cg._cam_onehot(prob), R, t, xw, active,
            jnp.float32(lam), jnp.bool_(True), ocfg, ocfg.cg_iters,
            precision=prec)[:3])

    def solve(prec):
        """n_iters Huber LM iterations with the pipeline's accept/reject
        rule (optim/ba_cg.make_lm_chunk_pq); returns the final cost."""
        def f(prob):
            onehot = ba_cg._cam_onehot(prob)

            def body(carry, _):
                R, t, xw, lm = carry
                Rn, tn, xn, chi2, _, d2 = ba_cg._cg_lm_step_rcs(
                    cam, prob, onehot, R, t, xw, active, lm, jnp.bool_(True),
                    ocfg, ocfg.cg_iters, precision=prec)
                c0 = _total_cost(chi2, active, d2, True)
                c1 = _total_cost(_residual_chi2(cam, prob, Rn, tn, xn)[0],
                                 active, d2, True)
                ok = c1 < c0
                return (jnp.where(ok, Rn, R), jnp.where(ok, tn, t),
                        jnp.where(ok, xn, xw),
                        jnp.where(ok, lm * 0.5, lm * 4.0)), None

            (R, t, xw, _), _ = jax.lax.scan(
                body, (prob.R, prob.t, prob.xw, jnp.float32(lam)), None,
                length=n_iters)
            chi2, _ = _residual_chi2(cam, prob, R, t, xw)
            d2 = jnp.where(prob.obs_uvr[:, 2] >= 0, ocfg.chi2_stereo,
                           ocfg.chi2_mono)
            return _total_cost(chi2, active, d2, True)
        return jax.jit(f)

    P_ = jax.lax.Precision
    forms = {"HIGH": P_.HIGH, "HIGHEST": P_.HIGHEST,
             "BF16_BF16_F32_X3": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3}
    probg = jax.device_put(prob, dev)
    cost_cpu = float(_on(ref, solve(P_.HIGHEST), prob))
    res = {}
    for name, prec in forms.items():
        S, onehot, Uo, Wcp, V_inv = jax.device_get(
            schur(prec)(probg, probg.R, probg.t, probg.xw))
        S64 = _schur_f64(prob, onehot, Uo, Wcp, V_inv, lam)
        err = float(np.abs(S - S64).max() / np.abs(S64).max())
        f = step(prec)
        ms = 1e3 * time_device(lambda: f(probg, probg.R, probg.t, probg.xw), n=20)
        cost = float(solve(prec)(probg))
        res[name] = (err, ms, cost, abs(cost - cost_cpu) / abs(cost_cpu))
        timings[f"rcs_step_{name}"] = ms
    print(f"[parity] rcs_precision: cpu_f32_cost_after_{n_iters}_iters="
          f"{cost_cpu:.6e} " + " ".join(
              f"{k}: rel_err_S={e:.3e} step_ms={ms:.4f} cost={c:.6e} "
              f"rel_cost_diff={d:.3e}" for k, (e, ms, c, d) in res.items()),
          flush=True)
    chosen = next(k for k, v in forms.items() if v == ba_cg.SCHUR_PRECISION)
    e, ms, c, d = res[chosen]
    chk("rcs_chosen_precision", e <= 1e-4 and d <= 1e-3,
        f"SCHUR_PRECISION={chosen} rel_err_S={e:.3e} tol<=1e-4 "
        f"rel_cost_diff_after_{n_iters}_iters={d:.3e} tol<=1e-3")


def parity_ransac(chk, cfg, dev, ref):
    """Horn Sim3 RANSAC and EPnP RANSAC on seeded synthetic correspondences
    (20 % outliers, 0.5 px noise). The PRNG is backend independent, so both
    devices draw the same hypotheses; borderline inliers may differ."""
    from orb_slam2_2021_tpu.geometry.so3 import so3_exp
    from orb_slam2_2021_tpu.solvers.epnp import make_pnp_ransac
    from orb_slam2_2021_tpu.solvers.horn_sim3 import make_sim3_ransac

    rng = np.random.default_rng(7)
    fx, fy, cx, cy = cfg.fx, cfg.fy, cfg.cx, cfg.cy

    def proj(xc):
        return np.stack([fx * xc[:, 0] / xc[:, 2] + cx,
                         fy * xc[:, 1] / xc[:, 2] + cy], 1).astype(np.float32)

    def scene(n):
        return np.stack([rng.uniform(-6, 6, n), rng.uniform(-1.5, 1.5, n),
                         rng.uniform(5, 30, n)], 1).astype(np.float32)

    R = np.asarray(so3_exp(jnp.asarray(rng.standard_normal(3) * 0.1, jnp.float32)))
    t = (rng.standard_normal(3) * 0.5).astype(np.float32)

    # Sim3 (fixed scale, stereo): x1 = R x2 + t
    n = 256
    x1 = scene(n)
    x2 = ((x1 - t) @ R).astype(np.float32)
    uv1 = proj(x1) + rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    uv2 = proj(x2) + rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    out = rng.random(n) < 0.2
    uv1[out] += rng.uniform(-80, 80, (int(out.sum()), 2)).astype(np.float32)
    fn = make_sim3_ransac(True, 128)
    args = (jax.random.PRNGKey(0), x1, x2, uv1, uv2,
            np.ones(n, np.float32), np.ones(n, np.float32), np.ones(n, bool))

    def run(f, d, a, *scalars):
        a = jax.tree.map(lambda x: jax.device_put(x, d), a)
        return jax.device_get(f(*a, *scalars))

    sg, Rg, tg, _, ng = run(fn, dev, args, fx, fy, cx, cy)
    sc, Rc, tc, _, nc = run(fn, ref, args, fx, fy, cx, cy)
    dR, dt = _rot_angle(Rg, Rc), float(np.abs(tg - tc).max())
    chk("horn_sim3_ransac",
        dR <= 1e-3 and dt <= 1e-2 and abs(int(ng) - int(nc)) <= 2
        and _rot_angle(Rg, R) <= 5e-3 and abs(float(sg) - 1.0) < 1e-6,
        f"inliers gpu={int(ng)} cpu={int(nc)} |dR|={dR:.2e} |dt|={dt:.2e} "
        f"vs_gt R={_rot_angle(Rg, R):.2e}rad tol |dR|<=1e-3 |dt|<=1e-2 "
        f"|dn|<=2")

    # EPnP: world points -> camera (R, t)
    n = 512
    xw = scene(n)
    uv = proj(xw @ R.T + t) + rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    out = rng.random(n) < 0.2
    uv[out] += rng.uniform(-80, 80, (int(out.sum()), 2)).astype(np.float32)
    fn = make_pnp_ransac(256)
    args = (jax.random.PRNGKey(1), xw, uv, np.ones(n, np.float32),
            np.ones(n, bool))
    Rg, tg, _, ng = run(fn, dev, args, fx, fy, cx, cy)
    Rc, tc, _, nc = run(fn, ref, args, fx, fy, cx, cy)
    dR, dt = _rot_angle(Rg, Rc), float(np.abs(tg - tc).max())
    chk("epnp_ransac",
        dR <= 1e-3 and dt <= 1e-2 and abs(int(ng) - int(nc)) <= 2
        and _rot_angle(Rg, R) <= 1e-2,
        f"inliers gpu={int(ng)} cpu={int(nc)} |dR|={dR:.2e} |dt|={dt:.2e} "
        f"vs_gt R={_rot_angle(Rg, R):.2e}rad tol |dR|<=1e-3 |dt|<=1e-2 "
        f"|dn|<=2")


def phase_parity(cfg, frames, gt, dev):
    ref = jax.devices("cpu")[0]
    chk = Checks("parity")
    timings = {}
    f0 = parity_frame(chk, cfg, frames[0], dev, ref)
    parity_hamming(chk, dev, timings)
    parity_motion_track(chk, cfg, f0, frames[1], gt[0], gt[1], dev, ref)
    parity_local_ba(chk, dev, ref, timings)
    parity_ransac(chk, cfg, dev, ref)
    chk.done()
    return timings


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def phase_e2e(cfg, frames, gt, dev, card):
    from orb_slam2_2021_tpu.io.trajectory import ate_rmse
    from orb_slam2_2021_tpu.pipeline.system import System

    t0 = time.perf_counter()
    sys_ = System(cfg, async_mode=True)
    sys_.warmup()
    warmup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    nxt = sys_.prefetch_stereo(frames[0][0], frames[0][1])
    for i in range(len(frames)):
        cur = nxt
        cur_imgs = frames[i + 1] if i + 1 < len(frames) else None
        _, nxt = sys_.track_stereo_prefetch(cur, cur_imgs, timestamp=i * 0.1)
    drive_s = time.perf_counter() - t0
    sys_.shutdown()

    lc = sys_.loop_closer
    lc._run_global_ba(idx=lc.full_ba_idx)

    gt_mats = []
    for R_wc, t_wc in gt:
        T = np.eye(4)
        T[:3, :3] = R_wc
        T[:3, 3] = t_wc
        gt_mats.append(T)
    est = sys_.trajectory_kitti()
    ate = float(ate_rmse(est, gt_mats[: len(est)]))
    path = float(np.linalg.norm(np.diff([T[:3, 3] for T in gt_mats], axis=0),
                                axis=1).sum())
    lost = sum(r.get("state") == "LOST" for r in sys_.metrics)
    n_kf = int(sys_.map.n_kf)
    lba_iters = sum(n for _, n in sys_.local_mapper.ba_solve_times)
    gba_iters = len(getattr(lc, "gba_iter_times", []))
    chk = Checks("e2e")
    chk("drive",
        len(est) == len(frames) and lost == 0 and n_kf >= 3
        and lba_iters >= 1 and gba_iters >= 1 and ate < ATE_FRAC * path,
        f"frames={len(est)}/{len(frames)} lost={lost} keyframes={n_kf} "
        f"map_points={int(sys_.map.mp_valid.sum())} loops={lc.n_loops} "
        f"local_ba_iters={lba_iters} global_ba_iters={gba_iters} "
        f"ate={ate:.4f}m path={path:.3f}m bound={ATE_FRAC * path:.4f}m")
    chk.done()
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use", "not reported")
    print(f"[e2e] info card={card} warmup_s={warmup_s:.2f} "
          f"fps={len(frames) / drive_s:.3f} "
          f"median_frame_ms={1e3 * float(np.median(sys_.frame_times)):.3f} "
          f"gba_ms_per_iter={1e3 * lc.gba_iter_times[-1]:.3f} "
          f"peak_bytes_in_use={peak}", flush=True)


# ---------------------------------------------------------------------------
# --four: sharded global BA
# ---------------------------------------------------------------------------

def kitti_shaped_map(cfg, seed=0, n_kf=150, new_per_kf=330, max_obs=16):
    """Seeded map store of KITTI shape: n_kf keyframes 1.5 m apart driving
    along +z, each with cfg.orb.n_features feature slots; every point is
    seen by a run of 2..max_obs consecutive keyframes. Observations are
    exact stereo projections plus 0.5 px noise; keyframe poses and points
    start perturbed, so global BA has work to do."""
    from orb_slam2_2021_tpu.geometry.so3 import so3_exp
    from orb_slam2_2021_tpu.mapping.map_store import MapStore

    rng = np.random.default_rng(seed)
    N = cfg.orb.n_features
    m = MapStore(cfg)
    centers = np.zeros((n_kf, 3), np.float32)
    centers[:, 2] = 1.5 * np.arange(n_kf)
    n_pts = n_kf * new_per_kf
    first = np.repeat(np.arange(n_kf), new_per_kf)
    life = rng.integers(2, max_obs + 1, n_pts)
    last = np.minimum(first + life - 1, n_kf - 1)
    d_min = rng.uniform(4.0, 35.0, n_pts)          # depth at the last observer
    z = centers[last, 2] + d_min
    x = rng.uniform(-0.75, 0.75, n_pts) * d_min
    y = rng.uniform(-0.22, 0.22, n_pts) * d_min
    pts = np.stack([x, y, z], 1).astype(np.float32)
    pts_noisy = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    ids = np.full(n_pts, -1, np.int64)
    for k in range(n_kf):
        new = np.nonzero(first == k)[0]
        ids[new] = m.add_map_points_batch(
            pts_noisy[new], rng.integers(0, 2 ** 32, (len(new), 8), dtype=np.uint32), k)
        seen = np.nonzero((first <= k) & (last >= k))[0][:N]
        xc = pts[seen] - centers[k]
        u = cfg.fx * xc[:, 0] / xc[:, 2] + cfg.cx
        v = cfg.fy * xc[:, 1] / xc[:, 2] + cfg.cy
        ur = u - cfg.bf / xc[:, 2]
        noise = rng.normal(0, 0.5, (len(seen), 2)).astype(np.float32)
        xy = np.zeros((N, 2), np.float32)
        xy[: len(seen)] = np.stack([u, v], 1) + noise
        urs = np.full(N, -1.0, np.float32)
        urs[: len(seen)] = ur + noise[:, 0]
        dep = np.full(N, -1.0, np.float32)
        dep[: len(seen)] = xc[:, 2]
        valid = np.zeros(N, bool)
        valid[: len(seen)] = True
        bind = np.full(N, -1, np.int64)
        bind[: len(seen)] = ids[seen]
        R_cw = np.eye(3, dtype=np.float32)
        t_cw = -centers[k]
        if k > 0:
            R_cw = np.asarray(so3_exp(jnp.asarray(
                rng.normal(0, 0.002, 3), jnp.float32))) @ R_cw
            t_cw = t_cw + rng.normal(0, 0.02, 3).astype(np.float32)
        m.add_keyframe(R_cw, t_cw, xy, urs, dep, np.zeros(N, np.int32),
                       np.zeros(N, np.float32),
                       np.zeros((N, 8), np.uint32), valid, bind)
    return m


def phase_four(cfg):
    from jax.sharding import Mesh

    from orb_slam2_2021_tpu.optim.assemble import (
        assemble_ba_problem, global_problem_shapes, upload_problem)
    from orb_slam2_2021_tpu.optim.ba import _residual_chi2, _total_cost
    from orb_slam2_2021_tpu.parallel.dist_ba import (
        AXIS, device_put_sharded_problem, shard_ba_problem)
    from orb_slam2_2021_tpu.pipeline.loop_closing import LoopClosing
    from orb_slam2_2021_tpu.place.kf_database import KeyFrameDatabase
    from orb_slam2_2021_tpu.place.vocab import BinaryVocabulary

    gpus = jax.devices()
    if len(gpus) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, found {len(gpus)}")
    mesh = Mesh(np.array(gpus[:4]), (AXIS,))
    chk = Checks("four")
    voc = BinaryVocabulary(2, 2, np.zeros((7, 8), np.uint32), np.ones(4, np.float32))

    results = {}
    for name, use_mesh in (("mesh4", True), ("single", False)):
        m = kitti_shaped_map(cfg)
        kfs = np.nonzero(m.kf_valid)[0]
        mp = np.nonzero(m.mp_valid)[0]
        n_obs = int(np.count_nonzero(m.mp_obs_kf[mp] >= 0))
        if name == "mesh4":
            print(f"[four] map keyframes={len(kfs)} points={len(mp)} "
                  f"observations={n_obs} max_obs_per_point="
                  f"{int(m.mp_obs_n[mp].max())}", flush=True)
        lc = LoopClosing(cfg, m, KeyFrameDatabase(voc), fix_scale=True)
        lc.mesh = mesh if use_mesh else None
        t0 = time.perf_counter()
        lc._run_global_ba(idx=lc.full_ba_idx)
        wall = time.perf_counter() - t0
        if use_mesh and lc._dist_step is None:
            raise AssertionError("global BA did not take the sharded mesh path")
        # final cost of the written-back map, evaluated one way for both
        C_pad, P_pad, O_pad = global_problem_shapes(len(kfs), len(mp), n_obs)
        prob, *_ = assemble_ba_problem(m, kfs, kfs != 0, mp, C_pad, P_pad,
                                       O_pad, device=False)
        if use_mesh:
            n_dev = mesh.devices.size
            P_pad = ((P_pad + n_dev - 1) // n_dev) * n_dev
            prob_s, *_ = assemble_ba_problem(m, kfs, kfs != 0, mp, C_pad,
                                             P_pad, O_pad, device=False)
            placed = device_put_sharded_problem(shard_ba_problem(prob_s, n_dev), mesh)
            shard_devs = {s.device for s in placed.xw.addressable_shards}
            chk("shards_on_all_devices", shard_devs == set(gpus[:4]),
                f"xw shards on {sorted(d.id for d in shard_devs)}")
        probd = upload_problem(prob)
        chi2, _ = jax.jit(_residual_chi2)(lc.cam, probd, probd.R, probd.t, probd.xw)
        is_st = np.asarray(prob.obs_uvr)[:, 2] >= 0
        delta2 = np.where(is_st, cfg.optim.chi2_stereo, cfg.optim.chi2_mono)
        cost = float(_total_cost(chi2, probd.obs_valid.astype(jnp.float32),
                                 jnp.asarray(delta2, jnp.float32), jnp.bool_(True)))
        # gba_iter_times holds each chunk's per-iteration mean; the last
        # chunk is past compilation
        results[name] = dict(cost=cost, R=m.kf_R[kfs].copy(), t=m.kf_t[kfs].copy(),
                             iters=len(lc.gba_iter_times), wall=wall,
                             ms_iter=1e3 * lc.gba_iter_times[-1])
        print(f"[four] {name}: cost={cost:.6e} iters={results[name]['iters']} "
              f"ms_per_iter={results[name]['ms_iter']:.3f} wall_s={wall:.2f}",
              flush=True)
    a, b = results["mesh4"], results["single"]
    rel = abs(a["cost"] - b["cost"]) / max(abs(b["cost"]), 1e-30)
    dR = max(_rot_angle(x, y) for x, y in zip(a["R"], b["R"]))
    dt = float(np.abs(a["t"] - b["t"]).max())
    chk("gba_mesh4_vs_single",
        rel <= 1e-3 and a["iters"] == b["iters"] and dR <= 1e-3 and dt <= 1e-2,
        f"rel_cost_diff={rel:.3e} max|dR|={dR:.2e}rad max|dt|={dt:.2e}m "
        f"tol rel<=1e-3 |dR|<=1e-3 |dt|<=1e-2")
    chk.done()


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded global BA on four GPUs")
    args = ap.parse_args(argv)

    dev, card = phase_device()
    enable_compile_cache()
    from orb_slam2_2021_tpu.config import kitti_stereo_config

    cfg = kitti_stereo_config()
    if args.four:
        phase_four(cfg)
    else:
        from orb_slam2_2021_tpu.io.synthetic import (
            SyntheticCylinderWorld, orbit_trajectory)

        world = SyntheticCylinderWorld(cfg, seed=7)
        gt = orbit_trajectory(144, total_deg=630.0, r_orbit=1.5)[:N_DRIVE]
        frames = [world.render(R, t) for R, t in gt]
        phase_parity(cfg, frames, gt, dev)
        phase_e2e(cfg, frames, gt, dev, card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
