"""LoopClosing — loop detection, Sim3 computation, loop correction, global BA.

Mirrors the reference's loop thread (/root/reference/src/LoopClosing.cc):
- DetectLoop (:118-245): BoW candidates from the keyframe database gated by
  the min covisible score, then covisibility-consistency across 3 consecutive
  detections (mnCovisibilityConsistencyTh=3, :54);
- ComputeSim3 (:247-419): per candidate, descriptor matching -> vmapped Horn
  Sim3 RANSAC -> relative Sim3 refine (>= 20 inliers) -> gather loop-region
  map points -> projection matching against the corrected pose (>= 40 total);
- CorrectLoop (:421-614): propagate the corrected Sim3 through the current
  covisibility group, remap their map points, fuse duplicates, optimize the
  essential graph (spanning tree + covis>=100 + loop edges), then run full
  bundle adjustment (RunGlobalBundleAdjustment, :674-779).

Runs synchronously from LocalMapping's queue drain; scale is fixed for
stereo/RGBD (bFixScale) and free for monocular.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..geometry.camera import PinholeCamera
from ..mapping.map_store import MapStore
from ..optim.sim3_opt import PoseGraph, make_essential_solver, make_sim3_refine
from ..place.kf_database import KeyFrameDatabase
from ..place.vocab import make_transform_fn
from ..solvers.horn_sim3 import make_sim3_ransac
from ..frontend.matchers import match_bruteforce_desc
from .mapping_steps import KFView, make_fuse_fn


def _sim3_mat(s, R, t):
    """(s,R,t) -> 4x4 with scale folded: [sR | t]."""
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = s * R
    T[:3, 3] = t
    return T


def _sim3_inv(s, R, t):
    si = 1.0 / s
    Ri = R.T
    ti = -si * (Ri @ t)
    return si, Ri, ti


def _sim3_mul(a, b):
    sa, Ra, ta = a
    sb, Rb, tb = b
    return sa * sb, Ra @ Rb, sa * (Ra @ tb) + ta


def _pose_mat(R, t):
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


class LoopClosing:
    def __init__(self, cfg: SlamConfig, map_store: MapStore, kfdb: KeyFrameDatabase,
                 fix_scale: bool = True):
        self.cfg = cfg
        self.map = map_store
        self.kfdb = kfdb
        self.fix_scale = fix_scale
        self.cam = PinholeCamera.create(
            cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.bf, cfg.width, cfg.height
        )
        self.queue: List[int] = []
        self.last_loop_kf = -int(1e9)
        self.consistent_groups: List[Tuple[Set[int], int]] = []  # (group, count)
        self.loop_closed_flag = False  # consumed by GridMapping (GridMapping.cpp:43)
        self.n_loops = 0
        self.local_mapper = None
        # background global-BA state (LoopClosing.h mbRunningGBA/mbStopGBA/
        # mnFullBAIdx; LoopClosing.cc:604-608, 674-779)
        self.async_mode = False
        self.running_gba = False
        self.stop_gba = False
        self.full_ba_idx = 0
        self.gba_thread = None
        # optional device mesh: global BA shards points/observations over the
        # 'map' axis and psums the reduced camera system across the devices
        # (SURVEY.md §5 distributed-backend plan)
        self.mesh = None
        self._dist_step = None

        self._sim3_ransac = make_sim3_ransac(fix_scale, 128)
        self._sim3_refine = make_sim3_refine(fix_scale)
        self._essential = make_essential_solver(fix_scale)
        self._fuse_fn = make_fuse_fn(cfg)
        self._match_fn = jax.jit(match_bruteforce_desc)
        self._key = jax.random.PRNGKey(cfg.orb.n_features)

    @property
    def loop_edges(self) -> Dict[int, Set[int]]:
        """Essential-graph loop constraints (mspLoopEdges, KeyFrame.h). Live
        on the MapStore so persistence round-trips them (KeyFrame.cc:695-766
        serializes them in the reference)."""
        return self.map.loop_edges

    # ------------------------------------------------------------------
    def request_reset(self):
        """LoopClosing::RequestReset (LoopClosing.cc:645-672): drop queued
        keyframes, abort a running global BA, forget loop bookkeeping."""
        self.queue.clear()
        self.full_ba_idx += 1
        if self.gba_thread is not None and self.gba_thread.is_alive():
            self.stop_gba = True
            self.gba_thread.join()
        self.stop_gba = False
        self.last_loop_kf = -int(1e9)
        self.consistent_groups = []
        self.map.loop_edges.clear()
        self.loop_closed_flag = False

    def insert_keyframe(self, k: int, words=None):
        self.queue.append((k, words))

    def process_pending(self):
        while self.queue:
            k, words = self.queue.pop(0)
            self._process(k, words)

    def _process(self, k: int, words):
        if words is not None:
            self.kfdb.add_bow(k, words)
        with self.map.lock:
            if not self.map.kf_valid[k]:
                return
            # protect the current KF from culling while its detection is in
            # flight (SetNotErase, LoopClosing.cc:121, 392-417)
            self.map.kf_not_erase[k] = True
            candidates = self._detect_loop(k)
        result = None
        if candidates:
            with self.map.lock:
                for c in candidates:
                    self.map.kf_not_erase[c] = True
                result = self._compute_sim3(k, candidates)
        if result is not None:
            loop_kf, scw, matched_feat_mp = result
            # abort any in-flight global BA OUTSIDE the map lock (it may be
            # blocked acquiring it for write-back); staleness index invalidates
            # its result (mbStopGBA + mnFullBAIdx, LoopClosing.cc:427-448)
            self.full_ba_idx += 1
            if self.gba_thread is not None and self.gba_thread.is_alive():
                self.stop_gba = True
                self.gba_thread.join()
            self.stop_gba = False
            with self.map.lock:
                self._correct_loop(k, loop_kf, scw, matched_feat_mp)
        with self.map.lock:
            # release erase protection (SetErase runs deferred culls)
            for c in set(candidates) | {k}:
                if result is not None and c in (k, result[0]):
                    continue  # the matched pair stays protected (loop edges)
                self.map.set_erase(int(c))
        # the KF becomes a retrieval candidate only now (DetectLoop end,
        # LoopClosing.cc:237-243)
        if k in self.kfdb.bow:
            self.kfdb.add_to_index(k)

    # ------------------------------------------------------------------
    def _detect_loop(self, k: int) -> List[int]:
        """DetectLoop (:118-245). Returns enough-consistent candidates."""
        if k < self.last_loop_kf + self.cfg.place.loop_min_kf_gap:
            self.consistent_groups = []
            return []
        if k not in self.kfdb.bow:
            return []
        connected = set(int(x) for x in self.map.covisible_keyframes(k))
        # min score among covisible neighbors (:131-141)
        min_score = 1.0
        for nb in connected:
            if nb in self.kfdb.bow:
                min_score = min(min_score, self.kfdb.score(k, nb))
        cands = self.kfdb.detect_loop_candidates(
            k, min_score, connected, lambda x: self.map.covisible_keyframes(x, 10)
        )
        if not cands:
            self.consistent_groups = []
            return []
        # covisibility consistency over consecutive detections (:167-227)
        enough: List[int] = []
        new_groups: List[Tuple[Set[int], int]] = []
        th = self.cfg.place.covis_consistency_th
        for c in cands:
            group = set(int(x) for x in self.map.covisible_keyframes(c)) | {c}
            best_count = 0
            matched_any = False
            for prev_group, count in self.consistent_groups:
                if group & prev_group:
                    matched_any = True
                    best_count = max(best_count, count + 1)
            new_groups.append((group, best_count))
            if best_count >= th:
                enough.append(c)
            if not matched_any:
                new_groups[-1] = (group, 0)
        self.consistent_groups = new_groups
        return enough

    # ------------------------------------------------------------------
    def _kf_cam_points(self, k: int):
        """Map points of KF k in its camera frame + their feature pixels."""
        mp = self.map.kf_mp[k]
        feats = np.nonzero((mp >= 0) & self.map.mp_valid[np.clip(mp, 0, None)])[0]
        ids = mp[feats]
        pw = self.map.mp_pos[ids]
        R, t = self.map.kf_R[k], self.map.kf_t[k]
        pc = pw @ R.T + t
        uv = self.map.kf_xy[k, feats]
        octv = self.map.kf_octave[k, feats]
        return feats, ids, pc, uv, octv

    def _compute_sim3(self, k: int, candidates: List[int]):
        """ComputeSim3 (:247-419). Returns (loop_kf, Scw(s,R,t), feat->loop_mp)
        or None."""
        sigma2 = self.map.scale_factors ** 2
        for kc in candidates:
            # descriptor matching between the two KFs' map-point features
            f1, ids1, pc1, uv1, oct1 = self._kf_cam_points(k)
            f2, ids2, pc2, uv2, oct2 = self._kf_cam_points(int(kc))
            if len(f1) < 20 or len(f2) < 20:
                continue

            # pad both sides to power-of-two buckets: raw lengths would
            # compile one matcher program per (n1, n2) pair, and first-loop
            # compiles land inside the map lock on the live pipeline
            def _mcap(n):
                return max(256, int(2 ** np.ceil(np.log2(max(n, 2)))))

            def _mpad(x, n, fill=0):
                out = np.full((_mcap(n), *x.shape[1:]), fill, x.dtype)
                out[:n] = x[:n]
                return jnp.asarray(out)

            n1, n2 = len(f1), len(f2)
            best_b, accept, dist = self._match_fn(
                _mpad(self.map.kf_desc[k, f1], n1),
                jnp.asarray(np.arange(_mcap(n1)) < n1),
                _mpad(self.map.kf_angle[k, f1], n1),
                _mpad(self.map.kf_desc[int(kc), f2], n2),
                jnp.asarray(np.arange(_mcap(n2)) < n2),
                _mpad(self.map.kf_angle[int(kc), f2], n2),
            )
            accept = np.asarray(accept)[:n1]
            best_b = np.asarray(best_b)[:n1]
            # padded B-side slots can never be best (valid mask), but clamp
            # defensively so a pad index can't address past f2
            best_b = np.clip(best_b, 0, n2 - 1)
            if accept.sum() < 20:
                continue
            m1 = np.nonzero(accept)[0]
            m2 = best_b[m1]
            n = len(m1)
            pad = max(64, int(2 ** np.ceil(np.log2(max(n, 2)))))
            def padded(x, fill=0.0):
                out = np.full((pad, *x.shape[1:]), fill, x.dtype)
                out[:n] = x
                return jnp.asarray(out)
            valid = jnp.asarray(np.arange(pad) < n)
            self._key, sub = jax.random.split(self._key)
            s12, R12, t12, inl, n_in = self._sim3_ransac(
                sub,
                padded(pc1[m1]), padded(pc2[m2]),
                padded(uv1[m1]), padded(uv2[m2]),
                padded(sigma2[oct1[m1]]), padded(sigma2[oct2[m2]]),
                valid,
                self.cfg.fx, self.cfg.fy, self.cfg.cx, self.cfg.cy,
            )
            if int(n_in) < 20:
                continue
            # refine (OptimizeSim3; acceptance >= 20, LoopClosing.cc:389)
            s12, R12, t12, inl, n_in = self._sim3_refine(
                s12, R12, t12,
                padded(pc1[m1]), padded(pc2[m2]),
                padded(uv1[m1]), padded(uv2[m2]),
                padded(1.0 / sigma2[oct1[m1]]), padded(1.0 / sigma2[oct2[m2]]),
                valid,
                self.cfg.fx, self.cfg.fy, self.cfg.cx, self.cfg.cy,
            )
            if int(n_in) < self.cfg.place.sim3_min_inliers:
                continue
            s12 = float(s12)
            R12 = np.asarray(R12)
            t12 = np.asarray(t12)
            # corrected current pose: Scw = S1_2 * S2_w  (:341-344)
            S2w = (1.0, self.map.kf_R[int(kc)], self.map.kf_t[int(kc)])
            scw = _sim3_mul((s12, R12, t12), S2w)

            # gather loop map points (candidate + neighbors, :346-366)
            loop_kfs = [int(kc)] + [int(x) for x in self.map.covisible_keyframes(int(kc))]
            loop_mps = self.map.kf_mp[np.asarray(loop_kfs, np.int64)]
            loop_mps = np.unique(loop_mps[loop_mps >= 0])
            loop_mps = loop_mps[self.map.mp_valid[loop_mps]]

            # SearchByProjection with Scw (:368-389 via ORBmatcher.cc:295-412)
            matched = self._project_match_scw(k, scw, loop_mps, radius_th=10.0)
            total = int((matched >= 0).sum())
            if total >= self.cfg.place.loop_min_matches:
                return int(kc), scw, matched
        return None

    def _project_match_scw(self, k: int, scw, loop_mps: np.ndarray, radius_th: float):
        """Project loop MPs into KF k under the Sim3 Scw; returns [N]
        feat->loop_mp (-1) (SearchByProjection(KF, Scw, ...))."""
        s, R, t = scw
        # fold scale into a rigid view for the matcher: x_c = s R x + t; the
        # fuse matcher expects (R, t) with unit scale, so pre-scale
        view = KFView(
            xy=jnp.asarray(self.map.kf_xy[k]),
            ur=jnp.asarray(self.map.kf_ur[k]),
            depth=jnp.asarray(self.map.kf_depth[k]),
            octave=jnp.asarray(self.map.kf_octave[k]),
            desc=jnp.asarray(self.map.kf_desc[k]),
            valid=jnp.asarray(self.map.kf_feat_valid[k]),
            R=jnp.asarray((s * R).astype(np.float32)),
            t=jnp.asarray(t.astype(np.float32)),
        )
        P = 4096
        out = np.full(self.cfg.orb.n_features, -1, np.int64)
        dev = []
        for s0 in range(0, len(loop_mps), P):
            sub = loop_mps[s0 : s0 + P]
            pad = P - len(sub)
            sel = np.concatenate([sub, np.zeros(pad, np.int64)])
            valid = np.concatenate([np.ones(len(sub), bool), np.zeros(pad, bool)])
            best_feat, accept, dist = self._fuse_fn(
                self.cam, view,
                jnp.asarray(self.map.mp_pos[sel]),
                jnp.asarray(self.map.mp_normal[sel]),
                jnp.asarray(self.map.mp_min_dist[sel]),
                jnp.asarray(self.map.mp_max_dist[sel]),
                jnp.asarray(self.map.mp_desc[sel]),
                jnp.asarray(valid),
                radius_th=radius_th,
            )
            dev.append((sel, accept, best_feat))
        pulled = jax.device_get([(a, b) for _, a, b in dev])
        for (sel, _, _), (accept, best_feat) in zip(dev, pulled):
            for i in np.nonzero(accept)[0]:
                out[best_feat[i]] = sel[i]
        return out

    # ------------------------------------------------------------------
    def _correct_loop(self, k: int, loop_kf: int, scw, matched_feat_mp: np.ndarray):
        """CorrectLoop (:421-614). Caller holds the map lock and has already
        aborted any in-flight global BA."""
        if self.local_mapper is not None:
            self.local_mapper.process_pending()

        s_cw, R_cw, t_cw = scw
        # corrected Sim3 for the covis group (:461-535)
        group = [k] + [int(x) for x in self.map.covisible_keyframes(k)]
        T_kw_old = (1.0, self.map.kf_R[k].copy(), self.map.kf_t[k].copy())
        corrected: Dict[int, Tuple[float, np.ndarray, np.ndarray]] = {}
        old_poses: Dict[int, Tuple[float, np.ndarray, np.ndarray]] = {}
        for ki in group:
            S_iw_old = (1.0, self.map.kf_R[ki].copy(), self.map.kf_t[ki].copy())
            old_poses[ki] = S_iw_old
            if ki == k:
                corrected[ki] = scw
            else:
                # S_ik = S_iw_old * S_wk_old ; corrected = S_ik * Scw
                S_ik = _sim3_mul(S_iw_old, _sim3_inv(*T_kw_old))
                corrected[ki] = _sim3_mul(S_ik, scw)

        # remap group map points + set corrected poses (:470-535). Record
        # which group KF corrected each point (mnCorrectedByKF /
        # mnCorrectedReference, LoopClosing.cc:489-492) — the essential-graph
        # write-back must un-project these through the CORRECTED pose of that
        # KF, not their reference KF's pre-correction pose
        # (Optimizer.cc:1017-1032).
        moved_by: Dict[int, int] = {}
        for ki in group:
            sc, Rc, tc = corrected[ki]
            so, Ro, to = old_poses[ki]
            mp = self.map.kf_mp[ki]
            ids = mp[mp >= 0]
            ids = ids[self.map.mp_valid[ids]]
            fresh = [m for m in ids if m not in moved_by]
            if fresh:
                fresh = np.asarray(fresh)
                pw = self.map.mp_pos[fresh]
                # p' = S_iw_corr^-1 ( S_iw_old (p) )
                pc = so * pw @ Ro.T + to
                sci, Rci, tci = _sim3_inv(sc, Rc, tc)
                pw_new = sci * pc @ Rci.T + tci
                self.map.mp_pos[fresh] = pw_new.astype(np.float32)
                for m in fresh:
                    moved_by[int(m)] = ki
            # pose: scale folded into translation: Tiw = [R, t/s] (:523-529)
            self.map.kf_R[ki] = Rc.astype(np.float32)
            self.map.kf_t[ki] = (tc / sc).astype(np.float32)

        # loop fusion: replace current-KF features' points with loop points
        # (:537-561)
        for f in np.nonzero(matched_feat_mp >= 0)[0]:
            m_loop = int(matched_feat_mp[f])
            if not self.map.mp_valid[m_loop]:
                continue
            cur = int(self.map.kf_mp[k, f])
            if cur >= 0 and self.map.mp_valid[cur]:
                self.map.replace_map_point(cur, m_loop)
            else:
                n = self.map.mp_obs_n[m_loop]
                if (self.map.mp_obs_kf[m_loop, :n] == k).any():
                    continue  # already bound at another feature of k
                self.map.kf_mp[k, f] = m_loop
                self.map._add_observation(m_loop, k, int(f))

        # SearchAndFuse: project loop MPs into corrected group KFs (:616-643)
        loop_kfs = [loop_kf] + [int(x) for x in self.map.covisible_keyframes(loop_kf)]
        loop_mps = self.map.kf_mp[np.asarray(loop_kfs, np.int64)]
        loop_mps = np.unique(loop_mps[loop_mps >= 0])
        loop_mps = loop_mps[self.map.mp_valid[loop_mps]]
        if self.local_mapper is not None:
            for ki in group:
                self.local_mapper._fuse_points_into(loop_mps, ki)

        # refresh covisibility for the group
        for ki in group:
            self.map.update_connections(ki)

        # essential-graph optimization (:589-599 -> Optimizer.cc:784-1048)
        self.loop_edges.setdefault(k, set()).add(loop_kf)
        self.loop_edges.setdefault(loop_kf, set()).add(k)
        self._optimize_essential_graph(k, loop_kf, corrected, old_poses, moved_by)

        # full global BA (RunGlobalBundleAdjustment, :674-779): background
        # thread in async mode (LoopClosing.cc:604-608), inline otherwise
        if self.async_mode:
            import threading as _threading

            idx = self.full_ba_idx
            self.gba_thread = _threading.Thread(
                target=self._gba_entry, args=(idx,), daemon=True
            )
            self.gba_thread.start()
        else:
            self._run_global_ba(idx=self.full_ba_idx)

        self.last_loop_kf = k
        self.loop_closed_flag = True
        self.n_loops += 1
        self.map.big_change_idx += 1
        self.map.write_epoch += 1

    # ------------------------------------------------------------------
    def _optimize_essential_graph(self, k, loop_kf, corrected, old_poses,
                                  moved_by: Optional[Dict[int, int]] = None):
        """Assemble the essential graph (spanning tree + covis >= 100 + loop
        edges, Optimizer.cc:809-988) and solve with the PCG pose-graph LM.

        `moved_by` maps point id -> the group KF whose loop correction already
        moved it (mnCorrectedByKF semantics); those points are un-projected
        through that KF's CORRECTED entry pose, all others through their
        reference KF's entry pose (Optimizer.cc:1017-1047)."""
        moved_by = moved_by or {}
        kfs = np.nonzero(self.map.kf_valid)[0]
        if len(kfs) < 3:
            return
        K = len(kfs)
        idx_of = {int(kf): i for i, kf in enumerate(kfs)}

        s_arr = np.ones(K, np.float32)
        R_arr = np.zeros((K, 3, 3), np.float32)
        t_arr = np.zeros((K, 3), np.float32)
        for kf, i in idx_of.items():
            # corrected group uses the Sim3 with scale (:830-847)
            if kf in corrected:
                sc, Rc, tc = corrected[kf]
                s_arr[i], R_arr[i], t_arr[i] = sc, Rc, tc
            else:
                R_arr[i] = self.map.kf_R[kf]
                t_arr[i] = self.map.kf_t[kf]

        # edge measurements from PRE-correction poses
        def old_pose_of(kf):
            if kf in old_poses:
                return old_poses[kf]
            return (1.0, self.map.kf_R[kf], self.map.kf_t[kf])

        edges = set()
        ei, ej, ms, mR, mt, wts = [], [], [], [], [], []

        def add_edge(a, b):
            key = (min(a, b), max(a, b))
            if key in edges or a == b:
                return
            edges.add(key)
            Sa = old_pose_of(a)
            Sb = old_pose_of(b)
            s_, R_, t_ = _sim3_mul(Sa, _sim3_inv(*Sb))
            ei.append(idx_of[a]); ej.append(idx_of[b])
            ms.append(s_); mR.append(R_); mt.append(t_)
            wts.append(1.0)

        # the loop edge uses the CORRECTED relative pose (it's the new info)
        def add_loop_edge(a, b):
            key = (min(a, b), max(a, b))
            if key in edges:
                return
            edges.add(key)
            Sa = corrected.get(a, old_pose_of(a))
            Sb = corrected.get(b, old_pose_of(b))
            s_, R_, t_ = _sim3_mul(Sa, _sim3_inv(*Sb))
            ei.append(idx_of[a]); ej.append(idx_of[b])
            ms.append(s_); mR.append(R_); mt.append(t_)
            wts.append(1.0)

        add_loop_edge(k, loop_kf)
        for kf in kfs:
            kf = int(kf)
            p = int(self.map.parent[kf])
            if p >= 0 and p in idx_of:
                add_edge(kf, p)
            for le in self.loop_edges.get(kf, ()):
                if le in idx_of:
                    add_loop_edge(kf, le)
            w = self.map.covis[kf]
            for nb in np.nonzero(w >= self.cfg.place.essential_min_weight)[0]:
                if int(nb) in idx_of:
                    add_edge(kf, int(nb))

        if len(ei) < 2:
            return

        fixed = np.zeros(K, bool)
        fixed[idx_of[loop_kf]] = True

        # pad K (vertices) and E (edges) to power-of-two buckets: the jitted
        # solver otherwise compiles one program per exact (K, E) — a fresh
        # multi-second XLA compile at EVERY loop event, taken under the map
        # lock.
        # Pad vertices are identity poses marked fixed; pad edges carry
        # weight 0 (the solver's documented padding convention).
        K_pad = max(32, int(2 ** np.ceil(np.log2(K))))
        E = len(ei)
        E_pad = max(256, int(2 ** np.ceil(np.log2(E))))
        s_p = np.ones(K_pad, np.float32); s_p[:K] = s_arr
        R_p = np.tile(np.eye(3, dtype=np.float32), (K_pad, 1, 1)); R_p[:K] = R_arr
        t_p = np.zeros((K_pad, 3), np.float32); t_p[:K] = t_arr
        fx_p = np.ones(K_pad, bool); fx_p[:K] = fixed
        ei_p = np.zeros(E_pad, np.int32); ei_p[:E] = ei
        ej_p = np.zeros(E_pad, np.int32); ej_p[:E] = ej
        ms_p = np.ones(E_pad, np.float32); ms_p[:E] = ms
        mR_p = np.tile(np.eye(3, dtype=np.float32), (E_pad, 1, 1)); mR_p[:E] = np.stack(mR)
        mt_p = np.zeros((E_pad, 3), np.float32); mt_p[:E] = np.stack(mt)
        w_p = np.zeros(E_pad, np.float32); w_p[:E] = wts

        g = PoseGraph(
            s=jnp.asarray(s_p), R=jnp.asarray(R_p), t=jnp.asarray(t_p),
            edge_i=jnp.asarray(ei_p), edge_j=jnp.asarray(ej_p),
            m_s=jnp.asarray(ms_p), m_R=jnp.asarray(mR_p),
            m_t=jnp.asarray(mt_p), weight=jnp.asarray(w_p),
            fixed=jnp.asarray(fx_p),
        )
        s_new, R_new, t_new = self._essential(g)
        s_new, R_new, t_new = map(np.asarray, (s_new, R_new, t_new))

        # write back: correct points p' = S_new^-1 (S_entry (p)) where S_entry
        # is the pose consistent with the point's CURRENT position — the
        # corrected Sim3 for points already moved by the loop correction
        # (via their correcting KF, mnCorrectedReference), the reference KF's
        # current pose otherwise (Optimizer.cc:1017-1047). s_arr/R_arr/t_arr
        # hold exactly these entry poses (vScw, :813-847). Vectorized.
        mp_ids = np.nonzero(self.map.mp_valid)[0]
        if len(mp_ids):
            lut = np.full(self.map.kf_R.shape[0], -1, np.int64)
            lut[kfs] = np.arange(K)
            ref_kf = self.map.mp_obs_kf[mp_ids, 0]
            rid = np.where(ref_kf >= 0, lut[np.clip(ref_kf, 0, None)], -1)
            if moved_by:
                pos_lut = np.full(self.map.mp_pos.shape[0], -1, np.int64)
                pos_lut[mp_ids] = np.arange(len(mp_ids))
                mv_ids = np.fromiter(moved_by.keys(), np.int64, len(moved_by))
                mv_kf = np.fromiter(moved_by.values(), np.int64, len(moved_by))
                p = pos_lut[mv_ids]
                sel = p >= 0
                rid[p[sel]] = lut[mv_kf[sel]]
            okm = rid >= 0
            ids = mp_ids[okm]
            r = rid[okm]
            pw = self.map.mp_pos[ids]
            pc = s_arr[r, None] * np.einsum("nij,nj->ni", R_arr[r], pw) + t_arr[r]
            pw_new = (1.0 / s_new[r])[:, None] * np.einsum(
                "nji,nj->ni", R_new[r], pc - t_new[r]
            )
            self.map.mp_pos[ids] = pw_new.astype(np.float32)

        for kf, i in idx_of.items():
            self.map.kf_R[kf] = R_new[i].astype(np.float32)
            self.map.kf_t[kf] = (t_new[i] / s_new[i]).astype(np.float32)
        # refresh derived point state
        self.map.update_point_stats(mp_ids)

    # ------------------------------------------------------------------
    def _gba_entry(self, idx: int):
        """Ephemeral GBA thread body (LoopClosing::RunGlobalBundleAdjustment,
        spawned at LoopClosing.cc:604-608)."""
        self.running_gba = True
        try:
            self._run_global_ba(idx=idx)
        finally:
            self.running_gba = False

    def _run_global_ba(self, idx: int):
        """Full bundle adjustment over ALL keyframes and map points
        (RunGlobalBundleAdjustment, LoopClosing.cc:674-779 ->
        Optimizer::BundleAdjustment, Optimizer.cc:51-240): KF0 fixed for
        gauge, every other camera and every point free. The matrix-free
        Schur-PCG LM runs one host-driven iteration at a time so mbStopGBA
        (self.stop_gba) aborts between iterations; the write-back is dropped
        when a newer loop superseded this run (mnFullBAIdx), and keyframes /
        points created while the solve was in flight are corrected through
        the spanning tree (LoopClosing.cc:706-766)."""
        from ..optim.assemble import assemble_ba_problem, global_problem_shapes
        from ..optim.ba_cg import make_gba_iteration, make_lm_chunk_pq

        with self.map.lock:
            kfs = np.nonzero(self.map.kf_valid)[0]
            mp = np.nonzero(self.map.mp_valid)[0]
            mp = mp[self.map.mp_obs_n[mp] > 0]
            if len(kfs) < 3 or len(mp) < 32:
                return
            n_obs = int(np.count_nonzero(self.map.mp_obs_kf[mp] >= 0))
            C_pad, P_pad, O_pad = global_problem_shapes(len(kfs), len(mp), n_obs)
            # PQ/RCS layout when the camera count allows it (single-device
            # path): the dense reduced camera system
            # (optim/ba_cg._cg_lm_step_rcs) replaces the flat layout's
            # segment-sum scatters. Observations beyond
            # global_ba_obs_per_point per point are dropped from GBA only — a
            # documented divergence from Optimizer.cc:51-240, which uses all
            # edges (orbit-scale points carry <= ~10 observers).
            Qg = self.cfg.optim.global_ba_obs_per_point
            use_rcs = self.mesh is None and C_pad <= 128
            cam_free = kfs != 0  # gauge: first KF pinned (Optimizer.cc:104)
            if use_rcs:
                prob, _, _, _ = assemble_ba_problem(
                    self.map, kfs, cam_free, mp, C_pad, P_pad, O_pad=None,
                    Q_pad=Qg, obs_per_point_cap=Qg, pq_layout=True,
                    device=False,
                )
            else:
                if self.mesh is not None:
                    n_dev = self.mesh.devices.size
                    P_pad = ((P_pad + n_dev - 1) // n_dev) * n_dev
                prob, _, _, _ = assemble_ba_problem(
                    self.map, kfs, cam_free, mp, C_pad, P_pad, O_pad,
                    device=False,
                )
        if self.mesh is not None:
            # sharded path: points/obs over the 'map' axis; camera updates
            # computed redundantly per device (parallel/dist_ba.py).
            # shard_ba_problem re-orders the HOST arrays — feeding it the
            # host-assembled problem directly avoids a full upload+download
            # round trip of the largest problem in the system
            from ..parallel.dist_ba import (
                device_put_sharded_problem,
                make_dist_gba_iteration,
                shard_ba_problem,
            )

            n_dev = self.mesh.devices.size
            prob = device_put_sharded_problem(
                shard_ba_problem(prob, n_dev), self.mesh
            )
            if self._dist_step is None:
                self._dist_step = make_dist_gba_iteration(
                    self.cfg.optim, self.mesh, self.cam
                )
            step = lambda cam, prob, R, t, xw, lam, active, hub: self._dist_step(
                prob, R, t, xw, lam, active, hub
            )
        elif use_rcs:
            from ..optim.assemble import upload_problem

            prob = upload_problem(prob)  # uploads outside the map lock
            chunk_fn = make_lm_chunk_pq(self.cfg.optim, 1)  # 1 LM iter/call

            def step(cam, prob, R, t, xw, lam, active, hub):
                R, t, xw, lam, _inl = chunk_fn(cam, prob, R, t, xw, lam,
                                               active, hub)
                return R, t, xw, lam, None
        else:
            from ..optim.assemble import upload_problem

            prob = upload_problem(prob)  # uploads outside the map lock
            step = make_gba_iteration(self.cfg.optim)
        R, t, xw = prob.R, prob.t, prob.xw
        lam = jnp.float32(self.cfg.optim.lm_lambda_init)
        active = prob.obs_valid.astype(jnp.float32)
        self.gba_iter_times: List[float] = []
        import time as _time
        # iterations are dispatched in chunks with one host sync per chunk;
        # the abort check (mbStopGBA, LoopClosing.cc:674-779) coarsens to
        # the chunk boundary.
        n_total = self.cfg.optim.global_ba_iters
        # small chunks (2 iters) instead of half the solve per dispatch
        # burst: each burst occupies the in-order device stream, and the
        # pacer can only protect the tracking lane BETWEEN bursts
        chunk = 2 if self.async_mode else max(1, (n_total + 1) // 2)
        pacer = getattr(self, "pacer", None)
        done = 0
        while done < n_total:
            if self.stop_gba:
                return  # aborted: discard (the superseding loop re-runs GBA)
            if pacer is not None and self.async_mode:
                pacer.yield_point()
            k = min(chunk, n_total - done)
            t0 = _time.perf_counter()
            for _ in range(k):
                R, t, xw, lam, _cost = step(self.cam, prob, R, t, xw, lam,
                                            active, jnp.bool_(True))
            jax.block_until_ready(R)
            dt = (_time.perf_counter() - t0) / k
            self.gba_iter_times.extend([dt] * k)
            done += k

        R, t, xw = jax.device_get((R, t, xw))
        with self.map.lock:
            if idx != self.full_ba_idx or self.stop_gba:
                return  # stale: a newer loop correction owns the map now
            self._gba_writeback(kfs, cam_free, mp, R, t, xw)

    def _gba_writeback(self, kfs, cam_free, mp, Rn, tn, xwn):
        """Merge GBA results into the (possibly advanced) map: optimized KFs
        and points directly; KFs created during the solve via spanning-tree
        propagation (Tchild_new = Tchild * Tparent^-1 * Tparent_new); their
        points via their reference KF (LoopClosing.cc:706-766 mTcwBefGBA /
        mTcwGBA semantics). Caller holds the map lock."""
        m = self.map
        nk = len(kfs)
        in_prob_kf = np.zeros(m.kf_capacity, bool)
        in_prob_kf[kfs] = True
        bef_R = m.kf_R.copy()
        bef_t = m.kf_t.copy()

        wr = m.kf_valid[kfs] & cam_free
        m.kf_R[kfs[wr]] = Rn[:nk][wr]
        m.kf_t[kfs[wr]] = tn[:nk][wr]

        # spanning-tree propagation to keyframes not in the problem
        from collections import deque as _dq
        todo = _dq(int(x) for x in kfs)
        seen = set(int(x) for x in kfs)
        while todo:
            p = todo.popleft()
            for c in m.children.get(p, ()):
                if c in seen:
                    continue
                seen.add(c)
                if m.kf_valid[c] and not in_prob_kf[c]:
                    T_c = _pose_mat(bef_R[c], bef_t[c])
                    T_p = _pose_mat(bef_R[p], bef_t[p])
                    T_pn = _pose_mat(m.kf_R[p], m.kf_t[p])
                    T_cn = T_c @ np.linalg.inv(T_p) @ T_pn
                    m.kf_R[c] = T_cn[:3, :3].astype(np.float32)
                    m.kf_t[c] = T_cn[:3, 3].astype(np.float32)
                todo.append(c)

        in_prob_mp = np.zeros(m.mp_capacity, bool)
        in_prob_mp[mp] = True
        alive = m.mp_valid[mp]
        m.mp_pos[mp[alive]] = xwn[: len(mp)][alive]
        # points created during the solve: preserve their camera-frame
        # coordinates w.r.t. their reference KF across its correction
        others = np.nonzero(m.mp_valid & ~in_prob_mp)[0]
        if len(others):
            r = m.mp_obs_kf[others, 0]
            ok = (r >= 0) & m.kf_valid[np.clip(r, 0, None)]
            others, r = others[ok], r[ok]
            pw = m.mp_pos[others]
            pc = np.einsum("nij,nj->ni", bef_R[r], pw) + bef_t[r]
            pw_new = np.einsum("nji,nj->ni", m.kf_R[r], pc - m.kf_t[r])
            m.mp_pos[others] = pw_new.astype(np.float32)
        m.update_point_stats(np.nonzero(m.mp_valid)[0])
        m.write_epoch += 1
