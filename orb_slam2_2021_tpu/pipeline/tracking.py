"""Tracking front-end — host orchestration of the per-frame hot path.

Mirrors the reference's Tracking thread (/root/reference/src/Tracking.cc):
state machine (NOT_INITIALIZED / OK / LOST, Tracking.h:84-91), stereo
initialization (Tracking.cc:530-582), motion-model tracking with
reference-KF fallback (Tracking.cc:777-948), local-map tracking
(Tracking.cc:950-994), keyframe decision + creation (Tracking.cc:996-1162),
and per-frame relative-pose bookkeeping for trajectory export
(Tracking.cc:509-526: Tcr = Tcw * Trw^-1 so later KF corrections propagate).

Device work happens in the jitted steps from track_steps; this class owns the
numpy-side bindings (feature -> map-point ids) and the map store.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..frontend.frame import Frame
from ..geometry.camera import PinholeCamera
from ..mapping.map_store import MapStore
from .track_steps import (
    make_bow_track_fn,
    make_frame_pack_fn,
    make_fused_track_packed_fn,
    make_local_track_fn,
    make_motion_track_fn,
)


class TrackState(Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


class LastFrame:
    """Device-resident stash of the previous frame.

    The hot fused tracking path consumes the previous frame's descriptors /
    octaves / angles directly as device arrays (`.kp`), so the steady-state
    tracking lane never copies feature data off the device. Host-side numpy
    views (keys: xy, ur, depth, angle, octave, kp_valid, desc, response) are
    materialized lazily — in TWO packed pulls — only when a slow path
    (localization VO spawn, mono, relocalization, viz) asks for them: each
    device->host copy is a host sync, so the stash is transfer-count-frugal
    rather than eagerly pulled."""

    def __init__(self, tracker, frame, frame_id, bind, pose, host=None):
        self._tr = tracker
        self._frame = frame
        self.kp = frame.kp
        self.ur_dev = frame.u_right
        self.depth_dev = frame.depth
        self._data = {"frame_id": frame_id, "mp": bind, "pose": pose}
        self._host = host

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __getitem__(self, key):
        if key in self._data:
            return self._data[key]
        if self._host is None:
            self._host = self._tr._frame_host_arrays(self._frame)
        return self._host[key]


@dataclass
class FrameRecord:
    """Per-frame trajectory bookkeeping (mlRelativeFramePoses et al.)."""
    frame_id: int
    timestamp: float
    ref_kf: int
    T_cr: np.ndarray  # [4, 4] pose relative to reference KF: Tcw * Twr
    lost: bool


class Tracking:
    def __init__(self, cfg: SlamConfig, map_store: MapStore, local_mapper=None,
                 place_rec=None):
        self.cfg = cfg
        self.map = map_store
        self.local_mapper = local_mapper  # set by System; None = no mapping
        self.place = place_rec            # PlaceRecognition bundle or None
        self.cam = PinholeCamera.create(
            cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.bf, cfg.width, cfg.height
        )
        self.state = TrackState.NO_IMAGES_YET
        self.velocity: Optional[np.ndarray] = None  # [4,4] Tcl (cur<-last)
        self.last_pose: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.last_frame_data = None   # dict of numpy arrays incl. mp bindings
        self.ref_kf: int = -1
        self.last_kf_frame_id: int = -1
        self.records: List[FrameRecord] = []
        self.n_inliers_last = 0
        self.only_tracking = False  # localization mode (mbOnlyTracking)
        self.vo_mode = False        # mbVO: tracking mostly temporal VO points
        self.last_reloc_frame_id = -(1 << 30)  # mnLastRelocFrameId
        self.request_system_reset = None  # set by System: reset-on-early-loss
        self.sensor = "stereo"      # "stereo" | "rgbd" | "mono"
        self.last_metrics: Optional[dict] = None  # per-frame observability
        self._mono_ref = None       # reference frame data for mono init

        self._motion_fn = make_motion_track_fn(cfg)
        self._bow_fn = make_bow_track_fn(cfg)
        self._local_fn = make_local_track_fn(cfg)
        self._fused_fn = make_fused_track_packed_fn(cfg)
        self._pack_fn = make_frame_pack_fn(cfg)

        # single-slot host-view cache for the current frame (2 packed pulls)
        self._fh = None
        # device-cached local-map snapshot (re-uploaded only when the local
        # keyframe set or the map content changes, not per frame)
        self._snap_key = None
        self._snap_dev = None
        self._snap_ids = None
        self._id2slot = None
        # (tracked_close, untracked_close) computed on device by the fused
        # step; None on frames that took a slow path
        self._kf_close_counts = None
        # current frame's slot -> map-point-id bindings (-1 = unbound)
        self._bind_cur = np.full(cfg.orb.n_features, -1, np.int64)
        # reference-KF pose snapshot taken at last-frame stash time: when a
        # loop correction / essential graph / GBA write-back moves that KF,
        # the cached last_pose must be rebased by the same delta before the
        # next frame (see _rebase_on_map_correction)
        self._ref_anchor = None
        # fine-grained section timers (seconds, cumulative) for profiling the
        # transfer-bound hot path; read by scripts/profile_e2e.py
        import collections as _collections
        self.sect_times = _collections.defaultdict(float)
        self.sect_counts = _collections.defaultdict(int)
        # interleaved next-frame prefetch (System.track_stereo_prefetch):
        # _track_fused invokes the callback between its dispatch and readback
        self.prefetch_cb = None
        self.prefetch_result = None

    # ------------------------------------------------------------------
    def track_stereo_frame(self, frame: Frame, frame_id: int, timestamp: float):
        """Main per-frame entry (Tracking::Track, Tracking.cc:287-528).

        `frame` is the already-built device Frame. Returns (R, t) Tcw or None
        while not initialized / lost.
        """
        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            n_kf0 = self.map.n_kf
            ok = self._stereo_initialize(frame, frame_id, timestamp)
            self.state = TrackState.OK if ok else TrackState.NOT_INITIALIZED
            self._set_metrics(frame_id, timestamp, self.map.n_kf > n_kf0)
            return self.last_pose if ok else None

        self._rebase_on_map_correction()
        n_kf0 = self.map.n_kf
        ok = False
        local_done = False
        self._kf_close_counts = None
        if not self.only_tracking:
            # normal SLAM mode (Tracking.cc:317-341)
            if self.state == TrackState.OK:
                if self.velocity is None or frame_id < self.last_reloc_frame_id + 2:
                    ok = self._track_reference_kf(frame)
                else:
                    # hot path: motion model + local map in ONE device program
                    fused = self._track_fused(frame, frame_id)
                    if fused is None:
                        # motion tracking failed -> reference-KF fallback
                        ok = self._track_reference_kf(frame)
                    else:
                        ok = fused
                        local_done = True
            else:
                ok = self._relocalize(frame, frame_id)
        else:
            # localization mode (Tracking.cc:343-412)
            if self.state == TrackState.LOST:
                ok = self._relocalize(frame, frame_id)
                if ok:
                    self.vo_mode = False
            elif not self.vo_mode:
                # enough real map matches in the last frame
                if self.velocity is not None:
                    ok = self._track_motion_model(frame)
                else:
                    ok = self._track_reference_kf(frame)
            else:
                # mbVO: mostly temporal points last frame — run BOTH the
                # motion model and relocalization; prefer the reloc solution
                # (Tracking.cc:364-410)
                ok_mm = False
                mm_pose = mm_bind = None
                if self.velocity is not None:
                    ok_mm = self._track_motion_model(frame)
                    if ok_mm:
                        mm_pose = self.last_pose
                        mm_bind = self._bind_cur.copy()
                ok_reloc = self._relocalize(frame, frame_id)
                if ok_mm and not ok_reloc:
                    self.last_pose = mm_pose
                    self._bind_cur = mm_bind
                    if self.vo_mode:
                        # IncreaseFound for the real map points still tracked
                        # (Tracking.cc:393-403)
                        b = self._bind_cur
                        self.map.increment_found(b[b >= 0])
                elif ok_reloc:
                    self.vo_mode = False
                ok = ok_reloc or ok_mm

        if ok and not local_done and not (self.only_tracking and self.vo_mode):
            # mbVO means too few map matches to retrieve a local map; skip
            # TrackLocalMap until relocalization succeeds (Tracking.cc:419-426)
            ok = self._track_local_map(frame, frame_id)

        return self._finish_frame(frame, frame_id, timestamp, ok, n_kf0)

    def _rebase_on_map_correction(self) -> bool:
        """Rebase the tracker's cached pose state after a map correction.

        The loop closer / essential graph / GBA move keyframe poses in place
        (CorrectLoop, /root/reference/src/LoopClosing.cc:461-535;
        RunGlobalBundleAdjustment, :706-766), but the tracker's last_pose /
        last-frame pose still live in PRE-correction coordinates. The
        reference survives this only because its window-free
        TrackReferenceKeyFrame usually re-converges from the stale pose; when
        it does not, the tracker goes LOST and relocalization in a
        self-similar scene can teleport it (the r3 orbit failure: the frame
        after the loop fired went LOST and re-localized 12.5 m off-map,
        VERDICT r3 Missing #1). Snapshot semantics make the fix exact: the
        last frame's pose RELATIVE to its reference keyframe is invariant
        under a correction, so when the anchor pose changed, re-anchor:
            T_lc_w_new = (T_lc_w_old @ T_rw_old^-1) @ T_rw_new .
        The relative motion model (velocity = T_cur T_prev^-1) is invariant
        under this right-multiplication and needs no update. Returns True
        when a rebase happened."""
        if self.last_pose is None or self._ref_anchor is None:
            return False
        k, R_old, t_old = self._ref_anchor
        T_new = self.map.resolve_kf_pose(int(k)).astype(np.float64)
        if (np.abs(T_new[:3, :3] - R_old).max() < 1e-5
                and np.abs(T_new[:3, 3] - t_old).max() < 1e-5):
            return False
        T_old = np.eye(4)
        T_old[:3, :3] = R_old
        T_old[:3, 3] = t_old
        D = np.linalg.inv(T_old) @ T_new

        def reb(pose):
            R, t = pose
            T = np.eye(4)
            T[:3, :3] = np.asarray(R, np.float64)
            T[:3, 3] = np.asarray(t, np.float64)
            T = T @ D
            return (T[:3, :3].astype(np.float32), T[:3, 3].astype(np.float32))

        self.last_pose = reb(self.last_pose)
        if (self.last_frame_data is not None
                and self.last_frame_data.get("pose") is not None):
            self.last_frame_data._data["pose"] = reb(self.last_frame_data["pose"])
        self._ref_anchor = (int(k), T_new[:3, :3].copy(), T_new[:3, 3].copy())
        return True

    def _finish_frame(self, frame: Frame, frame_id: int, timestamp: float,
                      ok: bool, n_kf0: int):
        """Shared per-frame tail (Tracking.cc:430-526): state transition,
        motion model, keyframe decision, trajectory record, last-frame stash,
        metrics."""
        if ok:
            self.state = TrackState.OK
            self._update_motion_model()
            if not self.only_tracking and self._need_new_keyframe(frame, frame_id):
                self._create_new_keyframe(frame, frame_id, timestamp)
        else:
            self.state = TrackState.LOST
            self.velocity = None
            # don't let the last successful frame's inlier count leak into
            # LOST-frame telemetry (VERDICT r3 Weak #7: n_inliers froze at its
            # last value through 45-frame LOST stretches)
            self.n_inliers_last = 0
            # reset if the camera got lost soon after initialization
            # (Tracking.cc:493-501): the map is too small to relocalize in
            if (not self.only_tracking and self.map.n_kf <= 5
                    and self.request_system_reset is not None):
                self.request_system_reset()
                self._set_metrics(frame_id, timestamp, False)
                return None

        self._record_frame(frame_id, timestamp, lost=not ok)
        self._stash_last_frame(frame, frame_id)
        self._set_metrics(frame_id, timestamp, self.map.n_kf > n_kf0)
        return self.last_pose if ok else None

    # ------------------------------------------------------------------
    def track_mono_frame(self, frame: Frame, frame_id: int, timestamp: float):
        """Monocular per-frame entry (GrabImageMonocular -> Track)."""
        self.sensor = "mono"
        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            n_kf0 = self.map.n_kf
            ok = self._mono_initialize(frame, frame_id, timestamp)
            self.state = TrackState.OK if ok else TrackState.NOT_INITIALIZED
            self._set_metrics(frame_id, timestamp, self.map.n_kf > n_kf0)
            return self.last_pose if ok else None
        return self.track_stereo_frame(frame, frame_id, timestamp)

    def _mono_initialize(self, frame: Frame, frame_id: int, timestamp: float) -> bool:
        """MonocularInitialization (Tracking.cc:584-657) +
        CreateInitialMapMonocular (:659-758): window-matched two-view
        H/F bootstrap, triangulated map, median-depth normalization."""
        import jax as _jax
        from ..frontend.matchers import match_bruteforce_desc
        from ..solvers.two_view import make_two_view_init

        n_valid = int(np.asarray(frame.kp.valid).sum())
        if self._mono_ref is None:
            if n_valid > 100:
                self._mono_ref = {
                    "xy": np.asarray(frame.kp.xy),
                    "desc": np.asarray(frame.kp.desc),
                    "angle": np.asarray(frame.kp.angle),
                    "octave": np.asarray(frame.kp.octave),
                    "valid": np.asarray(frame.kp.valid),
                    "frame_id": frame_id,
                    "timestamp": timestamp,
                }
            return False
        if n_valid <= 100:
            self._mono_ref = None
            return False
        ref = self._mono_ref
        # SearchForInitialization (ORBmatcher.cc:414-534): descriptor match
        # with ratio 0.9 restricted to a 100 px window
        best_b, accept, dist = match_bruteforce_desc(
            jnp.asarray(ref["desc"]), jnp.asarray(ref["valid"]), jnp.asarray(ref["angle"]),
            frame.kp.desc, frame.kp.valid, frame.kp.angle,
            nn_ratio=0.9, th=50,
        )
        accept = np.asarray(accept)
        best_b = np.asarray(best_b)
        cur_xy = np.asarray(frame.kp.xy)
        win_ok = (
            np.abs(cur_xy[best_b] - ref["xy"]).max(axis=1) < 100.0
        )
        accept = accept & win_ok
        if accept.sum() < 100:
            self._mono_ref = None
            return False

        p1 = np.where(accept[:, None], ref["xy"], 0.0).astype(np.float32)
        p2 = cur_xy[best_b].astype(np.float32)
        fn = make_two_view_init(256)
        res = fn(
            _jax.random.PRNGKey(frame_id), jnp.asarray(p1), jnp.asarray(p2),
            jnp.asarray(accept), self.cfg.fx, self.cfg.fy, self.cfg.cx, self.cfg.cy,
        )
        if not bool(res.ok):
            return False
        good = np.asarray(res.good)
        if good.sum() < 80:
            return False
        R2 = np.asarray(res.R)
        t2 = np.asarray(res.t)
        pts = np.asarray(res.points)

        # median-depth normalization (CreateInitialMapMonocular :731-757)
        med = float(np.median(pts[good][:, 2]))
        if med <= 0:
            return False
        inv_med = 1.0 / med
        pts = pts * inv_med
        t2 = t2 * inv_med

        # KF0 (reference frame, identity) + KF1 (current)
        N = frame.n
        bind0 = np.full(N, -1, np.int64)
        bind1 = np.full(N, -1, np.int64)
        gi = np.nonzero(good)[0]
        ids = self.map.add_map_points_batch(
            pts[gi].astype(np.float32), ref["desc"][gi], first_kf=0
        )
        bind0[gi] = ids
        bind1[best_b[gi]] = ids
        neg = np.full(N, -1.0, np.float32)
        k0 = self.map.add_keyframe(
            np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
            ref["xy"], neg, neg, ref["octave"], ref["angle"], ref["desc"],
            ref["valid"], bind0, ref["frame_id"], ref["timestamp"],
        )
        k1 = self.map.add_keyframe(
            R2.astype(np.float32), t2.astype(np.float32),
            cur_xy, np.asarray(frame.u_right), np.asarray(frame.depth),
            np.asarray(frame.kp.octave), np.asarray(frame.kp.angle),
            np.asarray(frame.kp.desc), np.asarray(frame.kp.valid),
            bind1, frame_id, timestamp,
        )
        self.map.update_point_stats(ids)
        self.ref_kf = k1
        self.last_kf_frame_id = frame_id
        self.last_pose = (R2.astype(np.float32), t2.astype(np.float32))
        self.velocity = None
        self._bind_cur = bind1
        self._record_frame(frame_id, timestamp, lost=False)
        self._stash_last_frame(frame, frame_id)
        words0 = None
        if self.place is not None:
            words0 = np.asarray(self.place.transform(jnp.asarray(ref["desc"]), jnp.asarray(ref["valid"])))
        words1 = self._compute_words(frame)
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(k0, words0)
            self.local_mapper.insert_keyframe(k1, words1, frame=frame)
        self._mono_ref = None
        return True

    def _stereo_initialize(self, frame: Frame, frame_id: int, timestamp: float) -> bool:
        """StereoInitialization (Tracking.cc:530-582): need >= 500 features;
        create a map point for every feature with positive depth."""
        host = self._frame_host_arrays(frame)
        kp_valid = host["kp_valid"]
        depth = host["depth"]
        if kp_valid.sum() < 500 * min(1.0, self.cfg.orb.n_features / 2000.0):
            return False
        R = np.eye(3, dtype=np.float32)
        t = np.zeros(3, dtype=np.float32)

        good = kp_valid & (depth > 0)
        if good.sum() < 100:
            return False

        xy = host["xy"]
        desc = host["desc"]
        # unproject at identity pose: world == camera
        z = depth[good]
        x = (xy[good, 0] - self.cfg.cx) * z / self.cfg.fx
        y = (xy[good, 1] - self.cfg.cy) * z / self.cfg.fy
        pos = np.stack([x, y, z], axis=1).astype(np.float32)

        ids = self.map.add_map_points_batch(pos, desc[good], first_kf=0)
        mp_bind = np.full(frame.n, -1, np.int64)
        mp_bind[np.nonzero(good)[0]] = ids

        k = self.map.add_keyframe(
            R, t,
            xy, host["ur"], depth,
            host["octave"], host["angle"],
            desc, kp_valid, mp_bind, frame_id, timestamp,
        )
        self.map.update_point_stats(ids)
        self.ref_kf = k
        self.last_kf_frame_id = frame_id
        self.last_pose = (R, t)
        self.velocity = None
        self._bind_cur = mp_bind
        self._record_frame(frame_id, timestamp, lost=False)
        self._stash_last_frame(frame, frame_id)
        words = self._compute_words(frame)
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(k, words, frame=frame)
        return True

    # ------------------------------------------------------------------
    VO_ID = -2  # marker id for temporal "visual odometry" points

    def _last_landmark_arrays(self):
        """Landmark set carried by the last frame (bound features).

        In localization mode (stereo/RGB-D) this also spawns temporal
        "visual odometry" points from the last frame's depths for features
        without a live map binding — all closer than ThDepth, at least the
        100 closest (UpdateLastFrame, Tracking.cc:821-885). They carry id
        VO_ID so downstream map statistics skip them; like the reference's
        mlpTemporalPoints they live exactly one frame (recreated from the
        next last-frame each time, Tracking.cc:465-475)."""
        lf = self.last_frame_data
        # normalize stale VO bindings (-2) to unbound; real ids stay
        ids = np.where(lf["mp"] >= 0, lf["mp"], -1)
        live = self.map.resolve_replaced(ids)
        valid = (live >= 0) & self.map.mp_valid[np.clip(live, 0, None)] & lf["kp_valid"]
        sel = np.clip(live, 0, None)
        xw = self.map.mp_pos[sel]
        out_ids = np.where(valid, live, -1)
        if (self.only_tracking and self.sensor != "mono"
                and lf.get("frame_id", -1) != self.last_kf_frame_id):
            depth = lf["depth"]
            cand = np.nonzero((depth > 0) & lf["kp_valid"] & ~valid)[0]
            if len(cand):
                order = cand[np.argsort(depth[cand], kind="stable")]
                th = self.cfg.resolved_depth_th()
                n_close = int((depth[order] < th).sum())
                take = order[: max(min(100, len(order)), n_close)]
                R_l, t_l = lf["pose"]
                z = depth[take]
                xy = lf["xy"]
                xc = np.stack(
                    [
                        (xy[take, 0] - self.cfg.cx) * z / self.cfg.fx,
                        (xy[take, 1] - self.cfg.cy) * z / self.cfg.fy,
                        z,
                    ],
                    axis=1,
                ).astype(np.float32)
                xw = xw.copy()
                xw[take] = (xc - t_l[None]) @ R_l  # R^T (xc - t)
                valid = valid.copy()
                valid[take] = True
                out_ids = out_ids.copy()
                out_ids[take] = self.VO_ID
        return {
            "xw": xw,
            "desc": lf["desc"],
            "octave": lf["octave"],
            "angle": lf["angle"],
            "valid": valid,
            "ids": out_ids,
        }

    def _run_motion_step(self, frame: Frame, R_pred, t_pred, radius: float):
        lm = self._last_landmark_arrays()
        R, t, slot, inlier, n_in, n_matched = self._motion_fn(
            self.cam, frame.kp, frame.u_right,
            jnp.asarray(R_pred), jnp.asarray(t_pred),
            jnp.asarray(lm["xw"]), jnp.asarray(lm["desc"]),
            jnp.asarray(lm["octave"]), jnp.asarray(lm["angle"]),
            jnp.asarray(lm["valid"]),
            jnp.float32(radius),
        )
        return lm, np.asarray(R), np.asarray(t), np.asarray(slot), np.asarray(inlier), int(n_in), int(n_matched)

    def _track_motion_model(self, frame: Frame) -> bool:
        """TrackWithMotionModel (Tracking.cc:887-948) with the reference's
        widened-window retry."""
        R_l, t_l = self.last_pose
        T_pred = self.velocity @ _mat(R_l, t_l)
        R_pred, t_pred = T_pred[:3, :3], T_pred[:3, 3]

        lm, R, t, slot, inlier, n_in, n_matched = self._run_motion_step(
            frame, R_pred, t_pred, self.cfg.tracking.motion_search_radius
        )
        if n_matched < 20:
            lm, R, t, slot, inlier, n_in, n_matched = self._run_motion_step(
                frame, R_pred, t_pred, 2 * self.cfg.tracking.motion_search_radius
            )
            if n_matched < 20:
                return False
        # inliers that are REAL map points (nmatchesMap, Tracking.cc:928-940):
        # VO temporal points count toward the pose but not toward map support
        slot_ok = (slot >= 0) & inlier
        n_map = int((slot_ok & (lm["ids"][np.clip(slot, 0, None)] >= 0)).sum())
        if self.only_tracking:
            # mbVO = too few map matches (Tracking.cc:941-945)
            if n_in < self.cfg.tracking.min_inliers_track:
                return False
            self._apply_matches(lm["ids"], slot, inlier)
            self.last_pose = (R, t)
            self.vo_mode = n_map < 10
            self.n_inliers_last = n_in
            return n_in > 20
        if n_map < self.cfg.tracking.min_inliers_track:
            return False
        self._apply_matches(lm["ids"], slot, inlier)
        self.last_pose = (R, t)
        return True

    def _track_reference_kf(self, frame: Frame) -> bool:
        """TrackReferenceKeyFrame (Tracking.cc:777-819) — WINDOW-FREE
        descriptor matching against the reference KF's landmarks (the
        reference's SearchByBoW, ORBmatcher.cc:165-293: descriptor distance +
        ratio + rotation-histogram gates, no projection window — after a
        motion-model failure the pose prior is by definition bad, so a window
        around it would be weakest exactly when this path runs), then pose
        optimization from the last pose."""
        if self.ref_kf < 0 or self.last_pose is None:
            return False
        k = self.ref_kf
        mp = self.map.kf_mp[k]
        valid = (mp >= 0) & self.map.mp_valid[np.clip(mp, 0, None)]
        if valid.sum() < 15:
            return False
        ids = np.where(valid, mp, -1)
        xw = self.map.mp_pos[np.clip(mp, 0, None)]
        R_l, t_l = self.last_pose
        out = self._bow_fn(
            self.cam, frame.kp, frame.u_right,
            jnp.asarray(R_l), jnp.asarray(t_l),
            jnp.asarray(xw), jnp.asarray(self.map.kf_desc[k]),
            jnp.asarray(self.map.kf_angle[k]), jnp.asarray(valid),
        )
        R, t, slot, inlier, n_in, n_matched = jax.device_get(out)
        if int(n_matched) < 15 or int(n_in) < self.cfg.tracking.min_inliers_track:
            return False
        self._apply_matches(ids, slot, inlier)
        self.last_pose = (R, t)
        return True

    def _feature_scale(self) -> float:
        """Inlier-count thresholds in the reference assume nFeatures=2000
        (arducam.yaml); scale them down for smaller feature budgets the same
        way _stereo_initialize scales its 500-feature gate."""
        return min(1.0, self.cfg.orb.n_features / 2000.0)

    def _relocalize(self, frame: Frame, frame_id: int) -> bool:
        """Relocalization (Tracking.cc:1368-1532): keyframe-database
        candidates -> descriptor matching -> PnP RANSAC -> pose optimization
        with two-stage projection-search escalation. Falls back to
        reference-KF matching when no vocabulary is wired."""
        if self.place is None:
            return self._track_reference_kf(frame)
        if self._relocalize_bow(frame, frame_id):
            return True
        return self._track_reference_kf(frame)

    def _relocalize_bow(self, frame: Frame, frame_id: int) -> bool:
        import jax as _jax
        from ..frontend.matchers import match_bruteforce_desc
        from ..solvers.epnp import make_pnp_ransac

        place = self.place
        words = np.asarray(
            place.transform(frame.kp.desc, frame.kp.valid)
        )
        cands = place.kfdb.detect_reloc_candidates(
            words, lambda x: self.map.covisible_keyframes(x, 10)
        )
        if not cands:
            return False
        n = frame.n
        sigma2 = self.map.scale_factors ** 2
        for kc in cands[:5]:
            kc = int(kc)
            if not self.map.kf_valid[kc]:
                continue
            mp = self.map.kf_mp[kc]
            feat_ok = (mp >= 0) & self.map.mp_valid[np.clip(mp, 0, None)]
            if feat_ok.sum() < 15:
                continue
            best_b, accept, dist = match_bruteforce_desc(
                frame.kp.desc, frame.kp.valid, frame.kp.angle,
                jnp.asarray(self.map.kf_desc[kc]), jnp.asarray(feat_ok),
                jnp.asarray(self.map.kf_angle[kc]),
            )
            accept = np.asarray(accept)
            best_b = np.asarray(best_b)
            if accept.sum() < 15:
                continue
            # PnP RANSAC on matched (world point, frame pixel) pairs
            fidx = np.nonzero(accept)[0]
            ids = mp[best_b[fidx]]
            xw = np.zeros((n, 3), np.float32)
            uv = np.zeros((n, 2), np.float32)
            s2 = np.ones(n, np.float32)
            valid = np.zeros(n, bool)
            xw[fidx] = self.map.mp_pos[ids]
            xy = np.asarray(frame.kp.xy)
            uv[fidx] = xy[fidx]
            s2[fidx] = sigma2[np.asarray(frame.kp.octave)[fidx]]
            valid[fidx] = True
            pnp = make_pnp_ransac(256)
            key = _jax.random.PRNGKey(kc + 17)
            R, t, inl, n_in = pnp(
                key, jnp.asarray(xw), jnp.asarray(uv), jnp.asarray(s2),
                jnp.asarray(valid), self.cfg.fx, self.cfg.fy, self.cfg.cx, self.cfg.cy,
            )
            if int(n_in) < 10:
                continue
            # pose optimization over the matches from the PnP pose, with the
            # reference's two-stage projection-search escalation
            # (Tracking.cc:1468-1516: nGood<50 -> coarse window th=10/ORBdist
            # 100 re-search + re-optimize; 30<nGood<50 -> narrow th=3/64).
            # Our vmapped PnP covers the 300-iteration RANSAC budget in one
            # launch, so the per-candidate 5-iteration rounds collapse into
            # a single pass per candidate.
            lm = {
                "xw": self.map.mp_pos[np.clip(mp, 0, None)],
                "desc": self.map.kf_desc[kc],
                "octave": self.map.kf_octave[kc],
                "angle": self.map.kf_angle[kc],
                "valid": feat_ok,
                "ids": np.where(feat_ok, mp, -1),
            }
            min_good = max(15, int(round(50 * self._feature_scale())))
            r0 = self.cfg.tracking.reloc_search_radius

            def _refine(R_c, t_c, radius):
                Rn, tn, slot, inlier, n_opt, _ = self._motion_fn(
                    self.cam, frame.kp, frame.u_right,
                    jnp.asarray(R_c), jnp.asarray(t_c),
                    jnp.asarray(lm["xw"]), jnp.asarray(lm["desc"]),
                    jnp.asarray(lm["octave"]), jnp.asarray(lm["angle"]),
                    jnp.asarray(lm["valid"]),
                    jnp.float32(radius),
                )
                return (np.asarray(Rn), np.asarray(tn), np.asarray(slot),
                        np.asarray(inlier), int(n_opt))

            Rn, tn, slot, inlier, n_good = _refine(np.asarray(R), np.asarray(t), r0)
            if n_good < 10:
                continue
            if n_good < min_good:
                # coarse-window escalation from the optimized pose
                Rn, tn, slot, inlier, n_good = _refine(Rn, tn, 2.0 * r0)
                if int(round(0.6 * min_good)) <= n_good < min_good:
                    # narrow-window final pass (th=3 analogue)
                    Rn, tn, slot, inlier, n_good = _refine(Rn, tn, 0.4 * r0)
            if n_good < min_good:
                continue
            self._apply_matches(lm["ids"], slot, inlier)
            self.last_pose = (Rn, tn)
            self.ref_kf = kc
            self.velocity = None
            self.last_reloc_frame_id = frame_id
            return True
        return False

    def _apply_matches(self, ids, slot, inlier):
        """Bind current-frame features to map-point ids given matcher slots."""
        bind = np.full(slot.shape[0], -1, np.int64)
        ok = (slot >= 0) & inlier
        bind[ok] = ids[slot[ok]]
        self._bind_cur = bind

    # ------------------------------------------------------------------
    def _frame_host_arrays(self, frame: Frame):
        """Host views of a frame's feature data (plus its BoW words when a
        vocabulary is configured) via ONE synchronized device->host read —
        each read is a host sync that stalls the following dispatches, so
        everything the host will ever need from a keyframe arrives
        together."""
        if self._fh is not None and self._fh[0] is frame:
            return self._fh[1]
        f, desc = self._pack_fn(frame.kp, frame.u_right, frame.depth)
        if self.place is not None:
            w_dev = self.place.transform(frame.kp.desc, frame.kp.valid)
            f, desc, words = jax.device_get((f, desc, w_dev))
        else:
            f, desc = jax.device_get((f, desc))
            words = None
        host = {
            "xy": np.ascontiguousarray(f[:, :2]),
            "ur": f[:, 2].copy(),
            "depth": f[:, 3].copy(),
            "angle": f[:, 4].copy(),
            "octave": f[:, 5].astype(np.int32),
            "kp_valid": f[:, 6] > 0,
            "response": f[:, 7].copy(),
            "desc": np.asarray(desc),
            "words": words,
        }
        self._fh = (frame, host)
        return host

    def _select_local_kfs(self, matched_ids: np.ndarray):
        """UpdateLocalKeyFrames (Tracking.cc:1200-1283): keyframes voting for
        the current matches, padded with their best covisibles. Returns
        (reference_kf, local_kf_list) or None."""
        obs_kf = self.map.mp_obs_kf[matched_ids].reshape(-1)
        obs_kf = obs_kf[obs_kf >= 0]
        if len(obs_kf) == 0:
            return None
        votes = np.bincount(obs_kf, minlength=self.map.kf_capacity)
        voters = np.nonzero(votes)[0]
        order = voters[np.argsort(-votes[voters], kind="stable")]
        local_kfs = list(order[: self.cfg.tracking.local_window_kf // 2])
        for k in list(local_kfs):
            for nb in self.map.covisible_keyframes(int(k), 10):
                if len(local_kfs) >= self.cfg.tracking.local_window_kf:
                    break
                if nb not in local_kfs:
                    local_kfs.append(int(nb))
        return int(order[0]), local_kfs

    def _refresh_snapshot(self, local_kfs) -> bool:
        """Device-cached local-map snapshot: re-uploaded only when the local
        keyframe set or the map content (write epoch) changes — per keyframe
        cadence, NOT per frame. Three packed uploads. Returns True when the
        snapshot was actually rebuilt."""
        key = (tuple(int(x) for x in local_kfs), self.map.write_epoch)
        if key == self._snap_key:
            return False
        P = self.cfg.tracking.local_points_cap
        snap = self.map.local_map_snapshot(np.asarray(local_kfs, np.int64), P)
        geom = np.concatenate(
            [snap["pos"], snap["normal"],
             snap["min_dist"][:, None], snap["max_dist"][:, None]],
            axis=1,
        ).astype(np.float32)
        self._snap_dev = (
            jnp.asarray(geom), jnp.asarray(snap["desc"]), jnp.asarray(snap["valid"])
        )
        self._snap_ids = snap["ids"]
        cap = len(self.map.mp_valid)
        if self._id2slot is None or len(self._id2slot) != cap:
            self._id2slot = np.full(cap, -1, np.int32)
        else:
            self._id2slot[:] = -1
        live = snap["ids"] >= 0
        self._id2slot[snap["ids"][live]] = np.arange(P, dtype=np.int32)[live]
        self._snap_key = key
        return True

    def _track_fused(self, frame: Frame, frame_id: int):
        """Hot tracking path: TrackWithMotionModel + TrackLocalMap fused into
        one device dispatch with packed I/O (see track_steps.fused_track_step).
        Returns None when motion tracking failed (caller falls back to the
        reference-KF path), else the TrackLocalMap verdict."""
        lf = self.last_frame_data
        n = self.cfg.orb.n_features
        ids = np.where(lf["mp"] >= 0, lf["mp"], -1)
        live = self.map.resolve_replaced(ids)
        alive = (live >= 0) & self.map.mp_valid[np.clip(live, 0, None)]
        lm_ids = np.where(alive, live, -1)
        matched_ids = lm_ids[lm_ids >= 0]
        if matched_ids.size == 0:
            return None
        sel_res = self._select_local_kfs(matched_ids)
        if sel_res is None:
            return None
        ref_kf, local_kfs = sel_res
        self._refresh_snapshot(local_kfs)

        # ONE packed upload: geom(N*4) | last_slot bitcast (N) | pose_pack(16)
        # (one transfer instead of three — see fused_track_step_packed)
        pack = np.empty(5 * n + 16, np.float32)
        geom = pack[: 4 * n].reshape(n, 4)
        geom[:, :3] = self.map.mp_pos[np.clip(live, 0, None)]
        geom[:, 3] = alive
        pack[4 * n : 5 * n] = np.where(
            lm_ids >= 0, self._id2slot[np.clip(lm_ids, 0, None)], -1
        ).astype(np.int32).view(np.float32)

        R_l, t_l = self.last_pose
        T_pred = self.velocity @ _mat(R_l, t_l)
        pose_pack = pack[5 * n :]
        pose_pack[:] = 0.0
        pose_pack[:9] = T_pred[:3, :3].reshape(-1)
        pose_pack[9:12] = T_pred[:3, 3]
        pose_pack[12] = self.cfg.tracking.motion_search_radius
        pose_pack[13] = self.cfg.resolved_depth_th()
        pose_pack[14] = 20.0

        import time as _time
        _t0 = _time.perf_counter()
        out = self._fused_fn(
            self.cam, frame.kp, frame.u_right, frame.depth,
            lf.kp.desc, lf.kp.octave, lf.kp.angle, lf.kp.valid,
            jnp.asarray(pack), *self._snap_dev,
        )
        # interleaved prefetch (System.track_stereo_prefetch): the NEXT
        # frame's upload + feature build enqueues here, BETWEEN this frame's
        # dispatch and its readback, so the build executes while this pull's
        # result transfers — enqueuing it before track_stereo instead puts
        # the build ahead of this pull in the device queue
        cb = self.prefetch_cb
        if cb is not None:
            self.prefetch_result = cb()
            self.prefetch_cb = None
        _t1 = _time.perf_counter()
        # ONE packed pull: out_f bitcast (30) | enc (N) | visible (P)
        out = np.asarray(out)
        _t2 = _time.perf_counter()
        self.sect_times["fused.dispatch"] += _t1 - _t0
        self.sect_times["fused.pull"] += _t2 - _t1
        self.sect_counts["fused.dispatch"] += 1
        f = out[:30].view(np.float32)
        nm1, nin1, nin2 = int(f[12]), int(f[13]), int(f[14])
        if nm1 < 20 or nin1 < self.cfg.tracking.min_inliers_track:
            return None

        enc = out[30 : 30 + n]
        visible = out[30 + n :] > 0
        snap_ids = self._snap_ids
        bind = np.full(n, -1, np.int64)
        m1 = (enc >= 0) & (enc < n)
        bind[m1] = lm_ids[enc[m1]]
        m2 = enc >= n
        bind[m2] = snap_ids[enc[m2] - n]
        self._bind_cur = bind
        self.ref_kf = ref_kf
        self.map.increment_visible(snap_ids[visible & (snap_ids >= 0)])
        self.map.increment_found(bind[bind >= 0])
        self.n_inliers_last = nin2
        self._kf_close_counts = (int(f[15]), int(f[16]))

        min_in = self.cfg.tracking.min_inliers_localmap
        if frame_id < self.last_reloc_frame_id + self.cfg.tracking.max_frames_between_kf:
            min_in = max(
                min_in,
                int(round(self.cfg.tracking.min_inliers_localmap_recent
                          * self._feature_scale())),
            )
        if nin2 < min_in:
            # keep the motion-only pose (legacy semantics: TrackLocalMap
            # failure does not revert TrackWithMotionModel's estimate)
            self.last_pose = (f[18:27].reshape(3, 3).copy(), f[27:30].copy())
            return False
        self.last_pose = (f[:9].reshape(3, 3).copy(), f[9:12].copy())
        return True


    # ------------------------------------------------------------------
    def _track_local_map(self, frame: Frame, frame_id: int) -> bool:
        """TrackLocalMap (Tracking.cc:950-994): expand to covisible KFs, match
        their points, re-optimize, count inliers. Within MaxFrames of a
        relocalization the acceptance bar is raised (Tracking.cc:983-985)."""
        bind = self._bind_cur
        matched_ids = bind[bind >= 0]
        if len(matched_ids) == 0:
            return False
        # local KF set: voters for current matches + best covisibles (<= 80)
        sel_res = self._select_local_kfs(matched_ids)
        if sel_res is None:
            return False
        self.ref_kf, local_kfs = sel_res

        snap = self.map.local_map_snapshot(
            np.asarray(local_kfs, np.int64), self.cfg.tracking.local_points_cap
        )
        # exclude points already matched in this frame (SearchLocalPoints
        # skips mnLastFrameSeen == cur, Tracking.cc:1172-1178)
        already = np.isin(snap["ids"], matched_ids)
        snap_valid = snap["valid"] & ~already

        R0, t0 = self.last_pose
        bound_mask = bind >= 0
        live = self.map.resolve_replaced(bind)
        bound_xw = self.map.mp_pos[np.clip(live, 0, None)]

        R, t, slot, inlier, n_in, visible = self._local_fn(
            self.cam, frame.kp, frame.u_right,
            jnp.asarray(R0), jnp.asarray(t0),
            jnp.asarray(bound_xw), jnp.asarray(bound_mask),
            jnp.asarray(snap["pos"]), jnp.asarray(snap["normal"]),
            jnp.asarray(snap["min_dist"]), jnp.asarray(snap["max_dist"]),
            jnp.asarray(snap["desc"]), jnp.asarray(snap_valid),
        )
        slot = np.asarray(slot)
        inlier = np.asarray(inlier)
        n_in = int(n_in)

        # merge new bindings
        new_ok = (slot >= 0) & inlier
        bind = bind.copy()
        bind[new_ok] = snap["ids"][slot[new_ok]]
        bind[~inlier & (bind >= 0) & ~bound_mask] = -1
        # outliers among previously bound features are unbound as well
        bind[(~inlier) & bound_mask] = -1
        self._bind_cur = bind

        # visibility / found statistics (Tracking.cc:976-981)
        vis_ids = snap["ids"][np.asarray(visible) & (snap["ids"] >= 0)]
        self.map.increment_visible(vis_ids)
        self.map.increment_found(bind[bind >= 0])

        self.n_inliers_last = n_in
        min_in = self.cfg.tracking.min_inliers_localmap
        if frame_id < self.last_reloc_frame_id + self.cfg.tracking.max_frames_between_kf:
            # more restrictive right after a relocalization (Tracking.cc:984)
            min_in = max(
                min_in,
                int(round(self.cfg.tracking.min_inliers_localmap_recent
                          * self._feature_scale())),
            )
        if n_in < min_in:
            return False
        self.last_pose = (np.asarray(R), np.asarray(t))
        return True

    # ------------------------------------------------------------------
    def _update_motion_model(self):
        if self.last_frame_data is None:
            self.velocity = None
            return
        R_l, t_l = self.last_frame_data["pose"]
        R_c, t_c = self.last_pose
        T_l = _mat(R_l, t_l)
        T_c = _mat(R_c, t_c)
        self.velocity = (T_c @ np.linalg.inv(T_l)).astype(np.float32)

    def _need_new_keyframe(self, frame: Frame, frame_id: int) -> bool:
        """NeedNewKeyFrame (Tracking.cc:996-1080), stereo branch. Synchronous
        local mapping is always 'idle', so c1b reduces to the MinFrames gate
        exactly as in the reference's steady state."""
        if self.ref_kf < 0:
            return False
        n_kf = self.map.n_kf
        # nRefMatches = ref-KF points with >= nMinObs observations
        min_obs = 3 if n_kf > 2 else 2
        ref_mp = self.map.kf_mp[self.ref_kf]
        sel = np.clip(ref_mp, 0, None)
        n_ref = int(
            ((ref_mp >= 0) & self.map.mp_valid[sel] & (self.map.mp_n_obs[sel] >= min_obs)).sum()
        )

        if self._kf_close_counts is not None:
            tracked_close, untracked_close = self._kf_close_counts
        else:
            host = self._frame_host_arrays(frame)
            depth = host["depth"]
            bind = self._bind_cur
            close = (depth > 0) & (depth < self.cfg.resolved_depth_th())
            tracked_close = int((close & (bind >= 0)).sum())
            untracked_close = int((close & (bind < 0)).sum())
        need_close = tracked_close < 100 and untracked_close > 70

        frames_since = frame_id - self.last_kf_frame_id
        inl = self.n_inliers_last

        # bLocalMappingIdle (Tracking.cc:1014, LocalMapping::AcceptKeyFrames):
        # in async mode a busy mapping worker vetoes the MinFrames trigger and
        # gates insertion below; synchronous mapping is always idle (processed
        # inline), reproducing the reference's steady state
        lm = self.local_mapper
        mapping_idle = True
        queue_len = 0
        if lm is not None and getattr(lm, "async_mode", False):
            queue_len = len(lm.queue)
            mapping_idle = queue_len == 0 and not lm._busy

        c1a = frames_since >= self.cfg.tracking.max_frames_between_kf
        c1b = (frames_since >= self.cfg.tracking.min_frames_between_kf
               and mapping_idle)
        c1c = (self.sensor != "mono") and (inl < n_ref * 0.25 or need_close)
        th_ratio = 0.75 if n_kf >= 2 else 0.4
        if self.sensor == "mono":
            th_ratio = 0.9  # Tracking.cc:1044
        c2 = (inl < n_ref * th_ratio or need_close) and inl > 15
        if not ((c1a or c1b or c1c) and c2):
            return False
        if mapping_idle:
            return True
        # mapping busy: interrupt its BA; stereo/RGBD may still insert while
        # the queue is short (Tracking.cc:1056-1074)
        lm.abort_ba = True
        if self.sensor != "mono":
            return queue_len < 3
        return False

    def _create_new_keyframe(self, frame: Frame, frame_id: int, timestamp: float):
        """CreateNewKeyFrame (Tracking.cc:1082-1162): promote the frame; for
        stereo, spawn map points for the closest unbound depths (all closer
        than ThDepth, at least the 100 closest)."""
        R, t = self.last_pose
        bind = self._bind_cur.copy()
        host = self._frame_host_arrays(frame)
        depth = host["depth"]
        kp_valid = host["kp_valid"]
        xy = host["xy"]
        desc = host["desc"]

        cand = np.nonzero((depth > 0) & (bind < 0) & kp_valid)[0]
        if len(cand):
            order = cand[np.argsort(depth[cand], kind="stable")]
            th = self.cfg.resolved_depth_th()
            n_close = int((depth[order] < th).sum())
            n_take = min(len(order), max(100, n_close))
            take = order[:n_take]
            z = depth[take]
            # unproject to world: Xw = R^T (Xc - t)
            xc = np.stack(
                [
                    (xy[take, 0] - self.cfg.cx) * z / self.cfg.fx,
                    (xy[take, 1] - self.cfg.cy) * z / self.cfg.fy,
                    z,
                ],
                axis=1,
            ).astype(np.float32)
            xw = (xc - t[None]) @ R  # R^T (xc - t) as row vectors
            ids = self.map.add_map_points_batch(xw, desc[take], first_kf=self.map.next_kf)
            bind[take] = ids

        k = self.map.add_keyframe(
            R.astype(np.float32), t.astype(np.float32),
            xy, host["ur"], depth,
            host["octave"], host["angle"],
            desc, kp_valid, bind, frame_id, timestamp,
        )
        new_ids = bind[bind >= 0]
        self.map.update_point_stats(new_ids)
        self.ref_kf = k
        self.last_kf_frame_id = frame_id
        self._bind_cur = bind
        words = self._compute_words(frame)
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(k, words, frame=frame)

    def _compute_words(self, frame: Frame):
        """KF ComputeBoW (Frame.cc:447-454): descriptor -> word ids, pulled
        together with the frame's host arrays in the single keyframe read
        (_frame_host_arrays); None when no vocabulary is configured."""
        if self.place is None:
            return None
        return self._frame_host_arrays(frame)["words"]

    # ------------------------------------------------------------------
    def _set_metrics(self, frame_id: int, timestamp: float, kf_created: bool):
        """Per-frame observability record (SURVEY.md §5 metrics entry; the
        reference only std::cout-prints). System merges in stage timings."""
        self.last_metrics = {
            "frame_id": int(frame_id),
            "timestamp": float(timestamp),
            "state": self.state.name,
            "n_matches": int((self._bind_cur >= 0).sum()),
            "n_inliers": int(self.n_inliers_last),
            "keyframe": bool(kf_created),
            "n_keyframes": int(self.map.n_kf),
            "n_map_points": int(self.map.mp_valid.sum()),
        }

    def _record_frame(self, frame_id: int, timestamp: float, lost: bool):
        if self.last_pose is None or self.ref_kf < 0:
            return
        R, t = self.last_pose
        T_cw = _mat(R, t)
        T_rw = _mat(self.map.kf_R[self.ref_kf], self.map.kf_t[self.ref_kf])
        T_cr = T_cw @ np.linalg.inv(T_rw)
        self.records.append(FrameRecord(frame_id, timestamp, self.ref_kf, T_cr.astype(np.float32), lost))

    def reset(self):
        """Tracking::Reset bookkeeping (Tracking.cc:1534-1582): back to
        NO_IMAGES_YET with empty trajectory records. Map/database/worker
        clearing is orchestrated by System (the reference does it here because
        Tracking owns the pointers; ours live on System)."""
        self.state = TrackState.NO_IMAGES_YET
        self.velocity = None
        self.last_pose = None
        self.last_frame_data = None
        self.ref_kf = -1
        self.last_kf_frame_id = -1
        self.records.clear()
        self.n_inliers_last = 0
        self.vo_mode = False
        self.last_reloc_frame_id = -(1 << 30)
        self._mono_ref = None
        self._bind_cur = np.full(self.cfg.orb.n_features, -1, np.int64)
        self._fh = None
        self._snap_key = None
        self._snap_dev = None
        self._snap_ids = None
        self._kf_close_counts = None
        self._ref_anchor = None

    def _stash_last_frame(self, frame: Frame, frame_id: int = -1):
        host = None
        if self._fh is not None and self._fh[0] is frame:
            host = self._fh[1]  # reuse already-pulled views
        self.last_frame_data = LastFrame(
            self, frame, frame_id, self._bind_cur.copy(), self.last_pose, host
        )
        # anchor the cached pose state to the reference KF's CURRENT pose so
        # a later map correction can be detected and rebased
        # (_rebase_on_map_correction)
        if self.ref_kf >= 0:
            self._ref_anchor = (
                int(self.ref_kf),
                self.map.kf_R[self.ref_kf].astype(np.float64).copy(),
                self.map.kf_t[self.ref_kf].astype(np.float64).copy(),
            )
        else:
            self._ref_anchor = None

    # ------------------------------------------------------------------
    def trajectory(self) -> List[Tuple[float, np.ndarray]]:
        """Per-frame (timestamp, Twc [4,4]) resolving reference-KF poses at
        call time (SaveTrajectoryKITTI semantics, System.cc:473-530). Culled
        reference KFs resolve through the stored mTcp chain to a live
        spanning-tree ancestor (System.cc:510-513), so exported poses follow
        loop/GBA corrections even when the reference KF is gone."""
        out = []
        for rec in self.records:
            T_rw = self.map.resolve_kf_pose(rec.ref_kf)
            T_cw = rec.T_cr @ T_rw
            out.append((rec.timestamp, np.linalg.inv(T_cw)))
        return out


def _mat(R, t):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return T
