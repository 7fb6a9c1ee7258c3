"""System facade — construction, per-frame entry points, shutdown, export.

Mirrors the reference's System class (/root/reference/include/System.h:65-209,
src/System.cc): wires Tracking + LocalMapping (+ LoopClosing + GridMapping as
they land), routes frames, exposes trajectory/map persistence and the
localization-mode toggle. Runs synchronously by default (deterministic; the
reference's thread interleaving is nondeterministic by design, SURVEY.md §2
parallelism table) with an async mode for throughput.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..frontend.frame import Frame, make_stereo_frame_fn, make_stereo_frame_u8_fn
from ..mapping.map_store import MapStore
from ..place.bundle import PlaceRecognition
from .local_mapping import LocalMapping
from .loop_closing import LoopClosing
from .tracking import Tracking, TrackState


class System:
    def __init__(
        self,
        cfg: SlamConfig,
        enable_mapping: bool = True,
        enable_loop_closing: bool = True,
        vocab_path: Optional[str] = None,
        place_rec: Optional[PlaceRecognition] = None,
        sensor: str = "stereo",
        async_mode: bool = False,
        mesh=None,
        profile_dir: Optional[str] = None,
    ):
        """Boot the engine (System::System, System.cc:37-165): load the
        vocabulary, create the map + keyframe database, wire the pipeline
        stages (Tracking -> LocalMapping -> LoopClosing).

        async_mode=True reproduces the reference's thread layout
        (System.cc:129-147): tracking stays on the caller thread; local
        mapping + loop closing run on a worker; global BA on an ephemeral
        abortable thread. Default is synchronous (deterministic)."""
        self.cfg = cfg
        self.map = MapStore(cfg)
        if place_rec is None:
            if vocab_path is not None:
                place_rec = PlaceRecognition.from_file(vocab_path)
            else:
                place_rec = PlaceRecognition.load_default()
        self.place = place_rec
        self.local_mapper = LocalMapping(cfg, self.map) if enable_mapping else None
        if self.local_mapper is not None:
            self.local_mapper.monocular = sensor == "mono"
        self.loop_closer = None
        if enable_mapping and enable_loop_closing and self.place is not None:
            # monocular loops solve for scale drift (bFixScale=false)
            self.loop_closer = LoopClosing(
                cfg, self.map, self.place.kfdb, fix_scale=(sensor != "mono")
            )
            self.loop_closer.local_mapper = self.local_mapper
            self.local_mapper.loop_closer = self.loop_closer
            # optional jax.sharding.Mesh: global BA runs landmark-sharded over
            # its 'map' axis with psum'd camera reductions across the devices
            self.loop_closer.mesh = mesh
        self.tracker = Tracking(cfg, self.map, self.local_mapper, self.place)
        self.tracker.sensor = sensor
        if self.place is not None:
            # culled KFs leave the retrieval index (KeyFrame::SetBadFlag ->
            # KeyFrameDatabase::erase, KeyFrame.cc:561, KeyFrameDatabase.cc:49)
            self.map.on_kf_erased = self.place.kfdb.erase
        from ..gridmap.grid import GridMapper

        self.grid_mapper = GridMapper(cfg, self.map) if enable_mapping else None
        self._frame_fn = make_stereo_frame_fn(cfg)
        self._frame_u8_fn = make_stereo_frame_u8_fn(cfg)
        self.frame_times: List[float] = []
        self.metrics: List[dict] = []  # per-frame records (io/metrics.py schema)
        self._frame_id = 0
        self._reset_requested = False
        # jax.profiler trace behind a flag (SURVEY.md §5 tracing entry):
        # started lazily at the first frame, stopped in shutdown()
        self._profile_dir = profile_dir
        self._profiling = False
        # reset-on-early-loss (Tracking.cc:493-501) requests a system reset
        self.tracker.request_system_reset = self.reset

        self.async_mode = async_mode and self.local_mapper is not None
        self._worker = None
        if self.async_mode:
            import threading

            from ..utils.pacer import DevicePacer

            # priority scheduling of the single device stream: background
            # threads yield between bounded device units so the tracking
            # lane's dispatch+readback never queues behind a keyframe's bulk
            # work (utils/pacer.py)
            self.pacer = DevicePacer()
            self.local_mapper.pacer = self.pacer
            if self.loop_closer is not None:
                self.loop_closer.pacer = self.pacer
            self.tracker.pacer = self.pacer
            self.local_mapper.async_mode = True
            # the worker owns grid upkeep in async mode (the reference's
            # GridMapping thread, GridMapping.cpp:21-70) — the tracking lane
            # must not pay for raycasts
            self.local_mapper.grid_mapper = self.grid_mapper
            if self.loop_closer is not None:
                self.loop_closer.async_mode = True
            self._worker = threading.Thread(
                target=self.local_mapper.run_worker, daemon=True
            )
            self._worker.start()

    # ------------------------------------------------------------------
    def warmup(self, verbose: bool = False):
        """Precompile the bucketed device programs (local-BA size buckets,
        the loop-closure stack, global BA) so no XLA compile lands on the
        tracking-critical path mid-run. See pipeline/warmup.py."""
        from .warmup import warmup_system

        warmup_system(self, verbose=verbose)

    # ------------------------------------------------------------------
    def reset(self):
        """System::Reset (System.cc:346-350): flag only; the actual clearing
        runs on the tracking thread before the next frame (the reference's
        TrackStereo checks mbReset the same way, System.cc:176-190)."""
        self._reset_requested = True

    def _maybe_reset(self):
        if not self._reset_requested:
            return
        # Tracking::Reset orchestration (Tracking.cc:1534-1582): reset the
        # workers first (needs map.lock FREE so the mapping worker can finish
        # its in-flight keyframe), then clear database + map + tracker state.
        if self.local_mapper is not None:
            self.local_mapper.request_reset()
        if self.loop_closer is not None:
            self.loop_closer.request_reset()
        if self.place is not None:
            self.place.kfdb.clear()
        with self.map.lock:
            self.map.clear()
            self.tracker.reset()
            if self.grid_mapper is not None:
                self.grid_mapper.process_new(loop_closed=True)  # clears grid
        self._reset_requested = False

    def _post_track(self):
        """Mapping/grid work after a tracked frame: inline when synchronous,
        no-op in async mode (the worker owns it)."""
        if self.async_mode:
            # grid mapping runs on the mapping worker (LocalMapping._process
            # tail) — nothing to do on the tracking lane
            return
        if self.local_mapper is not None:
            self.local_mapper.process_pending()
        if self.grid_mapper is not None:
            loop_closed = bool(self.loop_closer and self.loop_closer.loop_closed_flag)
            if loop_closed:
                self.loop_closer.loop_closed_flag = False
            self.grid_mapper.process_new(loop_closed)

    def _pre_frame(self):
        self._maybe_reset()
        if self._profile_dir is not None and not self._profiling:
            jax.profiler.start_trace(self._profile_dir)
            self._profiling = True

    def _collect_metrics(self, timestamp, t0, t_extract, t_track, t_end):
        """Merge the tracker's per-frame record with stage wall-clock times
        (ms) into one METRICS_SCHEMA record (io/metrics.py)."""
        rec = self.tracker.last_metrics
        if rec is None:
            return
        rec = dict(rec)
        rec["timestamp"] = float(timestamp)
        rec["ms_extract"] = 1e3 * (t_extract - t0)
        rec["ms_track"] = 1e3 * (t_track - t_extract)
        rec["ms_mapping"] = 1e3 * (t_end - t_track)
        rec["ms_total"] = 1e3 * (t_end - t0)
        self.metrics.append(rec)

    # ------------------------------------------------------------------
    def _pack_stereo_u8(self, image_left, image_right,
                        normalized: Optional[bool] = None) -> np.ndarray:
        """Stack the pair as ONE uint8 upload payload (8x smaller than two
        f32 transfers; cast back to f32 on device — frame.py
        build_stereo_frame_from_u8).

        Contract (ADVICE r4 #5): uint8 input is passed through; float input
        is 0-255 intensity unless `normalized=True` ([0,1] scale, rescaled by
        255). With normalized=None (callers that predate the flag), a float
        pair whose max is <= 1.0 is ASSUMED normalized — a legitimately
        near-black 0-255 float frame must pass normalized=False (or uint8)
        to avoid the 255x brightening."""
        il = np.asarray(image_left)
        ir = np.asarray(image_right)
        if il.dtype == np.uint8 and ir.dtype == np.uint8:
            return np.stack([il, ir])
        stacked = np.stack([il, ir])
        if normalized or (normalized is None and stacked.max() <= 1.0):
            stacked = stacked * 255.0
        return np.clip(stacked, 0, 255).astype(np.uint8)

    def prefetch_stereo(self, image_left, image_right,
                        normalized: Optional[bool] = None):
        """Enqueue the pair's device upload AHEAD of the frame that will
        consume it and return the handle for track_stereo.

        Uploads ride a DMA path that overlaps device compute, so a caller
        that prefetches frame N+1 while frame N tracks hides the transfer
        (the host-side analogue of the reference's dataset-reader pacing
        loop, arducam_images.cpp:144-187)."""
        return self._frame_u8_fn(jnp.asarray(
            self._pack_stereo_u8(image_left, image_right, normalized)
        ))

    def track_stereo(self, image_left, image_right=None, timestamp: float = 0.0,
                     normalized: Optional[bool] = None):
        """Per-frame stereo entry (System::TrackStereo, System.cc:167-216).

        `image_left`/`image_right` are host images, or `image_left` may be a
        prefetched frame handle from prefetch_stereo (image_right=None).
        Returns Tcw as (R, t) numpy arrays, or None while initializing/lost.
        """
        self._pre_frame()
        t0 = time.perf_counter()
        if isinstance(image_left, Frame):
            frame = image_left  # prefetched Frame (prefetch_stereo)
        else:
            frame = self._frame_u8_fn(
                jnp.asarray(self._pack_stereo_u8(image_left, image_right, normalized))
            )
        t1 = time.perf_counter()
        pacer = getattr(self, "pacer", None)
        if pacer is not None:
            pacer.frame_start()
        try:
            with self.map.lock:
                pose = self.tracker.track_stereo_frame(
                    frame, self._frame_id, timestamp
                )
        finally:
            if pacer is not None:
                pacer.frame_end()
        t2 = time.perf_counter()
        self._post_track()
        t3 = time.perf_counter()
        self.frame_times.append(t3 - t0)
        self._collect_metrics(timestamp, t0, t1, t2, t3)
        self._frame_id += 1
        return pose

    def track_stereo_prefetch(self, frame, next_images, timestamp: float):
        """Real-time drive pattern: track `frame` (a prefetched handle) and
        enqueue the NEXT pair's upload + feature build at the optimal point —
        between this frame's fused dispatch and its result readback, so the
        build overlaps the readback instead of queuing ahead of it on the
        in-order device stream. Returns (pose, next_frame_handle).

        The host-side analogue of the reference's dataset-reader pacing loop
        (arducam_images.cpp:144-187), adapted to one device queue shared by
        every thread, where transfer/queue order matters."""
        if next_images is not None:
            payload = jnp.asarray(self._pack_stereo_u8(*next_images))
            self.tracker.prefetch_cb = lambda: self._frame_u8_fn(payload)
        self.tracker.prefetch_result = None
        pose = self.track_stereo(frame, timestamp=timestamp)
        handle = self.tracker.prefetch_result
        self.tracker.prefetch_cb = None
        self.tracker.prefetch_result = None
        if handle is None and next_images is not None:
            # slow path (init / reloc / ref-KF track) skipped the hook
            handle = self._frame_u8_fn(payload)
        return pose, handle

    def track_monocular(self, image, timestamp: float):
        """System::TrackMonocular (System.cc:269-319)."""
        import functools as _ft
        from ..frontend.frame import build_mono_frame

        self._pre_frame()
        t0 = time.perf_counter()
        if not hasattr(self, "_mono_fn"):
            self._mono_fn = jax.jit(_ft.partial(build_mono_frame, cfg=self.cfg))
        frame = self._mono_fn(jnp.asarray(image, jnp.float32))
        t1 = time.perf_counter()
        with self.map.lock:
            pose = self.tracker.track_mono_frame(frame, self._frame_id, timestamp)
        t2 = time.perf_counter()
        self._post_track()
        t3 = time.perf_counter()
        self.frame_times.append(t3 - t0)
        self._collect_metrics(timestamp, t0, t1, t2, t3)
        self._frame_id += 1
        return pose

    def track_rgbd(self, image, depth_map, timestamp: float):
        """System::TrackRGBD (System.cc:218-267)."""
        import functools as _ft
        from ..frontend.frame import build_rgbd_frame

        self._pre_frame()
        t0 = time.perf_counter()
        if not hasattr(self, "_rgbd_fn"):
            # DepthMapFactor semantics (Tracking.cc:147-153): raw depth maps
            # are divided by the factor to get meters; ~0 means already metric
            f = self.cfg.depth_map_factor
            scale = 1.0 if abs(f) < 1e-5 or f == 1.0 else 1.0 / f
            self._rgbd_fn = jax.jit(
                _ft.partial(build_rgbd_frame, cfg=self.cfg, depth_scale=scale)
            )
        frame = self._rgbd_fn(jnp.asarray(image, jnp.float32), jnp.asarray(depth_map, jnp.float32))
        t1 = time.perf_counter()
        with self.map.lock:
            pose = self.tracker.track_stereo_frame(frame, self._frame_id, timestamp)
        t2 = time.perf_counter()
        self._post_track()
        t3 = time.perf_counter()
        self.frame_times.append(t3 - t0)
        self._collect_metrics(timestamp, t0, t1, t2, t3)
        self._frame_id += 1
        return pose

    # ------------------------------------------------------------------
    def trajectory_kitti(self) -> List[np.ndarray]:
        return [T for _, T in self.tracker.trajectory()]

    def trajectory_tum(self) -> List[Tuple[float, np.ndarray]]:
        return self.tracker.trajectory()

    def save_trajectory_kitti(self, path: str):
        from ..io.trajectory import save_kitti

        save_kitti(path, self.trajectory_kitti())

    def save_trajectory_tum(self, path: str):
        from ..io.trajectory import save_tum

        save_tum(path, self.trajectory_tum())

    def timing_stats(self):
        ts = np.asarray(self.frame_times)
        if len(ts) == 0:
            return {}
        return {
            "median_s": float(np.median(ts)),
            "mean_s": float(ts.mean()),
            "fps": float(1.0 / np.median(ts)),
        }

    def occupancy_grid(self):
        """Live occupancy grid (the reference publishes this as a ROS
        nav_msgs/OccupancyGrid, GridMapping.cpp:137-174)."""
        if self.grid_mapper is None:
            return None
        return self.grid_mapper.occupancy_grid()

    def point_cloud(self):
        if self.grid_mapper is None:
            return None
        return self.grid_mapper.point_cloud()

    # ------------------------------------------------------------------
    def activate_localization_mode(self):
        """System::ActivateLocalizationMode (System.cc:321-331): tracking
        continues against the frozen map; mapping stops inserting."""
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        self.tracker.only_tracking = False

    # ------------------------------------------------------------------
    def save_map(self, path: str):
        """System::SaveMap (System.cc:550-565)."""
        from ..io.persistence import save_map

        if self.local_mapper is not None:
            self.local_mapper.finish()
        save_map(path, self.map, next_frame_id=self._frame_id)

    @classmethod
    def from_map_file(cls, cfg: SlamConfig, path: str, **kwargs):
        """System::LoadMap boot path (System.cc:567-596): restore the map,
        recompute BoW for every keyframe against the loaded vocabulary, and
        start the tracker LOST for relocalization (Tracking.cc:154-155)."""
        from ..io.persistence import load_map

        sys_ = cls(cfg, **kwargs)
        m, next_frame_id = load_map(path, cfg)
        sys_.map = m
        # rewire every component onto the restored store
        sys_.tracker.map = m
        if sys_.local_mapper is not None:
            sys_.local_mapper.map = m
        if sys_.loop_closer is not None:
            sys_.loop_closer.map = m
        if sys_.grid_mapper is not None:
            sys_.grid_mapper.map = m
            sys_.grid_mapper.process_new(loop_closed=True)
        sys_._frame_id = next_frame_id
        # recompute BoW + inverted file per restored KF
        if sys_.place is not None:
            import jax.numpy as jnp

            for k in np.nonzero(m.kf_valid)[0]:
                words = np.asarray(
                    sys_.place.transform(
                        jnp.asarray(m.kf_desc[int(k)]),
                        jnp.asarray(m.kf_feat_valid[int(k)]),
                    )
                )
                sys_.place.kfdb.add(int(k), words)
        from .tracking import TrackState

        sys_.tracker.state = TrackState.LOST
        sys_.tracker.ref_kf = int(np.nonzero(m.kf_valid)[0][-1]) if m.n_kf else -1
        sys_.tracker.last_pose = (
            m.kf_R[sys_.tracker.ref_kf].copy(), m.kf_t[sys_.tracker.ref_kf].copy()
        ) if sys_.tracker.ref_kf >= 0 else None
        sys_.tracker._bind_cur = np.full(cfg.orb.n_features, -1, np.int64)
        return sys_

    def shutdown(self):
        """System::Shutdown (System.cc:352-376): finish the worker, wait for
        a running global BA, drain remaining work synchronously."""
        if self.async_mode and self._worker is not None:
            self.local_mapper.request_finish()
            self._worker.join(timeout=300.0)
            self.async_mode = False
        if self.loop_closer is not None:
            th = self.loop_closer.gba_thread
            if th is not None and th.is_alive():
                th.join(timeout=300.0)
        if self.local_mapper is not None:
            self.local_mapper.finish()
        if self.grid_mapper is not None:
            self._post_track()
        if self._profiling:
            jax.profiler.stop_trace()
            self._profiling = False

    def save_metrics_ndjson(self, path: str) -> int:
        """Dump the per-frame metrics records (io/metrics.py schema) as
        NDJSON; returns the record count."""
        from ..io.metrics import write_ndjson

        return write_ndjson(path, self.metrics)
