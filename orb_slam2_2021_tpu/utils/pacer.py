"""Device-queue pacing between the tracking lane and background workers.

One process dispatches every thread's work to one device queue, so bulk
work the mapping worker or GBA thread enqueues can delay the tracking
lane's next dispatch AND its result readback whenever a keyframe is being
processed (the map pass + local BA queue device work ahead of the frame).
Whether this pacing still pays on a GPU is an open measurement
(ROADMAP.md 3.3). The reference
does not have this problem because its threads run on independent CPU cores
(System.cc:129-140); on a single shared accelerator the equivalent is
PRIORITY SCHEDULING of the dispatch queue.

DevicePacer implements it host-side: the tracking lane brackets its
per-frame device section with frame_start()/frame_end(); background threads
call yield_point() between bounded device units (one dispatch + its
readback), which blocks while a frame is in flight. Units are sized so the
worst case a frame can queue behind is one unit (~10-50 ms), not a whole
keyframe's pipeline. A timeout guarantees worker progress under a saturated
frame stream.
"""

from __future__ import annotations

import threading
import time


class DevicePacer:
    def __init__(self, worker_timeout: float = 0.25):
        self._cv = threading.Condition()
        self._frame_busy = False
        self.worker_timeout = worker_timeout
        # telemetry: cumulative seconds background threads spent yielding
        self.yield_wait_s = 0.0
        self.yield_count = 0

    def frame_start(self):
        with self._cv:
            self._frame_busy = True

    def frame_end(self):
        with self._cv:
            self._frame_busy = False
            self._cv.notify_all()

    def yield_point(self):
        """Block while a frame's device section is in flight (bounded by
        worker_timeout so a continuous frame stream cannot starve the
        worker forever)."""
        t0 = time.monotonic()
        with self._cv:
            while self._frame_busy:
                remaining = self.worker_timeout - (time.monotonic() - t0)
                if remaining <= 0:
                    break
                self._cv.wait(min(remaining, 0.02))
        dt = time.monotonic() - t0
        if dt > 1e-4:
            self.yield_wait_s += dt
            self.yield_count += 1
