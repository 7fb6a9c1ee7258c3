"""Device timing on the host clock.

JAX dispatch is asynchronous, so a timing is only meaningful once the result
has been waited on: `jax.block_until_ready` is the fence, `time.perf_counter`
the clock. The reference times what actually ran with plain chrono around
synchronous calls (the reference's Examples/Stereo/arducam_images.cpp:144-187);
this is the async-dispatch equivalent.
"""

from __future__ import annotations

import time

import jax


def time_device(fn, n: int = 10, warmup: int = 1) -> float:
    """Mean wall time per call of `fn` (s) over n back-to-back calls.

    `warmup` calls run first (compilation included) and are waited on; the
    timed loop dispatches n calls and waits once, on the last result."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n
