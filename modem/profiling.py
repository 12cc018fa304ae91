"""Observability: structured per-stage metrics and profiler traces.

The reference's diagnostics are unconditional stderr prints
(SURVEY.md §5); here the pipelines already return structured records
(DecodeResult / batch dicts) and this module adds the two aux tools:
a jax.profiler trace context and a simple wall-clock stage timer that
aggregates across jit boundaries.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture an XLA profiler trace (view with TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StageTimer:
    """Accumulates blocking wall-clock per named stage.

    Usage:
        timer = StageTimer()
        with timer("sync") as stage:
            stage.out = sync_fn(x)
    On exit the context blocks on ``stage.out`` (anything
    jax.block_until_ready accepts) so device work is charged to the
    right stage instead of draining inside whichever later stage
    happens to block first.  To charge the device-to-host copy to the
    stage as well, assign a HOST value, e.g.
    ``stage.out = np.asarray(y)``.
    """

    class _Stage:
        __slots__ = ("out",)

        def __init__(self):
            self.out = None

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        stage = self._Stage()
        t0 = time.perf_counter()
        try:
            yield stage
        finally:
            if stage.out is not None:
                jax.block_until_ready(stage.out)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{k:24s} {self.totals[k] * 1e3:9.1f} ms "
                 f"({self.counts[k]}x)"
                 for k in sorted(self.totals, key=self.totals.get,
                                 reverse=True)]
        return "\n".join(lines)
