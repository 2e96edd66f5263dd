"""Profiling / tracing hooks — the observability layer (SURVEY.md section 5).

Reference equivalents: cudaEvent timing behind #define COUNTER
(device/include/lanczos_complex.hpp:12,324-400), std::chrono driver walltime,
and per-run Python walltime persisted to HDF5. Versions here:

* `trace(logdir)` — context manager around `jax.profiler` producing a
  TensorBoard/Perfetto trace of every XLA computation inside.
* `StepTimer` — walltime accounting with device synchronization
  (`jax.block_until_ready` on the lap's result).
* `annotate(name)` — TraceAnnotation passthrough so named regions show up
  inside profiler traces.
"""

import contextlib
import time

import jax
import numpy as np

__all__ = ["trace", "StepTimer", "annotate"]


@contextlib.contextmanager
def trace(logdir):
    """jax.profiler trace around a block: `with trace("/tmp/tb"): step()`."""
    jax.profiler.start_trace(str(logdir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name):
    """Named region visible in profiler traces."""
    return jax.profiler.TraceAnnotation(name)


class StepTimer:
    """Accumulates per-step walltimes with device-synchronized laps.

    >>> t = StepTimer()
    >>> for _ in range(n): out = step(out); t.lap(out)
    >>> t.summary()   # {'mean_s', 'p50_s', 'p95_s', 'steps_per_s', ...}
    """

    def __init__(self):
        self.laps = []
        self._t0 = time.perf_counter()

    def reset(self):
        self.laps.clear()
        self._t0 = time.perf_counter()

    def lap(self, result=None):
        if result is not None:
            jax.block_until_ready(result)
        now = time.perf_counter()
        self.laps.append(now - self._t0)
        self._t0 = now

    def summary(self):
        if not self.laps:
            return {}
        arr = np.asarray(self.laps)
        return {
            "count": int(arr.size),
            "total_s": float(arr.sum()),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "steps_per_s": float(1.0 / arr.mean()),
        }
