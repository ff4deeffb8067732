"""Profiling hooks: wall timers + jax.profiler traces.

Replaces the reference's cProfile wrappers and time.time() prints
(``01_make_dict.py:335-341``, ``04_align_n_nmf.py:436,470``, SURVEY §5.1)
with device-aware timing (block_until_ready) and XLA trace capture."""

from __future__ import annotations

import contextlib
import time

import jax


def _device_fence():
    """Block until previously dispatched work on the default device drains.

    ``jax.effects_barrier()`` only waits for side-EFFECTING computations —
    pure jitted work has no effects token, so it returns immediately. A
    trivial computation dispatched NOW executes after all pending work on
    the same (in-order) device stream; blocking on it fences the stream.
    """
    jax.block_until_ready(jax.numpy.zeros(()) + 1.0)


class Timer:
    """Wall-clock timer, optionally fencing device work.

    ``sync=False`` (default) measures raw host wall time: async dispatches
    may still be draining when the block exits — exactly what the pipeline's
    stage splits want (stages intentionally overlap on device; a fence per
    stage would serialize the pipeline and cost one round trip each).
    ``sync=True`` fences the default device's stream
    before and after the block, so ``elapsed`` covers device EXECUTION —
    use it for isolated kernel timings. (Earlier revisions used
    ``jax.effects_barrier()`` for sync, which never waits for PURE jitted
    work and so silently behaved like sync=False.)

    >>> with Timer("nmf", sync=True) as t: result = f(x)
    >>> t.elapsed
    """

    def __init__(self, name: str = "", sync: bool = False):
        self.name = name
        self.sync = sync
        self.elapsed = 0.0

    def __enter__(self):
        if self.sync:
            _device_fence()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync:
            _device_fence()
        self.elapsed = time.perf_counter() - self._t0
        return False


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Capture a jax.profiler trace (inspect with tensorboard/xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
