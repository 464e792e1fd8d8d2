"""Tracing/profiling hooks (SURVEY.md section 5.1: the reference has none;
the framework exposes jax.profiler traces and simple wall-clock/roofline
counters from the start)."""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(dirname):
    """Capture a jax.profiler trace viewable in TensorBoard/Perfetto."""
    jax.profiler.start_trace(dirname)
    try:
        yield dirname
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Blocking wall-clock timer for jitted callables."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    def best(self):
        return min(self.times)

    def mean(self):
        return sum(self.times) / len(self.times)


def benchmark(fn, *args, reps=10, warmup=2):
    """Time a jax callable with proper blocking; returns seconds/call."""
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def steps_per_second(n_boards, n_steps, seconds):
    return n_boards * n_steps / seconds
