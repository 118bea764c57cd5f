"""Profiling / tracing utilities.

The reference has no profiler beyond wall-clock + codecarbon (SURVEY.md
§5); the device-side equivalents are JAX profiler traces (viewable in
TensorBoard / Perfetto) and per-step timing, plus a simple timer registry
for host-side stages.
"""
import contextlib
import time
from collections import defaultdict
from pathlib import Path


@contextlib.contextmanager
def jax_profile(logdir):
    """Capture a JAX profiler trace into ``logdir`` (TensorBoard format).

    Usage::

        with jax_profile(storage_dir / 'profile'):
            trainer.train_step(batch)
    """
    import jax
    logdir = str(logdir)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Accumulating named wall-clock timers for host-side stages."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self):
        return {
            name: {'total_s': self.totals[name],
                   'count': self.counts[name],
                   'mean_ms': 1000. * self.totals[name]
                   / max(self.counts[name], 1)}
            for name in self.totals
        }

    def print_summary(self):
        for name, stats in sorted(self.summary().items()):
            print(f'{name}: {stats["mean_ms"]:.2f} ms x '
                  f'{stats["count"]} = {stats["total_s"]:.2f} s')
