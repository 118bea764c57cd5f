"""Device time from a JAX profiler trace (``.xplane.pb``), read with
``jax.profiler.ProfileData``.

In a GPU trace each card is a plane named ``/device:GPU:<n>``. Its lines
are CUDA streams (``Stream #<id>(<kind>)``) and its events are kernels
and copies, with stats that name the XLA module (``hlo_module``), the
HLO op (``hlo_op``) and the JAX name stack (``name``). The host planes
carry the program's ``jax.profiler.StepTraceAnnotation`` spans (events
with a ``step_num`` stat). All events share one clock.

Per-step device time is the union of the kernel intervals that start
inside a step's host span (from its start to the next step's start).
That split is exact when every step ends in ``block_until_ready``;
without it the host runs ahead and kernels land in a later step, though
the total stays right.
"""
import collections
from pathlib import Path

DEVICE_PLANE_PREFIX = '/device:GPU:'

Kernel = collections.namedtuple(
    'Kernel', 'start_ns end_ns name module scope')
Trace = collections.namedtuple('Trace', 'devices steps')


def _xplane_files(trace_dir):
    """The .xplane.pb files of the newest run under ``trace_dir``."""
    files = sorted(Path(trace_dir).rglob('*.xplane.pb'))
    if not files:
        raise FileNotFoundError(f'no .xplane.pb under {trace_dir}')
    newest = max(f.parent for f in files)
    return [f for f in files if f.parent == newest]


def read_trace(trace_dir):
    """``Trace(devices={plane: [Kernel]}, steps=[(start_ns, step_num)])``;
    raises RuntimeError when the trace holds no GPU device plane."""
    from jax.profiler import ProfileData
    devices = {}
    steps = []
    for path in _xplane_files(trace_dir):
        for plane in ProfileData.from_file(str(path)).planes:
            if plane.name.startswith(DEVICE_PLANE_PREFIX):
                kernels = devices.setdefault(plane.name, [])
                for line in plane.lines:
                    for ev in line.events:
                        stats = dict(ev.stats)
                        kernels.append(Kernel(
                            ev.start_ns, ev.start_ns + ev.duration_ns,
                            ev.name, stats.get('hlo_module', ''),
                            stats.get('name', '')))
            elif plane.name.startswith('/host:'):
                for line in plane.lines:
                    for ev in line.events:
                        stats = dict(ev.stats)
                        if 'step_num' in stats:
                            steps.append((ev.start_ns,
                                          int(stats['step_num'])))
    if not devices:
        raise RuntimeError(
            f'no device plane ({DEVICE_PLANE_PREFIX}*) in the trace under '
            f'{trace_dir}: nothing ran on a GPU')
    for kernels in devices.values():
        kernels.sort()
    steps.sort()
    return Trace(devices, steps)


def describe(trace_dir):
    """[(plane name, [(line name, n_events)])] of every plane — what a
    trace holds, for a look by hand."""
    from jax.profiler import ProfileData
    out = []
    for path in _xplane_files(trace_dir):
        for plane in ProfileData.from_file(str(path)).planes:
            out.append((plane.name, [(line.name, len(list(line.events)))
                                     for line in plane.lines]))
    return out


def union_ns(intervals):
    """Total length covered by (start, end) intervals."""
    total = 0
    last = None
    for start, end in sorted(intervals):
        if last is None or start >= last:
            total += end - start
            last = end
        elif end > last:
            total += end - last
            last = end
    return total


def device_step_times_ms(trace_dir, device=None):
    """Busy ms of one device (default: the first) per annotated step;
    a single entry for the whole trace when no step is annotated."""
    trace = read_trace(trace_dir)
    kernels = trace.devices[device or sorted(trace.devices)[0]]
    starts = [s for s, _ in trace.steps] or [kernels[0].start_ns]
    bounds = starts[1:] + [float('inf')]
    times = []
    for lo, hi in zip(starts, bounds):
        inside = [(k.start_ns, k.end_ns) for k in kernels
                  if lo <= k.start_ns < hi]
        times.append(union_ns(inside) / 1e6)
    return times


def device_busy(trace_dir):
    """Per device: ``window_ms`` from the first step start (or first
    kernel) to the last kernel end, ``busy_ms`` (union of kernel
    intervals in it) and ``idle_share`` = 1 - busy / window."""
    trace = read_trace(trace_dir)
    out = {}
    for plane, kernels in sorted(trace.devices.items()):
        start = (trace.steps[0][0] if trace.steps
                 else kernels[0].start_ns)
        end = max(k.end_ns for k in kernels)
        busy = union_ns([(max(k.start_ns, start), k.end_ns)
                         for k in kernels if k.end_ns > start])
        window = max(end - start, 1)
        out[plane] = {'window_ms': window / 1e6, 'busy_ms': busy / 1e6,
                      'idle_share': 1. - busy / window}
    return out


def kernel_breakdown_ms(trace_dir, key='name', top=None):
    """{kernel name (or ``key='module'`` / ``'scope'``): (total_ms,
    count)} over all devices, largest first."""
    totals = {}
    for kernels in read_trace(trace_dir).devices.values():
        for k in kernels:
            name = getattr(k, key)
            total, count = totals.get(name, (0., 0))
            totals[name] = (total + (k.end_ns - k.start_ns) / 1e6,
                            count + 1)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])
    return dict(ranked[:top] if top else ranked)


if __name__ == '__main__':
    import sys
    trace = sys.argv[1] if len(sys.argv) > 1 else 'bench_profile'
    for plane, lines in describe(trace):
        print(plane, lines)
    print('device ms per step:', device_step_times_ms(trace))
    print('busy:', device_busy(trace))
    for name, (ms, count) in kernel_breakdown_ms(trace, top=30).items():
        print(f'  {ms:9.3f}  x{count:<5d} {name}')
