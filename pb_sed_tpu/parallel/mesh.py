"""Device mesh + sharding helpers.

The distributed-communication component the reference lacks entirely
(SURVEY.md §2.4): a ``jax.sharding.Mesh`` with ``data`` (and optionally
``ensemble``) axes; batches are sharded over ``data``, parameters
replicated, and XLA inserts the gradient all-reduce. Multi-
host entry goes through ``jax.distributed.initialize`` (``initialize``
below is a no-op on a single host).
"""
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed():
    """Multi-host init (safe no-op when not in a multi-host environment)."""
    import os
    if 'JAX_COORDINATOR_ADDRESS' in os.environ:
        jax.distributed.initialize()


def get_mesh(axis_name='data', devices=None, ensemble_size=None):
    """1-D data mesh, or 2-D (ensemble, data) mesh when ensemble_size set."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if ensemble_size is not None and ensemble_size > 1:
        assert len(devices) % ensemble_size == 0, (
            len(devices), ensemble_size)
        grid = devices.reshape(ensemble_size, -1)
        return Mesh(grid, ('ensemble', axis_name))
    return Mesh(devices.reshape(-1), (axis_name,))


def default_ensemble_mesh(n_models, devices=None):
    """Production default for ensemble inference (the north-star
    pseudo-labeling workload): members shard over an ``ensemble`` axis of
    size gcd(n_models, n_devices) — the largest size that both divides
    the device grid and splits the members evenly — and the batch over
    the remaining ``data`` axis. Returns None on a single device (the
    vmapped single-chip lane needs no mesh); a 1-D data mesh when the
    counts are coprime (members stay local, batch shards over devices)."""
    import math
    devices = list(devices if devices is not None else jax.devices())
    if len(devices) <= 1:
        return None
    ensemble_size = math.gcd(int(n_models), len(devices))
    if ensemble_size <= 1:
        return get_mesh(devices=devices)
    return get_mesh(devices=devices, ensemble_size=ensemble_size)


def batch_sharding(mesh, axis_name='data'):
    return NamedSharding(mesh, P(axis_name))


def stacked_batch_sharding(mesh, axis_name='data'):
    """Sharding for (K, B, ...) multi-step stacked batches: the steps
    axis K is replicated (scanned over), the batch axis B sharded."""
    return NamedSharding(mesh, P(None, axis_name))


def replicated_sharding(mesh):
    return NamedSharding(mesh, P())


def pad_batch_to_multiple(batch, multiple):
    """Pad the batch axis by repeating the last example so it divides the
    data-mesh size. Padded examples carry all-soft (0.5) weak targets so
    losses and metric buffers ignore them (soft-label masking)."""
    arrays = {k: v for k, v in batch.items()
              if isinstance(v, np.ndarray) and v.ndim >= 1}
    if not arrays:
        return batch, 0
    b = next(iter(arrays.values())).shape[0]
    pad = (-b) % multiple
    if pad == 0:
        return batch, 0
    out = dict(batch)
    for key, value in batch.items():
        if isinstance(value, np.ndarray) and value.ndim >= 1 \
                and value.shape[0] == b:
            reps = np.concatenate([value, np.repeat(
                value[-1:], pad, axis=0)], axis=0)
            if key.endswith('_targets'):
                reps[b:] = 0.5
            out[key] = reps
        elif isinstance(value, list) and len(value) == b:
            out[key] = value + [value[-1]] * pad
    return out, pad


def shard_device_batch(batch, mesh, axis_name='data'):
    """Place numeric batch entries sharded over the data axis."""
    sharding = batch_sharding(mesh, axis_name)
    out = {}
    for key, value in batch.items():
        if isinstance(value, (np.ndarray, jax.Array)):
            out[key] = jax.device_put(value, sharding)
    return out


def make_global_batch(batch, mesh, axis_name='data'):
    """Host-local numpy batch slices -> GLOBAL sharded jax.Arrays.

    In a multi-process run each host holds only its shard of the global
    batch (``DataFetcher`` shard modes); jit with global ``in_shardings``
    needs globally-shaped arrays, so the local slices are assembled with
    ``jax.make_array_from_process_local_data`` (data stays on the local
    devices; only metadata is global). Single-process: plain device_put.
    """
    sharding = batch_sharding(mesh, axis_name)
    multiprocess = jax.process_count() > 1
    out = {}
    for key, value in batch.items():
        if not isinstance(value, (np.ndarray, jax.Array)) and not (
                isinstance(value, (int, float))
                and not isinstance(value, bool)):
            continue
        value = np.asarray(value)
        if multiprocess and value.ndim >= 1:
            out[key] = jax.make_array_from_process_local_data(
                sharding, value)
        else:
            out[key] = jax.device_put(value)
    return out
