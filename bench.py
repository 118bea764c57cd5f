"""Benchmarks for the BASELINE.json north-star workloads.

Lanes (all on the attached chip(s), compile excluded):

1. ``train``: FBCRNN training throughput, full device pipeline per step
   (waveform -> STFT -> warped mel -> aug -> CNN -> fwd/bwd GRU ->
   losses -> grads -> Adam), single-step and K-steps-per-XLA-call.
2. ``ensemble``: 10-model stacked-ensemble sliding-window SED inference
   (the pseudo-labeling workload: ``BASELINE.json`` "10-model ensemble
   pseudo-labeling inference"); members evaluate as one vmapped XLA
   program.
3. ``host``: end-to-end training including the HOST pipeline — synthetic
   wav corpus decoded, bucketed, collated and shipped per step (nothing
   pre-staged on device).

Per-step wall time is recorded for K=1 and K=10/50 steps-per-call, the
XLA-reported per-step FLOPs give an achieved rate against the card's
published bf16 peak (``pb_sed_tpu.utils.device.PEAKS``), and a JAX
profiler trace gives device time and idle share. Every result carries
the device (platform, kind, count) and the card's name and power limit.
The bench needs a GPU; a lane that fails makes the exit code non-zero.

Prints ONE final JSON line {"metric", "value", "unit", "vs_baseline", ...}.
"""
import argparse
import json
import sys
import time

import numpy as np

# Derived, not assumed (BASELINE.md "Derived A100 throughput
# baseline"): component model of the reference PyTorch FBCRNN train
# step on one A100-SXM — TF32 tensor-core convs at fill-discounted
# efficiency, cuDNN GRU at its small-batch recurrent-GEMM rate, f32
# HBM elementwise terms, eager-mode overhead — lands at ~45 ms/step
# at bs=32, i.e. ~700 clips/s (range 460 tuned-f32 .. 1280 bf16-AMP).
# The reference publishes no throughput numbers to measure against.
A100_BASELINE_CLIPS_PER_SEC = 700.
BATCH_SIZE = 32
SECONDS = 10.


def _timed(fn, n, *args):
    """Wall seconds for n calls of fn (blocking on the last result)."""
    import jax
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return time.perf_counter() - t0


def _step_gflops(trainer, batch):
    """XLA's cost-model FLOPs of one compiled train step."""
    import jax.numpy as jnp
    lowered = trainer._step_fn.lower(
        trainer.model.variables, trainer.opt_state, batch,
        jnp.asarray(trainer._device_step_state[0]),
        jnp.asarray(0, jnp.int32), jnp.asarray(1., jnp.float32))
    cost = lowered.compile().cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    return float(cost['flops']) / 1e9


def _bf16_peak_tflops():
    import jax
    from pb_sed_tpu.utils.device import device_peaks
    return device_peaks(jax.devices()[0].device_kind)['bf16_flops'] / 1e12


def _traced_steps(step, n, logdir):
    """Run ``step`` n times under the profiler, one annotated and
    blocked step each; returns (per-step device ms, busy summary)."""
    import jax
    from pb_sed_tpu.utils.xplane import device_busy, device_step_times_ms
    jax.profiler.start_trace(str(logdir))
    for i in range(n):
        with jax.profiler.StepTraceAnnotation('step', step_num=i):
            jax.block_until_ready(step())
    jax.profiler.stop_trace()
    busy = device_busy(logdir)
    return device_step_times_ms(logdir), busy[sorted(busy)[0]]


def lane_train(results):
    import jax
    import jax.numpy as jnp
    from __graft_entry__ import _batch, _flagship_model
    from pb_sed_tpu.train.trainer import Trainer

    model = _flagship_model()
    trainer = Trainer(model, storage_dir=None,
                      stop_trigger=(10 ** 9, 'iteration'))
    batch = _batch(model, batch_size=BATCH_SIZE, seconds=SECONDS)
    trainer._ensure_ready(batch)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    n_chips = jax.device_count()

    for _ in range(3):  # compile + warm
        trainer.train_step(batch)
    jax.block_until_ready(trainer.model.variables)
    n = 20
    wall = []
    for _ in range(n):
        t0 = time.perf_counter()
        trainer.train_step(batch)
        jax.block_until_ready(trainer.model.variables)
        wall.append(time.perf_counter() - t0)
    results['train_single_clips_per_s_chip'] = round(
        BATCH_SIZE / float(np.median(wall)) / n_chips, 2)
    results['train_step_wall_ms'] = {
        'median': round(1e3 * float(np.median(wall)), 3),
        'min': round(1e3 * float(np.min(wall)), 3),
    }

    # XLA-reported per-step FLOPs -> achieved TFLOP/s at the best step
    gflops = _step_gflops(trainer, batch)
    results['train_step_gflops_xla'] = round(gflops, 2)
    results['achieved_tflops_best'] = round(
        gflops / 1e3 / float(np.min(wall)), 2)
    results['mfu_wall'] = round(
        gflops / 1e3 / float(np.min(wall)) / _bf16_peak_tflops(), 4)

    # multi-step lanes: dispatch amortized over K steps per XLA call
    for k in (10, 50):
        trainer.steps_per_call = k
        trainer._step_fn = None
        trainer._ensure_ready(batch)
        batches = [batch] * k
        trainer.train_steps(batches)  # compile
        jax.block_until_ready(trainer.model.variables)
        n_calls = 3
        dt = _timed(lambda: trainer.train_steps(batches), n_calls)
        jax.block_until_ready(trainer.model.variables)
        per_step = dt / (n_calls * k)
        results[f'train_multi_k{k}_clips_per_s_chip'] = round(
            BATCH_SIZE / per_step / n_chips, 2)
        results[f'train_multi_k{k}_wall_ms_per_step'] = round(
            1e3 * per_step, 3)


def lane_deep(results):
    """Deep width-2 recipe train step (the reference's best-quality
    config — AudioSet pre-training / 'with external data' rows,
    reference ``experiments/weak_label_crnn/training.py:158-185``) at
    bs=16, device-timed from a profiler trace."""
    import jax
    import jax.numpy as jnp
    from __graft_entry__ import _batch
    from pb_sed_tpu.models import weak_label
    from pb_sed_tpu.models.net_configs import fbcrnn_config
    from pb_sed_tpu.train.trainer import Trainer

    deep_bs = 16
    config = weak_label.CRNN.get_config(
        fbcrnn_config(net_config='deep', num_events=10))
    model = weak_label.CRNN.from_config(config)
    trainer = Trainer(model, storage_dir=None,
                      stop_trigger=(10 ** 9, 'iteration'))
    batch = _batch(model, batch_size=deep_bs, seconds=SECONDS)
    trainer._ensure_ready(batch)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(3):
        trainer.train_step(batch)
    jax.block_until_ready(trainer.model.variables)
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        times, _ = _traced_steps(
            lambda: (trainer.train_step(batch), trainer.model.variables),
            6, td)
    span = float(np.median(times))
    results['deep_device_ms_per_step'] = round(span, 3)
    results['deep_train_clips_per_s_chip'] = round(
        deep_bs / (span / 1e3) / jax.device_count(), 2)
    gflops = _step_gflops(trainer, batch)
    results['deep_step_gflops_xla'] = round(gflops, 2)
    results['deep_mfu_device'] = round(
        gflops / 1e3 / (span / 1e3) / _bf16_peak_tflops(), 4)


def lane_ensemble(results, n_models=10):
    """10-model ensemble sliding-window SED (pseudo-labeling workload),
    through the PRODUCTION path (``default_ensemble_mesh`` — same mesh
    resolution the CLIs get from ``base.inference``), with a 1-member
    scaling point and a device trace (device time, idle share)."""
    import jax
    import jax.numpy as jnp
    from __graft_entry__ import _batch, _flagship_model
    from pb_sed_tpu.models.base.ensemble import StackedEnsemble
    from pb_sed_tpu.parallel.mesh import default_ensemble_mesh

    models = []
    for i in range(n_models):
        m = _flagship_model()
        b = _batch(m, batch_size=2, seconds=SECONDS, seed=i)
        m.init_variables(b, seed=i)
        models.append(m)
    mesh = default_ensemble_mesh(n_models)
    # bs=32 in chunks of 8: the sliding-window fold multiplies the
    # batch by ~T windows; on a single device the chunks run INSIDE one
    # compiled program (lax.map over a (4, 8, ...) reshape)
    runner = StackedEnsemble(models, mesh=mesh, chunk_size=8)
    results['ensemble10_mesh'] = (
        dict(mesh.shape) if mesh is not None else None)
    results['ensemble10_chunk_size'] = 8
    ens_batch = 32
    batch = _batch(models[0], batch_size=ens_batch, seconds=SECONDS)
    batch = {k: jnp.asarray(v) for k, v in batch.items()
             if isinstance(v, np.ndarray)}
    n_chips = jax.device_count()
    # tuned scenario-1 window (median of the reference grid) at shift 1
    kwargs = dict(window_length=31, window_shift=1)
    runner.sound_event_detection(batch, **kwargs)  # compile
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        y, _ = runner.sound_event_detection(batch, **kwargs)
    dt = time.perf_counter() - t0
    results['ensemble10_sed_clips_per_s_chip'] = round(
        ens_batch * n / dt / n_chips, 2)
    results['ensemble10_sed_wall_ms_per_batch'] = round(1e3 * dt / n, 2)

    # pipelined production pattern (models/base/inference.py): batch
    # k+1 is DISPATCHED (runner.dispatch, async device arrays) before
    # batch k's outputs are materialized, so the host conversion
    # overlaps the next batch's device compute. This is the loop the
    # inference driver runs over a dataset; the serial figure above is
    # the dispatch-convert-dispatch pattern the reference uses.
    prev = None
    t0 = time.perf_counter()
    for _ in range(n):
        cur = runner.dispatch('sound_event_detection', batch, **kwargs)
        if prev is not None:
            np.asarray(prev[0])
            np.asarray(prev[1])
        prev = cur
    np.asarray(prev[0])
    np.asarray(prev[1])
    dt_p = time.perf_counter() - t0
    results['ensemble10_sed_pipelined_wall_ms_per_batch'] = round(
        1e3 * dt_p / n, 2)
    results['ensemble10_sed_pipelined_clips_per_s_chip'] = round(
        ens_batch * n / dt_p / n_chips, 2)

    # member-count scaling: 1-member reference point (same batch/window)
    runner1 = StackedEnsemble(models[:1], mesh=default_ensemble_mesh(1),
                              chunk_size=8)
    runner1.sound_event_detection(batch, **kwargs)  # compile
    dt1 = _timed(
        lambda: runner1.sound_event_detection(batch, **kwargs), n)
    results['ensemble1_sed_wall_ms_per_batch'] = round(1e3 * dt1 / n, 2)
    results['ensemble10_vs_1_scaling'] = round(dt / dt1, 2)

    # device time and idle share: trace 3 ensemble batches
    from pathlib import Path
    import shutil
    logdir = Path('bench_profile_ensemble')
    if logdir.exists():
        shutil.rmtree(logdir)
    times, busy = _traced_steps(
        lambda: runner.sound_event_detection(batch, **kwargs)[0], 3,
        logdir)
    results['ensemble10_device_ms'] = round(float(np.median(times)), 3)
    results['ensemble10_idle_share'] = round(busy['idle_share'], 4)


def lane_host(results):
    """End-to-end: host pipeline (decode -> bucket -> collate) included."""
    import tempfile
    from pathlib import Path

    import jax
    sys.path.insert(0, 'tests')
    from util_synth import build_database

    from pb_sed_tpu.data.provider import DataProvider
    from pb_sed_tpu.train.trainer import Trainer
    from __graft_entry__ import _flagship_model

    with tempfile.TemporaryDirectory() as tmp:
        # synthetic corpus at the flagship STFT geometry
        _, json_path = build_database(
            Path(tmp) / 'db', num_train=96, num_weak=32,
            clip_seconds=4.)
        config = DataProvider.get_config({
            'json_path': str(json_path),
            'train_set': {'train_strong': 1, 'train_weak': 1},
            'validate_set': 'validation',
            'min_audio_length': 0.2,
            'storage_dir': tmp,
            'train_transform': {
                'provide_boundary_targets': True,
            },
            'train_fetcher': {'batch_size': BATCH_SIZE,
                              'prefetch_workers': 2,
                              'drop_incomplete': True,
                              # int16 waveforms halve per-step H2D bytes
                              'audio_dtype': 'int16'},
            'mix_interval': 2.,
        })
        provider = DataProvider.from_config(config)
        provider.train_transform.label_encoder.initialize_labels(
            dataset=provider.db.get_dataset(
                ['train_strong', 'train_weak']))
        provider.test_transform.label_encoder.initialize_labels()
        model = _flagship_model_for_events(provider)
        trainer = Trainer(model, storage_dir=None,
                          stop_trigger=(10 ** 9, 'iteration'))
        train_set = provider.get_train_set()
        # one epoch to compile every palette shape
        n_warm = 0
        for batch in train_set:
            trainer.train_step(batch)
            n_warm += 1
        jax.block_until_ready(trainer.model.variables)
        clips = 0
        t0 = time.perf_counter()
        for batch in train_set:
            trainer.train_step(batch)
            clips += len(batch['example_id'])
        jax.block_until_ready(trainer.model.variables)
        dt = time.perf_counter() - t0
        n_chips = jax.device_count()
        results['host_pipeline_clips_per_s_chip'] = round(
            clips / dt / n_chips, 2)
        results['host_pipeline_batches'] = n_warm

        # HOST-ONLY throughput: decode -> bucket -> collate with NO
        # device step, scaled workers — bounds what the host path can
        # feed the card. Workers capped at the core count. f32 transport
        # here: the int16 quantization of the END-TO-END lane above
        # costs an extra host pass per batch, which this host-capability
        # lane should not pay
        import os as _os
        provider.train_fetcher.prefetch_workers = min(
            8, _os.cpu_count() or 1)
        provider.train_fetcher.audio_dtype = 'float32'
        results['host_cpu_count'] = _os.cpu_count()
        host_set = provider.get_train_set()
        for _ in host_set:  # warm decode caches / thread pools
            pass
        clips = 0
        t0 = time.perf_counter()
        for _ in range(3):
            for batch in host_set:
                clips += len(batch['example_id'])
        dt = time.perf_counter() - t0
        results['host_only_clips_per_s'] = round(clips / dt, 2)

        # per-STAGE breakdown (sequential, VERDICT r3 #4): attributes
        # the host ms/clip to decode+augment vs transform vs
        # bucket+collate so the worker-scaling extrapolation is
        # principled (the parallelizable stage is the rng-free decode)
        provider.train_fetcher.prefetch_workers = 0
        provider.decode_workers = 0

        def _clips_per_s(ds, passes=2):
            for _ in ds:  # warm caches
                pass
            n = 0
            t0 = time.perf_counter()
            for _ in range(passes):
                for item in ds:
                    n += (len(item['example_id'])
                          if isinstance(item, dict)
                          and isinstance(item.get('example_id'), list)
                          else 1)
            return round(n / (time.perf_counter() - t0), 2)

        try:
            results['host_stage_decode_aug_clips_per_s'] = _clips_per_s(
                provider.prepare_audio(provider.train_set, train=True))
            results['host_stage_plus_transform_clips_per_s'] = \
                _clips_per_s(provider.segment_transform_and_fetch(
                    provider.prepare_audio(provider.train_set,
                                           train=True),
                    fetch=False, train=True))
        except Exception as exc:  # noqa: BLE001 — evidence only
            print(f'host stage breakdown skipped: {exc!r}',
                  file=sys.stderr)

        # decode-workers axis (ordered thread-pool decode,
        # lazy.ParallelMapDataset; the wav decode releases the GIL so
        # the curve scales with cores)
        by_workers = {}
        for w in (0, 2, 4):
            provider.decode_workers = w
            try:
                by_workers[str(w)] = _clips_per_s(
                    provider.get_train_set(), passes=1)
            except Exception as exc:  # noqa: BLE001
                print(f'decode_workers={w} skipped: {exc!r}',
                      file=sys.stderr)
        provider.decode_workers = 0
        results['host_only_clips_per_s_by_decode_workers'] = by_workers

        # cached-features lanes: decode ONCE, memmap after.
        # (a) memmap AUDIO cache (data/cache.py MemmapAudioCache via
        #     provider.cache_dir): removes decode+resample+normalize
        #     per epoch; augmentation randomness stays live, so this is
        #     the production train path on a slow host.
        try:
            provider.cached_datasets = ['train_strong', 'train_weak']
            provider.cache_dir = str(Path(tmp) / 'audio_cache')
            results['host_cached_audio_clips_per_s'] = _clips_per_s(
                provider.get_train_set(), passes=3)
        except Exception as exc:  # noqa: BLE001
            print(f'cached-audio lane skipped: {exc!r}', file=sys.stderr)
        # (b) collated-BATCH cache (BatchCache): palette-shaped batches
        #     replayed verbatim — exact for rng-free pipelines
        #     (validation/inference, aug-free training); bounds what a
        #     fully-precomputed feature store feeds the chip.
        try:
            from pb_sed_tpu.data.cache import BatchCache
            replay = BatchCache(Path(tmp) / 'batch_cache').build(
                provider.get_train_set())
            results['host_cached_batches_clips_per_s'] = _clips_per_s(
                replay, passes=3)
        except Exception as exc:  # noqa: BLE001
            print(f'cached-batch lane skipped: {exc!r}', file=sys.stderr)


def _flagship_model_for_events(provider):
    """Flagship model resized to the synthetic DB's class count."""
    from pb_sed_tpu.models import weak_label
    from pb_sed_tpu.models.net_configs import fbcrnn_config
    k = len(provider.train_transform.label_encoder.label_mapping)
    config = weak_label.CRNN.get_config(fbcrnn_config(
        net_config='shallow', num_events=k))
    return weak_label.CRNN.from_config(config)


def lane_profile(results):
    """Capture a profiler trace of 3 train steps next to the result."""
    import jax
    import jax.numpy as jnp
    from __graft_entry__ import _batch, _flagship_model
    from pb_sed_tpu.train.trainer import Trainer
    from pathlib import Path
    logdir = Path('bench_profile')
    model = _flagship_model()
    trainer = Trainer(model, storage_dir=None,
                      stop_trigger=(10 ** 9, 'iteration'))
    batch = _batch(model, batch_size=BATCH_SIZE, seconds=SECONDS)
    trainer._ensure_ready(batch)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(2):
        trainer.train_step(batch)
    jax.block_until_ready(trainer.model.variables)
    if logdir.exists():  # stale traces would skew the parsed medians
        import shutil
        shutil.rmtree(logdir)
    logdir.mkdir()
    jax.profiler.start_trace(str(logdir))
    for i in range(3):
        with jax.profiler.StepTraceAnnotation('train', step_num=i):
            trainer.train_step(batch)
            jax.block_until_ready(trainer.model.variables)
    jax.profiler.stop_trace()
    results['profile_trace_dir'] = str(logdir)
    from pb_sed_tpu.utils.xplane import device_busy, device_step_times_ms
    times = device_step_times_ms(logdir)
    ms = float(np.median(times))
    results['device_ms_per_step_from_trace'] = round(ms, 3)
    gflops = results.get('train_step_gflops_xla') or _step_gflops(
        trainer, batch)
    results['mfu_device'] = round(
        gflops / 1e3 / (ms / 1e3) / _bf16_peak_tflops(), 4)
    busy = device_busy(logdir)
    results['train_idle_share'] = round(
        busy[sorted(busy)[0]]['idle_share'], 4)


def _emit_final(results):
    """Print the contract-format final JSON line to STDOUT (flush).

    Called after EVERY lane so the last stdout line is always a
    parseable, current snapshot — a driver kill mid-lane loses only
    that lane, not the round (driver contract: ONE final JSON line,
    last line wins)."""
    candidates = [
        results.get('train_single_clips_per_s_chip'),
        results.get('train_multi_k10_clips_per_s_chip'),
        results.get('train_multi_k50_clips_per_s_chip'),
    ]
    headline = max([c for c in candidates if c] or [0.])
    print(json.dumps({
        'metric': 'FBCRNN train clips/sec/chip (10s DESED clips, bs=32, '
                  'full device pipeline)',
        'value': headline,
        'unit': 'clips/s/chip',
        'vs_baseline': round(headline / A100_BASELINE_CLIPS_PER_SEC, 3),
        'a100_baseline_clips_per_s': A100_BASELINE_CLIPS_PER_SEC,
        'a100_baseline_note': (
            'derived component model of the torch reference on one '
            'A100 (BASELINE.md), range 460-1280; earlier rounds '
            'divided by an assumed 200'),
        **results,
    }), flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument(
        '--lanes', default='train,profile,deep,ensemble,host',
        help='comma list: train,profile,deep,ensemble,host')
    args = parser.parse_args()
    lanes = args.lanes.split(',')
    sys.path.insert(0, '.')
    from pb_sed_tpu.utils.device import (
        configure_compile_cache, gpu_name_power_limit, require_gpu)
    configure_compile_cache()
    devices = require_gpu()
    results = {
        'device': {'platform': devices[0].platform,
                   'kind': devices[0].device_kind,
                   'count': len(devices)},
        'gpu_name_power_limit': gpu_name_power_limit(),
        'lanes_done': [],
    }
    failed = []
    for name, fn in (('train', lane_train), ('profile', lane_profile),
                     ('deep', lane_deep), ('ensemble', lane_ensemble),
                     ('host', lane_host)):
        if name not in lanes:
            continue
        t_lane = time.perf_counter()
        try:
            fn(results)
        except Exception as exc:  # noqa: BLE001 — report, run the rest
            import traceback
            traceback.print_exc()
            results[f'{name}_error'] = repr(exc)
            failed.append(name)
        results['lanes_done'] = results['lanes_done'] + [name]
        print(f'[lane {name} done in '
              f'{time.perf_counter() - t_lane:.1f}s]', file=sys.stderr,
              flush=True)
        # contract line after EVERY lane: a later kill cannot erase it
        _emit_final(results)
    if failed:
        print(f'lanes failed: {failed}', file=sys.stderr)
        sys.exit(1)


if __name__ == '__main__':
    main()
