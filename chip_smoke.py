"""Smoke run of the main path on the GPU, in one process.

    python chip_smoke.py            # one card: every phase below but 6
    python chip_smoke.py --multi    # four cards: phase 6 only

1. Device check: JAX's first device must be a GPU; prints its kind, the
   JAX version and ``nvidia-smi`` name and power limit.
2. Train: ``Trainer.train_step`` on the full-width shallow FBCRNN (10 s
   clips at 16 kHz, bs=32; 3 warm-up and 5 timed steps), one deep
   width-2 step at bs=16 and one tag-conditioned BiCRNN step.
3. Parity: the shallow forward and loss on the GPU against the same on
   the CPU, and the scan GRU at H=256, T=501 against the numpy
   reference (``tests/numpy_reference.py``).
4. Ensemble: 10-member ``StackedEnsemble`` sliding-window SED at bs=32
   through ``models.base.inference``; one batch against the mean of
   the members run one by one.
5. Trace: a profiler trace of 3 shallow train steps, reduced by
   ``pb_sed_tpu.utils.xplane``.
6. Four cards: data-parallel training over a 4-device mesh against the
   same global batch on one card, and ``default_ensemble_mesh(10)``
   sharded SED against one card.

Findings go to earlier lines; the last line is one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``. Without a
GPU, without the package beside this script, or when a phase fails, the
script exits non-zero and prints no such line. Weights are random from
fixed seeds.
"""
import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
NUM_EVENTS = 10
SAMPLE_RATE = 16000
SED_WINDOW = {'window_length': 31, 'window_shift': 1}

# GPU against CPU, relative to max|ref| of the scores: mean abs error
# within PARITY_MEAN_REL, max within PARITY_MAX_REL. Convolutions and GRU
# projections run in bf16 (2^-8 relative rounding per op), rounding
# differently on the two devices; the largest readings of the H100 runs
# are max 2.9e-2 and mean 1.7e-3 (PERF.md). A structural error (gate
# order, a flipped mask) is order one. These bounds cannot see a
# precision fault inside the recurrence: the GRU check below does.
PARITY_MAX_REL = 4e-2
PARITY_MEAN_REL = 5e-3
# Scan GRU (B=32, T=501, H=256) against the numpy reference that rounds
# the matmul operands to bf16 as the model does, relative to max|ref|.
# CPU readings: max 1.6e-3, mean 7.1e-5; the same recurrence with its
# state held in bf16 (the control, run beside it every time): max
# 6.1e-3, mean 6.7e-4. Each bound sits between the two; the check
# fails when the control passes both.
GRU_MAX_REL = 5e-3
GRU_MEAN_REL = 2.5e-4
# A stacked ensemble against its members one by one runs the same
# arithmetic in a vmapped, chunked program whose kernels may round bf16
# conv outputs differently by one ulp (2^-8 relative).
ENSEMBLE_ATOL = 1e-2
# Data-parallel step against one device, from the same seeded weights
# and global batch. MULTI_GRAD_REL bounds the relative error of the
# gradient the step applied (Adam's first moment, all leaves as one
# vector); MULTI_STATS_REL that of the change of the batch-norm
# statistics, worst leaf. CPU readings at full width (4 virtual
# devices, bs=8 x 1 s and bs=16 x 3 s): sound 0.31 and 0.26 for the
# gradient, 1.6e-3 and 7.8e-4 for the statistics; bf16 rounding that
# differs with the per-device batch, amplified by batch norm's backward,
# sets that floor. A step on a quarter (one shard) or half of the batch
# gives 1.33-1.96 and 0.74-2.3 there, and 0.61-0.91 and 1.4e-2-1.9e-2
# at tiny size (tests/test_chip_smoke.py).
MULTI_GRAD_REL = 0.5
MULTI_STATS_REL = 5e-3
def log(*args):
    print(*args, flush=True)


def _import_repo():
    if not (ROOT / 'pb_sed_tpu' / '__init__.py').is_file():
        sys.exit('chip_smoke.py: the pb_sed_tpu package is not beside '
                 'this script')
    sys.path.insert(0, str(ROOT))
    import pb_sed_tpu
    if Path(pb_sed_tpu.__file__).resolve().parent != ROOT / 'pb_sed_tpu':
        sys.exit(f'chip_smoke.py: imported pb_sed_tpu from '
                 f'{pb_sed_tpu.__file__}, not from beside this script')


# ----------------------------------------------------------------------
# models and batches
# ----------------------------------------------------------------------
def _tiny_config(kind):
    """A few-channel model of ``kind`` for CPU tests of the phases."""
    cfg = {
        'feature_extractor': {
            'sample_rate': SAMPLE_RATE, 'stft_size': 512,
            'stft_shift': 160, 'stft_window_length': 480,
            'number_of_filters': 16},
        'cnn': {
            'cnn_2d': {'out_channels': [4, 4], 'kernel_size': 3,
                       'pool_size': [[2, 1], [2, 1]]},
            'cnn_1d': {'out_channels': [8, 8], 'kernel_size': 3}},
    }
    if kind == 'fbcrnn_deep':
        cfg['cnn']['cnn_2d'] = {
            'out_channels': [4, 4, 8, 8], 'kernel_size': [3, 1, 3, 1],
            'pool_size': [1, [2, 1], 1, [2, 1]],
            'residual_connections': [2, None, None, None]}
    head = {'rnn': {'hidden_size': 8, 'num_layers': 1},
            'output_net': {'out_channels': [8, NUM_EVENTS],
                           'kernel_size': 1}}
    if kind == 'bicrnn_tag':
        cfg.update(rnn=head, tag_conditioning=True)
    else:
        cfg['rnn_fwd'] = head
    return cfg


def build_model(kind, size='full'):
    """``kind``: fbcrnn_shallow | fbcrnn_deep | bicrnn_tag; ``size``:
    'full' (the published widths, models/net_configs.py) or 'tiny'."""
    from pb_sed_tpu.models import strong_label, weak_label
    from pb_sed_tpu.models.net_configs import bicrnn_config, fbcrnn_config
    cls = strong_label.CRNN if kind == 'bicrnn_tag' else weak_label.CRNN
    if size == 'tiny':
        cfg = _tiny_config(kind)
    elif kind == 'bicrnn_tag':
        cfg = bicrnn_config('shallow', NUM_EVENTS, tag_conditioning=True)
    else:
        cfg = fbcrnn_config(kind.split('_')[1], NUM_EVENTS)
    return cls.from_config(cls.get_config(cfg))


def make_batch(model, batch_size, seconds, seed=0, tags=False):
    """Random waveforms and targets for ``model``'s front end."""
    stft = model.module.feature_extractor.stft
    rng = np.random.RandomState(seed)
    n = int(seconds * SAMPLE_RATE)
    frames = int(stft.num_frames(n))
    batch = {
        'audio_data': rng.randn(batch_size, n).astype(np.float32),
        'seq_len': np.full(batch_size, frames, np.int32),
        'seq_len_samples': np.full(batch_size, n, np.int32),
        'weak_targets': (rng.rand(batch_size, NUM_EVENTS) > .7).astype(
            np.float32),
        'boundary_targets': (rng.rand(batch_size, NUM_EVENTS, frames)
                             > .9).astype(np.float32),
        'example_id': [f'clip{seed}_{i}' for i in range(batch_size)],
    }
    if tags:
        batch['strong_targets'] = batch['boundary_targets']
        batch['tag_condition'] = batch['weak_targets']
    return batch


def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get('peak_bytes_in_use')


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def train_steps(kind, size, batch_size, seconds, warmup, steps):
    """Compile, warm up and time ``Trainer.train_step`` on one device.
    Returns (findings, trainer, batch)."""
    import jax
    from pb_sed_tpu.train.trainer import Trainer
    model = build_model(kind, size)
    batch = make_batch(model, batch_size, seconds,
                       tags=kind == 'bicrnn_tag')
    trainer = Trainer(model, storage_dir=None, use_mesh=False,
                      stop_trigger=(10 ** 9, 'iteration'))
    t0 = time.perf_counter()
    losses = [trainer.train_step(batch)]
    jax.block_until_ready(trainer.model.variables)
    compile_s = time.perf_counter() - t0
    for _ in range(warmup - 1):
        losses.append(trainer.train_step(batch))
    jax.block_until_ready(trainer.model.variables)
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(trainer.train_step(batch))
        jax.block_until_ready(trainer.model.variables)
        times.append(time.perf_counter() - t0)
    losses = [float(v) for v in losses]
    assert np.isfinite(losses).all(), (kind, losses)
    found = {
        'kind': kind, 'batch_size': batch_size, 'seconds': seconds,
        'params': model.num_parameters(),
        'compile_and_first_step_s': compile_s,
        'step_ms': [1e3 * t for t in times],
        'median_step_ms': 1e3 * float(np.median(times)) if times else None,
        'losses': losses, 'peak_bytes_in_use': _peak_bytes(),
    }
    return found, trainer, batch


def phase_train(size='full'):
    shallow, trainer, batch = train_steps(
        'fbcrnn_shallow', size, 32 if size == 'full' else 4,
        10. if size == 'full' else 1., warmup=3, steps=5)
    log('train shallow FBCRNN:', json.dumps(shallow))
    deep, _, _ = train_steps('fbcrnn_deep', size,
                             16 if size == 'full' else 2,
                             10. if size == 'full' else 1., warmup=1,
                             steps=1)
    log('train deep width-2 FBCRNN:', json.dumps(deep))
    bi, _, _ = train_steps('bicrnn_tag', size,
                           32 if size == 'full' else 2,
                           10. if size == 'full' else 1., warmup=1,
                           steps=1)
    log('train tag-conditioned BiCRNN:', json.dumps(bi))
    return {'shallow': shallow, 'deep': deep, 'bicrnn': bi}, trainer, batch


def _check(name, got, ref, max_rel=PARITY_MAX_REL,
           mean_rel=PARITY_MEAN_REL, atol=None, control=False):
    """Compare ``got`` with ``ref``; tolerances are relative to max|ref|
    unless an absolute ``atol`` bounds the max error instead. A
    ``control`` is a planted fault that must exceed a tolerance."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    found = {'max_abs_err': float(err.max()),
             'mean_abs_err': float(err.mean()),
             'max_rel_err': float(err.max()) / scale,
             'mean_rel_err': float(err.mean()) / scale,
             'tolerance': atol if atol is not None else max_rel * scale,
             'mean_tolerance': mean_rel * scale}
    found['within'] = (found['max_abs_err'] <= found['tolerance'] and
                       found['mean_abs_err'] <= found['mean_tolerance'])
    log(f'{"control" if control else "parity"} {name}: max abs err '
        f'{found["max_abs_err"]:.3e} (tolerance {found["tolerance"]:.3e}), '
        f'mean abs err {found["mean_abs_err"]:.3e} (tolerance '
        f'{found["mean_tolerance"]:.3e}), max rel err '
        f'{found["max_rel_err"]:.3e}, mean rel err '
        f'{found["mean_rel_err"]:.3e}'
        + (', must exceed a tolerance' if control else ''))
    assert found['within'] != control, (name, found)
    return found


def gru_bf16_state(params, x):
    """The control of the GRU check: ``GRULayer``'s recurrence with its
    state rounded to bf16 after every step."""
    import jax
    import jax.numpy as jnp
    bf16 = jnp.bfloat16
    xw = jnp.dot(x.astype(bf16), params['w_ih'].astype(bf16),
                 preferred_element_type=jnp.float32) + params['b_ih']
    w_hh = params['w_hh'].astype(bf16)

    def step(h, xw_t):
        hw = jnp.dot(h, w_hh, preferred_element_type=jnp.float32) \
            + params['b_hh']
        xr, xz, xn = jnp.split(xw_t, 3, axis=-1)
        hr, hz, hn = jnp.split(hw, 3, axis=-1)
        r = jax.nn.sigmoid(xr + hr)
        z = jax.nn.sigmoid(xz + hz)
        h = ((1. - z) * jnp.tanh(xn + r * hn) + z * h).astype(bf16)
        return h, h

    h0 = jnp.zeros((x.shape[0], w_hh.shape[0]), bf16)
    _, ys = jax.lax.scan(step, h0, jnp.swapaxes(xw, 0, 1))
    return jnp.swapaxes(ys, 0, 1).astype(jnp.float32)


def phase_parity(model, batch, n_clips=4, gru_batch=32, gru_steps=501):
    """The model's forward and loss on the default device against the
    CPU, and the scan GRU against the numpy reference, beside a control
    that the GRU check must reject."""
    import jax
    import jax.numpy as jnp
    from pb_sed_tpu.ops.rnn import GRULayer
    from tests import numpy_reference as npref
    clips = {k: np.asarray(v)[:n_clips] for k, v in batch.items()
             if isinstance(v, np.ndarray)}

    def forward(variables, b):
        y_fwd, y_bwd, *_ = model.module.apply(variables, b, training=False)
        loss, _ = model.loss_fn(variables, b, {}, training=False)
        return y_fwd, y_bwd, loss

    fn = jax.jit(forward)
    got = fn(model.variables, clips)
    cpu = jax.devices('cpu')[0]
    ref = fn(jax.device_put(model.variables, cpu),
             jax.device_put(clips, cpu))
    found = {name: _check(f'{name} vs cpu', g, r)
             for name, g, r in zip(('y_fwd', 'y_bwd', 'loss'), got, ref)}

    rng = np.random.RandomState(7)
    hdim, feat = 256, 256
    x = rng.randn(gru_batch, gru_steps, feat).astype(np.float32)
    params = {
        'w_ih': (rng.randn(feat, 3 * hdim) / np.sqrt(feat)),
        'w_hh': (rng.randn(hdim, 3 * hdim) / np.sqrt(hdim)),
        'b_ih': .1 * rng.randn(3 * hdim), 'b_hh': .1 * rng.randn(3 * hdim),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    gru = jax.jit(lambda p, x: GRULayer(hdim).apply({'params': p}, x))
    ref = npref.gru_layer(x, **params, operand_dtype=jnp.bfloat16)
    name = f'scan GRU H={hdim} T={gru_steps} vs numpy'
    found['gru_h256'] = _check(name, gru(params, jnp.asarray(x)), ref,
                               GRU_MAX_REL, GRU_MEAN_REL)
    found['gru_control'] = _check(
        f'{name}, state in bf16', jax.jit(gru_bf16_state)(params, x), ref,
        GRU_MAX_REL, GRU_MEAN_REL, control=True)
    return found


def make_members(n, size, batch):
    """``n`` shallow FBCRNNs with weights from seeds 0..n-1."""
    import jax
    models = [build_model('fbcrnn_shallow', size) for _ in range(n)]
    module = models[0].module
    device_batch = {k: v for k, v in batch.items()
                    if isinstance(v, np.ndarray)}
    init = jax.jit(lambda rngs, b: module.init(rngs, b, training=False))
    for seed, m in enumerate(models):
        keys = jax.random.split(jax.random.PRNGKey(seed), 3)
        m.variables = init(dict(zip(('params', 'augment', 'dropout'),
                                    keys)), device_batch)
    return models


def phase_ensemble(size='full', n_members=10, batch_size=32, seconds=10.,
                   n_batches=3):
    from pb_sed_tpu.models.base import sound_event_detection
    from pb_sed_tpu.models.base.ensemble import StackedEnsemble
    probe = build_model('fbcrnn_shallow', size)
    batches = [make_batch(probe, batch_size, seconds, seed=i)
               for i in range(n_batches)]
    members = make_members(n_members, size, batches[0])
    runner = StackedEnsemble(members, chunk_size=min(8, batch_size))
    t0 = time.perf_counter()
    scores = sound_event_detection(
        [runner], batches[:1], model_kwargs=SED_WINDOW)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores.update(sound_event_detection(
        [runner], batches[1:], model_kwargs=SED_WINDOW))
    run_s = time.perf_counter() - t0
    assert len(scores) == n_batches * batch_size, len(scores)
    assert all(np.isfinite(s).all() for s in scores.values())
    one_by_one = []
    for m in members:  # one model object: one compiled program
        probe.variables = m.variables
        one_by_one.append(
            probe.sound_event_detection(batches[0], **SED_WINDOW)[0])
    one_by_one = np.mean(one_by_one, axis=0)  # (B, K, T)
    got = np.stack([scores[eid] for eid in batches[0]['example_id']])
    err = _check('ensemble batch vs members one by one', got,
                 one_by_one.swapaxes(1, 2)[:, :got.shape[1]],
                 atol=ENSEMBLE_ATOL)
    found = {'members': n_members, 'batch_size': batch_size,
             'compile_and_first_batch_s': compile_s,
             'ms_per_batch': 1e3 * run_s / max(n_batches - 1, 1),
             'clips_scored': len(scores), **err,
             'peak_bytes_in_use': _peak_bytes()}
    log('ensemble SED:', json.dumps(found))
    return found


def phase_trace(trainer, batch, steps=3):
    import jax
    from pb_sed_tpu.utils import xplane
    with tempfile.TemporaryDirectory() as tmp:
        jax.profiler.start_trace(tmp)
        for i in range(steps):
            with jax.profiler.StepTraceAnnotation('train', step_num=i):
                trainer.train_step(batch)
                jax.block_until_ready(trainer.model.variables)
        jax.profiler.stop_trace()
        for plane, lines in xplane.describe(tmp):
            log('trace plane', plane, lines)
        times = xplane.device_step_times_ms(tmp)
        busy = xplane.device_busy(tmp)
        scopes = xplane.kernel_breakdown_ms(tmp, key='scope')
        kernels = xplane.kernel_breakdown_ms(tmp, top=10)
    total = sum(ms for ms, _ in scopes.values())

    def share(part):
        return sum(ms for s, (ms, _) in scopes.items() if part in s) / total

    found = {
        'device_ms_per_step': times,
        'busy': busy,
        # the scan loops of the train step are the GRU recurrences
        'shares': {name: share(part) for name, part in (
            ('recurrence', '/while'), ('front_end', '/feature_extractor/'),
            ('conv2d_tower', '/cnn_2d/'), ('conv1d_tower', '/cnn_1d/'),
            ('gru_heads', '/rnn_'))},
        'top_kernels_ms': {k: v[0] for k, v in kernels.items()},
    }
    log('trace:', json.dumps(found))
    assert times and all(t > 0 for t in times), times
    return found


def train_once(mesh, size, batch_size, seconds, clips=None):
    """One ``Trainer.train_step`` of the shallow FBCRNN from its seeded
    initial weights on ``mesh`` (None: one device), on the first
    ``clips`` clips of the batch (default all). Returns the loss, the
    gradient the step applied (Adam's first moment), the change of the
    parameters and the new batch-norm statistics, all on the host."""
    import jax
    from pb_sed_tpu.train.trainer import Trainer
    model = build_model('fbcrnn_shallow', size)
    batch = make_batch(model, batch_size, seconds)
    batch = {k: v[:clips] for k, v in batch.items()}
    trainer = Trainer(model, storage_dir=None, use_mesh=False,
                      stop_trigger=(10 ** 9, 'iteration'))
    trainer.mesh = mesh
    trainer._ensure_ready(batch)
    before = jax.device_get(trainer.model.variables)
    t0 = time.perf_counter()
    loss = float(trainer.train_step(batch))
    after = jax.device_get(trainer.model.variables)
    grad = next(s.mu for s in trainer.opt_state if hasattr(s, 'mu'))
    return {'loss': loss, 'seconds': time.perf_counter() - t0,
            'grad': jax.device_get(grad),
            'delta': jax.tree.map(np.subtract, after['params'],
                                  before['params']),
            'stats_delta': jax.tree.map(np.subtract, after['batch_stats'],
                                        before['batch_stats'])}


def worst_leaf(got, ref):
    """(relative error, path) of the worst leaf: each leaf's error norm
    over max(its reference norm, the reference's RMS element times the
    root of its size), so that leaves whose true value is zero (a conv
    bias ahead of batch norm) are read at the tree's scale."""
    import jax
    paths = jax.tree_util.tree_flatten_with_path(ref)[0]
    refs = [np.asarray(v, np.float64) for _, v in paths]
    gots = [np.asarray(v, np.float64) for v in jax.tree.leaves(got)]
    rms = np.sqrt(sum(np.sum(r * r) for r in refs)
                  / sum(r.size for r in refs))
    errs = [np.linalg.norm(g - r) / max(np.linalg.norm(r),
                                        rms * np.sqrt(r.size), 1e-30)
            for g, r in zip(gots, refs)]
    i = int(np.argmax(errs))
    return float(errs[i]), jax.tree_util.keystr(paths[i][0])


def compare_steps(got, ref):
    """Readings of one train step against a reference step."""
    import jax
    found = {'loss_abs_err': abs(got['loss'] - ref['loss'])}
    for key in ('grad', 'stats_delta', 'delta'):
        g, r = (np.concatenate([np.ravel(v) for v in jax.tree.leaves(t)])
                for t in (got[key], ref[key]))
        found[key] = float(np.linalg.norm(g - r) / np.linalg.norm(r))
        found[key + '_worst_leaf'] = worst_leaf(got[key], ref[key])
    found['within'] = (found['grad'] <= MULTI_GRAD_REL and
                       found['stats_delta_worst_leaf'][0] <= MULTI_STATS_REL)
    return found


def phase_multi(n_devices=4, size='full', batch_size=32, seconds=10.,
                n_members=10):
    """Data-parallel training and sharded ensemble SED on ``n_devices``
    against the same work on one device."""
    import jax
    from pb_sed_tpu.models.base import sound_event_detection
    from pb_sed_tpu.models.base.ensemble import StackedEnsemble
    from pb_sed_tpu.parallel.mesh import default_ensemble_mesh, get_mesh
    devices = jax.devices()[:n_devices]
    assert len(devices) == n_devices, (len(devices), n_devices)

    steps = {name: train_once(mesh, size, batch_size, seconds)
             for name, mesh in (('mesh', get_mesh(devices=devices)),
                                ('one', None))}
    for name, step in steps.items():
        log(f'multi train ({name}): loss {step["loss"]}, '
            f'{step["seconds"]:.1f} s with compile')
    found = {'train': compare_steps(steps['mesh'], steps['one'])}
    log(f'{n_devices}-device data-parallel step vs one device: '
        f'{json.dumps(found["train"])}; bounds: grad {MULTI_GRAD_REL}, '
        f'stats_delta_worst_leaf {MULTI_STATS_REL}; delta (Adam\'s '
        f'sign-like first update) is reported only')
    assert np.isfinite(steps['mesh']['loss']), steps['mesh']['loss']
    assert found['train']['within'], found['train']

    probe = build_model('fbcrnn_shallow', size)
    batch = make_batch(probe, batch_size, seconds, seed=1)
    members = make_members(n_members, size, batch)
    mesh = default_ensemble_mesh(len(members), devices=devices)
    sharded = sound_event_detection(
        [StackedEnsemble(members, mesh=mesh)], [batch],
        model_kwargs=SED_WINDOW, mesh=mesh)
    single = sound_event_detection(
        [StackedEnsemble(members, chunk_size=min(8, batch_size))], [batch],
        model_kwargs=SED_WINDOW, mesh=None)
    ids = batch['example_id']
    found['mesh_shape'] = dict(mesh.shape)
    found['sed'] = _check(
        f'sharded ensemble SED over {dict(mesh.shape)} vs one device',
        np.stack([sharded[i] for i in ids]),
        np.stack([single[i] for i in ids]), atol=ENSEMBLE_ATOL)
    return found


# ----------------------------------------------------------------------
def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--multi', action='store_true',
                        help='run only the four-card phase')
    args = parser.parse_args(argv)
    _import_repo()
    from pb_sed_tpu.utils.device import (
        configure_compile_cache, gpu_name_power_limit, require_gpu)
    configure_compile_cache()
    try:
        devices = require_gpu()
    except RuntimeError as exc:
        sys.exit(f'chip_smoke.py: {exc}')
    import jax
    dev = devices[0]
    log(f'device: {dev.platform} {dev.device_kind} x{len(devices)}, '
        f'jax {jax.__version__}')
    smi = gpu_name_power_limit()
    log(f'nvidia-smi name, power.limit: {smi}')
    t_start = time.perf_counter()
    if args.multi:
        phase_multi()
    else:
        _, trainer, batch = phase_train()
        phase_parity(trainer.model, batch)
        phase_ensemble()
        phase_trace(trainer, batch)
    log(f'total {time.perf_counter() - t_start:.1f} s')
    log(f'gpu: {smi}')
    print(json.dumps({'ok': True, 'device': {
        'platform': dev.platform, 'kind': dev.device_kind,
        'count': len(devices)}}), flush=True)


if __name__ == '__main__':
    main()
