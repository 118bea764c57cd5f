"""Full-model golden parity: the CRNN modules vs the straight-numpy reference.

The numpy implementation (``tests/numpy_reference.py``) independently
re-implements the reference semantics (masked BN statistics, torch GRU
gate order, bounded sigmoid, cummax fwd/bwd losses — reference
``models/weak_label/crnn.py:69-206``, ``strong_label/crnn.py:60-112``);
weights are generated from a seeded numpy RandomState (never from jax
PRNG, so the fixture survives jax upgrades) and shoved into both
implementations. The numpy outputs are additionally pinned against a
checked-in fixture (``tests/fixtures/golden_model.npz``) so a
coordinated semantic drift of model AND reference cannot pass silently.

Tolerances: the module path computes convolutions and GRU projections in
bfloat16 (production semantics) — structural errors (wrong gate order,
flipped cummax, misapplied mask) produce order-one disagreement, far
above the few-percent bf16 noise allowed here.
"""
import os

import jax
import numpy as np
import pytest

from pb_sed_tpu.models import strong_label, weak_label
from tests import numpy_reference as npref

FIXTURE = os.path.join(os.path.dirname(__file__), 'fixtures',
                       'golden_model.npz')


def _seeded_variables(variables, seed):
    """Replace every leaf with seeded numpy values (scaled for sane
    activations): the fixture must not depend on jax's PRNG."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        leaf = np.asarray(leaf)
        name = '/'.join(str(getattr(p, 'key', p)) for p in path)
        if name.endswith('initialized'):
            return np.zeros_like(leaf)
        if name.endswith(('var',)):
            return np.ones_like(leaf)
        if name.endswith(('scale',)):
            return (1. + .1 * rng.randn(*leaf.shape)).astype(np.float32)
        if name.endswith(('shift', 'bias', 'b_ih', 'b_hh', 'mean')):
            return (.1 * rng.randn(*leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) or 1
        return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(fill, variables)


def _weak_setup():
    config = weak_label.CRNN.get_config({
        'feature_extractor': {
            'sample_rate': 16000, 'stft_size': 512,
            'number_of_filters': 32,
        },
        'cnn': {
            'cnn_2d': {'out_channels': [8, 8, 8], 'kernel_size': 3,
                       'pool_size': [[2, 1], [2, 1], 1],
                       'norm': 'batch', 'norm_kwargs': {'eps': 1e-3},
                       'pre_activation': True},
            'cnn_1d': {'out_channels': [16, 16], 'kernel_size': 3,
                       'norm': 'batch', 'pre_activation': True},
        },
        'rnn_fwd': {
            'rnn': {'hidden_size': 16, 'num_layers': 2},
            'output_net': {'out_channels': [16, 6], 'kernel_size': 1},
        },
    })
    model = weak_label.CRNN.from_config(config)
    rng = np.random.RandomState(21)
    b, t, k = 3, 14, 6
    batch = {
        'stft': (.5 * rng.randn(b, t, 257, 2)).astype(np.float32),
        'seq_len': np.array([14, 11, 9], dtype=np.int32),
        'weak_targets': np.zeros((b, k), np.float32),
        'boundary_targets': np.zeros((b, k, t), np.float32),
    }
    batch['weak_targets'][0, 2] = 1.
    batch['weak_targets'][1, :] = .5   # unlabeled example (soft)
    batch['weak_targets'][2, 4] = 1.
    batch['boundary_targets'][0, 2, 3:9] = 1.
    batch['boundary_targets'][2, 4, :] = .5  # partially labeled frames
    model.init_variables(batch, seed=0)
    model.variables = _seeded_variables(model.variables, seed=22)
    cfg = {
        'feature_extractor': dict(number_of_filters=32,
                                  sample_rate=16000, stft_size=512),
        'cnn_2d': dict(out_channels=[8, 8, 8], kernel_size=3,
                       pool_size=[[2, 1], [2, 1], 1],
                       pre_activation=True),
        'cnn_1d': dict(out_channels=[16, 16], kernel_size=3,
                       pre_activation=True),
        'rnn': dict(num_layers=2, output_net_cfg=dict(
            out_channels=[16, 6], kernel_size=1, output_layer=True,
            pre_activation=False)),
    }
    return model, batch, cfg


def _deep_setup():
    """Deep-STRUCTURE FBCRNN at golden scale (VERDICT r4 #4): the
    width-2 recipe's distinguishing semantics — 3/1-alternating kernel
    sizes and identity residual skips crossing freq pools AND channel
    growth in the conv2d tower, plus conv1d residuals — mirrored from
    ``net_configs.py`` 'deep' (reference ``training.py:171-185``)."""
    config = weak_label.CRNN.get_config({
        'feature_extractor': {
            'sample_rate': 16000, 'stft_size': 512,
            'number_of_filters': 32,
        },
        'cnn': {
            'cnn_2d': {
                'out_channels': [4, 4, 4, 8, 8, 8],
                'kernel_size': [3, 1, 3, 1, 3, 1],
                'pool_size': [1, [2, 1], 1, 1, [2, 1], 1],
                # layer0 -> layer3 crosses a freq pool (avg-pool match);
                # layer2 -> layer4 crosses channel growth (zero-pad)
                'residual_connections': [3, None, 4, None, None, None],
                'norm': 'batch', 'norm_kwargs': {'eps': 1e-3},
                'pre_activation': True,
            },
            'cnn_1d': {
                'out_channels': [16, 16, 16],
                'kernel_size': [1, 3, 1],
                'residual_connections': [None, 2, None],
                'norm': 'batch', 'pre_activation': True,
            },
        },
        'rnn_fwd': {
            'rnn': {'hidden_size': 16, 'num_layers': 2},
            'output_net': {'out_channels': [16, 6], 'kernel_size': 1},
        },
    })
    model = weak_label.CRNN.from_config(config)
    rng = np.random.RandomState(41)
    b, t, k = 3, 14, 6
    batch = {
        'stft': (.5 * rng.randn(b, t, 257, 2)).astype(np.float32),
        'seq_len': np.array([14, 12, 8], dtype=np.int32),
        'weak_targets': np.zeros((b, k), np.float32),
        'boundary_targets': np.zeros((b, k, t), np.float32),
    }
    batch['weak_targets'][0, 1] = 1.
    batch['weak_targets'][1, :] = .5
    batch['weak_targets'][2, 3] = 1.
    batch['boundary_targets'][0, 1, 2:8] = 1.
    batch['boundary_targets'][2, 3, :] = .5
    model.init_variables(batch, seed=0)
    model.variables = _seeded_variables(model.variables, seed=42)
    cfg = {
        'feature_extractor': dict(number_of_filters=32,
                                  sample_rate=16000, stft_size=512),
        'cnn_2d': dict(out_channels=[4, 4, 4, 8, 8, 8],
                       kernel_size=[3, 1, 3, 1, 3, 1],
                       pool_size=[1, [2, 1], 1, 1, [2, 1], 1],
                       residual_connections=[3, None, 4, None, None,
                                             None],
                       pre_activation=True),
        'cnn_1d': dict(out_channels=[16, 16, 16],
                       kernel_size=[1, 3, 1],
                       residual_connections=[None, 2, None],
                       pre_activation=True),
        'rnn': dict(num_layers=2, output_net_cfg=dict(
            out_channels=[16, 6], kernel_size=1, output_layer=True,
            pre_activation=False)),
    }
    return model, batch, cfg


def _strong_setup():
    config = strong_label.CRNN.get_config({
        'tag_conditioning': True,
        'feature_extractor': {
            'sample_rate': 16000, 'stft_size': 512,
            'number_of_filters': 32,
        },
        'cnn': {
            'cnn_2d': {'out_channels': [8, 8],
                       'pool_size': [[2, 1], 1], 'kernel_size': 3},
            'cnn_1d': {'out_channels': [16, 16], 'kernel_size': 3},
        },
        'rnn': {
            'rnn': {'hidden_size': 16},
            'output_net': {'out_channels': [16, 6], 'kernel_size': 1},
        },
    })
    model = strong_label.CRNN.from_config(config)
    rng = np.random.RandomState(31)
    b, t, k = 2, 12, 6
    batch = {
        'stft': (.5 * rng.randn(b, t, 257, 2)).astype(np.float32),
        'seq_len': np.array([12, 8], dtype=np.int32),
        'weak_targets': np.zeros((b, k), np.float32),
        'strong_targets': np.zeros((b, k, t), np.float32),
        'tag_condition': np.zeros((b, k), np.float32),
    }
    batch['strong_targets'][0, 1, 2:7] = 1.
    batch['strong_targets'][1, 3, :] = .5
    batch['tag_condition'][0, 1] = 1.
    batch['tag_condition'][1, 3] = 1.
    model.init_variables(batch, seed=0)
    model.variables = _seeded_variables(model.variables, seed=32)
    cfg = {
        'feature_extractor': dict(number_of_filters=32,
                                  sample_rate=16000, stft_size=512),
        'cnn_2d': dict(out_channels=[8, 8], kernel_size=3,
                       pool_size=[[2, 1], 1], pre_activation=False),
        'cnn_1d': dict(out_channels=[16, 16], kernel_size=3,
                       pre_activation=False),
        'rnn': dict(num_layers=1, output_net_cfg=dict(
            out_channels=[16, 6], kernel_size=1, output_layer=True,
            pre_activation=False)),
        'tag_conditioning': True,
    }
    return model, batch, cfg


def _np_vars(variables):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), variables)


def _close(got, ref, rel=4e-2, tag=''):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    atol = 1e-4 + rel * float(np.max(np.abs(ref)))
    np.testing.assert_allclose(got, ref, atol=atol, err_msg=tag)


def _golden_outputs():
    """All numpy-reference outputs pinned by the fixture."""
    out = {}
    model, batch, cfg = _weak_setup()
    variables = _np_vars(model.variables)
    y_fwd, y_bwd, sl = npref.fbcrnn_forward(variables, batch, cfg)
    out['weak_y_fwd'], out['weak_y_bwd'] = y_fwd, y_bwd
    out['weak_seq_len'] = sl
    out['weak_tags'] = npref.fbcrnn_tagging(y_fwd, y_bwd, sl)
    out['weak_boundaries'] = npref.fbcrnn_boundaries(y_fwd, y_bwd, sl)
    out['weak_loss'] = np.float32(npref.fbcrnn_loss(
        y_fwd, y_bwd, sl, batch['weak_targets'],
        batch['boundary_targets']))

    model_d, batch_d, cfg_d = _deep_setup()
    variables_d = _np_vars(model_d.variables)
    y_fwd_d, y_bwd_d, sl_d = npref.fbcrnn_forward(
        variables_d, batch_d, cfg_d)
    out['deep_y_fwd'], out['deep_y_bwd'] = y_fwd_d, y_bwd_d
    out['deep_seq_len'] = sl_d
    out['deep_loss'] = np.float32(npref.fbcrnn_loss(
        y_fwd_d, y_bwd_d, sl_d, batch_d['weak_targets'],
        batch_d['boundary_targets']))

    model_s, batch_s, cfg_s = _strong_setup()
    variables_s = _np_vars(model_s.variables)
    y, sl_s = npref.bicrnn_forward(variables_s, batch_s, cfg_s)
    out['strong_y'] = y
    out['strong_seq_len'] = sl_s
    out['strong_loss'] = np.float32(npref.bicrnn_loss(
        y, sl_s, batch_s['strong_targets']))
    return out


def test_fbcrnn_matches_numpy_reference():
    model, batch, cfg = _weak_setup()
    variables = _np_vars(model.variables)
    y_fwd_r, y_bwd_r, sl_r = npref.fbcrnn_forward(variables, batch, cfg)

    rngs = {'augment': jax.random.PRNGKey(0),
            'dropout': jax.random.PRNGKey(1)}
    outputs, _ = model.module.apply(
        model.variables, batch, training=True, rngs=rngs,
        mutable=['batch_stats'])
    y_fwd, y_bwd, sl, *_ = outputs
    np.testing.assert_array_equal(np.asarray(sl), sl_r)
    mask = npref.sequence_mask(sl_r, y_fwd_r.shape[-1])[:, None, :]
    _close(np.asarray(y_fwd) * mask, y_fwd_r * mask, tag='y_fwd')
    _close(np.asarray(y_bwd) * mask, y_bwd_r * mask, tag='y_bwd')

    # tagging/boundaries in training mode (masked batch statistics) —
    # the numpy reference pins training-mode BN; eval mode only swaps
    # the statistics source, the head arithmetic under test is shared
    module_cls = type(model.module)
    (tags, _), _ = model.module.apply(
        model.variables, batch, training=True, rngs=rngs,
        mutable=['batch_stats'], method=module_cls.tagging)
    _close(tags, npref.fbcrnn_tagging(y_fwd_r, y_bwd_r, sl_r),
           tag='tagging')
    (bnd, _), _ = model.module.apply(
        model.variables, batch, training=True, rngs=rngs,
        mutable=['batch_stats'], method=module_cls.boundaries_detection)
    _close(np.asarray(bnd) * mask,
           npref.fbcrnn_boundaries(y_fwd_r, y_bwd_r, sl_r), tag='bnd')

    loss, _ = model.loss_fn(model.variables, batch, rngs, training=True)
    loss_r = npref.fbcrnn_loss(
        y_fwd_r, y_bwd_r, sl_r, batch['weak_targets'],
        batch['boundary_targets'])
    assert abs(float(loss) - loss_r) < 4e-2 * abs(loss_r) + 1e-3, (
        float(loss), loss_r)


def test_fbcrnn_deep_matches_numpy_reference():
    """Deep-structure variant: residual tower (pool- and channel-
    crossing identity skips, 3/1 kernels) + conv1d residuals against
    the independent numpy semantics."""
    model, batch, cfg = _deep_setup()
    variables = _np_vars(model.variables)
    y_fwd_r, y_bwd_r, sl_r = npref.fbcrnn_forward(variables, batch, cfg)

    rngs = {'augment': jax.random.PRNGKey(0),
            'dropout': jax.random.PRNGKey(1)}
    outputs, _ = model.module.apply(
        model.variables, batch, training=True, rngs=rngs,
        mutable=['batch_stats'])
    y_fwd, y_bwd, sl, *_ = outputs
    np.testing.assert_array_equal(np.asarray(sl), sl_r)
    mask = npref.sequence_mask(sl_r, y_fwd_r.shape[-1])[:, None, :]
    _close(np.asarray(y_fwd) * mask, y_fwd_r * mask, tag='deep_y_fwd')
    _close(np.asarray(y_bwd) * mask, y_bwd_r * mask, tag='deep_y_bwd')

    loss, _ = model.loss_fn(model.variables, batch, rngs, training=True)
    loss_r = npref.fbcrnn_loss(
        y_fwd_r, y_bwd_r, sl_r, batch['weak_targets'],
        batch['boundary_targets'])
    assert abs(float(loss) - loss_r) < 4e-2 * abs(loss_r) + 1e-3, (
        float(loss), loss_r)


def test_bicrnn_matches_numpy_reference():
    model, batch, cfg = _strong_setup()
    variables = _np_vars(model.variables)
    y_r, sl_r = npref.bicrnn_forward(variables, batch, cfg)

    rngs = {'augment': jax.random.PRNGKey(0),
            'dropout': jax.random.PRNGKey(1)}
    outputs, _ = model.module.apply(
        model.variables, batch, training=True, rngs=rngs,
        mutable=['batch_stats'])
    y, sl, *_ = outputs
    np.testing.assert_array_equal(np.asarray(sl), sl_r)
    mask = npref.sequence_mask(sl_r, y_r.shape[-1])[:, None, :]
    _close(np.asarray(y) * mask, y_r * mask, tag='strong_y')

    loss, _ = model.loss_fn(model.variables, batch, rngs, training=True)
    loss_r = npref.bicrnn_loss(y_r, sl_r, batch['strong_targets'])
    assert abs(float(loss) - loss_r) < 4e-2 * abs(loss_r) + 1e-3, (
        float(loss), loss_r)


def test_numpy_reference_matches_fixture():
    """The numpy reference itself is pinned: a coordinated semantic
    drift of the model AND the numpy reference cannot pass. BLAS
    summation-order differences across machines allow 1e-5."""
    got = _golden_outputs()
    if not os.path.exists(FIXTURE):  # pragma: no cover
        pytest.fail(f'fixture missing: {FIXTURE} (generate with '
                    f'python -m tests.test_golden_model)')
    ref = np.load(FIXTURE)
    assert set(ref.files) == set(got)
    for k in ref.files:
        np.testing.assert_allclose(
            np.asarray(got[k], np.float64),
            np.asarray(ref[k], np.float64), atol=1e-5, err_msg=k)


if __name__ == '__main__':  # fixture (re)generation
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    np.savez(FIXTURE, **_golden_outputs())
    print(f'wrote {FIXTURE}')
