"""Trainer tests: jitted step, overfit, triggers, checkpoints, resume,
validation hook, freezing (runs on the virtual 8-device CPU mesh)."""
import numpy as np
import pytest

from pb_sed_tpu.data.provider import DataProvider
from pb_sed_tpu.models import weak_label
from pb_sed_tpu.train.hooks import (
    AllTrigger, EndTrigger, IntervalTrigger, LRAnnealingHook, NotTrigger)
from pb_sed_tpu.train.trainer import Trainer

from tests.util_synth import build_database


def make_provider(tmp_path, batch_size=4):
    db, json_path = build_database(tmp_path)
    config = DataProvider.get_config({
        'json_path': str(json_path),
        'train_set': {'train_strong': 1, 'train_weak': 1},
        'validate_set': 'validation',
        'min_audio_length': 0.2,
        'storage_dir': str(tmp_path),
        'train_transform': {
            'stft': {'shift': 160, 'window_length': 480, 'size': 512},
            'provide_boundary_targets': True,
            # no time warp for trainer determinism
            'anchor_sampling_fn': None,
            'anchor_shift_sampling_fn': None,
        },
        'train_fetcher': {
            'batch_size': batch_size, 'pad_to_multiple': 16,
            'prefetch_workers': 0, 'drop_incomplete': True,
        },
        'test_fetcher': {
            'batch_size': batch_size, 'pad_to_multiple': 16,
            'prefetch_workers': 0,
        },
        'mix_interval': None,
    })
    provider = DataProvider.from_config(config)
    provider.train_transform.label_encoder.initialize_labels(
        dataset=provider.db.get_dataset(['train_strong', 'train_weak']))
    provider.test_transform.label_encoder.initialize_labels()
    return provider


def make_model(num_events=3):
    config = weak_label.CRNN.get_config({
        'feature_extractor': {
            'sample_rate': 16000, 'stft_size': 512,
            'stft_shift': 160, 'stft_window_length': 480,
            'number_of_filters': 16,
        },
        'cnn': {
            'cnn_2d': {'out_channels': [4, 4],
                       'pool_size': [[2, 1], [2, 1]], 'kernel_size': 3},
            'cnn_1d': {'out_channels': [8, 8], 'kernel_size': 3},
        },
        'rnn_fwd': {
            'rnn': {'hidden_size': 8, 'num_layers': 1},
            'output_net': {'out_channels': [8, num_events],
                           'kernel_size': 1},
        },
    })
    return weak_label.CRNN.from_config(config)


def test_triggers():
    t = IntervalTrigger((3, 'iteration'))
    fired = [i for i in range(10) if t(i)]
    assert fired == [0, 3, 6, 9]
    e = EndTrigger(5)
    assert not e(4) and e(5) and e(6)
    a = AllTrigger((2, 'iteration'), NotTrigger(EndTrigger(6)))
    fired = [i for i in range(10) if a(i)]
    assert fired == [0, 2, 4]


def test_all_trigger_does_not_consume_boundaries():
    """Regression (ADVICE r2): AllTrigger advanced every stateful member
    per poll, so a boundary 'consumed' while another member evaluated
    False was lost forever — the composite never fired for it."""
    a = AllTrigger((2, 'iteration'), NotTrigger(EndTrigger(3)))
    assert a(0)
    assert a(2)
    # iteration 4 crosses the period-2 boundary but the Not(End(3))
    # member is False -> composite must not fire AND must not consume
    assert not a(4)
    assert not a(5)
    # a fresh composite whose interval member crossed a boundary while
    # blocked still sees the crossing once unblocked
    blocked = []
    interval = IntervalTrigger((2, 'iteration'))
    gate = lambda i, e=0: i >= 5  # noqa: E731 — stateless member
    b = AllTrigger(interval, gate)
    for i in range(8):
        if b(i):
            blocked.append(i)
    # crossings at 2 and 4 are gated off but NOT consumed: the first
    # unblocked poll (5) fires for the pending boundary, then 6 crosses
    assert blocked == [5, 6]


def test_nested_composite_triggers_do_not_consume_boundaries():
    """Regression (round-3 review): AnyTrigger inside AllTrigger used to
    commit its interval members on every poll even when the outer
    composite evaluated False — the consumed-boundary bug one nesting
    level deeper. Composites now implement peek/commit themselves."""
    from pb_sed_tpu.train.hooks import AnyTrigger
    inner = AnyTrigger(IntervalTrigger((2, 'iteration')))
    gate = lambda i, e=0: i >= 5  # noqa: E731 — stateless member
    outer = AllTrigger(inner, gate)
    fired = [i for i in range(8) if outer(i)]
    # crossings at 2 and 4 are gated but NOT consumed: first unblocked
    # poll (5) fires the pending boundary, then 6 crosses
    assert fired == [5, 6]


def test_interval_trigger_fires_on_boundary_crossing():
    """Regression: with steps_per_call>1 the iteration advances in
    strides, so exact-multiple matching would stretch the effective
    period to lcm(period, stride); crossings must fire instead."""
    t = IntervalTrigger((1000, 'iteration'))
    fired = [i for i in range(3, 3001, 3) if t(i)]
    assert fired == [1002, 2001, 3000]
    # repeated calls at the same index stay deduped
    t2 = IntervalTrigger((4, 'iteration'))
    assert t2(4) and not t2(4)
    # resume alignment: no immediate re-fire at the restored iteration
    t3 = IntervalTrigger((4, 'iteration'))
    t3.last = 8
    assert not t3(9) and not t3(11) and t3(12)


def test_resume_continues_rng_stream(tmp_path):
    """Regression: checkpoints used to store the initial seed key, so
    resume replayed the augment/dropout RNG stream from iteration 0."""
    import pickle

    import jax

    provider = make_provider(tmp_path / 'db')
    batch = next(iter(provider.get_train_set()))
    storage = tmp_path / 'run'
    t_full = Trainer(make_model(), storage_dir=None,
                     stop_trigger=(6, 'iteration'))
    t_full._ensure_ready(batch)
    full_losses = [float(t_full.train_step(batch)) for _ in range(6)]

    t_a = Trainer(make_model(), storage_dir=storage,
                  stop_trigger=(3, 'iteration'))
    t_a._ensure_ready(batch)
    a_losses = [float(t_a.train_step(batch)) for _ in range(3)]
    t_a.save_checkpoint()
    with (storage / 'checkpoints' / 'ckpt_latest.pkl').open('rb') as fid:
        payload = pickle.load(fid)
    seed_key = np.asarray(jax.random.PRNGKey(t_a.seed))
    assert not np.array_equal(payload['rng'], seed_key), (
        'checkpoint stored the initial seed key instead of the '
        'device-advanced one')

    t_b = Trainer(make_model(), storage_dir=storage,
                  stop_trigger=(6, 'iteration'))
    t_b._ensure_ready(batch)
    assert t_b.load_latest_checkpoint()
    b_losses = [float(t_b.train_step(batch)) for _ in range(3)]
    np.testing.assert_allclose(
        a_losses + b_losses, full_losses, rtol=1e-4)


def test_lr_annealing_hook():
    hook = LRAnnealingHook(breakpoints=[(0, 0.), (10, 1.), (10, 1.),
                                        (20, 1.), (20, 0.2)])
    assert hook.factor(0) == 0.
    assert hook.factor(5) == pytest.approx(0.5)
    assert hook.factor(15) == 1.
    assert hook.factor(25) == pytest.approx(0.2)


def test_trainer_end_to_end(tmp_path):
    provider = make_provider(tmp_path / 'db')
    model = make_model()
    storage = tmp_path / 'run'
    trainer = Trainer(
        model, storage_dir=storage,
        summary_trigger=(2, 'iteration'),
        checkpoint_trigger=(4, 'iteration'),
        stop_trigger=(8, 'iteration'),
    )
    trainer.optimizer.lr = 5e-3
    train_set = provider.get_train_set()
    validate_set = provider.get_validate_set()
    trainer.test_run(train_set, validate_set)
    trainer.register_validation_hook(
        validate_set, metric='macro_fscore_weak', maximize=True)
    trainer.register_hook(LRAnnealingHook(
        breakpoints=[(0, 0.), (4, 1.)]))
    losses = []
    trainer.train(train_set)
    assert trainer.iteration == 8
    # artifacts
    assert (storage / 'checkpoints' / 'ckpt_latest.pkl').exists()
    assert (storage / 'checkpoints'
            / 'ckpt_best_macro_fscore_weak.pkl').exists()
    assert (storage / 'summary.jsonl').exists()
    # lr annealing was applied
    assert trainer.lr_factor_annealing == 1.

    # resume continues from saved iteration
    trainer2 = Trainer(
        make_model(), storage_dir=storage,
        stop_trigger=(10, 'iteration'),
    )
    trainer2.register_validation_hook(
        validate_set, metric='macro_fscore_weak', maximize=True)
    batch = next(iter(train_set))
    trainer2._ensure_ready(batch)
    assert trainer2.load_latest_checkpoint()
    assert trainer2.iteration == 8
    trainer2.train(train_set, resume=False)
    assert trainer2.iteration == 10


def test_test_run_is_side_effect_free(tmp_path):
    """Regression: test_run used to run a real train_step whose
    checkpoint trigger fired at iteration 1 and overwrote ckpt_latest
    before train(resume=True) could load it, silently restarting
    training from scratch; it also applied one hidden optimizer update.
    """
    import pickle

    import jax
    import numpy as np

    provider = make_provider(tmp_path / 'db')
    storage = tmp_path / 'run'
    trainer = Trainer(
        model := make_model(), storage_dir=storage,
        checkpoint_trigger=(3, 'iteration'),
        stop_trigger=(6, 'iteration'),
    )
    train_set = provider.get_train_set()
    trainer.train(train_set)
    assert trainer.iteration == 6
    latest = storage / 'checkpoints' / 'ckpt_latest.pkl'
    with latest.open('rb') as fid:
        assert pickle.load(fid)['iteration'] == 6

    # fresh trainer, same storage dir: the reference chain runs
    # test_run BEFORE train(resume=True)
    trainer2 = Trainer(
        make_model(), storage_dir=storage,
        checkpoint_trigger=(3, 'iteration'),
        stop_trigger=(9, 'iteration'),
    )
    trainer2._ensure_ready(next(iter(train_set)))
    params_before = jax.tree.map(np.asarray, trainer2.model.variables)
    trainer2.test_run(train_set)
    params_after = jax.tree.map(np.asarray, trainer2.model.variables)
    # no hidden optimizer update
    jax.tree.map(np.testing.assert_array_equal,
                 params_before, params_after)
    # ckpt_latest untouched -> resume continues at 6, stops at 9
    with latest.open('rb') as fid:
        assert pickle.load(fid)['iteration'] == 6
    trainer2.train(train_set, resume=True)
    assert trainer2.iteration == 9
    with latest.open('rb') as fid:
        assert pickle.load(fid)['iteration'] == 9


def test_trainer_profiler_trace(tmp_path):
    """profile_at captures a JAX profiler trace into storage_dir/profile
    (SURVEY.md §5 device-time observability) and reads the device time
    per step from it; a trace without a GPU plane is an error, not a
    silent skip."""
    provider = make_provider(tmp_path / 'db')
    storage = tmp_path / 'run'
    trainer = Trainer(
        make_model(), storage_dir=storage,
        stop_trigger=(4, 'iteration'),
        profile_at=2, profile_num_steps=2,
    )
    with pytest.raises(RuntimeError, match='no device plane'):
        trainer.train(provider.get_train_set())
    assert trainer.iteration == 4  # the profile window closed
    trace_files = list((storage / 'profile').rglob('*'))
    assert any(p.is_file() for p in trace_files), trace_files


def test_trainer_overfits_tiny_batch(tmp_path):
    provider = make_provider(tmp_path / 'db')
    model = make_model()
    trainer = Trainer(model, storage_dir=None,
                      stop_trigger=(30, 'iteration'))
    trainer.optimizer.lr = 1e-2
    batch = next(iter(provider.get_train_set()))
    trainer._ensure_ready(batch)
    first = float(trainer.train_step(batch))
    for _ in range(29):
        last = float(trainer.train_step(batch))
    assert last < first, (first, last)


def test_freeze_blocks_updates(tmp_path):
    provider = make_provider(tmp_path / 'db')
    model = make_model()
    trainer = Trainer(model, storage_dir=None,
                      stop_trigger=(3, 'iteration'))
    batch = next(iter(provider.get_train_set()))
    trainer._ensure_ready(batch)
    before = model.state_dict()
    trainer.freeze(lambda path: path.startswith('cnn.'))
    trainer.train_step(batch)
    after = model.state_dict()
    frozen_keys = [k for k in before
                   if k.startswith('params.cnn.')
                   and not ('norm' in k)]  # BN stats may still update
    moved_keys = [k for k in before if k.startswith('params.rnn_fwd.')
                  and 'conv' in k and k.endswith('kernel')]
    assert frozen_keys and moved_keys
    for k in frozen_keys:
        np.testing.assert_array_equal(before[k], after[k])
    assert any(
        np.abs(before[k] - after[k]).max() > 0 for k in moved_keys)


def test_multi_step_lane_fires_triggers(tmp_path):
    """Regression: with steps_per_call=3 and checkpoint_interval=4 the
    old exact-multiple trigger fired only every lcm(3,4)=12 iterations."""
    provider = make_provider(tmp_path / 'db')
    storage = tmp_path / 'run'
    trainer = Trainer(make_model(), storage_dir=storage,
                      steps_per_call=3,
                      checkpoint_trigger=(4, 'iteration'),
                      stop_trigger=(100, 'iteration'),
                      keep_checkpoints=10)
    batch = next(iter(provider.get_train_set()))
    trainer._ensure_ready(batch)
    for _ in range(4):
        trainer.train_steps([batch] * 3)
    names = sorted(
        int(p.stem.split('_')[1])
        for p in (storage / 'checkpoints').glob('ckpt_[0-9]*.pkl'))
    assert names == [6, 9, 12], names


def test_multi_step_training(tmp_path):
    provider = make_provider(tmp_path / 'db')
    model = make_model()
    trainer = Trainer(model, storage_dir=None,
                      stop_trigger=(8, 'iteration'), steps_per_call=4)
    trainer.optimizer.lr = 5e-3
    batch = next(iter(provider.get_train_set()))
    trainer._ensure_ready(batch)
    losses = trainer.train_steps([batch] * 4)
    assert trainer.iteration == 4
    assert np.asarray(losses).shape == (4,)
    assert np.isfinite(np.asarray(losses)).all()
    # multi-step losses match per-step training (identical rng chain);
    # exact param equality is NOT asserted: adam amplifies bf16/scan
    # float-ordering noise to O(lr) per step
    model2 = make_model()
    trainer2 = Trainer(model2, storage_dir=None,
                       stop_trigger=(8, 'iteration'))
    trainer2.optimizer.lr = 5e-3
    trainer2._ensure_ready(batch)
    step_losses = [float(trainer2.train_step(batch)) for _ in range(4)]
    np.testing.assert_allclose(
        np.asarray(losses), step_losses, rtol=2e-2)
    # buffered summaries flush fine (stacked scalars)
    trainer._flush_summary(prefix='training')
