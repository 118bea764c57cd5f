"""Restoring run directories that older code wrote.

``fixtures/old_runs/<name>`` hold a ``1/config.json`` (the data provider
and the trainer) and a checkpoint as the training experiments persist
them. The code before its module layer was replaced wrote them, with
the kernel-choice options ``use_pallas``, ``fuse_bn``, ``stft_backend``
and the STFT's ``backend`` that the code has since removed, together
with its eval-mode output ``y_eval.npy`` on a fixed input (2 clips of
0.5 s, ``np.random.RandomState(0)``). The data provider's database path
is a placeholder.
"""
import json
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest

from pb_sed_tpu.models import strong_label, weak_label
from pb_sed_tpu.utils.config import (
    REMOVED_OPTIONS, drop_removed_options, instantiate, load_run_config)

FIXTURES = Path(__file__).parent / 'fixtures' / 'old_runs'
RUNS = {
    'fbcrnn': (weak_label.CRNN, 'ckpt_best_macro_fscore_weak.pkl', {
        'feature_extractor.stft_backend', 'cnn.cnn_2d.use_pallas',
        'cnn.cnn_2d.fuse_bn', 'rnn_fwd.rnn.use_pallas',
        'rnn_bwd.rnn.use_pallas'}),
    'bicrnn_tag': (strong_label.CRNN, 'ckpt_best_macro_fscore_strong.pkl', {
        'feature_extractor.stft_backend', 'cnn.cnn_2d.use_pallas',
        'cnn.cnn_2d.fuse_bn', 'rnn.rnn.use_pallas'}),
}


def _batch(model, tags):
    n = 8000
    batch = {
        'audio_data': np.random.RandomState(0).randn(2, n).astype(
            np.float32),
        'seq_len_samples': np.full(2, n, np.int32)}
    frames = int(model.module.feature_extractor.stft.num_frames(n))
    batch['seq_len'] = np.full(2, frames, np.int32)
    if tags:
        batch['tag_condition'] = np.ones((2, 3), np.float32)
    return batch


@pytest.mark.parametrize('name', sorted(RUNS))
def test_restore_old_run_dir(name):
    cls, ckpt, _ = RUNS[name]
    with pytest.warns(UserWarning, match='removed from the code'):
        model = cls.from_storage_dir(FIXTURES / name, checkpoint_name=ckpt)
    with (FIXTURES / name / 'checkpoints' / ckpt).open('rb') as fid:
        stored = pickle.load(fid)['model']
    restored = model.state_dict()
    assert set(restored) == set(stored)
    for key, value in stored.items():
        np.testing.assert_array_equal(restored[key], value, err_msg=key)
    y = model.module.apply(model.variables, _batch(model, name != 'fbcrnn'),
                           training=False)[0]
    np.testing.assert_allclose(
        np.asarray(y), np.load(FIXTURES / name / 'y_eval.npy'),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('name', sorted(RUNS))
def test_drop_removed_options_names_each_key(name):
    _, _, expected = RUNS[name]
    config = json.loads(
        (FIXTURES / name / '1' / 'config.json').read_text())
    with pytest.warns(UserWarning):
        dropped = drop_removed_options(config['trainer']['model'], 'm')
    assert {d[len('m.'):] for d in dropped} == expected
    text = json.dumps(config['trainer']['model'])
    assert not any(f'"{key}"' in text for key in REMOVED_OPTIONS)


@pytest.mark.parametrize('name', sorted(RUNS))
def test_old_data_provider_config_instantiates(name):
    """Tuning and inference reuse a run's stored data-provider config;
    its transforms' STFTs carried ``backend``."""
    with pytest.warns(UserWarning, match='stft.backend'):
        config = load_run_config(FIXTURES / name / '1' / 'config.json')
    for key in ('train_transform', 'test_transform'):
        transform = instantiate(config['data_provider'][key])
        assert (transform.stft.shift, transform.stft.size) == (320, 1024)


def test_restore_current_run_dir_keeps_config(tmp_path, recwarn):
    """A run directory written by the current code restores without a
    warning and with its config untouched."""
    from pb_sed_tpu.utils.config import config_to_json
    from pb_sed_tpu.utils.misc import dump_json, load_json
    cls, ckpt, _ = RUNS['fbcrnn']
    old = load_json(FIXTURES / 'fbcrnn' / '1' / 'config.json')
    drop_removed_options(old)
    recwarn.clear()
    model_config = cls.get_config(old['trainer']['model'])
    run = tmp_path / 'run'
    dump_json(config_to_json({'trainer': {'model': model_config}}),
              run / '1' / 'config.json')
    shutil.copytree(FIXTURES / 'fbcrnn' / 'checkpoints', run / 'checkpoints')
    before = (run / '1' / 'config.json').read_text()
    model = cls.from_storage_dir(run, checkpoint_name=ckpt)
    assert not [w for w in recwarn if 'removed from the code' in str(
        w.message)]
    assert (run / '1' / 'config.json').read_text() == before
    assert model.num_parameters() == 4064
