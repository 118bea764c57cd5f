"""chip_smoke.py: it refuses to run without a GPU or without the package
beside it, and its phases run at tiny size on the CPU (the four-card
phase on four of the virtual CPU devices)."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def _smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(out):
    lines = out.stdout.strip().splitlines()
    return not lines or '"ok"' not in lines[-1]


def test_refuses_without_a_gpu():
    out = _smoke(ROOT, ROOT / 'chip_smoke.py')
    assert out.returncode != 0
    assert 'no GPU' in out.stderr
    assert _no_result(out)


def test_refuses_without_the_package(tmp_path):
    shutil.copy(ROOT / 'chip_smoke.py', tmp_path)
    out = _smoke(tmp_path, tmp_path / 'chip_smoke.py')
    assert out.returncode != 0
    assert 'package is not beside' in out.stderr
    assert _no_result(out)


@pytest.fixture(scope='module')
def trained():
    return chip_smoke.phase_train('tiny')


def test_phase_train_tiny(trained):
    found, trainer, batch = trained
    assert set(found) == {'shallow', 'deep', 'bicrnn'}
    assert len(found['shallow']['step_ms']) == 5
    assert len(found['shallow']['losses']) == 8
    for run in found.values():
        assert np.isfinite(run['losses']).all()
        assert run['params'] > 0
    json.dumps(found)  # printable findings


def test_phase_parity_tiny(trained):
    _, trainer, batch = trained
    found = chip_smoke.phase_parity(trainer.model, batch, n_clips=2,
                                    gru_batch=4, gru_steps=50)
    control = found.pop('gru_control')
    assert set(found) == {'y_fwd', 'y_bwd', 'loss', 'gru_h256'}
    assert all(v['within'] for v in found.values())
    # the bf16-state recurrence is rejected by the GRU check's bounds
    assert not control['within']
    assert control['mean_rel_err'] > 2 * chip_smoke.GRU_MEAN_REL


def test_phase_ensemble_tiny():
    found = chip_smoke.phase_ensemble('tiny', n_members=3, batch_size=4,
                                      seconds=1., n_batches=2)
    assert found['clips_scored'] == 8
    assert found['max_abs_err'] <= found['tolerance']


def test_phase_trace_needs_a_device_plane(trained):
    _, trainer, batch = trained
    with pytest.raises(RuntimeError, match='no device plane'):
        chip_smoke.phase_trace(trainer, batch, steps=1)


def test_phase_multi_tiny_on_four_devices():
    found = chip_smoke.phase_multi(4, 'tiny', batch_size=8, seconds=1.,
                                   n_members=4)
    assert found['mesh_shape'] == {'ensemble': 4, 'data': 1}
    train = found['train']
    assert train['within']
    assert train['grad'] <= chip_smoke.MULTI_GRAD_REL
    assert train['stats_delta_worst_leaf'][0] <= chip_smoke.MULTI_STATS_REL
    assert found['sed']['within']


@pytest.fixture(scope='module')
def one_device_step():
    return chip_smoke.train_once(None, 'tiny', 8, 1.)


@pytest.mark.parametrize('clips', [2, 4], ids=['one_shard', 'half_batch'])
def test_phase_multi_rejects_planted_faults(one_device_step, clips):
    """A step whose gradient and statistics come from one of four shards
    (2 of 8 clips) or from half the batch fails the data-parallel check
    that the sound four-device step passes."""
    fault = chip_smoke.train_once(None, 'tiny', 8, 1., clips=clips)
    found = chip_smoke.compare_steps(fault, one_device_step)
    assert not found['within'], found
    assert found['grad'] > chip_smoke.MULTI_GRAD_REL
    assert found['stats_delta_worst_leaf'][0] > chip_smoke.MULTI_STATS_REL
