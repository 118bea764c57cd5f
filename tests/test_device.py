"""Device helpers (pb_sed_tpu/utils/device.py), the emissions power
ceiling, the profiler-trace reduction (pb_sed_tpu/utils/xplane.py) on a
synthetic GPU trace, and what the device path imports."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from pb_sed_tpu.utils import device, xplane

ROOT = Path(__file__).resolve().parents[1]


def _run(code, **env):
    full = dict(os.environ, JAX_PLATFORMS='cpu', **env)
    return subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=full,
                          capture_output=True, text=True, timeout=300)


# ----------------------------------------------------------------------
# peaks, nvidia-smi, compile cache, the GPU check
# ----------------------------------------------------------------------
def test_peaks_of_the_h100():
    peaks = device.device_peaks('NVIDIA H100 80GB HBM3')
    assert peaks == {'bf16_flops': 989e12, 'hbm_bytes_per_s': 3.35e12}


@pytest.mark.parametrize('kind', ['cpu', 'NVIDIA H200', 'NVIDIA A100'])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(KeyError, match='no published peaks'):
        device.device_peaks(kind)


@pytest.mark.parametrize('text,want', [
    ('NVIDIA H100 80GB HBM3, 400.00 W', [400.]),
    ('NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 650.00 W\n',
     [700., 650.]),
])
def test_parse_power_limits(text, want):
    assert device.parse_power_limits_w(text) == want


@pytest.mark.parametrize('text', ['NVIDIA H100 80GB HBM3, [N/A]', ''])
def test_parse_power_limits_rejects(text):
    with pytest.raises(ValueError):
        device.parse_power_limits_w(text)


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(RuntimeError, match='no GPU: JAX found only cpu'):
        device.require_gpu()


def test_compile_cache_default_is_in_the_checkout():
    env = {k: v for k, v in os.environ.items()
           if k != 'JAX_COMPILATION_CACHE_DIR'}
    code = ('import jax; from pb_sed_tpu.utils.device import '
            'configure_compile_cache as c; p = c(); '
            'print(p, jax.config.jax_compilation_cache_dir)')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         env=dict(env, JAX_PLATFORMS='cpu'),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    path, configured = out.stdout.split()
    assert path == configured == str(ROOT / '.jax_cache')


def test_compile_cache_follows_the_environment(tmp_path):
    code = ('import jax; from pb_sed_tpu.utils.device import '
            'configure_compile_cache as c; p = c(); '
            'print(p, jax.config.jax_compilation_cache_dir)')
    out = _run(code, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(tmp_path), str(tmp_path)]


# ----------------------------------------------------------------------
# emissions: power.limit as the ceiling
# ----------------------------------------------------------------------
def test_emissions_gpu_ceiling_is_the_power_limit(monkeypatch):
    from pb_sed_tpu.train import emissions
    monkeypatch.setattr(
        emissions, 'gpu_name_power_limit',
        lambda: 'NVIDIA H100 80GB HBM3, 400.00 W\n'
                'NVIDIA H100 80GB HBM3, 700.00 W')
    assert emissions.power_ceiling_w('gpu', 1) == 400.
    assert emissions.power_ceiling_w('gpu', 2) == 1100.


def test_emissions_cpu_estimate():
    from pb_sed_tpu.train import emissions
    assert emissions.power_ceiling_w('cpu', 8) == \
        emissions.CPU_WATTS_ESTIMATE


def test_emissions_unknown_platform_raises():
    from pb_sed_tpu.train import emissions
    with pytest.raises(ValueError, match='no power figure'):
        emissions.power_ceiling_w('rocm', 1)


# ----------------------------------------------------------------------
# trace reduction on a synthetic XSpace with a GPU plane
# ----------------------------------------------------------------------
XSPACE = '''
planes {
  id: 1 name: "/device:GPU:0"
  lines { id: 1 name: "Stream #13(Compute)" timestamp_ns: 0
    events { metadata_id: 1 offset_ps: 1000000 duration_ps: 2000000
      stats { metadata_id: 1 str_value: "jit_step" }
      stats { metadata_id: 2 str_value: "jit(step)/cnn/conv_0" } }
    events { metadata_id: 2 offset_ps: 2000000 duration_ps: 2000000
      stats { metadata_id: 1 str_value: "jit_step" }
      stats { metadata_id: 2 str_value: "jit(step)/rnn/while" } }
    events { metadata_id: 1 offset_ps: 11000000 duration_ps: 1000000
      stats { metadata_id: 1 str_value: "jit_step" }
      stats { metadata_id: 2 str_value: "jit(step)/cnn/conv_0" } }
  }
  event_metadata { key: 1 value { id: 1 name: "conv_kernel" } }
  event_metadata { key: 2 value { id: 2 name: "gemm_kernel" } }
  stat_metadata { key: 1 value { id: 1 name: "hlo_module" } }
  stat_metadata { key: 2 value { id: 2 name: "name" } }
}
planes {
  id: 2 name: "/host:CPU"
  lines { id: 1 name: "python" timestamp_ns: 0
    events { metadata_id: 1 offset_ps: 0 duration_ps: 500000
      stats { metadata_id: 1 int64_value: 0 } }
    events { metadata_id: 1 offset_ps: 10000000 duration_ps: 500000
      stats { metadata_id: 1 int64_value: 1 } }
  }
  event_metadata { key: 1 value { id: 1 name: "train" } }
  stat_metadata { key: 1 value { id: 1 name: "step_num" } }
}
'''


def _write_trace(tmp_path, text):
    from jax.profiler import ProfileData
    run = tmp_path / 'plugins' / 'profile' / '2026_01_01'
    run.mkdir(parents=True)
    (run / 'host.xplane.pb').write_bytes(
        ProfileData.text_proto_to_serialized_xspace(text))
    return tmp_path


def test_xplane_selects_the_gpu_plane(tmp_path):
    trace = _write_trace(tmp_path, XSPACE)
    planes = dict(xplane.describe(trace))
    assert planes['/device:GPU:0'] == [('Stream #13(Compute)', 3)]
    read = xplane.read_trace(trace)
    assert list(read.devices) == ['/device:GPU:0']
    assert [s for _, s in read.steps] == [0, 1]
    # step 0: kernels [1, 3) and [2, 4) us overlap -> 3 us busy
    assert xplane.device_step_times_ms(trace) == pytest.approx(
        [0.003, 0.001])


def test_xplane_busy_idle_and_breakdown(tmp_path):
    trace = _write_trace(tmp_path, XSPACE)
    busy = xplane.device_busy(trace)['/device:GPU:0']
    assert busy['window_ms'] == pytest.approx(0.012)
    assert busy['busy_ms'] == pytest.approx(0.004)
    assert busy['idle_share'] == pytest.approx(1 - 4 / 12)
    by_scope = xplane.kernel_breakdown_ms(trace, key='scope')
    assert by_scope == {'jit(step)/cnn/conv_0': pytest.approx((0.003, 2)),
                        'jit(step)/rnn/while': pytest.approx((0.002, 1))}
    assert list(xplane.kernel_breakdown_ms(trace, top=1)) == [
        'conv_kernel']


def test_xplane_without_device_plane_raises(tmp_path):
    host_only = XSPACE[XSPACE.index('planes {\n  id: 2'):]
    trace = _write_trace(tmp_path, host_only)
    with pytest.raises(RuntimeError, match='no device plane'):
        xplane.device_step_times_ms(trace)


# ----------------------------------------------------------------------
# imports of the device path and of the evaluation workers
# ----------------------------------------------------------------------
@pytest.mark.parametrize('module', [
    'pb_sed_tpu.train.trainer', 'pb_sed_tpu.models.weak_label',
    'pb_sed_tpu.models.strong_label', 'pb_sed_tpu.models.base.ensemble',
    'pb_sed_tpu.models.base.inference'])
def test_device_path_imports_no_pandas(module):
    out = _run(f'import sys, {module}; print("pandas" in sys.modules)')
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'False'


def test_package_imports_only_what_the_card_has():
    """Module-level imports of the package are the standard library,
    the package itself, or packages sure to be beside JAX on the card;
    anything else (pandas, sklearn, tensorboardX) is imported lazily."""
    import ast
    card = {'jax', 'numpy', 'scipy', 'optax', 'chex', 'einops'}
    found = set()
    for path in (ROOT / 'pb_sed_tpu').rglob('*.py'):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.Import):
                found.update(a.name.split('.')[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                found.add(node.module.split('.')[0])
    third_party = found - set(sys.stdlib_module_names) - {'pb_sed_tpu'}
    assert third_party <= card, third_party - card


@pytest.mark.parametrize('module', [
    'collar_based', 'intersection_based', 'instance_based', 'changepoints'])
def test_evaluation_workers_import_no_jax(module):
    """The spawn workers of evaluation/parallel.py import these modules;
    without jax they cannot start a device backend."""
    out = _run(f'import sys, pb_sed_tpu.evaluation.{module}; '
               f'print("jax" in sys.modules)')
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'False'
