"""The accelerator the program runs on: the GPU check, the card's name and
power limit from ``nvidia-smi``, published peak rates, and where the
persistent compile cache lives."""
import os
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]

# Published dense peaks, keyed by ``jax.Device.device_kind``. Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM part (bf16 tensor-core
# FLOP/s without sparsity; HBM3 bandwidth), at the full 700 W limit.
PEAKS = {
    'NVIDIA H100 80GB HBM3': {'bf16_flops': 989e12,
                              'hbm_bytes_per_s': 3.35e12},
}

SMI_QUERY = ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader']


def device_peaks(device_kind):
    """Published peaks of ``device_kind``; an unknown kind is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f'no published peaks for device kind {device_kind!r}: add '
            f'them to pb_sed_tpu.utils.device.PEAKS with their source'
        ) from None


def require_gpu():
    """``jax.devices()`` when they are GPUs; otherwise RuntimeError naming
    what JAX found instead."""
    import jax
    try:
        devices = jax.devices()
    except RuntimeError as exc:
        raise RuntimeError(f'no GPU: JAX has no usable backend ({exc})'
                           ) from exc
    if devices[0].platform != 'gpu':
        raise RuntimeError(
            f'no GPU: JAX found only {devices[0].platform} devices '
            f'({devices[0].device_kind})')
    return devices


def gpu_name_power_limit():
    """The text of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader``: one ``name, limit`` line per card."""
    proc = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                          check=True, timeout=60)
    return proc.stdout.strip()


def parse_power_limits_w(text):
    """Watts per card from :func:`gpu_name_power_limit` output."""
    limits = []
    for line in text.strip().splitlines():
        _, _, limit = line.rpartition(',')
        value = limit.strip().split()[0] if limit.strip() else ''
        try:
            limits.append(float(value))
        except ValueError:
            raise ValueError(f'no power limit in {line!r}') from None
    if not limits:
        raise ValueError('nvidia-smi listed no card')
    return limits


def configure_compile_cache():
    """Use a persistent compile cache. JAX reads
    ``JAX_COMPILATION_CACHE_DIR`` itself when it is set; otherwise the
    cache is ``.jax_cache/`` in the checkout. Returns the directory."""
    path = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if path:
        return path
    import jax
    path = str(REPO_ROOT / '.jax_cache')
    jax.config.update('jax_compilation_cache_dir', path)
    return path
