"""Test configuration.

The suite runs on the CPU: ``JAX_PLATFORMS=cpu python -m pytest tests/``.
The CPU backend is given 8 virtual devices so the sharding tests build
real meshes. Tests that need a GPU carry the ``gpu`` marker and take the
``gpu`` fixture, which skips them unless JAX's first device is a GPU; on
the card they run with ``python -m pytest -m gpu tests/``. The persistent
compile cache follows ``pb_sed_tpu.utils.device.configure_compile_cache``.
"""
import os

import pytest

flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8').strip()

from pb_sed_tpu.utils.device import configure_compile_cache  # noqa: E402

configure_compile_cache()


@pytest.fixture
def gpu():
    """The GPU devices; skips the test when JAX runs on anything else."""
    import jax
    devices = jax.devices()
    if devices[0].platform != 'gpu':
        pytest.skip(f'needs a GPU; JAX runs on {devices[0].platform}')
    return devices
