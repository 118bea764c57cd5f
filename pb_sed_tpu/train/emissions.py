"""Lightweight energy/emissions tracking (codecarbon-surface parity).

The reference wraps tuning/inference/training in codecarbon's
``EmissionsTracker`` (``experiments/weak_label_crnn/tuning.py:93-95,248``,
``training.py:397-400``). Without codecarbon this provides the same
start/stop/flush API backed by wall-clock x a power ceiling, appended to
``emissions.csv``: on a GPU the cards' ``power.limit`` as ``nvidia-smi``
reports it, on the CPU a fixed estimate. The figures are upper bounds,
not metered draw, and every column says ``_estimated``.
"""
import csv
import time
from pathlib import Path

import jax

from pb_sed_tpu.utils.device import gpu_name_power_limit, parse_power_limits_w

CPU_WATTS_ESTIMATE = 50.


def power_ceiling_w(platform, num_devices):
    """Summed power ceiling (W) of ``num_devices`` devices."""
    if platform == 'gpu':
        limits = parse_power_limits_w(gpu_name_power_limit())
        return sum(limits[:num_devices])
    if platform == 'cpu':
        return CPU_WATTS_ESTIMATE
    raise ValueError(f'no power figure for platform {platform!r}')


class EmissionsTracker:
    def __init__(self, output_dir, on_csv_write='update',
                 carbon_intensity_g_per_kwh=450.):
        self.output_dir = Path(output_dir)
        self.carbon_intensity = carbon_intensity_g_per_kwh
        self.start_time = None
        self.on_csv_write = on_csv_write

    def start(self):
        self.start_time = time.time()

    def __enter__(self):
        self.start()
        return self

    def stop(self):
        if self.start_time is None:
            return None
        duration = time.time() - self.start_time
        devices = jax.devices()
        platform = devices[0].platform
        watts = power_ceiling_w(platform, len(devices))
        energy_kwh = watts * duration / 3600. / 1000.
        emissions_kg = energy_kwh * self.carbon_intensity / 1000.
        self._write(duration, energy_kwh, emissions_kg, platform,
                    len(devices))
        self.start_time = None
        return emissions_kg

    def __exit__(self, *exc):
        self.stop()

    def _write(self, duration, energy_kwh, emissions_kg, platform, n):
        self.output_dir.mkdir(parents=True, exist_ok=True)
        path = self.output_dir / 'emissions.csv'
        new = not path.exists()
        with path.open('a', newline='') as fid:
            writer = csv.writer(fid)
            if new:
                # *_estimated: wall-clock x power ceiling, NOT a measured
                # power draw — do not compare against metered numbers
                writer.writerow([
                    'timestamp', 'duration_s', 'platform', 'num_devices',
                    'energy_kwh_estimated', 'emissions_kg_estimated'])
            writer.writerow([
                time.strftime('%Y-%m-%dT%H:%M:%S'), f'{duration:.1f}',
                platform, n, f'{energy_kwh:.6f}', f'{emissions_kg:.6f}'])
