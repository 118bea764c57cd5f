"""Mel filterbank construction and VTLP-style mel warping.

Capability parity with paderbox's fbank/``MelWarping`` as configured by the
reference (``experiments/weak_label_crnn/training.py:195-209``: 128 filters,
warp_factor ~ LogTruncatedNormal(scale=.08, trunc=ln 1.3),
boundary_frequency_ratio ~ TruncatedExponential(scale=.5, trunc=5),
highest_frequency = sr/2).

Design: the warped filterbank is built *per example on device* from two
scalars (warp factor, boundary ratio) via a closed-form triangle formula,
then applied as one batched (B,T,F)x(B,F,M) matmul next to the |STFT|
that precedes it.
"""
import jax.numpy as jnp
import numpy as np


def hz2mel(f):
    return 2595.0 * jnp.log10(1.0 + f / 700.0)


def mel2hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mel_edge_frequencies(num_filters, sample_rate, size,
                         lowest_frequency=50., highest_frequency=None):
    """(num_filters + 2,) triangle edge frequencies in Hz (numpy)."""
    if highest_frequency is None:
        highest_frequency = sample_rate / 2
    mlo = 2595.0 * np.log10(1.0 + lowest_frequency / 700.0)
    mhi = 2595.0 * np.log10(1.0 + highest_frequency / 700.0)
    mels = np.linspace(mlo, mhi, num_filters + 2)
    return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)


def _triangles(edges_hz, bin_hz):
    """Build triangle filters from edge frequencies.

    Args:
        edges_hz: (..., M + 2) triangle edges.
        bin_hz: (F,) FFT bin center frequencies.

    Returns: (..., F, M) filterbank.
    """
    lower = edges_hz[..., :-2]    # (..., M)
    center = edges_hz[..., 1:-1]
    upper = edges_hz[..., 2:]
    f = bin_hz.reshape((1,) * (edges_hz.ndim - 1) + (-1, 1))  # (..., F, 1)
    lower = lower[..., None, :]
    center = center[..., None, :]
    upper = upper[..., None, :]
    up = (f - lower) / jnp.maximum(center - lower, 1e-6)
    down = (upper - f) / jnp.maximum(upper - center, 1e-6)
    return jnp.clip(jnp.minimum(up, down), 0.0, 1.0)


def mel_filterbank(num_filters, sample_rate, size,
                   lowest_frequency=50., highest_frequency=None):
    """Static (F, M) mel filterbank (F = size // 2 + 1)."""
    edges = jnp.asarray(mel_edge_frequencies(
        num_filters, sample_rate, size, lowest_frequency, highest_frequency))
    bin_hz = jnp.arange(size // 2 + 1) * sample_rate / size
    return _triangles(edges, bin_hz).astype(jnp.float32)


def warp_frequencies(f, warp_factor, boundary_frequency, highest_frequency):
    """VTLP piecewise-linear frequency warp.

    ``w(f) = alpha * f`` below the breakpoint, then linear up to
    ``(f_max, f_max)``. The breakpoint is
    ``min(boundary_frequency, f_max / alpha, f_max)`` so the warp stays
    within [0, f_max] and is continuous.

    Args:
        f: (..., K) frequencies in Hz.
        warp_factor: (...,) alpha.
        boundary_frequency: (...,) requested breakpoint in Hz.
        highest_frequency: scalar f_max.
    """
    alpha = warp_factor[..., None]
    f_max = highest_frequency
    bp = jnp.minimum(
        jnp.minimum(boundary_frequency[..., None], f_max / alpha), f_max)
    bp = jnp.maximum(bp, 1.0)
    lo = alpha * f
    hi = alpha * bp + (f - bp) * (f_max - alpha * bp) / jnp.maximum(
        f_max - bp, 1.0)
    return jnp.where(f < bp, lo, hi)


def warped_mel_filterbank(
        warp_factor, boundary_ratio, num_filters, sample_rate, size,
        lowest_frequency=50., highest_frequency=None):
    """Per-example warped filterbanks, fully on device.

    Args:
        warp_factor: (B,) multiplicative warp factors (~1.0).
        boundary_ratio: (B,) boundary frequency as a ratio of f_max.

    Returns: (B, F, M) filterbanks.
    """
    if highest_frequency is None:
        highest_frequency = sample_rate / 2
    edges = jnp.asarray(mel_edge_frequencies(
        num_filters, sample_rate, size, lowest_frequency, highest_frequency)
    )[None, :]  # (1, M+2)
    warped = warp_frequencies(
        edges, warp_factor, boundary_ratio * highest_frequency,
        highest_frequency)
    bin_hz = jnp.arange(size // 2 + 1) * sample_rate / size
    return _triangles(warped, bin_hz).astype(jnp.float32)
