"""Fused log-mel feature extractor with on-device augmentation.

On-device re-design of the reference feature front-end
(padertorch ``NormalizedLogMelExtractor`` configured at
``pb_sed/experiments/weak_label_crnn/training.py:190-217``):

    waveform -> STFT -> |.| -> (warped) mel -> log -> masked running
    normalization -> [train: time masks, frequency masks, additive noise]

Everything after the host ships the waveform happens inside one jit:
XLA fuses |STFT| with the (B,T,F)x(B,F,M) mel matmul, and the
augmentations are elementwise ops keyed by explicit JAX PRNG keys.
Mel warping (reference ``MelWarping``) is realised by building a *warped
filterbank per example on device* from two scalars (ops/mel.py), instead of
re-computing filter matrices on CPU workers.

Sequence masking: normalization statistics, masks and noise only ever see
valid frames (padded batches keep one compiled program per shape, which
the reference didn't need).
"""

import jax
import jax.numpy as jnp

from pb_sed_tpu import nn
from pb_sed_tpu.ops import mel as mel_ops
from pb_sed_tpu.ops.masking import sequence_mask
from pb_sed_tpu.ops.stft import STFT
from pb_sed_tpu.utils.config import Configurable

# int16 waveform transport scale: per-instance max-normalized audio is
# in [-1, 1] but host-side scale augmentation / superposition mixing can
# exceed it, so quantize with 8x headroom (|x| <= 8 representable).
# Shared contract between Collate(audio_dtype='int16') and the device
# dequantization in NormalizedLogMelExtractor.
AUDIO_INT16_SCALE = 4096.0


def _time_delta(x, n=2):
    """HTK-style delta along time: regression over +-n frames with edge
    padding (the classic ``sum i*(x[t+i]-x[t-i]) / (2*sum i^2)``)."""
    t = x.shape[1]
    xp = jnp.pad(x, ((0, 0), (n, n), (0, 0)), mode='edge')
    denom = 2. * sum(i * i for i in range(1, n + 1))
    out = sum(
        i * (xp[:, n + i:t + n + i] - xp[:, n - i:t + n - i])
        for i in range(1, n + 1)
    )
    return out / denom


class NormalizedLogMelExtractor(nn.Module, Configurable):
    """(B, S) audio or (B, T, F) magnitudes -> (B, T, M) normalized log-mel.

    Attributes mirror the reference's config surface
    (``weak_label/crnn.py:318-327``, ``training.py:190-217``).
    """
    sample_rate: int = 16000
    stft_size: int = 1024
    stft_shift: int = 320
    stft_window_length: int = 960
    stft_fading: str = 'half'
    stft_window: str = 'blackman'
    number_of_filters: int = 128
    lowest_frequency: float = 50.
    highest_frequency: float = None
    # extra channels (reference padertorch surface consumed at
    # ``weak_label/crnn.py:324-326``): time-derivative features stacked
    # on a trailing channel axis -> (B, T, M, C)
    add_deltas: bool = False
    add_delta_deltas: bool = False
    # normalization
    norm_momentum: float = 0.95
    norm_eps: float = 1e-5
    learnable_affine: bool = True
    # augmentation (train only)
    frequency_warping: bool = False
    warp_factor_scale: float = .08
    warp_factor_truncation: float = None  # default ln(1.3)
    boundary_ratio_scale: float = .5
    boundary_ratio_truncation: float = 5.
    n_time_masks: int = 0
    max_masked_time_steps: int = 70
    max_masked_time_rate: float = .2
    n_frequency_masks: int = 0
    max_masked_frequency_bands: int = 20
    max_masked_frequency_rate: float = .2
    max_noise_scale: float = 0.

    @property
    def stft(self):
        return STFT(
            shift=self.stft_shift, window_length=self.stft_window_length,
            size=self.stft_size, fading=self.stft_fading,
            window=self.stft_window,
        )

    def __call__(self, x, seq_len, training=False, warp_params=None):
        """
        Args:
            x: (B, S) waveforms, (B, T, F) magnitudes, or (B, T, F, 2)
                real/imag STFT (reference tensor layout minus the channel
                axis).
            seq_len: (B,) valid *frames* (when x is a spectrogram) or the
                number of valid frames after the STFT (when x is audio; the
                host computes it via ``STFT.num_frames``).
            training: enables augmentation + running-stat updates.
            warp_params: optional (anchor_out, anchor_in, valid_samples)
                arrays for device-side time-warped framing.

        Returns: (B, T, M) features.
        """
        if x.dtype == jnp.int16:
            # quantized waveform transport (Collate audio_dtype='int16'):
            # per-instance-normalized audio quantized at AUDIO_INT16_SCALE
            # halves the host->device bytes vs f32 — the batch upload is
            # latency+bandwidth-bound on remote/PCIe links. Dequantize on
            # device; quantization error (~2.4e-4 at scale 4096) sits far
            # below the training noise augmentation.
            x = x.astype(jnp.float32) / AUDIO_INT16_SCALE
        if x.ndim == 2:
            stft = self.stft
            if warp_params is not None:
                mag = stft.magnitude_warped(x, *warp_params)
            else:
                frames = stft.frame(x)
                mag = stft._frames_to_magnitude(frames)
        elif x.ndim == 4:
            mag = jnp.sqrt(jnp.sum(jnp.square(x), axis=-1) + 1e-18)
        else:
            mag = x
        b, t, f = mag.shape
        m = self.number_of_filters

        if training and self.frequency_warping:
            trunc = self.warp_factor_truncation
            if trunc is None:
                import math
                trunc = math.log(1.3)
            key = self.make_rng('augment')
            k1, k2 = jax.random.split(key)
            warp = jnp.exp(jnp.clip(
                self.warp_factor_scale * jax.random.normal(k1, (b,)),
                -trunc, trunc))
            ratio = jnp.minimum(
                jax.random.exponential(k2, (b,)) * self.boundary_ratio_scale,
                self.boundary_ratio_truncation)
            fbank = mel_ops.warped_mel_filterbank(
                warp, ratio, m, self.sample_rate, self.stft_size,
                self.lowest_frequency, self.highest_frequency)
            melspec = jnp.einsum('btf,bfm->btm', mag, fbank)
        else:
            fbank = mel_ops.mel_filterbank(
                m, self.sample_rate, self.stft_size,
                self.lowest_frequency, self.highest_frequency)
            melspec = mag @ fbank

        logmel = jnp.log(melspec + 1e-4)

        # masked running normalization per mel band (reference Normalization
        # with statistics over batch+time)
        mask = sequence_mask(seq_len, t)[:, :, None]  # (B, T, 1)
        ra_mean = self.variable(
            'batch_stats', 'mean', lambda: jnp.zeros((m,)))
        ra_var = self.variable(
            'batch_stats', 'var', lambda: jnp.ones((m,)))
        initialized = self.variable(
            'batch_stats', 'initialized', lambda: jnp.zeros(()))
        if training:
            count = jnp.maximum(mask.sum(), 1.)
            mean = (logmel * mask).sum((0, 1)) / count
            var = (jnp.square(logmel - mean) * mask).sum((0, 1)) / count
            momentum = jnp.where(
                initialized.value > 0, self.norm_momentum, 0.)
            ra_mean.value = momentum * ra_mean.value + (1 - momentum) * mean
            ra_var.value = momentum * ra_var.value + (1 - momentum) * var
            initialized.value = jnp.ones(())
        else:
            mean = ra_mean.value
            var = ra_var.value
        y = (logmel - mean) * jax.lax.rsqrt(var + self.norm_eps)
        if self.learnable_affine:
            gamma = self.param('scale', nn.initializers.ones, (m,))
            beta = self.param('shift', nn.initializers.zeros, (m,))
            y = y * gamma + beta

        if training:
            y = self._augment(y, seq_len, mask)
        y = y * mask
        if self.add_deltas or self.add_delta_deltas:
            # delta regression must see EDGE-replicated values past each
            # sequence end, not the zeroed padding (zeros would put a
            # spurious derivative spike on every clip tail). Select with
            # the mask + the last valid frame instead of a full-tensor
            # take_along_axis (a full-tensor gather/scatter — see
            # ops/masking.reverse_sequence).
            from pb_sed_tpu.ops.masking import take_last

            def edge_replicate(z):
                z_last = take_last(z, seq_len, axis=1, keepdims=True)
                return jnp.where(mask > 0, z, z_last)

            channels = [y]
            delta = _time_delta(edge_replicate(y)) * mask
            if self.add_deltas:
                channels.append(delta)
            if self.add_delta_deltas:
                channels.append(
                    _time_delta(edge_replicate(delta)) * mask)
            return jnp.stack(channels, axis=-1)  # (B, T, M, C)
        return y

    def _augment(self, y, seq_len, mask):
        b, t, m = y.shape
        if self.n_time_masks > 0:
            key = self.make_rng('augment')
            for i in range(self.n_time_masks):
                key, k1, k2 = jax.random.split(key, 3)
                max_w = jnp.minimum(
                    self.max_masked_time_steps,
                    (seq_len * self.max_masked_time_rate).astype(jnp.int32))
                w = (jax.random.uniform(k1, (b,))
                     * (max_w + 1).astype(jnp.float32)).astype(jnp.int32)
                start = (jax.random.uniform(k2, (b,)) * jnp.maximum(
                    seq_len - w, 1).astype(jnp.float32)).astype(jnp.int32)
                pos = jnp.arange(t)[None, :]
                hole = (pos >= start[:, None]) & (pos < (start + w)[:, None])
                y = jnp.where(hole[:, :, None], 0., y)
        if self.n_frequency_masks > 0:
            key = self.make_rng('augment')
            max_w = min(self.max_masked_frequency_bands,
                        int(m * self.max_masked_frequency_rate))
            for i in range(self.n_frequency_masks):
                key, k1, k2 = jax.random.split(key, 3)
                w = (jax.random.uniform(k1, (b,)) * (max_w + 1)).astype(
                    jnp.int32)
                start = (jax.random.uniform(k2, (b,)) * (m - w).astype(
                    jnp.float32)).astype(jnp.int32)
                pos = jnp.arange(m)[None, :]
                hole = (pos >= start[:, None]) & (pos < (start + w)[:, None])
                y = jnp.where(hole[:, None, :], 0., y)
        if self.max_noise_scale > 0:
            key = self.make_rng('augment')
            k1, k2 = jax.random.split(key)
            scale = jax.random.uniform(
                k1, (b, 1, 1), maxval=self.max_noise_scale)
            y = y + scale * jax.random.normal(k2, y.shape)
        return y
