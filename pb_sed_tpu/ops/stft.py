"""Device-side STFT front-end.

On-device re-design of the reference's CPU-worker STFT
(padertorch ``STFT``/``TimeWarpedSTFT`` consumed at
``pb_sed/data_preparation/provider.py:315-322`` and
``pb_sed/data_preparation/transform.py:36-53``): instead of computing the
STFT per example in host worker processes and shipping (B, C, T, F, 2)
tensors, we ship raw waveforms (B, S) and compute framing -> window ->
rFFT -> magnitude inside the jitted step. This cuts host->device bytes by
~6x and removes the host CPU from the hot path; XLA fuses the whole
front-end with the mel projection (see ops/features.py).

Contract (defaults match the reference: shift=320, window_length=960,
size=1024, fading='half', pad=True — ``provider.py:315-322``):

- fading pads ``(window_length - shift) // 2`` ('half') or
  ``window_length - shift`` ('full') zeros at both ends.
- frame count for ``L`` samples: ``T = ceil((L' - window_length) / shift) + 1``
  with ``L' = L + 2 * fade_pad`` (end-padded when ``pad=True``).
- event alignment: onset sample ``s`` -> frame ``floor(s / shift)``, offset
  sample ``s`` -> frame ``ceil(s / shift)``; frame-grid timestamps are
  ``t * shift / sample_rate`` (self-consistent with evaluation timestamps).

Time warping (reference ``TimeWarpedSTFT``): a random anchor ``a`` of the
clip is moved by a random shift; frames gather their samples at
piecewise-linearly warped positions. The warp parameters are sampled on the
host (so host-side label alignment uses the same warp) and shipped as two
scalars per example; the warped framing itself runs on device.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _window(name, length):
    n = np.arange(length)
    if name == 'blackman':
        # periodic blackman (matches paderbox symmetric_window=False)
        w = (0.42 - 0.5 * np.cos(2 * np.pi * n / length)
             + 0.08 * np.cos(4 * np.pi * n / length))
    elif name == 'hann':
        w = 0.5 - 0.5 * np.cos(2 * np.pi * n / length)
    elif name == 'hamming':
        w = 0.54 - 0.46 * np.cos(2 * np.pi * n / length)
    elif name in (None, 'boxcar', 'rect'):
        w = np.ones(length)
    else:
        raise ValueError(f'Unknown window {name}')
    return w.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class STFT:
    """STFT geometry + device kernels. Frozen so it can be a jit static arg."""
    shift: int = 320
    window_length: int = 960
    size: int = 1024
    fading: str = 'half'
    pad: bool = True
    window: str = 'blackman'

    def __post_init__(self):
        assert self.size >= self.window_length, (self.size, self.window_length)
        assert self.fading in (None, 'none', 'half', 'full'), self.fading

    # ------------------------------------------------------------------
    # geometry (host-side helpers, also used for label alignment)
    # ------------------------------------------------------------------
    @property
    def fade_pad(self):
        if self.fading == 'full':
            return self.window_length - self.shift
        if self.fading == 'half':
            return (self.window_length - self.shift) // 2
        return 0

    @property
    def num_bins(self):
        return self.size // 2 + 1

    def num_frames(self, num_samples):
        """Frames produced for a signal of ``num_samples`` samples."""
        num_samples = np.asarray(num_samples)
        padded = num_samples + 2 * self.fade_pad
        if self.pad:
            frames = np.ceil(
                np.maximum(padded - self.window_length, 0) / self.shift
            ).astype(np.int64) + 1
        else:
            frames = (padded - self.window_length) // self.shift + 1
        return frames if frames.ndim else int(frames)

    def num_samples_for_frames(self, num_frames):
        """Smallest sample count whose clip yields >= num_frames frames."""
        return (
            (num_frames - 1) * self.shift + self.window_length
            - 2 * self.fade_pad
        )

    def sample_to_onset_frame(self, sample):
        return np.floor_divide(np.asarray(sample), self.shift)

    def sample_to_offset_frame(self, sample):
        return -(-np.asarray(sample) // self.shift)

    def frame_timestamps(self, num_frames, sample_rate):
        """Score-grid timestamps: num_frames+1 boundaries in seconds."""
        return np.arange(num_frames + 1) * self.shift / sample_rate

    # ------------------------------------------------------------------
    # device kernels
    # ------------------------------------------------------------------
    def _padded_length(self, num_samples):
        t = self.num_frames(num_samples)
        return self.window_length + (t - 1) * self.shift

    def frame(self, audio):
        """(B, S) -> (B, T, window_length) frames (static shapes)."""
        b, s = audio.shape
        total = self._padded_length(s)
        pad_front = self.fade_pad
        pad_back = total - s - pad_front
        x = jnp.pad(audio, ((0, 0), (pad_front, max(pad_back, 0))))
        if pad_back < 0:
            x = x[:, :total]
        t = self.num_frames(s)
        if self.window_length % self.shift == 0:
            # strided framing via shifted slices: no gather, XLA-friendly
            k = self.window_length // self.shift
            nblocks = x.shape[1] // self.shift
            blocks = x[:, :nblocks * self.shift].reshape(
                b, nblocks, self.shift)
            parts = [blocks[:, i:i + t] for i in range(k)]
            frames = jnp.concatenate(parts, axis=-1)
        else:
            starts = (
                jnp.arange(t)[:, None] * self.shift
                + jnp.arange(self.window_length)[None, :]
            )
            frames = x[:, starts]
        return frames

    def frame_warped(self, audio, warp_anchor_out, warp_anchor_in, valid_len):
        """Warped framing: per-example piecewise-linear time warp.

        Args:
            audio: (B, S) waveforms (zero padded).
            warp_anchor_out: (B,) anchor position on the *output* time axis
                (samples).
            warp_anchor_in: (B,) position on the *input* axis the anchor is
                read from (samples).
            valid_len: (B,) valid samples per example.

        Returns: (B, T, window_length) frames.
        """
        b, s = audio.shape
        t = self.num_frames(s)
        pad_front = self.fade_pad
        total = self._padded_length(s)
        x = jnp.pad(audio, ((0, 0), (pad_front, max(total - s - pad_front, 0))))
        u = jnp.arange(t, dtype=jnp.float32)[None, :] * self.shift  # output pos
        a_out = warp_anchor_out[:, None].astype(jnp.float32)
        a_in = warp_anchor_in[:, None].astype(jnp.float32)
        length = valid_len[:, None].astype(jnp.float32)
        lo = u * a_in / jnp.maximum(a_out, 1.)
        hi = a_in + (u - a_out) * (length - a_in) / jnp.maximum(
            length - a_out, 1.)
        src = jnp.where(u < a_out, lo, hi)
        # src is a start index into the fade-padded buffer (content
        # coordinates); clip so the window always fits
        src = jnp.clip(src, 0., x.shape[1] - self.window_length)
        starts = src.astype(jnp.int32)  # (B, T)
        idx = starts[:, :, None] + jnp.arange(self.window_length)[None, None, :]
        idx = jnp.clip(idx, 0, x.shape[1] - 1)
        return jnp.take_along_axis(x[:, None, :], idx, axis=-1)

    @partial(jax.jit, static_argnums=0)
    def magnitude(self, audio):
        """(B, S) -> (B, T, F) magnitude spectrogram."""
        frames = self.frame(audio)
        return self._frames_to_magnitude(frames)

    def _frames_to_magnitude(self, frames):
        # rfft, not a windowed real-DFT matmul: on an H100 at bs=32,
        # 10 s clips, size 1024 the FFT takes 0.127 ms against 0.175 ms
        # for the bf16 DFT matmul (PERF.md, STFT backend)
        win = jnp.asarray(_window(self.window, self.window_length))
        spec = jnp.fft.rfft(frames * win, n=self.size, axis=-1)
        return jnp.abs(spec).astype(jnp.float32)

    def magnitude_warped(self, audio, warp_anchor_out, warp_anchor_in,
                         valid_len):
        frames = self.frame_warped(
            audio, warp_anchor_out, warp_anchor_in, valid_len)
        return self._frames_to_magnitude(frames)

    def complex_stft(self, audio):
        """(B, S) -> (B, T, F, 2) real/imag (reference tensor layout)."""
        frames = self.frame(audio)
        win = jnp.asarray(_window(self.window, self.window_length))
        spec = jnp.fft.rfft(frames * win, n=self.size, axis=-1)
        return jnp.stack([spec.real, spec.imag], axis=-1).astype(jnp.float32)


def sample_time_warp(valid_len, anchor_sampling_fn, shift_sampling_fn):
    """Host-side sampling of per-example warp parameters (the single
    implementation — ``data/transform.py`` consumes it, so host target
    alignment and device framing can never drift apart).

    Reference: anchor ~ U(0.4, 0.6) of the clip, shift ~ U(-0.1, 0.1) of
    the clip (``provider.py:329-338``). Returns (anchor_out, anchor_in)
    in samples, both clipped into [1, valid_len - 1].
    """
    anchor = float(anchor_sampling_fn()) * valid_len
    delta = float(shift_sampling_fn()) * valid_len
    anchor_out = float(np.clip(anchor, 1., valid_len - 1.))
    anchor_in = float(np.clip(anchor + delta, 1., valid_len - 1.))
    return anchor_out, anchor_in


def warp_sample_position(s, anchor_out, anchor_in, valid_len):
    """Map input sample positions to output positions under the warp.

    Inverse of the framing map in :meth:`STFT.frame_warped`; used on the
    host to co-warp event sample times before frame conversion.
    """
    s = np.asarray(s, dtype=np.float64)
    lo = s * anchor_out / max(anchor_in, 1.)
    hi = anchor_out + (s - anchor_in) * (valid_len - anchor_out) / max(
        valid_len - anchor_in, 1.)
    return np.where(s < anchor_in, lo, hi)
