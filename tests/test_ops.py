"""Tests for device ops: STFT geometry, mel filterbank, masking, filters."""
import numpy as np
import pytest

from pb_sed_tpu.ops.stft import STFT, warp_sample_position
from pb_sed_tpu.ops import filters as F
from pb_sed_tpu.ops import mel as M


def test_stft_geometry():
    stft = STFT()  # shift=320, window=960, size=1024, fading='half'
    assert stft.fade_pad == 320
    # 10 s @ 16 kHz
    t = stft.num_frames(160000)
    assert t == 500
    assert stft.num_frames(np.array([160000, 16000])).tolist() == [500, 50]
    assert stft.num_bins == 513
    # inverse geometry
    assert stft.num_frames(stft.num_samples_for_frames(t)) == t
    ts = stft.frame_timestamps(t, 16000)
    assert len(ts) == t + 1
    assert ts[1] == pytest.approx(0.02)


def test_stft_magnitude_shapes_and_strided_vs_gather():
    import jax.numpy as jnp
    stft = STFT()
    rng = np.random.RandomState(0)
    audio = rng.randn(2, 16000).astype(np.float32)
    mag = np.asarray(stft.magnitude(jnp.asarray(audio)))
    assert mag.shape == (2, stft.num_frames(16000), 513)
    assert np.isfinite(mag).all()
    # strided framing must equal gather framing
    stft_g = STFT(shift=300, window_length=960)  # 960 % 300 != 0 -> gather
    frames_gather = np.asarray(stft_g.frame(jnp.asarray(audio)))
    assert frames_gather.shape[-1] == 960
    # cross-check strided path against explicit numpy framing
    frames = np.asarray(stft.frame(jnp.asarray(audio)))
    padded = np.pad(audio, ((0, 0), (320, 960 + 320)))
    for t in [0, 1, 17]:
        np.testing.assert_allclose(
            frames[:, t], padded[:, t * 320:t * 320 + 960], rtol=0, atol=0)


@pytest.mark.parametrize('window', ['blackman', 'hann'])
def test_stft_magnitude_matches_numpy_rfft(window):
    """|rfft| of the windowed frames, against numpy's FFT in float64."""
    import jax.numpy as jnp
    from pb_sed_tpu.ops.stft import _window
    rng = np.random.RandomState(3)
    audio = (rng.randn(2, 16000) * np.hanning(16000)).astype(np.float32)
    stft = STFT(window=window)
    got = np.asarray(stft.magnitude(jnp.asarray(audio)))
    frames = np.asarray(stft.frame(jnp.asarray(audio)), np.float64)
    ref = np.abs(np.fft.rfft(
        frames * _window(window, 960).astype(np.float64), n=1024, axis=-1))
    assert got.shape == ref.shape == (2, 50, 513)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * ref.max())


def test_stft_identity_warp_matches_unwarped():
    import jax.numpy as jnp
    stft = STFT()
    rng = np.random.RandomState(1)
    audio = rng.randn(2, 16000).astype(np.float32)
    n = 16000
    warped = np.asarray(stft.frame_warped(
        jnp.asarray(audio),
        jnp.asarray([n / 2., n / 2.]), jnp.asarray([n / 2., n / 2.]),
        jnp.asarray([float(n), float(n)]),
    ))
    plain = np.asarray(stft.frame(jnp.asarray(audio)))
    assert plain.shape == warped.shape
    # identity warp reproduces the plain framing exactly
    np.testing.assert_allclose(warped, plain, atol=0)


def test_warp_sample_position_roundtrip():
    # event positions co-move with the frame warp
    n = 16000.
    a_out, a_in = 8000., 8800.
    s = np.array([0., 4400., 8800., 12000., 16000.])
    u = warp_sample_position(s, a_out, a_in, n)
    assert u[0] == 0.
    assert u[2] == pytest.approx(8000.)
    assert u[-1] == pytest.approx(16000.)
    assert np.all(np.diff(u) > 0)


def test_mel_filterbank():
    import jax.numpy as jnp
    fb = np.asarray(M.mel_filterbank(128, 16000, 1024))
    assert fb.shape == (513, 128)
    assert (fb >= 0).all() and (fb <= 1).all()
    # every filter has some support
    assert (fb.sum(0) > 0).all()
    # warped filterbank with alpha=1 equals static
    wfb = np.asarray(M.warped_mel_filterbank(
        jnp.ones(3), jnp.full(3, 0.5), 128, 16000, 1024))
    assert wfb.shape == (3, 513, 128)
    np.testing.assert_allclose(wfb[0], fb, atol=1e-5)
    # warped with alpha != 1 differs
    wfb2 = np.asarray(M.warped_mel_filterbank(
        jnp.asarray([1.2]), jnp.asarray([0.5]), 128, 16000, 1024))
    assert np.abs(wfb2[0] - fb).max() > 0.1


def test_masking_ops():
    import jax.numpy as jnp
    from pb_sed_tpu.ops import masking as mk
    x = jnp.asarray(np.arange(24, dtype=np.float32).reshape(2, 3, 4))
    seq_len = jnp.asarray([4, 2])
    m = np.asarray(mk.compute_mask(x, seq_len, sequence_axis=-1))
    assert m.shape == (2, 1, 4)
    assert m[1, 0].tolist() == [1, 1, 0, 0]
    mean = np.asarray(mk.masked_mean(x, seq_len, axis=-1))
    np.testing.assert_allclose(mean[0, 0], np.mean([0, 1, 2, 3]))
    np.testing.assert_allclose(mean[1, 0], np.mean([12, 13]))
    last = np.asarray(mk.take_last(x, seq_len, axis=-1))
    assert last[0, 0] == 3 and last[1, 0] == 13
    mx = np.asarray(mk.masked_max(-x, seq_len, axis=-1))
    assert mx[1, 0] == -12
    rev = np.asarray(mk.reverse_sequence(x, seq_len, axis=-1))
    assert rev[0, 0].tolist() == [3, 2, 1, 0]
    assert rev[1, 0, :2].tolist() == [13, 12]


@pytest.mark.parametrize('axis', [1, 2])
def test_reverse_sequence_matches_numpy_and_vjp(axis):
    """Masked reversal against a numpy loop (padding stays at the end,
    untouched) and its VJP against the gradient of the same numpy
    permutation."""
    import jax
    import jax.numpy as jnp
    from pb_sed_tpu.ops import masking as mk
    rng = np.random.RandomState(5)
    x = rng.randn(3, 17, 17, 5).astype(np.float32)
    seq_len = np.array([17, 9, 1])
    ref = x.copy()
    for b, n in enumerate(seq_len):
        idx = [slice(None)] * 3
        idx[axis - 1] = slice(0, n)
        src = np.take(x[b], np.arange(n)[::-1], axis=axis - 1)
        ref[b][tuple(idx)] = src
    got = np.asarray(mk.reverse_sequence(jnp.asarray(x), seq_len, axis))
    for b, n in enumerate(seq_len):
        valid = np.take(got[b], np.arange(n), axis=axis - 1)
        np.testing.assert_array_equal(
            valid, np.take(ref[b], np.arange(n), axis=axis - 1))
    w = rng.randn(*x.shape).astype(np.float32)
    grad = np.asarray(jax.grad(lambda v: jnp.sum(
        mk.reverse_sequence(v, seq_len, axis) * w))(jnp.asarray(x)))
    # the op is a symmetric permutation: d/dx sum(P(x) * w) = P(w)
    np.testing.assert_array_equal(
        grad, np.asarray(mk.reverse_sequence(jnp.asarray(w), seq_len,
                                             axis)))
    # and P is an involution
    twice = mk.reverse_sequence(
        mk.reverse_sequence(jnp.asarray(x), seq_len, axis), seq_len, axis)
    np.testing.assert_array_equal(np.asarray(twice), x)


def test_filters_match_scipy_reference_semantics():
    from scipy import signal
    rng = np.random.RandomState(0)
    x = rng.rand(2, 5, 30)
    # medfilt vs scipy per-row
    got = F.medfilt(x, 5, axis=-1)
    want = np.apply_along_axis(
        lambda m: signal.medfilt(m, 5), -1, x)
    np.testing.assert_allclose(got, want)
    assert F.medfilt(x, 1, axis=-1) is not None
    # meanfilt vs np.correlate 'same'
    got = F.meanfilt(x, 3, axis=1)
    want = np.apply_along_axis(
        lambda m: np.correlate(m, np.ones(3) / 3, mode='same'), 1, x)
    np.testing.assert_allclose(got, want, atol=1e-12)
    # even-length meanfilt matches np.correlate 'same' centering
    got = F.meanfilt(x, 4, axis=-1)
    want = np.apply_along_axis(
        lambda m: np.correlate(m, np.ones(4) / 4, mode='same'), -1, x)
    np.testing.assert_allclose(got, want, atol=1e-12)
    # maxfilt
    got = F.maxfilt(x, 3, axis=1)
    assert got.shape == x.shape
    np.testing.assert_allclose(got[:, 1, :],
                               np.max(x[:, 0:3, :], axis=1))
    # stepfilt: reference kernel/padding semantics
    n = 4
    kernel = np.concatenate((-np.ones(n // 2), np.ones(n // 2))) / (n // 2)
    xp = np.pad(x, ((0, 0), (0, 0), (n // 2, n // 2 - 1)))
    want = np.apply_along_axis(
        lambda m: np.correlate(m, kernel, mode='valid'), -1, xp)
    got = F.stepfilt(x, n, axis=-1)
    np.testing.assert_allclose(got, want, atol=1e-12)
    assert got.shape == x.shape


def test_boundariesfilt():
    x = np.zeros((1, 1, 12))
    x[0, 0, 4:8] = 1.0
    out = F.boundariesfilt(x, 4, axis=-1)
    assert out.shape == x.shape
    # the span interior should score high, edges low
    assert out[0, 0, 5] > out[0, 0, 0]
    assert out[0, 0, 5] > out[0, 0, 11]


def test_jax_filters_match_numpy():
    import jax.numpy as jnp
    rng = np.random.RandomState(2)
    x = rng.rand(2, 3, 21)
    for n in [1, 3, 5]:
        np.testing.assert_allclose(
            np.asarray(F.medfilt_jax(jnp.asarray(x), n)),
            F.medfilt(x, n), atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(F.maxfilt_jax(jnp.asarray(x), n)),
            F.maxfilt(x, n), atol=1e-6)
    for n in [2, 4, 6]:
        np.testing.assert_allclose(
            np.asarray(F.stepfilt_jax(jnp.asarray(x), n)),
            F.stepfilt(x, n), atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(F.boundariesfilt_jax(jnp.asarray(x), n)),
            F.boundariesfilt(x, n), atol=1e-6)
