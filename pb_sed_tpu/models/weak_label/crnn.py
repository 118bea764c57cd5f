"""FBCRNN: forward-backward CRNN for weak-label sound event detection.

Capability parity with ``pb_sed/models/weak_label/crnn.py:14-421``:
shared log-mel front-end + hybrid CNN, *two* GRU heads (forward and
time-reversed backward), bounded sigmoid scores, weak-BCE on
``max(y_fwd, y_bwd)``, strong fwd-bwd BCE against cummax-expanded boundary
targets, soft-label (0.5) masking, SLAT mode, label smoothing, class
weights; inference methods ``tagging`` (fwd-last + bwd-first),
``boundaries_detection`` (min of heads), and sliding-window
``sound_event_detection`` with per-class / per-paramset window lengths.

The whole forward (waveform -> STFT -> mel -> CNN -> GRU heads) is one
jitted graph; sliding-window SED folds the window axis into the batch
axis so the GRU heads run as one big batched recurrence ((B*n_windows)
rows per gate matmul); all losses are mask-driven over padded
batches. Scores are returned time-last (B, K, T), matching the reference's
downstream contract.
"""
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pb_sed_tpu import nn
from pb_sed_tpu.models.base.model import SoundEventModel
from pb_sed_tpu.ops.cnn import CNN
from pb_sed_tpu.ops.features import NormalizedLogMelExtractor
from pb_sed_tpu.ops.masking import compute_mask, masked_mean, take_last
from pb_sed_tpu.ops.rnn import GRU


class FBCRNNModule(nn.Module):
    """The computation graph of the FBCRNN."""
    feature_extractor: NormalizedLogMelExtractor
    cnn: CNN
    rnn_fwd: GRU
    rnn_bwd: Optional[GRU]
    minimum_score: float = 1e-5

    def _bounded_sigmoid(self, logits):
        return self.minimum_score + (
            1. - 2. * self.minimum_score) * jax.nn.sigmoid(logits)

    def features(self, batch, training=False):
        """Resolve input format: device STFT from audio, or shipped stft."""
        seq_len = batch['seq_len']
        if 'audio_data' in batch:
            warp = None
            if training and 'warp_anchor_out' in batch:
                warp = (batch['warp_anchor_out'], batch['warp_anchor_in'],
                        batch['seq_len_samples'])
            x = self.feature_extractor(
                batch['audio_data'], seq_len, training=training,
                warp_params=warp)
        else:
            x = self.feature_extractor(
                batch['stft'], seq_len, training=training)
        return x, seq_len

    def encode(self, batch, training=False):
        x, seq_len = self.features(batch, training=training)
        h, seq_len_h = self.cnn(x, seq_len, training=training)
        return h, seq_len_h, x, seq_len

    def __call__(self, batch, training=False):
        """Returns (y_fwd, y_bwd, seq_len_y, x, seq_len_x); y are (B, K, T)."""
        h, seq_len_h, x, seq_len_x = self.encode(batch, training=training)
        y_fwd, seq_len_y = self.rnn_fwd(h, seq_len_h, training=training)
        y_fwd = jnp.swapaxes(self._bounded_sigmoid(y_fwd), 1, 2)
        if self.rnn_bwd is None:
            y_bwd = None
        else:
            y_bwd, _ = self.rnn_bwd(h, seq_len_h, training=training)
            y_bwd = jnp.swapaxes(self._bounded_sigmoid(y_bwd), 1, 2)
        return y_fwd, y_bwd, seq_len_y, x, seq_len_x

    # -- inference methods --------------------------------------------
    def tagging(self, batch, training=False):
        """Clip tags: mean of fwd head's last and bwd head's first frame."""
        y_fwd, y_bwd, seq_len_y, *_ = self(batch, training=training)
        y = take_last(y_fwd, seq_len_y, axis=-1, keepdims=True)
        if y_bwd is not None:
            y = (y + y_bwd[..., :1]) / 2
        return y, jnp.ones_like(seq_len_y)

    def boundaries_detection(self, batch, training=False):
        y_fwd, y_bwd, seq_len_y, *_ = self(batch, training=training)
        mask = compute_mask(y_fwd, seq_len_y, sequence_axis=-1)
        return jnp.minimum(y_fwd * mask, y_bwd * mask), seq_len_y

    def sed_windows(self, batch, window_length: int, window_shift: int = 1,
                    training=False):
        """Sliding-window SED for one window length.

        Every output frame is the clip-level tag prediction of a short
        window of the CNN embedding centered on it; windows are folded into
        the batch axis so both GRU heads run once over (B * n) sequences.
        """
        h, seq_len, *_ = self.encode(batch, training=training)
        b, t, c = h.shape
        wl, ws = int(window_length), int(window_shift)
        pad_front = (wl - ws) // 2 if wl > ws else 0
        n = -(-t // ws)  # ceil
        pad_back = (n - 1) * ws + wl - pad_front - t
        hp = jnp.pad(h, ((0, 0), (pad_front, max(pad_back, 0)), (0, 0)))
        # window extraction as wl STATIC strided slices instead of an
        # (n, wl) advanced-index gather: windows[:, i, j] = hp[:, i*ws+j]
        # so slicing over j gives hp[:, j : j+n*ws : ws] — slices+stack
        # lower to plain copies, a gather to an index computation per
        # element
        windows = jnp.stack(
            [hp[:, j:j + n * ws:ws] for j in range(wl)],
            axis=2)  # (B, n, wl, C)
        windows = windows.reshape(b * n, wl, c)
        y_fwd, _ = self.rnn_fwd(windows, None, training=training)
        y = self._bounded_sigmoid(y_fwd[:, -1])  # (B*n, K)
        if self.rnn_bwd is not None:
            y_bwd, _ = self.rnn_bwd(windows, None, training=training)
            y = (y + self._bounded_sigmoid(y_bwd[:, 0])) / 2
        k = y.shape[-1]
        y = y.reshape(b, n, k)
        y = jnp.swapaxes(y, 1, 2)  # (B, K, n)
        seq_len_y = 1 + (seq_len - 1) // ws
        return y, seq_len_y


def multi_window_sed(run_window, window_length, materialize=True):
    """Combine per-window-length SED runs under scalar / per-class (K,)
    / per-paramset (N, K) window lengths (the reference's array-valued
    window semantics, ``weak_label/crnn.py:241-302``).

    Args:
        run_window: ``win_len -> (y (B, K, T), seq_len)`` — a single
            fixed-window SED evaluation (member or stacked ensemble).
        window_length: scalar / (K,) / (N, K) ints.
        materialize: with a SCALAR window length, ``False`` returns the
            device arrays as dispatched (async) so the caller can
            overlap host post-processing with device compute (the
            ``dispatch`` inference lane). Array-valued windows combine
            on the host and always return numpy.
    """
    window_length = np.array(window_length, dtype=int)
    if window_length.ndim == 0:
        y, seq_len = run_window(int(window_length))
        if not materialize:
            return y, seq_len
        return np.asarray(y), np.asarray(seq_len)
    uniq = np.unique(window_length.flatten())
    y_out = None
    seq_len_y = None
    for win_len in uniq:
        yi, seq_len_y = run_window(int(win_len))
        yi = np.asarray(yi)
        b, k, t = yi.shape
        wl = window_length
        if wl.ndim == 1:
            assert wl.shape[0] in (1, k), wl.shape
            wl = np.broadcast_to(wl, (k,))
            mask = (wl == win_len)[None, :, None]
        else:
            assert wl.ndim == 2 and wl.shape[1] in (1, k), wl.shape
            n = wl.shape[0]
            wl = np.broadcast_to(wl, (n, k))
            yi = yi[:, None]
            mask = (wl == win_len)[None, :, :, None]
        if y_out is None:
            shape = (b, *wl.shape, t) if wl.ndim == 2 else (b, k, t)
            y_out = np.zeros(shape, dtype=yi.dtype)
        y_out = y_out + mask * yi
    return y_out, np.asarray(seq_len_y)


class CRNN(SoundEventModel):
    """FBCRNN wrapper: losses, inference API, config glue."""

    def __init__(
            self, feature_extractor, cnn, rnn_fwd, rnn_bwd,
            *, minimum_score=1e-5, label_smoothing=0.,
            labelwise_metrics=(), label_mapping=None, test_labels=None,
            slat=False, strong_fwd_bwd_loss_weight=1., class_weights=None,
    ):
        super().__init__(
            labelwise_metrics=labelwise_metrics,
            label_mapping=label_mapping, test_labels=test_labels,
        )
        self.module = FBCRNNModule(
            feature_extractor=feature_extractor, cnn=cnn,
            rnn_fwd=rnn_fwd, rnn_bwd=rnn_bwd,
            minimum_score=minimum_score,
        )
        self.minimum_score = minimum_score
        self.label_smoothing = label_smoothing
        self.slat = slat
        self.strong_fwd_bwd_loss_weight = strong_fwd_bwd_loss_weight
        self.class_weights = (
            None if class_weights is None else np.asarray(class_weights))

    # ------------------------------------------------------------------
    # training loss (pure; used inside the jitted train step)
    # ------------------------------------------------------------------
    def loss_fn(self, variables, batch, rngs, training=True):
        """Returns (loss, aux) with aux = (mutated_vars, scalars, buffers).

        Loss semantics from the reference (``weak_label/crnn.py:107-206``):
        - weak targets in (.01, .99) are "soft" (unlabeled) and masked out;
        - weak loss: BCE(max(y_fwd, y_bwd), weak) broadcast over frames;
        - strong loss: BCE(y_fwd, cummax(boundary)) +
          BCE(y_bwd, reversed cummax), only for classes that are fully
          frame-labeled AND weakly positive, mixed in per class/example by
          ``strong_fwd_bwd_loss_weight``;
        - masked mean over frames, class-weighted mean over (B, K).
        """
        outputs, mutated = self.module.apply(
            variables, batch, training=training,
            rngs=rngs, mutable=['batch_stats'] if training else [],
        )
        y_fwd, y_bwd, seq_len_y, x, _ = outputs
        weak_targets = batch['weak_targets']  # (B, K)
        wt_mask = ((weak_targets < .01) | (weak_targets > .99)).astype(
            y_fwd.dtype)
        weak_targets = weak_targets * wt_mask

        loss = self._weak_fwd_bwd_loss(
            y_fwd, y_bwd, weak_targets, seq_len_y) * wt_mask[..., None]

        boundary_label_rate = jnp.zeros(())
        if self.strong_fwd_bwd_loss_weight > 0.:
            if self.slat:
                boundary_targets = jnp.broadcast_to(
                    weak_targets[..., None], y_fwd.shape)
            else:
                boundary_targets = batch['boundary_targets']
            bt_mask = ((boundary_targets > .99)
                       | (boundary_targets < .01)).astype(y_fwd.dtype)
            frame_mask = compute_mask(
                boundary_targets, seq_len_y, sequence_axis=-1)
            fully_labeled = (
                masked_mean(bt_mask, seq_len_y, axis=-1, keepdims=True)
                > .999).astype(y_fwd.dtype)
            bt_mask = bt_mask * fully_labeled * (
                weak_targets > .99)[..., None] * frame_mask
            boundary_label_rate = bt_mask.mean()
            strong_loss = self._strong_fwd_bwd_loss(
                y_fwd, y_bwd, boundary_targets)
            w = bt_mask * self.strong_fwd_bwd_loss_weight
            loss = w * strong_loss + (1. - w) * loss

        loss = masked_mean(loss, seq_len_y, axis=-1)  # (B, K)
        weights = wt_mask
        if self.class_weights is not None:
            weights = weights * jnp.asarray(self.class_weights)
        loss = (loss * weights).sum() / jnp.maximum(weights.sum(), 1.)

        # buffered clip-level scores for summary metrics
        labeled = (wt_mask == 1.).all(-1)  # (B,)
        y_weak = take_last(y_fwd, seq_len_y, axis=-1)
        if y_bwd is not None:
            y_weak = y_weak / 2 + y_bwd[..., 0] / 2
        scalars = {
            'seq_len': batch['seq_len'].mean(),
            'weak_label_rate': wt_mask.mean(),
            'boundary_label_rate': boundary_label_rate,
        }
        buffers = {
            'y_weak': y_weak,
            'targets_weak': weak_targets,
            'labeled_mask': labeled,
        }
        # with delta channels x is (B, T, M, C): image the base channel
        images = {'features': x[:3] if x.ndim == 3 else x[:3, ..., 0]}
        return loss, (mutated, scalars, buffers, images)

    def _clip_targets(self, targets):
        if self.label_smoothing > 0.:
            return jnp.clip(targets, self.label_smoothing,
                            1. - self.label_smoothing)
        return targets

    @staticmethod
    def _bce(y, t):
        y = jnp.clip(y, 1e-7, 1. - 1e-7)
        return -(t * jnp.log(y) + (1. - t) * jnp.log(1. - y))

    def _weak_fwd_bwd_loss(self, y_fwd, y_bwd, targets, seq_len):
        targets = self._clip_targets(targets)
        if y_bwd is None:
            y_weak = take_last(y_fwd, seq_len, axis=-1)
            return jnp.broadcast_to(
                self._bce(y_weak, targets)[..., None], y_fwd.shape)
        y_weak = jnp.maximum(y_fwd, y_bwd)
        return self._bce(y_weak, targets[..., None])

    def _strong_fwd_bwd_loss(self, y_fwd, y_bwd, targets):
        targets = self._clip_targets(targets)
        axis = targets.ndim - 1  # lax.cummax needs a non-negative axis
        t_fwd = jax.lax.cummax(targets, axis=axis)
        t_bwd = jnp.flip(
            jax.lax.cummax(jnp.flip(targets, -1), axis=axis), -1)
        loss = self._bce(y_fwd, t_fwd)
        if y_bwd is not None:
            loss = loss / 2 + self._bce(y_bwd, t_bwd) / 2
        return loss

    # ------------------------------------------------------------------
    # host-facing review (padertorch Model contract)
    # ------------------------------------------------------------------
    def review_from_aux(self, loss, aux):
        mutated, scalars, buffers, images = aux
        labeled = np.asarray(buffers['labeled_mask'])
        return {
            'loss': float(loss),
            'scalars': {k: float(np.asarray(v)) for k, v in scalars.items()},
            'images': {k: np.asarray(v) for k, v in images.items()},
            'buffers': {
                'y_weak': np.asarray(buffers['y_weak'])[labeled],
                'targets_weak': np.asarray(buffers['targets_weak'])[labeled],
            },
        }

    def modify_summary(self, summary):
        if 'targets_weak' in summary.get('buffers', {}):
            self.add_metrics_to_summary(summary, 'weak')
        return super().modify_summary(summary)

    # ------------------------------------------------------------------
    # inference API (each call is one jitted apply)
    # ------------------------------------------------------------------
    def tagging(self, batch, **params):
        y, seq_len = self._apply(batch, method=FBCRNNModule.tagging)
        return np.asarray(y), np.asarray(seq_len)

    def boundaries_detection(self, batch, **params):
        y, seq_len = self._apply(
            batch, method=FBCRNNModule.boundaries_detection)
        return np.asarray(y), np.asarray(seq_len)

    def sound_event_detection(self, batch, window_length, window_shift=1):
        """Supports scalar, per-class (K,) and per-paramset (N, K) window
        lengths (reference ``weak_label/crnn.py:241-302``)."""
        return multi_window_sed(
            lambda win_len: self._apply(
                batch, method=FBCRNNModule.sed_windows,
                window_length=win_len, window_shift=int(window_shift)),
            window_length)

    def dispatch(self, method, batch, **params):
        """Async inference (same values as the public methods, device
        arrays instead of numpy — see ``SoundEventModel.dispatch``)."""
        if method == 'tagging':
            return self._apply(batch, method=FBCRNNModule.tagging)
        if method == 'boundaries_detection':
            return self._apply(
                batch, method=FBCRNNModule.boundaries_detection)
        if method == 'sound_event_detection':
            ws = params.pop('window_shift', 1)
            return multi_window_sed(
                lambda win_len: self._apply(
                    batch, method=FBCRNNModule.sed_windows,
                    window_length=win_len, window_shift=int(ws)),
                params.pop('window_length'), materialize=False)
        return super().dispatch(method, batch, **params)

    # ------------------------------------------------------------------
    # config glue (reference crnn.py:304-340)
    # ------------------------------------------------------------------
    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['feature_extractor'] = {'factory': NormalizedLogMelExtractor}
        config['cnn'] = {'factory': CNN}
        config['rnn_fwd'] = {'factory': GRU}
        config['rnn_bwd'] = {}
        if config['rnn_bwd'] is not None:
            config['rnn_bwd'].update(config['rnn_fwd'].to_dict(),
                                     reverse=True)
            config['rnn_bwd']['reverse'] = True
        num_filters = config['feature_extractor']['number_of_filters']
        config['cnn']['input_height'] = num_filters
        rnn_cfg = config['rnn_fwd'].get('rnn')
        if rnn_cfg is not None:
            rnn_cfg['input_size'] = config['cnn']['cnn_1d'][
                'out_channels'][-1]


# ----------------------------------------------------------------------
# tuning wrappers (reference crnn.py:343-421); implemented in
# models/base/tuning.py and re-exported here for API parity
# ----------------------------------------------------------------------
def tune_tagging(crnns, dataset, timestamps, event_classes, metrics,
                 minimize=False, storage_dir=None, device=None):
    from pb_sed_tpu.models import base
    print('\nTagging Tuning')
    tagging_scores = base.tagging(
        crnns, dataset, timestamps=timestamps, event_classes=event_classes)
    return base.tune_tagging(
        tagging_scores, medfilt_length_candidates=[1], metrics=metrics,
        minimize=minimize, storage_dir=storage_dir)


def tune_boundary_detection(
        crnns, dataset, timestamps, event_classes, tags, metrics,
        stepfilt_lengths, minimize=False, tag_masking='?',
        storage_dir=None, device=None):
    from pb_sed_tpu.models import base
    print('\nBoundaries Detection Tuning')
    boundaries_scores = base.boundaries_detection(
        crnns, dataset, stepfilt_length=None, apply_mask=False, masks=tags,
        timestamps=timestamps, event_classes=event_classes)
    return base.tune_boundaries_detection(
        boundaries_scores, medfilt_length_candidates=[1],
        stepfilt_length_candidates=stepfilt_lengths, tags=tags,
        metrics=metrics, minimize=minimize, tag_masking=tag_masking,
        storage_dir=storage_dir)


def tune_sound_event_detection(
        crnns, dataset, timestamps, event_classes, tags, metrics,
        window_lengths, window_shift, medfilt_lengths,
        minimize=False, tag_masking='?', storage_dir=None, device=None):
    from pb_sed_tpu.models import base
    print('\nSound Event Detection Tuning')
    leaderboard = {}
    for win_len in window_lengths:
        print(f'\n### window_length={win_len} ###')
        detection_scores = base.sound_event_detection(
            crnns, dataset,
            model_kwargs={'window_length': win_len,
                          'window_shift': window_shift},
            timestamps=timestamps[::window_shift],
            event_classes=event_classes)
        lb = base.tune_sound_event_detection(
            detection_scores, medfilt_lengths, tags, metrics=metrics,
            minimize=minimize, tag_masking=tag_masking,
            storage_dir=storage_dir)
        for metric_name, (metric_values, hyper_params, scores) in lb.items():
            for event_class in event_classes:
                hyper_params[event_class]['window_length'] = win_len
                hyper_params[event_class]['window_shift'] = window_shift
            leaderboard = base.update_leaderboard(
                leaderboard, metric_name, metric_values, hyper_params,
                scores, minimize=minimize)
    print('\nbest overall:')
    for metric_name in metrics:
        print(f'\n{metric_name}:')
        print(leaderboard[metric_name][0])
    return leaderboard
