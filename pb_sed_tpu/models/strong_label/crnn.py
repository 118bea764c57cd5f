"""BiCRNN: bidirectional CRNN for strong-label SED, optionally
tag-conditioned.

Capability parity with ``pb_sed/models/strong_label/crnn.py:13-262``:
single bidirectional GRU head; optional tag conditioning where the weak-tag
vector is injected both as extra CNN input channels (``conditional_dims``)
and concatenated to the RNN input features; strong-target BCE with
soft-label (0.5) masking; review buffers of ``eval_segment_length``
max-pooled frame scores; ``tagging`` = max over time, SED = masked frame
scores.

One jitted graph from waveform to frame scores; the bidirectional
recurrence runs as one scan over both directions (see ops/rnn.py);
segment pooling for summary buffers happens on device via reshape+max.
"""

import jax
import jax.numpy as jnp
import numpy as np

from pb_sed_tpu import nn
from pb_sed_tpu.models.base.model import SoundEventModel
from pb_sed_tpu.ops.cnn import CNN
from pb_sed_tpu.ops.features import NormalizedLogMelExtractor
from pb_sed_tpu.ops.masking import compute_mask, masked_max, masked_mean
from pb_sed_tpu.ops.rnn import GRU


class BiCRNNModule(nn.Module):
    feature_extractor: NormalizedLogMelExtractor
    cnn: CNN
    rnn: GRU
    tag_conditioning: bool = False

    def features(self, batch, training=False):
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

    def __call__(self, batch, training=False):
        """Returns (y (B, K, T), seq_len_y, x, seq_len_x)."""
        x, seq_len_x = self.features(batch, training=training)
        condition = batch.get('tag_condition') if self.tag_conditioning \
            else None
        h, seq_len_h = self.cnn(
            x, seq_len_x, condition=condition, training=training)
        if self.tag_conditioning and condition is not None:
            b, t, c = h.shape
            cond = jnp.broadcast_to(
                condition[:, None, :], (b, t, condition.shape[-1]))
            h = jnp.concatenate([h, cond], axis=-1)
        y, seq_len_y = self.rnn(h, seq_len_h, training=training)
        y = jnp.swapaxes(jax.nn.sigmoid(y), 1, 2)  # (B, K, T)
        return y, seq_len_y, x, seq_len_x

    def tagging(self, batch, training=False):
        y, seq_len_y, *_ = self(batch, training=training)
        return (masked_max(y, seq_len_y, axis=-1, keepdims=True),
                jnp.ones_like(seq_len_y))

    def boundaries_detection(self, batch, training=False):
        return self.sound_event_detection(batch, training=training)

    def sound_event_detection(self, batch, training=False):
        y, seq_len_y, *_ = self(batch, training=training)
        mask = compute_mask(y, seq_len_y, sequence_axis=-1)
        return y * mask, seq_len_y


class CRNN(SoundEventModel):
    """BiCRNN wrapper: loss, inference API, config glue."""

    def __init__(self, feature_extractor, cnn, rnn, *,
                 tag_conditioning=False, labelwise_metrics=(),
                 label_mapping=None, test_labels=None,
                 eval_segment_length=1):
        super().__init__(
            labelwise_metrics=labelwise_metrics,
            label_mapping=label_mapping, test_labels=test_labels)
        self.module = BiCRNNModule(
            feature_extractor=feature_extractor, cnn=cnn, rnn=rnn,
            tag_conditioning=tag_conditioning)
        self.tag_conditioning = tag_conditioning
        self.eval_segment_length = eval_segment_length

    # ------------------------------------------------------------------
    def loss_fn(self, variables, batch, rngs, training=True):
        """Strong-target BCE with soft-label masking
        (reference ``strong_label/crnn.py:95-112``): frames whose target is
        in (.01, .99) are "unknown" and masked; the loss is the masked sum
        over valid frames normalized by the number of certain entries.
        """
        outputs, mutated = self.module.apply(
            variables, batch, training=training,
            rngs=rngs, mutable=['batch_stats'] if training else [],
        )
        y, seq_len_y, x, _ = outputs
        strong_targets = batch['strong_targets']  # (B, K, T)
        st_mask = ((strong_targets > .99) | (strong_targets < .01)).astype(
            y.dtype)
        frame_mask = compute_mask(y, seq_len_y, sequence_axis=-1)
        st_mask = st_mask * frame_mask
        y_c = jnp.clip(y, 1e-7, 1. - 1e-7)
        bce = -(strong_targets * jnp.log(y_c)
                + (1. - strong_targets) * jnp.log(1. - y_c)) * st_mask
        loss = bce.sum() / jnp.maximum(st_mask.sum(), 1.)

        fully_labeled = (
            masked_mean(st_mask, seq_len_y, axis=-1) > .999).all(-1)  # (B,)
        scalars = {
            'seq_len': batch['seq_len'].mean(),
            'strong_label_rate': st_mask.mean(),
        }
        # segment-pooled frame scores for buffered metrics (device-side
        # reshape+max over eval_segment_length blocks)
        seg = int(self.eval_segment_length)
        b, k, t = y.shape
        n_seg = t // seg if seg > 1 else t
        if seg > 1:
            y_seg = y[..., :n_seg * seg].reshape(b, k, n_seg, seg).max(-1)
            t_seg = strong_targets[..., :n_seg * seg].reshape(
                b, k, n_seg, seg).max(-1)
        else:
            y_seg, t_seg = y, strong_targets
        seg_valid = (
            jnp.arange(n_seg)[None, :]
            < (seq_len_y[:, None] + seg - 1) // seg)  # (B, n_seg)
        buffers = {
            'y_strong': jnp.swapaxes(y_seg, 1, 2),        # (B, n_seg, K)
            'targets_strong': jnp.swapaxes(t_seg, 1, 2),
            'segment_mask': seg_valid & fully_labeled[:, None],
        }
        images = {'features': x[:3] if x.ndim == 3 else x[:3, ..., 0],
                  'strong_targets': strong_targets[:3]}
        return loss, (mutated, scalars, buffers, images)

    def review_from_aux(self, loss, aux):
        mutated, scalars, buffers, images = aux
        seg_mask = np.asarray(buffers['segment_mask']).reshape(-1)
        y = np.asarray(buffers['y_strong'])
        t = np.asarray(buffers['targets_strong'])
        y = y.reshape(-1, y.shape[-1])[seg_mask]
        t = t.reshape(-1, t.shape[-1])[seg_mask]
        return {
            'loss': float(loss),
            'scalars': {k: float(np.asarray(v)) for k, v in scalars.items()},
            'images': {k: np.asarray(v) for k, v in images.items()},
            'buffers': {'y_strong': y, 'targets_strong': t},
        }

    def modify_summary(self, summary):
        if 'targets_strong' in summary.get('buffers', {}):
            self.add_metrics_to_summary(summary, 'strong')
        return super().modify_summary(summary)

    # ------------------------------------------------------------------
    def tagging(self, batch, **params):
        y, seq_len = self._apply(batch, method=BiCRNNModule.tagging)
        return np.asarray(y), np.asarray(seq_len)

    def boundaries_detection(self, batch, **params):
        return self.sound_event_detection(batch, **params)

    def sound_event_detection(self, batch, **params):
        y, seq_len = self._apply(
            batch, method=BiCRNNModule.sound_event_detection)
        return np.asarray(y), np.asarray(seq_len)

    def dispatch(self, method, batch, **params):
        """Async inference (see ``SoundEventModel.dispatch``)."""
        if method == 'tagging':
            return self._apply(batch, method=BiCRNNModule.tagging)
        if method in ('boundaries_detection', 'sound_event_detection'):
            return self._apply(
                batch, method=BiCRNNModule.sound_event_detection)
        return super().dispatch(method, batch, **params)

    # ------------------------------------------------------------------
    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['feature_extractor'] = {'factory': NormalizedLogMelExtractor}
        config['cnn'] = {'factory': CNN}
        config['rnn'] = {'factory': GRU}
        num_filters = config['feature_extractor']['number_of_filters']
        config['cnn']['input_height'] = num_filters
        num_events = config['rnn']['output_net']['out_channels'][-1]
        if config['tag_conditioning']:
            config['cnn']['conditional_dims'] = num_events
        rnn_cfg = config['rnn'].get('rnn')
        if rnn_cfg is not None:
            rnn_cfg.update({
                'num_layers': 1, 'bias': True, 'dropout': 0.,
                'bidirectional': True,
            })
            input_size = config['cnn']['cnn_1d']['out_channels'][-1]
            if config['tag_conditioning']:
                input_size += num_events
            rnn_cfg['input_size'] = input_size


# tuning wrappers (reference strong_label/crnn.py:213-262)
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
        stepfilt_lengths, minimize=False, tag_masking=True,
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
        medfilt_lengths, minimize=False, tag_masking='?',
        storage_dir=None, device=None):
    from pb_sed_tpu.models import base
    print('\nSound Event Detection Tuning')
    detection_scores = base.sound_event_detection(
        crnns, dataset, timestamps=timestamps, event_classes=event_classes)
    return base.tune_sound_event_detection(
        detection_scores, medfilt_lengths, tags, metrics=metrics,
        minimize=minimize, tag_masking=tag_masking, storage_dir=storage_dir)
