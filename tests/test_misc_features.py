"""Coverage for remaining capability surface: Transformer head, SLAT,
label smoothing, class weights, audio segmenter, host sharding, CLI
parsing, profiling timers, emissions tracker, trace intervals."""
import numpy as np
import pytest

from pb_sed_tpu.data import lazy
from pb_sed_tpu.data.segment import AudioSegmenter
from pb_sed_tpu.experiments.core import (
    ConfigDict, Experiment, parse_cli_overrides)
from pb_sed_tpu.models import weak_label
from pb_sed_tpu.utils.profiling import Timer


def tiny_batch(num_events=3, b=2, t=9):
    rng = np.random.RandomState(0)
    batch = {
        'stft': np.abs(rng.randn(b, t, 257, 2)).astype(np.float32),
        'seq_len': np.full(b, t, np.int32),
        'weak_targets': np.zeros((b, num_events), np.float32),
        'boundary_targets': np.zeros((b, num_events, t), np.float32),
    }
    batch['weak_targets'][0, 1] = 1.
    batch['boundary_targets'][0, 1, 2:5] = 1.
    return batch


def test_transformer_fbcrnn():
    from pb_sed_tpu.ops.rnn import TransformerEncoder
    config = weak_label.CRNN.get_config({
        'feature_extractor': {
            'sample_rate': 16000, 'stft_size': 512,
            'number_of_filters': 16,
        },
        'cnn': {
            'cnn_2d': {'out_channels': [4, 4],
                       'pool_size': [[2, 1], [2, 1]], 'kernel_size': 3},
            'cnn_1d': {'out_channels': [8, 8], 'kernel_size': 3},
        },
        'rnn_fwd': {
            'factory': TransformerEncoder,
            'rnn': {'hidden_size': 8, 'd_ff': 16, 'num_layers': 2,
                    'dropout': 0., 'num_heads': 2},
            'output_net': {'out_channels': [8, 3], 'kernel_size': 1},
        },
    })
    assert config['rnn_bwd']['factory'] == TransformerEncoder
    assert config['rnn_bwd']['reverse'] is True
    model = weak_label.CRNN.from_config(config)
    batch = tiny_batch()
    model.init_variables(batch, seed=0)
    import jax
    rngs = {'augment': jax.random.PRNGKey(0),
            'dropout': jax.random.PRNGKey(1)}
    loss, aux = model.loss_fn(model.variables, batch, rngs, training=True)
    assert np.isfinite(float(loss))
    y, seq_len = model.tagging(batch)
    assert y.shape == (2, 3, 1)
    # causal fwd head: changing future frames must not change y_fwd[:, :, 0]
    import jax.numpy as jnp
    out1 = model._apply(batch)
    b2 = dict(batch)
    b2['stft'] = batch['stft'].copy()
    b2['stft'][:, -1] += 1.0
    out2 = model._apply(b2)
    np.testing.assert_allclose(
        np.asarray(out1[0])[:, :, 0], np.asarray(out2[0])[:, :, 0],
        atol=1e-5)


def test_slat_and_label_smoothing_and_class_weights():
    config = weak_label.CRNN.get_config({
        'slat': True,
        'label_smoothing': 0.05,
        'class_weights': [1., 2., 0.5],
        'feature_extractor': {
            'sample_rate': 16000, 'stft_size': 512,
            'number_of_filters': 16},
        'cnn': {'cnn_2d': {'out_channels': [4], 'kernel_size': 3},
                'cnn_1d': {'out_channels': [8], 'kernel_size': 3}},
        'rnn_fwd': {'rnn': {'hidden_size': 8, 'num_layers': 1},
                    'output_net': {'out_channels': [8, 3],
                                   'kernel_size': 1}},
    })
    model = weak_label.CRNN.from_config(config)
    batch = tiny_batch()
    batch.pop('boundary_targets')  # slat derives them from weak targets
    model.init_variables(batch, seed=0)
    import jax
    rngs = {'augment': jax.random.PRNGKey(0),
            'dropout': jax.random.PRNGKey(1)}
    loss, aux = model.loss_fn(model.variables, batch, rngs, training=True)
    assert np.isfinite(float(loss)) and float(loss) > 0


def test_fwd_only_fbcrnn():
    config = weak_label.CRNN.get_config({
        'rnn_bwd': None,
        'feature_extractor': {
            'sample_rate': 16000, 'stft_size': 512,
            'number_of_filters': 16},
        'cnn': {'cnn_2d': {'out_channels': [4], 'kernel_size': 3},
                'cnn_1d': {'out_channels': [8], 'kernel_size': 3}},
        'rnn_fwd': {'rnn': {'hidden_size': 8, 'num_layers': 1},
                    'output_net': {'out_channels': [8, 3],
                                   'kernel_size': 1}},
    })
    model = weak_label.CRNN.from_config(config)
    batch = tiny_batch()
    model.init_variables(batch, seed=0)
    import jax
    rngs = {'augment': jax.random.PRNGKey(0),
            'dropout': jax.random.PRNGKey(1)}
    loss, _ = model.loss_fn(model.variables, batch, rngs, training=True)
    assert np.isfinite(float(loss))
    y, seq_len = model.tagging(batch)
    assert y.shape == (2, 3, 1)


def test_audio_segmenter():
    seg = AudioSegmenter(length=100, shift=80)
    example = {
        'example_id': 'x', 'dataset': 'd',
        'audio_data': np.arange(250, dtype=np.float32)[None, :],
        'seq_len': 250,
        'events': ['a', 'b'],
        'events_start_samples': [10, 180],
        'events_stop_samples': [50, 240],
        'label_types': ['strong', 'strong'],
    }
    segments = seg(example)
    assert len(segments) == 3
    assert segments[0]['example_id'] == 'x_!segment!_0_3'
    assert segments[0]['events'] == ['a']
    assert segments[0]['events_start_samples'] == [10]
    # event b spans segments 2 and 3 with clipped boundaries
    assert 'b' in segments[2]['events']
    s2 = segments[2]
    i = s2['events'].index('b')
    assert s2['events_start_samples'][i] == 180 - 160
    # short example passes through
    short = {'example_id': 'y', 'audio_data': np.zeros((1, 50)),
             'seq_len': 50}
    assert seg(short) == [short]


def test_shard_dataset():
    ds = lazy.from_list(list(range(10)))
    s0 = lazy.ShardDataset(ds, 3, 0)
    s1 = lazy.ShardDataset(ds, 3, 1)
    s2 = lazy.ShardDataset(ds, 3, 2)
    assert list(s0) == [0, 3, 6, 9]
    assert list(s1) == [1, 4, 7]
    assert list(s2) == [2, 5, 8]
    assert len(s0) == 4 and len(s1) == 3
    assert s0[1] == 3
    # fetcher integration
    from pb_sed_tpu.data.fetcher import DataFetcher
    examples = [{'example_id': str(i), 'dataset': 'd',
                 'audio_data': np.zeros(100, np.float32),
                 'seq_len': 5, 'seq_len_samples': 100,
                 'weak_targets': np.zeros(2, np.float32)}
                for i in range(8)]
    fetcher = DataFetcher(prefetch_workers=0, batch_size=2,
                          pad_to_multiple=8, num_shards=2, shard_index=1)
    batches = list(fetcher(lazy.from_list(examples)))
    ids = [i for b in batches for i in b['example_id']]
    assert ids == ['1', '3', '5', '7']


def test_cli_override_parsing():
    updates = parse_cli_overrides(
        ['with', 'batch_size=8', 'data_provider.train_set.train_weak=2',
         'debug=True', 'name=hello', 'lr=5e-4'])
    assert updates['batch_size'] == 8
    assert updates['data_provider']['train_set']['train_weak'] == 2
    assert updates['debug'] is True
    assert updates['name'] == 'hello'
    assert updates['lr'] == 5e-4


def test_experiment_config_derivation():
    ex = Experiment('test')

    @ex.config
    def config(cfg):
        cfg['batch_size'] = 32
        cfg['iterations'] = 1000 * 16 // cfg['batch_size']

    @ex.main
    def main(batch_size, iterations):
        return batch_size, iterations

    assert ex.run() == (32, 500)
    # override propagates into derived values
    assert ex.run(config_updates={'batch_size': 8}) == (8, 2000)


def test_timer_and_emissions(tmp_path):
    timer = Timer()
    with timer('stage'):
        pass
    with timer('stage'):
        pass
    assert timer.summary()['stage']['count'] == 2
    from pb_sed_tpu.train.emissions import EmissionsTracker
    tracker = EmissionsTracker(output_dir=tmp_path)
    tracker.start()
    kg = tracker.stop()
    assert kg is not None and kg >= 0
    assert (tmp_path / 'emissions.csv').exists()


def test_merge_segments_short_clip_keeps_tail():
    """Regression: a clip ending INSIDE a non-final segment used to lose
    its trailing ceil(overlap/2) frames to the interior-edge trim; the
    merge is now content-aware. Values encode global frame indices."""
    import numpy as np
    from pb_sed_tpu.utils.segment import merge_segments

    def arr(start, stop):
        return np.arange(start, stop, dtype=float)[:, None]  # (T, 1)

    out = {
        'A_!segment!_0_2': arr(0, 100),   # full first segment
        'A_!segment!_1_2': arr(80, 150),  # 70 frames (clip len 150)
        'B_!segment!_0_2': arr(0, 90),    # clip len 90 ends in seg 0
        'B_!segment!_1_2': arr(80, 90),   # 10 leftover overlap frames
        'C': arr(0, 7),                   # unsegmented passthrough
    }
    merged = merge_segments(out, segment_overlap=20)
    np.testing.assert_array_equal(merged['A'][:, 0], np.arange(150))
    np.testing.assert_array_equal(merged['B'][:, 0], np.arange(90))
    np.testing.assert_array_equal(merged['C'][:, 0], np.arange(7))

    # pooled (tagging) scores merge by max
    pooled = {
        'A_!segment!_0_2': np.array([[0.2, 0.9]]),
        'A_!segment!_1_2': np.array([[0.7, 0.1]]),
    }
    merged = merge_segments(pooled, segment_overlap=20)
    np.testing.assert_allclose(merged['A'], [[0.7, 0.9]])


def test_xplane_gaps_in_span():
    """Pure interval logic of the device-idle reduction
    (utils/xplane.py:union_ns): the holes of a span not covered by
    kernel intervals, with overlapping and out-of-order input."""
    from pb_sed_tpu.utils.xplane import union_ns

    span = (0, 100)
    ivs = [(10, 30), (20, 40), (55, 60), (90, 95)]  # overlap + holes
    gaps = [(0, 10), (40, 55), (60, 90), (95, 100)]
    covered = union_ns(ivs)
    assert covered == 40
    assert (span[1] - span[0]) - covered == sum(b - a for a, b in gaps)
    # fully covered span -> no gaps
    assert union_ns([(0, 50), (10, 40)]) == 50
    # empty coverage -> the whole span is one gap
    assert union_ns([]) == 0
