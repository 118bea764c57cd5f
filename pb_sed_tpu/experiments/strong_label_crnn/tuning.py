"""BiCRNN hyper-parameter tuning experiment.

Capability parity with ``pb_sed/experiments/strong_label_crnn/tuning.py``:
needs BOTH the weak-label hyper-params dir (for the tagging ensemble) and
the strong-label model group; runs weak-ensemble tagging to obtain tags,
maps ``tag_condition`` per batch, tunes medfilt x tag-masking against
collar-F1 / PSDS1-AUC / PSDS2-AUC, writes
``sed_hyper_params_{f,psds1,psds2}.json`` with derived per-class
thresholds, symlinks into model dirs and auto-chains evaluation.
"""
import os
from functools import partial
from pathlib import Path

import numpy as np

from pb_sed_tpu.data.provider import DataProvider
from pb_sed_tpu.evaluation import collar_based
from pb_sed_tpu.experiments.core import (
    Experiment, FileStorageObserver, print_config)
from pb_sed_tpu.experiments.weak_label_crnn.inference import tagging
from pb_sed_tpu.experiments.weak_label_crnn.tuning import (
    ground_truth_from_json)
from pb_sed_tpu.models import base, strong_label, weak_label
from pb_sed_tpu.models.strong_label import crnn as strong_label_crnn
from pb_sed_tpu.paths import storage_root
from pb_sed_tpu.train.emissions import EmissionsTracker
from pb_sed_tpu.utils.config import load_run_config
from pb_sed_tpu.utils.misc import dump_json, timestamp

ex_name = 'strong_label_crnn_hyper_params'
ex = Experiment(ex_name)


@ex.config
def config(cfg):
    cfg['debug'] = False
    debug = cfg['debug']
    cfg['timestamp'] = timestamp() + ('_debug' if debug else '')

    cfg['weak_label_crnn_hyper_params_dir'] = ''
    assert len(cfg['weak_label_crnn_hyper_params_dir']) > 0, \
        'Set weak_label_crnn_hyper_params_dir on the command line.'
    weak_tuning_config = load_run_config(
        Path(cfg['weak_label_crnn_hyper_params_dir']) / '1'
        / 'config.json')
    cfg['weak_label_crnn_dirs'] = weak_tuning_config['crnn_dirs']
    cfg['weak_label_crnn_checkpoints'] = \
        weak_tuning_config['crnn_checkpoints']

    cfg['strong_label_crnn_group_dir'] = ''
    group_dir = cfg['strong_label_crnn_group_dir']
    if 'strong_label_crnn_dirs' not in cfg:
        if isinstance(group_dir, list):
            dirs = [d for g in group_dir for d in Path(g).glob('202*')
                    if d.is_dir()]
        else:
            dirs = [d for d in Path(group_dir).glob('202*') if d.is_dir()]
        cfg.force('strong_label_crnn_dirs', sorted(str(d) for d in dirs))
    assert len(cfg['strong_label_crnn_dirs']) > 0
    cfg['strong_label_crnn_checkpoints'] = \
        'ckpt_best_macro_fscore_strong.pkl'
    strong_config = load_run_config(
        Path(cfg['strong_label_crnn_dirs'][0]) / '1' / 'config.json')
    cfg['data_provider'] = strong_config['data_provider']
    cfg['database_name'] = strong_config.get('database_name', 'desed')
    cfg['storage_dir'] = str(
        storage_root / 'strong_label_crnn' / cfg['database_name']
        / 'hyper_params' / cfg['timestamp'])
    cfg['data_provider']['min_audio_length'] = .01
    cfg['data_provider']['cached_datasets'] = None

    cfg['device'] = None
    cfg['validation_set_name'] = 'validation'
    cfg['validation_ground_truth_filepath'] = None
    cfg['eval_set_name'] = 'eval_public'
    cfg['eval_ground_truth_filepath'] = None
    cfg['medfilt_lengths'] = [31] if debug else \
        [301, 251, 201, 151, 101, 81, 61, 51, 41, 31, 21, 11]
    ex.observers.append(FileStorageObserver.create(cfg['storage_dir']))


@ex.automain
def main(_config, storage_dir, debug, weak_label_crnn_hyper_params_dir,
         weak_label_crnn_dirs, weak_label_crnn_checkpoints,
         strong_label_crnn_dirs, strong_label_crnn_checkpoints,
         data_provider, validation_set_name,
         validation_ground_truth_filepath, eval_set_name,
         eval_ground_truth_filepath, medfilt_lengths, device):
    print('\n##### Tuning #####\n')
    print_config(_config)
    print(storage_dir)
    storage_dir = Path(storage_dir)
    storage_dir.mkdir(parents=True, exist_ok=True)
    emissions_tracker = EmissionsTracker(output_dir=storage_dir)
    emissions_tracker.start()

    if not isinstance(weak_label_crnn_checkpoints, list):
        weak_label_crnn_checkpoints = \
            len(weak_label_crnn_dirs) * [weak_label_crnn_checkpoints]
    weak_label_crnns = [
        weak_label.CRNN.from_storage_dir(
            storage_dir=crnn_dir, config_name='1/config.json',
            checkpoint_name=ckpt)
        for crnn_dir, ckpt in zip(
            weak_label_crnn_dirs, weak_label_crnn_checkpoints)
    ]
    data_provider = DataProvider.from_config(data_provider)
    data_provider.test_transform.label_encoder.initialize_labels()
    inverse = data_provider.test_transform.label_encoder.\
        inverse_label_mapping
    event_classes = [inverse[i] for i in range(len(inverse))]
    frame_shift = (data_provider.test_transform.stft.shift
                   / data_provider.audio_reader.target_sample_rate)

    dataset = data_provider.get_dataset(validation_set_name)
    gt_events, gt_tags, audio_durations = ground_truth_from_json(
        data_provider, validation_set_name)
    if validation_ground_truth_filepath is not None:
        events_ground_truth = validation_ground_truth_filepath
    else:
        events_ground_truth = gt_events

    tags, tagging_scores, _ = tagging(
        weak_label_crnns, dataset, None, event_classes,
        weak_label_crnn_hyper_params_dir, None, None)

    collar_based_params = {
        'onset_collar': .2, 'offset_collar': .2,
        'offset_collar_rate': .2,
    }
    psds_scenario_1 = {
        'dtc_threshold': 0.7, 'gtc_threshold': 0.7,
        'cttc_threshold': None, 'alpha_ct': .0, 'alpha_st': 1.,
    }
    psds_scenario_2 = {
        'dtc_threshold': 0.1, 'gtc_threshold': 0.1,
        'cttc_threshold': 0.3, 'alpha_ct': .5, 'alpha_st': 1.,
    }
    metrics = {
        'f': partial(
            base.f_collar, ground_truth=events_ground_truth,
            return_onset_offset_bias=True, num_jobs=8,
            **collar_based_params),
        'auc1': partial(
            base.psd_auc, ground_truth=events_ground_truth,
            audio_durations=audio_durations, num_jobs=8,
            **psds_scenario_1),
        'auc2': partial(
            base.psd_auc, ground_truth=events_ground_truth,
            audio_durations=audio_durations, num_jobs=8,
            **psds_scenario_2),
    }

    if not isinstance(strong_label_crnn_checkpoints, list):
        strong_label_crnn_checkpoints = \
            len(strong_label_crnn_dirs) * [strong_label_crnn_checkpoints]
    strong_label_crnns = [
        strong_label.CRNN.from_storage_dir(
            storage_dir=crnn_dir, config_name='1/config.json',
            checkpoint_name=ckpt)
        for crnn_dir, ckpt in zip(
            strong_label_crnn_dirs, strong_label_crnn_checkpoints)
    ]

    def add_tag_condition(batch):
        batch['tag_condition'] = np.array([
            tags[example_id] for example_id in batch['example_id']
        ]).astype(np.float32)
        return batch

    timestamps = np.arange(0, 10000) * frame_shift
    leaderboard = strong_label_crnn.tune_sound_event_detection(
        strong_label_crnns, dataset.map(add_tag_condition), timestamps,
        event_classes, tags, metrics,
        tag_masking={'f': True, 'auc1': '?', 'auc2': '?'},
        medfilt_lengths=medfilt_lengths)
    dump_json(leaderboard['f'][1], storage_dir / 'sed_hyper_params_f.json')
    for auc_name, out_name in (('auc1', 'psds1'), ('auc2', 'psds2')):
        f, p, r, thresholds, _ = collar_based.best_fscore(
            leaderboard[auc_name][2], events_ground_truth,
            **collar_based_params, num_jobs=8)
        for event_class in thresholds:
            leaderboard[auc_name][1][event_class]['threshold'] = \
                thresholds[event_class]
        dump_json(leaderboard[auc_name][1],
                  storage_dir / f'sed_hyper_params_{out_name}.json')
    for crnn_dir in strong_label_crnn_dirs:
        tuning_dir = Path(crnn_dir) / 'hyper_params'
        os.makedirs(str(tuning_dir), exist_ok=True)
        link = tuning_dir / storage_dir.name
        if not link.exists():
            link.symlink_to(storage_dir)
    emissions_tracker.stop()
    print(storage_dir)

    if eval_set_name:
        from pb_sed_tpu.experiments.strong_label_crnn.inference import (
            ex as evaluation)
        evaluation.run(config_updates={
            'debug': debug,
            'strong_label_crnn_hyper_params_dir': str(storage_dir),
            'dataset_name': eval_set_name,
            'ground_truth_filepath': eval_ground_truth_filepath,
        })
    return str(storage_dir)
