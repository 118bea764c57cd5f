"""BiCRNN ensemble inference / evaluation / pseudo-labeling experiment.

Capability parity with ``pb_sed/experiments/strong_label_crnn/inference.py``:
two-stage ensemble inference — weak ensemble tagging -> tags ->
tag-conditioned strong ensemble SED; PSDS1/2 + collar F1 + approximate
PSDS evaluation; optional batch segmentation with 100-frame overlap;
strong pseudo-label export to a database json copy AND a
``<dataset>_pseudo_labeled.tsv`` (the artifact the reference ships for
self-training rounds).
"""
import os
from copy import deepcopy
from pathlib import Path

import numpy as np

from pb_sed_tpu.data.provider import DataProvider
from pb_sed_tpu.evaluation import collar_based, intersection_based
from pb_sed_tpu.evaluation.intersection_based import staircase_auc
from pb_sed_tpu.evaluation.scores import (
    scores_to_event_list, write_detection,
    write_detections_for_multiple_thresholds)
from pb_sed_tpu.experiments.core import (
    Experiment, FileStorageObserver, print_config)
from pb_sed_tpu.experiments.weak_label_crnn.inference import (
    ground_truth_for, tagging)
from pb_sed_tpu.models import base, strong_label, weak_label
from pb_sed_tpu.paths import storage_root
from pb_sed_tpu.train.emissions import EmissionsTracker
from pb_sed_tpu.utils.config import load_run_config
from pb_sed_tpu.utils.misc import dump_json, load_json, timestamp

ex_name = 'strong_label_crnn_inference'
ex = Experiment(ex_name)


@ex.config
def config(cfg):
    cfg['debug'] = False
    cfg['timestamp'] = timestamp() + ('_debug' if cfg['debug'] else '')
    cfg['strong_label_crnn_hyper_params_dir'] = ''
    assert len(cfg['strong_label_crnn_hyper_params_dir']) > 0, \
        'Set strong_label_crnn_hyper_params_dir on the command line.'
    tuning_config = load_run_config(
        Path(cfg['strong_label_crnn_hyper_params_dir']) / '1'
        / 'config.json')
    cfg['weak_label_crnn_hyper_params_dir'] = \
        tuning_config['weak_label_crnn_hyper_params_dir']
    cfg['weak_label_crnn_dirs'] = tuning_config['weak_label_crnn_dirs']
    cfg['weak_label_crnn_checkpoints'] = \
        tuning_config['weak_label_crnn_checkpoints']
    cfg['strong_label_crnn_dirs'] = \
        tuning_config['strong_label_crnn_dirs']
    cfg['strong_label_crnn_checkpoints'] = \
        tuning_config['strong_label_crnn_checkpoints']
    cfg['data_provider'] = tuning_config['data_provider']
    cfg['database_name'] = tuning_config.get('database_name', 'desed')
    cfg['storage_dir'] = str(
        storage_root / 'strong_label_crnn' / cfg['database_name']
        / 'inference' / cfg['timestamp'])
    cfg['sed_hyper_params_name'] = ['f', 'psds1']
    cfg['device'] = None
    cfg['dataset_name'] = 'eval_public'
    cfg['ground_truth_filepath'] = None
    cfg['max_segment_length'] = None
    cfg['segment_overlap'] = 100
    cfg['save_scores'] = False
    cfg['save_detections'] = False
    cfg['strong_pseudo_labeling'] = False
    cfg['pseudo_labeled_dataset_name'] = cfg['dataset_name']
    cfg['pseudo_widening'] = .0
    ex.observers.append(FileStorageObserver.create(cfg['storage_dir']))


def sound_event_detection(strong_label_crnns, dataset, timestamps,
                          event_classes, tags, hyper_params_dir,
                          hyper_params_name, ground_truth,
                          audio_durations, collar_based_params=(),
                          psds_params=(), max_segment_length=None,
                          segment_overlap=None, pseudo_widening=.0,
                          score_storage_dir=None,
                          detection_storage_dir=None):
    """Strong-model SED with per-paramset medfilt/tag-mask arrays
    (no window grid — frame scores come straight from the BiCRNN)."""
    print('\nSound Event Detection')
    if isinstance(hyper_params_name, (str, Path)):
        hyper_params_name = [hyper_params_name]
    hyper_params = [
        load_json(Path(hyper_params_dir) / f'sed_hyper_params_{name}.json')
        for name in hyper_params_name
    ]
    if isinstance(score_storage_dir, (str, Path)):
        score_storage_dir = [
            Path(score_storage_dir) / name for name in hyper_params_name]
    if isinstance(detection_storage_dir, (str, Path)):
        detection_storage_dir = [
            Path(detection_storage_dir) / name
            for name in hyper_params_name]
    n_sets = len(hyper_params)
    k = len(event_classes)
    medfilt_lengths = np.zeros((n_sets, k), dtype=int)
    tag_masked = np.zeros((n_sets, k), dtype=bool)
    for i, hp in enumerate(hyper_params):
        for j, event_class in enumerate(event_classes):
            medfilt_lengths[i, j] = hp[event_class]['medfilt_length']
            tag_masked[i, j] = hp[event_class]['tag_masked']
    detection_scores = base.sound_event_detection(
        strong_label_crnns, dataset,
        medfilt_length=medfilt_lengths, apply_mask=tag_masked,
        masks=tags, timestamps=timestamps, event_classes=event_classes,
        max_segment_length=max_segment_length,
        segment_overlap=segment_overlap, merge_score_segments=True,
        score_storage_dir=score_storage_dir)
    event_detections = []
    results = []
    has_gt = ground_truth is not None and len(ground_truth)
    for i, name in enumerate(hyper_params_name):
        results.append({})
        scores_i = detection_scores[i]
        if detection_storage_dir and detection_storage_dir[i]:
            write_detections_for_multiple_thresholds(
                scores_i, thresholds=np.linspace(.01, .99, 50),
                dir_path=detection_storage_dir[i])
        if 'threshold' in hyper_params[i][event_classes[0]]:
            thresholds = {
                event_class: hyper_params[i][event_class]['threshold']
                for event_class in event_classes
            }
            events = scores_to_event_list(
                scores_i, thresholds, event_classes=event_classes)
            if detection_storage_dir and detection_storage_dir[i]:
                write_detection(
                    scores_i, thresholds,
                    Path(detection_storage_dir[i]) / 'cbf.tsv')
            if has_gt and collar_based_params:
                f, p, r, stats = collar_based.fscore(
                    scores_i, ground_truth, thresholds,
                    **collar_based_params,
                    return_onset_offset_dist_sum=True, num_jobs=8)
                print('f', f)
                for key in f:
                    results[-1].update({
                        f'{key}_f': f[key], f'{key}_p': p[key],
                        f'{key}_r': r[key]})
                    if key in stats:
                        results[-1][f'{key}_onset_bias'] = (
                            stats[key]['onset_dist_sum']
                            / max(stats[key]['tps'], 1))
                        results[-1][f'{key}_offset_bias'] = (
                            stats[key]['offset_dist_sum']
                            / max(stats[key]['tps'], 1))
            for clip_id in events:
                corrected = []
                for onset, offset, event_label in events[clip_id]:
                    onset = max(
                        onset - pseudo_widening
                        - hyper_params[i][event_label].get(
                            'onset_bias', 0), 0)
                    offset = (offset + pseudo_widening
                              - hyper_params[i][event_label].get(
                                  'offset_bias', 0))
                    if offset > onset:
                        corrected.append((onset, offset, event_label))
                events[clip_id] = corrected
            event_detections.append(events)
        else:
            event_detections.append(None)
        if has_gt:
            if not isinstance(psds_params, (tuple, list)):
                psds_params = [psds_params]
            for j, params in enumerate(psds_params):
                psds_value, _, classwise = intersection_based.psds(
                    scores_i, ground_truth, audio_durations, **params,
                    num_jobs=8)
                print(f'psds[{j}]', psds_value)
                results[-1][f'psds[{j}]'] = psds_value
                for event_class, (tpr, efpr, *_) in classwise.items():
                    results[-1][f'{event_class}_auc[{j}]'] = \
                        staircase_auc(
                            tpr, efpr, params.get('max_efpr', 100))
                approx, _, _ = intersection_based.approximate_psds(
                    scores_i, ground_truth, audio_durations, **params,
                    thresholds=np.linspace(.01, .99, 50))
                print(f'approx_psds[{j}]', approx)
                results[-1][f'approx_psds[{j}]'] = approx
    return event_detections, results


@ex.automain
def main(_config, storage_dir, strong_label_crnn_hyper_params_dir,
         sed_hyper_params_name, weak_label_crnn_hyper_params_dir,
         weak_label_crnn_dirs, weak_label_crnn_checkpoints,
         strong_label_crnn_dirs, strong_label_crnn_checkpoints, device,
         data_provider, dataset_name, ground_truth_filepath, save_scores,
         save_detections, max_segment_length, segment_overlap,
         strong_pseudo_labeling, pseudo_widening,
         pseudo_labeled_dataset_name):
    print('\n##### Inference #####\n')
    print_config(_config)
    print(storage_dir)
    storage_dir = Path(storage_dir)
    storage_dir.mkdir(parents=True, exist_ok=True)
    emissions_tracker = EmissionsTracker(output_dir=storage_dir)
    emissions_tracker.start()

    collar_based_params = {
        'onset_collar': .2, 'offset_collar': .2, 'offset_collar_rate': .2}
    psds_scenario_1 = {
        'dtc_threshold': 0.7, 'gtc_threshold': 0.7,
        'cttc_threshold': None, 'alpha_ct': .0, 'alpha_st': 1.}
    psds_scenario_2 = {
        'dtc_threshold': 0.1, 'gtc_threshold': 0.1,
        'cttc_threshold': 0.3, 'alpha_ct': .5, 'alpha_st': 1.}

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
    data_provider = DataProvider.from_config(data_provider)
    data_provider.test_transform.label_encoder.initialize_labels()
    inverse = data_provider.test_transform.label_encoder.\
        inverse_label_mapping
    event_classes = [inverse[i] for i in range(len(inverse))]
    frame_shift = (data_provider.test_transform.stft.shift
                   / data_provider.audio_reader.target_sample_rate)

    if not isinstance(dataset_name, list):
        dataset_name = [dataset_name]
    def listify(x):
        return x if isinstance(x, list) else len(dataset_name) * [x]
    ground_truth_filepath = listify(ground_truth_filepath)
    strong_pseudo_labeling = listify(strong_pseudo_labeling)
    pseudo_labeled_dataset_name = listify(pseudo_labeled_dataset_name)

    database = deepcopy(data_provider.db.data)
    for i, ds_name in enumerate(dataset_name):
        print(f'\n{ds_name}')
        dataset = data_provider.get_dataset(ds_name)
        gt_events, gt_tags, audio_durations = ground_truth_for(
            data_provider, ds_name, ground_truth_filepath[i])
        score_storage_dir = storage_dir / 'scores' / ds_name
        detection_storage_dir = storage_dir / 'detections' / ds_name

        tags, tagging_scores, _ = tagging(
            weak_label_crnns, dataset, None, event_classes,
            weak_label_crnn_hyper_params_dir, None, None,
            max_segment_length=max_segment_length,
            segment_overlap=segment_overlap)

        def add_tag_condition(batch):
            batch = dict(batch)
            batch['tag_condition'] = np.array([
                tags[example_id.split('_!segment!_')[0]]
                for example_id in batch['example_id']
            ]).astype(np.float32)
            return batch

        conditioned = dataset.map(add_tag_condition)
        timestamps = np.round(
            np.arange(0, 100000) * frame_shift, decimals=6)
        sed_names = (sed_hyper_params_name
                     if isinstance(sed_hyper_params_name, (list, tuple))
                     else [sed_hyper_params_name])
        events, sed_results = sound_event_detection(
            strong_label_crnns, conditioned, timestamps, event_classes,
            tags, strong_label_crnn_hyper_params_dir, sed_names,
            gt_events, audio_durations, collar_based_params,
            [psds_scenario_1, psds_scenario_2],
            max_segment_length=max_segment_length,
            segment_overlap=segment_overlap,
            pseudo_widening=pseudo_widening,
            score_storage_dir=[
                score_storage_dir / name for name in sed_names]
            if save_scores else None,
            detection_storage_dir=[
                detection_storage_dir / name for name in sed_names]
            if save_detections else None)
        for j, sed_results_j in enumerate(sed_results):
            if sed_results_j:
                dump_json(sed_results_j,
                          storage_dir
                          / f'sed_{sed_names[j]}_results_{ds_name}.json')
        if strong_pseudo_labeling[i] and events[0] is not None:
            database['datasets'][pseudo_labeled_dataset_name[i]] = \
                base.pseudo_label(
                    database['datasets'][ds_name], event_classes,
                    False, False, True, None, None, events[0])
            with (storage_dir
                  / f'{ds_name}_pseudo_labeled.tsv').open('w') as fid:
                fid.write('filename\tonset\toffset\tevent_label\n')
                for key, event_list in events[0].items():
                    if len(event_list) == 0:
                        fid.write(f'{key}.wav\t\t\t\n')
                    for t_on, t_off, event_label in event_list:
                        fid.write(f'{key}.wav\t{t_on}\t{t_off}\t'
                                  f'{event_label}\n')

    if any(strong_pseudo_labeling):
        dump_json(database,
                  storage_dir / Path(data_provider.json_path).name)
    inference_dir = Path(strong_label_crnn_hyper_params_dir) / 'inference'
    os.makedirs(str(inference_dir), exist_ok=True)
    link = inference_dir / storage_dir.name
    if not link.exists():
        link.symlink_to(storage_dir)
    emissions_tracker.stop()
    print(storage_dir)
    return str(storage_dir)
