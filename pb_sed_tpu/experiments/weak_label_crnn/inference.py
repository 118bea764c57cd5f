"""FBCRNN ensemble inference / evaluation / pseudo-labeling experiment.

Capability parity with ``pb_sed/experiments/weak_label_crnn/inference.py``:
loads the tuned hyper-params dir (+ its persisted tuning config -> model
dirs); stage functions
- ``tagging``: clip F1 at tuned thresholds + PSDS of tag scores + approx
  PSDS; thresholds -> boolean tags,
- ``boundaries_detection``: per-class stepfilt + tag mask + collar F1 with
  onset/offset bias correction of the detected spans,
- ``sound_event_detection``: per-paramset (f / psds1 / psds2) window /
  medfilt / tag-mask arrays, score + detection storage, PSDS both
  scenarios + approximate PSDS + from-files verification, bias-corrected
  event lists;
main loop over datasets with optional weak / boundary / strong
pseudo-labeling written back into a copy of the database json.
"""
import os
from copy import deepcopy
from pathlib import Path

import numpy as np

from pb_sed_tpu.data.provider import DataProvider
from pb_sed_tpu.evaluation import clip_based, collar_based, \
    intersection_based
from pb_sed_tpu.evaluation.intersection_based import staircase_auc
from pb_sed_tpu.evaluation.scores import (
    scores_to_event_list, write_detection,
    write_detections_for_multiple_thresholds)
from pb_sed_tpu.experiments.core import (
    Experiment, FileStorageObserver, print_config)
from pb_sed_tpu.models import base
from pb_sed_tpu.models.weak_label import CRNN
from pb_sed_tpu.paths import storage_root
from pb_sed_tpu.train.emissions import EmissionsTracker
from pb_sed_tpu.utils.config import load_run_config
from pb_sed_tpu.utils.misc import dump_json, load_json, timestamp
from pb_sed_tpu.utils.segment import merge_segments

ex_name = 'weak_label_crnn_inference'
ex = Experiment(ex_name)


@ex.config
def config(cfg):
    cfg['debug'] = False
    cfg['timestamp'] = timestamp() + (
        '_debug' if cfg['debug'] else '')
    cfg['hyper_params_dir'] = ''
    assert len(cfg['hyper_params_dir']) > 0, \
        'Set hyper_params_dir on the command line.'
    tuning_config = load_run_config(
        Path(cfg['hyper_params_dir']) / '1' / 'config.json')
    cfg['crnn_dirs'] = tuning_config['crnn_dirs']
    cfg['crnn_checkpoints'] = tuning_config['crnn_checkpoints']
    cfg['data_provider'] = tuning_config['data_provider']
    cfg['database_name'] = tuning_config.get('database_name', 'desed')
    cfg['storage_dir'] = str(
        storage_root / 'weak_label_crnn' / cfg['database_name']
        / 'inference' / cfg['timestamp'])
    cfg['sed_hyper_params_name'] = ['f', 'psds1']
    cfg['device'] = None
    cfg['dataset_name'] = 'eval_public'
    cfg['ground_truth_filepath'] = None
    cfg['max_segment_length'] = None
    cfg['segment_overlap'] = 0
    cfg['save_scores'] = False
    cfg['save_detections'] = False
    cfg['weak_pseudo_labeling'] = False
    cfg['boundary_pseudo_labeling'] = False
    cfg['strong_pseudo_labeling'] = False
    cfg['pseudo_labeled_dataset_name'] = cfg['dataset_name']
    cfg['pseudo_widening'] = .0
    ex.observers.append(FileStorageObserver.create(cfg['storage_dir']))


def tagging(crnns, dataset, timestamps, event_classes, hyper_params_dir,
            ground_truth, audio_durations, psds_params=(),
            max_segment_length=None, segment_overlap=None):
    print('\nTagging')
    hyper_params = load_json(
        Path(hyper_params_dir) / 'tagging_hyper_params_f.json')
    thresholds = {
        event_class: hyper_params[event_class]['threshold']
        for event_class in hyper_params
    }
    tagging_scores = base.tagging(
        crnns, dataset, max_segment_length=max_segment_length,
        segment_overlap=segment_overlap, merge_score_segments=False)
    # clip-level scores: pooled segments merge by max (segment ids carry
    # the _!segment!_ suffix and every downstream consumer — tag masks,
    # pseudo-labeling — is keyed by CLIP id)
    merged = merge_segments(tagging_scores, segment_overlap=0)
    results = {}
    if ground_truth is not None and len(ground_truth):
        scores_df = base.scores_to_dataframes(
            merged, timestamps=timestamps, event_classes=event_classes)
        f, p, r, stats = clip_based.fscore(
            scores_df, ground_truth, thresholds, num_jobs=8)
        print('f', f)
        for key in f:
            results.update({f'{key}_f': f[key], f'{key}_p': p[key],
                            f'{key}_r': r[key]})
        for j, params in enumerate(psds_params):
            psds_value, _, classwise = intersection_based.psds(
                scores_df, ground_truth, audio_durations, **params,
                num_jobs=8)
            print(f'psds[{j}]', psds_value)
            results[f'psds[{j}]'] = psds_value
            for event_class, (tpr, efpr, *_) in classwise.items():
                results[f'{event_class}_auc[{j}]'] = staircase_auc(
                    tpr, efpr, params.get('max_efpr', 100))
            approx, _, classwise = intersection_based.approximate_psds(
                scores_df, ground_truth, audio_durations, **params,
                thresholds=np.linspace(.01, .99, 50))
            print(f'approx_psds[{j}]', approx)
            results[f'approx_psds[{j}]'] = approx
            for event_class, (tpr, efpr, *_) in classwise.items():
                results[f'{event_class}_approx_auc[{j}]'] = staircase_auc(
                    tpr, efpr, params.get('max_efpr', 100))
    thresholds_arr = np.array([
        thresholds[event_class] for event_class in event_classes])
    raw_scores = {
        audio_id: np.asarray(merged[audio_id])[0]
        for audio_id in merged
    }
    tags = {audio_id: raw_scores[audio_id] > thresholds_arr
            for audio_id in raw_scores}
    return tags, raw_scores, results


def boundaries_detection(crnns, dataset, timestamps, event_classes, tags,
                         hyper_params_dir, ground_truth,
                         collar_based_params, max_segment_length=None,
                         segment_overlap=None, pseudo_widening=.0):
    print('\nBoundaries Detection')
    hyper_params = load_json(
        Path(hyper_params_dir)
        / 'boundaries_detection_hyper_params_f.json')
    stepfilt_length = np.array([
        hyper_params[event_class]['stepfilt_length']
        for event_class in event_classes])
    thresholds = {
        event_class: hyper_params[event_class]['threshold']
        for event_class in event_classes
    }
    boundary_scores = base.boundaries_detection(
        crnns, dataset, stepfilt_length=stepfilt_length,
        apply_mask=True, masks=tags,
        max_segment_length=max_segment_length,
        segment_overlap=segment_overlap, merge_score_segments=True,
        timestamps=timestamps, event_classes=event_classes)
    results = {}
    if ground_truth is not None and len(ground_truth):
        boundary_ground_truth = base.boundaries_from_events(ground_truth)
        f, p, r, stats = collar_based.fscore(
            boundary_scores, boundary_ground_truth, thresholds,
            **collar_based_params, return_onset_offset_dist_sum=True,
            num_jobs=8)
        print('f', f)
        for key in f:
            results.update({f'{key}_f': f[key], f'{key}_p': p[key],
                            f'{key}_r': r[key]})
            if key in stats:
                results[f'{key}_onset_bias'] = (
                    stats[key]['onset_dist_sum']
                    / max(stats[key]['tps'], 1))
                results[f'{key}_offset_bias'] = (
                    stats[key]['offset_dist_sum']
                    / max(stats[key]['tps'], 1))
    detections = scores_to_event_list(
        boundary_scores, thresholds, event_classes=event_classes)
    for clip_id in detections:
        corrected = []
        for onset, offset, event_label in detections[clip_id]:
            onset = max(np.round(
                onset - pseudo_widening
                - hyper_params[event_label].get('onset_bias', 0), 3), 0)
            offset = np.round(
                offset + pseudo_widening
                - hyper_params[event_label].get('offset_bias', 0), 3)
            if offset > onset:
                corrected.append((onset, offset, event_label))
        detections[clip_id] = corrected
    return detections, results


def sound_event_detection(crnns, dataset, timestamps, event_classes,
                          tags, hyper_params_dir, hyper_params_name,
                          ground_truth, audio_durations,
                          collar_based_params=(), psds_params=(),
                          max_segment_length=None, segment_overlap=None,
                          pseudo_widening=.0, score_storage_dir=None,
                          detection_storage_dir=None):
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
    window_lengths = np.zeros((n_sets, k), dtype=int)
    medfilt_lengths = np.zeros((n_sets, k), dtype=int)
    tag_masked = np.zeros((n_sets, k), dtype=bool)
    window_shift = set()
    for i, hp in enumerate(hyper_params):
        for j, event_class in enumerate(event_classes):
            window_lengths[i, j] = hp[event_class]['window_length']
            medfilt_lengths[i, j] = hp[event_class]['medfilt_length']
            tag_masked[i, j] = hp[event_class]['tag_masked']
            window_shift.add(hp[event_class]['window_shift'])
    assert len(window_shift) == 1, (
        'Inference with multiple window shifts is not supported.')
    window_shift = window_shift.pop()
    if max_segment_length is not None:
        assert max_segment_length % window_shift == 0
        assert (segment_overlap // 2) % window_shift == 0
    detection_scores = base.sound_event_detection(
        crnns, dataset,
        model_kwargs={'window_length': window_lengths,
                      'window_shift': window_shift},
        medfilt_length=medfilt_lengths, apply_mask=tag_masked,
        masks=tags, timestamps=timestamps[::window_shift],
        event_classes=event_classes,
        max_segment_length=max_segment_length,
        segment_overlap=segment_overlap, merge_score_segments=True,
        score_segment_overlap=(
            segment_overlap // window_shift
            if segment_overlap else None),
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
                        staircase_auc(tpr, efpr,
                                      params.get('max_efpr', 100))
                if score_storage_dir and score_storage_dir[i] is not None:
                    from pb_sed_tpu.evaluation.scores import (
                        lazy_sed_scores_loader)
                    psds_files, _, _ = intersection_based.psds(
                        lazy_sed_scores_loader(score_storage_dir[i]),
                        ground_truth, audio_durations, **params,
                        num_jobs=8)
                    print(f'psds[{j}] (from files)', psds_files)
                approx, _, classwise = \
                    intersection_based.approximate_psds(
                        scores_i, ground_truth, audio_durations,
                        **params, thresholds=np.linspace(.01, .99, 50))
                print(f'approx_psds[{j}]', approx)
                results[-1][f'approx_psds[{j}]'] = approx
                for event_class, (tpr, efpr, *_) in classwise.items():
                    results[-1][f'{event_class}_approx_auc[{j}]'] = \
                        staircase_auc(tpr, efpr,
                                      params.get('max_efpr', 100))
                if detection_storage_dir and detection_storage_dir[i]:
                    approx_files, _, _ = intersection_based.\
                        approximate_psds_from_detections_dir(
                            detection_storage_dir[i], ground_truth,
                            audio_durations, **params)
                    print(f'approx_psds[{j}] (from files)', approx_files)
    return event_detections, results


def ground_truth_for(data_provider, dataset_name, filepath):
    from pb_sed_tpu.experiments.weak_label_crnn.tuning import (
        ground_truth_from_json)
    if filepath:
        from pb_sed_tpu.evaluation.scores import read_ground_truth_events
        events = read_ground_truth_events(filepath)
        _, tags, durations = ground_truth_from_json(
            data_provider, dataset_name)
        return events, tags, durations
    events, tags, durations = ground_truth_from_json(
        data_provider, dataset_name)
    has_strong = any(events.values())
    return (events if has_strong else None), tags, durations


@ex.automain
def main(_config, storage_dir, hyper_params_dir, sed_hyper_params_name,
         crnn_dirs, crnn_checkpoints, device, data_provider, dataset_name,
         ground_truth_filepath, save_scores, save_detections,
         max_segment_length, segment_overlap, weak_pseudo_labeling,
         boundary_pseudo_labeling, strong_pseudo_labeling,
         pseudo_widening, pseudo_labeled_dataset_name):
    print('\n##### Inference #####\n')
    print_config(_config)
    print(storage_dir)
    storage_dir = Path(storage_dir)
    storage_dir.mkdir(parents=True, exist_ok=True)
    emissions_tracker = EmissionsTracker(output_dir=storage_dir)
    emissions_tracker.start()

    boundary_collar_based_params = {
        'onset_collar': .5, 'offset_collar': .5, 'offset_collar_rate': .0}
    collar_based_params = {
        'onset_collar': .2, 'offset_collar': .2, 'offset_collar_rate': .2}
    psds_scenario_1 = {
        'dtc_threshold': 0.7, 'gtc_threshold': 0.7,
        'cttc_threshold': None, 'alpha_ct': .0, 'alpha_st': 1.}
    psds_scenario_2 = {
        'dtc_threshold': 0.1, 'gtc_threshold': 0.1,
        'cttc_threshold': 0.3, 'alpha_ct': .5, 'alpha_st': 1.}

    if not isinstance(crnn_checkpoints, list):
        crnn_checkpoints = len(crnn_dirs) * [crnn_checkpoints]
    crnns = [
        CRNN.from_storage_dir(
            storage_dir=crnn_dir, config_name='1/config.json',
            checkpoint_name=ckpt)
        for crnn_dir, ckpt in zip(crnn_dirs, crnn_checkpoints)
    ]
    print('Params', sum(crnn.num_parameters() for crnn in crnns))
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
    weak_pseudo_labeling = listify(weak_pseudo_labeling)
    boundary_pseudo_labeling = listify(boundary_pseudo_labeling)
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

        if max_segment_length is None:
            timestamps = {
                audio_id: np.array([0., audio_durations[audio_id]])
                for audio_id in audio_durations
            }
        else:
            timestamps = {}
            for audio_id in audio_durations:
                ts = np.arange(
                    0, audio_durations[audio_id],
                    (max_segment_length - segment_overlap) * frame_shift)
                timestamps[audio_id] = np.concatenate(
                    (ts, [audio_durations[audio_id]]))
        tags, tagging_scores, tagging_results = tagging(
            crnns, dataset, timestamps, event_classes, hyper_params_dir,
            gt_events, audio_durations,
            [psds_scenario_1, psds_scenario_2],
            max_segment_length=max_segment_length,
            segment_overlap=segment_overlap)
        if tagging_results:
            dump_json(tagging_results,
                      storage_dir / f'tagging_results_{ds_name}.json')

        timestamps = np.round(
            np.arange(0, 100000) * frame_shift, decimals=6)
        if gt_events is not None or boundary_pseudo_labeling[i]:
            boundaries, boundaries_results = boundaries_detection(
                crnns, dataset, timestamps, event_classes, tags,
                hyper_params_dir, gt_events,
                boundary_collar_based_params,
                max_segment_length=max_segment_length,
                segment_overlap=segment_overlap,
                pseudo_widening=pseudo_widening)
            if boundaries_results:
                dump_json(
                    boundaries_results,
                    storage_dir
                    / f'boundaries_detection_results_{ds_name}.json')
        else:
            boundaries = {}
        sed_names = (sed_hyper_params_name
                     if isinstance(sed_hyper_params_name, (list, tuple))
                     else [sed_hyper_params_name])
        if (gt_events is not None or strong_pseudo_labeling[i]
                or save_scores or save_detections):
            events, sed_results = sound_event_detection(
                crnns, dataset, timestamps, event_classes, tags,
                hyper_params_dir, sed_names, gt_events, audio_durations,
                collar_based_params, [psds_scenario_1, psds_scenario_2],
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
                    dump_json(
                        sed_results_j,
                        storage_dir
                        / f'sed_{sed_names[j]}_results_{ds_name}.json')
        else:
            events = [{}]
        database['datasets'][pseudo_labeled_dataset_name[i]] = \
            base.pseudo_label(
                database['datasets'][ds_name], event_classes,
                weak_pseudo_labeling[i], boundary_pseudo_labeling[i],
                strong_pseudo_labeling[i], tags, boundaries, events[0])

    if any(weak_pseudo_labeling) or any(boundary_pseudo_labeling) \
            or any(strong_pseudo_labeling):
        dump_json(database,
                  storage_dir / Path(data_provider.json_path).name)
    inference_dir = Path(hyper_params_dir) / 'inference'
    os.makedirs(str(inference_dir), exist_ok=True)
    link = inference_dir / storage_dir.name
    if not link.exists():
        link.symlink_to(storage_dir)
    emissions_tracker.stop()
    print(storage_dir)
    return str(storage_dir)
