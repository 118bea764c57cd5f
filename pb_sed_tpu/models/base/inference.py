"""Ensemble inference engine.

Capability parity with ``pb_sed/models/base/inference.py:12-356``: one
generic ``inference(models, method, dataset, ...)`` driver plus
``tagging`` / ``boundaries_detection`` / ``sound_event_detection``
wrappers; ensemble = mean of model scores; sequence masking; vectorized
per-class / per-paramset median filtering; ``boundariesfilt`` (min of
forward/backward cummax after step filtering); tag-mask application;
overlapped segment merging; conversion to score dataframes with optional
on-disk storage.

Execution: each model's method call is a cached jitted XLA program (see
``SoundEventModel._apply``); batches arrive in a fixed shape palette so
programs are reused across the dataset. Post-processing (filters, masking,
dataframes) is host-side numpy like the reference — it is O(B*K*T) cheap
next to the model.
"""
from pathlib import Path

import numpy as np

from pb_sed_tpu.evaluation.scores import (
    create_score_dataframe, lazy_sed_scores_loader, write_sed_scores)
from pb_sed_tpu.ops.filters import boundariesfilt, medfilt
from pb_sed_tpu.utils.segment import merge_segments, segment_batch


def tagging(models, dataset, max_segment_length=None, segment_overlap=None,
            merge_score_segments=False, score_segment_overlap=None,
            model_kwargs=None, medfilt_length=1, method='tagging',
            timestamps=None, event_classes=None, score_storage_dir=None,
            device=None, auto_stack=True, mesh='auto'):
    return inference(
        models, method, dataset, mesh=mesh,
        max_segment_length=max_segment_length,
        segment_overlap=segment_overlap,
        merge_score_segments=merge_score_segments,
        score_segment_overlap=score_segment_overlap,
        model_kwargs=model_kwargs, medfilt_length=medfilt_length,
        post_processing_fn=lambda x: x.max(-2, keepdims=True),
        timestamps=timestamps, event_classes=event_classes,
        score_storage_dir=score_storage_dir, auto_stack=auto_stack)


def boundaries_detection(models, dataset, max_segment_length=None,
                         segment_overlap=None, merge_score_segments=False,
                         score_segment_overlap=None, model_kwargs=None,
                         medfilt_length=1, stepfilt_length=0,
                         apply_mask=False, masks=None,
                         method='boundaries_detection', timestamps=None,
                         event_classes=None, score_storage_dir=None,
                         device=None, auto_stack=True, mesh='auto'):
    return inference(
        models, method, dataset, mesh=mesh,
        max_segment_length=max_segment_length,
        segment_overlap=segment_overlap,
        merge_score_segments=merge_score_segments,
        score_segment_overlap=score_segment_overlap,
        model_kwargs=model_kwargs, medfilt_length=medfilt_length,
        stepfilt_length=stepfilt_length, apply_mask=apply_mask,
        masks=masks, timestamps=timestamps, event_classes=event_classes,
        score_storage_dir=score_storage_dir, auto_stack=auto_stack)


def sound_event_detection(models, dataset, max_segment_length=None,
                          segment_overlap=None, merge_score_segments=False,
                          score_segment_overlap=None, model_kwargs=None,
                          medfilt_length=1,
                          method='sound_event_detection',
                          apply_mask=False, masks=None, timestamps=None,
                          event_classes=None, score_storage_dir=None,
                          device=None, auto_stack=True, mesh='auto'):
    return inference(
        models, method, dataset, mesh=mesh,
        max_segment_length=max_segment_length,
        segment_overlap=segment_overlap,
        merge_score_segments=merge_score_segments,
        score_segment_overlap=score_segment_overlap,
        model_kwargs=model_kwargs, medfilt_length=medfilt_length,
        apply_mask=apply_mask, masks=masks, timestamps=timestamps,
        event_classes=event_classes, score_storage_dir=score_storage_dir,
        auto_stack=auto_stack)


def inference(model, method, dataset, max_segment_length=None,
              segment_overlap=0, merge_score_segments=False,
              score_segment_overlap=None, model_kwargs=None,
              medfilt_length=1, stepfilt_length=None, apply_mask=False,
              masks=None, post_processing_fn=None, timestamps=None,
              event_classes=None, score_storage_dir=None, device=None,
              auto_stack=True, mesh='auto'):
    """``mesh='auto'`` (the production default, mirroring
    ``Trainer.__init__``'s ``get_mesh()``): with >1 attached device the
    stacked ensemble shards members over an ``ensemble`` mesh axis and
    the batch over ``data`` (collectives; see
    ``parallel.mesh.default_ensemble_mesh``) — replacing the reference's
    sequential single-device member loop
    (``pb_sed/models/base/inference.py:133-141``). Pass ``mesh=None`` to
    force the single-device vmapped lane, or an explicit
    ``jax.sharding.Mesh``."""
    models = model if isinstance(model, (list, tuple)) else [model]
    if model_kwargs is None:
        model_kwargs = {}
    if not isinstance(model_kwargs, (list, tuple)):
        model_kwargs = len(models) * [model_kwargs]
    assert len(model_kwargs) == len(models), (
        len(models), len(model_kwargs))
    if auto_stack and len(models) > 1:
        # identical architectures: evaluate the whole ensemble in one
        # vmapped XLA program (see models/base/ensemble.py); with a
        # mesh, members/batch shard over the devices
        from pb_sed_tpu.models.base.ensemble import maybe_stack
        if isinstance(mesh, str) and mesh == 'auto':
            from pb_sed_tpu.parallel.mesh import default_ensemble_mesh
            mesh = default_ensemble_mesh(len(models))
        try:
            models, model_kwargs = maybe_stack(
                models, model_kwargs, mesh=mesh)
        except Exception as exc:  # stacking is an optimization only
            print(f'ensemble stacking disabled: {exc}')
    medfilt_length = np.asarray(medfilt_length, dtype=int)
    apply_mask = np.asarray(apply_mask, dtype=bool)
    for m in models:
        assert hasattr(m, method), (m, method)

    stft_geom = getattr(
        getattr(models[0].module, 'feature_extractor', None), 'stft', None)
    if post_processing_fn is None:
        def post_processing_fn(x):
            return x
    if stepfilt_length is not None:
        stepfilt_length = np.asarray(stepfilt_length, dtype=int)
    scores = {}
    score_cache = {}

    def segments():
        """(segment, last_of_batch) over the dataset's batches."""
        for batch in dataset:
            batch = dict(batch)
            for key in ('weak_targets', 'boundary_targets',
                        'strong_targets'):
                batch.pop(key, None)
            if max_segment_length is not None:
                input_segments = segment_batch(
                    batch, max_length=max_segment_length,
                    overlap=segment_overlap, stft=stft_geom)
            else:
                input_segments = [batch]
            for j, segment in enumerate(input_segments):
                yield segment, j == len(input_segments) - 1

    def finalize(segment, outs, last_of_batch):
        """Host side of one segment: materialize the dispatched model
        outputs, ensemble-mean, mask, filter, cache — and on the last
        segment of a batch, the batch tail (merge / dataframes /
        result bookkeeping)."""
        nonlocal scores, score_cache
        segment_scores = None
        seq_len = None
        for yi, seq_len_i in outs:
            yi = np.asarray(yi, dtype=np.float64)
            if segment_scores is None:
                segment_scores = yi
                seq_len = np.asarray(seq_len_i)
            else:
                assert (np.asarray(seq_len_i) == seq_len).all(), (
                    seq_len, seq_len_i)
                segment_scores = segment_scores + yi
        segment_scores = segment_scores / len(models)
        # sequence masking (scores are (B, ..., K, T))
        t = segment_scores.shape[-1]
        mask = (np.arange(t)[None, :]
                < seq_len[:, None]).astype(segment_scores.dtype)
        mask = mask.reshape(
            mask.shape[0], *([1] * (segment_scores.ndim - 2)), t)
        segment_scores = segment_scores * mask
        segment_scores = filtering(
            segment_scores, medfilt, medfilt_length)
        if stepfilt_length is not None:
            segment_scores = filtering(
                segment_scores, _boundariesfilt, stepfilt_length)
        score_cache.update({
            audio_id: post_processing_fn(
                segment_scores[i, ..., :sl].swapaxes(-2, -1))
            for i, (audio_id, sl) in enumerate(zip(
                segment['example_id'], seq_len))
        })
        if apply_mask.any():
            assert masks is not None
            # mask ONLY the segment ids just added: earlier cache
            # entries are already masked (re-multiplying them would
            # attenuate non-boolean masks as mask^n)
            for audio_id in segment['example_id']:
                # tag masks are keyed by CLIP id (time-invariant)
                mask_key = audio_id.split('_!segment!_')[0]
                assert mask_key in masks, mask_key
                m_arr = apply_mask
                if m_arr.ndim == 2:
                    m_arr = m_arr[..., None, :]
                score_cache[audio_id] = score_cache[audio_id] * (
                    np.maximum(masks[mask_key], 1 - m_arr))
        if not last_of_batch:
            return
        # ---- batch tail ------------------------------------------------
        local_cache = score_cache
        if merge_score_segments:
            example_id = segment['example_id'][0]
            if '_!segment!_' in example_id:
                seg_idx, n_segments = example_id.split(
                    '_!segment!_')[-1].split('_')
                if int(seg_idx) != int(n_segments) - 1:
                    # batch ends mid-clip: keep accumulating segments
                    # across batches (reference semantics)
                    return
                local_cache = merge_segments(
                    local_cache,
                    segment_overlap=segment_overlap
                    if score_segment_overlap is None
                    else score_segment_overlap)
        if (timestamps is not None or event_classes is not None
                or score_storage_dir is not None):
            assert timestamps is not None and event_classes is not None
            local_cache = scores_to_dataframes(
                local_cache, timestamps, event_classes, score_storage_dir)
        if score_storage_dir is None:
            if not scores:
                scores = local_cache
            elif isinstance(scores, (list, tuple)):
                for i in range(len(scores)):
                    scores[i].update(local_cache[i])
            else:
                scores.update(local_cache)
        else:
            scores = local_cache
        score_cache = {}

    # one-segment-deep dispatch pipeline: segment k+1's jitted calls are
    # dispatched (async device arrays, ``model.dispatch``) BEFORE
    # segment k's outputs are materialized and post-processed, so host
    # filtering/masking overlaps device compute; the reference's serial
    # loop (``pb_sed/models/base/inference.py:130-160``) leaves the
    # device idle while the host post-processes.
    pending = None
    for segment, last_of_batch in segments():
        outs = [
            m.dispatch(method, segment, **model_kwargs[i])
            if hasattr(m, 'dispatch')
            # duck-typed models without the async lane: blocking call
            else getattr(m, method)(segment, **model_kwargs[i])
            for i, m in enumerate(models)]
        if pending is not None:
            finalize(*pending)
        pending = (segment, outs, last_of_batch)
    if pending is not None:
        finalize(*pending)
    return scores


def filtering(score_arr, filter_fn, filter_length):
    """Apply a time filter with scalar / per-class / per-paramset lengths
    (reference semantics, ``inference.py:225-263``)."""
    score_arr = np.array(score_arr)
    b, *_, k, t = score_arr.shape
    filter_length = np.asarray(filter_length, dtype=int)
    if filter_length.ndim == 0:
        return filter_fn(score_arr, int(filter_length), axis=-1)
    if filter_length.ndim == 1:
        assert filter_length.shape[0] == k, filter_length.shape
        for ki, n in enumerate(filter_length):
            score_arr[..., ki, :] = filter_fn(
                score_arr[..., ki, :], int(n), axis=-1)
        return score_arr
    if filter_length.ndim == 2:
        assert filter_length.shape[1] in (1, k), filter_length.shape
        n_sets = filter_length.shape[0]
        if score_arr.ndim == 3:
            score_arr = np.broadcast_to(
                score_arr[:, None], (b, n_sets, k, t)).copy()
        else:
            assert score_arr.shape[1] == n_sets, (
                score_arr.shape, n_sets)
        for j in range(n_sets):
            if filter_length.shape[1] == 1:
                score_arr[:, j] = filter_fn(
                    score_arr[:, j], int(filter_length[j, 0]), axis=-1)
            else:
                for ki in range(k):
                    score_arr[:, j, ki] = filter_fn(
                        score_arr[:, j, ki], int(filter_length[j, ki]),
                        axis=-1)
        return score_arr
    raise ValueError(filter_length.shape)


def _boundariesfilt(score_arr, stepfilt_length, axis=-1):
    return boundariesfilt(score_arr, stepfilt_length, axis=axis)


def scores_to_dataframes(scores, timestamps, event_classes,
                         storage_path=None):
    """(T, K) arrays (or dicts / per-paramset stacks) -> score dataframes
    (reference ``inference.py:292-356``)."""
    if isinstance(scores, np.ndarray):
        t, k = scores.shape
        assert len(timestamps) > t, (len(timestamps), t)
        assert len(event_classes) == k, (event_classes, k)
        df = create_score_dataframe(
            scores, np.asarray(timestamps)[:t + 1], event_classes)
        if storage_path is not None:
            write_sed_scores(df, storage_path)
        return df
    assert isinstance(scores, dict), type(scores)
    audio_ids = sorted(scores.keys())
    if not audio_ids:
        return {}
    first = scores[audio_ids[0]]
    if np.ndim(first) == 3:
        n = np.shape(first)[0]
        out = [dict() for _ in range(n)]
        for audio_id in audio_ids:
            ts = (timestamps[audio_id]
                  if isinstance(timestamps, dict) else timestamps)
            for i in range(n):
                if storage_path is None:
                    filepath = None
                else:
                    assert isinstance(storage_path, (list, tuple))
                    assert len(storage_path) == n
                    d = Path(storage_path[i])
                    d.mkdir(parents=True, exist_ok=True)
                    filepath = d / f'{audio_id}.tsv'
                out[i][audio_id] = scores_to_dataframes(
                    scores[audio_id][i], ts, event_classes, filepath)
        if storage_path is not None:
            return [lazy_sed_scores_loader(p) for p in storage_path]
        return out
    out = {}
    for audio_id in audio_ids:
        ts = (timestamps[audio_id]
              if isinstance(timestamps, dict) else timestamps)
        if storage_path is None:
            filepath = None
        else:
            d = Path(storage_path)
            d.mkdir(parents=True, exist_ok=True)
            filepath = d / f'{audio_id}.tsv'
        out[audio_id] = scores_to_dataframes(
            scores[audio_id], ts, event_classes, filepath)
    if storage_path is not None:
        return lazy_sed_scores_loader(storage_path)
    return out
