"""SED score dataframes, event-list extraction and score/detection IO.

Capability parity with the ``sed_scores_eval`` utilities the reference
consumes (SURVEY.md §2.3f): ``create_score_dataframe(scores, timestamps,
event_classes)`` (columns ``onset, offset, <class...>``),
``validate_score_dataframe``, ``scores_to_event_list`` (threshold ->
per-clip event list from the piecewise-constant score signal),
``write_sed_scores`` / ``lazy_sed_scores_loader`` tsv IO,
``write_detection`` / ``write_detections_for_multiple_thresholds``, and
ground-truth TSV readers (``filename onset offset event_label``).
"""
from pathlib import Path

import numpy as np


def create_score_dataframe(scores, timestamps, event_classes):
    """(T, K) scores + (T+1,) timestamps -> score dataframe."""
    import pandas as pd
    scores = np.asarray(scores)
    timestamps = np.asarray(timestamps, dtype=float)
    t, k = scores.shape
    assert len(timestamps) == t + 1, (len(timestamps), t)
    assert len(event_classes) == k, (len(event_classes), k)
    data = {'onset': timestamps[:-1], 'offset': timestamps[1:]}
    for i, name in enumerate(event_classes):
        data[name] = scores[:, i]
    return pd.DataFrame(data)


def validate_score_dataframe(df, event_classes=None):
    """Returns (timestamps (T+1,), event_classes)."""
    import pandas as pd
    assert isinstance(df, pd.DataFrame), type(df)
    columns = list(df.columns)
    assert columns[:2] == ['onset', 'offset'], columns[:2]
    found_classes = columns[2:]
    if event_classes is not None:
        assert list(event_classes) == found_classes, (
            event_classes, found_classes)
    onsets = df['onset'].to_numpy()
    offsets = df['offset'].to_numpy()
    timestamps = np.concatenate((onsets, offsets[-1:]))
    return timestamps, found_classes


def event_list_from_score_array(scores, timestamps, event_classes,
                                thresholds):
    """Maximal runs of score > threshold -> [(onset, offset, label)].

    Args:
        scores: (T, K).
        timestamps: (T+1,).
        thresholds: scalar or per-class (K,).
    """
    scores = np.asarray(scores)
    t, k = scores.shape
    thresholds = np.broadcast_to(np.asarray(thresholds, dtype=float), (k,))
    events = []
    for ki in range(k):
        above = scores[:, ki] > thresholds[ki]
        if not above.any():
            continue
        edges = np.diff(above.astype(np.int8), prepend=0, append=0)
        onsets = np.nonzero(edges == 1)[0]
        offsets = np.nonzero(edges == -1)[0]
        for on, off in zip(onsets, offsets):
            events.append((float(timestamps[on]), float(timestamps[off]),
                           event_classes[ki]))
    return sorted(events)


def scores_to_event_list(scores, thresholds, event_classes=None):
    """Dict of dataframes (or one dataframe) -> event list(s)."""
    if isinstance(scores, dict):
        return {
            clip_id: scores_to_event_list(df, thresholds, event_classes)
            for clip_id, df in scores.items()
        }
    timestamps, classes = validate_score_dataframe(scores, event_classes)
    arr = scores[classes].to_numpy()
    if isinstance(thresholds, dict):
        thresholds = np.array([thresholds[c] for c in classes])
    return event_list_from_score_array(arr, timestamps, classes, thresholds)


# ----------------------------------------------------------------------
# IO
# ----------------------------------------------------------------------
def write_sed_scores(scores, storage_path):
    storage_path = Path(storage_path)
    storage_path.parent.mkdir(parents=True, exist_ok=True)
    scores.to_csv(storage_path, sep='\t', index=False)


def read_sed_scores(filepath):
    import pandas as pd
    return pd.read_csv(filepath, sep='\t')


class lazy_sed_scores_loader(dict):
    """Dict-like lazy loader over a directory of per-clip score tsvs."""

    def __init__(self, dir_path):
        super().__init__()
        self.dir_path = Path(dir_path)
        self._files = {
            p.stem: p for p in sorted(self.dir_path.glob('*.tsv'))}

    def keys(self):
        return self._files.keys()

    def __iter__(self):
        return iter(self._files)

    def __len__(self):
        return len(self._files)

    def __contains__(self, key):
        return key in self._files

    def __getitem__(self, key):
        if not super().__contains__(key):
            super().__setitem__(key, read_sed_scores(self._files[key]))
        return super().__getitem__(key)


def write_detection(scores, threshold, filepath, event_classes=None):
    """Threshold scores -> event TSV ``filename onset offset event_label``."""
    event_lists = scores_to_event_list(scores, threshold, event_classes)
    filepath = Path(filepath)
    filepath.parent.mkdir(parents=True, exist_ok=True)
    with filepath.open('w') as fid:
        fid.write('filename\tonset\toffset\tevent_label\n')
        for clip_id in sorted(event_lists):
            for onset, offset, label in event_lists[clip_id]:
                fid.write(
                    f'{clip_id}.wav\t{onset}\t{offset}\t{label}\n')


def write_detections_for_multiple_thresholds(
        scores, thresholds, dir_path, event_classes=None, suffix='.tsv',
        threshold_decimals=3):
    dir_path = Path(dir_path)
    dir_path.mkdir(parents=True, exist_ok=True)
    for threshold in thresholds:
        name = f'{threshold:.{threshold_decimals}f}{suffix}'
        write_detection(scores, threshold, dir_path / name, event_classes)


def read_ground_truth_events(filepath):
    """TSV -> {clip_id: [(onset, offset, label)]}."""
    import pandas as pd
    df = pd.read_csv(filepath, sep='\t')
    out = {}
    for _, row in df.iterrows():
        clip_id = str(row['filename']).rsplit('.', 1)[0]
        out.setdefault(clip_id, [])
        if isinstance(row.get('event_label'), str):
            out[clip_id].append((
                float(row['onset']), float(row['offset']),
                row['event_label']))
    return out


def read_ground_truth_tags(filepath):
    """TSV -> ({clip_id: [labels]}, {label: clip count}).

    Supports both the events format (``filename onset offset event_label``)
    and the DESED weak format (``filename event_labels`` with
    comma-separated labels)."""
    import pandas as pd
    df = pd.read_csv(filepath, sep='\t')
    if 'event_labels' in df.columns:
        tags = {}
        for _, row in df.iterrows():
            clip_id = str(row['filename']).rsplit('.', 1)[0]
            labels = row['event_labels']
            tags[clip_id] = (sorted(str(labels).split(','))
                             if isinstance(labels, str) else [])
    else:
        events = read_ground_truth_events(filepath)
        tags = {cid: sorted({lb for *_, lb in evs})
                for cid, evs in events.items()}
    counts = {}
    for labels in tags.values():
        for lb in labels:
            counts[lb] = counts.get(lb, 0) + 1
    return tags, counts


def read_audio_durations(filepath):
    import pandas as pd
    df = pd.read_csv(filepath, sep='\t')
    return {
        str(row['filename']).rsplit('.', 1)[0]: float(row['duration'])
        for _, row in df.iterrows()
    }


def ground_truth_from_events_dict(events_dict):
    """Pass-through helper: {clip: [(on, off, label)]} already in shape."""
    return {
        clip_id: [tuple(ev) for ev in evs]
        for clip_id, evs in events_dict.items()
    }
