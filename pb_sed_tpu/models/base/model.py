"""SoundEventModel base: module wrapper with the reference's model API.

Capability parity with ``pb_sed/models/base/model.py:9-88`` (abstract
``tagging`` / ``boundaries_detection`` / ``sound_event_detection``,
``modify_summary`` scalar averaging + image grids,
``add_metrics_to_summary`` buffered-score metrics) and the padertorch
``Model`` contract the trainer consumes (``forward``/``review``,
checkpoint restore via ``from_storage_dir`` —
``experiments/weak_label_crnn/tuning.py:128-133``).

JAX split: the *module* (a ``pb_sed_tpu.nn.Module``) holds the
architecture; this wrapper owns the variables (params + batch_stats),
pure loss/inference functions for the jitted trainer, label metadata, and
the host-side summary logic. Checkpoints are flat dotted-key -> numpy
dicts (layout ``{'model': flat_state_dict}``) to support the reference's
partial-restore surgery (``training.py:327-342``).
"""
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from pb_sed_tpu.evaluation import instance_based
from pb_sed_tpu.utils.config import (
    Configurable, instantiate, load_run_config)


def flatten_variables(variables, prefix=''):
    """Nested variable dict -> flat dotted-key numpy dict."""
    out = {}
    for key, value in variables.items():
        full = f'{prefix}.{key}' if prefix else str(key)
        if isinstance(value, dict):
            out.update(flatten_variables(value, full))
        else:
            out[full] = np.asarray(value)
    return out


def unflatten_variables(flat):
    out = {}
    for key, value in flat.items():
        parts = key.split('.')
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


class SoundEventModel(Configurable):
    """Base wrapper: module + variables + label metadata + summaries."""

    def __init__(self, *, labelwise_metrics=(), label_mapping=None,
                 test_labels=None):
        self.labelwise_metrics = labelwise_metrics
        self.label_mapping = label_mapping
        self.test_labels = test_labels
        self.module = None       # set by subclass
        self.variables = None    # {'params': ..., 'batch_stats': ...}

    # ------------------------------------------------------------------
    # variable management
    # ------------------------------------------------------------------
    def init_variables(self, batch, seed=0):
        rng = jax.random.PRNGKey(seed)
        p_rng, a_rng, d_rng = jax.random.split(rng, 3)
        self.variables = self.module.init(
            {'params': p_rng, 'augment': a_rng, 'dropout': d_rng},
            batch, training=False,
        )
        return self.variables

    @property
    def params(self):
        return self.variables['params']

    @property
    def batch_stats(self):
        return self.variables.get('batch_stats', {})

    def num_parameters(self):
        if self.variables is None:
            return 0
        return sum(
            int(np.prod(np.shape(x)))
            for x in jax.tree_util.tree_leaves(self.variables['params'])
        )

    # ------------------------------------------------------------------
    # inference API (reference model.py:16-26)
    # ------------------------------------------------------------------
    def tagging(self, batch, **params):
        raise NotImplementedError

    def boundaries_detection(self, batch, **params):
        raise NotImplementedError

    def sound_event_detection(self, batch, **params):
        raise NotImplementedError

    def dispatch(self, method, batch, **params):
        """Async variant of the public inference API: same values as
        ``getattr(self, method)(batch, **params)`` but returning DEVICE
        arrays where possible, so the jitted call dispatches without
        forcing a transfer. The inference driver
        (``models/base/inference.py``) uses this to overlap host
        post-processing of one segment with device compute of the next
        — a blocking conversion would leave the device idle meanwhile.
        Subclasses override; this default falls back to the blocking
        method."""
        return getattr(self, method)(batch, **params)

    def _apply(self, batch, method=None, **kwargs):
        """Jitted, cached module application for inference.

        ``kwargs`` must be hashable (they become jit-static); the compiled
        function is cached per (method, kwargs) so repeated inference calls
        reuse the same executable.
        """
        assert self.variables is not None, 'call init_variables first'
        if not hasattr(self, '_jit_cache'):
            self._jit_cache = {}
        key = (getattr(method, '__name__', method),
               tuple(sorted(kwargs.items())))
        if key not in self._jit_cache:
            module = self.module

            def fn(variables, device_batch):
                return module.apply(
                    variables, device_batch, training=False, method=method,
                    **kwargs)

            self._jit_cache[key] = jax.jit(fn)
        device_batch = {
            k: v for k, v in batch.items()
            if isinstance(v, (jnp.ndarray, np.ndarray))
        }
        device_batch = jax.tree_util.tree_map(jnp.asarray, device_batch)
        return self._jit_cache[key](self.variables, device_batch)

    # ------------------------------------------------------------------
    # checkpoint IO
    # ------------------------------------------------------------------
    def state_dict(self):
        return flatten_variables(self.variables)

    def load_state_dict(self, flat, strict=True):
        nested = unflatten_variables(dict(flat))
        if strict and self.variables is not None:
            own = set(flatten_variables(self.variables))
            new = set(flat)
            assert own == new, (own - new, new - own)
        self.variables = jax.tree_util.tree_map(jnp.asarray, nested)

    def load_partial_state_dict(self, flat, verbose=True):
        """Merge a (possibly partial) flat state dict into the current
        variables — the transfer-learning surgery path (reference
        ``training.py:327-342``): keys must exist with matching shapes;
        non-matching keys are skipped and reported."""
        assert self.variables is not None, 'initialize variables first'
        current = self.state_dict()
        loaded, skipped = [], []
        for key, value in flat.items():
            if key in current and np.shape(current[key]) == np.shape(
                    value):
                current[key] = np.asarray(value)
                loaded.append(key)
            else:
                skipped.append(key)
        self.load_state_dict(current)
        if verbose:
            print(f'Loaded {len(loaded)} tensors, skipped {len(skipped)}')
        return loaded, skipped

    def save_checkpoint(self, path, extra=None):
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {'model': self.state_dict()}
        if extra:
            payload.update(extra)
        with path.open('wb') as fid:
            pickle.dump(payload, fid)

    def load_checkpoint(self, path):
        with Path(path).open('rb') as fid:
            payload = pickle.load(fid)
        self.load_state_dict(payload['model'], strict=False)
        return payload

    @classmethod
    def from_storage_dir(
            cls, storage_dir, config_name='1/config.json',
            checkpoint_name='ckpt_best_macro_fscore_weak.pkl',
            consider_mpi=False):
        """Restore model from a training run directory
        (reference ``tuning.py:128-133`` contract)."""
        storage_dir = Path(storage_dir)
        config = load_run_config(storage_dir / config_name)
        model = instantiate(config['trainer']['model'])
        ckpt_path = storage_dir / 'checkpoints' / checkpoint_name
        model.load_checkpoint(ckpt_path)
        return model

    # ------------------------------------------------------------------
    # summaries (reference model.py:28-88)
    # ------------------------------------------------------------------
    def modify_summary(self, summary):
        for key, scalar in summary.get('scalars', {}).items():
            summary['scalars'][key] = float(np.mean(scalar))
        images = summary.get('images', {})
        for key, image in list(images.items()):
            images[key] = _image_grid(np.asarray(image))
        return summary

    def add_metrics_to_summary(self, summary, suffix):
        buffers = summary['buffers']
        y = buffers.pop(f'y_{suffix}', None)
        if y is None or len(y) == 0:
            return
        y = np.concatenate(y) if isinstance(y, list) else np.asarray(y)
        if len(y) == 0:
            return
        targets = buffers.pop(f'targets_{suffix}')
        targets = (np.concatenate(targets) if isinstance(targets, list)
                   else np.asarray(targets))
        summary['scalars'][f'num_examples_{suffix}'] = len(y)

        test_labels = self.test_labels
        if test_labels is not None:
            if isinstance(test_labels[0], str):
                assert self.label_mapping is not None
                test_labels = [
                    self.label_mapping.index(lb) for lb in test_labels]
            y = y[..., test_labels]
            targets = targets[..., test_labels]

        def maybe_labelwise(key, values):
            if key in self.labelwise_metrics:
                for idx, value in enumerate(values):
                    cls_idx = test_labels[idx] if test_labels is not None \
                        else idx
                    name = (self.label_mapping[cls_idx]
                            if self.label_mapping is not None else cls_idx)
                    summary['scalars'][f'z/{key}/{name}'] = float(value)

        _, f, p, r = instance_based.get_best_fscore_thresholds(targets, y)
        summary['scalars'][f'macro_fscore_{suffix}'] = float(np.mean(f))
        maybe_labelwise(f'fscore_{suffix}', f)

        _, er, ir, dr = instance_based.get_best_er_thresholds(targets, y)
        summary['scalars'][f'macro_error_rate_{suffix}'] = float(np.mean(er))
        maybe_labelwise(f'error_rate_{suffix}', er)

        lw, per_class_lw, _ = instance_based.lwlrap(targets, y)
        summary['scalars'][f'lwlrap_{suffix}'] = float(lw)
        maybe_labelwise(f'lwlrap_{suffix}', per_class_lw)

        if (targets.sum(0) > 1).all():
            try:
                from sklearn import metrics as skm
                ap = skm.average_precision_score(targets, y, average=None)
                summary['scalars'][f'map_{suffix}'] = float(np.mean(ap))
                maybe_labelwise(f'ap_{suffix}', ap)
                auc = skm.roc_auc_score(targets, y, average=None)
                summary['scalars'][f'mauc_{suffix}'] = float(np.mean(auc))
                maybe_labelwise(f'auc_{suffix}', auc)
            except (ImportError, ValueError):
                pass


def _image_grid(images, max_images=3):
    """(N, T, F) or (N, F, T) feature maps -> one normalized grid image."""
    images = images[:max_images]
    rows = []
    for img in images:
        img = np.asarray(img, dtype=float)
        if img.ndim == 3:
            img = img[..., 0]
        lo, hi = img.min(), img.max()
        img = (img - lo) / (hi - lo + 1e-12)
        rows.append(img[::-1])  # flip freq axis for display
    if not rows:
        return np.zeros((1, 1))
    h = max(r.shape[0] for r in rows)
    w = max(r.shape[1] for r in rows)
    rows = [np.pad(r, ((0, h - r.shape[0]), (0, w - r.shape[1])))
            for r in rows]
    return np.concatenate(rows, axis=0)
