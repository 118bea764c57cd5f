"""Stacked ensemble execution.

The reference runs ensemble members sequentially on one device
(``pb_sed/models/base/inference.py:133-141``). Redesign: when all
members share the same architecture, their variables are stacked on a
leading ensemble axis and the model function is ``vmap``-ed over it — one
XLA program evaluates the whole ensemble per batch (N-times larger
batched matmuls instead of N sequential launches). With a multi-device
mesh the ensemble axis is sharded over the ``ensemble`` mesh axis so
members evaluate on different devices.
"""
import jax
import jax.numpy as jnp
import numpy as np

from jax.sharding import NamedSharding, PartitionSpec as P


_VMAP_LOWERING_PATTERNS = (
    'feature_group_count',   # grouped-conv constraint under vmap
    'batch_group_count',
    'batching rule',         # missing/unsupported primitive batching rule
    'conv_general_dilated',
)


def _is_vmap_lowering_error(exc):
    """Only the known vmap-of-grouped-conv lowering failures may silently
    fall back to the sequential lane; anything else (OOM, shape mismatch,
    bad member state) must propagate."""
    msg = str(exc)
    return any(pat in msg for pat in _VMAP_LOWERING_PATTERNS)


def same_architecture(models):
    if len(models) < 2:
        return True
    first = models[0].module
    return all(m.module == first for m in models[1:])


class StackedEnsemble:
    """Drop-in for a list of SoundEventModel with identical architecture.

    Exposes the same inference API; scores are the ensemble mean.
    """

    def __init__(self, models, mesh=None, ensemble_axis='ensemble',
                 chunk_size=None):
        assert len(models) >= 1
        assert same_architecture(models), 'architectures differ'
        self.models = models
        self.module = models[0].module
        self.variables = jax.tree_util.tree_map(
            lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
            *[m.variables for m in models])
        self.mesh = mesh
        self.ensemble_axis = ensemble_axis
        # chunk_size: evaluate batches in fixed-size chunks through ONE
        # compiled program (the last chunk pads by repeating its final
        # row; outputs are sliced back). Sliding-window programs (batch x
        # ~T windows x members) grow with the batch — chunking bounds
        # program size and activation memory.
        self.chunk_size = chunk_size
        if mesh is not None and ensemble_axis in mesh.axis_names:
            sharding = NamedSharding(
                mesh, P(ensemble_axis))
            self.variables = jax.tree_util.tree_map(
                lambda x: jax.device_put(x, sharding), self.variables)
        self._jit_cache = {}

    def __len__(self):
        return len(self.models)

    def _apply(self, batch, method, **kwargs):
        cs = self.chunk_size
        if cs:
            arrays = {k: v for k, v in batch.items()
                      if isinstance(v, (np.ndarray, jnp.ndarray))
                      and np.ndim(v) >= 1}
            lens = {np.shape(v)[0] for v in arrays.values()}
            if lens and max(lens) > cs:
                assert len(lens) == 1, lens
                batch_len = lens.pop()
                if self.mesh is None and \
                        not getattr(self, '_scan_disabled', False):
                    # single-device: chunk INSIDE the compiled program
                    # (lax.map over (n_chunks, cs, ...)) — ONE dispatch
                    # per batch; program size stays that of the bs=cs
                    # body.
                    try:
                        return self._apply_scan_chunks(
                            batch, method, set(arrays), batch_len,
                            **kwargs)
                    except Exception as exc:  # noqa: BLE001
                        if not _is_vmap_lowering_error(exc):
                            raise
                        # grouped-conv vmap lowering failure: the host
                        # chunk loop below reaches the sequential-
                        # members fallback lane
                        self._scan_disabled = True
                # per-example HOST lists (example_id/dataset) are sliced
                # alongside the arrays so a method reading per-example
                # metadata sees aligned rows (ADVICE r4: passing them
                # whole was a silent misalignment trap)
                lists = {k for k, v in batch.items()
                         if isinstance(v, list) and len(v) == batch_len}
                outs = []
                for lo in range(0, batch_len, cs):
                    hi = min(lo + cs, batch_len)
                    chunk = {
                        k: (v[lo:hi] if k in arrays or k in lists else v)
                        for k, v in batch.items()}
                    if hi - lo < cs:
                        # pad to the ONE static chunk shape by repeating
                        # the last row (mirrors the data-axis padding)
                        pad = cs - (hi - lo)
                        chunk = {
                            k: (np.concatenate(
                                [v, np.repeat(np.asarray(v)[-1:], pad,
                                              axis=0)], axis=0)
                                if k in arrays else
                                v + v[-1:] * pad if k in lists else v)
                            for k, v in chunk.items()}
                    outs.append(
                        (hi - lo, self._apply_chunk(chunk, method,
                                                    **kwargs)))
                # convert AFTER every chunk is dispatched: np.asarray
                # blocks on the device result, so converting inside the
                # loop would serialize the chunks instead of letting
                # async dispatch pipeline them (ADVICE r4)
                ys = [np.asarray(y)[:n] for n, (y, _) in outs]
                sls = [np.asarray(sl)[:n] if np.ndim(sl) >= 1 else sl
                       for n, (_, sl) in outs]
                y = np.concatenate(ys, axis=0)
                sl = (np.concatenate(sls, axis=0)
                      if np.ndim(sls[0]) >= 1 else sls[0])
                return y, sl
        return self._apply_chunk(batch, method, **kwargs)

    def _apply_scan_chunks(self, batch, method, array_keys, batch_len,
                           **kwargs):
        """One compiled program evaluating ALL chunks: the batch is
        padded to a chunk multiple (repeating the last row, mirroring
        the host loop) and ``lax.map``-ed in ``chunk_size`` slices over
        the vmapped member-mean body."""
        cs = self.chunk_size
        module = self.module
        pad = (-batch_len) % cs
        device_batch = {
            k: jnp.asarray(batch[k]) for k in array_keys}
        if pad:
            device_batch = {
                k: jnp.concatenate(
                    [v, jnp.repeat(v[-1:], pad, axis=0)], axis=0)
                for k, v in device_batch.items()}
        n_chunks = (batch_len + pad) // cs
        key = ('scan', getattr(method, '__name__', method), n_chunks,
               tuple(sorted(kwargs.items())))
        if key not in self._jit_cache:
            def one(variables, device_batch):
                return module.apply(
                    variables, device_batch, training=False,
                    method=method, **kwargs)

            member_fn = jax.vmap(one, in_axes=(0, None))

            def chunk_body(variables, chunk):
                y, seq_len = member_fn(variables, chunk)
                return y.mean(0), seq_len[0]

            def scan_fn(variables, full_batch):
                chunks = {
                    k: v.reshape(n_chunks, cs, *v.shape[1:])
                    for k, v in full_batch.items()}
                ys, sls = jax.lax.map(
                    lambda c: chunk_body(variables, c), chunks)
                y = ys.reshape(n_chunks * cs, *ys.shape[2:])
                sl = (sls.reshape(n_chunks * cs, *sls.shape[2:])
                      if sls.ndim >= 2 else sls[0])
                return y, sl

            self._jit_cache[key] = [jax.jit(scan_fn)]
        y, sl = self._jit_cache[key][0](self.variables, device_batch)
        return (y[:batch_len],
                sl[:batch_len] if jnp.ndim(sl) >= 1 else sl)

    def _apply_chunk(self, batch, method, **kwargs):
        key = (getattr(method, '__name__', method),
               tuple(sorted(kwargs.items())))
        module = self.module
        if key not in self._jit_cache:
            def one(variables, device_batch):
                return module.apply(
                    variables, device_batch, training=False,
                    method=method, **kwargs)

            fn = jax.vmap(one, in_axes=(0, None))

            def mean_fn(variables, device_batch):
                y, seq_len = fn(variables, device_batch)
                return y.mean(0), seq_len[0]

            def member_mean_fn(variables, device_batch):
                # fallback: sequential members inside one jit (some
                # vmapped convolutions hit grouped-conv constraints)
                ys = []
                seq_len = None
                for i in range(len(self.models)):
                    member = jax.tree_util.tree_map(
                        lambda x: x[i], variables)
                    y, seq_len = one(member, device_batch)
                    ys.append(y)
                return jnp.stack(ys).mean(0), seq_len

            mesh = self.mesh
            if mesh is not None and self.ensemble_axis in mesh.axis_names:
                # ensemble-axis parallelism via shard_map: every shard
                # evaluates its LOCAL members with ordinary (non-grouped)
                # convolutions and the member mean reduces with one
                # pmean — this avoids the GSPMD grouped-conv rewrite
                # that the vmapped lane can hit under sharding. The BATCH
                # axis additionally shards over the mesh's 'data' axis
                # (SURVEY §2.4: inference segments/windows across chips).
                from jax import shard_map
                axis = self.ensemble_axis
                data_axis = ('data' if 'data' in mesh.axis_names
                             else None)
                e_local = len(self.models) // mesh.shape[axis]

                def shard_fn(variables, device_batch):
                    ys = []
                    seq_len = None
                    for i in range(e_local):
                        member = jax.tree_util.tree_map(
                            lambda x: x[i], variables)
                        y, seq_len = one(member, device_batch)
                        ys.append(y)
                    y = jnp.stack(ys).mean(0)
                    y = jax.lax.pmean(y, axis_name=axis)
                    return y, seq_len

                sharded = shard_map(
                    shard_fn, mesh=mesh,
                    # prefix specs: members over the ensemble axis, the
                    # batch dim over the data axis (replicated when the
                    # mesh has no data axis)
                    in_specs=(P(axis), P(data_axis)),
                    out_specs=(P(data_axis), P(data_axis)),
                    check_vma=False,
                )
                self._jit_cache[key] = [jax.jit(sharded),
                                        jax.jit(member_mean_fn)]
            elif mesh is not None and 'data' in mesh.axis_names:
                # coprime member/device counts (no ensemble axis):
                # members evaluate vmapped on every device, the BATCH
                # shards over the data axis
                repl = NamedSharding(mesh, P())
                data = NamedSharding(mesh, P('data'))
                self._jit_cache[key] = [
                    jax.jit(mean_fn, in_shardings=(repl, data),
                            out_shardings=(data, data)),
                    jax.jit(member_mean_fn, in_shardings=(repl, data),
                            out_shardings=(data, data)),
                ]
            else:
                self._jit_cache[key] = [jax.jit(mean_fn),
                                        jax.jit(member_mean_fn)]
        device_batch = {
            k: jnp.asarray(v) for k, v in batch.items()
            if isinstance(v, (np.ndarray, jnp.ndarray))
        }
        # batch padded to the data-axis size so the batch axis splits
        # evenly over the mesh (both the shard_map and data-only lanes)
        batch_len = None
        data_size = (self.mesh.shape.get('data', 1)
                     if self.mesh is not None else 1)
        if data_size > 1:
            lens = {v.shape[0] for v in device_batch.values()
                    if v.ndim >= 1}
            assert len(lens) == 1, lens
            batch_len = lens.pop()
            pad = (-batch_len) % data_size
            if pad:
                device_batch = {
                    k: jnp.concatenate(
                        [v, jnp.repeat(v[-1:], pad, axis=0)], axis=0)
                    if v.ndim >= 1 else v
                    for k, v in device_batch.items()
                }
        fns = self._jit_cache[key]
        try:
            out = fns[0](self.variables, device_batch)
        except Exception as exc:  # noqa: BLE001 — filtered below
            if not _is_vmap_lowering_error(exc):
                raise  # genuine failures (OOM, shape bugs) must surface
            import warnings
            warnings.warn(
                f'vmapped ensemble path failed to lower '
                f'({type(exc).__name__}: {exc}); falling back to the '
                f'sequential-members-in-one-jit lane (N x slower)',
                RuntimeWarning, stacklevel=2)
            fns[0] = fns[1]  # stop retrying the vmapped path
            out = fns[1](self.variables, device_batch)
        if batch_len is not None:
            y, seq_len = out
            out = (y[:batch_len],
                   seq_len[:batch_len] if jnp.ndim(seq_len) >= 1
                   else seq_len)
        return out

    # -- inference API -------------------------------------------------
    def dispatch(self, method, batch, **params):
        """Async inference: same values as the public methods, device
        arrays where possible (see ``SoundEventModel.dispatch``)."""
        module_cls = type(self.module)
        if method == 'sound_event_detection' \
                and hasattr(module_cls, 'sed_windows') \
                and params.get('window_length') is not None:
            from pb_sed_tpu.models.weak_label.crnn import multi_window_sed
            ws = params.pop('window_shift', 1)
            return multi_window_sed(
                lambda win_len: self._apply(
                    batch, module_cls.sed_windows,
                    window_length=win_len, window_shift=int(ws)),
                params.pop('window_length'), materialize=False)
        if method == 'sound_event_detection' \
                and not hasattr(module_cls, 'sed_windows'):
            params.pop('window_length', None)
            params.pop('window_shift', None)
            return self._apply(
                batch, module_cls.sound_event_detection, **params)
        return self._apply(batch, getattr(module_cls, method), **params)

    def tagging(self, batch, **params):
        method = type(self.module).tagging
        y, seq_len = self._apply(batch, method, **params)
        return np.asarray(y), np.asarray(seq_len)

    def boundaries_detection(self, batch, **params):
        method = type(self.module).boundaries_detection
        y, seq_len = self._apply(batch, method, **params)
        return np.asarray(y), np.asarray(seq_len)

    def sound_event_detection(self, batch, window_length=None,
                              window_shift=1, **params):
        module_cls = type(self.module)
        if hasattr(module_cls, 'sed_windows') and window_length is not None:
            from pb_sed_tpu.models.weak_label.crnn import multi_window_sed
            return multi_window_sed(
                lambda win_len: self._apply(
                    batch, module_cls.sed_windows,
                    window_length=win_len,
                    window_shift=int(window_shift)),
                window_length)
        method = module_cls.sound_event_detection
        y, seq_len = self._apply(batch, method, **params)
        return np.asarray(y), np.asarray(seq_len)


def maybe_stack(models, model_kwargs, mesh=None):
    """Stack when architectures and per-model kwargs agree."""
    if len(models) < 2:
        return models, model_kwargs
    if isinstance(models[0], StackedEnsemble):
        return models, model_kwargs
    if not same_architecture(models):
        return models, model_kwargs
    if any(kw != model_kwargs[0] for kw in model_kwargs[1:]):
        return models, model_kwargs
    return [StackedEnsemble(models, mesh=mesh)], [model_kwargs[0]]
