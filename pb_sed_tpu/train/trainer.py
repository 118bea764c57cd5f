"""Trainer: jitted SPMD train loop with hooks, validation, checkpointing.

Capability parity with the padertorch Trainer contract the reference
consumes (SURVEY.md §1/L3, §2.3b):
``Trainer.get_config/from_config``, ``test_run(train_set, validate_set)``,
``register_validation_hook(metric=..., maximize, n_back_off,
back_off_patience, lr_update_factor, early_stopping_patience)``,
``register_hook(LRAnnealingHook(...))``,
``train(train_set, resume=..., device=..., track_emissions=...)``,
``(N, 'iteration')`` summary/checkpoint/stop triggers, best-checkpoint
tracking named ``ckpt_best_<metric>``, resume from the latest checkpoint,
and ``{'model': flat_state_dict}`` checkpoint layout enabling partial-load
surgery.

Design:
- ONE jitted train step per padded batch shape: loss + grads + optax update
  + masked-BN stat updates fused into a single XLA program.
- SPMD data parallelism via ``jax.sharding``: the batch is sharded over the
  mesh's ``data`` axis, parameters/optimizer state are replicated, and XLA
  emits the gradient all-reduce — no hand-written collectives.
- The learning rate enters the step as a dynamic scalar, so host-side LR
  annealing and validation back-off never trigger recompilation.
- Summaries buffer on host (numpy) and flush on the summary trigger to
  tensorboardX event files + a jsonl log.
"""
import pickle
import shutil
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from pb_sed_tpu.parallel.mesh import (
    batch_sharding, get_mesh, pad_batch_to_multiple, replicated_sharding,
    stacked_batch_sharding)
from pb_sed_tpu.train.hooks import EndTrigger, Hook, IntervalTrigger
from pb_sed_tpu.train.optimizer import Adam
from pb_sed_tpu.utils.config import Configurable


class Trainer(Configurable):
    def __init__(self, model, optimizer=None, storage_dir=None,
                 summary_trigger=(100, 'iteration'),
                 checkpoint_trigger=(1000, 'iteration'),
                 stop_trigger=(10000, 'iteration'),
                 keep_checkpoints=1, seed=0, use_mesh=True,
                 loss_scale=None, steps_per_call=1,
                 profile_at=None, profile_num_steps=3):
        self.model = model
        self.optimizer = optimizer if optimizer is not None else Adam()
        self.storage_dir = Path(storage_dir) if storage_dir else None
        self.summary_trigger = IntervalTrigger(summary_trigger)
        self.checkpoint_trigger = IntervalTrigger(checkpoint_trigger)
        self.stop_trigger = EndTrigger(stop_trigger)
        self.keep_checkpoints = keep_checkpoints
        self.seed = seed
        self.iteration = 0
        self.epoch = 0
        self.hooks = []
        self.lr_factor_annealing = 1.
        self.lr_factor_backoff = 1.
        self.validation_hook = None
        self.opt_state = None
        self._device_step_state = None
        self._tx = self.optimizer.make_transform()
        self.steps_per_call = steps_per_call
        # JAX profiler trace around iterations [profile_at,
        # profile_at + profile_num_steps) into storage_dir/profile
        # (SURVEY.md §5: device-time replacement for the reference's
        # wall-clock-only observability)
        self.profile_at = profile_at
        self.profile_num_steps = profile_num_steps
        self._profiling = False
        self._step_fn = None
        self._multi_step_fn = None
        self._val_fn = None
        self._batch_buffer = []
        self._writer = None
        self._summary = _empty_summary()
        self.mesh = get_mesh() if use_mesh else None
        self._rng = jax.random.PRNGKey(seed)
        self._frozen_mask = None

    # ------------------------------------------------------------------
    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['optimizer'] = {'factory': Adam}

    # ------------------------------------------------------------------
    # hooks / validation registration (reference training.py:369-396)
    # ------------------------------------------------------------------
    def register_hook(self, hook):
        assert isinstance(hook, Hook), type(hook)
        self.hooks.append(hook)
        self._step_fn = None  # re-bake (e.g. LR annealing breakpoints)

    def register_validation_hook(
            self, validate_set, metric='loss', maximize=False,
            back_off_patience=None, n_back_off=0, lr_update_factor=1.,
            early_stopping_patience=None):
        self.validation_hook = {
            'validate_set': validate_set,
            'metric': metric,
            'maximize': maximize,
            'back_off_patience': back_off_patience,
            'n_back_off': n_back_off,
            'back_offs_done': 0,
            'lr_update_factor': lr_update_factor,
            'early_stopping_patience': early_stopping_patience,
            'best': -np.inf if maximize else np.inf,
            'validations_since_best': 0,
        }

    def freeze(self, predicate, freeze_norm_stats=True):
        """Freeze parameters whose flat path satisfies ``predicate``
        (transfer-learning layer freezing, reference
        ``training.py:343-350``). Frozen params get zero updates; with
        ``freeze_norm_stats`` the matching batch-norm running stats are
        restored after each step as well."""
        flat = _flatten_with_paths(self.model.params)
        self._frozen_mask = {
            path: bool(predicate(path)) for path, _ in flat}
        if freeze_norm_stats and self.model.batch_stats:
            stats = _flatten_with_paths(self.model.batch_stats)
            self._frozen_stats_mask = {
                path: bool(predicate(path)) for path, _ in stats}
        else:
            self._frozen_stats_mask = None
        self._step_fn = None  # rebuild with the mask baked in

    # ------------------------------------------------------------------
    # jitted step construction
    # ------------------------------------------------------------------
    def _ensure_ready(self, batch):
        if self.model.variables is None:
            device_batch = _device_batch(batch)
            self.model.init_variables(device_batch, seed=self.seed)
        if self.opt_state is None:
            self.opt_state = self._tx.init(self.model.variables['params'])
        if self._step_fn is None:
            self._build_step_fns()

    def _annealing_points(self):
        """Collect LRAnnealingHook breakpoints to bake into the step.

        The schedule runs ON DEVICE against the iteration counter, so
        only ONE iteration-unit hook is supported — anything else must
        fail loudly rather than silently mis-schedule the LR.
        """
        from pb_sed_tpu.train.hooks import LRAnnealingHook
        hooks = [h for h in self.hooks
                 if isinstance(h, LRAnnealingHook) and h.breakpoints]
        if not hooks:
            return None
        if len(hooks) > 1:
            raise NotImplementedError(
                'multiple LRAnnealingHooks: merge the breakpoints into '
                'one hook (the schedule is baked into the jitted step)')
        hook = hooks[0]
        if hook.unit != 'iteration':
            raise NotImplementedError(
                f'LRAnnealingHook(unit={hook.unit!r}): the baked-in '
                f'schedule interpolates over ITERATIONS')
        xs = np.array([float(x) for x, _ in hook.breakpoints])
        ys = np.array([float(y) for _, y in hook.breakpoints])
        return xs, ys

    def _build_step_fns(self):
        model = self.model
        tx = self._tx
        frozen = self._frozen_mask
        frozen_stats = getattr(self, '_frozen_stats_mask', None)
        base_lr = float(self.optimizer.lr)
        annealing = self._annealing_points()

        def step_body(variables, opt_state, batch, rng, iteration,
                      lr_scale):
            # Everything that changes per step (rng, iteration, LR
            # annealing) lives in device-resident args advanced ON DEVICE:
            # per-step host->device transfers serialize the dispatch
            # pipeline.
            step_rng = jax.random.fold_in(rng, 0)
            rngs = {'augment': jax.random.fold_in(step_rng, 0),
                    'dropout': jax.random.fold_in(step_rng, 1)}
            next_rng = jax.random.fold_in(rng, 1)
            lr = base_lr * lr_scale
            if annealing is not None:
                lr = lr * jnp.interp(
                    iteration.astype(jnp.float32),
                    jnp.asarray(annealing[0], jnp.float32),
                    jnp.asarray(annealing[1], jnp.float32))

            def loss_of(params):
                vs = dict(variables)
                vs['params'] = params
                return model.loss_fn(vs, batch, rngs, training=True)

            (loss, aux), grads = jax.value_and_grad(
                loss_of, has_aux=True)(variables['params'])
            mutated, scalars, buffers, images = aux
            updates, opt_state = tx.update(
                grads, opt_state, variables['params'])
            if frozen is not None:
                updates = _mask_frozen(updates, frozen)
            grad_norm = optax_global_norm(grads)
            params = jax.tree_util.tree_map(
                lambda p, u: p - lr * u, variables['params'], updates)
            new_vars = dict(variables)
            new_vars['params'] = params
            if 'batch_stats' in mutated:
                new_bs = mutated['batch_stats']
                if frozen_stats is not None:
                    new_bs = _restore_frozen(
                        new_bs, variables.get('batch_stats', {}),
                        frozen_stats)
                new_vars['batch_stats'] = new_bs
            scalars = dict(scalars)
            scalars['grad_norm'] = grad_norm
            scalars['lr'] = lr
            return (new_vars, opt_state, next_rng, iteration + 1,
                    loss, scalars, buffers, images)

        train_step = step_body

        def train_multi_step(variables, opt_state, batches, rng,
                             iteration, lr_scale):
            """K train steps in one XLA program: lax.scan over stacked
            batches (K, B, ...) amortizes per-call dispatch overhead and
            lets XLA overlap the steps' host-independent work."""

            def body(carry, batch):
                variables, opt_state, rng, iteration = carry
                (new_vars, opt_state, next_rng, next_it, loss, scalars,
                 buffers, images) = step_body(
                    variables, opt_state, batch, rng, iteration, lr_scale)
                return ((new_vars, opt_state, next_rng, next_it),
                        (loss, scalars, buffers, images))

            (variables, opt_state, rng, iteration), (
                losses, scalars, buffers, images) = jax.lax.scan(
                body, (variables, opt_state, rng, iteration), batches)
            # keep only the last step's images (summaries show one grid)
            images = jax.tree_util.tree_map(lambda x: x[-1], images)
            return (variables, opt_state, rng, iteration, losses,
                    scalars, buffers, images)

        def val_step(variables, batch):
            loss, aux = model.loss_fn(variables, batch, rngs={},
                                      training=False)
            _, scalars, buffers, images = aux
            return loss, scalars, buffers, images

        if self.mesh is not None and len(self.mesh.devices.flat) > 1:
            repl = replicated_sharding(self.mesh)
            data = batch_sharding(self.mesh)
            # stacked batches are (K, B, ...): shard the trailing batch
            # axis so the multi-step lane is data-parallel like the
            # single-step lane
            stacked_data = stacked_batch_sharding(self.mesh)
            self._step_fn = jax.jit(
                train_step,
                in_shardings=(repl, repl, data, repl, repl, repl),
                out_shardings=(repl,) * 8,
                donate_argnums=(0, 1, 3),
            )
            self._val_fn = jax.jit(
                val_step, in_shardings=(repl, data),
            )
            self._multi_step_fn = jax.jit(
                train_multi_step,
                in_shardings=(repl, repl, stacked_data, repl, repl, repl),
                out_shardings=(repl,) * 8,
                donate_argnums=(0, 1, 3),
            )
        else:
            self._step_fn = jax.jit(train_step, donate_argnums=(0, 1, 3))
            self._val_fn = jax.jit(val_step)
            self._multi_step_fn = jax.jit(
                train_multi_step, donate_argnums=(0, 1, 3))
        self._device_step_state = None

    @property
    def learning_rate(self):
        return (self.optimizer.lr * self.lr_factor_annealing
                * self.lr_factor_backoff)

    def _sync_step_state(self):
        """(Re)materialize the device-resident per-step state. Called on
        start/resume and whenever a host-side factor changes (back-off) —
        NOT per step."""
        self._device_step_state = (
            # copy: the step donates its rng buffer
            jnp.array(np.asarray(self._rng)),
            jnp.asarray(self.iteration, jnp.int32),
            jnp.asarray(self.lr_factor_backoff, jnp.float32),
        )

    # ------------------------------------------------------------------
    # train loop
    # ------------------------------------------------------------------
    def train(self, train_set, resume=False, device=None,
              track_emissions=False):
        del device  # devices come from the mesh
        tracker = None
        if track_emissions and self.storage_dir is not None:
            from pb_sed_tpu.train.emissions import EmissionsTracker
            tracker = EmissionsTracker(output_dir=self.storage_dir)
            tracker.start()
        if resume:
            self.load_latest_checkpoint()
        try:
            while not self.stop_trigger(self.iteration, self.epoch):
                for batch in train_set:
                    if self.stop_trigger(self.iteration, self.epoch):
                        break
                    if self.steps_per_call > 1:
                        self._enqueue_batch(batch)
                    else:
                        self.train_step(batch)
                self._drain_batch_buffer()
                self.epoch += 1
            # final checkpoint + validation (resuming an already-
            # finished run never builds the jitted fns: skip cleanly)
            self._flush_summary(prefix='training')
            if self.validation_hook is not None and self._val_fn is not None:
                self.validate()
            self.save_checkpoint()
        finally:
            self._maybe_stop_profile(force=True)
            if tracker is not None:
                tracker.stop()
            if self._writer is not None:
                self._writer.flush()

    def _maybe_start_profile(self):
        # crossing condition (>=): the multi-step lane advances the
        # iteration in strides and can step over an exact profile_at
        if (self.profile_at is not None and not self._profiling
                and not getattr(self, '_profile_done', False)
                and self.iteration + 1 >= self.profile_at
                and self.storage_dir is not None):
            logdir = self.storage_dir / 'profile'
            logdir.mkdir(parents=True, exist_ok=True)
            jax.profiler.start_trace(str(logdir))
            self._profiling = True

    def _maybe_stop_profile(self, force=False):
        if self._profiling and (
                force or self.iteration
                >= self.profile_at + self.profile_num_steps):
            jax.block_until_ready(self.model.variables)
            jax.profiler.stop_trace()
            self._profiling = False
            self._profile_done = True
            logdir = self.storage_dir / 'profile'
            print(f'Profiler trace written to {logdir}')
            from pb_sed_tpu.utils.xplane import device_step_times_ms
            times = device_step_times_ms(logdir)
            print(f'Device time per step (trace): '
                  f'{[round(t, 3) for t in times]} ms')

    def train_step(self, batch):
        self._ensure_ready(batch)
        self._maybe_start_profile()
        if self._profiling:
            with jax.profiler.StepTraceAnnotation(
                    'train', step_num=self.iteration):
                return self._train_step(batch)
        return self._train_step(batch)

    def _train_step(self, batch):
        for hook in self.hooks:
            hook.pre_step(self)
        mesh_size = (len(self.mesh.devices.flat)
                     if self.mesh is not None else 1)
        batch, _ = pad_batch_to_multiple(batch, mesh_size)
        device_batch = _device_batch(batch, self.mesh)
        if self._device_step_state is None:
            self._sync_step_state()
        rng, iteration, lr_scale = self._device_step_state
        (variables, self.opt_state, next_rng, next_iteration, loss,
         scalars, buffers, images) = self._step_fn(
            self.model.variables, self.opt_state, device_batch,
            rng, iteration, lr_scale)
        self._device_step_state = (next_rng, next_iteration, lr_scale)
        self.model.variables = variables
        self.iteration += 1
        self._accumulate_summary(loss, scalars, buffers, images)
        if self.summary_trigger(self.iteration, self.epoch):
            self._flush_summary(prefix='training')
        if self.checkpoint_trigger(self.iteration, self.epoch):
            self.save_checkpoint()
            if self.validation_hook is not None:
                self.validate()
        for hook in self.hooks:
            hook.post_step(self, batch, loss, None)
        self._maybe_stop_profile()
        return loss

    # ------------------------------------------------------------------
    # multi-step lane (steps_per_call > 1)
    # ------------------------------------------------------------------
    def _enqueue_batch(self, batch):
        if self._batch_buffer and not _same_shapes(
                self._batch_buffer[0], batch):
            self._drain_batch_buffer()
        self._batch_buffer.append(batch)
        if len(self._batch_buffer) >= self.steps_per_call:
            self._drain_batch_buffer()

    def _drain_batch_buffer(self):
        batches, self._batch_buffer = self._batch_buffer, []
        if not batches:
            return
        if len(batches) == 1:
            self.train_step(batches[0])
            return
        self.train_steps(batches)

    def train_steps(self, batches):
        """Run len(batches) train steps as ONE jitted lax.scan call."""
        self._ensure_ready(batches[0])
        self._maybe_start_profile()
        for hook in self.hooks:
            hook.pre_step(self)
        mesh_size = (len(self.mesh.devices.flat)
                     if self.mesh is not None else 1)
        padded = [pad_batch_to_multiple(b, mesh_size)[0] for b in batches]
        keys = [k for k, v in padded[0].items()
                if isinstance(v, (np.ndarray, jnp.ndarray))]
        if self.mesh is not None and jax.process_count() > 1:
            # host-local arrays can't be resharded to a multi-host
            # NamedSharding at dispatch: assemble each (K, B_local, ...)
            # stack into a GLOBAL (K, B_global, ...) array (batch axis
            # sharded, steps axis replicated) like _device_batch does
            # for the single-step lane
            sharding = stacked_batch_sharding(self.mesh)
            stacked = {
                k: jax.make_array_from_process_local_data(
                    sharding,
                    np.stack([np.asarray(b[k]) for b in padded]))
                for k in keys
            }
        else:
            stacked = {
                k: jnp.stack([jnp.asarray(b[k]) for b in padded])
                for k in keys
            }
        if self._device_step_state is None:
            self._sync_step_state()
        rng, iteration, lr_scale = self._device_step_state
        (variables, self.opt_state, next_rng, next_iteration, losses,
         scalars, buffers, images) = self._multi_step_fn(
            self.model.variables, self.opt_state, stacked,
            rng, iteration, lr_scale)
        self._device_step_state = (next_rng, next_iteration, lr_scale)
        self.model.variables = variables
        self.iteration += len(batches)
        # scalars/losses are (K,)-stacked; buffers (K, B, ...) -> (K*B,...)
        flat_buffers = jax.tree_util.tree_map(
            lambda x: x.reshape((-1,) + x.shape[2:]), buffers)
        self._accumulate_summary(losses, scalars, flat_buffers, images)
        if self.summary_trigger(self.iteration, self.epoch):
            self._flush_summary(prefix='training')
        if self.checkpoint_trigger(self.iteration, self.epoch):
            self.save_checkpoint()
            if self.validation_hook is not None:
                self.validate()
        for hook in self.hooks:
            hook.post_step(self, batches[-1], losses, None)
        self._maybe_stop_profile()
        return losses

    # ------------------------------------------------------------------
    # validation (metric tracking, back-off, early stopping, best ckpt)
    # ------------------------------------------------------------------
    def validate(self):
        hook = self.validation_hook
        summary = _empty_summary()
        mesh_size = (len(self.mesh.devices.flat)
                     if self.mesh is not None else 1)
        for batch in hook['validate_set']:
            batch, _ = pad_batch_to_multiple(batch, mesh_size)
            device_batch = _device_batch(batch, self.mesh)
            loss, scalars, buffers, images = self._val_fn(
                self.model.variables, device_batch)
            _merge_summary(summary, self.model, loss, scalars, buffers,
                           images)
        summary = self.model.modify_summary(summary)
        self._write_summary(summary, prefix='validation')
        metric_name = hook['metric']
        value = summary['scalars'].get(metric_name)
        assert value is not None, (
            metric_name, sorted(summary['scalars']))
        improved = (value > hook['best'] if hook['maximize']
                    else value < hook['best'])
        if improved:
            hook['best'] = value
            hook['validations_since_best'] = 0
            self.save_checkpoint(name=f'ckpt_best_{metric_name}.pkl')
        else:
            hook['validations_since_best'] += 1
            patience = hook['back_off_patience']
            if (patience is not None
                    and hook['back_offs_done'] < hook['n_back_off']
                    and hook['validations_since_best'] >= patience):
                self.lr_factor_backoff *= hook['lr_update_factor']
                hook['back_offs_done'] += 1
                hook['validations_since_best'] = 0
                self._sync_step_state()  # push new lr scale to device
                print(f'Backing off lr to {self.learning_rate}')
        print(f'Validation {metric_name}: {value:.4f} '
              f'(best {hook["best"]:.4f})')
        es = hook['early_stopping_patience']
        if es is not None and hook['validations_since_best'] >= es:
            print('Early stopping')
            self.stop_trigger.period = 0
        return value

    # ------------------------------------------------------------------
    # test run (padertorch dry-run contract, reference training.py:368)
    # ------------------------------------------------------------------
    def test_run(self, train_set, validate_set=None):
        """Side-effect-free forward/backward sanity pass (reference
        ``trainer.test_run``, experiments/weak_label_crnn/training.py:368).

        Runs the jitted step on *copies* of the training state (the step
        donates its inputs) and discards the result, so no optimizer
        update is applied, no trigger fires, and no checkpoint is
        written — a later ``train(resume=True)`` still sees the original
        ``ckpt_latest``.
        """
        print('Starting test run')
        batch = next(iter(train_set))
        self._ensure_ready(batch)
        mesh_size = (len(self.mesh.devices.flat)
                     if self.mesh is not None else 1)
        tbatch, _ = pad_batch_to_multiple(batch, mesh_size)
        if self._device_step_state is None:
            self._sync_step_state()
        rng, iteration, lr_scale = self._device_step_state
        out = self._step_fn(
            jax.tree.map(jnp.copy, self.model.variables),
            jax.tree.map(jnp.copy, self.opt_state),
            _device_batch(tbatch, self.mesh), jnp.copy(rng), iteration,
            lr_scale)
        loss = out[4]
        assert np.isfinite(float(loss)), float(loss)
        if validate_set is not None:
            vbatch = next(iter(validate_set))
            vbatch, _ = pad_batch_to_multiple(vbatch, mesh_size)
            vloss, *_ = self._val_fn(
                self.model.variables,
                _device_batch(vbatch, self.mesh))
            assert np.isfinite(float(vloss)), float(vloss)
        self._device_step_state = None  # reset device iteration counter
        print('Finished test run')

    # ------------------------------------------------------------------
    # summaries
    # ------------------------------------------------------------------
    def _accumulate_summary(self, loss, scalars, buffers, images):
        # keep everything as device arrays: converting here would force a
        # host sync every step and stall the async dispatch pipeline
        s = self._summary
        s['scalars'].setdefault('loss', []).append(loss)
        for key, value in scalars.items():
            s['scalars'].setdefault(key, []).append(value)
        s.setdefault('_raw', []).append(buffers)
        s['images'] = images

    def _flush_summary(self, prefix):
        if not self._summary['scalars']:
            return
        s = self._summary
        # device -> host conversion happens only here (once per trigger);
        # multi-step entries arrive (K,)-stacked -> mean
        s['scalars'] = {
            key: [float(np.mean(np.asarray(v))) for v in values]
            for key, values in s['scalars'].items()
        }
        now = time.time()
        last_flush = getattr(self, '_last_flush', None)
        if last_flush is not None:
            it_last, t_last = last_flush
            elapsed = max(now - t_last, 1e-9)
            s['scalars']['steps_per_second'] = [
                (self.iteration - it_last) / elapsed]
        self._last_flush = (self.iteration, now)
        for buffers in s.pop('_raw', []):
            if hasattr(self.model, 'review_from_aux'):
                review = self.model.review_from_aux(
                    s['scalars']['loss'][0], (None, {}, buffers, {}))
                for key, value in review['buffers'].items():
                    s['buffers'].setdefault(key, []).append(value)
        s['images'] = {k: np.asarray(v) for k, v in s['images'].items()}
        summary = self.model.modify_summary(s)
        self._write_summary(summary, prefix=prefix)
        self._summary = _empty_summary()

    def _write_summary(self, summary, prefix):
        if self.storage_dir is None:
            return
        if self._writer is None:
            try:
                from tensorboardX import SummaryWriter
                self._writer = SummaryWriter(logdir=str(self.storage_dir))
            except ImportError:
                self._writer = False
        scalars = summary['scalars']
        if self._writer:
            for key, value in scalars.items():
                self._writer.add_scalar(
                    f'{prefix}/{key}', value, self.iteration)
            for key, image in summary.get('images', {}).items():
                if image is not None and np.ndim(image) == 2:
                    self._writer.add_image(
                        f'{prefix}/{key}', image[None], self.iteration)
        log_path = self.storage_dir / 'summary.jsonl'
        with log_path.open('a') as fid:
            import json
            fid.write(json.dumps({
                'iteration': self.iteration, 'prefix': prefix,
                'time': time.time(),
                **{k: v for k, v in scalars.items()},
            }) + '\n')

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------
    @property
    def checkpoint_dir(self):
        assert self.storage_dir is not None
        return self.storage_dir / 'checkpoints'

    def save_checkpoint(self, name=None):
        if self.storage_dir is None:
            return
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        if self._device_step_state is not None:
            # the live key advances ON DEVICE inside the jitted step;
            # pull it back so resume continues the augment/dropout RNG
            # stream instead of replaying it from the initial seed
            self._rng = jnp.asarray(
                np.asarray(self._device_step_state[0]))
        payload = {
            'model': self.model.state_dict(),
            'iteration': self.iteration,
            'epoch': self.epoch,
            'lr_factor_backoff': self.lr_factor_backoff,
            'optimizer': _tree_to_numpy(self.opt_state),
            'rng': np.asarray(self._rng),
        }
        if name is None:
            path = self.checkpoint_dir / f'ckpt_{self.iteration}.pkl'
            with path.open('wb') as fid:
                pickle.dump(payload, fid)
            shutil.copyfile(path, self.checkpoint_dir / 'ckpt_latest.pkl')
            self._prune_checkpoints()
        else:
            with (self.checkpoint_dir / name).open('wb') as fid:
                pickle.dump(payload, fid)

    def _prune_checkpoints(self):
        ckpts = sorted(
            self.checkpoint_dir.glob('ckpt_[0-9]*.pkl'),
            key=lambda p: int(p.stem.split('_')[1]))
        for path in ckpts[:-max(self.keep_checkpoints, 1)]:
            path.unlink()

    def load_latest_checkpoint(self):
        path = self.checkpoint_dir / 'ckpt_latest.pkl'
        if not path.exists():
            print('No checkpoint to resume from')
            return False
        with path.open('rb') as fid:
            payload = pickle.load(fid)
        self.model.load_state_dict(payload['model'], strict=False)
        self.iteration = payload['iteration']
        self.epoch = payload.get('epoch', 0)
        self.lr_factor_backoff = payload.get('lr_factor_backoff', 1.)
        if payload.get('optimizer') is not None:
            if self.opt_state is None:
                self.opt_state = self._tx.init(
                    self.model.variables['params'])
            self.opt_state = _restore_opt_state(
                self.opt_state, payload['optimizer'])
        if payload.get('rng') is not None:
            self._rng = jnp.asarray(payload['rng'])
        # re-align interval triggers with the restored iteration so the
        # first post-resume step doesn't immediately fire checkpoint /
        # summary / validation
        for trigger in (self.checkpoint_trigger, self.summary_trigger):
            if trigger.unit == 'iteration':
                trigger.last = self.iteration
        self._device_step_state = None
        print(f'Resumed from iteration {self.iteration}')
        return True


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------
def _empty_summary():
    return {'scalars': {}, 'buffers': {}, 'images': {}}


def _same_shapes(batch_a, batch_b):
    for key, value in batch_a.items():
        if isinstance(value, (np.ndarray, jnp.ndarray)):
            other = batch_b.get(key)
            if other is None or np.shape(other) != np.shape(value):
                return False
    return True


def _merge_summary(summary, model, loss, scalars, buffers, images):
    summary['scalars'].setdefault('loss', []).append(float(loss))
    for key, value in scalars.items():
        summary['scalars'].setdefault(key, []).append(
            float(np.asarray(value)))
    if hasattr(model, 'review_from_aux'):
        review = model.review_from_aux(loss, (None, {}, buffers, {}))
        for key, value in review['buffers'].items():
            summary['buffers'].setdefault(key, []).append(value)
    summary['images'] = {k: np.asarray(v) for k, v in images.items()}


def _device_batch(batch, mesh=None):
    if mesh is not None and jax.process_count() > 1:
        # multi-process: assemble host-local shards into global arrays
        from pb_sed_tpu.parallel.mesh import make_global_batch
        return make_global_batch(batch, mesh)
    return {k: jnp.asarray(v) for k, v in batch.items()
            if isinstance(v, (np.ndarray, jnp.ndarray))
            or (isinstance(v, (int, float)) and not isinstance(v, bool))}


def optax_global_norm(tree):
    leaves = jax.tree_util.tree_leaves(tree)
    return jnp.sqrt(sum(jnp.sum(jnp.square(x)) for x in leaves))


def _flatten_with_paths(tree, prefix=''):
    out = []
    if isinstance(tree, dict):
        for key, value in tree.items():
            out.extend(_flatten_with_paths(
                value, f'{prefix}.{key}' if prefix else str(key)))
    else:
        out.append((prefix, tree))
    return out


def _restore_frozen(new_tree, old_tree, frozen_mask):
    def restore(path, new, old):
        if isinstance(new, dict):
            return {k: restore(f'{path}.{k}' if path else k,
                               v, old.get(k, v) if isinstance(old, dict)
                               else v)
                    for k, v in new.items()}
        return old if frozen_mask.get(path) else new
    return restore('', new_tree, old_tree)


def _mask_frozen(updates, frozen_mask):
    def mask(path, value):
        if isinstance(value, dict):
            return {k: mask(f'{path}.{k}' if path else k, v)
                    for k, v in value.items()}
        return jnp.zeros_like(value) if frozen_mask.get(path) else value
    return mask('', updates)


def _tree_to_numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _restore_opt_state(template, saved):
    leaves_t, treedef = jax.tree_util.tree_flatten(template)
    leaves_s = jax.tree_util.tree_leaves(saved)
    assert len(leaves_t) == len(leaves_s), (len(leaves_t), len(leaves_s))
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(s) for s in leaves_s])
