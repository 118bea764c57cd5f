"""CNN stacks: masked-norm 2-D + 1-D convolutional towers.

Capability parity with padertorch ``contrib.je.modules.hybrid.CNN`` (=
``CNN2d`` stack + flatten + ``CNN1d`` stack) as configured by the reference
(``experiments/weak_label_crnn/training.py:158-185,218-242``): per-layer
``out_channels`` / ``kernel_size`` / ``pool_size`` lists, residual
connection index lists, masked batch norm with eps, pre-activation ReLU,
dropout, ``output_layer`` flag, ``input_height``, tag conditioning via
``conditional_dims``, and layer freezing for transfer learning (handled in
the trainer via parameter-label masks, see train/trainer.py).

Data layout is (B, T, F, C) / (B, T, C) (channels-last convolutions);
batch-norm statistics are computed with
explicit sequence masks (padded batches must not pollute the running
stats); the reference's "(2, 1) pool" notation (freq x time in its (B, C,
F, T) layout) is preserved in configs and mapped to our layout internally.
"""
from typing import Any, Sequence, Union

import jax
import jax.numpy as jnp

from pb_sed_tpu import nn
from pb_sed_tpu.ops.masking import sequence_mask
from pb_sed_tpu.utils.config import Configurable
from pb_sed_tpu.utils.misc import to_list


class MaskedBatchNorm(nn.Module):
    """Batch norm whose statistics only see valid frames.

    Normalizes per channel over batch x valid-time (x freq for 4-D input).
    """
    eps: float = 1e-3
    momentum: float = 0.95

    def __call__(self, x, seq_len, training=False):
        c = x.shape[-1]
        ra_mean = self.variable('batch_stats', 'mean',
                                lambda: jnp.zeros((c,)))
        ra_var = self.variable('batch_stats', 'var', lambda: jnp.ones((c,)))
        initialized = self.variable('batch_stats', 'initialized',
                                    lambda: jnp.zeros(()))
        gamma = self.param('scale', nn.initializers.ones, (c,))
        beta = self.param('shift', nn.initializers.zeros, (c,))
        mask = sequence_mask(seq_len, x.shape[1])  # (B, T)
        mask = mask.reshape(mask.shape + (1,) * (x.ndim - 2))
        # f32 statistics and normalize regardless of input dtype:
        # bf16-accumulated moments/counts would be garbage at flagship
        # element counts. Single-pass sum / sum-of-squares form (the
        # reference BN kernels' own formulation), clamped at 0 against
        # cancellation: the two moment reductions are independent
        # siblings over one buffer, which XLA fuses into one read.
        xf = x.astype(jnp.float32)
        mf = mask.astype(jnp.float32)
        if training:
            axes = tuple(range(x.ndim - 1))
            count = jnp.maximum(
                (mf * jnp.ones(x.shape, jnp.float32)).sum(axes), 1.)
            mean = (xf * mf).sum(axes) / count
            var = jnp.maximum(
                (jnp.square(xf) * mf).sum(axes) / count
                - jnp.square(mean), 0.)
            momentum = jnp.where(initialized.value > 0, self.momentum, 0.)
            ra_mean.value = momentum * ra_mean.value + (1 - momentum) * mean
            ra_var.value = momentum * ra_var.value + (1 - momentum) * var
            initialized.value = jnp.ones(())
        else:
            mean = ra_mean.value
            var = ra_var.value
        return (xf - mean) * jax.lax.rsqrt(var + self.eps) * gamma + beta


def _act(name):
    if name in (None, 'identity', 'linear'):
        return lambda x: x
    return getattr(jax.nn, name)


def _dtype(name):
    if name in (None, 'float32'):
        return jnp.float32
    return jnp.dtype(name)


def _pool_fp_tp(pool):
    """Reference pool notation -> (freq_pool, time_pool) ints."""
    if isinstance(pool, (tuple, list)):
        pf, pt = pool
    else:
        pf = pt = pool
    return int(pf), int(pt)


def _pool2d(x, pool):
    """Pool with reference notation: pool = (freq, time) or scalar."""
    if isinstance(pool, (tuple, list)):
        pf, pt = pool
    else:
        pf = pt = pool
    if pf == 1 and pt == 1:
        return x
    # x: (B, T, F, C); reference pools are max pools
    return nn.max_pool(x, window_shape=(pt, pf), strides=(pt, pf))


def _match_residual(res, shape):
    """Adapt a saved residual to target ``shape``: average-pool
    mismatched T/F dims and zero-pad grown channel counts (identity
    skips across the deep config's channel-doubling boundaries,
    reference residual lists at ``training.py:171-178``)."""
    if res.shape == tuple(shape):
        return res
    if res.ndim == 4:
        st = res.shape[1] // shape[1] or 1
        sf = res.shape[2] // shape[2] or 1
        if st > 1 or sf > 1:
            res = nn.avg_pool(res, window_shape=(st, sf),
                              strides=(st, sf))
    else:
        st = res.shape[1] // shape[1] or 1
        if st > 1:
            res = nn.avg_pool(res, window_shape=(st,), strides=(st,))
    grow = shape[-1] - res.shape[-1]
    assert grow >= 0, (res.shape, shape)
    if grow:
        width = [(0, 0)] * (res.ndim - 1) + [(0, grow)]
        res = jnp.pad(res, width)
    return res


class CNN2d(nn.Module, Configurable):
    """Stack of 2-D convolutions over (time, freq).

    ``compute_dtype='bfloat16'`` runs the convolutions in bf16 (params
    and norm statistics stay float32).
    """
    out_channels: Sequence[int]
    kernel_size: Union[int, Sequence[int]] = 3
    pool_size: Union[int, Sequence[Any]] = 1
    residual_connections: Sequence[Any] = None
    norm: str = 'batch'
    norm_kwargs: dict = None
    activation_fn: str = 'relu'
    pre_activation: bool = False
    dropout: float = 0.
    output_layer: bool = False
    compute_dtype: str = 'bfloat16'
    in_channels: int = None      # informational (finalize glue)
    input_height: int = None     # informational

    def __call__(self, x, seq_len, training=False):
        n = len(self.out_channels)
        kernels = to_list(self.kernel_size, n)
        pools = to_list(
            list(self.pool_size) if isinstance(self.pool_size, (list, tuple))
            and len(self.pool_size) == n else self.pool_size, n)
        residuals = to_list(
            self.residual_connections if self.residual_connections
            else None, n)
        act = _act(self.activation_fn)
        norm_kwargs = self.norm_kwargs or {}
        pending = {}
        for i in range(n):
            is_output = self.output_layer and i == n - 1
            h = x
            if self.pre_activation and not is_output:
                if self.norm == 'batch':
                    h = MaskedBatchNorm(
                        **norm_kwargs, name=f'norm_{i}')(
                            h, seq_len, training)
                h = act(h)
                if self.dropout > 0 and training:
                    h = nn.Dropout(self.dropout)(h)
            k = kernels[i]
            kt, kf = (k, k) if not isinstance(k, (tuple, list)) else k
            h = nn.Conv(self.out_channels[i], kernel_size=(kt, kf),
                        name=f'conv_{i}',
                        dtype=_dtype(self.compute_dtype))(h)
            h = h.astype(jnp.float32)
            if not self.pre_activation and not is_output:
                if self.norm == 'batch':
                    h = MaskedBatchNorm(
                        **norm_kwargs, name=f'norm_{i}')(
                            h, seq_len, training)
                h = act(h)
                if self.dropout > 0 and training:
                    h = nn.Dropout(self.dropout)(h)
            if i in pending:
                for res in pending.pop(i):
                    h = h + _match_residual(res, h.shape)
            if residuals[i] is not None:
                pending.setdefault(int(residuals[i]), []).append(h)
            pool = pools[i]
            h = _pool2d(h, pool)
            if isinstance(pool, (tuple, list)):
                pt = pool[1]
            else:
                pt = pool
            if pt > 1:
                seq_len = -(-seq_len // pt)
            x = h
        return x, seq_len


class CNN1d(nn.Module, Configurable):
    """Stack of 1-D convolutions over time ((B, T, C) layout)."""
    out_channels: Sequence[int]
    kernel_size: Union[int, Sequence[int]] = 3
    pool_size: Union[int, Sequence[int]] = 1
    residual_connections: Sequence[Any] = None
    norm: str = 'batch'
    norm_kwargs: dict = None
    activation_fn: str = 'relu'
    pre_activation: bool = False
    dropout: float = 0.
    output_layer: bool = False
    compute_dtype: str = 'bfloat16'
    in_channels: int = None  # informational

    def __call__(self, x, seq_len, training=False):
        n = len(self.out_channels)
        kernels = to_list(
            list(self.kernel_size) if isinstance(
                self.kernel_size, (list, tuple)) else self.kernel_size, n)
        pools = to_list(self.pool_size, n)
        residuals = to_list(
            self.residual_connections if self.residual_connections
            else None, n)
        act = _act(self.activation_fn)
        norm_kwargs = self.norm_kwargs or {}
        pending = {}
        for i in range(n):
            is_output = self.output_layer and i == n - 1
            h = x
            if self.pre_activation and not is_output:
                if self.norm == 'batch':
                    h = MaskedBatchNorm(
                        **norm_kwargs, name=f'norm_{i}')(
                            h, seq_len, training)
                h = act(h)
                if self.dropout > 0 and training:
                    h = nn.Dropout(self.dropout)(h)
            h = nn.Conv(self.out_channels[i], kernel_size=(kernels[i],),
                        name=f'conv_{i}',
                        dtype=_dtype(self.compute_dtype))(h)
            h = h.astype(jnp.float32)
            if not self.pre_activation and not is_output:
                if self.norm == 'batch':
                    h = MaskedBatchNorm(
                        **norm_kwargs, name=f'norm_{i}')(
                            h, seq_len, training)
                h = act(h)
                if self.dropout > 0 and training:
                    h = nn.Dropout(self.dropout)(h)
            if i in pending:
                for res in pending.pop(i):
                    h = h + _match_residual(res, h.shape)
            if residuals[i] is not None:
                pending.setdefault(int(residuals[i]), []).append(h)
            if pools[i] > 1:
                h = nn.max_pool(h, window_shape=(pools[i],),
                                strides=(pools[i],))
                seq_len = -(-seq_len // pools[i])
            x = h
        return x, seq_len


class CNN(nn.Module, Configurable):
    """2-D tower -> flatten freq into channels -> 1-D tower.

    Mirrors the reference hybrid CNN: input (B, T, F) features are lifted to
    (B, T, F, C=1[+cond]) for the 2-D stack; the surviving freq bins are
    folded into channels for the 1-D stack. Output is (B, T, C_1d).
    """
    cnn_2d: dict
    cnn_1d: dict
    input_height: int = None
    positional_encoding: bool = False
    conditional_dims: int = 0

    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['cnn_2d'] = {'factory': CNN2d}
        config['cnn_1d'] = {'factory': CNN1d}

    def setup(self):
        def build(spec, cls):
            if isinstance(spec, cls):
                return spec
            cfg = dict(spec)
            cfg.pop('factory', None)
            return cls(**cfg)

        self.tower_2d = build(self.cnn_2d, CNN2d)
        self.tower_1d = build(self.cnn_1d, CNN1d)

    def __call__(self, x, seq_len, condition=None, training=False):
        """
        Args:
            x: (B, T, F) features, or (B, T, F, C) with delta channels
                (``NormalizedLogMelExtractor.add_deltas``).
            seq_len: (B,) valid frames.
            condition: optional (B, K) conditioning vector (tag condition,
                reference ``strong_label/crnn.py:85-86``).
        Returns: (B, T, C) embedding, updated seq_len.
        """
        h = x[..., None] if x.ndim == 3 else x  # (B, T, F, C)
        b, t, f = h.shape[:3]
        if self.positional_encoding:
            pos = jnp.linspace(-1., 1., f).reshape(1, 1, f, 1)
            h = jnp.concatenate(
                [h, jnp.broadcast_to(pos, (b, t, f, 1))], axis=-1)
        if self.conditional_dims and condition is not None:
            cond = jnp.broadcast_to(
                condition[:, None, None, :], (b, t, f, condition.shape[-1]))
            h = jnp.concatenate([h, cond], axis=-1)
        h, seq_len = self.tower_2d(h, seq_len, training=training)
        b, t2, f2, c2 = h.shape
        h = h.reshape(b, t2, f2 * c2)
        h, seq_len = self.tower_1d(h, seq_len, training=training)
        return h, seq_len
