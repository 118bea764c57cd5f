"""Recurrent heads: GRU (and a Transformer alternative) + 1x1-conv output net.

Capability parity with padertorch ``contrib.je.modules.rnn.{GRU,
TransformerEncoder}`` as used by the reference models
(``pb_sed/models/weak_label/crnn.py:320-340``,
``strong_label/crnn.py:171-198``): multi-layer GRU with torch gate
semantics, optional bidirectionality, optional construction as a
*time-reversed* copy (the FBCRNN backward head), and a CNN1d output net.

The input projections of every timestep are computed as one large
(B*T, F) x (F, 3H) bf16 matmul *outside* the recurrence; ``lax.scan``
then only carries the (B, H) x (H, 3H) recurrent matmul per step.
Sequences are padded; the reversed/bidirectional paths use mask-aware
sequence reversal so padding never leaks into the recurrence from the
front.
"""

import jax
import jax.numpy as jnp

from pb_sed_tpu import nn
from pb_sed_tpu.ops.cnn import CNN1d
from pb_sed_tpu.ops.masking import reverse_sequence
from pb_sed_tpu.utils.config import Configurable


# timesteps per scan iteration: on an H100 at D=2, B=32, T=501, H=256
# the forward+grad recurrence takes 11.0 ms at 8 against 27.2 ms at 1
# (16: 10.8 ms at twice the unrolled body; PERF.md, GRU recurrence)
_SCAN_UNROLL = 8


def gru_scan(xw, w_hh, b_hh, h0):
    """GRU recurrence with torch gate order (r, z, n) over D independent
    directions: (D, B, T, 3H) input projections (input bias included),
    (D, H, 3H) recurrent weights, (D, 1, 3H) recurrent bias and
    (D, B, H) initial state -> (D, B, T, H) hidden states. The
    recurrent matmul runs in bf16 with f32 accumulation; gates and state
    stay f32."""
    t = xw.shape[2]
    w_hh_c = w_hh.astype(jnp.bfloat16)

    def step(h, xw_t):  # h: (D, B, H), xw_t: (D, B, 3H)
        hw = jnp.einsum(
            'dbh,dhg->dbg', h.astype(jnp.bfloat16), w_hh_c,
            preferred_element_type=jnp.float32) + b_hh
        xr, xz, xn = jnp.split(xw_t, 3, axis=-1)
        hr, hz, hn = jnp.split(hw, 3, axis=-1)
        r = jax.nn.sigmoid(xr + hr)
        z = jax.nn.sigmoid(xz + hz)
        n = jnp.tanh(xn + r * hn)
        h_new = (1. - z) * n + z * h
        return h_new, h_new

    _, ys = jax.lax.scan(step, h0, jnp.moveaxis(xw, 2, 0),
                         unroll=min(_SCAN_UNROLL, t))  # (T, D, B, H)
    return jnp.moveaxis(ys, 0, 2)


class GRULayer(nn.Module):
    """Single unidirectional GRU layer: (B, T, F) -> (B, T, H)."""
    hidden_size: int
    bias: bool = True

    def __call__(self, x):
        b, t, f = x.shape
        hdim = self.hidden_size
        w_ih = self.param('w_ih', nn.initializers.lecun_normal(),
                          (f, 3 * hdim))
        w_hh = self.param('w_hh', nn.initializers.orthogonal(),
                          (hdim, 3 * hdim))
        if self.bias:
            b_ih = self.param('b_ih', nn.initializers.zeros, (3 * hdim,))
            b_hh = self.param('b_hh', nn.initializers.zeros, (3 * hdim,))
        else:
            b_ih = b_hh = jnp.zeros((3 * hdim,))
        xw = jnp.dot(x.astype(jnp.bfloat16), w_ih.astype(jnp.bfloat16),
                     preferred_element_type=jnp.float32) + b_ih
        h0 = jnp.zeros((1, b, hdim), dtype=jnp.float32)
        return gru_scan(xw[None], w_hh[None], b_hh[None, None], h0)[0]


class BiGRULayer(nn.Module):
    """Fused bidirectional GRU layer: forward and backward directions run
    in ONE scan with a stacked (2, ...) parameter axis, halving the
    number of sequential loop iterations vs two separate scans."""
    hidden_size: int
    bias: bool = True

    def __call__(self, x, seq_len):
        """x: (B, T, F) -> (B, T, 2H) (fwd || bwd)."""
        b, t, f = x.shape
        hdim = self.hidden_size
        w_ih = self.param('w_ih', nn.initializers.lecun_normal(),
                          (2, f, 3 * hdim))
        w_hh = self.param('w_hh', _stacked_orthogonal, (2, hdim, 3 * hdim))
        if self.bias:
            b_ih = self.param('b_ih', nn.initializers.zeros,
                              (2, 1, 3 * hdim))
            b_hh = self.param('b_hh', nn.initializers.zeros,
                              (2, 1, 3 * hdim))
        else:
            b_ih = b_hh = jnp.zeros((2, 1, 3 * hdim))
        rev = reverse_sequence(x, seq_len, axis=1)
        x2 = jnp.stack([x, rev])  # (2, B, T, F)
        xw = jnp.einsum(
            'dbtf,dfg->dbtg', x2.astype(jnp.bfloat16),
            w_ih.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32) + b_ih[:, None]
        h0 = jnp.zeros((2, b, hdim), dtype=jnp.float32)
        ys = gru_scan(xw, w_hh, b_hh, h0)  # (2, B, T, H)
        bwd = reverse_sequence(ys[1], seq_len, axis=1)
        return jnp.concatenate([ys[0], bwd], axis=-1)


def _stacked_orthogonal(key, shape, dtype=jnp.float32):
    init = nn.initializers.orthogonal()
    return jnp.stack([
        init(k, shape[1:], dtype) for k in jax.random.split(key, shape[0])
    ])


class StackedGRU(nn.Module):
    """Multi-layer (optionally bidirectional) GRU over padded batches."""
    hidden_size: int
    num_layers: int = 1
    bias: bool = True
    dropout: float = 0.
    bidirectional: bool = False
    input_size: int = None  # informational (config glue)

    def __call__(self, x, seq_len, training=False):
        h = x
        for i in range(self.num_layers):
            if self.bidirectional:
                h = BiGRULayer(self.hidden_size, self.bias,
                               name=f'layer_{i}_bi')(h, seq_len)
            else:
                h = GRULayer(self.hidden_size, bias=self.bias,
                             name=f'layer_{i}_fwd')(h)
            if self.dropout > 0 and training and i < self.num_layers - 1:
                h = nn.Dropout(self.dropout)(h)
        return h


class GRU(nn.Module, Configurable):
    """GRU + output net, the reference's recurrent head.

    ``reverse=True`` builds the FBCRNN backward head: the input is
    sequence-reversed before the recurrence and the output reversed back,
    so ``y[t]`` summarizes frames ``t..T-1``
    (``weak_label/crnn.py:65-67,304-340``).
    """
    rnn: dict = None
    output_net: dict = None
    reverse: bool = False

    @classmethod
    def finalize_dogmatic_config(cls, config):
        if config.get('rnn') is not None:
            config['rnn'] = {
                'factory': StackedGRU,
                'hidden_size': 256,
                'num_layers': 1,
                'dropout': 0.,
                'bidirectional': False,
                'bias': True,
            }
        config['output_net'] = {
            'factory': CNN1d,
            'out_channels': [256, 10],
            'kernel_size': 1,
            'norm': 'batch',
            'activation_fn': 'relu',
            'dropout': 0.,
            'output_layer': True,
        }

    def setup(self):
        if self.rnn is None:
            self.core = None
        elif isinstance(self.rnn, StackedGRU):
            self.core = self.rnn
        else:
            cfg = dict(self.rnn)
            cfg.pop('factory', None)
            self.core = StackedGRU(**cfg)
        if isinstance(self.output_net, CNN1d):
            self.head = self.output_net
        else:
            cfg = dict(self.output_net)
            cfg.pop('factory', None)
            cfg.setdefault('output_layer', True)
            self.head = CNN1d(**cfg)

    def __call__(self, x, seq_len, training=False):
        """(B, T, C) -> (B, T, K) scores (time-major internally)."""
        # seq_len=None (sliding-window SED path): reverse_sequence
        # degenerates to a plain flip internally
        rev_len = seq_len
        if seq_len is None:
            seq_len = jnp.full((x.shape[0],), x.shape[1], dtype=jnp.int32)
        h = x
        if self.core is not None:
            if self.reverse:
                h = reverse_sequence(h, rev_len, axis=1)
            h = self.core(h, seq_len, training=training)
            if self.reverse:
                h = reverse_sequence(h, rev_len, axis=1)
        y, seq_len = self.head(h, seq_len, training=training)
        return y, seq_len


class TransformerEncoder(nn.Module, Configurable):
    """Causal Transformer alternative to the GRU head
    (``experiments/weak_label_crnn/training.py:275-281``)."""
    rnn: dict = None
    output_net: dict = None
    reverse: bool = False

    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['rnn'] = {
            'hidden_size': 256, 'd_ff': 1024, 'num_layers': 6,
            'dropout': 0.2, 'num_heads': 8,
        }
        config['output_net'] = {
            'factory': CNN1d,
            'out_channels': [256, 10],
            'kernel_size': 1,
            'norm': 'batch',
            'activation_fn': 'relu',
            'dropout': 0.,
            'output_layer': True,
        }

    def setup(self):
        cfg = dict(self.rnn or {})
        cfg.pop('factory', None)
        cfg.pop('input_size', None)
        self.hidden_size = cfg.get('hidden_size', 256)
        self.d_ff = cfg.get('d_ff', 1024)
        self.num_layers = cfg.get('num_layers', 6)
        self.dropout_rate = cfg.get('dropout', 0.2)
        self.num_heads = cfg.get('num_heads', 8)
        if isinstance(self.output_net, CNN1d):
            self.head = self.output_net
        else:
            head_cfg = dict(self.output_net)
            head_cfg.pop('factory', None)
            head_cfg.setdefault('output_layer', True)
            self.head = CNN1d(**head_cfg)
        self.in_proj = nn.Dense(self.hidden_size)
        self.blocks = [
            _TransformerBlock(
                self.hidden_size, self.d_ff, self.num_heads,
                self.dropout_rate, name=f'block_{i}')
            for i in range(self.num_layers)
        ]

    def __call__(self, x, seq_len, training=False):
        rev_len = seq_len  # None -> reverse_sequence does a plain flip
        if seq_len is None:
            seq_len = jnp.full((x.shape[0],), x.shape[1], dtype=jnp.int32)
        h = x
        if self.reverse:
            h = reverse_sequence(h, rev_len, axis=1)
        h = self.in_proj(h)
        t = h.shape[1]
        pos = jnp.arange(t)
        causal = pos[None, :] <= pos[:, None]  # (T, T) lower triangular
        valid = pos[None, :] < seq_len[:, None]  # (B, T)
        mask = causal[None, None] & valid[:, None, None, :]
        for block in self.blocks:
            h = block(h, mask, training=training)
        if self.reverse:
            h = reverse_sequence(h, rev_len, axis=1)
        y, seq_len = self.head(h, seq_len, training=training)
        return y, seq_len


class _TransformerBlock(nn.Module):
    hidden_size: int
    d_ff: int
    num_heads: int
    dropout: float

    def __call__(self, x, mask, training=False):
        h = nn.LayerNorm()(x)
        h = nn.MultiHeadDotProductAttention(
            num_heads=self.num_heads, qkv_features=self.hidden_size,
            dropout_rate=self.dropout, deterministic=not training,
        )(h, mask=mask)
        x = x + h
        h = nn.LayerNorm()(x)
        h = nn.Dense(self.d_ff)(h)
        h = jax.nn.relu(h)
        if self.dropout > 0 and training:
            h = nn.Dropout(self.dropout)(h)
        h = nn.Dense(self.hidden_size)(h)
        return x + h
