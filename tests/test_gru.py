"""The scan GRU (ops/rnn.py) against the numpy reference at the published
hidden size H=256: forward, time-reversed head, bidirectional layer, the
stacked D-direction recurrence, and the gradient."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pb_sed_tpu.ops.rnn import BiGRULayer, GRULayer, gru_scan
from tests import numpy_reference as npref

H = 256
# bf16 input projections and recurrent matmul against a float32 numpy
# recurrence: rounding compounds over the steps; a structural error
# (gate order, reset placement) is order one
TOL = 4e-2


def _weights(rng, feat, d=None):
    lead = () if d is None else (d,)
    bias = lead + ((1,) if d is not None else ())
    return {
        'w_ih': (rng.randn(*lead, feat, 3 * H) / np.sqrt(feat)),
        'w_hh': (rng.randn(*lead, H, 3 * H) / np.sqrt(H)),
        'b_ih': .1 * rng.randn(*bias, 3 * H),
        'b_hh': .1 * rng.randn(*bias, 3 * H),
    }


def _f32(tree):
    return {k: np.asarray(v, np.float32) for k, v in tree.items()}


@pytest.mark.parametrize('steps', [1, 9, 501])
def test_gru_layer_matches_numpy(steps):
    rng = np.random.RandomState(steps)
    x = rng.randn(3, steps, 64).astype(np.float32)
    p = _f32(_weights(rng, 64))
    got = jax.jit(lambda p, x: GRULayer(H).apply({'params': p}, x))(p, x)
    ref = npref.gru_layer(x, **p)
    np.testing.assert_allclose(got, ref, atol=TOL)
    assert float(np.max(np.abs(np.asarray(got) - ref))) < TOL


@pytest.mark.parametrize('steps', [50, 501])
def test_gru_layer_matches_bf16_operand_reference(steps):
    """Against the reference that rounds both matmuls' operands to bf16
    as the layer does, only float32 accumulation order differs: max and
    mean error stay far inside the bounds of chip_smoke.py's GRU check
    (5e-3 and 2.5e-4 of max|ref|)."""
    rng = np.random.RandomState(10 + steps)
    x = rng.randn(8, steps, H).astype(np.float32)
    p = _f32(_weights(rng, H))
    got = jax.jit(lambda p, x: GRULayer(H).apply({'params': p}, x))(p, x)
    ref = npref.gru_layer(x, **p, operand_dtype=jnp.bfloat16)
    err = np.abs(np.asarray(got, np.float64) - ref)
    scale = np.abs(ref).max()
    assert err.max() <= 5e-3 * scale and err.mean() <= 2.5e-4 * scale


def test_reversed_head_matches_numpy():
    """The FBCRNN backward head: reverse valid frames, recur, reverse
    back (padding untouched by the recurrence's front)."""
    from pb_sed_tpu.ops.cnn import CNN1d
    from pb_sed_tpu.ops.rnn import GRU, StackedGRU
    rng = np.random.RandomState(1)
    b, t, c, k = 3, 40, 32, 10
    x = rng.randn(b, t, c).astype(np.float32)
    seq_len = np.array([40, 31, 7])
    head = GRU(rnn=StackedGRU(hidden_size=H, num_layers=1),
               output_net=CNN1d(out_channels=[k], kernel_size=1,
                                output_layer=True),
               reverse=True)
    variables = head.init(jax.random.PRNGKey(0), x, seq_len)
    p = jax.tree_util.tree_map(np.asarray, variables['params'])
    p['rnn']['layer_0_fwd'] = _f32(_weights(rng, c))
    y, _ = head.apply({'params': p, **{
        k_: v for k_, v in variables.items() if k_ != 'params'}},
        x, seq_len)
    ref = npref.gru_head(
        jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32), p), x,
        seq_len, num_layers=1, reverse=True,
        output_net_cfg=dict(out_channels=[k], kernel_size=1,
                            output_layer=True, pre_activation=False))
    mask = npref.sequence_mask(seq_len, t)[..., None]
    np.testing.assert_allclose(np.asarray(y) * mask, ref * mask,
                               atol=TOL * max(1., np.abs(ref).max()))


def test_bidirectional_layer_matches_numpy():
    rng = np.random.RandomState(2)
    b, t, c = 3, 50, 48
    x = rng.randn(b, t, c).astype(np.float32)
    seq_len = np.array([50, 33, 12])
    p = _f32(_weights(rng, c, d=2))
    got = BiGRULayer(H).apply({'params': p}, x, seq_len)
    ref = npref.bigru({'layer_0_bi': p}, x, seq_len, num_layers=1)
    mask = npref.sequence_mask(seq_len, t)[..., None]
    assert got.shape == (b, t, 2 * H)
    np.testing.assert_allclose(np.asarray(got) * mask, ref * mask,
                               atol=TOL)


def test_stacked_directions_equal_separate_scans():
    """gru_scan over D=2 stacked directions is two independent D=1
    recurrences (the pairing the bidirectional layer relies on)."""
    rng = np.random.RandomState(3)
    xw = jnp.asarray(rng.randn(2, 4, 30, 3 * H).astype(np.float32))
    w_hh = jnp.asarray((rng.randn(2, H, 3 * H) / 16).astype(np.float32))
    b_hh = jnp.asarray(.1 * rng.randn(2, 1, 3 * H).astype(np.float32))
    h0 = jnp.zeros((2, 4, H))
    both = gru_scan(xw, w_hh, b_hh, h0)
    for d in range(2):
        one = gru_scan(xw[d:d + 1], w_hh[d:d + 1], b_hh[d:d + 1],
                       h0[d:d + 1])
        np.testing.assert_allclose(both[d], one[0], atol=1e-6)


def _gru_f32(p, x):
    """The reference recurrence in float32 jax (no bf16), for gradients."""
    xw = x @ p['w_ih'] + p['b_ih']

    def step(h, xw_t):
        hw = h @ p['w_hh'] + p['b_hh']
        xr, xz, xn = jnp.split(xw_t, 3, -1)
        hr, hz, hn = jnp.split(hw, 3, -1)
        r, z = jax.nn.sigmoid(xr + hr), jax.nn.sigmoid(xz + hz)
        h = (1. - z) * jnp.tanh(xn + r * hn) + z * h
        return h, h

    _, ys = jax.lax.scan(step, jnp.zeros((x.shape[0], H)),
                         jnp.swapaxes(xw, 0, 1))
    return jnp.swapaxes(ys, 0, 1)


def test_gradient_matches_float32_reference():
    rng = np.random.RandomState(4)
    x = jnp.asarray(rng.randn(2, 60, 32).astype(np.float32))
    p = {k: jnp.asarray(v) for k, v in _f32(_weights(rng, 32)).items()}
    w = jnp.asarray(rng.randn(2, 60, H).astype(np.float32))

    def loss(apply):
        return lambda p, x: jnp.sum(apply(p, x) * w)

    got = jax.grad(loss(lambda p, x: GRULayer(H).apply(
        {'params': p}, x)), argnums=(0, 1))(p, x)
    ref = jax.grad(loss(_gru_f32), argnums=(0, 1))(p, x)
    for g, r in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        scale = float(jnp.max(jnp.abs(r)))
        np.testing.assert_allclose(g, r, atol=TOL * scale)


@pytest.mark.gpu
def test_gru_matches_numpy_on_gpu(gpu):
    """The published recurrence (B=32, T=501, H=256) on the card."""
    rng = np.random.RandomState(5)
    x = rng.randn(32, 501, 256).astype(np.float32)
    p = _f32(_weights(rng, 256))
    got = jax.jit(lambda p, x: GRULayer(H).apply({'params': p}, x))(p, x)
    assert got.devices() == {gpu[0]}
    np.testing.assert_allclose(got, npref.gru_layer(x, **p), atol=TOL)
