"""The module layer (pb_sed_tpu/nn.py): variable trees of the published
models against the recorded fixture, init/apply semantics, rng streams,
module equality, and every layer against numpy."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pb_sed_tpu import nn
from tests import numpy_reference as npref

TREES = os.path.join(os.path.dirname(__file__), 'fixtures',
                     'variable_trees.json')


def _model(name):
    from pb_sed_tpu.models import strong_label, weak_label
    from pb_sed_tpu.models.net_configs import bicrnn_config, fbcrnn_config
    from pb_sed_tpu.ops.rnn import TransformerEncoder
    if name.startswith('bicrnn'):
        cfg = bicrnn_config('shallow', 10,
                            tag_conditioning=name.endswith('conditioned'))
        cls = strong_label.CRNN
    else:
        cfg = fbcrnn_config('deep' if name.endswith('deep') else 'shallow',
                            10)
        if name.endswith('transformer'):
            cfg['rnn_fwd'] = {'factory': TransformerEncoder,
                              'output_net': cfg['rnn_fwd']['output_net']}
        cls = weak_label.CRNN
    return cls.from_config(cls.get_config(cfg))


def _tree(model, tags=False):
    b, t = 2, 16
    batch = {'stft': np.zeros((b, t, 513, 2), np.float32),
             'seq_len': np.full(b, t, np.int32)}
    if tags:
        batch['tag_condition'] = np.zeros((b, 10), np.float32)
    rngs = {'params': jax.random.PRNGKey(0),
            'augment': jax.random.PRNGKey(1),
            'dropout': jax.random.PRNGKey(2)}
    shapes = jax.eval_shape(
        lambda: model.module.init(rngs, batch, training=False))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return {'/'.join(p.key for p in path): list(leaf.shape)
            for path, leaf in flat}


@pytest.mark.parametrize('name', [
    'fbcrnn_shallow', 'fbcrnn_deep', 'bicrnn', 'bicrnn_tag_conditioned',
    'fbcrnn_transformer'])
def test_variable_tree_matches_fixture(name):
    """Same collections, paths and shapes as the trees recorded before
    the module layer changed: checkpoints keep loading."""
    with open(TREES) as fid:
        want = json.load(fid)[name]
    got = _tree(_model(name), tags=name.endswith('conditioned'))
    assert sorted(got) == sorted(want)
    assert got == want


def test_shallow_fbcrnn_size():
    tree = _tree(_model('fbcrnn_shallow'))
    params = [s for p, s in tree.items() if p.startswith('params/')]
    assert len(tree) == 137
    assert sum(int(np.prod(s)) for s in params) == 3_493_446


class _Net(nn.Module):
    features: int = 3
    rate: float = 0.5

    def __call__(self, x, training=False):
        h = nn.Dense(self.features)(x)
        stat = self.variable('batch_stats', 'mean',
                             lambda: jnp.zeros((self.features,)))
        if training:
            stat.value = 0.5 * stat.value + 0.5 * h.mean(0)
            h = nn.Dropout(self.rate)(h)
        return nn.Dense(2)(h)


def _init(seed=0, module=None):
    module = module or _Net()
    return module.init(jax.random.PRNGKey(seed), jnp.ones((4, 5)))


def test_init_is_deterministic_and_seeded():
    a, b, c = _init(0), _init(0), _init(1)
    assert sorted(a['params']) == ['Dense_0', 'Dense_1']
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a['params']['Dense_0']['kernel'],
                              c['params']['Dense_0']['kernel'])


def test_apply_mutable_collections():
    variables = _init()
    x = jnp.arange(20.).reshape(4, 5)
    rngs = {'dropout': jax.random.PRNGKey(3)}
    out = _Net().apply(variables, x)
    assert out.shape == (4, 2)
    out2, mutated = _Net().apply(variables, x, training=True, rngs=rngs,
                                 mutable=['batch_stats'])
    assert set(mutated) == {'batch_stats'}
    assert not np.allclose(mutated['batch_stats']['mean'], 0.)
    # the caller's variables are untouched
    np.testing.assert_array_equal(variables['batch_stats']['mean'], 0.)
    _, none = _Net().apply(variables, x, mutable=[])
    assert none == {}
    with pytest.raises(ValueError, match='immutable'):
        _Net().apply(variables, x, training=True, rngs=rngs)


def test_make_rng_streams_are_distinct():
    class Draw(nn.Module):
        def __call__(self):
            return (self.make_rng('dropout'), self.make_rng('dropout'),
                    self.make_rng('augment'))

    class Two(nn.Module):
        def __call__(self):
            return Draw(name='a')(), Draw(name='b')()

    rngs = {'dropout': jax.random.PRNGKey(0),
            'augment': jax.random.PRNGKey(0)}
    (a1, a2, a3), (b1, _, _) = Two().apply({}, rngs=rngs)
    keys = [np.asarray(jax.random.key_data(k) if jnp.issubdtype(
        k.dtype, jax.dtypes.prng_key) else k) for k in (a1, a2, a3, b1)]
    assert len({k.tobytes() for k in keys}) == 4
    again = Two().apply({}, rngs=rngs)[0][0]
    np.testing.assert_array_equal(again, a1)


def test_dropout_only_when_training():
    x = jnp.ones((64, 64))
    rngs = {'dropout': jax.random.PRNGKey(0)}
    assert nn.Dropout(0.).apply({}, x) is x
    y = nn.Dropout(0.5).apply({}, x, rngs=rngs)
    kept = np.asarray(y) != 0
    assert 0.3 < kept.mean() < 0.7
    np.testing.assert_allclose(np.asarray(y)[kept], 2.)
    # a model in eval mode draws no dropout key at all
    variables = _init()
    np.testing.assert_array_equal(
        _Net(rate=0.9).apply(variables, x[:4, :5]),
        _Net(rate=0.9).apply(variables, x[:4, :5]))


def test_module_equality_and_hashing():
    from pb_sed_tpu.models.base.ensemble import same_architecture
    assert _Net() == _Net() and hash(_Net()) == hash(_Net())
    assert _Net(features=4) != _Net()
    assert len({_Net(), _Net(), _Net(features=4)}) == 2
    a, b, c = (_model('fbcrnn_shallow'), _model('fbcrnn_shallow'),
               _model('fbcrnn_deep'))
    assert same_architecture([a, b]) and not same_architecture([a, c])


def test_fields_are_frozen_outside_setup():
    module = _Net()
    with pytest.raises(dataclasses_error()):
        module.features = 4

    class WithSetup(nn.Module):
        def setup(self):
            self.proj = nn.Dense(2)
            self.stack = [nn.Dense(2), nn.Dense(3, name='named')]
            self.width = 7

        def __call__(self, x):
            return self.stack[1](self.stack[0](self.proj(x))) * self.width

    variables = WithSetup().init(jax.random.PRNGKey(0), jnp.ones((1, 4)))
    assert sorted(variables['params']) == ['named', 'proj', 'stack_0']


def dataclasses_error():
    import dataclasses
    return dataclasses.FrozenInstanceError


def test_method_argument_and_repeated_calls_share_variables():
    class Inner(nn.Module):
        def __call__(self, x):
            return nn.Dense(x.shape[-1])(x)

    class Twice(nn.Module):
        def setup(self):
            self.inner = Inner()

        def __call__(self, x):
            return self.inner(self.inner(x))

        def once(self, x):
            return self.inner(x)

    variables = Twice().init(jax.random.PRNGKey(0), jnp.ones((1, 3)))
    assert jax.tree_util.tree_structure(variables['params']) == \
        jax.tree_util.tree_structure(
            {'inner': {'Dense_0': {'bias': 0, 'kernel': 0}}})
    x = jnp.ones((2, 3))
    once = Twice().apply(variables, x, method=Twice.once)
    np.testing.assert_array_equal(
        once, Twice().apply(variables, x, method='once'))
    np.testing.assert_allclose(
        Twice().apply(variables, x),
        Twice().apply(variables, once, method='once'), rtol=1e-6)


# ----------------------------------------------------------------------
# layers against numpy
# ----------------------------------------------------------------------
def test_dense_matches_numpy():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 5).astype(np.float32)
    variables = nn.Dense(4).init(jax.random.PRNGKey(0), x)
    p = variables['params']
    assert p['kernel'].shape == (5, 4) and p['bias'].shape == (4,)
    p = {'kernel': rng.randn(5, 4).astype(np.float32),
         'bias': rng.randn(4).astype(np.float32)}
    got = nn.Dense(4).apply({'params': p}, x)
    np.testing.assert_allclose(got, x @ p['kernel'] + p['bias'],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('dims,dtype', [
    (1, None), (2, None), (2, jnp.bfloat16)])
def test_conv_same_matches_numpy(dims, dtype):
    rng = np.random.RandomState(dims)
    shape = (2, 7, 6, 3) if dims == 2 else (2, 9, 3)
    ks = (3, 3) if dims == 2 else (3,)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(*ks, 3, 4) / 3).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    got = nn.Conv(4, kernel_size=ks, dtype=dtype).apply(
        {'params': {'kernel': w, 'bias': b}}, x)
    ref = (npref.conv2d_same(x, w, b) if dims == 2
           else npref.conv1d_same(x, w, b))
    assert got.dtype == (dtype or jnp.float32)
    tol = 5e-2 if dtype is not None else 1e-4
    np.testing.assert_allclose(np.asarray(got, np.float32), ref,
                               rtol=tol, atol=tol)


def test_layer_norm_matches_numpy():
    rng = np.random.RandomState(1)
    x = (3. + rng.randn(2, 4, 8)).astype(np.float32)
    scale = rng.rand(8).astype(np.float32)
    bias = rng.randn(8).astype(np.float32)
    got = nn.LayerNorm().apply({'params': {'scale': scale, 'bias': bias}},
                               x)
    mu = x.mean(-1, keepdims=True)
    ref = (x - mu) / np.sqrt(x.var(-1, keepdims=True) + 1e-6) * scale + bias
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def _numpy_attention(p, x, mask, heads):
    def proj(name, v):
        return np.einsum('btf,fhd->bthd', v, p[name]['kernel']) \
            + p[name]['bias']
    q, k, v = (proj(n, x) for n in ('query', 'key', 'value'))
    logits = np.einsum('bqhd,bkhd->bhqk', q / np.sqrt(q.shape[-1]), k)
    if mask is not None:
        logits = np.where(mask, logits, -1e30)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w = w / w.sum(-1, keepdims=True)
    out = np.einsum('bhqk,bkhd->bqhd', w, v)
    return np.einsum('bqhd,hdo->bqo', out, p['out']['kernel']) \
        + p['out']['bias']


@pytest.mark.parametrize('causal', [False, True])
def test_attention_matches_numpy(causal):
    rng = np.random.RandomState(2)
    b, t, f, heads = 2, 6, 8, 2
    x = rng.randn(b, t, f).astype(np.float32)
    module = nn.MultiHeadDotProductAttention(num_heads=heads,
                                             qkv_features=f)
    variables = module.init(jax.random.PRNGKey(0), x)
    p = jax.tree_util.tree_map(np.asarray, variables['params'])
    assert p['query']['kernel'].shape == (f, heads, f // heads)
    assert p['out']['kernel'].shape == (heads, f // heads, f)
    mask = (np.tril(np.ones((t, t), bool))[None, None] if causal
            else None)
    got = module.apply(variables, x, mask=mask)
    np.testing.assert_allclose(got, _numpy_attention(p, x, mask, heads),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('kind', ['max', 'avg'])
def test_pools_match_numpy(kind):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 6, 3).astype(np.float32)
    pool = nn.max_pool if kind == 'max' else nn.avg_pool
    got = pool(x, window_shape=(2, 3), strides=(2, 3))
    blocks = x.reshape(2, 4, 2, 2, 3, 3)
    ref = blocks.max((2, 4)) if kind == 'max' else blocks.mean((2, 4))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    if kind == 'max':
        np.testing.assert_allclose(
            pool(x[..., 0, :], window_shape=(2,)),
            npref.max_pool(x[..., 0, :], (2,)), rtol=1e-6)
