"""The module layer of the device path: dataclass modules with named,
nested variables.

Modules are dataclasses compared by value (``StackedEnsemble`` stacks
members whose modules compare equal). Fields are fixed after
construction; ``setup`` may assign attributes. A module's variables live
outside it, in nested dicts ``{collection: {name: {...: array}}}``:

- ``Module.init(rngs, *args, method=None, **kwargs)`` runs a method with
  every collection created on demand and returns the variables;
- ``Module.apply(variables, *args, rngs=None, mutable=False,
  method=None, **kwargs)`` runs a method against given variables; with
  ``mutable`` a list of collection names (or ``True``) it returns
  ``(output, {collection: updated tree})``.

Inside a method, ``self.param(name, init_fn, *shape)``,
``self.variable(collection, name, init_fn, *args)`` and
``self.make_rng(stream)`` address the module's own node of the tree.
Submodules are named by the dataclass field that holds them, by the
attribute ``setup`` assigns them to (``f'{attr}_{i}'`` inside a list),
by an explicit ``name=`` or, when created inside a method, as
``f'{ClassName}_{n}'`` in creation order. Calling a method twice in one
``apply`` reproduces the same names, so both calls share variables.
Modules passed as fields are constructed outside any module.
"""
import dataclasses
import functools
import threading
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np

initializers = jax.nn.initializers

_CONTEXT = threading.local()


def _module_stack():
    stack = getattr(_CONTEXT, 'stack', None)
    if stack is None:
        stack = _CONTEXT.stack = []
    return stack


class _State:
    """Variables, rng streams and mutability of one init/apply call."""

    def __init__(self, variables, rngs, mutable):
        self.variables = variables
        self.rngs = rngs
        self.mutable = mutable  # True or a frozenset of collections
        self.rng_counts = {}

    def is_mutable(self, collection):
        return self.mutable is True or collection in self.mutable

    def node(self, collection, path, create):
        """The dict holding the module's variables, or None."""
        node = self.variables.get(collection)
        if node is None:
            if not create:
                return None
            node = self.variables[collection] = {}
        for part in path:
            child = node.get(part)
            if child is None:
                if not create:
                    return None
                child = node[part] = {}
            node = child
        return node


class Variable:
    """Handle to one variable; ``.value`` reads and (if mutable) writes."""

    def __init__(self, state, collection, path, name):
        self._state = state
        self.collection = collection
        self._path = path
        self.name = name

    @property
    def value(self):
        return self._state.node(self.collection, self._path, False)[
            self.name]

    @value.setter
    def value(self, value):
        if not self._state.is_mutable(self.collection):
            raise ValueError(
                f'collection {self.collection!r} is immutable here: '
                f'pass mutable=[{self.collection!r}] to apply')
        self._state.node(self.collection, self._path, True)[
            self.name] = value


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


def _wrap_method(fn):
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        d = self.__dict__
        if d.get('_state') is None:
            return fn(self, *args, **kwargs)
        stack = _module_stack()
        entered = not any(m is self for m in stack)
        if entered:
            d['_counters'] = {}  # a fresh call re-creates the same names
        if not d['_setup_done']:
            self._run_setup()
        stack.append(self)
        try:
            if not entered:
                return fn(self, *args, **kwargs)
            # the module path names the module's ops in HLO metadata and
            # profiler traces (kernel ``name`` stat)
            with jax.named_scope(d['name'] or type(self).__name__):
                return fn(self, *args, **kwargs)
        finally:
            stack.pop()
    return wrapped


@dataclasses.dataclass(eq=False)
class Module:
    """Base class; subclasses become dataclasses compared by value."""
    name: str = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for attr, value in list(vars(cls).items()):
            if (isinstance(value, types.FunctionType) and attr != 'setup'
                    and (attr == '__call__' or not attr.startswith('__'))):
                setattr(cls, attr, _wrap_method(value))
        dataclasses.dataclass(cls, eq=True, unsafe_hash=True)

    def __post_init__(self):
        d = self.__dict__
        d.update(_state=None, _path=(), _setup_done=False, _counters={},
                 _in_setup=False)
        stack = _module_stack()
        parent = stack[-1] if stack else None
        if parent is not None and not parent.__dict__['_in_setup']:
            # created inside a method of a bound module: owned by it
            name = self.name
            if name is None:
                cls = type(self).__name__
                count = parent.__dict__['_counters'].get(cls, 0)
                parent.__dict__['_counters'][cls] = count + 1
                name = f'{cls}_{count}'
            self._adopt(parent, name, parent._state)
        d['_frozen'] = True

    def _adopt(self, parent, name, state):
        """Bind this (fresh or cloned) object under ``parent`` (None:
        the root of an init/apply call)."""
        d = self.__dict__
        d['name'] = name
        d['_state'] = state
        d['_path'] = (parent._path + (name,)) if parent is not None else ()
        d['_setup_done'] = False
        d['_counters'] = {}
        for field in dataclasses.fields(self):
            value = d[field.name]
            if isinstance(value, Module):
                d[field.name] = value._bound_clone(self, field.name, state)

    def _bound_clone(self, parent, name, state):
        clone = object.__new__(type(self))
        clone.__dict__.update(self.__dict__)
        clone._adopt(parent, name, state)
        return clone

    def _run_setup(self):
        d = self.__dict__
        d['_in_setup'] = True
        stack = _module_stack()
        stack.append(self)
        try:
            self.setup()
        finally:
            stack.pop()
            d['_in_setup'] = False
        d['_setup_done'] = True

    def setup(self):
        """Declare submodules and attributes; runs once per binding."""

    def __setattr__(self, attr, value):
        d = self.__dict__
        if d.get('_in_setup'):
            value = self._register(attr, value)
        elif d.get('_frozen'):
            raise dataclasses.FrozenInstanceError(
                f'cannot assign {attr!r} outside setup')
        object.__setattr__(self, attr, value)

    def _register(self, attr, value):
        def bind(module, name):
            if module.__dict__.get('_state') is not None:
                return module  # already bound (a field module): alias
            return module._bound_clone(self, module.name or name,
                                       self._state)
        if isinstance(value, Module):
            return bind(value, attr)
        if isinstance(value, (list, tuple)) and any(
                isinstance(v, Module) for v in value):
            return type(value)(
                bind(v, f'{attr}_{i}') if isinstance(v, Module) else v
                for i, v in enumerate(value))
        return value

    def __getattr__(self, attr):
        # attributes assigned in setup: run it on first access
        d = self.__dict__
        if (attr.startswith('__') or d.get('_state') is None
                or d.get('_setup_done') or d.get('_in_setup')):
            raise AttributeError(attr)
        self._run_setup()
        return getattr(self, attr)

    # -- variables -----------------------------------------------------
    def param(self, name, init_fn, *init_args):
        state = self._state
        create = state.is_mutable('params')
        node = state.node('params', self._path, create)
        if node is None or name not in node:
            if not create:
                raise KeyError(
                    f"parameter {'/'.join(self._path + (name,))} missing")
            node[name] = init_fn(self.make_rng('params'), *init_args)
        return node[name]

    def variable(self, collection, name, init_fn, *init_args):
        state = self._state
        create = state.is_mutable(collection)
        node = state.node(collection, self._path, create)
        if node is None or name not in node:
            if not create:
                raise KeyError(
                    f"variable {collection}/"
                    f"{'/'.join(self._path + (name,))} missing")
            node[name] = init_fn(*init_args)
        return Variable(state, collection, self._path, name)

    def make_rng(self, stream):
        """A fresh key of ``stream``, distinct per module path and call."""
        state = self._state
        if stream not in state.rngs:
            raise ValueError(f'no rng stream {stream!r} given')
        count_key = (self._path, stream)
        count = state.rng_counts.get(count_key, 0)
        state.rng_counts[count_key] = count + 1
        key = state.rngs[stream]
        for part in (stream,) + self._path:
            key = jax.random.fold_in(
                key, zlib.crc32(part.encode()) & 0x7FFFFFFF)
        return jax.random.fold_in(key, count)

    # -- entry points --------------------------------------------------
    def _run(self, state, method, args, kwargs):
        root = self._bound_clone(None, self.name, state)
        fn = type(self).__call__ if method is None else method
        if isinstance(fn, str):
            fn = getattr(type(self), fn)
        return fn(root, *args, **kwargs)

    def init(self, rngs, *args, method=None, **kwargs):
        if not isinstance(rngs, dict):
            rngs = {'params': rngs}
        state = _State({}, rngs, True)
        self._run(state, method, args, kwargs)
        return state.variables

    def apply(self, variables, *args, rngs=None, mutable=False,
              method=None, **kwargs):
        if mutable is True:
            mut = True
        elif isinstance(mutable, str):
            mut = frozenset([mutable])
        else:
            mut = frozenset(mutable or ())
        state = _State(
            {c: _copy_tree(t) if (mut is True or c in mut) else t
             for c, t in variables.items()},
            dict(rngs or {}), mut)
        out = self._run(state, method, args, kwargs)
        if mutable is False:
            return out
        return out, {c: t for c, t in state.variables.items()
                     if state.is_mutable(c)}


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------
class Dense(Module):
    features: int

    def __call__(self, x):
        kernel = self.param('kernel', initializers.lecun_normal(),
                            (x.shape[-1], self.features))
        bias = self.param('bias', initializers.zeros, (self.features,))
        return jnp.dot(x, kernel) + bias


class DenseGeneral(Module):
    """Projection of the trailing ``len(axis)`` input axes onto
    ``features`` (a tuple of output axes)."""
    features: tuple
    axis: tuple = (-1,)

    def __call__(self, x):
        n_in = len(self.axis)
        in_shape = x.shape[x.ndim - n_in:]
        features = tuple(self.features)

        def init(key, shape, dtype=jnp.float32):
            flat = (int(np.prod(in_shape)), int(np.prod(features)))
            return initializers.lecun_normal()(key, flat, dtype).reshape(
                shape)

        kernel = self.param('kernel', init, in_shape + features)
        bias = self.param('bias', initializers.zeros, features)
        contract = (tuple(range(x.ndim - n_in, x.ndim)),
                    tuple(range(n_in)))
        return jax.lax.dot_general(x, kernel, (contract, ((), ()))) + bias


class Conv(Module):
    """Channels-last convolution, stride 1; ``kernel_size`` a tuple with
    one entry per spatial axis. ``dtype`` is the compute dtype of inputs,
    kernel and bias."""
    features: int
    kernel_size: tuple
    padding: str = 'SAME'
    dtype: object = None

    def __call__(self, x):
        ks = tuple(self.kernel_size)
        kernel = self.param('kernel', initializers.lecun_normal(),
                            ks + (x.shape[-1], self.features))
        bias = self.param('bias', initializers.zeros, (self.features,))
        if self.dtype is not None:
            x, kernel, bias = (a.astype(self.dtype) for a in (x, kernel,
                                                             bias))
        n = len(ks)
        spatial = 'HWD'[:n] if n > 1 else 'W'
        y = jax.lax.conv_general_dilated(
            x, kernel, (1,) * n, self.padding,
            dimension_numbers=(f'N{spatial}C', f'{spatial}IO',
                               f'N{spatial}C'))
        return y + bias


class Dropout(Module):
    """Inverted dropout; callers apply it only while training."""
    rate: float

    def __call__(self, x):
        if self.rate == 0.:
            return x
        keep = 1. - self.rate
        mask = jax.random.bernoulli(self.make_rng('dropout'), keep, x.shape)
        return jax.lax.select(mask, x / keep, jnp.zeros_like(x))


class LayerNorm(Module):
    epsilon: float = 1e-6

    def __call__(self, x):
        features = x.shape[-1]
        scale = self.param('scale', initializers.ones, (features,))
        bias = self.param('bias', initializers.zeros, (features,))
        xf = x.astype(jnp.float32)
        mean = xf.mean(-1, keepdims=True)
        var = jnp.maximum(
            jnp.square(xf).mean(-1, keepdims=True) - jnp.square(mean), 0.)
        y = (xf - mean) * jax.lax.rsqrt(var + self.epsilon)
        return (y * scale + bias).astype(x.dtype)


class MultiHeadDotProductAttention(Module):
    """Scaled dot-product self-attention over ``num_heads`` heads with
    query/key/value/out projections; ``mask`` (broadcastable to
    (B, heads, T, T)) is True where attention is allowed. Attention
    dropout, off when ``deterministic``, shares one mask over batch and
    heads."""
    num_heads: int
    qkv_features: int = None
    dropout_rate: float = 0.
    deterministic: bool = True

    def __call__(self, x, *, mask=None):
        features = self.qkv_features or x.shape[-1]
        head_dim = features // self.num_heads
        heads = (self.num_heads, head_dim)
        q = DenseGeneral(heads, name='query')(x)
        k = DenseGeneral(heads, name='key')(x)
        v = DenseGeneral(heads, name='value')(x)
        q = q / jnp.sqrt(head_dim).astype(q.dtype)
        logits = jnp.einsum('...qhd,...khd->...hqk', q, k)
        if mask is not None:
            logits = jnp.where(mask, logits, jnp.finfo(logits.dtype).min)
        weights = jax.nn.softmax(logits.astype(jnp.float32)).astype(q.dtype)
        if not self.deterministic and self.dropout_rate > 0.:
            keep = 1. - self.dropout_rate
            shape = (1,) * (weights.ndim - 2) + weights.shape[-2:]
            mask_d = jax.random.bernoulli(self.make_rng('dropout'), keep,
                                          shape)
            weights = weights * (mask_d.astype(weights.dtype) / keep)
        out = jnp.einsum('...hqk,...khd->...qhd', weights, v)
        return DenseGeneral((x.shape[-1],), axis=(-2, -1), name='out')(out)


def _pool(x, init, reduce_fn, window_shape, strides):
    window_shape = tuple(window_shape)
    strides = tuple(strides) if strides is not None else window_shape
    dims = (1,) + window_shape + (1,) * (x.ndim - 1 - len(window_shape))
    steps = (1,) + strides + (1,) * (x.ndim - 1 - len(strides))
    return jax.lax.reduce_window(x, init, reduce_fn, dims, steps, 'VALID')


def max_pool(x, window_shape, strides=None):
    """Max over windows of the axes after the batch axis (VALID)."""
    return _pool(x, -jnp.inf, jax.lax.max, window_shape, strides)


def avg_pool(x, window_shape, strides=None):
    """Mean over windows of the axes after the batch axis (VALID)."""
    return _pool(x, 0., jax.lax.add, window_shape, strides) / np.prod(
        window_shape)
