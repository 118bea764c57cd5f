"""Sequence masks and masked reductions.

Device-side (JAX) equivalents of the reference's sequence ops
(padertorch ``compute_mask`` at ``pb_sed/models/weak_label/crnn.py:238`` and
``reduce.{TakeLast,Mean,Sum,Max}`` at ``crnn.py:147,158,185``). Everything
here is shape-static and mask-driven, as required under jit: padded batches
never influence losses, statistics or pooled outputs.
"""
import functools

import jax
import jax.numpy as jnp


def sequence_mask(seq_len, max_len, dtype=jnp.float32):
    """(B,) lengths -> (B, max_len) {0,1} mask."""
    return (
        jnp.arange(max_len)[None, :] < seq_len[:, None]
    ).astype(dtype)


def compute_mask(x, seq_len, sequence_axis=-1, batch_axis=0):
    """Mask broadcastable to ``x`` with 1s on valid frames."""
    axis = sequence_axis % x.ndim
    mask = sequence_mask(seq_len, x.shape[axis], x.dtype)  # (B, T)
    shape = [1] * x.ndim
    shape[batch_axis % x.ndim] = x.shape[batch_axis % x.ndim]
    shape[axis] = x.shape[axis]
    return mask.reshape(shape)


def masked_mean(x, seq_len, axis=-1, keepdims=False):
    mask = compute_mask(x, seq_len, sequence_axis=axis)
    total = jnp.sum(x * mask, axis=axis, keepdims=keepdims)
    count = jnp.sum(mask, axis=axis, keepdims=keepdims)
    return total / jnp.maximum(count, 1.)


def masked_sum(x, seq_len, axis=-1, keepdims=False):
    mask = compute_mask(x, seq_len, sequence_axis=axis)
    return jnp.sum(x * mask, axis=axis, keepdims=keepdims)


def masked_max(x, seq_len, axis=-1, keepdims=False):
    mask = compute_mask(x, seq_len, sequence_axis=axis)
    neg = jnp.finfo(x.dtype).min
    return jnp.max(jnp.where(mask > 0, x, neg), axis=axis, keepdims=keepdims)


def take_last(x, seq_len, axis=-1, keepdims=False):
    """Value at the last valid frame per example (reference ``TakeLast``)."""
    axis = axis % x.ndim
    idx = jnp.clip(seq_len - 1, 0, x.shape[axis] - 1)  # (B,)
    idx_shape = [1] * x.ndim
    idx_shape[0] = x.shape[0]
    idx = idx.reshape(idx_shape)
    idx = jnp.broadcast_to(
        idx, x.shape[:axis] + (1,) + x.shape[axis + 1:])
    out = jnp.take_along_axis(x, idx, axis=axis)
    if not keepdims:
        out = jnp.squeeze(out, axis=axis)
    return out


def reverse_sequence(x, seq_len, axis=-1):
    """Flip valid frames, keeping padding at the end.

    ``reverse_sequence(x, sl)[..., t] == x[..., sl - 1 - t]`` for t < sl.
    Needed for the backward GRU head over padded batches.

    ``seq_len=None`` means every sequence is full: the masked reversal
    degenerates to a plain ``jnp.flip`` (no roll, no doubled-buffer
    copies — those dominated the sliding-window ensemble trace).

    Implementation: the obvious ``take_along_axis(flip(x), src)``
    broadcasts the index to the full tensor (a gather forward, a
    scatter backward). Instead: flip + per-example circular roll via
    batched dynamic slices of a doubled buffer. Because flip-then-roll
    is a SYMMETRIC permutation (P^T == P — the op is an involution), the
    VJP is the op itself applied to the cotangent, so the backward pass
    never sees a scatter at all.
    """
    axis = axis % x.ndim
    if seq_len is None:
        return jnp.flip(x, axis=axis)
    t = x.shape[axis]
    offsets = (t - seq_len) % jnp.maximum(t, 1)  # (B,)
    return _flip_roll(x, offsets, axis)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _flip_roll(x, offsets, axis):
    """flip along ``axis`` then roll example b LEFT by ``offsets[b]``."""
    return _flip_roll_impl(x, offsets, axis)


def _flip_roll_impl(x, offsets, axis):
    # a dynamic slice per example, not a one-hot (B, T, T) permutation
    # matmul: on an H100 at (32, 500, 256) f32 the slices take 0.063 ms
    # forward+grad against 0.125 ms for the matmul (PERF.md, roll)
    t = x.shape[axis]
    flipped = jnp.flip(x, axis=axis)

    # batch on axis 0 (all callers), roll axis = axis-1 inside the map
    def roll_one(xb, off):
        doubled = jnp.concatenate([xb, xb], axis=axis - 1)
        return jax.lax.dynamic_slice_in_dim(doubled, off, t, axis=axis - 1)
    return jax.vmap(roll_one)(flipped, offsets)


def _flip_roll_fwd(x, offsets, axis):
    return _flip_roll_impl(x, offsets, axis), offsets


def _flip_roll_bwd(axis, offsets, g):
    # involution: P^T == P, so the cotangent transforms by the same
    # cheap flip+roll instead of a (sort-lowered) scatter
    import numpy as np
    return (_flip_roll_impl(g, offsets, axis),
            np.zeros(offsets.shape, dtype=jax.dtypes.float0))


_flip_roll.defvjp(_flip_roll_fwd, _flip_roll_bwd)
