"""Straight-numpy reference implementation of the CRNN semantics.

An INDEPENDENT re-implementation of the reference model contract
(``/root/reference/pb_sed/models/weak_label/crnn.py:69-206`` and
``strong_label/crnn.py:60-112``) used by ``test_golden_model.py`` to pin
the models' numerics: HTK mel triangles, masked normalization and
batch-norm statistics (valid frames only, normalization applied
everywhere), SAME convs, torch-gate-order GRU (r, z, n with the reset
gate inside the candidate's recurrent term), bounded sigmoid, the
fwd-last + bwd-first tagging rule, min-of-heads boundary scores, weak
BCE on max(y_fwd, y_bwd), and the cummax-expanded strong fwd/bwd BCE
with soft-label (0.5) masking.

Everything here is float32/float64 numpy with no jax import — wrong
gate order, a flipped cummax, a mask applied to the wrong axis, or a
transposed weight in the module path produces order-one disagreement,
far above the bf16 tolerance of the comparison.
"""
import numpy as np


# ---------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------

def sigmoid(x):
    return 1. / (1. + np.exp(-x))


def relu(x):
    return np.maximum(x, 0.)


def sequence_mask(seq_len, t):
    return (np.arange(t)[None, :] < np.asarray(seq_len)[:, None]
            ).astype(np.float32)


def mel_filterbank(m, sample_rate, size, fmin=50., fmax=None):
    """(F, M) HTK-mel triangle filterbank, F = size // 2 + 1."""
    if fmax is None:
        fmax = sample_rate / 2
    mel = lambda f: 2595. * np.log10(1. + f / 700.)
    imel = lambda x: 700. * (10. ** (x / 2595.) - 1.)
    edges = imel(np.linspace(mel(fmin), mel(fmax), m + 2))
    bins = np.arange(size // 2 + 1) * sample_rate / size
    lo, ce, hi = edges[:-2], edges[1:-1], edges[2:]
    f = bins[:, None]
    up = (f - lo) / np.maximum(ce - lo, 1e-6)
    down = (hi - f) / np.maximum(hi - ce, 1e-6)
    return np.clip(np.minimum(up, down), 0., 1.).astype(np.float32)


def conv2d_same(x, w, b):
    """(B, T, F, Ci) * (kt, kf, Ci, Co) -> (B, T, F, Co), stride-1 SAME
    with zero padding (plain loops: tiny test shapes only)."""
    bsz, t, f, ci = x.shape
    kt, kf, _, co = w.shape
    pt, pf = (kt - 1) // 2, (kf - 1) // 2
    xp = np.pad(x, ((0, 0), (pt, kt - 1 - pt), (pf, kf - 1 - pf), (0, 0)))
    y = np.zeros((bsz, t, f, co), np.float32)
    for dt in range(kt):
        for df in range(kf):
            y += np.einsum('btfi,io->btfo',
                           xp[:, dt:dt + t, df:df + f], w[dt, df])
    return y + b


def conv1d_same(x, w, b):
    """(B, T, Ci) * (k, Ci, Co) -> (B, T, Co), stride-1 SAME."""
    bsz, t, ci = x.shape
    k, _, co = w.shape
    p = (k - 1) // 2
    xp = np.pad(x, ((0, 0), (p, k - 1 - p), (0, 0)))
    y = np.zeros((bsz, t, co), np.float32)
    for dk in range(k):
        y += np.einsum('bti,io->bto', xp[:, dk:dk + t], w[dk])
    return y + b


def masked_batch_norm(x, seq_len, scale, shift, eps):
    """Training-mode masked BN: statistics over valid frames only
    (padded frames and, for 4-D input, all freq bins of valid frames);
    normalization applied at EVERY position."""
    mask = sequence_mask(seq_len, x.shape[1])
    mask = mask.reshape(mask.shape + (1,) * (x.ndim - 2))
    axes = tuple(range(x.ndim - 1))
    count = max((mask * np.ones_like(x)).sum(axis=axes).max(), 1.)
    mean = (x * mask).sum(axis=axes) / count
    var = (np.square(x - mean) * mask).sum(axis=axes) / count
    return (x - mean) / np.sqrt(var + eps) * scale + shift


def max_pool(x, window):
    """Non-overlapping max pool over (T, F) of (B, T, F, C) or (T,) of
    (B, T, C); window = (wt, wf) or (wt,)."""
    if x.ndim == 4:
        wt, wf = window
        b, t, f, c = x.shape
        t2, f2 = t // wt, f // wf
        x = x[:, :t2 * wt, :f2 * wf]
        x = x.reshape(b, t2, wt, f2, wf, c)
        return x.max(axis=(2, 4))
    (wt,) = window
    b, t, c = x.shape
    t2 = t // wt
    return x[:, :t2 * wt].reshape(b, t2, wt, c).max(axis=2)


def gru_layer(x, w_ih, w_hh, b_ih, b_hh, operand_dtype=None):
    """(B, T, F) -> (B, T, H); torch gate order (r, z, n), reset gate
    multiplying the candidate's RECURRENT term only. ``operand_dtype``
    (e.g. ``ml_dtypes.bfloat16``) rounds the operands of both matmuls to
    that type first, as a reduced-precision matmul does; products and
    sums, gates and state stay float32."""
    def rnd(a):
        a = np.asarray(a, np.float32)
        if operand_dtype is None:
            return a
        return a.astype(operand_dtype).astype(np.float32)

    b, t, f = x.shape
    hdim = w_hh.shape[0]
    xw = rnd(x) @ rnd(w_ih) + b_ih  # (B, T, 3H)
    w_hh = rnd(w_hh)
    h = np.zeros((b, hdim), np.float32)
    ys = np.zeros((b, t, hdim), np.float32)
    for i in range(t):
        hw = rnd(h) @ w_hh + b_hh
        xr, xz, xn = np.split(xw[:, i], 3, axis=-1)
        hr, hz, hn = np.split(hw, 3, axis=-1)
        r = sigmoid(xr + hr)
        z = sigmoid(xz + hz)
        n = np.tanh(xn + r * hn)
        h = (1. - z) * n + z * h
        ys[:, i] = h
    return ys


def reverse_sequence(x, seq_len, axis=1):
    """out[b, t] = x[b, sl_b - 1 - t] for t < sl_b; padding kept."""
    assert axis == 1
    out = x.copy()
    for b in range(x.shape[0]):
        sl = int(seq_len[b])
        if sl:
            out[b, :sl] = x[b, sl - 1::-1]
    return out


def cummax(x, axis):
    return np.maximum.accumulate(x, axis=axis)


def bce(y, t):
    y = np.clip(y, 1e-7, 1. - 1e-7)
    return -(t * np.log(y) + (1. - t) * np.log(1. - y))


# ---------------------------------------------------------------------
# model blocks (parameters read from the variables tree as data)
# ---------------------------------------------------------------------

def extractor(params, stft, seq_len, *, number_of_filters, sample_rate,
              stft_size, norm_eps=1e-5):
    """Training-mode front end: |STFT| -> mel -> log -> masked
    normalization (batch statistics) -> affine -> zero padding."""
    mag = np.sqrt(np.square(stft).sum(-1) + 1e-18)
    fbank = mel_filterbank(number_of_filters, sample_rate, stft_size)
    logmel = np.log(mag @ fbank + 1e-4)
    mask = sequence_mask(seq_len, logmel.shape[1])[:, :, None]
    # per-band statistics over (batch x valid frames)
    count = max(mask.sum(), 1.)
    mean = (logmel * mask).sum(axis=(0, 1)) / count
    var = (np.square(logmel - mean) * mask).sum(axis=(0, 1)) / count
    y = (logmel - mean) / np.sqrt(var + norm_eps)
    y = y * params['scale'] + params['shift']
    return y * mask


def cnn2d(params, x, seq_len, *, out_channels, kernel_size, pool_size,
          residual_connections=None, pre_activation=True, eps=1e-3):
    n = len(out_channels)
    kernels = kernel_size if isinstance(kernel_size, list) \
        else [kernel_size] * n
    pools = pool_size if isinstance(pool_size, list) else [pool_size] * n
    residuals = residual_connections or [None] * n
    pending = {}
    for i in range(n):
        h = x
        if pre_activation:
            norm = params[f'norm_{i}']
            h = masked_batch_norm(h, seq_len, norm['scale'],
                                  norm['shift'], eps)
            h = relu(h)
        k = kernels[i]
        kt, kf = (k, k) if not isinstance(k, (tuple, list)) else k
        conv = params[f'conv_{i}']
        h = conv2d_same(h, conv['kernel'], conv['bias'])
        if not pre_activation:
            norm = params[f'norm_{i}']
            h = masked_batch_norm(h, seq_len, norm['scale'],
                                  norm['shift'], eps)
            h = relu(h)
        if i in pending:
            for res in pending.pop(i):
                # average-pool mismatched dims, zero-pad grown channels
                st = res.shape[1] // h.shape[1] or 1
                sf = res.shape[2] // h.shape[2] or 1
                if st > 1 or sf > 1:
                    b_, t_, f_, c_ = res.shape
                    res = res[:, :t_ // st * st, :f_ // sf * sf]
                    res = res.reshape(b_, t_ // st, st, f_ // sf, sf, c_
                                      ).mean(axis=(2, 4))
                grow = h.shape[-1] - res.shape[-1]
                if grow:
                    res = np.pad(res, ((0, 0),) * 3 + ((0, grow),))
                h = h + res
        if residuals[i] is not None:
            pending.setdefault(int(residuals[i]), []).append(h)
        pool = pools[i]
        pf_, pt_ = (pool if isinstance(pool, (tuple, list))
                    else (pool, pool))
        if pf_ > 1 or pt_ > 1:
            h = max_pool(h, (pt_, pf_))
            if pt_ > 1:
                seq_len = -(-np.asarray(seq_len) // pt_)
        x = h
    return x, seq_len


def cnn1d(params, x, seq_len, *, out_channels, kernel_size,
          residual_connections=None, pre_activation=False,
          output_layer=False, eps=1e-3):
    n = len(out_channels)
    kernels = kernel_size if isinstance(kernel_size, list) \
        else [kernel_size] * n
    residuals = residual_connections or [None] * n
    pending = {}
    for i in range(n):
        is_output = output_layer and i == n - 1
        h = x
        if pre_activation and not is_output:
            norm = params[f'norm_{i}']
            h = masked_batch_norm(h, seq_len, norm['scale'],
                                  norm['shift'], eps)
            h = relu(h)
        conv = params[f'conv_{i}']
        w = conv['kernel']
        h = conv1d_same(h, w, conv['bias'])
        if not pre_activation and not is_output:
            norm = params[f'norm_{i}']
            h = masked_batch_norm(h, seq_len, norm['scale'],
                                  norm['shift'], eps)
            h = relu(h)
        if i in pending:
            for res in pending.pop(i):
                # zero-pad grown channels (identity skips, deep recipe
                # residual_connections_1d, training.py:171-178)
                grow = h.shape[-1] - res.shape[-1]
                if grow:
                    res = np.pad(res, ((0, 0), (0, 0), (0, grow)))
                h = h + res
        if residuals[i] is not None:
            pending.setdefault(int(residuals[i]), []).append(h)
        x = h
    return x, seq_len


def gru_head(params, x, seq_len, *, num_layers, output_net_cfg,
             reverse=False):
    """GRU + 1x1-conv output net, the reference recurrent head; with
    ``reverse`` the input is sequence-reversed before the recurrence and
    the output reversed back (backward FBCRNN head)."""
    h = x
    if reverse:
        h = reverse_sequence(h, seq_len, axis=1)
    core = params['rnn']
    for i in range(num_layers):
        lp = core[f'layer_{i}_fwd']
        h = gru_layer(h, lp['w_ih'], lp['w_hh'], lp['b_ih'], lp['b_hh'])
    if reverse:
        h = reverse_sequence(h, seq_len, axis=1)
    y, _ = cnn1d(params['output_net'], h, seq_len, **output_net_cfg)
    return y


def bigru(params, x, seq_len, *, num_layers):
    """Bidirectional stacked GRU: per layer fwd || reversed-bwd concat."""
    h = x
    for i in range(num_layers):
        lp = params[f'layer_{i}_bi']
        fwd = gru_layer(h, lp['w_ih'][0], lp['w_hh'][0],
                        lp['b_ih'][0, 0], lp['b_hh'][0, 0])
        rev = reverse_sequence(h, seq_len, axis=1)
        bwd = gru_layer(rev, lp['w_ih'][1], lp['w_hh'][1],
                        lp['b_ih'][1, 0], lp['b_hh'][1, 0])
        bwd = reverse_sequence(bwd, seq_len, axis=1)
        h = np.concatenate([fwd, bwd], axis=-1)
    return h


# ---------------------------------------------------------------------
# full models
# ---------------------------------------------------------------------

def fbcrnn_forward(variables, batch, cfg, minimum_score=1e-5):
    """Returns (y_fwd, y_bwd, seq_len_y) with y time-last (B, K, T)."""
    p = variables['params']
    x = extractor(p['feature_extractor'], batch['stft'],
                  batch['seq_len'], **cfg['feature_extractor'])
    seq_len = np.asarray(batch['seq_len'])
    h, seq_len = cnn2d(p['cnn']['cnn_2d'], x[..., None], seq_len,
                       **cfg['cnn_2d'])
    b, t, f, c = h.shape
    h = h.reshape(b, t, f * c)
    h, seq_len = cnn1d(p['cnn']['cnn_1d'], h, seq_len, **cfg['cnn_1d'])
    bound = lambda y: minimum_score + (1. - 2. * minimum_score) * sigmoid(y)
    y_fwd = bound(gru_head(p['rnn_fwd'], h, seq_len, **cfg['rnn']))
    y_bwd = bound(gru_head(p['rnn_bwd'], h, seq_len, reverse=True,
                           **cfg['rnn']))
    return (np.swapaxes(y_fwd, 1, 2), np.swapaxes(y_bwd, 1, 2), seq_len)


def fbcrnn_tagging(y_fwd, y_bwd, seq_len):
    last = np.stack([y_fwd[b, :, seq_len[b] - 1]
                     for b in range(y_fwd.shape[0])])
    return (last[..., None] + y_bwd[..., :1]) / 2


def fbcrnn_boundaries(y_fwd, y_bwd, seq_len):
    mask = sequence_mask(seq_len, y_fwd.shape[-1])[:, None, :]
    return np.minimum(y_fwd * mask, y_bwd * mask)


def fbcrnn_loss(y_fwd, y_bwd, seq_len, weak_targets, boundary_targets,
                strong_fwd_bwd_loss_weight=1.):
    """Reference loss semantics (weak_label/crnn.py:107-206)."""
    wt_mask = ((weak_targets < .01) | (weak_targets > .99)).astype(
        np.float32)
    weak_targets = weak_targets * wt_mask
    y_weak = np.maximum(y_fwd, y_bwd)
    loss = bce(y_weak, weak_targets[..., None]) * wt_mask[..., None]
    if strong_fwd_bwd_loss_weight > 0.:
        bt = boundary_targets
        bt_mask = ((bt > .99) | (bt < .01)).astype(np.float32)
        frame_mask = sequence_mask(seq_len, bt.shape[-1])[:, None, :]
        denom = np.maximum(frame_mask.sum(-1, keepdims=True), 1.)
        fully = ((bt_mask * frame_mask).sum(-1, keepdims=True) / denom
                 > .999).astype(np.float32)
        bt_mask = bt_mask * fully * (
            weak_targets > .99)[..., None] * frame_mask
        t_fwd = cummax(bt, axis=-1)
        t_bwd = cummax(bt[..., ::-1], axis=-1)[..., ::-1]
        strong = bce(y_fwd, t_fwd) / 2 + bce(y_bwd, t_bwd) / 2
        w = bt_mask * strong_fwd_bwd_loss_weight
        loss = w * strong + (1. - w) * loss
    frame_mask = sequence_mask(seq_len, loss.shape[-1])[:, None, :]
    loss = (loss * frame_mask).sum(-1) / np.maximum(
        frame_mask.sum(-1), 1.)
    return (loss * wt_mask).sum() / max(wt_mask.sum(), 1.)


def bicrnn_forward(variables, batch, cfg):
    """Returns (y (B, K, T), seq_len_y); optional tag conditioning."""
    p = variables['params']
    x = extractor(p['feature_extractor'], batch['stft'],
                  batch['seq_len'], **cfg['feature_extractor'])
    seq_len = np.asarray(batch['seq_len'])
    h4 = x[..., None]
    cond = batch.get('tag_condition') if cfg.get('tag_conditioning') \
        else None
    if cond is not None:
        b, t, f, _ = h4.shape
        h4 = np.concatenate(
            [h4, np.broadcast_to(cond[:, None, None, :],
                                 (b, t, f, cond.shape[-1]))], axis=-1)
    h, seq_len = cnn2d(p['cnn']['cnn_2d'], h4, seq_len, **cfg['cnn_2d'])
    b, t, f, c = h.shape
    h = h.reshape(b, t, f * c)
    h, seq_len = cnn1d(p['cnn']['cnn_1d'], h, seq_len, **cfg['cnn_1d'])
    if cond is not None:
        h = np.concatenate(
            [h, np.broadcast_to(cond[:, None, :],
                                (b, h.shape[1], cond.shape[-1]))],
            axis=-1)
    rp = p['rnn']
    y = bigru(rp['rnn'], h, seq_len,
              num_layers=cfg['rnn']['num_layers'])
    y, _ = cnn1d(rp['output_net'], y, seq_len, **cfg['rnn']['output_net_cfg'])
    return np.swapaxes(sigmoid(y), 1, 2), seq_len


def bicrnn_loss(y, seq_len, strong_targets):
    st_mask = ((strong_targets > .99) | (strong_targets < .01)).astype(
        np.float32)
    frame_mask = sequence_mask(seq_len, y.shape[-1])[:, None, :]
    st_mask = st_mask * frame_mask
    return (bce(y, strong_targets) * st_mask).sum() / max(
        st_mask.sum(), 1.)
