"""Layer probes on one GPU: the plain conv2d tower, the GRU scan at
several unrolls, the STFT and the time-reversal roll.

Run on the card from the repository root:

    python scripts/perf/gpu_probe.py [--probes tower,gru,stft,roll]
                                     [--out chiprun_out/gpu_probe]

Times are host-clock throughput (``n`` back-to-back calls, then
``block_until_ready``), so per-call launch overhead is amortised and the
figure approaches device time for device-bound calls.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def throughput_ms(fn, *args, n=30):
    import jax
    jax.block_until_ready(fn(*args))  # compile
    jax.block_until_ready(fn(*args))
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = fn(*args)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / n * 1e3
        best = dt if best is None else min(best, dt)
    return round(best, 4)


def gru_scan(xw, w_hh, b_hh, h0, unroll):
    """``ops.rnn.gru_scan`` traced with ``unroll`` timesteps per scan
    iteration in place of the module's ``_SCAN_UNROLL``."""
    from pb_sed_tpu.ops import rnn
    saved = rnn._SCAN_UNROLL
    rnn._SCAN_UNROLL = unroll
    try:
        return rnn.gru_scan(xw, w_hh, b_hh, h0)
    finally:
        rnn._SCAN_UNROLL = saved


def probe_gru(results):
    import jax
    import jax.numpy as jnp
    rng = np.random.RandomState(0)
    b, t = 32, 501
    for d, hdim, unrolls in ((2, 256, (1, 2, 4, 8, 16)), (1, 256, (1, 8)),
                             (2, 512, (1, 8))):
        xw = jnp.asarray(rng.randn(d, b, t, 3 * hdim).astype(np.float32))
        w_hh = jnp.asarray((rng.randn(d, hdim, 3 * hdim)
                            / np.sqrt(hdim)).astype(np.float32))
        b_hh = jnp.asarray(
            .1 * rng.randn(d, 1, 3 * hdim).astype(np.float32))
        h0 = jnp.zeros((d, b, hdim), jnp.float32)
        for unroll in unrolls:
            fwd = jax.jit(lambda *a, u=unroll: gru_scan(*a, u))
            grad = jax.jit(jax.grad(
                lambda *a, u=unroll: jnp.sum(jnp.square(gru_scan(*a, u))),
                argnums=(0, 1, 2)))
            key = f'gru_D{d}_H{hdim}_unroll{unroll}'
            results[key + '_fwd_ms'] = throughput_ms(
                fwd, xw, w_hh, b_hh, h0, n=10)
            results[key + '_fwdgrad_ms'] = throughput_ms(
                grad, xw, w_hh, b_hh, h0, n=10)
            print(key, results[key + '_fwd_ms'],
                  results[key + '_fwdgrad_ms'], flush=True)


def probe_stft(results):
    import jax
    import jax.numpy as jnp
    from pb_sed_tpu.ops.stft import STFT
    rng = np.random.RandomState(0)
    audio = jnp.asarray(rng.randn(32, 160000).astype(np.float32))
    valid = jnp.full((32,), 160000, jnp.int32)
    a_out = jnp.asarray(rng.uniform(.4, .6, 32) * 160000, jnp.float32)
    a_in = a_out + jnp.asarray(rng.uniform(-.1, .1, 32) * 160000,
                               jnp.float32)
    stft = STFT(shift=320, window_length=960, size=1024)
    results['stft_ms'] = throughput_ms(jax.jit(stft.magnitude), audio)
    results['stft_warped_ms'] = throughput_ms(
        jax.jit(stft.magnitude_warped), audio, a_out, a_in, valid)
    print('stft', results['stft_ms'], results['stft_warped_ms'],
          flush=True)


def probe_roll(results):
    import jax
    import jax.numpy as jnp
    from pb_sed_tpu.ops.masking import reverse_sequence
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(32, 500, 256).astype(np.float32))
    sl = jnp.asarray(rng.randint(250, 501, 32).astype(np.int32))
    w = jnp.asarray(rng.randn(32, 500, 256).astype(np.float32))
    fwd = jax.jit(lambda x, s: reverse_sequence(x, s, 1))
    grad = jax.jit(jax.grad(lambda x, s: jnp.sum(
        reverse_sequence(x, s, 1) * w)))
    results['roll_fwd_ms'] = throughput_ms(fwd, x, sl)
    results['roll_fwdgrad_ms'] = throughput_ms(grad, x, sl)
    print('roll', results['roll_fwd_ms'], results['roll_fwdgrad_ms'],
          flush=True)


def probe_tower(results, out_dir):
    """The conv2d tower (CNN2d) of the shallow (bs=32) and deep width-2
    (bs=16) recipes on 10 s of 128 log-mels: forward (running stats)
    and forward+grad (training, batch statistics), with per-conv kernel
    time from a trace."""
    import jax
    import jax.numpy as jnp
    from pb_sed_tpu.models.net_configs import cnn_config
    from pb_sed_tpu.ops.cnn import CNN2d
    from pb_sed_tpu.utils import xplane
    for net, bs in (('shallow', 32), ('deep', 16)):
        cfg = dict(cnn_config(net)[1]['cnn_2d'])
        tower = CNN2d(**cfg, name='cnn_2d')
        rng = np.random.RandomState(0)
        x = jnp.asarray(rng.randn(bs, 500, 128, 1).astype(np.float32))
        seq_len = jnp.full((bs,), 500, jnp.int32)
        variables = jax.jit(lambda x, s: tower.init(
            jax.random.PRNGKey(0), x, s))(x, seq_len)
        fwd = jax.jit(lambda v, x, s: tower.apply(v, x, s)[0])

        def loss(params, v, x, s):
            (y, _), _ = tower.apply({**v, 'params': params}, x, s,
                                    training=True,
                                    mutable=['batch_stats'])
            return jnp.sum(jnp.square(y.astype(jnp.float32)))

        grad = jax.jit(jax.grad(loss))
        key = f'tower_{net}_bs{bs}'
        results[key + '_fwd_ms'] = throughput_ms(
            fwd, variables, x, seq_len, n=10)
        results[key + '_fwdgrad_ms'] = throughput_ms(
            grad, variables['params'], variables, x, seq_len, n=10)
        for name, fn, args in (
                ('fwd', fwd, (variables, x, seq_len)),
                ('fwdgrad', grad,
                 (variables['params'], variables, x, seq_len))):
            tdir = out_dir / f'trace_{key}_{name}'
            with jax.profiler.trace(str(tdir)):
                for i in range(3):
                    with jax.profiler.StepTraceAnnotation('s', step_num=i):
                        jax.block_until_ready(fn(*args))
            scopes = xplane.kernel_breakdown_ms(tdir, key='scope')
            per_conv = {}
            for scope, (ms, _) in scopes.items():
                for part in scope.split('/'):
                    if part.startswith(('conv_', 'norm_')):
                        per_conv[part] = per_conv.get(part, 0.) + ms / 3
                        break
            results[f'{key}_{name}_device_ms'] = float(np.median(
                xplane.device_step_times_ms(tdir)))
            results[f'{key}_{name}_per_layer_ms'] = {
                k: round(v, 4) for k, v in sorted(per_conv.items())}
        print(key, {k: v for k, v in results.items() if k.startswith(key)},
              flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--out', default='chiprun_out/gpu_probe')
    parser.add_argument('--probes', default='tower,gru,stft,roll')
    args = parser.parse_args()
    probes = args.probes.split(',')
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from pb_sed_tpu.utils.device import (
        configure_compile_cache, gpu_name_power_limit, require_gpu)
    configure_compile_cache()
    import jax
    dev = require_gpu()[0]
    results = {'nvidia_smi': gpu_name_power_limit(),
               'device_kind': dev.device_kind, 'jax': jax.__version__}
    print(json.dumps(results), flush=True)
    for name, probe in (('tower', lambda r: probe_tower(r, out_dir)),
                        ('stft', probe_stft), ('roll', probe_roll),
                        ('gru', probe_gru)):
        if name in probes:
            probe(results)
            (out_dir / 'results.json').write_text(
                json.dumps(results, indent=1))
    print(json.dumps(results))


if __name__ == '__main__':
    main()
