#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (mxnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Refuses to run without a CUDA device; prints the card's name and power
   limit as nvidia-smi reports them.
2. Builds the CUDA kernels from mxnet_tpu_torch/csrc with nvcc (all
   sources at once) and prints the -Xptxas -v summary on one line.
3. Kernel phase: each hand-written kernel (flash-attention forward, fused
   residual+LayerNorm, fused FFN1) against its plain PyTorch version on
   the same inputs on the card, at the serving path's shapes (B = 8,
   T in {128, 512}, bf16 and f32; attention also causal, with a key mask,
   with dropout and at a ragged T), with the tolerance stated beside each
   comparison. Times each kernel, its plain version and one PyTorch
   library call that computes the same function (a yardstick only: the
   port never calls it) as device time from torch.profiler's CUDA trace
   (CUDA events where the trace has none), and computes each kernel's
   bound from the H100 SXM data sheet.
4. Serving phase: BERT-base at full width, weights drawn with numpy from
   a fixed seed (Normal(0.02)) and cast to bf16 on the card, served by
   InferenceEngine with both fused-kernel knobs on. The launch counters
   are set to 0 just before 64 ragged requests from 4 client threads and
   read just after: every kernel must have run 12, 24 and 12 times per
   dispatch. One request is checked against the same weights in f32 on
   the CPU through the plain versions, and again with both knobs off.
   A profiled dispatch of the largest bucket (8 x 512) prints where the
   device time goes and the device's idle share.
5. Prints the kernels' JSON line and, last, the result line.

Any failed check raises: the script exits non-zero and prints no result.
"""
import json
import os
import subprocess
import sys
import threading
import time

SEED = 20261016
PEAK_BF16 = 989e12     # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
PEAK_F32 = 67e12       # H100 SXM f32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12      # H100 SXM HBM3 bytes/s


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke check failed: {msg}')


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def stream_ms(fn, iters=20, warmup=3):
    """Mean stream time of one call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls (inputs stay warm in L2).
    Where the host takes longer to launch a call than the card to run
    it, this is the host's launch time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _dev_us(evt):
    t = getattr(evt, 'self_device_time_total', None)
    return t if t is not None else getattr(evt, 'self_cuda_time_total', 0)


def profile_device(fn, iters):
    """torch.profiler CUDA trace of ``iters`` calls: {kernel name: total
    device microseconds} and the host seconds the calls took."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return ({e.key: _dev_us(e) for e in prof.key_averages()
             if _dev_us(e) > 0}, wall)


def time_ms(fn, iters=20):
    """(ms, how): the mean device time of one call — the summed durations
    of the kernels it ran, from the profiler's trace — or, where the trace
    holds no device time, the CUDA-event stream time."""
    per_kernel, _ = profile_device(fn, iters)
    total = sum(per_kernel.values())
    if total > 0:
        return total / iters / 1e3, 'profiler'
    return stream_ms(fn, iters), 'events'


def bound_ms(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BPS
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops > t_bytes
                                       else 'bytes')


def compare(name, got, want, atol, rtol):
    """max |got - want| and max relative error; fails unless every
    element is within atol + rtol * |want|."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs()
    max_abs = float(err.max())
    max_rel = float((err / w.abs().clamp_min(1e-6)).max())
    ok = bool(torch.isfinite(g).all()) and bool(
        (err <= atol + rtol * w.abs()).all())
    print(f'  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} '
          f'tolerance atol={atol} rtol={rtol} -> {"ok" if ok else "FAIL"}')
    check(ok, f'{name} disagrees with its plain version')
    return max_abs


def timings(kernel, plain, library):
    """Device times of a kernel's wrapper, its plain version and the
    library yardstick, plus the kernel's back-to-back stream time."""
    ms, how = time_ms(kernel)
    return dict(ms=ms, how=how, stream_ms=stream_ms(kernel),
                plain_ms=time_ms(plain)[0], library_ms=time_ms(library)[0])


# tolerances, kernel vs plain version on the same inputs on the card:
# f32 differs only by summation order; bf16 outputs may differ by one or
# two bf16 ulps (2**-8 relative) where the two round differently
TOL = {'float32': dict(atol=1e-4, rtol=1e-4),
       'bfloat16': dict(atol=1e-2, rtol=1.6e-2)}


def kernel_phase(card):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import fused_ffn, fused_layernorm

    gen = torch.Generator(device='cuda').manual_seed(SEED)
    dev = 'cuda'
    rows = {}
    H, D, C, FF = 12, 64, 768, 3072

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) *
                scale).to(dtype)

    print(f'kernel phase on {card}')
    # ---- A: flash-attention forward
    cases = [(8, 128, torch.bfloat16, {}), (8, 128, torch.float32, {}),
             (8, 512, torch.float32, {}),
             (8, 512, torch.bfloat16, {'causal': True}),
             (8, 512, torch.bfloat16, {'mask': True}),
             (8, 512, torch.bfloat16, {'dropout_p': 0.1}),
             (8, 200, torch.bfloat16, {'mask': True, 'causal': True}),
             (8, 512, torch.bfloat16, {})]      # the main shape, timed
    for B, T, dtype, opt in cases:
        q, k, v = (randn(B, H, T, D, dtype=dtype) for _ in range(3))
        key_mask = None
        if opt.get('mask'):
            valid = torch.randint(1, T + 1, (B,), generator=gen, device=dev)
            key_mask = torch.arange(T, device=dev)[None, :] < valid[:, None]
        kw = dict(key_mask=key_mask, causal=opt.get('causal', False),
                  dropout_p=opt.get('dropout_p', 0.0),
                  dropout_seed=1234 if opt.get('dropout_p') else None)
        out, lse = fa.flash_attention_forward(q, k, v, **kw)
        torch.cuda.synchronize()
        km, _ = fa._normalize_mask(key_mask, B, H, T)
        ref_out, ref_lse = fa.flash_attention_reference(
            q, k, v, km, kw['causal'], kw['dropout_p'], kw['dropout_seed'])
        tag = f'flash_attn_fwd B={B} T={T} {str(dtype)[6:]} {opt or "plain"}'
        tol = TOL[str(dtype)[6:]]
        err = compare(tag + ' out', out, ref_out, **tol)
        compare(tag + ' lse', lse, ref_lse, **TOL['float32'])
    times = timings(lambda: fa.flash_attention(q, k, v),
                    lambda: fa.flash_attention_reference(q, k, v),
                    lambda: F.scaled_dot_product_attention(q, k, v))
    nbytes = 4 * q.numel() * q.element_size() + B * H * T * 4
    b_ms, b_by = bound_ms(4 * B * H * T * T * D, nbytes, PEAK_BF16)
    rows['flash_attn_fwd'] = dict(
        route='cuda', source='mxnet_tpu_torch/csrc/flash_attn_fwd.cu',
        replaces='mxnet_tpu/ops/pallas_attention.py:171',
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **times)

    # ---- B: fused residual + LayerNorm
    for B, T, dtype in [(8, 128, torch.float32), (8, 512, torch.float32),
                        (8, 128, torch.bfloat16), (8, 512, torch.bfloat16)]:
        x, r = randn(B, T, C, dtype=dtype), randn(B, T, C, dtype=dtype)
        g = (1 + randn(C, dtype=torch.float32, scale=0.1)).to(dtype)
        b = randn(C, dtype=dtype, scale=0.1)
        out = fused_layernorm.fused_add_layer_norm(x, r, g, b, 1e-5)
        torch.cuda.synchronize()
        ref = fused_layernorm.add_layer_norm_reference(x, r, g, b, 1e-5)
        d = str(dtype)[6:]
        err = compare(f'fused_add_layernorm N={B * T} C={C} {d}', out, ref,
                      **({'atol': 1e-4, 'rtol': 0} if d == 'float32'
                         else {'atol': 0.05, 'rtol': 0}))
    times = timings(
        lambda: fused_layernorm.fused_add_layer_norm(x, r, g, b),
        lambda: fused_layernorm.add_layer_norm_reference(x, r, g, b),
        lambda: F.layer_norm(x + r, (C,), g, b, 1e-5))
    N = B * T
    b_ms, b_by = bound_ms(7 * N * C, (3 * N * C + 2 * C) * x.element_size(),
                          PEAK_F32)
    rows['fused_add_layernorm'] = dict(
        route='triton', source='mxnet_tpu_torch/ops/fused_layernorm.py',
        replaces='mxnet_tpu/ops/pallas_layernorm.py:33',
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **times)

    # ---- C: fused FFN1 dense + bias + GELU
    for B, T, dtype in [(8, 128, torch.float32), (8, 512, torch.float32),
                        (8, 128, torch.bfloat16), (8, 512, torch.bfloat16)]:
        x = randn(B * T, C, dtype=dtype)
        w = randn(FF, C, dtype=dtype, scale=0.02)
        b = randn(FF, dtype=dtype, scale=0.02)
        out = fused_ffn.fused_dense_gelu(x, w, b)
        torch.cuda.synchronize()
        ref = fused_ffn.dense_gelu_reference(x, w, b)
        err = compare(f'dense_gelu M={B * T} K={C} N={FF} {str(dtype)[6:]}',
                      out, ref, **TOL[str(dtype)[6:]])
    times = timings(lambda: fused_ffn.fused_dense_gelu(x, w, b),
                    lambda: fused_ffn.dense_gelu_reference(x, w, b),
                    lambda: F.gelu(F.linear(x, w, b)))
    M = B * T
    b_ms, b_by = bound_ms(2 * M * FF * C,
                          (M * C + FF * C + FF + M * FF) * x.element_size(),
                          PEAK_BF16)
    rows['dense_gelu'] = dict(
        route='cuda', source='mxnet_tpu_torch/csrc/dense_gelu.cu',
        replaces='mxnet_tpu/ops/pallas_ffn.py:48',
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **times)

    for name, r in rows.items():
        print(f'  timing {name} (bf16, B=8 T=512) on {card}: device time '
              f'({r["how"]}) kernel {r["ms"]:.4f} ms, plain '
              f'{r["plain_ms"]:.4f} ms, library {r["library_ms"]:.4f} ms; '
              f'bound {r["bound_ms"]:.4f} ms ({r["bound_by"]}); back-to-back '
              f'stream time of the kernel {r["stream_ms"]:.4f} ms')
    return rows


_FAMILIES = (('flash_attn_fwd', ('flash_fwd_kernel',)),
             ('fused_add_layernorm', ('_add_ln_fwd',)),
             ('dense_gelu', ('dense_gelu_',)),
             ('library GEMMs', ('gemm', 'nvjet', 'cutlass', 'xmma')))


def dispatch_breakdown(engine, card, batch=8, seq=512, iters=3):
    """Device time of one dispatch of the largest bucket by kernel family,
    from torch.profiler's CUDA trace, and the device's idle share: one
    minus the kernels' summed time over the dispatch's host time (tokens
    in, output back to the host included)."""
    per_kernel, wall = profile_device(
        lambda: engine.run_bucket(batch, seq), iters)
    fam = {}
    for name, us in per_kernel.items():
        f = next((f for f, pats in _FAMILIES
                  if any(p in name for p in pats)), 'other')
        fam[f] = fam.get(f, 0.0) + us / iters / 1e3
    busy = sum(fam.values())
    per = wall / iters * 1e3
    print(f'  dispatch b{batch}_s{seq} on {card}: host {per:.3f} ms, '
          f'device busy {busy:.3f} ms, idle share '
          f'{max(0.0, 1 - busy / per):.3f}; by family: ' + ', '.join(
              f'{f} {ms:.3f} ms ({ms / busy:.1%})' for f, ms in
              sorted(fam.items(), key=lambda kv: -kv[1])))
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    print('  top kernels per dispatch: ' + '; '.join(
        f'{n[:60]} {us / iters / 1e3:.3f} ms' for n, us in top))


def random_bert_arrays(net):
    """Normal(0.02) for every weight, drawn with numpy from SEED; gamma,
    beta and biases keep their constructed one/zero."""
    import numpy as onp
    rng = onp.random.RandomState(SEED)
    arrays = {}
    for name, p in net.named_parameters():
        if name.endswith('weight'):
            arrays[name] = (rng.standard_normal(tuple(p.shape))
                            .astype(onp.float32) * onp.float32(0.02))
        else:
            arrays[name] = p.detach().float().cpu().numpy()
    return arrays


def serving_phase(card):
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models.bert import BertModel, bert_base_config
    from mxnet_tpu_torch.ops import attention as attn_ops
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu

    os.environ['MXTPU_PALLAS_LN'] = '1'
    os.environ['MXTPU_PALLAS_FFN'] = '1'
    cfg = bert_base_config()
    net = BertModel(**cfg, dtype=torch.bfloat16, device='cuda')
    arrays = random_bert_arrays(net)
    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    engine = mt.serving.InferenceEngine(
        mt.serving.BlockRunner(net), seq_buckets='64,128,256,512',
        batch_buckets='1,2,4,8')
    try:
        t0 = time.perf_counter()
        rep = mt.serving.warmup(engine)
        print(f'serving phase on {card}: BERT-base bf16, warmup of '
              f'{len(rep["buckets"])} buckets took '
              f'{time.perf_counter() - t0:.2f} s')

        rng = onp.random.RandomState(SEED)
        requests = [rng.randint(1, cfg['vocab_size'], int(n)).tolist()
                    for n in rng.randint(8, 513, 64)]
        results, errors = [None] * len(requests), []

        def client(idx):
            try:
                handles = [(i, engine.submit_async(requests[i])) for i in idx]
                for i, h in handles:
                    results[i] = engine.result(h, timeout=300.0)
            except Exception as e:                    # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=client,
                                    args=(range(t, len(requests), 4),))
                   for t in range(4)]
        # the main path's run: counters at 0 just before, read just after
        batches0 = engine.stats()['batches']
        mt.ops.reset_launch_counts()
        for k in attn_ops.route_counts:
            attn_ops.route_counts[k] = 0
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = dict(mt.ops.launch_counts)
        routes = dict(attn_ops.route_counts)
        stats = engine.stats()
        dispatches = stats['batches'] - batches0

        check(not any(t.is_alive() for t in threads), 'a client hung')
        check(not errors, f'client errors: {errors!r}')
        check(all(r is not None for r in results), 'a request went unanswered')
        for req, out in zip(requests, results):
            check(out.shape == (len(req), cfg['hidden']),
                  f'output shape {out.shape} for length {len(req)}')
            check(bool(onp.isfinite(out).all()), 'non-finite output')
        L = cfg['layers']
        print(f'  dispatches={dispatches} launches={launches} '
              f'routes={routes}')
        check(routes['flash'] > 0, 'attention never took the flash route')
        check(launches == {'flash_attn_fwd': L * dispatches,
                           'fused_add_layernorm': 2 * L * dispatches,
                           'dense_gelu': L * dispatches},
              f'launch counts {launches} for {dispatches} dispatches')
        print(f'  served {len(requests)} requests in {wall:.3f} s: '
              f'{len(requests) / wall:.2f} requests/s, '
              f'p50 {stats["p50_ms"]} ms, p99 {stats["p99_ms"]} ms, '
              f'shed {stats["shed"]} on {card}')
        dispatch_breakdown(engine, card)

        # one request against the same weights in f32 on the CPU (plain
        # versions throughout); bf16 through 12 layers is expected to
        # stay within a few percent
        req = requests[0]
        s = mt.serving.seq_bucket_for(len(req), engine.seq_buckets)
        cpu = BertModel(**cfg, device='cpu').eval()
        cpu.load_state_dict(params_from_mxnet_tpu(arrays, cpu))
        tok = torch.zeros(1, s, dtype=torch.int64)
        tok[0, :len(req)] = torch.tensor(req)
        with torch.inference_mode():
            want = cpu(tok)[0][0, :len(req)].numpy()

        def agree(name, got):
            err = onp.abs(got - want)
            rel = float(onp.linalg.norm(got - want) / onp.linalg.norm(want))
            ok = float(err.max()) <= 0.5 and rel <= 0.05
            print(f'  {name} vs f32 CPU plain (length {len(req)}): '
                  f'max_abs_err={float(err.max()):.4f} '
                  f'rel_fro_err={rel:.5f} tolerance max_abs<=0.5 '
                  f'rel_fro<=0.05 -> {"ok" if ok else "FAIL"}')
            check(ok, f'{name} disagrees with the f32 CPU reference')

        agree('served bf16, all three kernels', results[0])
        os.environ['MXTPU_PALLAS_LN'] = '0'
        os.environ['MXTPU_PALLAS_FFN'] = '0'
        agree('served bf16, flash only', engine.submit(req, timeout=300.0))
    finally:
        engine.drain()
    return launches, stats, len(requests) / wall


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs only on the card',
              file=sys.stderr)
        return 2
    from mxnet_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f'card: {card} ({torch.cuda.get_device_name(0)}, torch '
          f'{torch.__version__}, CUDA {torch.version.cuda})')
    t0 = time.perf_counter()
    _build.build_all()
    print(f'build: nvcc of {len(_build.SOURCES)} sources in '
          f'{time.perf_counter() - t0:.1f} s')
    print('ptxas: ' + ' | '.join(_build.ptxas_report()))

    rows = kernel_phase(card)
    launches, _stats, _rps = serving_phase(card)
    kernels = [dict(name=name, route=r['route'], source=r['source'],
                    replaces=r['replaces'], launches=launches[name],
                    max_abs_err=r['max_abs_err'], ms=r['ms'],
                    plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
                    bound_by=r['bound_by'], library_ms=r['library_ms'])
               for name, r in rows.items()]
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
