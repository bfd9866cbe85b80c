#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (mxnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Refuses to run without a CUDA device; prints the card's name and power
   limit as nvidia-smi reports them.
2. Builds the CUDA kernels from mxnet_tpu_torch/csrc with nvcc (all
   sources at once) and prints the -Xptxas -v summary on one line.
3. Kernel phase: each hand-written kernel (flash-attention forward, its
   backward's dq and dk/dv kernels, fused residual+LayerNorm, fused FFN1)
   against its plain PyTorch version on the same inputs on the card, at
   the main paths' shapes (B = 8, T in {128, 512}, bf16 and f32;
   attention also causal, with a key mask, with dropout and at a ragged
   T), with the tolerance stated beside each comparison. Times each
   kernel, its plain version and one PyTorch library call that computes
   the same function (a yardstick only: the port never calls it) as
   device time from torch.profiler's CUDA trace (CUDA events where the
   trace has none), and computes each kernel's bound from the H100 SXM
   data sheet.
4. Serving phase: BERT-base at full width, weights drawn with numpy from
   a fixed seed (Normal(0.02)) and cast to bf16 on the card, served by
   InferenceEngine with both fused-kernel knobs on. The launch counters
   are set to 0 just before 64 ragged requests from 4 client threads and
   read just after: every kernel must have run 12, 24 and 12 times per
   dispatch. One request is checked against the same weights in f32 on
   the CPU through the plain versions, and again with both knobs off.
   A profiled dispatch of the largest bucket (8 x 512) prints where the
   device time goes and the device's idle share.
5. Training phase: BERT-base BertForPretraining at full width in bf16,
   the same numpy weights, both knobs on, so all five kernels run. First
   one step at B = 2 with dropout 0 against the same weights in f32 on the
   CPU through the plain versions (loss, and every gradient). Then, with
   dropout 0.1 drawn on the card, the flagship batch (B = 8, T = 512,
   valid_length in [256, 512], 72 masked positions per row) through
   gluon.Trainer/AdamW (multi_precision): a warm-up step, then 5 timed
   steps with the launch counters set to 0 just before and read just
   after (12 forward, 12 dq, 12 dk/dv, 24 LayerNorm and 12 FFN1 launches
   per step), step time, samples/s and MFU, and a profiled step.
6. Prints the kernels' JSON line and, last, the result line.

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
    (ms, how), (plain_ms, plain_how), (library_ms, library_how) = (
        time_ms(fn) for fn in (kernel, plain, library))
    return dict(ms=ms, how=f'{how}/{plain_how}/{library_how}',
                stream_ms=stream_ms(kernel), plain_ms=plain_ms,
                library_ms=library_ms)


# tolerances, kernel vs plain version on the same inputs on the card:
# f32 differs only by summation order; bf16 outputs may differ by one or
# two bf16 ulps (2**-8 relative) where the two round differently
TOL = {'float32': dict(atol=1e-4, rtol=1e-4),
       'bfloat16': dict(atol=1e-2, rtol=1.6e-2)}
# one BERT-base training step in bf16 on the card against f32 on the CPU
# (chosen before the first run; see PERF.md section 2)
TRAIN_TOL = {'loss_rel': 0.01, 'grad_rel_fro': 0.1, 'grad_min_cos': 0.95}


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

    # ---- K2, K3: flash-attention backward (dq; dk and dv)
    for B, T, dtype, opt in cases:
        q, k, v, do = (randn(B, H, T, D, dtype=dtype) for _ in range(4))
        key_mask = None
        if opt.get('mask'):
            valid = torch.randint(1, T + 1, (B,), generator=gen, device=dev)
            key_mask = torch.arange(T, device=dev)[None, :] < valid[:, None]
        causal, p = opt.get('causal', False), opt.get('dropout_p', 0.0)
        seed = 1234 if p else None
        out, lse = fa.flash_attention_forward(q, k, v, key_mask, causal, p,
                                              seed)
        grads = fa.flash_attention_backward(q, k, v, key_mask, causal, p,
                                            seed, out, lse, do)
        torch.cuda.synchronize()
        km, _ = fa._normalize_mask(key_mask, B, H, T)
        want = fa.flash_attention_backward_reference(q, k, v, km, causal, p,
                                                     seed, out, lse, do)
        tag = f'flash_attn_bwd B={B} T={T} {str(dtype)[6:]} {opt or "plain"}'
        errs = [compare(f'{tag} d{n}', g, w, **TOL[str(dtype)[6:]])
                for n, g, w in zip('qkv', grads, want)]
    # timed at the training path's shape: bf16, B=8, T=512, with a float
    # additive key mask as the valid_length mask is
    valid = torch.randint(T // 2, T + 1, (B,), generator=gen, device=dev)
    fmask = torch.where(torch.arange(T, device=dev)[None, :] < valid[:, None],
                        0.0, -1e30).float()
    out, lse = fa.flash_attention_forward(q, k, v, fmask)

    def backward():
        return fa.flash_attention_backward(q, k, v, fmask, False, 0.0, None,
                                           out, lse, do)
    per_kernel, _ = profile_device(backward, 20)
    bwd_stream_ms = stream_ms(backward)
    km, _ = fa._normalize_mask(fmask, B, H, T)
    plain_ms, plain_how = time_ms(
        lambda: fa.flash_attention_backward_reference(
            q, k, v, km, False, 0.0, None, out, lse, do))
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=fmask.to(dtype)[:, None, None, :])
    library_ms, library_how = time_ms(lambda: torch.autograd.grad(
        sdpa_out, (qs, ks, vs), do, retain_graph=True))
    io = q.numel() * q.element_size()          # one (B, H, T, D) tensor
    rows_f32 = 2 * B * H * T * 4 + fmask.numel() * 4   # lse, delta, mask
    for name, kname, flops, nbytes, err in (
            ('flash_attn_bwd_dq', 'flash_bwd_dq_kernel',
             6 * B * H * T * T * D, 5 * io + rows_f32, errs[0]),
            ('flash_attn_bwd_dkv', 'flash_bwd_dkv_kernel',
             8 * B * H * T * T * D, 6 * io + rows_f32, max(errs[1:]))):
        us = sum(t for n, t in per_kernel.items() if kname in n)
        check(us > 0, f'no device time for {kname} in the trace')
        b_ms, b_by = bound_ms(flops, nbytes, PEAK_BF16)
        rows[name] = dict(
            route='cuda', source='mxnet_tpu_torch/csrc/flash_attn_bwd.cu',
            replaces='mxnet_tpu/ops/pallas_attention.py:' +
            ('283' if name.endswith('dq') else '319'),
            max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
            ms=us / 20 / 1e3, how=f'profiler/{plain_how}/{library_how}',
            stream_ms=bwd_stream_ms,
            plain_ms=plain_ms, library_ms=library_ms)
    delta_us = sum(t for n, t in per_kernel.items()
                   if 'flash_bwd' not in n) / 20
    print(f'  flash_attn_bwd: delta = rowsum(dO*O) and the allocations take '
          f'{delta_us / 1e3:.4f} ms of device time per backward beside the '
          f'two kernels; plain_ms (the whole plain backward) and library_ms '
          f'(the backward of F.scaled_dot_product_attention with the same '
          f'float mask, dq+dk+dv) are one time for both kernels, and so is '
          f'the stream time (the whole backward)')

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
              f'(kernel/plain/library from {r["how"]}) kernel '
              f'{r["ms"]:.4f} ms, plain '
              f'{r["plain_ms"]:.4f} ms, library {r["library_ms"]:.4f} ms; '
              f'bound {r["bound_ms"]:.4f} ms ({r["bound_by"]}); back-to-back '
              f'stream time of the kernel {r["stream_ms"]:.4f} ms')
    return rows


_FAMILIES = (('flash_attn_fwd', ('flash_fwd_kernel',)),
             ('flash_attn_bwd_dq', ('flash_bwd_dq_kernel',)),
             ('flash_attn_bwd_dkv', ('flash_bwd_dkv_kernel',)),
             ('fused_add_layernorm', ('_add_ln_fwd',)),
             ('dense_gelu', ('dense_gelu_',)),
             ('library GEMMs', ('gemm', 'nvjet', 'cutlass', 'xmma')))


def device_breakdown(label, fn, card, iters):
    """Device time of one call of ``fn`` by kernel family, from
    torch.profiler's CUDA trace, and the device's idle share: one minus
    the kernels' summed time over the call's host time."""
    per_kernel, wall = profile_device(fn, iters)
    fam = {}
    for name, us in per_kernel.items():
        f = next((f for f, pats in _FAMILIES
                  if any(p in name for p in pats)), 'other')
        fam[f] = fam.get(f, 0.0) + us / iters / 1e3
    busy = sum(fam.values())
    per = wall / iters * 1e3
    print(f'  {label} on {card}: host {per:.3f} ms, '
          f'device busy {busy:.3f} ms, idle share '
          f'{max(0.0, 1 - busy / per):.3f}; by family: ' + ', '.join(
              f'{f} {ms:.3f} ms ({ms / busy:.1%})' for f, ms in
              sorted(fam.items(), key=lambda kv: -kv[1])))
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    print(f'  top kernels per {label}: ' + '; '.join(
        f'{n[:60]} {us / iters / 1e3:.3f} ms' for n, us in top))


def dispatch_breakdown(engine, card, batch=8, seq=512, iters=3):
    """One dispatch of the largest bucket (tokens in, output back to the
    host included)."""
    device_breakdown(f'dispatch b{batch}_s{seq}',
                     lambda: engine.run_bucket(batch, seq), card, iters)


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
                           'flash_attn_bwd_dq': 0, 'flash_attn_bwd_dkv': 0,
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


def pretraining_batch(cfg, batch, seq, seed):
    """The flagship batch of bench.py: random tokens, token types 0,
    valid_length in [seq/2, seq], 72 masked positions per row (15% of 512
    rounded down to a multiple of 8), their labels and NSP labels."""
    import numpy as onp
    rng = onp.random.RandomState(seed)
    nmask = max(8, int(0.15 * seq) // 8 * 8)
    arrays = dict(
        tokens=rng.randint(0, cfg['vocab_size'], (batch, seq)),
        types=onp.zeros((batch, seq), onp.int64),
        valid=rng.randint(seq // 2, seq + 1, (batch,)).astype(onp.float32),
        mpos=onp.stack([rng.choice(seq, nmask, replace=False)
                        for _ in range(batch)]),
        labels=rng.randint(0, cfg['vocab_size'], (batch, nmask)),
        nsp=rng.randint(0, 2, (batch,)))
    return arrays, nmask


def _key_bias_zeroed(name, g, hidden):
    """A gradient with the key third of a qkv bias set to 0: that gradient
    is zero in exact arithmetic (softmax ignores a shift shared by every
    key of a row), so what any run computes for it is rounding noise."""
    if name.endswith('attention.qkv.bias'):
        g = g.clone()
        g[hidden:2 * hidden] = 0
    return g


def training_parity(cfg, arrays, card, seq=512, batch=2):
    """One step's loss and gradients on the card (bf16, all five kernels,
    dropout 0) against the same weights in f32 on the CPU through the
    plain versions."""
    import torch
    from mxnet_tpu_torch.models.bert import (BertForPretraining,
                                             bert_pretrain_loss)
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu
    data, _ = pretraining_batch(cfg, batch, seq, SEED + 1)
    cfg0 = dict(cfg, dropout=0.0)
    out = {}
    for dev, dtype in (('cuda', torch.bfloat16), ('cpu', torch.float32)):
        net = BertForPretraining(cfg0, dtype=dtype, device=dev).train()
        net.load_state_dict(params_from_mxnet_tpu(arrays, net))
        t = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
        mlm, nsp = net(t['tokens'], t['types'], t['valid'], t['mpos'])
        loss = bert_pretrain_loss(mlm, nsp, t['labels'], t['nsp'])
        loss.backward()
        out[dev] = (float(loss.detach()), {
            n: _key_bias_zeroed(n, p.grad.detach().float().cpu(),
                                cfg['hidden'])
            for n, p in net.named_parameters()})
        del net, mlm, nsp, loss
    (lg, gg), (lc, gc) = out['cuda'], out['cpu']
    loss_rel = abs(lg - lc) / abs(lc)
    num = sum(float((gg[n] - gc[n]).square().sum()) for n in gc)
    den = sum(float(gc[n].square().sum()) for n in gc)
    rel_fro = (num / den) ** 0.5
    cos = {n: float(torch.nn.functional.cosine_similarity(
        gg[n].flatten(), gc[n].flatten(), dim=0)) for n in gc}
    worst = min(cos, key=cos.get)
    ok = loss_rel <= TRAIN_TOL['loss_rel'] and \
        rel_fro <= TRAIN_TOL['grad_rel_fro'] and \
        cos[worst] >= TRAIN_TOL['grad_min_cos']
    print(f'  parity, one step at B={batch} T={seq} (dropout 0), bf16 on the '
          f'card vs f32 CPU plain: loss {lg:.5f} vs {lc:.5f} (rel '
          f'{loss_rel:.2e}), gradients rel_fro_err={rel_fro:.4f}, least '
          f'cosine {cos[worst]:.5f} ({worst}); tolerance {TRAIN_TOL} '
          f'(key third of each qkv bias left out: its gradient is zero in '
          f'exact arithmetic) -> {"ok" if ok else "FAIL"}')
    check(ok, 'training step disagrees with the f32 CPU reference')
    return dict(loss_rel=loss_rel, rel_fro=rel_fro, min_cos=cos[worst])


def training_phase(card, steps=5, batch=8, seq=512):
    import numpy as onp
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.models.bert import (BertForPretraining,
                                             bert_base_config,
                                             bert_pretrain_loss)
    from mxnet_tpu_torch.ops import attention as attn_ops
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu

    os.environ['MXTPU_PALLAS_LN'] = '1'
    os.environ['MXTPU_PALLAS_FFN'] = '1'
    cfg = bert_base_config()
    print(f'training phase on {card}: BertForPretraining (BERT-base), bf16, '
          f'both knobs on')
    gen = torch.Generator('cuda').manual_seed(SEED)
    net = BertForPretraining(dict(cfg, dropout=0.1), dtype=torch.bfloat16,
                             device='cuda', generator=gen)
    arrays = random_bert_arrays(net)
    parity = training_parity(cfg, arrays, card)

    net.load_state_dict(params_from_mxnet_tpu(arrays, net))
    net.train()
    params = gluon.collect_params(net)
    trainer = gluon.Trainer(params, 'adamw',
                            {'learning_rate': 1e-4, 'wd': 0.01,
                             'multi_precision': True})
    data, nmask = pretraining_batch(cfg, batch, seq, SEED)
    t = {k: torch.from_numpy(v).cuda() for k, v in data.items()}

    def step():
        mlm, nsp = net(t['tokens'], t['types'], t['valid'], t['mpos'])
        loss = bert_pretrain_loss(mlm, nsp, t['labels'], t['nsp'])
        loss.backward()
        trainer.step(1)
        net.zero_grad(set_to_none=False)
        return loss.detach()

    warm = float(step())
    masters0 = {i: st[0].clone() for i, st in trainer._states.items()}
    torch.cuda.synchronize()
    # the main path's run: counters at 0 just before, read just after
    mt.ops.reset_launch_counts()
    for k in attn_ops.route_counts:
        attn_ops.route_counts[k] = 0
    t0 = time.perf_counter()
    losses = [step() for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(mt.ops.launch_counts)
    routes = dict(attn_ops.route_counts)
    losses = [float(x) for x in losses]

    L = cfg['layers']
    print(f'  losses: warm-up {warm:.5f}, timed {losses}')
    print(f'  launches={launches} routes={routes} over {steps} steps')
    check(all(onp.isfinite(x) for x in [warm] + losses), 'non-finite loss')
    check(routes['flash'] == L * steps, f'flash route {routes}')
    check(launches == {'flash_attn_fwd': L * steps,
                       'flash_attn_bwd_dq': L * steps,
                       'flash_attn_bwd_dkv': L * steps,
                       'fused_add_layernorm': 2 * L * steps,
                       'dense_gelu': L * steps},
          f'launch counts {launches} for {steps} steps')
    names = list(params)
    still = [names[i] for i, st in trainer._states.items()
             if torch.equal(st[0], masters0[i])]
    check(not still, f'parameters that did not move: {still}')

    # bench.py's FLOP accounting: embeddings do no matmul work, the MLM
    # head runs on the masked positions only, pooler and NSP on one
    # position per sequence; 12*L*hidden*T per token for attention
    def psize(keys):
        return sum(p.numel() for n, p in params.items()
                   if any(k in n for k in keys))
    P = psize([''])
    P_embed = psize(['word_embed', 'pos_embed', 'type_embed'])
    P_head = psize(['mlm_'])
    P_pool = psize(['pooler', 'nsp'])
    P_body = P - P_embed - P_head - P_pool
    tokens = batch * seq
    flops = (6 * P_body * tokens + 6 * P_head * batch * nmask
             + 6 * P_pool * batch + 12 * L * cfg['hidden'] * seq * tokens)
    step_s = wall / steps
    mfu = flops / step_s / PEAK_BF16
    print(f'  {steps} AdamW steps at B={batch} T={seq} on {card}: '
          f'{step_s * 1e3:.3f} ms per step (host clock between '
          f'synchronizes), {batch / step_s:.3f} samples/s, '
          f'{flops / 1e12:.4f} TFLOP per step, MFU {mfu:.4%} of 989 '
          f'TFLOP/s bf16')

    # where a step's device time goes: by kernel family over one profiled
    # step, then forward / backward / optimizer from CUDA events
    device_breakdown(f'training step b{batch}_s{seq}', step, card, 1)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    mlm, nsp = net(t['tokens'], t['types'], t['valid'], t['mpos'])
    loss = bert_pretrain_loss(mlm, nsp, t['labels'], t['nsp'])
    ev[1].record()
    loss.backward()
    ev[2].record()
    trainer.step(1)
    net.zero_grad(set_to_none=False)
    ev[3].record()
    ev[3].synchronize()
    phases = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    print(f'  one step by phase (CUDA events) on {card}: forward+loss '
          f'{phases[0]:.3f} ms, backward {phases[1]:.3f} ms, AdamW update '
          f'{phases[2]:.3f} ms')
    return launches, dict(step_ms=step_s * 1e3, samples_per_s=batch / step_s,
                          mfu=mfu, parity=parity)


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
    serving, _stats, _rps = serving_phase(card)
    training, _train = training_phase(card)
    # launches: the serving run's and the training run's, each counted
    # from 0 just before its run
    kernels = [dict(name=name, route=r['route'], source=r['source'],
                    replaces=r['replaces'],
                    launches=serving[name] + training[name],
                    launches_by_path={'serving': serving[name],
                                      'training': training[name]},
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
