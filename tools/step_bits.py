#!/usr/bin/env python3
"""Record the compiled BERT-base step's losses and kernel launches per
replay, bit for bit, so two trees of the port can be compared on one card.

    python3 tools/step_bits.py --out a.json [--root TREE] [--steps 13]
    python3 tools/step_bits.py --compare a.json b.json [c.json ...]

The port is imported from ``--root`` (default: this checkout), the recipe
from this checkout's chip_smoke.py, so two trees run the same recipe:
chip_smoke's compiled-step phase with no guard and no fault armed —
BERT-base BertForPretraining in bf16, dropout 0.1 drawn on the card from a
fixed seed, both fused-kernel knobs on, AdamW, ShardedTrainStep (call 1
eager and captured, every later call a replay of its CUDA graph), the
flagship batch (B = 8, T = 512) on every step. Writes each loss as
``float.hex``, the device operations of one replay (kernels, and the
input and rate copies apart) from a torch.profiler trace of 3 replays,
and sha256 digests of the final parameters and f32 masters. chip_smoke's
compiled-step phase prints the same bits for the tree it runs from. ``--compare`` exits 1 unless every file holds the same losses,
launches and digests.
"""
import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.normpath(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), os.pardir))


def _recipe():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_recipe', os.path.join(HERE, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def record(root, steps, out):
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.models.bert import (BertForPretraining,
                                             bert_base_config,
                                             bert_pretrain_loss)
    from mxnet_tpu_torch.weights import params_from_mxnet_tpu
    cs = _recipe()
    if not torch.cuda.is_available():
        print('step_bits: no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ['MXTPU_PALLAS_LN'] = '1'
    os.environ['MXTPU_PALLAS_FFN'] = '1'
    mt.ops._build.build_all()
    cfg = bert_base_config()
    gen = torch.Generator('cuda').manual_seed(cs.SEED + 3)
    net = BertForPretraining(dict(cfg, dropout=0.1), dtype=torch.bfloat16,
                             device='cuda', generator=gen)
    net.load_state_dict(params_from_mxnet_tpu(cs.random_bert_arrays(net),
                                              net))
    step = parallel.ShardedTrainStep(net, bert_pretrain_loss, 'adamw',
                                     {'learning_rate': 1e-4, 'wd': 0.01})
    data, _ = cs.pretraining_batch(cfg, 8, 512, cs.SEED)
    t = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    ins = [t['tokens'], t['types'], t['valid'], t['mpos']]
    labs = [t['labels'], t['nsp']]
    losses = [float(step(ins, labs)).hex() for _ in range(steps)]
    params = cs._digest(dict(net.named_parameters()))
    masters = cs._digest(step._master)
    names = cs.kernel_launches(lambda: step(ins, labs), 3)
    doc = {'root': os.path.abspath(root), 'package': mt.__file__,
           'card': cs.card_line(), 'losses': losses,
           'params_sha256': params, 'masters_sha256': masters,
           'launches_per_replay': {k: v / 3 for k, v in sorted(
               names.items())},
           'kernels_per_replay': sum(names.values()) / 3,
           'kernels_copies_per_replay': cs.ops_split(names, 3)}
    with open(out, 'w') as f:
        json.dump(doc, f, indent=1)
    print(json.dumps({k: doc[k] for k in (
        'package', 'card', 'kernels_per_replay', 'kernels_copies_per_replay',
        'params_sha256')}))
    return 0


def compare(files):
    docs = [json.load(open(f)) for f in files]
    keys = ('losses', 'params_sha256', 'masters_sha256',
            'launches_per_replay')
    same = all(d[k] == docs[0][k] for d in docs for k in keys)
    for f, d in zip(files, docs):
        kern, copies = d['kernels_copies_per_replay']
        print(f'{f}: {d["package"]} on {d["card"]}: '
              f'{d["kernels_per_replay"]:.0f} device operations per replay '
              f'({kern:.0f} kernels, {copies:.0f} copies and memsets), losses '
              f'{[float.fromhex(x) for x in d["losses"]][-3:]} (last 3), '
              f'params {d["params_sha256"][:16]}')
    print('identical' if same else 'DIFFERENT')
    return 0 if same else 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=HERE)
    ap.add_argument('--steps', type=int, default=13)
    ap.add_argument('--out')
    ap.add_argument('--compare', nargs='+')
    a = ap.parse_args()
    if a.compare:
        return compare(a.compare)
    return record(a.root, a.steps, a.out)


if __name__ == '__main__':
    sys.exit(main())
