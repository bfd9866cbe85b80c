#!/usr/bin/env python3
"""Write the input pipeline's committed JPEG fixture.

    python3 tools/io_fixture.py [--out tools/fixtures/io_smooth.rec] [--n 64]

Smooth synthetic images (sums of low-frequency sinusoids, 360 x 480 RGB,
JPEG quality 90, made from a fixed seed) packed through the port's
``recordio`` with labels ``i % 10``: what ``chip_smoke.py``'s io phase
reads on a machine without PIL, where it cannot encode JPEGs itself.
Smooth images keep the file under 2 MB; decoding them costs what any
JPEG of that size costs.
"""
import argparse
import io
import os
import sys

import numpy as onp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, 'tools', 'fixtures', 'io_smooth.rec')


def smooth_image(rng, h=360, w=480):
    y = onp.linspace(0, 1, h, dtype=onp.float32)[:, None, None]
    x = onp.linspace(0, 1, w, dtype=onp.float32)[None, :, None]
    f = rng.uniform(0.5, 3.0, (4, 1, 1, 3)).astype(onp.float32)
    ph = rng.uniform(0, 2 * onp.pi, (4, 1, 1, 3)).astype(onp.float32)
    img = 0.5 + 0.12 * sum(onp.sin(2 * onp.pi * (f[k] * (x if k % 2 else y)
                                                + f[(k + 1) % 4] * y * x)
                                   + ph[k]) for k in range(4))
    return (onp.clip(img, 0, 1) * 255).astype(onp.uint8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default=DEFAULT_OUT)
    ap.add_argument('--n', type=int, default=64)
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from PIL import Image
    from mxnet_tpu_torch import recordio
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    rng = onp.random.RandomState(args.seed)
    rec = recordio.MXRecordIO(args.out, 'w')
    for i in range(args.n):
        buf = io.BytesIO()
        Image.fromarray(smooth_image(rng)).save(buf, format='JPEG',
                                                quality=90)
        rec.write(recordio.pack(recordio.IRHeader(0, float(i % 10), i, 0),
                                buf.getvalue()))
    rec.close()
    print(f'{args.out}: {args.n} images, {os.path.getsize(args.out)} bytes')
    return 0


if __name__ == '__main__':
    sys.exit(main())
