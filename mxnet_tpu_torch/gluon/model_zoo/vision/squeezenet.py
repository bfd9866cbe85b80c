"""SqueezeNet 1.0 and 1.1 (counterpart of ``mxnet_tpu/gluon/model_zoo/
vision/squeezenet.py``, ref: python/mxnet/gluon/model_zoo/vision/
squeezenet.py), with the JAX package's structure and so its structured
parameter names. Its max pools take MXNet's 'full' convention
(``ceil_mode=True``)."""
from __future__ import annotations

from ....base import MXNetError
from .... import ndarray as F
from ... import nn
from ...block import HybridBlock
from ..model_store import load_pretrained as _load_pretrained


class _Fire(HybridBlock):
    def __init__(self, squeeze_channels, expand1x1_channels, expand3x3_channels,
                 **kwargs):
        super().__init__(**kwargs)
        self.squeeze = nn.Conv2D(squeeze_channels, kernel_size=1,
                                 activation='relu')
        self.expand1x1 = nn.Conv2D(expand1x1_channels, kernel_size=1,
                                   activation='relu')
        self.expand3x3 = nn.Conv2D(expand3x3_channels, kernel_size=3,
                                   padding=1, activation='relu')

    def forward(self, x):
        x = self.squeeze(x)
        return F.concat(self.expand1x1(x), self.expand3x3(x), dim=1)


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in ('1.0', '1.1'):
            raise MXNetError(f"SqueezeNet version {version!r}: 1.0 or 1.1")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix='')
            if version == '1.0':
                self.features.add(nn.Conv2D(96, kernel_size=7, strides=2,
                                            activation='relu'))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(16, 64, 64))
                self.features.add(_Fire(16, 64, 64))
                self.features.add(_Fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(32, 128, 128))
                self.features.add(_Fire(48, 192, 192))
                self.features.add(_Fire(48, 192, 192))
                self.features.add(_Fire(64, 256, 256))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(64, 256, 256))
            else:
                self.features.add(nn.Conv2D(64, kernel_size=3, strides=2,
                                            activation='relu'))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(16, 64, 64))
                self.features.add(_Fire(16, 64, 64))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(32, 128, 128))
                self.features.add(_Fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_Fire(48, 192, 192))
                self.features.add(_Fire(48, 192, 192))
                self.features.add(_Fire(64, 256, 256))
                self.features.add(_Fire(64, 256, 256))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix='')
            self.output.add(nn.Conv2D(classes, kernel_size=1,
                                      activation='relu'))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def forward(self, x):
        x = self.features(x)
        x = self.output(x)
        return x


def get_squeezenet(version, pretrained=False, ctx=None, root=None, **kwargs):
    net = SqueezeNet(version, **kwargs)
    if pretrained:
        _load_pretrained(net, 'squeezenet' + version, root, ctx)
    return net


def squeezenet1_0(**kwargs):
    return get_squeezenet('1.0', **kwargs)


def squeezenet1_1(**kwargs):
    return get_squeezenet('1.1', **kwargs)

