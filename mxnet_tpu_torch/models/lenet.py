"""LeNet for MNIST (counterpart of ``mxnet_tpu/models/lenet.py``; ref:
example/gluon/mnist.py)."""
from __future__ import annotations

from ..gluon import nn

__all__ = ['LeNet']


class LeNet(nn.HybridBlock):
    def __init__(self, classes=10, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix='')
            self.features.add(nn.Conv2D(20, kernel_size=5, activation='relu'))
            self.features.add(nn.MaxPool2D(pool_size=2, strides=2))
            self.features.add(nn.Conv2D(50, kernel_size=5, activation='relu'))
            self.features.add(nn.MaxPool2D(pool_size=2, strides=2))
            self.features.add(nn.Flatten())
            self.features.add(nn.Dense(500, activation='relu'))
            self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))
