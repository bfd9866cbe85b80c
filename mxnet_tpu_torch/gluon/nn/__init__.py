"""Gluon layers (counterpart of ``mxnet_tpu/gluon/nn``)."""
from .basic_layers import (Sequential, HybridSequential, Dense, Dropout,
                           BatchNorm, SyncBatchNorm, LayerNorm, GroupNorm,
                           InstanceNorm, Embedding, Flatten, Lambda,
                           HybridLambda)
from .conv_layers import (Conv1D, Conv2D, Conv3D, Conv1DTranspose,
                          Conv2DTranspose, Conv3DTranspose, MaxPool1D,
                          MaxPool2D, MaxPool3D, AvgPool1D, AvgPool2D,
                          AvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D,
                          GlobalMaxPool3D, GlobalAvgPool1D, GlobalAvgPool2D,
                          GlobalAvgPool3D, ReflectionPad2D)
from .activations import (Activation, LeakyReLU, PReLU, ELU, SELU, GELU,
                          Swish)
from ..block import Block, HybridBlock, SymbolBlock
