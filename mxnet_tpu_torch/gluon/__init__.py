"""Gluon, MXNet's imperative high-level API (counterpart of
``mxnet_tpu/gluon``): Parameters, Blocks and hybridize, the layers, the
losses, the Trainer, the vision model zoo and ``data`` (datasets,
samplers, the DataLoader, the vision datasets and transforms), and
``contrib`` (the Estimator, the contrib layers). ``collect_params(module)``
keys a plain ``torch.nn.Module``'s parameters by structured name (the
BERT models)."""
from .parameter import (Parameter, Constant, ParameterDict,
                        DeferredInitializationError, collect_params)
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import nn
from . import loss
from . import utils
from .utils import split_data, split_and_load
from . import model_zoo
from . import data
from . import contrib

__all__ = ['Parameter', 'Constant', 'ParameterDict',
           'DeferredInitializationError', 'collect_params', 'Block',
           'HybridBlock', 'SymbolBlock', 'Trainer', 'nn', 'loss', 'utils',
           'model_zoo', 'data', 'split_data', 'split_and_load', 'contrib']
