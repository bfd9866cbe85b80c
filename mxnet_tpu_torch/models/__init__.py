"""Reference models (counterpart of ``mxnet_tpu/models``): LeNet, BERT,
the Transformer encoder-decoder and the GPT-style causal LM, built on
``mxnet_tpu_torch.gluon``. The JAX package's SSD waits for
``ops/detection.py`` (ROADMAP queue 1 item 14)."""
from . import bert, gpt, lenet, transformer
from .bert import (BertForPretraining, BertModel, bert_base_config,
                   bert_pretrain_loss)
from .gpt import GPTModel, gpt2_small_config, gpt_lm_loss
from .lenet import LeNet
from .transformer import TransformerEncoder, TransformerModel

__all__ = ['bert', 'gpt', 'lenet', 'transformer', 'LeNet',
           'BertForPretraining', 'BertModel', 'bert_base_config',
           'bert_pretrain_loss', 'GPTModel', 'gpt2_small_config',
           'gpt_lm_loss', 'TransformerEncoder', 'TransformerModel']
