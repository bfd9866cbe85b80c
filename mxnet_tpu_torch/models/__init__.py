"""Reference models (counterpart of ``mxnet_tpu/models``): LeNet, BERT,
the Transformer encoder-decoder, the GPT-style causal LM and the SSD
detector, built on ``mxnet_tpu_torch.gluon``."""
from . import bert, gpt, lenet, ssd, transformer
from .bert import (BertForPretraining, BertModel, bert_base_config,
                   bert_pretrain_loss)
from .gpt import GPTModel, gpt2_small_config, gpt_lm_loss
from .lenet import LeNet
from .ssd import SSD, ssd_300, ssd_512, ssd_train_loss
from .transformer import TransformerEncoder, TransformerModel

__all__ = ['bert', 'gpt', 'lenet', 'ssd', 'transformer', 'LeNet', 'SSD',
           'ssd_300', 'ssd_512', 'ssd_train_loss',
           'BertForPretraining', 'BertModel', 'bert_base_config',
           'bert_pretrain_loss', 'GPTModel', 'gpt2_small_config',
           'gpt_lm_loss', 'TransformerEncoder', 'TransformerModel']
