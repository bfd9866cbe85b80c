from . import bert, lenet
from .bert import (BertForPretraining, BertModel, bert_base_config,
                   bert_pretrain_loss)
from .lenet import LeNet

__all__ = ['bert', 'lenet', 'LeNet', 'BertForPretraining', 'BertModel',
           'bert_base_config', 'bert_pretrain_loss']
