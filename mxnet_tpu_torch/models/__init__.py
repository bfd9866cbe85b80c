from . import bert
from .bert import (BertForPretraining, BertModel, bert_base_config,
                   bert_pretrain_loss)

__all__ = ['bert', 'BertForPretraining', 'BertModel', 'bert_base_config',
           'bert_pretrain_loss']
