from . import bert
from .bert import BertModel, bert_base_config

__all__ = ['bert', 'BertModel', 'bert_base_config']
