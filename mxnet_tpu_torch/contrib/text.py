"""Text utilities: vocabulary and token embeddings (counterpart of
``mxnet_tpu/contrib/text.py``, ref: python/mxnet/contrib/text/{vocab.py,
embedding.py,utils.py}).

An embedding's ``idx_to_vec`` is an NDArray on the context it was asked
for (``ctx=``; the current context, the card unless a ``with mx.cpu():``
scope says otherwise, for None); the vocabulary and the text parsing are
host work, as in the JAX package.
"""
from __future__ import annotations

import collections
import re

import numpy as onp
import torch

from ..ndarray.ndarray import NDArray, array as nd_array

__all__ = ['Vocabulary', 'CustomEmbedding', 'CompositeEmbedding',
           'count_tokens_from_str']


def count_tokens_from_str(source_str, token_delim=' ', seq_delim='\n',
                          to_lower=False, counter_to_update=None):
    """Count tokens in a delimited string (ref: text/utils.py)."""
    source_str = re.sub(
        f'[{re.escape(token_delim)}{re.escape(seq_delim)}]+', ' ',
        source_str).strip()
    if to_lower:
        source_str = source_str.lower()
    counter = counter_to_update if counter_to_update is not None \
        else collections.Counter()
    if source_str:
        counter.update(source_str.split(' '))
    return counter


class Vocabulary:
    """Token ↔ index mapping built from a counter
    (ref: text/vocab.py Vocabulary)."""

    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token='<unk>', reserved_tokens=None):
        if min_freq < 1:
            raise ValueError("min_freq must be >= 1")
        self._unknown_token = unknown_token
        reserved_tokens = list(reserved_tokens or [])
        if len(set(reserved_tokens)) != len(reserved_tokens) or \
                unknown_token in reserved_tokens:
            raise ValueError("reserved tokens must be unique and must not "
                             "contain the unknown token")
        self._idx_to_token = [unknown_token] + reserved_tokens
        self._reserved_tokens = reserved_tokens
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}
        if counter is not None:
            pairs = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
            if most_freq_count is not None:
                pairs = pairs[:most_freq_count]
            for token, freq in pairs:
                if freq < min_freq:
                    break
                if token not in self._token_to_idx:
                    self._token_to_idx[token] = len(self._idx_to_token)
                    self._idx_to_token.append(token)

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def reserved_tokens(self):
        return self._reserved_tokens

    def to_indices(self, tokens):
        single = isinstance(tokens, str)
        if single:
            tokens = [tokens]
        out = [self._token_to_idx.get(t, 0) for t in tokens]
        return out[0] if single else out

    def to_tokens(self, indices):
        single = isinstance(indices, int)
        if single:
            indices = [indices]
        out = []
        for i in indices:
            if not 0 <= i < len(self._idx_to_token):
                raise ValueError(f"token index {i} out of range")
            out.append(self._idx_to_token[i])
        return out[0] if single else out


class _TokenEmbedding(Vocabulary):
    """Base for pretrained/custom embeddings (ref: text/embedding.py)."""

    def __init__(self, ctx=None, **kwargs):
        super().__init__(**kwargs)
        self._ctx = ctx
        self._vec_len = 0
        self._idx_to_vec = None

    @property
    def vec_len(self):
        return self._vec_len

    @property
    def idx_to_vec(self):
        return self._idx_to_vec

    def get_vecs_by_tokens(self, tokens, lower_case_backup=False):
        single = isinstance(tokens, str)
        if single:
            tokens = [tokens]
        indices = []
        for t in tokens:
            if t in self._token_to_idx:
                indices.append(self._token_to_idx[t])
            elif lower_case_backup and t.lower() in self._token_to_idx:
                indices.append(self._token_to_idx[t.lower()])
            else:
                indices.append(0)
        table = self._idx_to_vec._data
        vecs = table[torch.tensor(indices, device=table.device)]
        return NDArray(vecs[0] if single else vecs)

    def update_token_vectors(self, tokens, new_vectors):
        if isinstance(tokens, str):
            tokens = [tokens]
        vecs = onp.array(self._idx_to_vec.asnumpy())  # writable copy
        new_np = new_vectors.asnumpy() if isinstance(new_vectors, NDArray) \
            else onp.asarray(new_vectors)
        new_np = new_np.reshape(len(tokens), -1)
        for t, v in zip(tokens, new_np):
            if t not in self._token_to_idx:
                raise ValueError(f"token '{t}' is unknown")
            vecs[self._token_to_idx[t]] = v
        self._idx_to_vec = nd_array(vecs, ctx=self._ctx)

    def _load_embedding_txt(self, file_path, elem_delim=' ',
                            encoding='utf8', restrict_vocab=None):
        """Load `token v1 v2 ...` lines (glove/fasttext text format).
        A leading fastText `count dim` header line is skipped. When
        `restrict_vocab` is given, only its tokens are loaded and row
        indices follow the vocabulary's own order."""
        tokens, vecs = [], []
        with open(file_path, encoding=encoding) as f:
            for lineno, line in enumerate(f):
                parts = line.rstrip().split(elem_delim)
                if len(parts) < 2:
                    continue
                if lineno == 0 and len(parts) == 2:
                    try:  # fastText header: "<vocab_count> <dim>"
                        int(parts[0]), int(parts[1])
                        continue
                    except ValueError:
                        pass
                try:
                    vec = [float(x) for x in parts[1:]]
                except ValueError:
                    continue  # malformed / header-ish line
                if vecs and len(vec) != len(vecs[0]):
                    raise ValueError(
                        f"{file_path}:{lineno + 1}: vector has dim "
                        f"{len(vec)}, expected {len(vecs[0])}")
                if restrict_vocab is not None and \
                        parts[0] not in restrict_vocab.token_to_idx:
                    continue
                tokens.append(parts[0])
                vecs.append(vec)
        if not vecs:
            raise ValueError(f"no vectors found in {file_path}")
        self._vec_len = len(vecs[0])
        if restrict_vocab is not None:
            # adopt the vocabulary's index space verbatim
            self._idx_to_token = list(restrict_vocab.idx_to_token)
            self._token_to_idx = dict(restrict_vocab.token_to_idx)
        else:
            for t in tokens:
                if t not in self._token_to_idx:
                    self._token_to_idx[t] = len(self._idx_to_token)
                    self._idx_to_token.append(t)
        all_vecs = onp.zeros((len(self._idx_to_token), self._vec_len),
                             onp.float32)
        for t, v in zip(tokens, vecs):
            all_vecs[self._token_to_idx[t]] = v
        self._idx_to_vec = nd_array(all_vecs, ctx=self._ctx)


class CustomEmbedding(_TokenEmbedding):
    """Embedding loaded from a user text file of `token v1 v2 ...` lines
    (ref: text/embedding.py CustomEmbedding)."""

    def __init__(self, pretrained_file_path, elem_delim=' ',
                 encoding='utf8', vocabulary=None, ctx=None):
        super().__init__(ctx=ctx)
        self._load_embedding_txt(pretrained_file_path, elem_delim, encoding,
                                 restrict_vocab=vocabulary)


class CompositeEmbedding(_TokenEmbedding):
    """Concatenate several embeddings' vectors per token
    (ref: text/embedding.py CompositeEmbedding)."""

    def __init__(self, vocabulary, token_embeddings, ctx=None):
        super().__init__(ctx=ctx)
        if not isinstance(token_embeddings, (list, tuple)):
            token_embeddings = [token_embeddings]
        self._idx_to_token = list(vocabulary.idx_to_token)
        self._token_to_idx = dict(vocabulary.token_to_idx)
        parts = []
        for emb in token_embeddings:
            parts.append(emb.get_vecs_by_tokens(
                self._idx_to_token).asnumpy())
        cat = onp.concatenate(parts, axis=1)
        self._vec_len = cat.shape[1]
        self._idx_to_vec = nd_array(cat.astype(onp.float32), ctx=ctx)
