"""Text utilities: vocabulary indexing and token embeddings.

Counterpart of ``incubator_mxnet_tpu/contrib/text.py`` (ref:
python/mxnet/contrib/text/ — vocab.py Vocabulary, embedding.py
TokenEmbedding/CustomEmbedding/CompositeEmbedding, utils.py
count_tokens_from_str). It reads local files only: ``CustomEmbedding``
loads any word-vector text file in the ``token<sep>v1 v2 ...`` format of
the GloVe/fastText archives. Vectors are NDArrays on the current context.
"""
from __future__ import annotations

import collections
import re
from typing import Dict, Hashable, List, Optional, Sequence

import numpy as _np

from ..ndarray.ndarray import NDArray, array as nd_array

__all__ = ["count_tokens_from_str", "Vocabulary", "TokenEmbedding",
           "CustomEmbedding", "CompositeEmbedding"]


def count_tokens_from_str(source_str: str, token_delim: str = " ",
                          seq_delim: str = "\n", to_lower: bool = False,
                          counter_to_update: Optional[
                              collections.Counter] = None):
    """Tokenize a string and count tokens
    (ref: contrib/text/utils.py count_tokens_from_str)."""
    if to_lower:
        source_str = source_str.lower()
    tokens = [t for t in re.split(
        f"{re.escape(token_delim)}|{re.escape(seq_delim)}", source_str) if t]
    counter = (counter_to_update if counter_to_update is not None
               else collections.Counter())
    counter.update(tokens)
    return counter


class Vocabulary:
    """Token index with unknown + reserved handling
    (ref: contrib/text/vocab.py:30 Vocabulary)."""

    def __init__(self, counter: Optional[collections.Counter] = None,
                 most_freq_count: Optional[int] = None, min_freq: int = 1,
                 unknown_token: Hashable = "<unk>",
                 reserved_tokens: Optional[List] = None):
        assert min_freq > 0, "min_freq must be positive"
        if reserved_tokens is not None:
            assert unknown_token not in reserved_tokens, \
                "unknown_token cannot be reserved"
            assert len(set(reserved_tokens)) == len(reserved_tokens), \
                "reserved_tokens cannot contain duplicates"
        self._unknown_token = unknown_token
        self._reserved_tokens = (list(reserved_tokens)
                                 if reserved_tokens else None)
        self._idx_to_token = [unknown_token] + (self._reserved_tokens or [])
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}
        if counter is not None:
            self._index_counter_keys(counter, most_freq_count, min_freq)

    def _index_counter_keys(self, counter, most_freq_count, min_freq):
        # frequency-descending, ties by token order (ref: vocab.py sorting)
        pairs = sorted(counter.items(), key=lambda kv: (-kv[1], str(kv[0])))
        limit = most_freq_count if most_freq_count is not None else len(pairs)
        taken = 0
        for token, freq in pairs:
            if freq < min_freq or taken >= limit:
                break
            if token not in self._token_to_idx:
                self._token_to_idx[token] = len(self._idx_to_token)
                self._idx_to_token.append(token)
                taken += 1

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def token_to_idx(self) -> Dict:
        return self._token_to_idx

    @property
    def idx_to_token(self) -> List:
        return self._idx_to_token

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def reserved_tokens(self):
        return self._reserved_tokens

    def to_indices(self, tokens):
        """(ref: vocab.py to_indices)"""
        single = not isinstance(tokens, (list, tuple))
        toks = [tokens] if single else tokens
        idx = [self._token_to_idx.get(t, 0) for t in toks]  # 0 = unknown
        return idx[0] if single else idx

    def to_tokens(self, indices):
        """(ref: vocab.py to_tokens)"""
        single = not isinstance(indices, (list, tuple))
        idxs = [indices] if single else indices
        for i in idxs:
            if not 0 <= i < len(self._idx_to_token):
                raise ValueError(f"token index {i} out of range")
        toks = [self._idx_to_token[i] for i in idxs]
        return toks[0] if single else toks


class TokenEmbedding(Vocabulary):
    """Vocabulary whose tokens carry embedding vectors
    (ref: contrib/text/embedding.py:_TokenEmbedding).

    ``idx_to_vec`` is an NDArray (vocab_size, vec_len); unknown tokens map
    to index 0 whose vector comes from ``init_unknown_vec``.
    """

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._vec_len = 0
        self._idx_to_vec: Optional[NDArray] = None

    @property
    def vec_len(self) -> int:
        return self._vec_len

    @property
    def idx_to_vec(self) -> Optional[NDArray]:
        return self._idx_to_vec

    def get_vecs_by_tokens(self, tokens, lower_case_backup: bool = False):
        """(ref: embedding.py get_vecs_by_tokens)"""
        single = not isinstance(tokens, (list, tuple))
        toks = [tokens] if single else list(tokens)
        if lower_case_backup:
            toks = [t if t in self._token_to_idx else str(t).lower()
                    for t in toks]
        idx = [self._token_to_idx.get(t, 0) for t in toks]
        vecs = self._idx_to_vec.asnumpy()[idx]
        out = nd_array(vecs)
        return out[0] if single else out

    def update_token_vectors(self, tokens, new_vectors: NDArray):
        """(ref: embedding.py update_token_vectors)"""
        single = not isinstance(tokens, (list, tuple))
        toks = [tokens] if single else list(tokens)
        vals = new_vectors.asnumpy().reshape(len(toks), -1)
        arr = _np.array(self._idx_to_vec.asnumpy())  # writable copy
        for t, v in zip(toks, vals):
            if t not in self._token_to_idx:
                raise ValueError(f"token {t!r} is not indexed")
            arr[self._token_to_idx[t]] = v
        self._idx_to_vec = nd_array(arr)


class CustomEmbedding(TokenEmbedding):
    """Load word vectors from a local text file: one token per line,
    ``token<elem_delim>v1<elem_delim>v2...``
    (ref: contrib/text/embedding.py:CustomEmbedding)."""

    def __init__(self, pretrained_file_path: str, elem_delim: str = " ",
                 encoding: str = "utf8", vocabulary: Optional[
                     Vocabulary] = None, init_unknown_vec=None, **kwargs):
        super().__init__(**kwargs)
        vectors: Dict[Hashable, _np.ndarray] = {}
        vec_len = None
        with open(pretrained_file_path, encoding=encoding) as f:
            for line in f:
                parts = line.rstrip().split(elem_delim)
                if len(parts) < 2:
                    continue
                token, vals = parts[0], parts[1:]
                if vec_len is None:
                    vec_len = len(vals)
                elif len(vals) != vec_len:
                    raise ValueError(
                        f"inconsistent vector length for {token!r}")
                vectors[token] = _np.asarray(vals, _np.float32)
        if vec_len is None:
            raise ValueError("no vectors found in file")
        self._vec_len = vec_len

        if vocabulary is not None:
            tokens = [t for t in vocabulary.idx_to_token[1:]]
        else:
            tokens = list(vectors)
        for t in tokens:
            if t not in self._token_to_idx:
                self._token_to_idx[t] = len(self._idx_to_token)
                self._idx_to_token.append(t)

        mat = _np.zeros((len(self), vec_len), _np.float32)
        if init_unknown_vec is not None:
            mat[0] = _np.asarray(init_unknown_vec, _np.float32)
        for t, v in vectors.items():
            if t in self._token_to_idx:
                mat[self._token_to_idx[t]] = v
        self._idx_to_vec = nd_array(mat)


class CompositeEmbedding(TokenEmbedding):
    """Concatenate several embeddings over one vocabulary
    (ref: contrib/text/embedding.py:CompositeEmbedding)."""

    def __init__(self, vocabulary: Vocabulary,
                 token_embeddings: Sequence[TokenEmbedding]):
        super().__init__()
        if isinstance(token_embeddings, TokenEmbedding):
            token_embeddings = [token_embeddings]
        self._idx_to_token = list(vocabulary.idx_to_token)
        self._token_to_idx = dict(vocabulary.token_to_idx)
        self._unknown_token = vocabulary.unknown_token
        self._reserved_tokens = vocabulary.reserved_tokens
        parts = []
        for emb in token_embeddings:
            vecs = emb.get_vecs_by_tokens(self._idx_to_token)
            parts.append(vecs.asnumpy())
        mat = _np.concatenate(parts, axis=1)
        self._vec_len = mat.shape[1]
        self._idx_to_vec = nd_array(mat)


# ---------------------------------------------------------------------------
# reference sub-namespace layout (ref: contrib/text/{utils,vocab,embedding}.py
# — the reference splits these across submodules; the flat module keeps the
# same names reachable both ways: text.Vocabulary AND text.vocab.Vocabulary,
# including module-path imports like `import ...contrib.text.embedding`)
# ---------------------------------------------------------------------------
import sys as _sys
import types as _types


def _submodule(name, **members):
    mod = _types.ModuleType(f"{__name__}.{name}")
    for k, v in members.items():
        setattr(mod, k, v)
    _sys.modules[mod.__name__] = mod
    return mod


utils = _submodule("utils", count_tokens_from_str=count_tokens_from_str)
vocab = _submodule("vocab", Vocabulary=Vocabulary)
embedding = _submodule("embedding", TokenEmbedding=TokenEmbedding,
                       CustomEmbedding=CustomEmbedding,
                       CompositeEmbedding=CompositeEmbedding)
__all__ += ["utils", "vocab", "embedding"]
