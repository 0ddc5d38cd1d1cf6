"""Language-model datasets (ref: python/mxnet/gluon/contrib/data/text.py).

Counterpart of ``incubator_mxnet_tpu/gluon/contrib/data/text.py``.
WikiText2 / WikiText103 streams of (data, label) sequence pairs where label
is data shifted by one token, cut into fixed seq_len rows, as the
reference's _WikiText slices them. A local file at ``root`` is used when
present; otherwise a deterministic synthetic corpus with a Zipfian unigram
distribution stands in (the reference's, draw for draw), sharing its
vocabulary across splits so train/val/test are consistent.
"""
from __future__ import annotations

import collections
import io
import os

import numpy as np

from .... import ndarray as nd
from ....contrib import text as _text
from ...data import dataset

EOS_TOKEN = "<eos>"


def _synthetic_corpus(segment: str, vocab_size: int = 200,
                      n_tokens: int = 60000) -> str:
    """Deterministic fake corpus: Zipf-distributed 'words' from a shared
    vocabulary; only sample order varies per segment."""
    words = [f"w{i:03d}" for i in range(vocab_size)]
    seg_seed = {"train": 0, "validation": 1, "val": 1, "test": 2}.get(
        segment, 3)
    rng = np.random.RandomState(100 + seg_seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    idx = rng.choice(vocab_size, size=n_tokens, p=probs)
    # lines of 10-25 words
    out_lines = []
    i = 0
    while i < n_tokens:
        ln = int(rng.randint(10, 26))
        out_lines.append(" ".join(words[j] for j in idx[i:i + ln]))
        i += ln
    return "\n".join(out_lines)


class _LanguageModelDataset(dataset.Dataset):
    """(ref: contrib/data/text.py:35)"""

    def __init__(self, root, namespace, vocabulary):
        self._vocab = vocabulary
        self._counter = None
        self._namespace = namespace
        self._root = os.path.expanduser(root)
        self._data = None
        self._label = None
        self._get_data()

    @property
    def vocabulary(self):
        return self._vocab

    @property
    def frequencies(self):
        return self._counter

    def _build_vocab(self, content: str):
        if not self._counter:
            self._counter = collections.Counter(content.split())
        if not self._vocab:
            self._vocab = _text.Vocabulary(counter=self._counter,
                                           reserved_tokens=[EOS_TOKEN])


class _WikiText(_LanguageModelDataset):

    def _read_content(self) -> str:
        path = os.path.join(self._root, self._data_file_name)
        if os.path.exists(path):
            with io.open(path, "r", encoding="utf8") as fin:
                return fin.read()
        # no local file: the synthetic corpus (MXNet downloads here)
        return _synthetic_corpus(self._segment)

    def _get_data(self):
        content = self._read_content()
        self._build_vocab(content)
        raw_lines = [line for line in
                     (x.strip().split() for x in content.splitlines()) if line]
        tokens = []
        for line in raw_lines:
            tokens.extend(line)
            tokens.append(EOS_TOKEN)
        indices = self._vocab.to_indices(tokens)
        data = np.asarray(indices[0:-1], dtype=np.int32)
        label = np.asarray(indices[1:], dtype=np.int32)
        n = (len(data) // self._seq_len) * self._seq_len
        self._data = nd.array(data[:n].reshape(-1, self._seq_len))
        self._label = nd.array(label[:n].reshape(-1, self._seq_len))

    def __getitem__(self, idx):
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)


class WikiText2(_WikiText):
    """WikiText-2 word-level LM dataset (ref: contrib/data/text.py:105).

    segment: 'train' | 'validation' | 'test'; rows are seq_len-token
    (data, label) pairs with label = data shifted by one."""

    def __init__(self, root=os.path.join("~", ".mxtpu", "datasets",
                                         "wikitext-2"),
                 segment="train", vocab=None, seq_len=35):
        self._segment = segment
        self._seq_len = seq_len
        self._data_file_name = f"wiki.{segment}.tokens"
        super().__init__(root, "wikitext-2", vocab)


class WikiText103(_WikiText):
    """WikiText-103 (ref: contrib/data/text.py:143); same layout as
    WikiText2 with a much larger corpus."""

    def __init__(self, root=os.path.join("~", ".mxtpu", "datasets",
                                         "wikitext-103"),
                 segment="train", vocab=None, seq_len=35):
        self._segment = segment
        self._seq_len = seq_len
        self._data_file_name = f"wiki.{segment}.tokens"
        super().__init__(root, "wikitext-103", vocab)
