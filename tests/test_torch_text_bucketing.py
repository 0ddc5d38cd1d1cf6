"""The port's ``contrib.text``, ``gluon.contrib.data`` and ``rnn.io``
against the JAX package's, on the CPU.

``count_tokens_from_str``, ``Vocabulary`` (frequency order, ties,
``most_freq_count``, ``min_freq``, reserved tokens), ``CustomEmbedding``
from a word-vector file this file writes, ``CompositeEmbedding``,
``IntervalSampler``, ``WikiText2`` / ``WikiText103`` from a local file and
from the synthetic corpus, ``encode_sentences`` and
``BucketSentenceIter`` (Python's ``random`` and numpy's global generator
seeded alike before each package's iterator: the same buckets, order and
rows). Every comparison is exact (tolerance 0). The names the port has
not ported (the symbolic cells, ``gluon.contrib.nn`` / ``rnn``) raise.
"""
import collections
import random

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import rnn as jrnn
from incubator_mxnet_tpu.contrib import text as jtext
from incubator_mxnet_tpu.gluon.contrib import data as jcdata
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import rnn as trnn
from incubator_mxnet_tpu_torch.contrib import text as ttext
from incubator_mxnet_tpu_torch.gluon.contrib import data as tcdata

TEXT = ("the cat sat on the mat\nthe dog ate the cat\n"
        "a bird sat on a dog\nThe End")


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _np(a):
    return a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)


@pytest.mark.parametrize("kw", [dict(), dict(to_lower=True),
                                dict(token_delim="a", seq_delim="t")])
def test_count_tokens_from_str(kw):
    assert ttext.count_tokens_from_str(TEXT, **kw) == \
        jtext.count_tokens_from_str(TEXT, **kw)
    c = collections.Counter({"zz": 4})
    assert ttext.count_tokens_from_str(TEXT, counter_to_update=c) is c
    assert c["zz"] == 4 and c["the"] == 4


@pytest.mark.parametrize("kw", [
    dict(), dict(most_freq_count=3), dict(min_freq=2),
    dict(reserved_tokens=["<pad>", "<eos>"], unknown_token="<UNK>"),
    dict(most_freq_count=2, min_freq=1, reserved_tokens=["<eos>"])])
def test_vocabulary_matches_the_reference(kw):
    counter = jtext.count_tokens_from_str(TEXT)
    tv, jv = ttext.Vocabulary(counter, **kw), jtext.Vocabulary(counter, **kw)
    assert tv.idx_to_token == jv.idx_to_token
    assert tv.token_to_idx == jv.token_to_idx
    assert len(tv) == len(jv)
    assert tv.unknown_token == jv.unknown_token
    assert tv.reserved_tokens == jv.reserved_tokens
    toks = ["the", "nope", "cat", "sat"]
    assert tv.to_indices(toks) == jv.to_indices(toks)
    assert tv.to_indices("dog") == jv.to_indices("dog")
    assert tv.to_tokens([0, 1]) == jv.to_tokens([0, 1])
    with pytest.raises(ValueError):
        tv.to_tokens(len(tv))
    with pytest.raises(AssertionError):
        ttext.Vocabulary(counter, unknown_token="a", reserved_tokens=["a"])


def _vec_file(tmp_path):
    rs = np.random.RandomState(0)
    path = tmp_path / "vecs.txt"
    lines = [f"{w} " + " ".join(f"{v:.6f}" for v in rs.randn(4))
             for w in ("the", "cat", "dog", "mat", "zebra")]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_custom_and_composite_embeddings_match_the_reference(tmp_path):
    path = _vec_file(tmp_path)
    counter = jtext.count_tokens_from_str(TEXT)
    embs = []
    for text in (ttext, jtext):
        vocab = text.Vocabulary(counter, reserved_tokens=["<eos>"])
        plain = text.CustomEmbedding(path, init_unknown_vec=[1, 2, 3, 4])
        on_vocab = text.CustomEmbedding(path, vocabulary=vocab)
        comp = text.CompositeEmbedding(vocab, [plain, on_vocab])
        embs.append((plain, on_vocab, comp))
    for t, j in zip(*embs):
        assert t.idx_to_token == j.idx_to_token
        assert t.vec_len == j.vec_len
        np.testing.assert_array_equal(_np(t.idx_to_vec), _np(j.idx_to_vec))
        toks = ["cat", "The", "nope", "zebra"]
        np.testing.assert_array_equal(
            _np(t.get_vecs_by_tokens(toks, lower_case_backup=True)),
            _np(j.get_vecs_by_tokens(toks, lower_case_backup=True)))
        np.testing.assert_array_equal(_np(t.get_vecs_by_tokens("dog")),
                                      _np(j.get_vecs_by_tokens("dog")))
    plain_t, plain_j = embs[0][0], embs[1][0]
    new = np.arange(8, dtype=np.float32).reshape(2, 4)
    plain_t.update_token_vectors(["cat", "dog"], tmx.nd.array(new))
    plain_j.update_token_vectors(["cat", "dog"], jmx.nd.array(new))
    np.testing.assert_array_equal(_np(plain_t.idx_to_vec),
                                  _np(plain_j.idx_to_vec))
    with pytest.raises(ValueError, match="not indexed"):
        plain_t.update_token_vectors("nope", tmx.nd.array(new[:1]))
    assert ttext.embedding.CustomEmbedding is ttext.CustomEmbedding
    assert ttext.vocab.Vocabulary is ttext.Vocabulary


@pytest.mark.parametrize("length,interval,rollover",
                         [(10, 3, True), (10, 3, False), (9, 3, True),
                          (7, 7, False), (13, 4, True)])
def test_interval_sampler_matches_the_reference(length, interval, rollover):
    t = tcdata.IntervalSampler(length, interval, rollover)
    j = jcdata.IntervalSampler(length, interval, rollover)
    assert list(t) == list(j) and len(t) == len(j)
    with pytest.raises(ValueError):
        tcdata.IntervalSampler(3, 4)


def _same_wikitext(t, j):
    assert len(t) == len(j)
    assert t.vocabulary.idx_to_token == j.vocabulary.idx_to_token
    assert t.frequencies == j.frequencies
    for i in (0, 1, len(t) - 1):
        for a, b in zip(t[i], j[i]):
            assert str(_np(a).dtype) == str(_np(b).dtype)
            np.testing.assert_array_equal(_np(a), _np(b))


def test_wikitext2_from_a_local_file_matches_the_reference(tmp_path):
    root = tmp_path / "wikitext-2"
    root.mkdir()
    rs = np.random.RandomState(1)
    words = [f"w{i}" for i in range(30)]
    lines = [" ".join(rs.choice(words, rs.randint(3, 12)))
             for _ in range(60)]
    (root / "wiki.train.tokens").write_text("\n".join(lines) + "\n\n")
    t = tcdata.WikiText2(root=str(root), segment="train", seq_len=7)
    j = jcdata.WikiText2(root=str(root), segment="train", seq_len=7)
    _same_wikitext(t, j)
    # a second split shares the first one's vocabulary
    (root / "wiki.test.tokens").write_text(lines[0] + "\n")
    tt = tcdata.WikiText2(root=str(root), segment="test", seq_len=3,
                          vocab=t.vocabulary)
    assert tt.vocabulary is t.vocabulary


@pytest.mark.parametrize("cls,segment", [("WikiText2", "train"),
                                         ("WikiText2", "validation"),
                                         ("WikiText103", "test")])
def test_wikitext_synthetic_corpus_matches_the_reference(tmp_path, cls,
                                                         segment):
    root = str(tmp_path / "absent")
    t = getattr(tcdata, cls)(root=root, segment=segment)
    j = getattr(jcdata, cls)(root=root, segment=segment)
    _same_wikitext(t, j)
    assert t[0][0].shape == (35,) and str(t[0][0].dtype) == "int32"
    np.testing.assert_array_equal(_np(t[0][0])[1:], _np(t[0][1])[:-1])


def _sentences(seed=3, n=300):
    rs = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(50)]
    return [list(rs.choice(words, rs.randint(2, 40))) for _ in range(n)]


def test_encode_sentences_matches_the_reference():
    sents = _sentences()
    tcoded, tvocab = trnn.encode_sentences(sents, invalid_label=0,
                                           start_label=1)
    jcoded, jvocab = jrnn.encode_sentences(sents, invalid_label=0,
                                           start_label=1)
    assert tcoded == jcoded and tvocab == jvocab
    more = trnn.encode_sentences([["w1", "zz"]], vocab=dict(tvocab),
                                 unknown_token="<unk>")
    assert more == jrnn.encode_sentences([["w1", "zz"]], vocab=dict(jvocab),
                                         unknown_token="<unk>")
    with pytest.raises(AssertionError, match="Unknown token"):
        trnn.encode_sentences([["nope"]], vocab={"a": 1})


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_matches_the_reference(layout, capsys):
    coded, _ = jrnn.encode_sentences(_sentences(), invalid_label=0,
                                     start_label=1)
    iters = []
    for mod in (trnn, jrnn):
        random.seed(11)
        np.random.seed(11)
        iters.append(mod.BucketSentenceIter(coded, 16, buckets=[10, 20, 35],
                                            invalid_label=0, layout=layout))
    t, j = iters
    assert "discarded" in capsys.readouterr().out
    assert t.buckets == j.buckets and t.default_bucket_key == 35
    assert t.provide_data[0].shape == j.provide_data[0].shape
    assert t.idx == j.idx
    for epoch in range(2):
        n = 0
        for tb, jb in zip(t, j):
            assert tb.bucket_key == jb.bucket_key
            for a, b in ((tb.data[0], jb.data[0]),
                         (tb.label[0], jb.label[0])):
                assert a.shape == b.shape
                np.testing.assert_array_equal(_np(a), _np(b))
            assert tb.provide_data[0].shape == tuple(tb.data[0].shape)
            n += 1
        assert n == len(j.idx)
        with pytest.raises(StopIteration):
            t.next()
        random.seed(12 + epoch)
        np.random.seed(12 + epoch)
        t.reset()
        random.seed(12 + epoch)
        np.random.seed(12 + epoch)
        j.reset()


def test_unported_names_raise_and_name_their_queue():
    with pytest.raises(NotImplementedError, match="A11"):
        trnn.LSTMCell
    with pytest.raises(NotImplementedError, match="A11"):
        trnn.save_rnn_checkpoint
    # gluon.contrib.nn and .rnn are ported (tests/test_torch_contrib_extras.py)
    assert tmx.gluon.contrib.nn.Identity and tmx.gluon.contrib.rnn.LSTMPCell
    assert tmx.gluon.contrib.data.WikiText2 is tcdata.WikiText2
    assert tmx.contrib.text is ttext
