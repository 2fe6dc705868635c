"""The port's text pipeline (``bigdl_tpu_torch/dataset/text.py``) and the
20-Newsgroups / GloVe loaders (``dataset/news20.py``) against the JAX
package's, on the CPU.

Tolerance: bitwise everywhere (the same tokenizer, dictionary order,
padding and numpy expressions; the synthetic corpus and vectors are the
same ``RandomState`` draws; the archive and the GloVe file are read by the
same rules).
"""

import os
import tarfile

import numpy as np
import pytest
from tests.torch_parity import one_torch_thread  # noqa: F401

import bigdl_tpu.dataset.news20 as jn
import bigdl_tpu.dataset.text as jt
import bigdl_tpu_torch.dataset.news20 as tn
import bigdl_tpu_torch.dataset.text as tt

CORPUS = ["The cat sat on the mat.", "A dog's life: 3 dogs, 1 cat!",
          "mat mat mat", "", "Zebras don't sit on mats"]


def _same_samples(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.feature(), b.feature())
        assert a.feature().dtype == b.feature().dtype
        np.testing.assert_array_equal(a.label(), b.label())
        assert a.label().dtype == b.label().dtype


def _pair(vocab_size=None):
    toks = [jt.simple_tokenize(s) for s in CORPUS]
    return (jt.Dictionary(toks, vocab_size), tt.Dictionary(toks, vocab_size),
            toks)


@pytest.mark.parametrize("vocab_size", [None, 4])
def test_labeled_sentences_match_jax(vocab_size):
    jd, td, toks = _pair(vocab_size)
    want = list(jt.TextToLabeledSentence(jd)(toks))
    got = list(tt.TextToLabeledSentence(td)(toks))
    assert td.index2word == jd.index2word         # the markers registered
    assert td.vocab_size() == jd.vocab_size()
    for a, b in zip(got, want):
        assert (a.data, a.labels) == (b.data, b.labels)
        assert (a.data_length(), a.label_length()) == (b.data_length(),
                                                       b.label_length())
    for one_hot in (False, True):
        for seq_len in (3, 9):
            _same_samples(
                tt.LabeledSentenceToSample(td.vocab_size(), seq_len,
                                           one_hot)(got),
                jt.LabeledSentenceToSample(jd.vocab_size(), seq_len,
                                           one_hot)(want))


@pytest.mark.parametrize("seq_len", [1, 4, 7])
def test_sequence_windower_matches_jax(seq_len):
    streams = [list(range(20)), list(range(5, 12)), [3]]
    want = list(jt.SequenceWindower(seq_len)(streams))
    got = list(tt.SequenceWindower(seq_len)(streams))
    assert [(s.data, s.labels) for s in got] == \
        [(s.data, s.labels) for s in want]
    assert all(len(s.data) == seq_len for s in got)


@pytest.mark.parametrize("pad_index", [0, 1])
def test_sentence_to_word_indices_matches_jax(pad_index):
    jd, td, toks = _pair(6)
    pairs = [(t, i % 3 + 1) for i, t in enumerate(toks)]
    _same_samples(tt.SentenceToWordIndices(td, 5, pad_index)(pairs),
                  jt.SentenceToWordIndices(jd, 5, pad_index)(pairs))


def test_dataset_exports_the_jax_names():
    import bigdl_tpu.dataset as jds
    import bigdl_tpu_torch.dataset as tds

    assert set(jds.__all__) <= set(tds.__all__)
    for name in jds.__all__:
        assert hasattr(tds, name), name


def test_synthetic_corpus_and_vectors_are_jax_draws(tmp_path):
    empty = str(tmp_path / "none")
    assert tn.get_news20(empty) == jn.get_news20(empty)
    assert tn.get_news20(empty, n_per_class=3, seed=1) == \
        jn.get_news20(empty, n_per_class=3, seed=1)
    want = jn.glove_dict(empty, dim=7)
    got = tn.glove_dict(empty, dim=7)
    assert list(got) == list(want) and len(got) == 20 * 8 + 16
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert tn.DEFAULT_DIR.startswith(__import__("tempfile").gettempdir())


def _write_tree(root):
    tree = os.path.join(root, "20news-18828")
    rng = np.random.RandomState(3)
    for g in ("comp.graphics", "alt.atheism", "sci.space"):
        os.makedirs(os.path.join(tree, g))
        for i in range(3):
            words = [f"w{int(rng.randint(40))}" for _ in range(12)]
            body = (" ".join(words) + " caf\xe9").encode("latin1")
            with open(os.path.join(tree, g, str(50 + i)), "wb") as f:
                f.write(body)
    return tree


def test_archive_and_tree_read_as_jax_reads_them(tmp_path):
    src = tmp_path / "src"
    _write_tree(str(src))
    for name in ("jax", "port"):
        os.makedirs(tmp_path / name)
        with tarfile.open(tmp_path / name / "20news-18828.tar.gz",
                          "w:gz") as tf:
            tf.add(src / "20news-18828", arcname="20news-18828")
    want = jn.get_news20(str(tmp_path / "jax"))
    got = tn.get_news20(str(tmp_path / "port"))       # expands the archive
    assert got == want
    assert [lab for _, lab in got] == [1] * 3 + [2] * 3 + [3] * 3
    assert os.path.isdir(tmp_path / "port" / "20news-18828")
    assert tn.get_news20(str(tmp_path / "port")) == want   # the tree now
    glove = tmp_path / "glove"
    os.makedirs(glove)
    with open(glove / "glove.6B.3d.txt", "w", encoding="utf-8") as f:
        f.write("w1 0.5 -1.25 3\nw2 1e-3 2 0\ncaf\xe9 1 1 1\n")
    want = jn.glove_dict(str(glove), dim=3)
    got = tn.glove_dict(str(glove), dim=3)
    assert list(got) == list(want) == ["w1", "w2", "caf\xe9"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == np.float32
