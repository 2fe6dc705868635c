"""The text pipeline (``bigdl_tpu/dataset/text.py``): ``simple_tokenize``,
the word-frequency ``Dictionary``, and the sentence transformers that
turn token lists into fixed-length ``Sample``s (host numpy, static
shapes: every sequence padded or cut to ``sequence_len``):

* ``TextToLabeledSentence`` — tokens → next-word ``LabeledSentence``s
  between ``SENTENCE_START``/``SENTENCE_END`` markers;
* ``LabeledSentenceToSample`` — 1-based ids (0 pads) or one-hot rows,
  1-based labels padded with class 1;
* ``SequenceWindower`` — a long id stream → contiguous next-word windows
  (the language model's ``numSteps`` batching; the tail is dropped);
* ``SentenceToWordIndices`` — (tokens, label) → a classification
  ``Sample`` of 1-based ids."""

from __future__ import annotations

import collections
import re
from typing import (
    Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple,
)

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import Transformer

SENTENCE_START = "SENTENCE_START"
SENTENCE_END = "SENTENCE_END"


def simple_tokenize(text: str) -> List[str]:
    """Lowercase word tokenizer (reference ``SentenceTokenizer`` role)."""
    return re.findall(r"[a-z0-9']+", text.lower())


class Dictionary:
    """Word-frequency vocabulary (reference ``text/Dictionary.scala``):
    the ``vocab_size`` most frequent words (every word, sorted, when
    ``vocab_size`` is None); every other word maps to one
    out-of-vocabulary index, the last."""

    def __init__(self, sentences: Optional[Iterable[Sequence[str]]] = None,
                 vocab_size: Optional[int] = None) -> None:
        self.word2index: Dict[str, int] = {}
        self.index2word: List[str] = []
        if sentences is not None:
            counts = collections.Counter(
                w for sent in sentences for w in sent)
            keep = (counts.most_common(vocab_size)
                    if vocab_size is not None else sorted(counts.items()))
            for w, _ in keep:
                self.add_word(w)

    def add_word(self, word: str) -> int:
        if word not in self.word2index:
            self.word2index[word] = len(self.index2word)
            self.index2word.append(word)
        return self.word2index[word]

    def vocab_size(self) -> int:
        """Vocabulary size INCLUDING the out-of-vocab slot."""
        return len(self.index2word) + 1

    def get_index(self, word: str) -> int:
        """In-vocab index, or the OOV index (``vocab_size() - 1``)."""
        return self.word2index.get(word, len(self.index2word))

    def get_word(self, index: int) -> str:
        if 0 <= index < len(self.index2word):
            return self.index2word[index]
        return "<unk>"

    def __len__(self) -> int:
        return self.vocab_size()


class LabeledSentence:
    """An indexed sentence with per-position labels (reference
    ``text/LabeledSentence.scala``): for language modelling the label is the
    next word; for classification a single class id."""

    def __init__(self, data: Sequence[int], labels: Sequence[int]) -> None:
        self.data = list(data)
        self.labels = list(labels)

    def data_length(self) -> int:
        return len(self.data)

    def label_length(self) -> int:
        return len(self.labels)


class TextToLabeledSentence(Transformer):
    """token sequences → next-word-prediction ``LabeledSentence``s
    (reference ``text/TextToLabeledSentence.scala``): wraps each sentence
    with start/end markers and labels every position with the next word."""

    def __init__(self, dictionary: Dictionary) -> None:
        self.dictionary = dictionary
        # the markers can never come out of a tokenizer — register them so
        # sentence boundaries don't silently collapse onto the OOV index
        self.start_idx = dictionary.add_word(SENTENCE_START)
        self.end_idx = dictionary.add_word(SENTENCE_END)

    def apply(self, it: Iterator[Sequence[str]]) -> Iterator[LabeledSentence]:
        for tokens in it:
            idx = [self.start_idx] + [self.dictionary.get_index(t) for t in tokens] \
                + [self.end_idx]
            yield LabeledSentence(idx[:-1], idx[1:])


class LabeledSentenceToSample(Transformer):
    """``LabeledSentence`` → fixed-length ``Sample`` (reference
    ``text/LabeledSentenceToSample.scala``): pads/truncates to
    ``sequence_len``.

    Non-one-hot features are 1-based word ids for a ``LookupTable`` front
    (id 0 = padding, which LookupTable embeds to the zero vector); one-hot
    mode expands 0-based rows. Labels are 1-based (ClassNLL convention),
    padded with class 1."""

    def __init__(self, vocab_size: int, sequence_len: int,
                 one_hot: bool = False) -> None:
        self.vocab_size = vocab_size
        self.sequence_len = sequence_len
        self.one_hot = one_hot

    def apply(self, it: Iterator[LabeledSentence]) -> Iterator[Sample]:
        L = self.sequence_len
        for s in it:
            n = min(L, len(s.data))
            if self.one_hot:
                feat = np.zeros((L, self.vocab_size), np.float32)
                feat[np.arange(n), np.asarray(s.data[:n], np.int64)] = 1.0
            else:
                feat = np.zeros((L,), np.float32)
                feat[:n] = np.asarray(s.data[:n], np.float32) + 1.0
            labels = np.ones((L,), np.float32)
            labels[:n] = np.asarray(s.labels[:n], np.float32) + 1.0
            yield Sample(feat, labels)


class SequenceWindower(Transformer):
    """Long token-id streams → contiguous next-word windows for language
    modelling (the reference PTB pipeline's fixed ``numSteps`` batching):
    yields ``LabeledSentence(ids[i:i+L], ids[i+1:i+L+1])`` with stride ``L``;
    the ragged tail is dropped, so no padding ever enters the LM loss."""

    def __init__(self, sequence_len: int) -> None:
        self.sequence_len = sequence_len

    def apply(self, it: Iterator[Sequence[int]]) -> Iterator[LabeledSentence]:
        L = self.sequence_len
        for ids in it:
            for i in range(0, len(ids) - L, L):
                yield LabeledSentence(ids[i:i + L], ids[i + 1:i + L + 1])


class SentenceToWordIndices(Transformer):
    """(tokens, label) pairs → classification ``Sample``s: pad/truncate the
    token ids to ``sequence_len``; label passes through unchanged (the
    textclassifier pipeline's shape)."""

    def __init__(self, dictionary: Dictionary, sequence_len: int,
                 pad_index: int = 0) -> None:
        self.dictionary = dictionary
        self.sequence_len = sequence_len
        self.pad_index = pad_index

    def apply(self, it: Iterator[Tuple[Sequence[str], Any]]) -> Iterator[Sample]:
        L = self.sequence_len
        for tokens, label in it:
            idx = [self.dictionary.get_index(t) + 1 for t in tokens][:L]
            idx = idx + [self.pad_index] * (L - len(idx))
            yield Sample(np.asarray(idx, np.float32), np.float32(label))
