"""Text helpers of the text classifier's main (``bigdl_tpu/dataset/
text.py:29-73``): ``simple_tokenize`` and the word-frequency
``Dictionary``. The sentence transformers, padding and bucketing of that
module come with the host data plane (``ROADMAP.md`` A.6)."""

from __future__ import annotations

import collections
import re
from typing import Dict, Iterable, List, Optional, Sequence


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
