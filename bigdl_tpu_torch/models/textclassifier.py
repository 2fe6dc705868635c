"""The BiRecurrent LSTM text classifier (``bigdl_tpu/models/
textclassifier.py``) — BASELINE config #5.

``TextClassifier`` is an optional ``LookupTable`` front (``embedding_input
=False``: (batch, seq) 1-based word ids, 0 the zero-vector padding),
then a ``BiRecurrent(merge="concat")`` LSTM whose summary is the forward
half's last step and the backward half's first (``_BiEnds``), or a
one-way ``Recurrent`` and its last step, then ``Linear`` → ``LogSoftMax``.
The child order and the params tree are the JAX model's, so
:func:`bigdl_tpu_torch.utils.params_tree.load_jax_tree` carries JAX
weights across. Weights are f32, made on ``device`` (default ``cuda``;
raises without a card unless ``device="cpu"``) from ``generator``
(default: torch's global generator). The recurrence is plain PyTorch
(``nn/recurrent.py``), as JAX's is a ``lax.scan`` outside Pallas.

``train_main`` is the reference's TextClassifier main with ``Adagrad``:
synthetic class-dependent token sequences, or ``-f`` a news20-style
folder (one subdirectory per class of text files) through
``simple_tokenize`` and ``Dictionary``; ``--device`` (default ``cuda``).
Its default compute dtype is f32: under bf16 the float word ids above
256 would round. ``--news20`` is the reference pyspark pipeline: the
20-Newsgroups corpus under ``-f`` (its tree or archive; the synthetic
corpus when neither is there, ``dataset/news20.py``), tokenized and
embedded with GloVe vectors on the host into ``(seqLen, embeddingDim)``
features, then ``TextClassifier(embedding_input=True)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn import (
    LSTM, BiRecurrent, Linear, LogSoftMax, LookupTable, Recurrent, Select,
    Sequential, TensorModule,
)
from bigdl_tpu_torch.utils.device import resolve_device


class _BiEnds(TensorModule):
    """(B, T, 2H) bidirectional output → (B, 2H): the forward half's last
    step and the backward half's first, where each direction has read the
    whole sequence."""

    def __init__(self, hidden_size: int) -> None:
        super().__init__()
        self.hidden_size = hidden_size

    def forward(self, x):
        h = self.hidden_size
        return torch.cat([x[:, -1, :h], x[:, 0, h:]], dim=-1)


def TextClassifier(class_num: int, embedding_dim: int = 200,
                   hidden_size: int = 128, vocab_size: Optional[int] = None,
                   embedding_input: bool = True, bidirectional: bool = True,
                   device=None, generator=None) -> Sequential:
    kw = {"device": resolve_device(device), "generator": generator}
    model = Sequential()
    if not embedding_input:
        if vocab_size is None:
            raise ValueError(
                "vocab_size is required with embedding_input=False")
        model.add(LookupTable(vocab_size, embedding_dim, **kw))
    if bidirectional:
        model.add(BiRecurrent(merge="concat").add(
            LSTM(embedding_dim, hidden_size, **kw)))
        model.add(_BiEnds(hidden_size))
        feat = 2 * hidden_size
    else:
        model.add(Recurrent().add(LSTM(embedding_dim, hidden_size, **kw)))
        model.add(Select(2, -1))  # the last time step
        feat = hidden_size
    model.add(Linear(feat, class_num, **kw))
    model.add(LogSoftMax())
    return model


def synthetic_samples(count: int, vocab: int, class_num: int, seq_len: int):
    """The main's synthetic set, JAX's draws: each sample's tokens come
    from its class's slice of the vocabulary, so the task is learnable."""
    import numpy as np

    from bigdl_tpu_torch.dataset.sample import Sample

    rng = np.random.default_rng(0)
    samples = []
    for _ in range(count):
        c = int(rng.integers(1, class_num + 1))
        base = (c - 1) * (vocab // class_num)
        toks = rng.integers(base + 1, base + vocab // class_num + 1,
                            size=(seq_len,))
        samples.append(Sample(toks.astype(np.float32), np.int32(c)))
    return samples


def folder_samples(folder: str, seq_len: int):
    """(samples, vocabulary size, class count) of a news20-style folder:
    one subdirectory per class, its files tokenized, indexed by a
    ``Dictionary`` of all of them, cut or padded (with id 1) to
    ``seq_len``."""
    import os

    import numpy as np

    from bigdl_tpu_torch.dataset.sample import Sample
    from bigdl_tpu_torch.dataset.text import Dictionary, simple_tokenize

    classes = sorted(d for d in os.listdir(folder)
                     if os.path.isdir(os.path.join(folder, d)))
    if not classes:
        raise ValueError(f"{folder}: no class subdirectories")
    docs = []
    for ci, cls in enumerate(classes):
        cdir = os.path.join(folder, cls)
        for fn in sorted(os.listdir(cdir)):
            with open(os.path.join(cdir, fn), errors="ignore") as f:
                docs.append((simple_tokenize(f.read()), ci + 1))
    d = Dictionary([t for t, _ in docs])
    samples = []
    for toks, label in docs:
        ids = [d.get_index(t) + 1 for t in toks][:seq_len]
        ids += [1] * (seq_len - len(ids))
        samples.append(Sample(np.asarray(ids, np.float32), np.int32(label)))
    return samples, d.vocab_size(), len(classes)


def news20_samples(folder, seq_len: int, embedding_dim: int):
    """(samples, class count) of the ``--news20`` pipeline: each text of
    ``get_news20(folder)`` tokenized, its first ``seq_len`` tokens
    embedded by ``glove_dict(folder/glove.6B, embedding_dim)`` (zero for
    an unknown word), zero-padded to ``(seq_len, embedding_dim)`` f32,
    with its 1-based label; the class count is the largest label."""
    import os

    import numpy as np

    from bigdl_tpu_torch.dataset.news20 import (
        DEFAULT_DIR, get_news20, glove_dict,
    )
    from bigdl_tpu_torch.dataset.sample import Sample
    from bigdl_tpu_torch.dataset.text import simple_tokenize

    data_dir = folder or DEFAULT_DIR
    texts = get_news20(data_dir)
    w2v = glove_dict(source_dir=os.path.join(data_dir, "glove.6B"),
                     dim=embedding_dim)
    zero = np.zeros((embedding_dim,), np.float32)
    samples = []
    for text, label in texts:
        toks = simple_tokenize(text)[:seq_len]
        mat = (np.stack([w2v.get(t, zero) for t in toks]) if toks
               else np.zeros((1, embedding_dim), np.float32))
        if mat.shape[0] < seq_len:
            mat = np.concatenate([mat, np.zeros(
                (seq_len - mat.shape[0], embedding_dim), np.float32)])
        samples.append(Sample(mat.astype(np.float32), np.int32(label)))
    return samples, max(lab for _, lab in texts)


def train_main(argv=None):
    """Reference ``example/textclassification/TextClassifier.scala`` /
    pyspark ``textclassifier.py`` main (BASELINE target #5); returns the
    trained model."""
    from bigdl_tpu_torch.models.utils import run_training, train_parser
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
    from bigdl_tpu_torch.optim.optim_method import Adagrad

    p = train_parser("BiRecurrent LSTM text classifier", batch_size=32,
                     learning_rate=0.05, max_epoch=3)
    p.add_argument("--vocab", type=int, default=500)
    p.add_argument("--seqLen", type=int, default=50)
    p.add_argument("--classNum", type=int, default=5)
    p.add_argument("--embeddingDim", type=int, default=64)
    p.add_argument("--news20", action="store_true",
                   help="the news20 + GloVe pipeline (pre-embedded input)")
    args = p.parse_args(argv)
    if args.news20:
        samples, class_num = news20_samples(
            args.folder, args.seqLen, args.embeddingDim)
        model = TextClassifier(class_num, embedding_dim=args.embeddingDim,
                               embedding_input=True, device=args.device)
        return run_training(
            model, samples, ClassNLLCriterion(), args,
            optim_method=Adagrad(learning_rate=args.learningRate))
    if args.folder:
        samples, vocab, class_num = folder_samples(args.folder, args.seqLen)
    else:
        vocab, class_num = args.vocab, args.classNum
        samples = synthetic_samples(args.synthetic, vocab, class_num,
                                    args.seqLen)
    model = TextClassifier(class_num, embedding_dim=args.embeddingDim,
                           vocab_size=vocab, embedding_input=False,
                           device=args.device)
    return run_training(model, samples, ClassNLLCriterion(), args,
                        optim_method=Adagrad(learning_rate=args.learningRate))


if __name__ == "__main__":
    train_main()
