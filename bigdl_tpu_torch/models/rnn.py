"""The PTB language model (``bigdl_tpu/models/rnn.py``; reference
``models/rnn/PTBModel.scala``): ``LookupTable`` → ``num_layers`` ×
``Recurrent(LSTM | RnnCell)`` → ``TimeDistributed(Linear)`` →
``LogSoftMax`` over the last axis, trained with
``TimeDistributedCriterion(ClassNLLCriterion())`` on next-word targets.
``SimpleRNN`` is its one-layer ``RnnCell`` variant.

The child order and the params tree are the JAX model's, so
:func:`bigdl_tpu_torch.utils.params_tree.load_jax_tree` carries JAX
weights across. Weights are f32, made on ``device`` (default ``cuda``;
raises without a card unless ``device="cpu"``) from ``generator``. No
TPU kernel lies on this path: each recurrence is the port's loop over
time (cuBLAS products on the card) and the head one product over the
folded ``(B·T, H)`` activity.

``train_main`` is the reference's ``models/rnn/Train.scala`` main with
``Adagrad``: the markov-ish synthetic corpus, or ``-f`` a text file
(``simple_tokenize`` → ``Dictionary`` → ``SequenceWindower``, 1-based
ids). Its compute dtype is f32: the float word ids above 256 would round
in bf16.
"""

from __future__ import annotations

from bigdl_tpu_torch.nn import (
    LSTM, Linear, LogSoftMax, LookupTable, Recurrent, RnnCell, Sequential,
    TimeDistributed,
)
from bigdl_tpu_torch.utils.device import resolve_device


def PTBModel(input_size: int, hidden_size: int = 200, output_size: int = None,
             num_layers: int = 2, key_type: str = "lstm", device=None,
             generator=None) -> Sequential:
    """``input_size``/``output_size``: the vocabulary (1-based ids in,
    per-step class log-probabilities out)."""
    kw = {"device": resolve_device(device), "generator": generator}
    output_size = output_size or input_size
    model = Sequential()
    model.add(LookupTable(input_size, hidden_size, **kw))
    for _ in range(num_layers):
        cell = (LSTM(hidden_size, hidden_size, **kw) if key_type == "lstm"
                else RnnCell(hidden_size, hidden_size, **kw))
        model.add(Recurrent().add(cell))
    model.add(TimeDistributed(Linear(hidden_size, output_size, **kw)))
    model.add(LogSoftMax())
    return model


def SimpleRNN(input_size: int, hidden_size: int = 200,
              output_size: int = None, device=None,
              generator=None) -> Sequential:
    return PTBModel(input_size, hidden_size, output_size, num_layers=1,
                    key_type="rnn", device=device, generator=generator)


def synthetic_samples(count: int, vocab: int, seq_len: int, seed: int = 0):
    """The main's markov-ish corpus, JAX's draws: each next id lies
    0-2 above the previous one (mod ``vocab``); the target is the input
    shifted by one."""
    import numpy as np

    from bigdl_tpu_torch.dataset.sample import Sample

    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(count):
        toks = [int(rng.integers(1, vocab + 1))]
        for _ in range(seq_len):
            toks.append(1 + (toks[-1] + int(rng.integers(0, 3))) % vocab)
        arr = np.asarray(toks, np.float32)
        samples.append(Sample(arr[:-1], arr[1:]))
    return samples


def corpus_samples(path: str, seq_len: int):
    """(next-word windows, vocabulary size) of a text file: tokenized,
    indexed by a ``Dictionary`` of all its words (1-based ids), cut into
    ``seq_len`` windows by ``SequenceWindower``."""
    import numpy as np

    from bigdl_tpu_torch.dataset.sample import Sample
    from bigdl_tpu_torch.dataset.text import (
        Dictionary, SequenceWindower, simple_tokenize,
    )

    with open(path) as f:
        tokens = simple_tokenize(f.read())
    d = Dictionary([tokens])
    ids = [d.get_index(t) + 1 for t in tokens]
    samples = [Sample(np.asarray(ls.data, np.float32),
                      np.asarray(ls.labels, np.float32))
               for ls in SequenceWindower(seq_len)(iter([ids]))]
    if not samples:
        raise ValueError(f"{path}: corpus shorter than --seqLen")
    return samples, d.vocab_size()


def train_main(argv=None):
    """Reference ``models/rnn/Train.scala`` main; returns the trained
    model."""
    from bigdl_tpu_torch.models.utils import run_training, train_parser
    from bigdl_tpu_torch.nn.criterion import (
        ClassNLLCriterion, TimeDistributedCriterion,
    )
    from bigdl_tpu_torch.optim.optim_method import Adagrad

    p = train_parser("PTB-style language model", batch_size=32,
                     learning_rate=0.1, max_epoch=2)
    p.add_argument("--vocab", type=int, default=200)
    p.add_argument("--seqLen", type=int, default=20)
    p.add_argument("--hidden", type=int, default=128)
    args = p.parse_args(argv)
    if args.folder:
        samples, vocab = corpus_samples(args.folder, args.seqLen)
    else:
        vocab = args.vocab
        samples = synthetic_samples(args.synthetic, vocab, args.seqLen)
    model = PTBModel(vocab, hidden_size=args.hidden, output_size=vocab,
                     num_layers=1, device=args.device)
    return run_training(model, samples,
                        TimeDistributedCriterion(ClassNLLCriterion()), args,
                        optim_method=Adagrad(learning_rate=args.learningRate))


if __name__ == "__main__":
    train_main()
