"""Language-model example (``bigdl_tpu/examples/languagemodel.py``):
train the PTB model (:func:`bigdl_tpu_torch.models.rnn.train_main`),
then generate from it with beam search.

The trained model's cells are stacked into one ``MultiRNNCell``, and a
decode step is: the embedding row of each beam's token, ``stack.step``,
the head's logits. The cells stay keyed in the trained model's tree (the
stack registers them without re-keying them).

    python -m bigdl_tpu_torch.examples.languagemodel --synthetic 256 \\
        --maxEpoch 1 --beam 4 --genLen 12 [--device cpu]
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def lm_step_fn(model):
    """``(symbols_to_logits(params_ignored, tokens, carry), stack)`` of a
    trained ``PTBModel``-shaped Sequential (LookupTable → N ×
    Recurrent(cell) → TimeDistributed(Linear) → LogSoftMax), any
    ``num_layers``."""
    from bigdl_tpu_torch.nn import (
        LookupTable, MultiRNNCell, Recurrent, TimeDistributed,
    )

    layers = model.layers()
    lookup = layers[0]
    if not isinstance(lookup, LookupTable):
        raise ValueError("PTBModel-shaped model expected")
    stack = MultiRNNCell([m.cell for m in layers if isinstance(m, Recurrent)])
    head = next(m for m in layers if isinstance(m, TimeDistributed)).layer

    def step(params, tokens, carry):
        # beam tokens are 0-based class indices; word id = token + 1 and
        # its embedding row is id - 1, so the row IS the token
        emb = lookup.weight.index_select(0, tokens)
        out, new_carry = stack.step(emb, carry)
        return F.linear(out, head.weight, head.bias), new_carry

    return step, stack


def generate(model, beam: int, gen_len: int, sos: int = 1):
    """Beam search from word id ``sos`` over the trained model:
    ``(sequences (1, beam, gen_len), scores (1, beam))``, 0-based class
    indices, best first; eos is unreachable (``vocab + 7``)."""
    from bigdl_tpu_torch.nn.beam_search import beam_search

    step, cell = lm_step_fn(model)
    vocab = model[0].n_index
    dev = model[0].weight.device
    carry0 = tuple(x.repeat((beam,) + (1,) * (x.dim() - 1))
                   for x in cell.init_carry(1, dev))
    with torch.no_grad():
        return beam_search(step, None, carry0, 1, beam, vocab, gen_len,
                           sos_id=sos - 1, eos_id=vocab + 7, alpha=0.6)


def main(argv=None):
    """Train (every argument but ``--beam``, ``--genLen`` and ``--sos``
    goes to ``train_main``), generate, print one ``beam k  score s  ids``
    line per beam (1-based word ids); returns the model."""
    import argparse

    from bigdl_tpu_torch.models.rnn import train_main

    p = argparse.ArgumentParser(description="LM train + beam-search generate")
    p.add_argument("--beam", type=int, default=4)
    p.add_argument("--genLen", type=int, default=12)
    p.add_argument("--sos", type=int, default=1)
    known, rest = p.parse_known_args(argv)

    model = train_main(rest)
    seqs, scores = generate(model, known.beam, known.genLen, known.sos)
    seqs, scores = seqs.cpu(), scores.cpu()
    for k in range(known.beam):
        ids = " ".join(str(int(t) + 1) for t in seqs[0, k])
        print(f"beam {k}  score {float(scores[0, k]):8.3f}  {ids}")
    return model


if __name__ == "__main__":
    main()
