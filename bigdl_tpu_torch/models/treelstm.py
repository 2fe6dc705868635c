"""Binary TreeLSTM (``bigdl_tpu/models/treelstm.py``; reference
``nn/BinaryTreeLSTM.scala`` and the ``treeLSTMSentiment`` example):
constituency-tree sentiment with a binary TreeLSTM (Tai et al. 2015),
scored per node with ``TreeNNAccuracy``.

A tree is JAX's padded array encoding, children before parents:

    word   (B, N) — 1-based token id of a leaf, 0 for an inner node
    left   (B, N) — 1-based node index of the left child (0 for a leaf)
    right  (B, N) — 1-based node index of the right child

A node is real if it has a word or children; padding nodes hold zero
states, and a word id of 0 embeds to the zero row. JAX walks the nodes
with ``lax.scan``, writing each state into a buffer whose row 0 is the
zero state. Here the leaf gates of every node run first as one product
(``(B·N, D) × (D, 3H)``), then a loop over node indices gathers both
children's states of the whole batch with one ``index_select`` from a
``((N + 1)·B, H)`` state buffer, runs the composition gates as one
``(B, 2H) × (2H, 5H)`` product, and writes the node's states into a new
buffer (``slice_scatter``, out of place: no tensor that autograd saved
is written, and a gather saves only its indices), so a node costs a
fixed number of launches forward and backward. Weights are applied as
``x @ w``, JAX's layout, ``RandomUniform(-0.1, 0.1)`` with zero biases,
f32 on ``device`` (default ``cuda``) from ``generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.init_methods import InitializationMethod, RandomUniform
from bigdl_tpu_torch.nn.module import AbstractModule, new_param
from bigdl_tpu_torch.utils.device import resolve_device


class BinaryTreeLSTM(AbstractModule):
    """Input table ``[word, left, right]``, each ``(B, N)``; output
    ``(B, N, hidden)``, the node states in the input's node order."""

    def __init__(self, vocab_size: int, embedding_dim: int, hidden_size: int,
                 init_weight: Optional[InitializationMethod] = None,
                 device=None, generator: torch.Generator = None) -> None:
        super().__init__()
        self.vocab_size = vocab_size
        self.embedding_dim = embedding_dim
        self.hidden_size = hidden_size
        self.weight_init = init_weight or RandomUniform(-0.1, 0.1)
        dev = resolve_device(device)
        E, D, H = vocab_size, embedding_dim, hidden_size
        self._generator = generator
        self.embedding = new_param((E, D), dev)
        # leaf: word embedding → (i, o, u) gates
        self.w_leaf = new_param((D, 3 * H), dev)
        self.b_leaf = new_param((3 * H,), dev)
        # composition: [h_l, h_r] → (i, o, u, f_l, f_r) gates
        self.w_comp = new_param((2 * H, 5 * H), dev)
        self.b_comp = new_param((5 * H,), dev)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> "BinaryTreeLSTM":
        """The embedding and gate weights by ``weight_init``, the gate
        biases zero."""
        g = self._draws(generator)
        for w in (self.embedding, self.w_leaf, self.w_comp):
            self.weight_init.fill(w.data, g)
        for b in (self.b_leaf, self.b_comp):
            b.data.zero_()
        return self

    def forward(self, xs):
        dev = self.w_leaf.device
        word, left, right = (torch.as_tensor(t).to(dev).long() for t in xs)
        B, N = word.shape
        H = self.hidden_size
        # leaf gates of every node in one product; row 0 embeds word id 0
        table = torch.cat([self.embedding.new_zeros(1, self.embedding_dim),
                           self.embedding])
        iou = torch.addmm(self.b_leaf, table[word].reshape(B * N, -1),
                          self.w_leaf).reshape(B, N, 3 * H)
        c_leaf = torch.sigmoid(iou[..., :H]) * torch.tanh(iou[..., 2 * H:])
        h_leaf = torch.sigmoid(iou[..., H:2 * H]) * torch.tanh(c_leaf)
        leaf = (word > 0)[..., None]
        # padding nodes (neither leaf nor parent) hold zero states
        h_leaf = torch.where(leaf, h_leaf, 0.0)
        c_leaf = torch.where(leaf, c_leaf, 0.0)
        comp = ((~leaf) & (left > 0)[..., None])
        # the rows of [l, r] children in the (node, batch)-major state
        # buffer, interleaved so one gather is [h_l, h_r]; row block 0 is
        # the zero state, node n's states go to block n + 1
        rows = torch.arange(B, device=dev)
        lr = torch.stack([left * B + rows[:, None],
                          right * B + rows[:, None]], dim=-1)  # (B, N, 2)
        lr = lr.transpose(0, 1).reshape(N, 2 * B)
        h_buf = h_leaf.new_zeros((N + 1) * B, H)
        c_buf = h_leaf.new_zeros((N + 1) * B, H)
        for n in range(N):
            h_lr = h_buf.index_select(0, lr[n]).reshape(B, 2 * H)
            c_lr = c_buf.index_select(0, lr[n]).reshape(B, 2, H)
            g = torch.addmm(self.b_comp, h_lr, self.w_comp)
            sig = torch.sigmoid(g)           # i, o, (u), f_l, f_r
            c_comp = (sig[:, :H] * torch.tanh(g[:, 2 * H:3 * H])
                      + sig[:, 3 * H:4 * H] * c_lr[:, 0]
                      + sig[:, 4 * H:] * c_lr[:, 1])
            h_comp = sig[:, H:2 * H] * torch.tanh(c_comp)
            # out of place: the gathers above saved only their indices,
            # and each step's buffer is a new tensor
            lo, hi = (n + 1) * B, (n + 2) * B
            h_buf = h_buf.slice_scatter(
                torch.where(comp[:, n], h_comp, h_leaf[:, n]), 0, lo, hi)
            c_buf = c_buf.slice_scatter(
                torch.where(comp[:, n], c_comp, c_leaf[:, n]), 0, lo, hi)
        return h_buf[B:].reshape(N, B, H).transpose(0, 1)

    def extra_repr(self) -> str:
        return (f"vocab={self.vocab_size}, emb={self.embedding_dim}, "
                f"hidden={self.hidden_size}")


def synthetic_trees(count: int, vocab: int, leaves=(10, 57),
                    n_nodes: int = 111, classes: int = 5, seed: int = 0):
    """``count`` random binary trees in the array encoding, each over a
    uniform number of leaves in ``[leaves[0], leaves[1])`` (at most
    ``(n_nodes + 1) / 2``), padded to ``n_nodes``: ``(word, left, right,
    labels)``, each ``(count, n_nodes)`` int64, with a 1-based label in
    ``1..classes`` on every real node and 0 on padding. A parent joins
    two neighbouring subtrees, so every tree is a constituency-style
    bracketing of its leaves in order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = np.zeros((4, count, n_nodes), np.int64)
    for b in range(count):
        word, left, right = [], [], []
        frontier = []
        for _ in range(int(rng.integers(*leaves))):
            word.append(int(rng.integers(1, vocab + 1)))
            left.append(0)
            right.append(0)
            frontier.append(len(word))
        while len(frontier) > 1:
            i = int(rng.integers(0, len(frontier) - 1))
            word.append(0)
            left.append(frontier[i])
            right.append(frontier[i + 1])
            frontier[i:i + 2] = [len(word)]
        n = len(word)
        if n > n_nodes:
            raise ValueError(f"a tree of {n} nodes does not fit {n_nodes}")
        out[:3, b, :n] = word, left, right
        out[3, b, :n] = rng.integers(1, classes + 1, n)
    return tuple(out)


def TreeLSTMSentiment(vocab_size: int, embedding_dim: int = 128,
                      hidden_size: int = 128, class_num: int = 5,
                      device=None, generator: torch.Generator = None):
    """The treeLSTMSentiment net: ``BinaryTreeLSTM`` → per-node
    ``TimeDistributed(Linear)`` → ``LogSoftMax``."""
    from bigdl_tpu_torch.nn import (
        Linear, LogSoftMax, Sequential, TimeDistributed,
    )

    dev = resolve_device(device)
    return (Sequential()
            .add(BinaryTreeLSTM(vocab_size, embedding_dim, hidden_size,
                                device=dev, generator=generator))
            .add(TimeDistributed(Linear(hidden_size, class_num, device=dev,
                                        generator=generator)))
            .add(LogSoftMax()))
