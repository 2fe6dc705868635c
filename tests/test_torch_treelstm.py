"""The binary TreeLSTM (``bigdl_tpu_torch/models/treelstm.py``) and
``TreeNNAccuracy`` against the JAX package on the CPU: the twins of
``tests/test_treelstm.py:53`` (the recursive oracle), ``:65`` (padding
nodes), ``:79`` and ``:148`` (``TreeNNAccuracy``), ``:97`` (the sentiment
net trained with L-BFGS), and the tree forward and its gradients
(embedding, leaf and composition weights, the head) against JAX's on a
padded batch of trees of several shapes.

Tolerances: 1e-5 relative to the tensor's largest magnitude for node
states, log-probabilities and gradients, and for the first L-BFGS loss
and gradient (f32; one product per node summed in another order); the
oracle within JAX's own test bar (1e-5 absolute); accuracies exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import treelstm as jtree
from bigdl_tpu.utils.random_gen import RNG
from bigdl_tpu_torch.models import treelstm as ttree
from bigdl_tpu_torch.utils.params_tree import load_jax_tree, named_leaves
from tests.torch_parity import one_torch_thread  # noqa: F401


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _tree_arrays():
    """((the cat) (sat down)): 7 nodes, children before parents, 1-based
    child indices; node 7 is the root."""
    word = np.array([1, 2, 0, 3, 4, 0, 0], np.int32)
    left = np.array([0, 0, 1, 0, 0, 4, 3], np.int32)
    right = np.array([0, 0, 2, 0, 0, 5, 6], np.int32)
    return word, left, right


def _forest(seed, batch, vocab, n_pad=13, leaves=(2, 7)):
    """A padded batch of random trees (``synthetic_trees``), checked to be
    in the encoding: children before parents, one root per tree."""
    word, left, right, labels = ttree.synthetic_trees(
        batch, vocab, leaves=leaves, n_nodes=n_pad, seed=seed)
    idx = np.arange(1, n_pad + 1)
    assert np.all((left < idx) & (right < idx))
    real = (word > 0) | (left > 0)
    assert np.all((labels > 0) == real)
    for b in range(batch):
        kids = set(left[b][left[b] > 0]) | set(right[b][right[b] > 0])
        assert len(set(idx[real[b]]) - kids) == 1
    return [word, left, right]


def _oracle(params, word, left, right, H):
    """The recursive reference of tests/test_treelstm.py (numpy)."""
    emb = np.asarray(params["embedding"])
    w_leaf, b_leaf = np.asarray(params["w_leaf"]), np.asarray(params["b_leaf"])
    w_comp, b_comp = np.asarray(params["w_comp"]), np.asarray(params["b_comp"])

    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))

    memo = {}

    def node(i):
        if i not in memo:
            if word[i] > 0:
                iou = emb[word[i] - 1] @ w_leaf + b_leaf
                c = sig(iou[:H]) * np.tanh(iou[2 * H:])
                h = sig(iou[H:2 * H]) * np.tanh(c)
            else:
                (hl, cl), (hr, cr) = node(left[i] - 1), node(right[i] - 1)
                g = np.concatenate([hl, hr]) @ w_comp + b_comp
                c = (sig(g[:H]) * np.tanh(g[2 * H:3 * H])
                     + sig(g[3 * H:4 * H]) * cl + sig(g[4 * H:]) * cr)
                h = sig(g[H:2 * H]) * np.tanh(c)
            memo[i] = (h, c)
        return memo[i]

    return np.stack([node(i)[0] for i in range(len(word))])


def _pair(vocab, emb, hidden, seed):
    RNG.set_seed(seed)
    jm = jtree.BinaryTreeLSTM(vocab, emb, hidden)
    jm._ensure_params()
    tm = ttree.BinaryTreeLSTM(vocab, emb, hidden, device="cpu")
    return jm, load_jax_tree(tm, jax.device_get(jm.params))


def _as_torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_treelstm_matches_recursive_oracle():
    jm, tm = _pair(10, 5, 6, 0)
    word, left, right = _tree_arrays()
    with torch.no_grad():
        out = tm(_as_torch([word[None], left[None], right[None]]))[0]
    want = _oracle(jax.device_get(jm.params), word, left, right, 6)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)


def test_treelstm_padding_nodes_zero():
    _, tm = _pair(10, 4, 5, 1)
    pad = [np.concatenate([a, np.zeros(3, np.int32)]) for a in _tree_arrays()]
    with torch.no_grad():
        out = tm(_as_torch([a[None] for a in pad]))[0]
    assert bool((out[7:] == 0).all())
    assert float(out[:7].abs().sum()) > 0


@pytest.fixture(scope="module")
def sentiment():
    """A JAX TreeLSTMSentiment, the port's with its weights, and JAX's
    jitted root-and-all-nodes loss with its gradient."""
    from bigdl_tpu.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.models import TreeLSTMSentiment

    RNG.set_seed(3)
    jm = jtree.TreeLSTMSentiment(20, 6, 8, 3)
    jm._ensure_params()
    tm = load_jax_tree(TreeLSTMSentiment(20, 6, 8, 3, device="cpu"),
                       jax.device_get(jm.params))
    crit = TimeDistributedCriterion(ClassNLLCriterion())

    def loss(p, xs, y, cot):
        out, _ = jm.apply(p, xs, {})
        return crit.apply(out[:, -1:], y) + jnp.sum(out * cot), out

    return jm, tm, jax.jit(jax.value_and_grad(loss, has_aux=True))


def test_tree_forward_and_gradients_match_jax(sentiment):
    """A padded batch of random trees through the whole net; the loss
    reads every node's log-probabilities, so every parameter (the
    embedding's used rows, leaf and composition weights, the head) has a
    gradient to compare."""
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion

    jm, tm, jgrad = sentiment
    xs = _forest(0, 6, 20)
    y = np.random.default_rng(1).integers(1, 4, (6, 1)).astype(np.float32)
    cot = np.random.default_rng(2).standard_normal(
        (6, 13, 3)).astype(np.float32)
    params = jax.device_get(jm.params)
    (jl, want), jg = jgrad(params, [jnp.asarray(a) for a in xs],
                           jnp.asarray(y), jnp.asarray(cot))
    out = tm(_as_torch(xs))
    assert _rel(out, want) <= 1e-5
    loss = (TimeDistributedCriterion(ClassNLLCriterion()).apply(
        out[:, -1:], torch.from_numpy(y)) + (out * torch.from_numpy(cot))
        .sum())
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    grads = dict(zip((k for k, _ in tm.named_parameters()),
                     torch.autograd.grad(loss, list(tm.parameters()))))
    for k, w in named_leaves(tm, jax.device_get(jg)).items():
        assert _rel(grads[k], w) <= 1e-5, k


def test_treenn_accuracy_matches_jax():
    from bigdl_tpu.optim import TreeNNAccuracy as JAcc
    from bigdl_tpu_torch.optim import TreeNNAccuracy

    out = np.zeros((2, 3, 4), np.float32)
    out[0, 2, 1] = 5.0   # tree 0's root predicts class 2
    out[0, 0, 0] = 5.0   # tree 0's leaf predicts class 1
    out[1, 1, 3] = 5.0   # tree 1's root (node 1) predicts class 4
    target = np.array([[1, 0, 2], [3, 4, 0]], np.float32)
    root = TreeNNAccuracy().apply(torch.from_numpy(out), target)
    assert root.result() == (1.0, 2)
    every = TreeNNAccuracy(all_nodes=True).apply(out, target)
    assert every.result() == (0.75, 4)
    for all_nodes in (False, True):
        assert TreeNNAccuracy(all_nodes).apply(out, target).result() == \
            JAcc(all_nodes).apply(out, target).result()
    rng = np.random.default_rng(4)
    out = rng.standard_normal((5, 9, 3)).astype(np.float32)
    target = rng.integers(0, 4, (5, 9)).astype(np.float32)
    target[2] = 0                         # a tree with no labelled node
    for all_nodes in (False, True):
        got = TreeNNAccuracy(all_nodes).apply(out, target)
        want = JAcc(all_nodes).apply(out, target)
        assert (got.correct, got.count) == (want.correct, want.count)
    empty = TreeNNAccuracy().empty_result()
    assert (empty + got).result() == got.result()
    assert repr(TreeNNAccuracy(True)) == JAcc(True).name


def test_treenn_accuracy_shape_tolerance():
    from bigdl_tpu_torch.optim import TreeNNAccuracy

    out = np.zeros((2, 3, 4), np.float32)
    out[:, :, 1] = 1.0
    t3 = np.full((2, 3, 1), 2.0, np.float32)    # trailing singleton dim
    assert TreeNNAccuracy(all_nodes=True).apply(out, t3).result() == (1.0, 6)
    single = TreeNNAccuracy(all_nodes=True).apply(out[0], t3[0, :, 0])
    assert single.result() == (1.0, 3)
    with pytest.raises(ValueError, match="does not match"):
        TreeNNAccuracy().apply(out, np.zeros((2, 5), np.float32))


def test_treelstm_sentiment_trains_with_lbfgs():
    """Root sentiment of small synthetic trees, learnt with L-BFGS from
    JAX's init (the twin of tests/test_treelstm.py:97): the first loss and
    gradient equal JAX's, the loss halves and the roots are right."""
    from bigdl_tpu.nn import ClassNLLCriterion as JNLL
    from bigdl_tpu_torch.models import TreeLSTMSentiment
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import LBFGS, TreeNNAccuracy
    from torch.func import functional_call

    RNG.set_seed(5)
    V, N, Bt = 8, 7, 16
    jm = jtree.TreeLSTMSentiment(V, embedding_dim=8, hidden_size=8,
                                 class_num=2)
    jm._ensure_params()
    tm = load_jax_tree(TreeLSTMSentiment(V, 8, 8, 2, device="cpu"),
                       jax.device_get(jm.params))
    word, left, right = _tree_arrays()
    words = np.stack([word] * Bt)
    rngs = np.random.RandomState(0)
    labels = np.zeros((Bt, N), np.float32)
    for b in range(Bt):
        tok = rngs.randint(1, V + 1)
        words[b, 0] = tok
        labels[b, 6] = 1 + (tok % 2)          # root label only
    xs = [words, np.stack([left] * Bt), np.stack([right] * Bt)]

    def jloss(p):
        out, _ = jm.apply(p, xs, jm.state)
        return JNLL().apply(out[:, 6, :], labels[:, 6])

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jax.device_get(jm.params))
    crit, txs = ClassNLLCriterion(), _as_torch(xs)
    root_t = torch.from_numpy(labels[:, 6])

    def feval(params):
        ps = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = crit.apply(functional_call(tm, ps, (txs,))[:, 6, :], root_t)
        return loss.detach(), dict(zip(ps, torch.autograd.grad(
            loss, list(ps.values()))))

    params = {k: p.detach() for k, p in tm.named_parameters()}
    l0, g0 = feval(params)
    assert abs(float(l0) - float(jl)) <= 1e-5 * abs(float(jl))
    for k, w in named_leaves(tm, jax.device_get(jg)).items():
        assert _rel(g0[k], w) <= 1e-5, k
    new, losses = LBFGS(max_iter=25).optimize(feval, params)
    assert losses[-1] < losses[0] * 0.5, f"{losses[0]} -> {losses[-1]}"
    with torch.no_grad():
        out = functional_call(tm, new, (txs,))
    acc, n = TreeNNAccuracy().apply(out, labels).result()
    assert n == Bt and acc > 0.8, f"root accuracy {acc}"
