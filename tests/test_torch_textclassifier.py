"""The BiRecurrent LSTM text classifier's pieces against the JAX package
on the CPU: ``LSTM``, ``Recurrent`` (forward and reverse) and
``BiRecurrent`` (add and concat) forwards and gradients at T <= 8,
H <= 16; the LSTM's regularizers in the train step; its variational
dropout within the port; ``Adagrad``; ``simple_tokenize`` and
``Dictionary``; ``TextClassifier`` (both fronts, one and two directions)
over three Adagrad steps; and ``train_main``'s synthetic, folder and
``--news20`` branches at two iterations.

Tolerances, with their reasons: 1e-5 relative to the largest magnitude
for forwards, gradients and parameters (f32; eight time steps of small
products summed in other orders, ``addmm`` folding the hidden product
into the precomputed input); ``Adagrad`` within 1e-6 relative (a few f32
operations per element); token indices, dictionaries and the masks'
algebra exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import textclassifier as jtc
from bigdl_tpu.utils.random_gen import RNG
from bigdl_tpu_torch.models import textclassifier as ttc
from bigdl_tpu_torch.utils.params_tree import load_jax_tree, named_leaves
from tests.torch_parity import one_torch_thread  # noqa: F401


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _x(shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _recurrent(kind, reverse=False, p=0.0, seed=1):
    """(JAX module, port module) with JAX's weights: an LSTM(5, 16) driven
    by ``Recurrent`` or ``BiRecurrent(kind)``."""
    from bigdl_tpu import nn as jnn
    from bigdl_tpu_torch import nn as tnn

    RNG.set_seed(seed)
    if kind == "recurrent":
        jm, tm = jnn.Recurrent(), tnn.Recurrent()
        jm.reverse = tm.reverse = reverse
    else:
        jm, tm = jnn.BiRecurrent(kind), tnn.BiRecurrent(kind)
    jm.add(jnn.LSTM(5, 16, p=p))
    tm.add(tnn.LSTM(5, 16, p=p, device="cpu"))
    jm._ensure_params()
    return jm, load_jax_tree(tm, jax.device_get(jm.params))


@pytest.mark.parametrize("kind,reverse", [("recurrent", False),
                                          ("recurrent", True),
                                          ("add", False), ("concat", False)])
def test_recurrent_and_birecurrent_match_jax(kind, reverse):
    jm, tm = _recurrent(kind, reverse)
    x = _x((3, 8, 5))
    params = jax.device_get(jm.params)
    cot = _x((3, 8, 32 if kind == "concat" else 16), 4)

    def jloss(p, v):
        out, _ = jm.apply(p, v, {}, training=False)
        return jnp.sum(out * cot), out

    (_, want), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = tm(xt)
    assert _rel(got, want) <= 1e-5
    grads = torch.autograd.grad((got * torch.from_numpy(cot)).sum(),
                                [xt] + list(tm.parameters()))
    assert _rel(grads[0], jgx) <= 1e-5
    named = dict(zip((k for k, _ in tm.named_parameters()), grads[1:]))
    for k, w in named_leaves(tm, jax.device_get(jgp)).items():
        assert _rel(named[k], w) <= 1e-5, k
    if kind == "recurrent" and reverse:
        # the whole-sequence state of a reversed pass sits at t = 0
        jfwd, tfwd = _recurrent("recurrent", False)
        assert _rel(got[:, 0], want[:, 0]) <= 1e-5
        assert not np.allclose(np.asarray(want[:, 0]),
                               np.asarray(jfwd.apply(jfwd.params,
                                                     jnp.asarray(x))[0])[:, 0])


def test_birecurrent_keys_and_reverse_cell():
    jm, tm = _recurrent("concat")
    jkeys = sorted(jm.params)
    assert [k.split(":")[0] for k in jkeys] == ["0", "1"]
    fwd_cell, rev_cell = tm.fwd.cell, tm.bwd.cell
    assert rev_cell.name == fwd_cell.name + "_rev"
    assert tm.bwd.reverse and not tm.fwd.reverse
    assert set(named_leaves(tm, jax.device_get(jm.params))) == {
        k for k, _ in tm.named_parameters()}
    from bigdl_tpu_torch import nn as tnn

    b = tnn.BiRecurrent().add(tnn.LSTM(5, 16, device="cpu"))
    assert not torch.equal(b.fwd.cell.w_ih, b.bwd.cell.w_ih)
    assert torch.equal(b.bwd.cell.b_ih, torch.zeros(64))
    with pytest.raises(ValueError, match="one cell"):
        b.fwd.add(tnn.LSTM(5, 16, device="cpu"))


def test_lstm_cell_facade_matches_jax():
    from bigdl_tpu import nn as jnn
    from bigdl_tpu_torch import nn as tnn

    RNG.set_seed(2)
    jc = jnn.LSTM(5, 7)
    jc._ensure_params()
    tc = load_jax_tree(tnn.LSTM(5, 7, device="cpu"),
                       jax.device_get(jc.params))
    x, h, c = _x((3, 5), 1), _x((3, 7), 2), _x((3, 7), 3)
    want, _ = jc.apply(jc.params, [jnp.asarray(v) for v in (x, h, c)])
    got = tc([torch.from_numpy(v) for v in (x, h, c)])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-6
    zero_want, _ = jc.apply(jc.params, [jnp.asarray(x)])
    zero_got = tc([torch.from_numpy(x)])
    assert _rel(zero_got[0], zero_want[0]) <= 1e-6


def test_lstm_regularizers_match_jax():
    """``w_regularizer``/``u_regularizer``/``b_regularizer`` on an LSTM:
    the port's train-step walk regularizes ``w_ih``, ``w_hh`` and both
    biases as JAX's does."""
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.optim.regularizer import L1L2Regularizer as JL1L2
    from bigdl_tpu.optim.train_step import apply_module_regularizers as japply
    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch.optim.regularizer import L1L2Regularizer
    from bigdl_tpu_torch.optim.train_step import (
        apply_module_regularizers, module_regularizers,
    )

    RNG.set_seed(3)
    jm = jnn.Recurrent().add(jnn.LSTM(5, 6, w_regularizer=JL1L2(0.1, 0.2),
                                      u_regularizer=JL1L2(0.0, 0.3),
                                      b_regularizer=JL1L2(0.05, 0.0)))
    tm = tnn.Recurrent().add(tnn.LSTM(
        5, 6, w_regularizer=L1L2Regularizer(0.1, 0.2),
        u_regularizer=L1L2Regularizer(0.0, 0.3),
        b_regularizer=L1L2Regularizer(0.05, 0.0), device="cpu"))
    jm._ensure_params()
    params = jax.device_get(jm.params)
    load_jax_tree(tm, params)
    grads = jax.tree_util.tree_map(lambda a: _x(np.shape(a), 9), params)
    want = named_leaves(tm, jax.device_get(japply(jm, params, grads)))
    regs = module_regularizers(tm)
    assert sorted(n.rsplit(".", 1)[1] for n, _ in regs) == [
        "b_hh", "b_ih", "w_hh", "w_ih"]
    tparams = {k: p.detach() for k, p in tm.named_parameters()}
    tgrads = {k: torch.from_numpy(v)
              for k, v in named_leaves(tm, grads).items()}
    got = apply_module_regularizers(regs, tparams, tgrads)
    for k, w in want.items():
        assert _rel(got[k], w) <= 1e-6, k


def test_variational_dropout_draws_one_mask_per_sequence():
    """``LSTM(p=0.4)`` under ``Recurrent``: identity-free only in
    training mode with a generator; then the output equals the p=0 cell
    run by hand on the input times one (B, 1, I) mask and with the hidden
    state times one (B, H) mask at every step, both drawn from the
    generator in that order."""
    from bigdl_tpu_torch.nn.misc import keep_mask
    from bigdl_tpu_torch.nn.module import use_rng

    _, drop = _recurrent("recurrent", p=0.4)
    _, plain = _recurrent("recurrent", p=0.0)
    x = torch.from_numpy(_x((3, 6, 5)))
    with torch.no_grad():
        ref = plain(x)
        assert torch.equal(drop.eval()(x), ref)
        assert torch.equal(drop.train()(x), ref)           # no generator
        with use_rng(torch.Generator().manual_seed(4)):
            got = drop(x)
        g = torch.Generator().manual_seed(4)
        m_in = keep_mask((3, 1, 5), 0.6, x, g) / 0.6
        m_h = keep_mask((3, 16), 0.6, x, g) / 0.6
        cell = plain.cell
        pre = cell.precompute_input(x * m_in)
        carry = cell.init_carry(3, x.device)
        outs = []
        for t in range(6):
            carry = (carry[0] * m_h, carry[1])
            out, carry = cell.step_pre(pre[:, t], carry)
            outs.append(out)
    torch.testing.assert_close(got, torch.stack(outs, 1), rtol=0, atol=0)
    assert not torch.equal(got, ref)


# -- Adagrad --------------------------------------------------------------------

@pytest.mark.parametrize("decay,wd", [(0.0, 0.0), (0.1, 0.01)])
def test_adagrad_matches_jax_over_several_updates(decay, wd):
    from bigdl_tpu.optim.optim_method import Adagrad as JAdagrad
    from bigdl_tpu_torch.optim import Adagrad

    params = {"a": _x((4, 3), 1), "b": _x((5,), 2)}
    jm, tm = JAdagrad(0.05, decay, wd), Adagrad(0.05, decay, wd)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jm.init_state(jp), tm.init_state(tp)
    for i in range(6):
        g = {k: _x(v.shape, 10 + i) for k, v in params.items()}
        jp, js = jm.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = tm.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp)
        assert ts["neval"] == int(js["neval"]) == i + 1
        for k in params:
            assert _rel(tp[k], jp[k]) <= 1e-6
            assert _rel(ts["accum"][k], js["accum"][k]) <= 1e-6


# -- text helpers ------------------------------------------------------------------

_CORPUS = {
    "sports": ["The match ended 2-1; fans cheered!", "A late goal won it.",
               "Referee's call: offside. Fans booed the referee."],
    "tech": ["New GPU ships with 80 GB.", "The compiler's bug was fixed",
             "GPU kernels, GPU memory: the compiler decides."],
}


@pytest.fixture
def corpus_dir(tmp_path):
    root = tmp_path / "corpus"
    for cls, docs in _CORPUS.items():
        (root / cls).mkdir(parents=True)
        for i, text in enumerate(docs):
            (root / cls / f"{i}.txt").write_text(text)
    (root / "README").write_text("not a class")
    return str(root)


def test_tokenize_and_dictionary_match_jax(corpus_dir):
    from bigdl_tpu.dataset.text import Dictionary as JDict
    from bigdl_tpu.dataset.text import simple_tokenize as jtok
    from bigdl_tpu_torch.dataset import Dictionary, simple_tokenize

    docs = []
    for cls in sorted(_CORPUS):
        for fn in sorted(os.listdir(os.path.join(corpus_dir, cls))):
            with open(os.path.join(corpus_dir, cls, fn)) as f:
                docs.append(f.read())
    toks = [simple_tokenize(d) for d in docs]
    assert toks == [jtok(d) for d in docs]
    assert toks[2] == ["referee's", "call", "offside", "fans", "booed",
                       "the", "referee"]
    for size in (None, 5):
        d, j = Dictionary(toks, vocab_size=size), JDict(toks, vocab_size=size)
        assert d.index2word == j.index2word
        assert d.vocab_size() == j.vocab_size() == len(d)
        for w in ("gpu", "the", "nowhere", "fans"):
            assert d.get_index(w) == j.get_index(w)
        for i in (-1, 0, 3, d.vocab_size() - 1, 99):
            assert d.get_word(i) == j.get_word(i)
    assert Dictionary(toks, 5).index2word[:2] == ["the", "gpu"]


# -- the classifier --------------------------------------------------------------

@pytest.mark.parametrize("embedding_input", [True, False])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_text_classifier_three_adagrad_steps_match_jax(embedding_input,
                                                       bidirectional):
    from bigdl_tpu.nn import ClassNLLCriterion as JNLL
    from bigdl_tpu.optim.optim_method import Adagrad as JAdagrad
    from bigdl_tpu.optim.train_step import make_train_step as jmake
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Adagrad
    from bigdl_tpu_torch.optim.train_step import make_train_step

    kw = dict(embedding_dim=6, hidden_size=8, vocab_size=20,
              embedding_input=embedding_input, bidirectional=bidirectional)
    RNG.set_seed(5)
    jm = jtc.TextClassifier(4, **kw)
    jm._ensure_params()
    tm = load_jax_tree(ttc.TextClassifier(4, device="cpu", **kw),
                       jax.device_get(jm.params))
    rng = np.random.default_rng(6)

    def batch():
        x = (rng.standard_normal((3, 7, 6)).astype(np.float32)
             if embedding_input
             else rng.integers(0, 21, (3, 7)).astype(np.float32))
        return x, rng.integers(1, 5, 3).astype(np.float32)

    x, _ = batch()
    want, _ = jm.apply(jm.params, jnp.asarray(x))
    assert _rel(tm.eval()(torch.from_numpy(x)), want) <= 1e-5
    jstep = jax.jit(jmake(jm, JNLL(), JAdagrad(0.05)))
    tstep = make_train_step(tm.train(), ClassNLLCriterion(), Adagrad(0.05))
    jp = jax.device_get(jm.params)
    js = JAdagrad(0.05).init_state(jp)
    tp = {k: p.detach().clone() for k, p in tm.named_parameters()}
    ts = Adagrad(0.05).init_state(tp)
    for _ in range(3):
        x, y = batch()
        jp, js, _, jl = jstep(jp, js, {}, None, jnp.asarray(x),
                              jnp.asarray(y))
        tp, ts, _, tl = tstep(tp, ts, {}, None, torch.from_numpy(x),
                              torch.from_numpy(y))
        assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    for k, w in named_leaves(tm, jax.device_get(jp)).items():
        assert _rel(tp[k], w) <= 1e-5, k


def _capture_jax_init(monkeypatch):
    """Make JAX's ``train_main`` keep its model's initial params, and the
    port's build its model with them."""
    init = {}
    jax_build, port_build = jtc.TextClassifier, ttc.TextClassifier

    def jax_tc(*a, **kw):
        m = jax_build(*a, **kw)
        m._ensure_params()
        init["params"] = jax.device_get(m.params)
        return m

    def port_tc(*a, **kw):
        return load_jax_tree(port_build(*a, **kw), init["params"])

    monkeypatch.setattr(jtc, "TextClassifier", jax_tc)
    monkeypatch.setattr(ttc, "TextClassifier", port_tc)


@pytest.mark.parametrize("branch", ["synthetic", "folder", "news20"])
def test_train_main_matches_jax(monkeypatch, tmp_path, corpus_dir, branch):
    """Both mains on one data branch, two iterations from the same
    weights: the ``Loss`` scalars of ``--summary`` agree (the LSTM's
    dropout is 0, so nothing draws). ``--news20`` reads the synthetic
    corpus and vectors (no archive in ``-f``) and embeds on the host."""
    from bigdl_tpu.visualization.summary import TrainSummary as JSummary
    from bigdl_tpu_torch.visualization import TrainSummary

    _capture_jax_init(monkeypatch)
    argv = ["-b", "4", "--maxIteration", "2", "--seqLen", "12",
            "--embeddingDim", "8"]
    argv += {"synthetic": ["--synthetic", "16", "--vocab", "40",
                           "--classNum", "4"],
             "folder": ["-f", corpus_dir],
             "news20": ["--news20", "-f", str(tmp_path / "news20")]}[branch]
    RNG.set_seed(12)
    jtc.train_main(argv + ["--summary", str(tmp_path / "jax")])
    model = ttc.train_main(argv + ["--summary", str(tmp_path / "port"),
                                   "--device", "cpu"])
    assert all(torch.isfinite(p).all() for p in model.parameters())
    want = JSummary(str(tmp_path / "jax"), "train").read_scalar("Loss")
    got = TrainSummary(str(tmp_path / "port"), "train").read_scalar("Loss")
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-5)
    if branch == "news20":       # pre-embedded input, 20 classes
        layers = model.layers()
        assert type(layers[0]).__name__ == "BiRecurrent"   # no LookupTable
        assert layers[-2].weight.shape[0] == 20


def test_synthetic_samples_are_jax_draws():
    from bigdl_tpu_torch.models.textclassifier import synthetic_samples

    got = synthetic_samples(9, 500, 5, 50)
    rng = np.random.default_rng(0)
    for s in got:
        c = int(rng.integers(1, 6))
        toks = rng.integers((c - 1) * 100 + 1, c * 100 + 1, size=(50,))
        np.testing.assert_array_equal(s.feature(), toks.astype(np.float32))
        assert s.label() == c
