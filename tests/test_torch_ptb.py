"""The PTB language model (``bigdl_tpu_torch/models/rnn.py``) and the
language-model example (``bigdl_tpu_torch/examples/languagemodel.py``)
against the JAX package on the CPU: a 2-layer ``PTBModel``'s forward,
gradients and one ``Adagrad`` step from JAX's weights; ``SimpleRNN``;
``train_main`` on the synthetic corpus and on a ``-f`` text file (the
first two ``Loss`` scalars against JAX's main from the same weights,
then the loss falls over more iterations); the example's stacked-cell
step against JAX's ``lm_step_fn`` and against ``model.forward``, its
beam search against JAX's on the same weights, and its ``main``, the
twin of ``tests/test_examples.py:56``.

Tolerances: 1e-5 relative to the tensor's largest magnitude for
log-probabilities, logits, gradients and the Adagrad accumulator (f32,
a few steps of small products); parameters after the step where
``|g|`` is clear of 0 (above 1e-4 of the largest), since Adagrad's
first update is ``±lr`` where ``g`` is within rounding of 0; the mains'
losses 1e-5 relative; beam scores 1e-5 and the beams' ids exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import rnn as jrnn
from bigdl_tpu.utils.random_gen import RNG
from bigdl_tpu_torch.models import rnn as trnn
from bigdl_tpu_torch.utils.params_tree import load_jax_tree, named_leaves
from tests.torch_parity import one_torch_thread  # noqa: F401

V, H, B, T = 23, 12, 4, 7


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _ids(shape, seed, vocab=V):
    return np.random.default_rng(seed).integers(
        1, vocab + 1, shape).astype(np.float32)


@pytest.fixture(scope="module")
def ptb():
    """(JAX 2-layer PTBModel, the port's with its weights, jitted JAX
    loss-and-grad and Adagrad step)."""
    from bigdl_tpu.nn.criterion import (
        ClassNLLCriterion, TimeDistributedCriterion,
    )
    from bigdl_tpu.optim.optim_method import Adagrad
    from bigdl_tpu.optim.train_step import make_train_step

    RNG.set_seed(4)
    jm = jrnn.PTBModel(V, H, num_layers=2)
    jm._ensure_params()
    tm = load_jax_tree(trnn.PTBModel(V, H, num_layers=2, device="cpu"),
                       jax.device_get(jm.params))
    crit = TimeDistributedCriterion(ClassNLLCriterion())

    def loss(p, x, y):
        out, _ = jm.apply(p, x, {}, training=False)
        return crit.apply(out, y), out

    grad = jax.jit(jax.value_and_grad(loss, has_aux=True))
    opt = Adagrad(learning_rate=0.1)
    step = jax.jit(make_train_step(jm, crit, opt))
    return jm, tm, grad, step, opt


def test_ptb_model_forward_gradients_and_adagrad_step(ptb):
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import Adagrad
    from bigdl_tpu_torch.optim.train_step import make_train_step

    jm, tm, jgrad, jstep, jopt = ptb
    x, y = _ids((B, T), 1), _ids((B, T), 2)
    params = jax.device_get(jm.params)
    (jloss, want), jg = jgrad(params, jnp.asarray(x), jnp.asarray(y))
    crit = TimeDistributedCriterion(ClassNLLCriterion())
    out = tm(torch.from_numpy(x))
    assert _rel(out, want) <= 1e-5
    torch.testing.assert_close(out.exp().sum(-1), torch.ones(B, T))
    loss = crit.apply(out, torch.from_numpy(y))
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(
        float(jloss))
    grads = dict(zip((k for k, _ in tm.named_parameters()),
                     torch.autograd.grad(loss, list(tm.parameters()))))
    want_g = named_leaves(tm, jax.device_get(jg))
    for k, w in want_g.items():
        assert _rel(grads[k], w) <= 1e-5, k

    jp, js, _, jl = jstep(params, jopt.init_state(params), {},
                          jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(y))
    opt = Adagrad(learning_rate=0.1)
    tp = {k: p.detach().clone() for k, p in tm.named_parameters()}
    tp, ts, _, tl = make_train_step(tm, crit, opt)(
        tp, opt.init_state(tp), {}, None, torch.from_numpy(x),
        torch.from_numpy(y))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    want_acc = named_leaves(tm, jax.device_get(js["accum"]))
    want_p = named_leaves(tm, jax.device_get(jp))
    for k, acc in want_acc.items():
        assert _rel(ts["accum"][k], acc) <= 1e-5, k
        clear = np.sqrt(acc) > 1e-4 * np.sqrt(acc).max()
        assert _rel(tp[k].numpy()[clear], want_p[k][clear]) <= 1e-5, k


def test_simple_rnn_matches_jax():
    RNG.set_seed(7)
    jm = jrnn.SimpleRNN(9, 6)
    jm._ensure_params()
    tm = load_jax_tree(trnn.SimpleRNN(9, 6, device="cpu"),
                       jax.device_get(jm.params))
    ids = _ids((2, 4), 3, 9)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    assert got.shape == (2, 4, 9)
    assert _rel(got, jm.forward(jnp.asarray(ids))) <= 1e-5
    assert type(tm[1].cell).__name__ == "RnnCell"


def _capture_jax_init(monkeypatch):
    """JAX's ``train_main`` keeps its model's initial params and the
    port's builds its model with them."""
    init = {}
    jax_build, port_build = jrnn.PTBModel, trnn.PTBModel

    def jax_ptb(*a, **kw):
        m = jax_build(*a, **kw)
        m._ensure_params()
        init["params"] = jax.device_get(m.params)
        return m

    def port_ptb(*a, **kw):
        return load_jax_tree(port_build(*a, **kw), init["params"])

    monkeypatch.setattr(jrnn, "PTBModel", jax_ptb)
    monkeypatch.setattr(trnn, "PTBModel", port_ptb)


def _corpus(path, words=600, seed=0):
    """A text file whose next word mostly follows from the previous."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(17)]
    toks = [0]
    for _ in range(words - 1):
        toks.append((toks[-1] + int(rng.integers(1, 3))) % len(vocab))
    path.write_text(" ".join(vocab[t] for t in toks))
    return str(path)


@pytest.mark.parametrize("branch", ["synthetic", "folder"])
def test_train_main_matches_jax_and_learns(monkeypatch, tmp_path, branch):
    from bigdl_tpu.visualization.summary import TrainSummary as JSummary
    from bigdl_tpu_torch.visualization import TrainSummary

    _capture_jax_init(monkeypatch)
    argv = ["-b", "8", "--seqLen", "8", "--hidden", "16",
            "--learningRate", "0.1"]
    argv += {"synthetic": ["--synthetic", "96", "--vocab", "30"],
             "folder": ["-f", _corpus(tmp_path / "train.txt")]}[branch]
    RNG.set_seed(12)
    jrnn.train_main(argv + ["--maxIteration", "2",
                            "--summary", str(tmp_path / "jax")])
    model = trnn.train_main(argv + ["--maxIteration", "36", "--summary",
                                    str(tmp_path / "port"), "--device",
                                    "cpu"])
    want = JSummary(str(tmp_path / "jax"), "train").read_scalar("Loss")
    got = TrainSummary(str(tmp_path / "port"), "train").read_scalar("Loss")
    np.testing.assert_allclose([v for _, v in got[:2]],
                               [v for _, v in want], rtol=1e-5)
    losses = [v for _, v in got]
    assert len(losses) == 36 and np.isfinite(losses).all()
    assert np.mean(losses[-6:]) < 0.8 * np.mean(losses[:6]), losses
    vocab = 30 if branch == "synthetic" else 18      # 17 words + OOV slot
    assert model[0].n_index == vocab and len(model.layers()) == 4


# -- the example -------------------------------------------------------------

def test_lm_step_matches_jax_and_forward(ptb):
    """The stacked-cell step against JAX's ``lm_step_fn`` on the same
    tokens and carries, and, fed a prompt token by token, against
    ``model.forward``'s log-probabilities at every position; the trained
    model's tree is untouched by the stacking."""
    from bigdl_tpu.examples.languagemodel import lm_step_fn as jstep_fn
    from bigdl_tpu_torch.examples.languagemodel import lm_step_fn

    jm, tm, *_ = ptb
    keys = [(m.name, m._container_key) for m in tm.modules()
            if isinstance(m, torch.nn.Module) and hasattr(m, "name")]
    names = [k for k, _ in tm.named_parameters()]
    jstep, jcell = jstep_fn(jm)
    step, cell = lm_step_fn(tm)
    assert keys == [(m.name, m._container_key) for m in tm.modules()
                    if hasattr(m, "name")]
    assert names == [k for k, _ in tm.named_parameters()]
    prompt = _ids((2, T), 5).astype(np.int64) - 1       # 0-based tokens
    jc = jcell.init_carry(2)
    tc = cell.init_carry(2, "cpu")
    with torch.no_grad():
        want_lp = tm(torch.from_numpy(prompt + 1.0).float())
        for t in range(T):
            jl, jc = jstep(None, jnp.asarray(prompt[:, t]), jc)
            tl, tc = step(None, torch.from_numpy(prompt[:, t]), tc)
            assert _rel(tl, jl) <= 1e-5
            for a, b in zip(tc, jc):
                assert _rel(a, b) <= 1e-5
            assert _rel(torch.log_softmax(tl, -1), want_lp[:, t]) <= 1e-5


def test_beam_search_matches_jax_on_the_same_weights(ptb):
    from bigdl_tpu.examples.languagemodel import lm_step_fn as jstep_fn
    from bigdl_tpu.nn.beam_search import beam_search as jbeam
    from bigdl_tpu_torch.examples.languagemodel import generate

    jm, tm, *_ = ptb
    K, L = 3, 6
    jstep, jcell = jstep_fn(jm)
    carry0 = jax.tree_util.tree_map(
        lambda x: np.tile(np.asarray(x), (K, 1)), jcell.init_carry(1))
    jseqs, jscores = jbeam(jstep, None, carry0, 1, K, V, L, sos_id=0,
                           eos_id=V + 7, alpha=0.6)
    seqs, scores = generate(tm, K, L)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(jseqs))
    assert _rel(scores, jscores) <= 1e-5
    assert bool((scores[0, :-1] >= scores[0, 1:]).all())


def test_languagemodel_example_beam_generation(capsys):
    from bigdl_tpu_torch.examples.languagemodel import main

    model = main(["--synthetic", "48", "--maxEpoch", "1", "--batchSize", "16",
                  "--vocab", "30", "--seqLen", "8", "--hidden", "16",
                  "--beam", "3", "--genLen", "5", "--device", "cpu"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("beam ")]
    assert len(lines) == 3
    for ln in lines:
        toks = [int(t) for t in ln.split()[4:]]
        assert len(toks) == 5 and all(1 <= t <= 30 for t in toks)
    scores = [float(ln.split()[3]) for ln in lines]
    assert scores == sorted(scores, reverse=True)
    assert model[0].n_index == 30
