"""The recurrent family's new cells (``bigdl_tpu_torch/nn/recurrent.py``)
against the JAX package on the CPU: ``RnnCell``, ``GRU`` (both forms),
``LSTMPeephole``, ``ConvLSTMPeephole`` (with and without peepholes, odd
and even kernels), ``MultiRNNCell`` stacks, ``RecurrentDecoder`` and
``TimeDistributed``, each loaded with JAX's params (``load_jax_tree``) and
fed the same numpy-seeded input: the output, the input gradient and the
parameter gradients (``jax.grad`` against autograd). Then the cases of
``tests/test_recurrent.py`` the port can run (``:62``, ``:84``, ``:134``,
``:149``, ``:162``, ``:177``, ``:192``, ``:263``, ``:317``, ``:327``,
``:348``), the cell facade, the regularizers' walk and
``tests/test_quantized.py:91-102`` (a ``Linear`` inside
``TimeDistributed`` quantized). Dropout cannot match JAX's threefry
masks, so it is held within the port: one mask per sequence, the
identity in evaluation, ConvLSTM's per-(batch, channel) masks and
``MultiRNNCell``'s inter-layer input masks.

Tolerances: 1e-5 relative to the tensor's largest magnitude for
forwards and gradients (f32; a few steps of small products and
convolutions summed in other orders); regularizer terms 1e-6; dropout
cases exact (the same operations in the same order); the quantized
output 1e-4 of JAX's quantized one and 0.1 of the float one (the JAX
test's bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.utils.random_gen import RNG
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.utils.params_tree import load_jax_tree, named_leaves
from tests.torch_parity import one_torch_thread  # noqa: F401

RTOL = 1e-5


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _x(shape, seed=3, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _cells(ns, case):
    """The cell of ``case`` built from the namespace ``ns`` (the JAX or
    the port's ``nn``)."""
    kw = {} if ns is jnn else {"device": "cpu"}
    return {
        "rnncell": lambda: ns.RnnCell(5, 7, **kw),
        "gru": lambda: ns.GRU(5, 7, **kw),
        "gru_keras1": lambda: ns.GRU(5, 7, reset_after=False, **kw),
        "lstm_peephole": lambda: ns.LSTMPeephole(5, 7, **kw),
        "convlstm": lambda: ns.ConvLSTMPeephole(3, 4, **kw),
        "convlstm_even": lambda: ns.ConvLSTMPeephole(2, 3, kernel_i=2,
                                                     kernel_c=4, **kw),
        "convlstm_nopeep": lambda: ns.ConvLSTMPeephole(
            2, 3, with_peephole=False, **kw),
        "multi_convlstm": lambda: ns.MultiRNNCell(
            [ns.ConvLSTMPeephole(2, 3, **kw),
             ns.ConvLSTMPeephole(3, 3, **kw)]),
        "multi_lstm": lambda: ns.MultiRNNCell(
            [ns.LSTM(5, 7, **kw), ns.LSTM(7, 7, **kw)]),
        "multi_mixed": lambda: ns.MultiRNNCell(
            [ns.GRU(5, 6, **kw), ns.RnnCell(6, 7, **kw)]),
    }[case]()


#: case → the sequence input's shape (B, T, ...)
SEQ_CASES = {
    "rnncell": (3, 6, 5), "gru": (3, 6, 5), "gru_keras1": (2, 5, 5),
    "lstm_peephole": (2, 5, 5), "convlstm": (2, 4, 3, 6, 7),
    "convlstm_even": (2, 3, 2, 5, 6), "convlstm_nopeep": (1, 3, 2, 5, 5),
    "multi_convlstm": (2, 4, 2, 5, 6), "multi_lstm": (3, 5, 5),
    "multi_mixed": (3, 5, 5),
}


def _pair(build_j, build_t, seed):
    """(JAX module with its params, port module loaded with them)."""
    RNG.set_seed(seed)
    jm = build_j()
    jm._ensure_params()
    tm = build_t()
    return jm, load_jax_tree(tm, jax.device_get(jm.params))


@pytest.fixture(scope="module")
def jax_ref():
    """``ref(key, jm)``: one jitted ``(output, (param grads, input
    grads))`` of ``jm.apply`` against a cotangent, built once per case
    for the module."""
    cache = {}

    def ref(key, jm):
        if key not in cache:
            def loss(p, xs, cot):
                out, _ = jm.apply(p, xs, {}, training=False)
                outs = out if isinstance(out, list) else [out]
                return sum(jnp.sum(o * c) for o, c in zip(outs, cot)), out

            cache[key] = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                    has_aux=True))
        return cache[key]

    return ref


def _check(jm, tm, xs, ref, key, table=False, seed=4):
    """Forward, input gradients and parameter gradients of ``tm`` against
    ``jm``'s on ``xs`` (a list: the module takes the list itself when
    ``table``, else its one item)."""
    params = jax.device_get(jm.params)
    probe = jm.apply(params, [jnp.asarray(v) for v in xs] if table
                     else jnp.asarray(xs[0]), {})[0]
    probe = probe if isinstance(probe, list) else [probe]
    cot = [_x(np.shape(o), seed + i, 1.0) for i, o in enumerate(probe)]
    jx = [jnp.asarray(v) for v in xs] if table else jnp.asarray(xs[0])
    (_, want), (jgp, jgx) = ref(key, jm)(params, jx, cot)
    want = want if isinstance(want, list) else [want]
    jgx = jgx if isinstance(jgx, list) else [jgx]
    txs = [torch.from_numpy(v).requires_grad_() for v in xs]
    got = tm(txs if table else txs[0])
    got = got if isinstance(got, list) else [got]
    for g, w in zip(got, want):
        assert _rel(g, w) <= RTOL
    grads = torch.autograd.grad(
        sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, cot)),
        txs + list(tm.parameters()))
    for g, w in zip(grads[:len(txs)], jgx):
        assert _rel(g, w) <= RTOL
    named = dict(zip((k for k, _ in tm.named_parameters()),
                     grads[len(txs):]))
    leaves = named_leaves(tm, jax.device_get(jgp))
    assert set(leaves) == set(named)
    for k, w in leaves.items():
        assert _rel(named[k], w) <= RTOL, k


# -- each cell under Recurrent (test_recurrent.py :62 :84 :149 :263 :317
# :327 :348) ----------------------------------------------------------------

@pytest.mark.parametrize("case,reverse", [
    (c, False) for c in sorted(SEQ_CASES)] + [
    (c, True) for c in ("gru", "convlstm", "multi_lstm")])
def test_cell_under_recurrent_matches_jax(case, reverse, jax_ref):
    def build(ns):
        def make():
            r = ns.Recurrent().add(_cells(ns, case))
            r.reverse = reverse
            return r
        return make

    jm, tm = _pair(build(jnn), build(tnn), seed=len(case))
    _check(jm, tm, [_x(SEQ_CASES[case])], jax_ref, ("rec", case, reverse))


def test_gru_forms_differ_on_the_same_weights():
    """``reset_after=False`` (keras-1) is a different function of the
    same weights (test_recurrent.py:348's last check)."""
    _, t1 = _pair(lambda: jnn.Recurrent().add(jnn.GRU(3, 4)),
                  lambda: tnn.Recurrent().add(tnn.GRU(3, 4, device="cpu")), 2)
    t2 = tnn.Recurrent().add(tnn.GRU(3, 4, reset_after=False, device="cpu"))
    with torch.no_grad():
        for p2, p1 in zip(t2.parameters(), t1.parameters()):
            p2.copy_(p1)
    x = torch.from_numpy(_x((2, 5, 3)))
    with torch.no_grad():
        assert float((t1(x) - t2(x)).abs().max()) > 1e-4


# -- the cell facade [x_t, *carry] (test_recurrent.py:327's single step) ----

@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("case", ["rnncell", "gru", "lstm_peephole",
                                  "convlstm", "multi_lstm"])
def test_cell_facade_matches_jax(case, with_carry, jax_ref):
    jm, tm = _pair(lambda: _cells(jnn, case), lambda: _cells(tnn, case), 7)
    shape = SEQ_CASES[case]
    x = _x((shape[0],) + shape[2:], 11)
    xs = [x]
    if with_carry:
        carry = jm.init_carry_for(jnp.asarray(x))
        xs += [_x(np.shape(c), 20 + i) for i, c in enumerate(carry)]
    _check(jm, tm, xs, jax_ref, ("facade", case, with_carry), table=True)


def test_convlstm_refuses_stride_and_a_carry_without_frame():
    with pytest.raises(ValueError, match="stride 1"):
        tnn.ConvLSTMPeephole(2, 3, stride=2, device="cpu")
    with pytest.raises(ValueError, match="spatial"):
        tnn.ConvLSTMPeephole(2, 3, device="cpu").init_carry(2, "cpu")


# -- RecurrentDecoder (test_recurrent.py:162) ---------------------------------

@pytest.mark.parametrize("cell", ["rnncell", "gru", "lstm"])
def test_recurrent_decoder_matches_jax(cell, jax_ref):
    def build(ns):
        kw = {} if ns is jnn else {"device": "cpu"}
        make = {"rnncell": ns.RnnCell, "gru": ns.GRU, "lstm": ns.LSTM}[cell]
        return lambda: ns.RecurrentDecoder(6).add(make(4, 4, **kw))

    jm, tm = _pair(build(jnn), build(tnn), 3)
    x0 = _x((2, 4), 5)
    _check(jm, tm, [x0], jax_ref, ("decoder", cell))
    with torch.no_grad():
        out = tm(torch.from_numpy(x0))
        c = tm.cell
        o0, _ = c.step(torch.from_numpy(x0), c.init_carry(2, "cpu"))
    assert out.shape == (2, 6, 4)
    torch.testing.assert_close(out[:, 0], o0, rtol=0, atol=0)
    with pytest.raises(ValueError, match="one cell"):
        tm.add(tnn.GRU(4, 4, device="cpu"))


# -- TimeDistributed (test_recurrent.py:177) and its quantization
# (test_quantized.py:91-102) -------------------------------------------------

def test_time_distributed_matches_jax(jax_ref):
    jm, tm = _pair(lambda: jnn.TimeDistributed(jnn.Linear(5, 3)),
                   lambda: tnn.TimeDistributed(tnn.Linear(5, 3,
                                                          device="cpu")), 1)
    x = _x((3, 4, 5), 2)
    _check(jm, tm, [x], jax_ref, ("td",))
    p = jax.device_get(jm.params)[jm._key()]
    want = x @ np.asarray(p["weight"]).T + np.asarray(p["bias"])
    with torch.no_grad():
        assert _rel(tm(torch.from_numpy(x)), want) <= RTOL
    assert tm.layer is tm[0] and list(tm._modules) == [
        f"0:{tm.layer.name}"]


def test_quantize_descends_into_time_distributed():
    jm, tm = _pair(lambda: jnn.Sequential().add(
        jnn.TimeDistributed(jnn.Linear(8, 8))),
        lambda: tnn.Sequential().add(tnn.TimeDistributed(
            tnn.Linear(8, 8, device="cpu"))), 6)
    x = _x((2, 5, 8), 1, 1.0)
    with torch.no_grad():
        want_f = tm(torch.from_numpy(x)).numpy()
    q = tm.quantize()
    assert isinstance(q[0].layer, tnn.QuantizedLinear)
    want = np.asarray(jm.quantize().forward(jnp.asarray(x)))
    with torch.no_grad():
        got = q(torch.from_numpy(x))
    assert _rel(got, want_f) < 0.1
    assert _rel(got, want) <= 1e-4


# -- BiRecurrent.add with a GRU (test_recurrent.py:134) ---------------------

def test_birecurrent_add_merge_gru_matches_jax(jax_ref):
    jm, tm = _pair(lambda: jnn.BiRecurrent().add(jnn.GRU(4, 4)),
                   lambda: tnn.BiRecurrent().add(tnn.GRU(4, 4, device="cpu")),
                   8)
    x = _x((2, 3, 4), 9)
    _check(jm, tm, [x], jax_ref, ("bi_gru",))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        torch.testing.assert_close(tm(xt), tm.fwd(xt) + tm.bwd(xt),
                                   rtol=0, atol=0)
    fresh = tnn.BiRecurrent().add(tnn.GRU(4, 4, device="cpu"))
    assert fresh.bwd.cell.name == fresh.fwd.cell.name + "_rev"
    assert not torch.equal(fresh.fwd.cell.w_hh, fresh.bwd.cell.w_hh)


# -- regularizers (test_recurrent.py:192) -----------------------------------

@pytest.mark.parametrize("case", ["rnncell", "gru", "lstm_peephole",
                                  "convlstm"])
def test_cell_regularizers_match_jax(case):
    from bigdl_tpu.optim.regularizer import L1L2Regularizer as JL1L2
    from bigdl_tpu.optim.train_step import apply_module_regularizers as japply
    from bigdl_tpu_torch.optim.regularizer import L1L2Regularizer
    from bigdl_tpu_torch.optim.train_step import (
        apply_module_regularizers, module_regularizers,
    )

    def build(ns, reg):
        def make():
            c = _cells(ns, case)
            c.w_regularizer = reg(0.1, 0.2)
            c.u_regularizer = reg(0.0, 0.3)
            c.b_regularizer = reg(0.05, 0.0)
            return ns.Recurrent().add(c)
        return make

    jm, tm = _pair(build(jnn, JL1L2), build(tnn, L1L2Regularizer), 3)
    params = jax.device_get(jm.params)
    grads = jax.tree_util.tree_map(lambda a: _x(np.shape(a), 9), params)
    want = named_leaves(tm, jax.device_get(japply(jm, params, grads)))
    regs = module_regularizers(tm)
    bias = ["b_ih"] if case == "convlstm" else ["b_hh", "b_ih"]
    assert sorted(n.rsplit(".", 1)[1] for n, _ in regs) == sorted(
        bias + ["w_hh", "w_ih"])
    tparams = {k: p.detach() for k, p in tm.named_parameters()}
    tgrads = {k: torch.from_numpy(v)
              for k, v in named_leaves(tm, grads).items()}
    got = apply_module_regularizers(regs, tparams, tgrads)
    for k, w in want.items():
        assert _rel(got[k], w) <= 1e-6, k


def test_rnncell_activation_stays_out_of_the_tree():
    from bigdl_tpu_torch.nn.activations import ReLU

    c = tnn.RnnCell(3, 4, activation=ReLU(), device="cpu")
    assert list(c.named_children()) == []
    assert sorted(k for k, _ in c.named_parameters()) == [
        "b_hh", "b_ih", "w_hh", "w_ih"]
    x = torch.from_numpy(_x((2, 3), 1))
    with torch.no_grad():
        out, _ = c.step(x, c.init_carry(2, "cpu"))
    assert bool((out >= 0).all()) and bool((out > 0).any())


# -- a recurrent model trains (test_recurrent.py:233, :263's second half) ---

@pytest.mark.parametrize("case", ["gru", "convlstm"])
def test_recurrent_model_trains(case):
    from bigdl_tpu_torch.optim import Adam
    from bigdl_tpu_torch.optim.train_step import make_train_step

    torch.manual_seed(0)
    model = tnn.Sequential().add(tnn.Recurrent().add(_cells(tnn, case)))
    shape = SEQ_CASES[case]
    x = torch.from_numpy(_x(shape, 1))
    with torch.no_grad():
        tgt = torch.from_numpy(_x(tuple(model(x).shape), 2))
    opt = Adam(1e-2)
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = opt.init_state(params)
    step = make_train_step(model, tnn.MSECriterion(), opt)
    losses = []
    for _ in range(8):
        params, state, _, loss = step(params, state, {}, None, x, tgt)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


# -- dropout within the port (test_recurrent.py:214) ------------------------

def _masked_run(cell, x, gen, p_in, specs):
    """``cell`` under ``Recurrent`` by hand with masks drawn from ``gen``
    in Recurrent's order: the input's, then one per spec."""
    from bigdl_tpu_torch.nn.misc import keep_mask

    b = x.shape[0]
    if p_in > 0:
        x = x * (keep_mask((b, 1) + tuple(x.shape[2:]), 1 - p_in, x, gen)
                 / (1 - p_in))
    masks = [keep_mask((b, w), 1 - p, x, gen) / (1 - p) if p > 0 else None
             for p, w in specs]
    pre = cell.precompute_input(x)
    carry = cell.init_carry_for(x)
    step = cell.with_masks(masks)
    outs = []
    for t in range(x.shape[1]):
        carry = cell.mask_carry(carry, masks)
        out, carry = step(pre[:, t], carry)
        outs.append(out)
    return torch.stack(outs, 1)


@pytest.mark.parametrize("case", ["rnncell", "gru", "lstm_peephole",
                                  "convlstm", "multi"])
def test_variational_dropout_one_mask_per_sequence(case):
    from bigdl_tpu_torch.nn.module import use_rng

    if case == "multi":
        cell = tnn.MultiRNNCell([tnn.GRU(5, 6, p=0.3, device="cpu"),
                                 tnn.LSTM(6, 7, p=0.5, device="cpu")])
        shape = (3, 5, 5)
    else:
        cell = _cells(tnn, case)
        cell.p = 0.4
        shape = SEQ_CASES[case]
    rec = tnn.Recurrent().add(cell)
    x = torch.from_numpy(_x(shape, 2))
    specs = cell.dropout_specs()
    with torch.no_grad():
        with use_rng(None):
            plain = rec.train()(x)                     # no generator
        assert torch.equal(rec.eval()(x), plain)       # eval: identity
        with use_rng(torch.Generator().manual_seed(4)):
            assert torch.equal(rec.eval()(x), plain)
            got = rec.train()(x)
        want = _masked_run(cell, x, torch.Generator().manual_seed(4),
                           cell.input_dropout_p, specs)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, plain)
    if case == "convlstm":
        # the hidden mask is per (batch, channel), broadcast over H, W
        assert specs == [(0.4, 4)]
        m = torch.ones(2, 4)
        m[0, 1] = 0.0
        h, c = cell.mask_carry((torch.ones(2, 4, 6, 7),
                                torch.ones(2, 4, 6, 7)), [m])
        assert float(h[0, 1].abs().max()) == 0.0 and bool((h[1] == 1).all())
        assert bool((c == 1).all())
    if case == "multi":
        # recurrent specs first, then one inter-layer input spec
        assert specs == [(0.3, 6), (0.5, 7), (0.5, 6)]
        assert cell.input_dropout_p == 0.3


def test_multirnncell_inter_layer_mask_drops_the_lower_output():
    """With every recurrent mask None, the inter-layer mask alone zeroes
    the second cell's input features: the stack equals its second cell
    stepped on the first cell's masked output."""
    a = tnn.GRU(4, 5, device="cpu")
    b = tnn.RnnCell(5, 3, device="cpu")
    stack = tnn.MultiRNNCell([a, b])
    x = torch.from_numpy(_x((2, 4), 3))
    carry = stack.init_carry(2, "cpu")
    m = torch.tensor([[1.0, 0.0, 2.0, 0.0, 2.0]]).expand(2, 5)
    with torch.no_grad():
        got, _ = stack.with_masks([None, None, m])(
            stack.precompute_input(x), carry)
        h1, _ = a.step(x, carry[:1])
        want, _ = b.step(h1 * m, carry[1:])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_multirnncell_keeps_a_held_cell_key():
    rec = tnn.Recurrent().add(tnn.LSTM(3, 3, device="cpu"))
    key = rec.cell._container_key
    stack = tnn.MultiRNNCell([rec.cell, tnn.LSTM(3, 3, device="cpu")])
    assert rec.cell._container_key == key
    assert stack[1]._container_key == f"1:{stack[1].name}"
    assert list(stack._modules) == [f"0:{rec.cell.name}",
                                    f"1:{stack[1].name}"]
