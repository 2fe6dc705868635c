"""The transformer LM's remaining knobs in the port (``remat``,
``layer_scan``, ``embed_grad_matmul``, ``flash_block``), Adam's bf16
slots and stochastic rounding, and the LM's ``train_main``, against the
JAX package on the CPU.

Tolerances, with their reasons:

* forwards: 1e-5 absolute on log-probs (f32 both sides, sums in other
  orders; the JAX twins hold 1e-5 to 2e-3);
* the first step's gradients, each leaf against ``jax.grad`` of the same
  loss: the largest error within 1e-5 of the leaf's largest gradient, or
  of a hundredth of the model's largest where the leaf's is smaller (the
  key projection's bias, whose gradient is zero in exact arithmetic: its
  ~1e-9 is rounding noise on both sides; other leaves err below 1e-6 of
  their own largest); Adam's step below would hide a gradient off by a
  constant factor;
* one Adam step: parameters 2e-6 absolute (f32; the step normalises the
  gradient, so a parameter moves by about lr = 1e-3 and the frameworks'
  rounding of the gradient shows only in the last bits), except the key
  projection's bias, whose gradient is rounding noise in exact
  arithmetic that Adam turns into +-lr (``_NOISE_ATOL``, as in
  ``tests/test_torch_training.py``);
* Adam with bf16 slots: three steps, parameters 1e-6 relative and the
  slots equal (the same f32 math, rounded to bf16 by the same
  round-to-nearest-even);
* ``stochastic_round`` given JAX's noise bits: bitwise (a NaN stays a
  NaN; its payload is unspecified);
* the port's own rounding: exact on bf16 values, unbiased within JAX's
  twin's bounds (30% of 4096 draws round up, +-5%);
* decode over a ``layer_scan`` or ``remat`` LM: bitwise the unrolled LM
  of the same seed (the same weights, the same ops);
* ``train_main``: the ``Loss`` scalars within 1e-4 relative, as
  ``tests/test_torch_resnet_main.py`` holds the ResNet main.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import make_pair, one_torch_thread  # noqa: F401

V, T, B = 29, 16, 4
_NOISE_ATOL = 2e-3            # +-lr of the key bias, one step of 1e-3
_GRAD_RTOL = 1e-5             # a leaf's gradient, relative to its largest
_GRAD_FLOOR = 1e-2            # ... or to this share of the model's largest

KNOBS = {
    "remat": dict(remat=True),
    "layer_scan": dict(layer_scan=True),
    "layer_scan_remat": dict(layer_scan=True, remat=True),
    "embed_grad_matmul": dict(embed_grad_matmul=True),
}


def _batch(seed, t=T):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, V + 1, size=(B, t)).astype(np.int32)
    y = rng.integers(1, V + 1, size=(B, t)).astype(np.float32)
    y[:, -3:] = 0.0
    return x, y


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_knob_forward_and_adam_step_match_jax(knob):
    from bigdl_tpu.nn.criterion_more import MaskedSoftmaxCECriterion as JCE
    from bigdl_tpu.optim.optim_method import Adam as JAdam
    from bigdl_tpu.optim.train_step import make_train_step as jmake
    from bigdl_tpu_torch.nn.criterion_more import MaskedSoftmaxCECriterion
    from bigdl_tpu_torch.optim.optim_method import Adam
    from bigdl_tpu_torch.optim.train_step import make_train_step
    from bigdl_tpu_torch.utils.params_tree import named_leaves

    jlm, tlm = make_pair(V=V, max_len=T, layers=3, output="logits",
                         **KNOBS[knob])
    x, y = _batch(1)
    want = np.asarray(jlm.forward(jnp.asarray(x)))
    with torch.no_grad():
        got = tlm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    # the gradients themselves: Adam's step normalises them, so the
    # parameters after it cannot show a gradient off by a constant factor
    def jloss(p):
        out, _ = jlm.apply(p, jnp.asarray(x), jlm.state, training=True,
                           rng=jax.random.PRNGKey(0))
        return JCE(0).apply(out, jnp.asarray(y))

    jgrads = named_leaves(tlm, jax.device_get(
        jax.jit(jax.grad(jloss))(jlm.params)))
    tgrads = {}

    def keep(grads):
        tgrads.update({k: g.detach().clone() for k, g in grads.items()})
        return grads

    jstep = jax.jit(jmake(jlm, JCE(0), JAdam(1e-3)))
    tstep = make_train_step(tlm, MaskedSoftmaxCECriterion(0), Adam(1e-3),
                            grad_transform=keep)
    jp, js = jlm.params, JAdam(1e-3).init_state(jlm.params)
    tp = {k: p.detach().clone() for k, p in tlm.named_parameters()}
    ts = Adam(1e-3).init_state(tp)
    jp, js, _, jloss = jstep(jp, js, jlm.state, jax.random.PRNGKey(0),
                             jnp.asarray(x), jnp.asarray(y))
    tp, ts, _, tloss = tstep(tp, ts, {}, None, torch.from_numpy(x),
                             torch.from_numpy(y))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert set(tgrads) == set(jgrads)
    floor = _GRAD_FLOOR * max(float(np.abs(w).max())
                              for w in jgrads.values())
    for k, w in jgrads.items():
        err = float(np.abs(tgrads[k].numpy() - w).max())
        assert err <= _GRAD_RTOL * max(float(np.abs(w).max()), floor), (
            k, err, float(np.abs(w).max()))
    for k, w in named_leaves(tlm, jax.device_get(jp)).items():
        np.testing.assert_allclose(
            tp[k].numpy(), w, rtol=0, err_msg=k,
            atol=_NOISE_ATOL if k.endswith("wk.bias") else 2e-6)


def test_flash_block_validates_and_matches_jax():
    """The twin of ``tests/test_transformer.py:413``: a flash_block LM
    (JAX's interpret-mode kernels at block 128; the port's plain flash
    version, the block stored and unused) against JAX's."""
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.nn.attention import MultiHeadAttention

    with pytest.raises(ValueError, match="multiple of 128"):
        MultiHeadAttention(32, 4, flash_block=100)
    with pytest.raises(ValueError, match="multiple of 128"):
        TransformerLM(V, 32, 4, 1, 128, flash_block=-128, device="cpu")
    jlm, tlm = make_pair(V=V, layers=1, max_len=128, use_flash="always",
                         flash_block=128)
    assert all(m.flash_block == 128 for m in tlm.modules()
               if isinstance(m, MultiHeadAttention))
    ids = np.random.default_rng(3).integers(1, V + 1, size=(1, 128))
    want = np.asarray(jlm.forward(jnp.asarray(ids.astype(np.float32))))
    with torch.no_grad():
        got = tlm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_layer_scan_holds_the_unrolled_weights_stacked():
    from bigdl_tpu_torch.models.transformer import ScanBlocks, TransformerLM

    un = TransformerLM(V, 32, 4, 3, T, device="cpu", seed=5)
    sc = TransformerLM(V, 32, 4, 3, T, device="cpu", seed=5,
                       layer_scan=True, remat=True)
    scan = sc[2]
    assert isinstance(scan, ScanBlocks) and scan.n_layers == 3
    stacked = [p for p in scan.parameters()]
    for j, p in enumerate(stacked):
        for i in range(3):
            assert torch.equal(p[i], list(un[2 + i].parameters())[j])
    views = scan.unstacked_params()
    assert len(views) == 3
    x, _ = _batch(2)
    with torch.no_grad():
        assert torch.equal(un(torch.from_numpy(x)), sc(torch.from_numpy(x)))


def test_remat_matches_plain_and_redraws_its_dropout_mask():
    """The twin of ``tests/test_containers_graph.py:137``: ``Remat``'s
    forward and gradients equal the bare child's (bitwise: the same ops
    run again), under a train step's ``functional_call`` and with a
    dropout mask that the recompute must draw again from the step's
    generator."""
    from torch.func import functional_call

    from bigdl_tpu_torch.nn import Dropout, Linear, Remat, Sequential, Tanh
    from bigdl_tpu_torch.nn.module import use_rng

    g = torch.Generator().manual_seed(0)
    inner = (Sequential().add(Linear(6, 12, device="cpu", generator=g))
             .add(Tanh()).add(Dropout(0.5))
             .add(Linear(12, 6, device="cpu", generator=g)))
    plain, rem = Sequential().add(inner), Sequential().add(Remat(inner))
    x = torch.randn(4, 6, generator=g)
    grads = []
    for m in (plain, rem):
        params = {k: p.detach().clone().requires_grad_()
                  for k, p in m.named_parameters()}
        with use_rng(torch.Generator().manual_seed(5)):
            out = functional_call(m, params, (x,))
        (out ** 2).sum().backward()
        grads.append((out.detach(), [p.grad for p in params.values()]))
    assert torch.equal(grads[0][0], grads[1][0])
    for a, b in zip(grads[0][1], grads[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("knob", ["remat", "layer_scan", "layer_scan_remat"])
def test_decode_over_knob_lm_equals_unrolled(knob):
    """``make_decode_step``, ``generate`` and the engine's batch prefill
    and decode steps over a knob LM give the unrolled LM's results."""
    from bigdl_tpu_torch.models import transformer as tm

    un = tm.TransformerLM(V, 32, 4, 2, 24, device="cpu", seed=7)
    kn = tm.TransformerLM(V, 32, 4, 2, 24, device="cpu", seed=7,
                          **KNOBS[knob])
    for m in (un, kn):
        m.evaluate()
    assert (tm.generate(kn, [3, 9, 2], length=6, temperature=0.0)
            == tm.generate(un, [3, 9, 2], length=6, temperature=0.0)).all()
    outs = []
    for m in (un, kn):
        step, init = tm.make_decode_step(m)
        carry, lps = init(2), []
        with torch.no_grad():
            for t in [4, 7, 1, 12]:
                lp, carry = step(None, torch.tensor([t, t + 1]), carry)
                lps.append(lp)
        prefill = tm.make_batch_prefill_step(m, kv_quant=True)
        bstep, binit = tm.make_batch_decode_step(m, kv_quant=True)
        P = tm.serving_params(m)
        with torch.no_grad():
            _, c = prefill(P, torch.tensor([[3, 4, 5], [6, 7, 0]]),
                           np.asarray([3, 2]), binit(2))
            lp, _ = bstep(P, torch.tensor([8, 9]),
                          torch.tensor([True, True]), c)
        outs.append(torch.stack(lps + [lp]))
    assert torch.equal(outs[0], outs[1])


# ----------------------------------------------------------------- Adam


def test_adam_bf16_state_three_steps_match_jax():
    """The twin of ``tests/test_optim_methods.py:245``, three steps held
    step by step: f32 parameters with bf16 slots."""
    from bigdl_tpu.optim import Adam as JAdam
    from bigdl_tpu_torch.optim.optim_method import Adam

    w0 = np.asarray([1.0, -2.0, 3.0, 0.37, -1e-3], np.float32)
    jo, to = JAdam(0.05, state_dtype="bf16"), Adam(0.05, state_dtype="bf16")
    jw = {"w": jnp.asarray(w0)}
    tw = {"w": torch.from_numpy(w0.copy())}
    js, ts = jo.init_state(jw), to.init_state(tw)
    assert ts["m"]["w"].dtype == ts["v"]["w"].dtype == torch.bfloat16
    for _ in range(3):
        jw, js = jo.update({"w": 2.0 * jw["w"]}, js, jw)
        tw, ts = to.update({"w": 2.0 * tw["w"]}, ts, tw)
        assert tw["w"].dtype == torch.float32
        np.testing.assert_allclose(tw["w"].numpy(), np.asarray(jw["w"]),
                                   rtol=1e-6, atol=0)
        for slot in ("m", "v"):
            np.testing.assert_array_equal(
                ts[slot]["w"].float().numpy(),
                np.asarray(js[slot]["w"], np.float32))


def test_adam_knobs_build_and_step_bf16_params():
    """bf16 parameters update in f32 and are written back in bf16, with
    and without stochastic rounding; an update is a pure function of
    (grads, state, params)."""
    from bigdl_tpu_torch.optim.optim_method import Adam

    g = {"w": torch.linspace(-1, 1, 64)}
    out = []
    for sr in (False, True, True):
        opt = Adam(1e-2, stochastic_rounding=sr)
        p = {"w": torch.full((64,), 2.0, dtype=torch.bfloat16)}
        s = opt.init_state(p)
        assert s["m"]["w"].dtype == torch.bfloat16
        for _ in range(2):
            p, s = opt.update(g, s, p)
        assert p["w"].dtype == torch.bfloat16 and s["neval"] == 2
        out.append(p["w"].clone())
    assert torch.equal(out[1], out[2])         # same steps, same bits
    assert not torch.equal(out[0], out[1])     # the noise moved some


def test_stochastic_round_bitwise_jax_given_its_bits():
    from bigdl_tpu.optim.optim_method import stochastic_round as jsr
    from bigdl_tpu_torch.optim.optim_method import _round_with_noise

    rs = np.random.RandomState(0)
    x = np.concatenate([rs.randn(2000) * 10.0 ** rs.randint(-6, 6, 2000),
                        [0.0, -0.0, 1.0, -3.5, 3.0e38, -3.0e38, 1e-40,
                         np.inf, -np.inf, np.nan]]).astype(np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        bits = np.asarray(jax.random.bits(key, x.shape, jnp.uint16))
        want = np.asarray(jsr(jnp.asarray(x), jnp.bfloat16, key)
                          .astype(jnp.float32))
        got = _round_with_noise(torch.from_numpy(x),
                                torch.from_numpy(bits.astype(np.int32)))
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        # a NaN's payload is unspecified: NaN where JAX has NaN, every
        # other value bit for bit
        nan = np.isnan(want)
        assert np.isnan(got[nan]).all()
        np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                      want[~nan].view(np.uint32))


def test_stochastic_round_exact_unbiased_and_passes_non_finite():
    """The twin of ``tests/test_optim_methods.py:272``, on the port's own
    noise."""
    from bigdl_tpu_torch.optim.optim_method import stochastic_round

    x = torch.tensor([1.0, -0.5, 0.0, 2.0])
    for seed in range(5):
        out = stochastic_round(x, torch.bfloat16,
                               torch.Generator().manual_seed(seed))
        assert torch.equal(out.float(), x)
    ulp = 2.0 ** -7                      # bf16's spacing at 1.0
    val = torch.full((4096,), 1.0 + 0.3 * ulp)
    out = stochastic_round(val, torch.bfloat16,
                           torch.Generator().manual_seed(123)).float()
    frac_up = float((out > 1.0).float().mean())
    assert 0.25 < frac_up < 0.35, frac_up
    np.testing.assert_allclose(float(out.mean()), 1.0 + 0.3 * ulp,
                               rtol=3e-4)
    bad = stochastic_round(torch.tensor([np.inf, -np.inf, np.nan]),
                           torch.bfloat16,
                           torch.Generator().manual_seed(0)).float()
    assert torch.isinf(bad[0]) and torch.isinf(bad[1]) and torch.isnan(bad[2])
    with pytest.raises(ValueError, match="bfloat16"):
        stochastic_round(x, torch.float16)


def test_adam_bf16_masters_with_sr_converge():
    """The twin of ``tests/test_optim_methods.py:309``: updates far below
    bf16's ulp move the weights with stochastic rounding and not without."""
    from bigdl_tpu_torch.optim.optim_method import Adam

    moved = {}
    for sr in (True, False):
        opt = Adam(learning_rate=1e-4, stochastic_rounding=sr)
        p = {"w": torch.full((512,), 8.0, dtype=torch.bfloat16)}
        s = opt.init_state(p)
        for _ in range(200):
            p, s = opt.update({"w": p["w"].float()}, s, p)
        assert p["w"].dtype == torch.bfloat16
        moved[sr] = 8.0 - float(p["w"].float().mean())
    assert 0.01 < moved[True] < 0.04, moved
    assert abs(moved[False]) < 1e-6, moved


# ------------------------------------------------------------ train_main


def _capture_jax_init(monkeypatch):
    from bigdl_tpu.models import transformer as jtr
    from bigdl_tpu_torch.models import transformer as ttr
    from bigdl_tpu_torch.utils.params_tree import load_jax_tree

    init = {}
    jax_build, port_build = jtr.TransformerLM, ttr.TransformerLM

    def jax_lm(*a, **kw):
        m = jax_build(*a, **kw)
        m._ensure_params()
        init["tree"] = jax.device_get(m.params)
        return m

    def port_lm(*a, **kw):
        return load_jax_tree(port_build(*a, **kw), init["tree"])

    monkeypatch.setattr(jtr, "TransformerLM", jax_lm)
    monkeypatch.setattr(ttr, "TransformerLM", port_lm)


CORPUS = ("the cat sat on the mat . the dog sat on the log . a cat and a "
          "dog met on the mat and sat . ") * 6


@pytest.mark.parametrize("source", ["synthetic", "synthetic_remat", "file"])
def test_train_main_matches_jax(monkeypatch, tmp_path, source):
    """The twin of ``tests/test_transformer.py:58`` with ``--summary``:
    the Loss of three iterations."""
    from bigdl_tpu.models import transformer as jtr
    from bigdl_tpu.utils.random_gen import RNG
    from bigdl_tpu.visualization.summary import TrainSummary as JSummary
    from bigdl_tpu_torch.models import transformer as ttr
    from bigdl_tpu_torch.visualization import TrainSummary

    _capture_jax_init(monkeypatch)
    argv = ["-b", "8", "--maxIteration", "3", "--seqLen", "12",
            "--hidden", "32", "--layers", "1", "--heads", "2"]
    if source == "file":
        path = tmp_path / "corpus.txt"
        path.write_text(CORPUS)
        argv += ["-f", str(path)]
    else:
        argv += ["--synthetic", "32", "--vocab", "30"]
    if source.endswith("remat"):
        argv += ["--remat"]
    RNG.set_seed(17)
    jtr.train_main(argv + ["--summary", str(tmp_path / "jax")])
    model = ttr.train_main(argv + ["--summary", str(tmp_path / "port"),
                                   "--device", "cpu"])
    assert all(torch.isfinite(p).all() for p in model.parameters())
    want = JSummary(str(tmp_path / "jax"), "train").read_scalar("Loss")
    got = TrainSummary(str(tmp_path / "port"), "train").read_scalar("Loss")
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-4)
