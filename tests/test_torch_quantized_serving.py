"""A weight-only int8 TransformerLM served by the port
(bigdl_tpu_torch/models/transformer.py's ``_serving_proj`` through
bigdl_tpu_torch/ops/w8a16.py, and the serving plane over it) against the
JAX package on the CPU, at make_pair()'s size (V=29, hidden 32, 4 heads,
2 layers, max_len 48). The JAX model is quantized with its ``Quantizer``
and its quantized tree carried into the port's quantized twin with
``load_jax_params``, so both hold the same codes:

* the quantized tree equals JAX's in keys, shapes and dtypes under both
  schemes: attention's wq/wk/wv/wo float, fc1, fc2 and the head int8;
* ``w8a16_plain`` and the serving projection against JAX's
  ``_serving_proj`` weight_q branch (f32 and bf16 activations);
* ``make_decode_step`` teacher-forced against JAX's over 6 steps (the
  int8 half of tests/test_transformer.py:469), and against the model's
  own full forward; prefill against sequential decode (:549's
  weight-only case); the batch prefill, decode and verify steps against
  JAX's at fp32 and int8 KV; a dynamic-scheme LM serving with weight-only
  math, as in JAX;
* ``remat`` models as JAX's; a ``layer_scan`` model quantized per layer
  and per output channel equals the unrolled quantized model; JAX's
  stacked tree reduces over the output axis and is refused by the
  loader, and JAX's quantized ``layer_scan`` LM scales every output by
  one input column's scale (a fault of the reference, ROADMAP C.1);
* ``adapter_site_shapes`` and ``AdapterBank`` refuse a quantized model,
  as JAX's do;
* ``ServingEngine`` over the weight-only model against the port's own
  ``generate`` (float KV, fp32 and bf16) and against JAX's int8-KV engine;
  a ``Speculator`` with a weight-only draft and target against the plain
  engine.

Tolerances: log-probs against JAX 1e-4 at f32 (f32 sums in another
order; every bf16 product of the projections is exact in f32) and 5e-2 at
bf16 (the frameworks' bf16 roundings differ, as in
tests/test_torch_generate.py); the projection 1e-5 relative at f32 and
2^-6 of its largest value at bf16 (the cast and the bias add may each
round one bf16 ulp apart, at most 2^-7 of a value); f32 caches 1e-5; int8 caches
within one quantum on at most 1% of values; tokens exactly, across
frameworks on requests whose JAX top-2 gap clears ``GAP`` at every step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (  # noqa: F401
    make_pair, np_tree, one_torch_thread, top2_gaps,
)

LOGP_TOL = 1e-4
BF16_TOL = 5e-2
F32_TOL = 1e-5
GAP = 1e-2
V = 29


def _quantized_pair(scheme="weight_only", **kw):
    """(JAX quantized LM, port quantized LM) holding the same codes."""
    from bigdl_tpu.nn.quantized import Quantizer as JQuantizer
    from bigdl_tpu_torch.models.transformer import load_jax_params

    jlm, tlm = make_pair(**kw)
    jq = JQuantizer.quantize(jlm, scheme)
    tq = tlm.quantize(scheme)
    load_jax_params(tq, jax.device_get(jq.params))
    return jq, tq


@pytest.fixture(scope="module")
def qpair():
    return _quantized_pair()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = k.split(":", 1)[0]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{key}/"))
        else:
            out[prefix + key] = (tuple(v.shape),
                                 str(v.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("scheme", ["weight_only", "dynamic"])
def test_quantized_lm_tree_equals_jax_with_attention_float(scheme):
    from bigdl_tpu.nn.quantized import Quantizer as JQuantizer
    from bigdl_tpu_torch.models.transformer import _params_tree
    from bigdl_tpu_torch.nn import Linear, QuantizedLinear

    jlm, tlm = make_pair()
    want = _flat(jax.device_get(JQuantizer.quantize(jlm, scheme).params))
    tq = tlm.quantize(scheme)
    assert _flat(_params_tree(tq)) == want
    int8 = sorted(k for k, v in want.items() if v[1] == "int8")
    assert int8 == ["2/3/weight_q", "2/4/weight_q", "3/3/weight_q",
                    "3/4/weight_q", "5/weight_q"]
    for blk in (tq[2], tq[3]):
        assert all(type(getattr(blk.attn, n)) is Linear
                   for n in ("wq", "wk", "wv", "wo"))
        assert isinstance(blk.fc1, QuantizedLinear)
        assert blk.fc2.scheme == scheme
    assert not tq.training


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_serving_projection_matches_jax(qpair, dtype, lead):
    from bigdl_tpu.models.transformer import _serving_proj as jproj
    from bigdl_tpu_torch.models.transformer import (
        _params_tree, _serving_proj,
    )
    from bigdl_tpu_torch.ops.w8a16 import w8a16, w8a16_plain

    jq, tq = qpair
    jp = jax.device_get(jq.params)
    key = list(jp)[2]
    jfc1 = jp[key][list(jp[key])[3]]
    tfc1 = _params_tree(tq)[list(tq._modules)[2]][tq[2]._child_key(3)]
    x = np.random.default_rng(5).standard_normal((*lead, 32)).astype(
        np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    jparams = {k: jnp.asarray(v) for k, v in jfc1.items()}
    jparams["bias"] = jparams["bias"].astype(jdt)
    tparams = dict(tfc1, bias=tfc1["bias"].to(tdt))
    acc = jax.lax.dot_general(jx.astype(jnp.bfloat16),
                              jparams["weight_q"].astype(jnp.bfloat16),
                              (((len(lead),), (1,)), ((), ())),
                              preferred_element_type=jnp.float32)
    want_acc = np.asarray(acc * jparams["w_scale"][:, 0])
    got_acc = w8a16_plain(tx, tfc1["weight_q"], tfc1["w_scale"])
    assert got_acc.dtype == torch.float32
    scale = float(np.abs(want_acc).max())
    assert float(np.abs(got_acc.numpy() - want_acc).max()) <= 1e-5 * scale
    assert torch.equal(w8a16(tx, tfc1["weight_q"], tfc1["w_scale"]),
                       got_acc)
    want = np.asarray(jproj(jparams, jx).astype(jnp.float32))
    got = _serving_proj(tparams, tx)
    assert got.dtype == tdt
    tol = 1e-5 * scale if dtype == "fp32" else 2.0 ** -6 * scale
    assert float(np.abs(got.float().numpy() - want).max()) <= tol


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_decode_step_teacher_forced_matches_jax(qpair, dtype):
    from bigdl_tpu.models.transformer import make_decode_step as jmake
    from bigdl_tpu_torch.models.transformer import make_decode_step

    jq, tq = qpair
    jdt, tdt, tol = {"fp32": (None, None, LOGP_TOL),
                     "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}[dtype]
    jstep, jinit = jmake(jq, compute_dtype=jdt)
    tstep, tinit = make_decode_step(tq, compute_dtype=tdt)
    jc, tc = jinit(2), tinit(2)
    toks = np.random.default_rng(6).integers(0, V, size=(6, 2))
    for t in range(6):
        jl, jc = jstep(None, jnp.asarray(toks[t], jnp.int32), jc)
        with torch.no_grad():
            tl, tc = tstep(None, torch.as_tensor(toks[t]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol,
                                   rtol=0, err_msg=f"step {t}")


def test_decode_step_matches_own_full_forward(qpair):
    """tests/test_transformer.py:469's int8 half: the weight-only decode
    step against the quantized model's full forward (2e-3, its bound)."""
    from bigdl_tpu_torch.models.transformer import make_decode_step

    _, tq = qpair
    ids = np.random.default_rng(7).integers(1, V + 1, size=(1, 6))
    with torch.no_grad():
        full = tq(torch.as_tensor(ids, dtype=torch.float32)).numpy()
    step, init = make_decode_step(tq)
    carry = init(1)
    for t in range(6):
        with torch.no_grad():
            logp, carry = step(None, torch.as_tensor([ids[0, t] - 1]), carry)
        np.testing.assert_allclose(logp[0].numpy(), full[0, t], atol=2e-3,
                                   rtol=0)


def test_prefill_matches_sequential_decode_and_jax(qpair):
    """:549's weight-only case: the prefilled carry equals P sequential
    decode steps' (K/V 1e-5, pos exactly, log-probs 1e-4), decoding
    continues identically from it, and the prefill matches JAX's."""
    from bigdl_tpu.models.transformer import make_decode_step as jmake
    from bigdl_tpu.models.transformer import make_prefill_step as jprefill
    from bigdl_tpu_torch.models.transformer import (
        make_decode_step, make_prefill_step, serving_params,
    )

    jq, tq = qpair
    toks = np.random.default_rng(8).integers(0, V, size=(2, 7))
    step, init = make_decode_step(tq)
    prefill = make_prefill_step(tq)
    P = serving_params(tq)
    with torch.no_grad():
        c_seq = init(2)
        for t in range(7):
            l_seq, c_seq = step(P, torch.as_tensor(toks[:, t]), c_seq)
        l_pre, c_pre = prefill(P, torch.as_tensor(toks), init(2))
        assert torch.equal(c_pre["pos"], c_seq["pos"])
        for key in c_seq:
            if key != "pos":
                np.testing.assert_allclose(c_pre[key].numpy(),
                                           c_seq[key].numpy(), atol=F32_TOL,
                                           rtol=0, err_msg=key)
        np.testing.assert_allclose(l_pre.numpy(), l_seq.numpy(),
                                   atol=LOGP_TOL, rtol=0)
        _, jinit = jmake(jq)
        jl, jc = jprefill(jq)(None, jnp.asarray(toks, jnp.int32), jinit(2))
        np.testing.assert_allclose(l_pre.numpy(), np.asarray(jl),
                                   atol=LOGP_TOL, rtol=0)
        for key in c_pre:
            _cache_close(c_pre[key].numpy(), np.asarray(jc[key]), key)
        nxt = torch.as_tensor(toks[:, 0])   # the steps write their carry
        np.testing.assert_allclose(step(P, nxt, c_pre)[0].numpy(),
                                   step(P, nxt, c_seq)[0].numpy(),
                                   atol=LOGP_TOL, rtol=0)


def _cache_close(got, want, key):
    if want.dtype == np.int8:
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, key
    elif key == "pos" or want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=key)
    else:
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL,
                                   err_msg=key)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp32", "int8"])
def test_batch_prefill_and_decode_steps_match_jax(qpair, kv_quant):
    """The int8-KV serving path over weight-only weights: a 3-row batch
    prefill (one ballast row), then 4 teacher-forced pooled decode steps
    with row 1 inactive: log-probs and every carry leaf against JAX."""
    from bigdl_tpu.models import transformer as jt
    from bigdl_tpu_torch.models import transformer as tt

    jq, tq = qpair
    jpre = jt.make_batch_prefill_step(jq, None, kv_quant=kv_quant)
    jstep, jinit = jt.make_batch_decode_step(jq, None, kv_quant=kv_quant)
    tpre = tt.make_batch_prefill_step(tq, None, kv_quant=kv_quant)
    tstep, tinit = tt.make_batch_decode_step(tq, None, kv_quant=kv_quant)
    jP, tP = jt.serving_params(jq, None), tt.serving_params(tq, None)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, V, size=(3, 8)).astype(np.int32)
    ln = np.asarray([6, 0, 8], np.int32)
    jl, jc = jpre(jP, jnp.asarray(toks), ln, jinit(3))
    with torch.no_grad():
        tl, tc = tpre(tP, torch.from_numpy(toks), ln, tinit(3))
    live = ln > 0
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=LOGP_TOL, rtol=0)
    active = np.asarray([True, False, True])
    for t in range(4):
        feed = rng.integers(0, V, size=(3,)).astype(np.int32)
        jl, jc = jstep(jP, jnp.asarray(feed), jnp.asarray(active),
                       jax.tree_util.tree_map(jnp.array, jc))
        with torch.no_grad():
            tl, tc = tstep(tP, torch.from_numpy(feed),
                           torch.from_numpy(active), tc)
        np.testing.assert_allclose(tl.numpy()[active],
                                   np.asarray(jl)[active], atol=LOGP_TOL,
                                   rtol=0)
        got, want = np_tree(tc), np_tree(jax.device_get(jc))
        for key in want:
            _cache_close(got[key], want[key], key)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp32", "int8"])
def test_verify_step_matches_jax(qpair, kv_quant):
    """The speculative target's step projects through the same branch
    (``bigdl_tpu/models/transformer.py:1797``): a 4-wide chunk on row 0,
    one position on row 1, row 2 ballast."""
    from bigdl_tpu.models import transformer as jt
    from bigdl_tpu.serving.sampling import make_knob_rows as jknobs
    from bigdl_tpu_torch.models import transformer as tt
    from bigdl_tpu_torch.serving.sampling import make_knob_rows

    jq, tq = qpair
    toks = np.random.default_rng(10).integers(0, V, size=(3, 8))
    ln = np.asarray([7, 4, 0], np.int32)
    jv, jinit = jt.make_batch_verify_step(jq, None, width=4,
                                          kv_quant=kv_quant)
    jP = jt.serving_params(jq, None)
    _, jc = jt.make_batch_prefill_step(jq, None, kv_quant=kv_quant)(
        jP, jnp.asarray(toks, jnp.int32), ln, jinit(3))
    tv, tinit = tt.make_batch_verify_step(tq, None, width=4,
                                          kv_quant=kv_quant)
    tP = tt.serving_params(tq, None)
    with torch.no_grad():
        _, tc = tt.make_batch_prefill_step(tq, None, kv_quant=kv_quant)(
            tP, torch.from_numpy(toks), ln.astype(np.int64), tinit(3))
    chunk = np.asarray([[5, 3, 9, 1], [8, 0, 0, 0], [1, 2, 3, 4]], np.int32)
    lengths = np.asarray([4, 1, 0], np.int32)
    jt_, jl, jn, jc2 = jv(jP, jnp.asarray(chunk), jnp.asarray(lengths), jc,
                          {k: jnp.asarray(v)
                           for k, v in jknobs(3, vocab=V).items()})
    with torch.no_grad():
        tt_, tl, tn, tc2 = tv(tP, torch.from_numpy(chunk).long(),
                              torch.from_numpy(lengths).long(), tc,
                              {k: torch.from_numpy(v)
                               for k, v in make_knob_rows(3).items()})
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    live = np.arange(4)[None] < lengths[:, None]
    np.testing.assert_array_equal(tt_.numpy()[live], np.asarray(jt_)[live])
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=LOGP_TOL, rtol=0)
    got, want = np_tree(tc2), np_tree(jax.device_get(jc2))
    for key in want:
        if key != "rng":
            _cache_close(got[key], want[key], key)


def test_dynamic_lm_serves_with_weight_only_math():
    """The serving branch keys on ``weight_q`` and ignores the scheme, as
    JAX's does: a dynamic-scheme LM's decode step equals JAX's, and
    equals the weight-only LM's of the same codes bitwise."""
    from bigdl_tpu.models.transformer import make_decode_step as jmake
    from bigdl_tpu_torch.models.transformer import make_decode_step

    jq, tq = _quantized_pair("dynamic")
    _, tw = _quantized_pair("weight_only")
    jstep, jinit = jmake(jq)
    steps = [make_decode_step(m) for m in (tq, tw)]
    jc, cs = jinit(1), [init(1) for _, init in steps]
    for tok in (3, 17, 4, 0):
        jl, jc = jstep(None, jnp.asarray([tok], jnp.int32), jc)
        with torch.no_grad():
            outs = []
            for i, (step, _) in enumerate(steps):
                logp, cs[i] = step(None, torch.as_tensor([tok]), cs[i])
                outs.append(logp)
        assert torch.equal(outs[0], outs[1])
        np.testing.assert_allclose(outs[0].numpy(), np.asarray(jl),
                                   atol=LOGP_TOL, rtol=0)


def test_remat_lm_quantizes_as_jax():
    from bigdl_tpu.models.transformer import make_decode_step as jmake
    from bigdl_tpu.nn.quantized import Quantizer as JQuantizer
    from bigdl_tpu_torch.models.transformer import (
        _params_tree, make_decode_step,
    )

    jlm, tlm = make_pair(remat=True)
    jq = JQuantizer.quantize(jlm, "weight_only")
    tq = tlm.quantize("weight_only")
    assert _flat(_params_tree(tq)) == _flat(jax.device_get(jq.params))
    ids = np.random.default_rng(11).integers(1, V + 1, size=(2, 5))
    with torch.no_grad():
        got = tq(torch.as_tensor(ids, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, np.asarray(jq.forward(
        jnp.asarray(ids, jnp.float32))), atol=LOGP_TOL, rtol=0)
    jstep, jinit = jmake(jq)
    tstep, tinit = make_decode_step(tq)
    jc, tc = jinit(2), tinit(2)
    for t in range(3):
        jl, jc = jstep(None, jnp.asarray(ids[:, t] - 1, jnp.int32), jc)
        with torch.no_grad():
            tl, tc = tstep(None, torch.as_tensor(ids[:, t] - 1), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGP_TOL, rtol=0)


def test_layer_scan_lm_quantizes_per_layer_and_channel():
    """The port quantizes a ``ScanBlocks`` template's stacked weights per
    layer and output channel, so the layer_scan model equals the unrolled
    quantized model of the same seed (full forward and decode). JAX's
    stacked tree carries ``w_scale`` (n_layers, 1, in) — reduced over the
    output axis — and the loader refuses it."""
    from bigdl_tpu.nn.quantized import Quantizer as JQuantizer
    from bigdl_tpu_torch.models.transformer import (
        TransformerLM, load_jax_params, make_decode_step,
    )

    kw = dict(hidden_size=32, n_heads=4, n_layers=2, max_len=48,
              device="cpu", seed=5)
    scan = TransformerLM(V, layer_scan=True, **kw).quantize("weight_only")
    flat = TransformerLM(V, **kw).quantize("weight_only")
    tmpl = scan[2][0]
    assert tuple(tmpl.fc1.w_scale.shape) == (2, 128, 1)
    for i in range(2):
        assert torch.equal(tmpl.fc1.weight_q[i], flat[2 + i].fc1.weight_q)
        assert torch.equal(tmpl.fc2.w_scale[i], flat[2 + i].fc2.w_scale)
    ids = torch.as_tensor(np.random.default_rng(12).integers(
        1, V + 1, size=(2, 5)), dtype=torch.float32)
    with torch.no_grad():
        np.testing.assert_allclose(scan(ids).numpy(), flat(ids).numpy(),
                                   atol=F32_TOL, rtol=0)
        steps = [make_decode_step(m) for m in (scan, flat)]
        cs = [init(2) for _, init in steps]
        for t in range(3):
            outs = []
            for i, (step, _) in enumerate(steps):
                logp, cs[i] = step(None, ids[:, t].long() - 1, cs[i])
                outs.append(logp.numpy())
            np.testing.assert_allclose(outs[0], outs[1], atol=F32_TOL,
                                       rtol=0)
    jlm, tlm = make_pair(layer_scan=True)
    jq = JQuantizer.quantize(jlm, "weight_only")
    jp = jax.device_get(jq.params)
    stacked = jp[list(jp)[2]]
    fc1 = stacked[list(stacked)[0]]
    assert fc1[list(fc1)[3]]["w_scale"].shape == (2, 1, 32)
    with pytest.raises(ValueError, match="w_scale"):
        load_jax_params(tlm.quantize("weight_only"), jp)


def test_jax_layer_scan_quantizer_scales_by_one_input_column():
    """A fault of the reference that the port does not copy (ROADMAP C.1).
    On a ``layer_scan`` LM JAX's ``quantize_symmetric(axis=1)`` reduces
    the stacked (n_layers, out, in) weight over its output axis: its
    ``w_scale`` is (n_layers, 1, in), one scale per input column, and the
    projection multiplies every output by column 0's. With fc1's input
    columns scaled apart (x1, x2, x4, x8), JAX's quantized LM leaves its
    float model by more than ten times what the port's does; the port's
    per-layer, per-output-channel scales keep it at the int8 rounding."""
    from bigdl_tpu.nn.quantized import Quantizer as JQuantizer
    from bigdl_tpu_torch.models.transformer import load_jax_params

    jlm, tlm = make_pair(layer_scan=True)
    params = jax.device_get(jlm.params)
    stacked = params[list(params)[2]]
    block = stacked[list(stacked)[0]]
    fc1 = block[list(block)[3]]
    fc1["weight"] = np.asarray(fc1["weight"]) * (
        2.0 ** (np.arange(32) % 4)).astype(np.float32)
    jlm.params = params
    load_jax_params(tlm, params)
    ids = np.random.default_rng(13).integers(
        1, V + 1, size=(2, 6)).astype(np.float32)
    jf = np.asarray(jlm.forward(jnp.asarray(ids)))
    with torch.no_grad():
        tf = tlm(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(tf, jf, atol=LOGP_TOL, rtol=0)
    jq = JQuantizer.quantize(jlm, "weight_only")
    tq = tlm.quantize("weight_only")
    jp = jax.device_get(jq.params)
    scale = np.asarray(jp[list(jp)[2]][list(stacked)[0]][list(block)[3]]
                       ["w_scale"])
    assert scale.shape == (2, 1, 32)
    assert (scale.max(-1) / scale.min(-1) > 4).all()
    j_err = np.abs(np.asarray(jq.forward(jnp.asarray(ids))) - jf).max()
    with torch.no_grad():
        t_err = np.abs(tq(torch.as_tensor(ids)).numpy() - tf).max()
    assert j_err > 10 * t_err


def test_adapters_refuse_a_quantized_model(qpair):
    from bigdl_tpu.models.transformer import adapter_site_shapes as jshapes
    from bigdl_tpu_torch.models.transformer import adapter_site_shapes
    from bigdl_tpu_torch.serving import AdapterBank

    jq, tq = qpair
    with pytest.raises(NotImplementedError, match="quantized"):
        jshapes(jq)
    with pytest.raises(NotImplementedError, match="quantized"):
        adapter_site_shapes(tq)
    with pytest.raises(NotImplementedError, match="quantized"):
        AdapterBank(tq, rank=2, n_slots=2)


def _requests(seed, n):
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, V + 1, size=(int(rng.randint(1, 6)),)).tolist(),
             int(rng.randint(3, 9))) for _ in range(n)]


@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_engine_over_weight_only_model_matches_generate(qpair, dtype_name):
    from bigdl_tpu_torch.models.transformer import generate
    from bigdl_tpu_torch.serving import ServingEngine

    _, tq = qpair
    dtype = None if dtype_name == "fp32" else torch.bfloat16
    reqs = _requests(13, 5)
    eng = ServingEngine(tq, n_slots=3, compute_dtype=dtype, device="cpu")
    rids = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
    outs = eng.drain()
    for rid, (prompt, n) in zip(rids, reqs):
        np.testing.assert_array_equal(
            outs[rid], generate(tq, prompt, length=n, temperature=0.0,
                                compute_dtype=dtype), err_msg=str(prompt))


def test_int8_kv_engine_over_weight_only_model_matches_jax(qpair):
    """``kv_dtype="int8"`` on both sides, fp32 compute: ids equal on every
    request whose JAX stream clears ``GAP`` at every step (at least 3 of
    the 6 do)."""
    from bigdl_tpu.serving import ServingEngine as JEngine
    from bigdl_tpu_torch.serving import ServingEngine

    jq, tq = qpair
    reqs = _requests(14, 6)
    runs = []
    for eng in (JEngine(jq, n_slots=3, kv_dtype="int8"),
                ServingEngine(tq, n_slots=3, kv_dtype="int8", device="cpu")):
        rids = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
        outs = eng.drain()
        runs.append([np.asarray(outs[r]).tolist() for r in rids])
    compared = 0
    for (prompt, _), want, got in zip(reqs, *runs):
        assert len(got) == len(want)
        if top2_gaps(jq, prompt, want).min() > GAP:
            assert got == want, prompt
            compared += 1
    assert compared >= 3, compared


def test_speculator_over_weight_only_draft_and_target(qpair):
    """A weight-only target with a weight-only draft of the same codes
    (the weight-tied draft: most proposals land) and with an unrelated
    weight-only draft: greedy output equals the plain engine's at fp32."""
    from bigdl_tpu_torch.serving import ServingEngine, SpeculativeConfig

    _, tq = qpair
    _, good = _quantized_pair()
    _, bad = _quantized_pair(seed=31, hidden=16, heads=2, layers=1)
    reqs = _requests(15, 4)

    def run(draft):
        spec = None if draft is None else SpeculativeConfig(draft, k=3)
        eng = ServingEngine(tq, n_slots=3, speculative=spec, device="cpu")
        rids = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
        outs = eng.drain()
        return [np.asarray(outs[r]).tolist() for r in rids], eng

    want, _ = run(None)
    got, eng = run(good)
    assert got == want
    assert eng.metrics.summary()["serving/accept_rate"] > 0.5
    assert run(bad)[0] == want
