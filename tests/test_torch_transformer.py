"""The port's TransformerLM and serving steps
(bigdl_tpu_torch/models/transformer.py) against the JAX package's, at
V=29, hidden 32, 4 heads, 2 layers, max_len 48, f32 on the CPU, with the
JAX weights carried across by ``load_jax_params``:

* the full-sequence forward (the simplest proof that the weights carried
  across compute the same function);
* the batched prefill (with a ballast row and a suffix continuation over
  start offsets) and the pooled decode step, teacher-forced on the same
  tokens, fp32 and int8 KV — log-probs, K/V carries, scales and ``pos``
  compared key by key;
* inactive and ballast rows stay bitwise untouched.

Tolerances: 1e-4 absolute on log-probs and 1e-5 on f32 caches and
scales (f32 math, sums in another order); int8 caches may differ by one
quantum where a value sits on a rounding boundary, and at most 1% of
them may."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (  # noqa: F401
    make_pair, np_tree, one_torch_thread,
)

LOGP_TOL = 1e-4
F32_TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _assert_cache_close(got, want, key):
    if want.dtype == np.int8:
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1, key
        assert (diff > 0).mean() <= 0.01, key
    else:
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0,
                                   err_msg=key)


def _assert_carry_close(got, want, keys=None):
    for key in keys or want:
        if key == "pos":
            np.testing.assert_array_equal(got[key], want[key])
        elif key.endswith("_scale"):
            np.testing.assert_allclose(got[key], want[key], rtol=F32_TOL,
                                       atol=0, err_msg=key)
        else:
            _assert_cache_close(got[key], want[key], key)


def test_load_jax_params_matches_children_by_index(pair):
    """The JAX and port child names differ (per-process instance
    counters), yet every parameter carried across equals its JAX leaf."""
    jlm, tlm = pair
    jkeys, tkeys = list(jlm.params), list(tlm._modules)
    assert [k.split(":")[0] for k in jkeys] == \
        [k.split(":")[0] for k in tkeys]
    assert jkeys != tkeys
    jp = jax.device_get(jlm.params)
    blk_j, blk_t = jp[jkeys[2]], tlm[2]
    np.testing.assert_array_equal(
        blk_t.attn.wq.weight.detach().numpy(),
        blk_j[list(blk_j)[1]]["wq"]["weight"])
    np.testing.assert_array_equal(tlm[1].pos.detach().numpy(),
                                  jp[jkeys[1]]["pos"])


def test_load_jax_params_rejects_mismatched_trees(pair):
    from bigdl_tpu_torch.models.transformer import (
        TransformerLM, load_jax_params,
    )

    jlm, _ = pair
    wrong = TransformerLM(29, hidden_size=32, n_heads=4, n_layers=3,
                          max_len=48, device="cpu")
    with pytest.raises(ValueError):
        load_jax_params(wrong, jax.device_get(jlm.params))


def test_full_forward_matches_jax(pair):
    jlm, tlm = pair
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 30, size=(3, 12)).astype(np.float32)
    want = np.asarray(jlm.forward(jnp.asarray(ids)))
    with torch.no_grad():
        got = tlm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGP_TOL, rtol=0)


def _jax_steps(jlm, kv_quant):
    from bigdl_tpu.models.transformer import (
        make_batch_decode_step, make_batch_prefill_step, serving_params,
    )

    prefill = make_batch_prefill_step(jlm, None, kv_quant=kv_quant)
    step, init = make_batch_decode_step(jlm, None, kv_quant=kv_quant)
    return prefill, step, init, serving_params(jlm, None)


def _port_steps(tlm, kv_quant):
    from bigdl_tpu_torch.models.transformer import (
        make_batch_decode_step, make_batch_prefill_step, serving_params,
    )

    prefill = make_batch_prefill_step(tlm, None, kv_quant=kv_quant)
    step, init = make_batch_decode_step(tlm, None, kv_quant=kv_quant)
    return prefill, step, init, serving_params(tlm, None)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp32", "int8"])
def test_batch_prefill_matches_jax(pair, kv_quant):
    """Two prefill rounds on a 3-row carry: lengths (5, 0, 8) from pos 0,
    then a suffix continuation (3, 2, 0) over the written prefixes. Row
    1 is ballast in round one and row 2 in round two: bitwise untouched."""
    jlm, tlm = pair
    jpre, _, jinit, jP = _jax_steps(jlm, kv_quant)
    tpre, _, tinit, tP = _port_steps(tlm, kv_quant)
    rng = np.random.default_rng(1)
    jc, tc = jinit(3), tinit(3)
    for lengths in ([5, 0, 8], [3, 2, 0]):
        toks = rng.integers(0, 29, size=(3, 8)).astype(np.int32)
        ln = np.asarray(lengths, np.int32)
        jl, jc = jpre(jP, jnp.asarray(toks), ln, jc)
        before = {k: v.clone() for k, v in tc.items()}
        with torch.no_grad():
            tl, tc = tpre(tP, torch.from_numpy(toks), ln, tc)
        live = ln > 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=LOGP_TOL, rtol=0)
        _assert_carry_close(np_tree(tc), np_tree(jax.device_get(jc)))
        ballast = int(np.flatnonzero(~live)[0])
        for k, v in tc.items():
            assert torch.equal(v[ballast], before[k][ballast]), k


def test_prefill_never_writes_its_input_carry(pair):
    """The shared zero carry of batched admission survives any number of
    prefills bitwise."""
    _, tlm = pair
    tpre, _, tinit, tP = _port_steps(tlm, True)
    zero = tinit(2)
    snapshot = {k: v.clone() for k, v in zero.items()}
    with torch.no_grad():
        tpre(tP, torch.ones((2, 4), dtype=torch.long), [4, 2], zero)
    for k, v in zero.items():
        assert torch.equal(v, snapshot[k]), k


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp32", "int8"])
def test_batch_decode_step_matches_jax(pair, kv_quant):
    """Prefill 3 rows, then 5 teacher-forced decode steps with row 1
    inactive throughout (and row 2 inactive in step 3): log-probs of the
    active rows and every carry leaf compare with JAX, and the inactive
    rows' carry is bitwise what it was before each step."""
    jlm, tlm = pair
    jpre, jstep, jinit, jP = _jax_steps(jlm, kv_quant)
    tpre, tstep, tinit, tP = _port_steps(tlm, kv_quant)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 29, size=(3, 8)).astype(np.int32)
    ln = np.asarray([6, 3, 8], np.int32)
    _, jc = jpre(jP, jnp.asarray(toks), ln, jinit(3))
    with torch.no_grad():
        _, tc = tpre(tP, torch.from_numpy(toks), ln, tinit(3))
    for t in range(5):
        feed = rng.integers(0, 29, size=(3,)).astype(np.int32)
        active = np.asarray([True, False, t != 3])
        jl, jc = jstep(jP, jnp.asarray(feed), jnp.asarray(active),
                       jax.tree_util.tree_map(jnp.array, jc))
        before = {k: v.clone() for k, v in tc.items()}
        with torch.no_grad():
            tl, tc = tstep(tP, torch.from_numpy(feed),
                           torch.from_numpy(active), tc)
        np.testing.assert_allclose(tl.numpy()[active],
                                   np.asarray(jl)[active], atol=LOGP_TOL,
                                   rtol=0)
        _assert_carry_close(np_tree(tc), np_tree(jax.device_get(jc)))
        for r in np.flatnonzero(~active):
            for k, v in tc.items():
                assert torch.equal(v[r], before[k][r]), (t, r, k)


def test_int8_merge_step_grow_and_no_grow_match_unconditional_merge():
    """The decode-step merge (host-read ``grew`` flag, requantize only on
    growth) is bitwise the unconditional merge, in both branches, and
    updates the pooled cache in place."""
    from bigdl_tpu_torch.models.transformer import (
        _kv_quant_merge, _kv_quant_merge_step,
    )

    g = torch.Generator().manual_seed(3)
    kc = torch.randint(-127, 128, (3, 6, 2, 4), dtype=torch.int8,
                       generator=g)
    ks = torch.rand(3, 2, generator=g) * 0.1
    for scale_up in (0.5, 40.0):        # no row grows / some rows grow
        amax = torch.rand(3, 2, generator=g) * ks * 127 * scale_up
        want_c, want_s, _ = _kv_quant_merge(kc, ks, amax)
        c, vc = kc.clone(), kc.clone()
        got_c, _, got_s, _, _, _ = _kv_quant_merge_step(
            c, vc, ks, ks, amax, amax)
        assert got_c is c
        assert torch.equal(got_c, want_c) and torch.equal(got_s, want_s)
