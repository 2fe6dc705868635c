"""The decode step's int8 grow check without a host read
(bigdl_tpu_torch/ops/kv_requant.py and ``_kv_quant_merge_step`` in
bigdl_tpu_torch/models/transformer.py), on the CPU:

* the port's ``_kv_quant_merge_step`` against the JAX package's on
  seeded int8 caches whose (row, head) pairs mix grown, not-grown,
  zero-scale and inactive (amax 0) rows: the requantized caches bitwise,
  the scales within one f32 ulp (``SCALE_RTOL``: XLA reassociates the
  scale's constant factors);
* the batched decode step reads nothing back to the host: during each
  step ``Tensor.item``, ``.cpu``, ``.tolist``, ``.numpy``, ``__bool__``,
  ``__int__`` and ``__float__`` raise, at int8 and bf16 KV, with the
  sampler fused in;
* a 137m-shaped decode (12 heads, bf16, int8 KV, sampled), shrunk to a
  tiny width, gives bitwise the outputs and carry of the parent's step,
  whose merge read the ``grew`` flag back to the host and requantized
  only on growth (that spelling is copied here as the reference), with
  steps of both kinds in the run.

* the kernel's work split (``chunk_plan``): over a grid of shapes every
  (cache, row, head, position) is in exactly one block's chunk, and a
  chunk stays within the block's bytes unless one position exceeds them.

The kernel itself is held to its plain version on the card in
tests/test_torch_cuda.py. Every other comparison here is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import make_pair, one_torch_thread  # noqa: F401

#: XLA on the CPU folds ``amax / 127 * 1.25`` into one multiply by
#: ``1.25 / 127``, the port multiplies by f32(1 / 127) and then by 1.25 (the
#: spelling its kernel shares with PyTorch on both devices): a grown scale
#: may differ by one f32 ulp
SCALE_RTOL = 2.0 ** -23

HOST_READS = ("item", "cpu", "tolist", "numpy", "__bool__", "__int__",
              "__float__")


def _caches(case, n=6, L=7, h=3, d=8, seed=0):
    """Seeded int8 caches, scales and new-value maxima. Row 0 never grows,
    row 1 grows in every head, row 2 has zero scales and grows (its stale
    bytes requantize to zero), row 3 is inactive (amax 0), rows 4-5 mix
    grown and not-grown heads. ``case`` "none" keeps every amax below its
    scale's range, "all" lifts every active one above it."""
    rng = np.random.default_rng(seed)
    kc = rng.integers(-127, 128, size=(n, L, h, d)).astype(np.int8)
    vc = rng.integers(-127, 128, size=(n, L, h, d)).astype(np.int8)
    ks = rng.uniform(0.01, 0.1, size=(n, h)).astype(np.float32)
    vs = rng.uniform(0.01, 0.1, size=(n, h)).astype(np.float32)
    ks[2] = vs[2] = 0.0
    grow = np.zeros((n, h), bool)
    grow[1] = grow[2] = True
    grow[4:] = rng.random((n - 4, h)) < 0.5
    if case == "none":
        grow[:] = False
    elif case == "all":
        grow[:] = True
    grow[3] = False

    def amax(s):
        a = np.where(grow, (s + 0.05) * 127 * rng.uniform(1.1, 3.0, (n, h)),
                     s * 127 * rng.uniform(0.0, 0.99, (n, h)))
        a[3] = 0.0
        return a.astype(np.float32)

    return kc, vc, ks, vs, amax(ks), amax(vs)


@pytest.mark.parametrize("case", ["none", "mixed", "all"])
def test_merge_step_matches_jax(case):
    from bigdl_tpu.models.transformer import _kv_quant_merge_step as jstep
    from bigdl_tpu_torch.models.transformer import _kv_quant_merge_step

    arrs = _caches(case)
    want = [np.asarray(x) for x in jstep(*map(jnp.asarray, arrs))]
    kc, vc, *rest = (torch.from_numpy(a.copy()) for a in arrs)
    got = _kv_quant_merge_step(kc, vc, *rest)
    assert got[0] is kc and got[1] is vc          # in place
    for g, w, name in zip(got, want, ("kc", "vc", "ks", "vs", "ks_safe",
                                      "vs_safe")):
        if name in ("kc", "vc"):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=SCALE_RTOL, atol=0,
                                       err_msg=name)
    if case == "none":
        np.testing.assert_array_equal(kc.numpy(), arrs[0])
    else:
        assert (kc.numpy()[2] == 0).all()        # zero scale: stale -> 0
        np.testing.assert_array_equal(kc.numpy()[3], arrs[0][3])


def test_kv_requant_checks_its_operands():
    from bigdl_tpu_torch.ops.kv_requant import kv_requant

    kc = torch.zeros((2, 4, 3, 8), dtype=torch.int8)
    s = torch.ones((2, 3))
    with pytest.raises(ValueError, match="one shape"):
        kv_requant(kc, kc[:1], s, s, s, s)
    with pytest.raises(ValueError, match="must be"):
        kv_requant(kc, kc.clone(), s[:1], s, s, s)
    with pytest.raises(ValueError, match="int8"):
        kv_requant(kc.float(), kc.float(), s, s, s, s)
    with pytest.raises(ValueError, match="f32"):
        kv_requant(kc, kc.clone(), s, s, s.double(), s)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _knobs(n):
    from bigdl_tpu_torch.serving.sampling import (
        SamplingParams, knob_row_values, make_knob_rows,
    )

    rows = make_knob_rows(n)
    sp = SamplingParams(temperature=0.9, top_k=8, repetition_penalty=1.2)
    scal, ban = knob_row_values(sp, -1)
    for k, v in scal.items():
        rows[k][1] = v
    rows["ban_ids"][1] = ban
    return {k: torch.from_numpy(v) for k, v in rows.items()}


def _prefilled(tlm, dtype, kv_quant, n=3):
    from bigdl_tpu_torch.models.transformer import (
        make_batch_decode_step, make_batch_prefill_step, serving_params,
    )

    P = serving_params(tlm, dtype)
    step, init = make_batch_decode_step(tlm, dtype, sampling=True,
                                        kv_quant=kv_quant)
    prefill = make_batch_prefill_step(tlm, dtype, kv_quant=kv_quant)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, 29, size=(n, 6)))
    with torch.no_grad():
        _, carry = prefill(P, toks, np.asarray([6, 2, 4]), init(n))
    carry["rng"][:, 0] = torch.arange(n)
    return P, step, carry, rng


@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_decode_step_makes_no_host_read(pair, kv, monkeypatch):
    """Eight steps with every host read of a tensor patched to raise; the
    int8 run grows scales (the check reaches the requantize)."""
    _, tlm = pair
    kv_quant = kv == "int8"
    P, step, carry, rng = _prefilled(tlm, torch.bfloat16, kv_quant)
    knobs = _knobs(3)
    scales0 = carry["k0_scale"].clone() if kv_quant else None
    tok = torch.from_numpy(rng.integers(0, 29, size=(3,)))

    def refuse(*a, **k):
        raise AssertionError("the decode step read a tensor to the host")

    for t in range(8):
        active = torch.tensor([True, t % 3 != 1, True])
        with monkeypatch.context() as m:
            for name in HOST_READS:
                m.setattr(torch.Tensor, name, refuse)
            with torch.no_grad():
                tok, chosen, carry = step(P, tok, active, carry, knobs)
        assert tok.shape == (3,) and chosen.dtype == torch.float32
    if kv_quant:
        assert not torch.equal(carry["k0_scale"], scales0)


def _parent_merge_step(kc, vc, ks_old, vs_old, k_amax, v_amax, seen):
    """The parent's spelling of the decode-step merge: read the ``grew``
    flag back to the host and requantize only on growth."""
    from bigdl_tpu_torch.models.transformer import _kv_quant_merge

    grew = bool(((k_amax / 127.0 > ks_old).any()
                 | (v_amax / 127.0 > vs_old).any()).item())
    seen.append(grew)
    if grew:
        kc2, ks, _ = _kv_quant_merge(kc, ks_old, k_amax)
        vc2, vs, _ = _kv_quant_merge(vc, vs_old, v_amax)
        kc.copy_(kc2)
        vc.copy_(vc2)
    else:
        ks, vs = ks_old, vs_old
    ks_safe = torch.where(ks > 0, ks, 1.0)
    vs_safe = torch.where(vs > 0, vs, 1.0)
    return kc, vc, ks, vs, ks_safe, vs_safe


def test_137m_shaped_decode_unchanged_against_the_parent(monkeypatch):
    from bigdl_tpu_torch.models import transformer as tm

    lm = tm.TransformerLM(61, hidden_size=48, n_heads=12, n_layers=2,
                          max_len=40, output="logits", device="cpu",
                          seed=0)
    lm.evaluate()

    def run():
        P, step, carry, rng = _prefilled(lm, torch.bfloat16, True)
        knobs = _knobs(3)
        tok = torch.from_numpy(rng.integers(0, 61, size=(3,)))
        outs = []
        for t in range(20):
            active = torch.tensor([True, t % 4 != 3, True])
            with torch.no_grad():
                tok, chosen, carry = step(P, tok, active, carry, knobs)
            outs += [tok.clone(), chosen.clone()]
        return outs, carry

    got, got_carry = run()
    seen = []
    monkeypatch.setattr(tm, "_kv_quant_merge_step",
                        lambda *a: _parent_merge_step(*a, seen))
    want, want_carry = run()
    assert True in seen and False in seen        # both branches ran
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for k, v in want_carry.items():
        assert torch.equal(got_carry[k], v), k


@pytest.mark.parametrize("n,L,h,d", [(16, 512, 12, 64), (3, 37, 5, 20),
                                     (2, 300, 3, 64), (1, 1, 1, 16),
                                     (2, 9, 64, 128), (4, 1000, 256, 256)])
def test_chunk_plan_covers_each_pair_and_position_once(n, L, h, d):
    """Block (cache c, row r, part p) of the kernel's grid 2 n chunks takes
    positions p chunk .. min(L, (p + 1) chunk) of every head of its row:
    each (cache, row, head, position) once."""
    from bigdl_tpu_torch.ops.kv_requant import CHUNK_BYTES, chunk_plan

    chunk, chunks = chunk_plan(L, h, d)
    assert chunk >= 1 and chunks == -(-L // chunk)
    assert chunk * h * d <= CHUNK_BYTES or chunk == 1
    seen = np.zeros((2, n, h, L), np.int64)
    for block in range(2 * n * chunks):
        rc, part = divmod(block, chunks)
        c, row = divmod(rc, n)
        seen[c, row, :, part * chunk:min(L, (part + 1) * chunk)] += 1
    assert (seen == 1).all()
