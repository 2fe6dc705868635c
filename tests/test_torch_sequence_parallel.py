"""The port's sequence parallelism (``bigdl_tpu_torch/parallel/
ring_attention.py`` and ``TransformerLM(sequence_parallel=)``) over gloo
ranks on the CPU, held against JAX's ``shard_map`` on a mesh of the same
size, the twin of ``tests/test_sequence_parallel.py`` and
``tests/test_transformer.py:74``.

Each world size (2 and 4) is one launch of that many worker processes
(the launcher of ``tests/test_torch_distri_optimizer.py``: a script
under ``tmp_path`` importing ``bigdl_tpu_torch`` only, a ``file://``
rendezvous, each rank's output in a file); each rank builds
``Engine.mesh(("seq",))``, takes its contiguous (or striped) shard of
the same numpy inputs and returns its outputs and gradients, which the
tests concatenate in rank order. JAX computes each reference on
``Mesh(jax.devices()[:n], ("seq",))`` meanwhile, one jitted function per
case (the flash cases through its interpret-mode kernels).

Tolerances (f32 on both sides, the blocks summed in the same ring order
but with other rounding inside each block): outputs 2e-5 absolute,
gradients 1e-4 absolute (the einsum and flash rings both reach 3e-6 in a
float64 check against dense attention; the gradients sum n blocks); the
LM's log-probs 1e-4; the summed gradients of the replicated weights 1e-4
relative to each leaf's largest magnitude (at least 1e-3 of the largest
gradient of all: the key bias's gradient is rounding noise).
"""

import pickle
import sys

import numpy as np
import pytest

from tests.test_torch_distri_optimizer import launch
from tests.torch_parity import one_torch_thread  # noqa: F401

WORLDS = (2, 4)
B, T_LOCAL, H, D = 2, 8, 4, 8
LM = dict(V=29, hidden=16, heads=4, layers=1, max_len=16, t_local=4)

#: attention cases: (function, causal, use_flash)
CASES = {
    "ring_einsum": ("ring", False, False),
    "ring_einsum_causal": ("ring", True, False),
    "ring_flash": ("ring", False, True),
    "ring_flash_causal": ("ring", True, True),
    "striped_ring": ("striped", True, True),
    "ulysses": ("ulysses", False, False),
    "ulysses_causal": ("ulysses", True, False),
    "ulysses_flash": ("ulysses", False, True),
    "ulysses_flash_causal": ("ulysses", True, True),
}
LM_MODES = ("ring", "ulysses")

WORKER = r'''
import pickle
import sys
import traceback

import numpy as np
import torch

torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
rdv, spec_path, out_path = sys.argv[3], sys.argv[4], sys.argv[5]

from bigdl_tpu_torch.models.transformer import TransformerLM
from bigdl_tpu_torch.nn import MaskedSoftmaxCECriterion
from bigdl_tpu_torch.optim.optim_method import SGD
from bigdl_tpu_torch.optim.train_step import make_train_step
from bigdl_tpu_torch.parallel.axis import sum_gradients
from bigdl_tpu_torch.parallel.ring_attention import (
    ring_attention, stripe_sequence, striped_ring_attention,
    ulysses_attention,
)
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.utils.params_tree import load_jax_tree

Engine.init_distributed(coordinator_address="file://" + rdv,
                        num_processes=world, process_id=rank, device="cpu",
                        timeout_s=60)
Engine.mesh(("seq",))
spec = pickle.load(open(spec_path, "rb"))
out = {}


def shard(a, striped=False):
    a = torch.from_numpy(a)
    if striped:
        a = stripe_sequence(a, world)
    t = a.shape[1] // world
    return a[:, rank * t:(rank + 1) * t].contiguous()


def attend(kind, causal, flash, q, k, v):
    if kind == "ring":
        return ring_attention(q, k, v, "seq", causal=causal, use_flash=flash)
    if kind == "striped":
        return striped_ring_attention(q, k, v, "seq")
    return ulysses_attention(q, k, v, "seq", causal=causal, use_flash=flash)


for name, (kind, causal, flash) in spec["cases"].items():
    try:
        striped = kind == "striped"
        q, k, v = (shard(spec[x], striped).requires_grad_()
                   for x in ("q", "k", "v"))
        o = attend(kind, causal, flash, q, k, v)
        (o * shard(spec["w"], striped)).sum().backward()
        out[name] = [t.detach().numpy() for t in (o, q.grad, k.grad, v.grad)]
    except Exception:
        out[name] = {"error": traceback.format_exc()}

try:                 # large logits: an excluded block's p overflows
    q, k, v = (shard(spec[x]).requires_grad_()
               for x in ("q_big", "k_big", "v"))
    o = ring_attention(q, k, v, "seq", causal=True, use_flash=True)
    (o ** 2).sum().backward()
    out["nan_safe"] = [t.detach().numpy() for t in (o, q.grad, k.grad,
                                                       v.grad)]
except Exception:
    out["nan_safe"] = {"error": traceback.format_exc()}

lm = spec["lm"]
for mode in spec["lm_modes"]:
    try:
        m = TransformerLM(lm["V"], lm["hidden"], lm["heads"], lm["layers"],
                          lm["max_len"], output="logits",
                          sequence_parallel=mode, device="cpu")
        load_jax_tree(m, lm["tree"])
        m.evaluate()
        with torch.no_grad():
            logits = m(shard(lm["ids"])).numpy()
        grads = {}

        def capture(g):
            g = sum_gradients("seq")(g)
            grads.update({k: v.detach().clone().numpy() for k, v in g.items()})
            return g

        step = make_train_step(m, MaskedSoftmaxCECriterion(0), SGD(0.0),
                               grad_transform=capture)
        params = {k: p.detach().clone() for k, p in m.named_parameters()}
        _, _, _, loss = step(params, {"neval": 0}, {}, None,
                             shard(lm["ids"]), shard(lm["y"]))
        out["lm_" + mode] = {"logits": logits, "loss": float(loss),
                             "grads": grads}
    except Exception:
        out["lm_" + mode] = {"error": traceback.format_exc()}

out["axis"] = (Engine.current_mesh().mesh_dim_names, world)
out["modules"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "bigdl_tpu"))
pickle.dump(out, open(f"{out_path}.{rank}", "wb"))
Engine.shutdown()
'''


def _inputs(n):
    rs = np.random.RandomState(10 + n)
    T = T_LOCAL * n
    mk = lambda s=1.0: (rs.randn(B, T, H, D) * s).astype(np.float32)  # noqa
    q, k, v, w = mk(), mk(), mk(), mk()
    T_lm = LM["t_local"] * n
    ids = rs.randint(1, LM["V"] + 1, size=(B, T_lm)).astype(np.float32)
    y = rs.randint(1, LM["V"] + 1, size=(B, T_lm)).astype(np.float32)
    y[:, -2:] = 0.0
    return dict(q=q, k=k, v=v, w=w, q_big=mk(10.0), k_big=mk(10.0),
                ids=ids, y=y)


def _jax_lm(mode):
    from bigdl_tpu.models.transformer import TransformerLM as JLM
    from bigdl_tpu.utils.random_gen import RNG

    RNG.set_seed(3)
    m = JLM(LM["V"], hidden_size=LM["hidden"], n_heads=LM["heads"],
            n_layers=LM["layers"], max_len=LM["max_len"], output="logits",
            sequence_parallel=mode, sp_axis="seq")
    m._ensure_params()
    m.evaluate()
    return m


def _jax_refs(n, x, tree):
    """JAX's results for every case on an n-device mesh; the LMs hold
    ``tree``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from bigdl_tpu.nn.criterion_more import MaskedSoftmaxCECriterion as JCE
    from bigdl_tpu.parallel.ring_attention import (
        ring_attention, stripe_sequence, striped_ring_attention,
        ulysses_attention,
    )
    from bigdl_tpu.utils.compat import shard_map

    mesh = Mesh(np.asarray(jax.devices()[:n]), ("seq",))
    seq = P(None, "seq")

    def sharded(fn):
        return shard_map(fn, mesh=mesh, in_specs=(seq, seq, seq),
                         out_specs=seq, check_vma=False)

    def attend(kind, causal, flash):
        if kind == "ring":
            return lambda q, k, v: ring_attention(q, k, v, "seq",
                                                  causal=causal,
                                                  use_flash=flash)
        if kind == "striped":
            return lambda q, k, v: striped_ring_attention(q, k, v, "seq")
        return lambda q, k, v: ulysses_attention(q, k, v, "seq",
                                                 causal=causal,
                                                 use_flash=flash)

    out = {}
    for name, (kind, causal, flash) in CASES.items():
        f = sharded(attend(kind, causal, flash))

        @jax.jit
        def run(q, k, v, w, f=f):
            o, vjp = jax.vjp(f, q, k, v)
            return (o,) + vjp(w)

        args = [x[a] for a in ("q", "k", "v", "w")]
        if kind == "striped":
            args = [stripe_sequence(a, n) for a in args]
        out[name] = [np.asarray(t) for t in run(*args)]
    f = sharded(attend("ring", True, True))

    @jax.jit
    def big(q, k, v):
        o, vjp = jax.vjp(f, q, k, v)
        return (o,) + vjp(2.0 * o)

    out["nan_safe"] = [np.asarray(t) for t in big(x["q_big"], x["k_big"],
                                                  x["v"])]
    for mode in LM_MODES:
        m = _jax_lm(mode)
        params = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(m.params),
            jax.tree_util.tree_leaves(tree))
        fwd = jax.jit(shard_map(
            lambda p, ids, m=m: m.apply(p, ids, {}, training=False)[0],
            mesh=mesh, in_specs=(P(), seq), out_specs=seq, check_vma=False))

        def loss(p, ids, y, m=m):
            def local(p, ids, y):
                lo = JCE(0).apply(m.apply(p, ids, {}, training=True)[0], y)
                return jax.lax.psum(lo, "seq")
            return shard_map(local, mesh=mesh, in_specs=(P(), seq, seq),
                             out_specs=P(), check_vma=False)(p, ids, y)

        lval, grads = jax.jit(jax.value_and_grad(loss))(
            params, jnp.asarray(x["ids"]), jnp.asarray(x["y"]))
        out["lm_" + mode] = {
            "logits": np.asarray(fwd(params, jnp.asarray(x["ids"]))),
            "loss": float(lval), "grads": jax.device_get(grads)}
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both world sizes launched at once; JAX's references computed while
    the ranks run. {n: {"ranks": [...], "jax": {...}, "inputs": {...}}}."""
    tmp = tmp_path_factory.mktemp("seqpar")
    (tmp / "worker.py").write_text(WORKER)
    import jax

    inputs = {n: _inputs(n) for n in WORLDS}
    tree = jax.device_get(_jax_lm("ring").params)
    waits = {}
    for n in WORLDS:
        spec = dict(inputs[n], cases=CASES, lm_modes=LM_MODES,
                    lm=dict(LM, tree=tree, ids=inputs[n]["ids"],
                            y=inputs[n]["y"]))
        (tmp / f"spec{n}.pkl").write_bytes(pickle.dumps(spec))
        argvs = [[sys.executable, str(tmp / "worker.py"), str(r), str(n),
                  str(tmp / f"rdv{n}"), str(tmp / f"spec{n}.pkl"),
                  str(tmp / f"out{n}")] for r in range(n)]
        waits[n] = launch(argvs, str(tmp / f"logs{n}"))
    out = {n: {"inputs": inputs[n], "jax": _jax_refs(n, inputs[n], tree)}
           for n in WORLDS}
    for n in WORLDS:
        waits[n]()
        out[n]["ranks"] = [pickle.loads((tmp / f"out{n}.{r}").read_bytes())
                           for r in range(n)]
    return out


def _ok(rank_out, name):
    got = rank_out[name]
    assert not (isinstance(got, dict) and "error" in got), got["error"]
    return got


def _gathered(res, name):
    """The ranks' shards of each result, concatenated along the
    sequence."""
    per_rank = [_ok(r, name) for r in res["ranks"]]
    return [np.concatenate(parts, axis=1) for parts in zip(*per_rank)]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_attention_matches_jax_shard_map(worlds, n, case):
    got = _gathered(worlds[n], case)
    want = worlds[n]["jax"][case]
    for what, g, w, tol in zip(("out", "dq", "dk", "dv"), got, want,
                               (2e-5, 1e-4, 1e-4, 1e-4)):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g, w, atol=tol, rtol=0,
                                   err_msg=f"{case} {what}")


@pytest.mark.parametrize("n", WORLDS)
def test_causal_flash_ring_backward_is_nan_safe(worlds, n):
    """The twin of ``tests/test_sequence_parallel.py:251``: with logits
    far past exp's range an excluded block's p overflows, and the
    select keeps every gradient finite (and JAX's)."""
    got = _gathered(worlds[n], "nan_safe")
    want = worlds[n]["jax"]["nan_safe"]
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("mode", LM_MODES)
def test_sp_lm_forward_matches_jax(worlds, n, mode):
    got = np.concatenate([_ok(r, "lm_" + mode)["logits"]
                          for r in worlds[n]["ranks"]], axis=1)
    want = worlds[n]["jax"]["lm_" + mode]["logits"]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("mode", LM_MODES)
def test_sp_train_step_sums_replicated_gradients_like_jax(worlds, n, mode):
    """One SP step: each rank's gradients of the replicated weights,
    all-reduced over the axis (``sum_gradients``), equal JAX's
    ``jax.grad`` through ``shard_map`` of the summed local losses; every
    rank holds the same sums."""
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.utils.params_tree import named_leaves

    ranks = [_ok(r, "lm_" + mode) for r in worlds[n]["ranks"]]
    jref = worlds[n]["jax"]["lm_" + mode]
    np.testing.assert_allclose(sum(r["loss"] for r in ranks), jref["loss"],
                               rtol=1e-5)
    fresh = TransformerLM(LM["V"], LM["hidden"], LM["heads"], LM["layers"],
                          LM["max_len"], output="logits", device="cpu")
    by_name = named_leaves(fresh, jref["grads"])
    # the ranks' parameter names carry other instance counters; the
    # order of named_parameters() is the same
    names = [k for k, _ in fresh.named_parameters()]
    want = [by_name[k] for k in names]
    # the key bias's gradient is rounding noise in exact arithmetic:
    # each leaf is measured against at least 1e-3 of the largest one
    floor = 1e-3 * max(np.abs(w).max() for w in want)
    for r in ranks:
        got = list(r["grads"].values())
        assert len(got) == len(want)
        for g, w, k in zip(got, want, names):
            np.testing.assert_allclose(
                g, w, rtol=0, err_msg=k,
                atol=1e-4 * max(np.abs(w).max(), floor))
    for r in ranks[1:]:
        for a, b in zip(r["grads"].values(), ranks[0]["grads"].values()):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", WORLDS)
def test_ranks_import_no_jax_and_resolve_the_axis(worlds, n):
    for r in worlds[n]["ranks"]:
        assert r["modules"] == []
        assert r["axis"] == (("seq",), n)


def test_stripe_roundtrip():
    """The twin of ``tests/test_sequence_parallel.py:364``."""
    import torch

    from bigdl_tpu.parallel.ring_attention import stripe_sequence as jstripe
    from bigdl_tpu_torch.parallel.ring_attention import (
        stripe_sequence, unstripe_sequence,
    )

    x = np.arange(2 * 12 * 3, dtype=np.float32).reshape(2, 12, 3)
    s = stripe_sequence(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(s[:, :3].numpy(), x[:, [0, 4, 8]])
    np.testing.assert_array_equal(s.numpy(), np.asarray(jstripe(x, 4)))
    np.testing.assert_array_equal(unstripe_sequence(s, 4).numpy(), x)


def test_sp_knobs_validate_and_need_a_mesh():
    """JAX's validation, and no fallback: an SP module with no mesh (no
    process group) raises, as a JAX collective does outside
    ``shard_map``."""
    import torch

    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.nn.attention import MultiHeadAttention
    from bigdl_tpu_torch.utils.engine import Engine

    with pytest.raises(ValueError, match="causal-only"):
        MultiHeadAttention(16, 4, causal=False,
                           sequence_parallel="striped_ring")
    with pytest.raises(ValueError, match="no non-flash path"):
        MultiHeadAttention(16, 4, causal=True, use_flash="never",
                           sequence_parallel="striped_ring")
    with pytest.raises(ValueError, match="unknown sequence_parallel"):
        MultiHeadAttention(16, 4, sequence_parallel="tree")
    assert Engine.current_mesh() is None
    lm = TransformerLM(29, 16, 4, 1, 16, sequence_parallel="ring",
                       device="cpu")
    with pytest.raises(RuntimeError, match="unbound"):
        lm(torch.ones(1, 4, dtype=torch.long))
