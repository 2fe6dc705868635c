"""The port's tensor, pipeline and expert parallelism and
``Engine.hybrid_mesh`` (``bigdl_tpu_torch/parallel/tensor_parallel.py``,
``pipeline.py``, ``moe.py``, ``utils/engine.py``) over gloo ranks on the
CPU, held against JAX's ``shard_map`` on a mesh of the same size, the
twin of ``tests/test_parallel_extensions.py``.

One launch per world size (2 and 4) of the worker below (the launcher of
``tests/test_torch_distri_optimizer.py``); each rank builds the mesh a
case names (``Engine.mesh(("model",))``, ``("pipe",)``, ``("expert",)``,
then ``Engine.hybrid_mesh``), takes the slice of the unsplit weights
that JAX's ``in_specs`` would hand its device, and returns its results.

Tolerances (f32 on both sides, sums in other orders): forwards 1e-5
absolute (the MLP's 1e-4, as its JAX twin; attention's, whose outputs
reach 90 from unscaled random weights, 1e-5 of the largest), gradients
1e-4 absolute, the hybrid mesh's loss 1e-5 relative.
"""

import pickle
import sys

import numpy as np
import pytest

from tests.test_torch_distri_optimizer import launch
from tests.torch_parity import one_torch_thread  # noqa: F401

WORLDS = (2, 4)

WORKER = r'''
import pickle
import sys
import traceback

import numpy as np
import torch

torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
rdv, spec_path, out_path = sys.argv[3], sys.argv[4], sys.argv[5]

from bigdl_tpu_torch.parallel import (
    column_parallel_linear, gpipe, microbatch, mlp_expert, moe_layer,
    row_parallel_linear, stack_stage_params, tp_attention, tp_mlp,
)
from bigdl_tpu_torch.parallel.axis import axis, psum
from bigdl_tpu_torch.utils.engine import Engine

Engine.init_distributed(coordinator_address="file://" + rdv,
                        num_processes=world, process_id=rank, device="cpu",
                        timeout_s=60)
s = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
     for k, v in pickle.load(open(spec_path, "rb")).items()}
out = {}


def rows(a):       # P(axis, None): this rank's rows
    n = a.shape[0] // world
    return a[rank * n:(rank + 1) * n].contiguous()


def cols(a):       # P(None, axis): this rank's columns of the last dim
    n = a.shape[-1] // world
    return a[..., rank * n:(rank + 1) * n].contiguous()


def case(name):
    def wrap(fn):
        try:
            out[name] = fn()
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return wrap


def np_(*ts):
    return [t.detach().numpy() for t in ts]


Engine.mesh(("model",))


@case("column")
def _():
    y = column_parallel_linear(s["x"], rows(s["w"]), rows(s["b"]), "model")
    g = column_parallel_linear(s["x"], rows(s["w"]), rows(s["b"]), "model",
                               gather_output=True)
    return np_(y, g)


@case("row")
def _():
    return np_(row_parallel_linear(cols(s["x2"]), cols(s["w2"]), s["b2"],
                                   "model"),
               row_parallel_linear(cols(s["x2"]), cols(s["w2"]), s["b2"],
                                   "model", accum_dtype=torch.float64))


@case("mlp")
def _():
    x = s["mx"].clone().requires_grad_()
    w1, b1, w2 = (t.clone().requires_grad_()
                  for t in (rows(s["w1"]), rows(s["b1"]), cols(s["w2m"])))
    y = tp_mlp(x, w1, b1, w2, s["b2m"], "model")
    (y * s["mo"]).sum().backward()
    return np_(y, x.grad, w1.grad, b1.grad, w2.grad)


for causal in (False, True):
    @case(f"attention_{causal}")
    def _():
        hl = s["heads"] // world
        return np_(tp_attention(s["ax"], rows(s["wq"]), rows(s["wk"]),
                                rows(s["wv"]), cols(s["wo"]), "model",
                                n_heads_local=hl, causal=causal,
                                bo=s["bo"]))

Engine.mesh(("pipe",))


@case("gpipe")
def _():
    stacked = stack_stage_params([{"w": s["pw"][i], "b": s["pb"][i]}
                                  for i in range(world)])
    mine = {k: v[rank:rank + 1].clone().requires_grad_()
            for k, v in stacked.items()}

    def stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    o = gpipe(stage, mine, microbatch(s["px"], s["n_micro"]), "pipe")
    (o ** 2).sum().backward()
    return np_(o, mine["w"].grad[0], mine["b"].grad[0])

Engine.mesh(("expert",))

for top_k in (1, 2):
    @case(f"moe_{top_k}")
    def _():
        t = s["ex"].shape[0] // world
        x = s["ex"][rank * t:(rank + 1) * t].clone().requires_grad_()
        router = s["router"].clone().requires_grad_()
        e = s["ew1"].shape[0] // world
        ep = {k: s["e" + k][rank * e:(rank + 1) * e].clone().requires_grad_()
              for k in ("w1", "b1", "w2", "b2")}
        y = moe_layer(x, router, ep, mlp_expert, "expert", top_k=top_k,
                      capacity=t)
        (y * s["eo"][rank * t:(rank + 1) * t]).sum().backward()
        g = router.grad.clone()
        torch.distributed.all_reduce(g, group=axis("expert").group)
        return np_(y, x.grad, g, *(ep[k].grad for k in ("w1", "b1", "w2",
                                                          "b2")))


@case("hybrid")
def _():
    dcn = 2 if world % 2 == 0 else 1
    mesh = Engine.hybrid_mesh(("data", "model"), (1, world // dcn),
                              num_slices=dcn)
    w, x = s["hw"], s["hx"]
    model = axis("model")
    data_rows = x.shape[0] // (mesh.shape[0] * mesh.shape[1])
    b = (mesh.get_local_rank("dcn") * mesh.shape[1]
         + mesh.get_local_rank("data"))
    nm = w.shape[0] // model.size
    xl = x[b * data_rows:(b + 1) * data_rows,
           model.index * nm:(model.index + 1) * nm]
    wl = w[model.index * nm:(model.index + 1) * nm]
    loss = (psum(xl @ wl, model) ** 2).mean()
    for name in ("data", "dcn"):
        ax = axis(name)
        torch.distributed.all_reduce(loss, group=ax.group)
        loss = loss / ax.size
    return {"shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
            "loss": float(loss)}


out["modules"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "bigdl_tpu"))
pickle.dump(out, open(f"{out_path}.{rank}", "wb"))
Engine.shutdown()
'''


def _spec(n):
    rs = np.random.RandomState(20 + n)
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    heads = 8
    return dict(
        x=f(4, 12), w=f(16, 12), b=f(16),                       # column
        x2=f(4, 16), w2=f(12, 16), b2=f(12),                    # row
        mx=f(4, 12), w1=f(32, 12), b1=f(32), w2m=f(12, 32), b2m=f(12),
        mo=f(4, 12),                                            # tp_mlp
        heads=heads, ax=f(2, 6, 32), wq=f(32, 32), wk=f(32, 32),
        wv=f(32, 32), wo=f(32, 32), bo=f(32),                   # attention
        pw=f(n, 6, 6) * 0.5, pb=f(n, 6) * 0.1, px=f(8, 6),
        n_micro=4,                                              # gpipe
        ex=f(6 * n, 4), router=f(4, 8), ew1=f(8, 4, 8) * 0.5,
        eb1=f(8, 8) * 0.1, ew2=f(8, 8, 4) * 0.5, eb2=f(8, 4) * 0.1,
        eo=f(6 * n, 4),                                         # moe
        hw=f(8, 8), hx=f(8, 8))                                 # hybrid


def _jax_refs(n, s):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as P

    from bigdl_tpu.parallel import (
        column_parallel_linear, gpipe, microbatch, mlp_expert, moe_layer,
        row_parallel_linear, stack_stage_params, tp_attention, tp_mlp,
    )
    from bigdl_tpu.utils.compat import shard_map
    from bigdl_tpu.utils.engine import Engine as JEngine

    def mesh(name):
        return Mesh(np.asarray(jax.devices()[:n]), (name,))

    out = {}
    m = mesh("model")
    col = jax.jit(shard_map(
        lambda x, w, b: column_parallel_linear(x, w, b, "model"), mesh=m,
        in_specs=(P(), P("model", None), P("model")),
        out_specs=P(None, "model")))
    out["column"] = np.asarray(col(s["x"], s["w"], s["b"]))
    out["row"] = np.asarray(jax.jit(shard_map(
        lambda x, w, b: row_parallel_linear(x, w, b, "model"), mesh=m,
        in_specs=(P(None, "model"), P(None, "model"), P()),
        out_specs=P()))(s["x2"], s["w2"], s["b2"]))

    def mlp_loss(x, w1, b1, w2):
        y = shard_map(lambda x, w1, b1, w2: tp_mlp(x, w1, b1, w2, s["b2m"],
                                                   "model"),
                      mesh=m, in_specs=(P(), P("model", None), P("model"),
                                        P(None, "model")),
                      out_specs=P())(x, w1, b1, w2)
        return jnp.sum(y * s["mo"]), y

    (_, y), g = jax.jit(jax.value_and_grad(mlp_loss, argnums=(0, 1, 2, 3),
                                           has_aux=True))(
        s["mx"], s["w1"], s["b1"], s["w2m"])
    out["mlp"] = [np.asarray(y)] + [np.asarray(t) for t in g]
    for causal in (False, True):
        out[f"attention_{causal}"] = np.asarray(jax.jit(shard_map(
            lambda x, wq, wk, wv, wo, bo: tp_attention(
                x, wq, wk, wv, wo, "model", n_heads_local=s["heads"] // n,
                causal=causal, bo=bo),
            mesh=m, in_specs=(P(), P("model", None), P("model", None),
                              P("model", None), P(None, "model"), P()),
            out_specs=P()))(s["ax"], s["wq"], s["wk"], s["wv"], s["wo"],
                            s["bo"]))

    stacked = stack_stage_params([{"w": s["pw"][i], "b": s["pb"][i]}
                                  for i in range(n)])

    def stage(p, x):
        return jnp.tanh(jnp.matmul(x, p["w"]) + p["b"])

    def pipe_loss(p, xm):
        o = shard_map(lambda p, xm: gpipe(stage, p, xm, "pipe"),
                      mesh=mesh("pipe"), in_specs=(P("pipe"), P()),
                      out_specs=P())(p, xm)
        return jnp.sum(o ** 2), o

    (_, o), g = jax.jit(jax.value_and_grad(pipe_loss, has_aux=True))(
        stacked, microbatch(s["px"], s["n_micro"]))
    out["gpipe"] = [np.asarray(o), np.asarray(g["w"]), np.asarray(g["b"])]

    t_loc = s["ex"].shape[0] // n
    for top_k in (1, 2):
        def moe_loss(x, router, ep, top_k=top_k):
            y = shard_map(
                lambda x, r, ep: moe_layer(x, r, ep, mlp_expert, "expert",
                                           top_k=top_k, capacity=t_loc),
                mesh=mesh("expert"),
                in_specs=(P("expert"), P(), P("expert")),
                out_specs=P("expert"))(x, router, ep)
            return jnp.sum(y * s["eo"]), y

        ep = {k: s["e" + k] for k in ("w1", "b1", "w2", "b2")}
        (_, y), g = jax.jit(jax.value_and_grad(
            moe_loss, argnums=(0, 1, 2), has_aux=True))(
            s["ex"], s["router"], ep)
        out[f"moe_{top_k}"] = [np.asarray(y), np.asarray(g[0]),
                               np.asarray(g[1])] + [
            np.asarray(g[2][k]) for k in ("w1", "b1", "w2", "b2")]

    dcn = 2
    hmesh = JEngine.hybrid_mesh(ici_axis_names=("data", "model"),
                                ici_axis_sizes=(1, n // dcn),
                                num_slices=dcn,
                                devices=jax.devices()[:n])

    def spmd(w, x):
        y = lax.psum(jnp.matmul(x, w), "model")
        return lax.pmean(lax.pmean(jnp.mean(y ** 2), "data"), "dcn")

    out["hybrid"] = {
        "shape": tuple(hmesh.devices.shape),
        "loss": float(jax.jit(shard_map(
            spmd, mesh=hmesh, in_specs=(P("model", None),
                                        P(("dcn", "data"), "model")),
            out_specs=P()))(s["hw"], s["hx"]))}
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parext")
    (tmp / "worker.py").write_text(WORKER)
    specs = {n: _spec(n) for n in WORLDS}
    waits = {}
    for n in WORLDS:
        (tmp / f"spec{n}.pkl").write_bytes(pickle.dumps(specs[n]))
        argvs = [[sys.executable, str(tmp / "worker.py"), str(r), str(n),
                  str(tmp / f"rdv{n}"), str(tmp / f"spec{n}.pkl"),
                  str(tmp / f"out{n}")] for r in range(n)]
        waits[n] = launch(argvs, str(tmp / f"logs{n}"))
    out = {n: {"jax": _jax_refs(n, specs[n]), "spec": specs[n]}
           for n in WORLDS}
    for n in WORLDS:
        waits[n]()
        out[n]["ranks"] = [pickle.loads((tmp / f"out{n}.{r}").read_bytes())
                           for r in range(n)]
    return out


def _ok(r, name):
    got = r[name]
    assert not (isinstance(got, dict) and "error" in got), got["error"]
    return got


def _all(res, name):
    return [_ok(r, name) for r in res["ranks"]]


@pytest.mark.parametrize("n", WORLDS)
def test_column_parallel_linear(worlds, n):
    got = _all(worlds[n], "column")
    want = worlds[n]["jax"]["column"]
    np.testing.assert_allclose(np.concatenate([g[0] for g in got], -1),
                               want, atol=1e-5, rtol=0)
    for g in got:                         # gather_output: the full (..., out)
        np.testing.assert_allclose(g[1], want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", WORLDS)
def test_row_parallel_linear(worlds, n):
    want = worlds[n]["jax"]["row"]
    for plain, acc in _all(worlds[n], "row"):
        np.testing.assert_allclose(plain, want, atol=1e-5, rtol=0)
        assert acc.dtype == np.float32      # one rounding after the sum
        np.testing.assert_allclose(acc, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", WORLDS)
def test_tp_mlp_forward_and_gradients(worlds, n):
    """The replicated input's gradient is all-reduced on every rank (what
    shard_map's transpose sums); each weight shard gets its slice."""
    y, dx, dw1, db1, dw2 = worlds[n]["jax"]["mlp"]
    got = _all(worlds[n], "mlp")
    for g in got:
        np.testing.assert_allclose(g[0], y, atol=1e-4, rtol=0)
        np.testing.assert_allclose(g[1], dx, atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.concatenate([g[2] for g in got]), dw1,
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.concatenate([g[3] for g in got]), db1,
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.concatenate([g[4] for g in got], -1), dw2,
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("causal", [False, True])
def test_tp_attention(worlds, n, causal):
    want = worlds[n]["jax"][f"attention_{causal}"]
    for g in _all(worlds[n], f"attention_{causal}"):
        np.testing.assert_allclose(g[0], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n", WORLDS)
def test_gpipe_forward_and_gradients(worlds, n):
    o, gw, gb = worlds[n]["jax"]["gpipe"]
    got = _all(worlds[n], "gpipe")
    for g in got:                         # every rank holds the outputs
        np.testing.assert_allclose(g[0], o, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.stack([g[1] for g in got]), gw, atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(np.stack([g[2] for g in got]), gb, atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_layer(worlds, n, top_k):
    """Forward and gradients: the tokens' (this rank's slice), the
    replicated router's (summed over the axis) and the experts' (this
    rank's experts)."""
    want = worlds[n]["jax"][f"moe_{top_k}"]
    got = _all(worlds[n], f"moe_{top_k}")
    for i, what in ((0, "y"), (1, "dx")):
        np.testing.assert_allclose(np.concatenate([g[i] for g in got]),
                                   want[i], atol=1e-4, rtol=0, err_msg=what)
    for g in got:
        np.testing.assert_allclose(g[2], want[2], atol=1e-4, rtol=0)
    for i in range(3, 7):
        np.testing.assert_allclose(np.concatenate([g[i] for g in got]),
                                   want[i], atol=1e-4, rtol=0)


@pytest.mark.parametrize("n", WORLDS)
def test_hybrid_mesh_step(worlds, n):
    """The twin of ``tests/test_parallel_extensions.py:252``: 2 slices x
    (1 data x n/2 model): the model psum inside a slice, the loss averaged
    over data and dcn."""
    want = worlds[n]["jax"]["hybrid"]
    for g in _all(worlds[n], "hybrid"):
        assert g["shape"] == want["shape"] == (2, 1, n // 2)
        assert g["names"] == ("dcn", "data", "model")
        np.testing.assert_allclose(g["loss"], want["loss"], rtol=1e-5)


@pytest.mark.parametrize("n", WORLDS)
def test_ranks_import_no_jax(worlds, n):
    for r in worlds[n]["ranks"]:
        assert r["modules"] == []


def test_top_k_gating_matches_jax():
    """Capacity drops in token order and the renormalized gates, on one
    device (no collective)."""
    import jax.numpy as jnp
    import torch

    from bigdl_tpu.parallel.moe import top_k_gating as jgate
    from bigdl_tpu_torch.parallel.moe import top_k_gating

    logits = np.random.RandomState(1).randn(16, 4).astype(np.float32)
    for k, cap in ((1, 3), (2, 5), (2, 16)):
        want = jgate(jnp.asarray(logits), k, cap)
        got = top_k_gating(torch.from_numpy(logits), k, cap)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=0)


def test_stack_stage_params_and_microbatch():
    import torch

    from bigdl_tpu_torch.parallel import microbatch, stack_stage_params

    st = stack_stage_params([{"w": np.ones((2, 2)) * i, "b": np.zeros(2)}
                             for i in range(3)])
    assert tuple(st["w"].shape) == (3, 2, 2) and float(st["w"][2, 0, 0]) == 2
    assert tuple(microbatch(torch.zeros(8, 3), 4).shape) == (4, 2, 3)
