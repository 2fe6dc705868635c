"""The port's ``tensor/sparse.py`` (``SparseTensor`` and its products) and
``nn/sparse.py`` (``SparseLinear``, ``SparseJoinTable``,
``LookupTableSparse``) held against the JAX package's on the CPU, the
twin of ``tests/test_sparse.py`` and ``tests/test_layers_more.py:537``.

Both sides get the same numpy-seeded dense matrices, made sparse by the
same ``from_dense`` (whose indices, values and padding must be equal
exactly). The port's products are a gather and an ``index_add`` where
JAX's are a gather and ``segment_sum``: the summation order differs, so
products and their gradients are held within 1e-6 of JAX's relative to
the result's largest magnitude; the layers (a dense weight, batch rows of
up to 12 entries) within 1e-5, output, weight and bias gradients. Index
manipulations (transpose, narrow, join, ``astype``) are compared
exactly, through ``to_dense`` and the COO triple. Duplicate indices
accumulate, and padding slots add exactly zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import max_rel_err, one_torch_thread  # noqa: F401


def _random_sparse(rs, b, d, density=0.3):
    dense = rs.standard_normal((b, d)).astype(np.float32)
    dense *= (rs.uniform(size=(b, d)) < density)
    return dense


def _pair(dense, capacity=None):
    from bigdl_tpu.tensor.sparse import SparseTensor as JS
    from bigdl_tpu_torch.tensor.sparse import SparseTensor as TS

    return (JS.from_dense(dense, capacity),
            TS.from_dense(torch.from_numpy(dense), capacity))


def _same_triple(t, j):
    assert t.shape == j.shape
    assert np.array_equal(t.indices.numpy(), np.asarray(j.indices))
    assert np.array_equal(t.values.numpy(), np.asarray(j.values))


@pytest.mark.parametrize("capacity", [None, 10, 60])
def test_from_dense_matches_jax(capacity):
    """Indices, values, padding, ``nnz``/``capacity``/``dim``/``size`` and
    ``to_dense``; ``coo`` from (nnz, ndim) coordinates."""
    from bigdl_tpu_torch.tensor.sparse import SparseTensor

    dense = _random_sparse(np.random.default_rng(0), 5, 7)
    if capacity == 10:
        dense[:, 3:] = 0.0                  # nnz must fit the capacity
    j, t = _pair(dense, capacity)
    _same_triple(t, j)
    assert (t.nnz(), t.capacity(), t.dim(), t.size(), t.size(2)) == (
        j.nnz(), j.capacity(), j.dim(), j.size(), j.size(2))
    assert np.array_equal(t.to_dense().numpy(), dense)
    coords = np.argwhere(dense)
    c = SparseTensor.coo(coords, dense[dense != 0], dense.shape)
    assert np.array_equal(c.to_dense().numpy(), dense)
    with pytest.raises(ValueError, match="capacity"):
        SparseTensor.from_dense(torch.from_numpy(dense), 2)


def _algebra():
    """name → (function of (sparse, operands...), operand arrays, exact)."""
    from bigdl_tpu.tensor import sparse as js
    from bigdl_tpu_torch.tensor import sparse as ts

    rs = np.random.default_rng(11)
    m = rs.standard_normal((7, 3)).astype(np.float32)
    v = rs.standard_normal(7).astype(np.float32)
    c = rs.standard_normal((5, 3)).astype(np.float32)
    y = rs.standard_normal(5).astype(np.float32)
    n = rs.standard_normal((4, 5)).astype(np.float32)
    other = rs.standard_normal((5, 7)).astype(np.float32)

    def both(f):
        return lambda mod: lambda sp, *a: f(mod, sp, *a)

    return {
        "t": (both(lambda mod, sp: sp.t().to_dense()), [], True),
        "mul": (both(lambda mod, sp: sp.mul(2.5).to_dense()), [], True),
        "div": (both(lambda mod, sp: sp.div(2.0).to_dense()), [], True),
        "astype": (both(lambda mod, sp: sp.astype(
            np.float16 if mod is js else torch.float16).to_dense()), [],
            True),
        "sum": (both(lambda mod, sp: sp.sum()), [], False),
        "sum_dim1": (both(lambda mod, sp: sp.sum(1)), [], False),
        "sum_dim2": (both(lambda mod, sp: sp.sum(2)), [], False),
        "narrow_dim1": (both(lambda mod, sp: sp.narrow(1, 2, 3).to_dense()),
                        [], True),
        "narrow_dim2": (both(lambda mod, sp: sp.narrow(2, 3, 4).to_dense()),
                        [], True),
        "cmul_dense": (both(lambda mod, sp, o: sp.cmul_dense(o).to_dense()),
                       [other], True),
        "vdot": (both(lambda mod, sp, o: sp.vdot(o)), [other], False),
        "mm": (both(lambda mod, sp, a: sp.mm(a)), [m], False),
        "mv": (both(lambda mod, sp, a: sp.mv(a)), [v], False),
        "sparse_dense_matmul": (both(
            lambda mod, sp, a: mod.sparse_dense_matmul(sp, a)), [m], False),
        "sparse_addmm": (both(lambda mod, sp, a, b: mod.sparse_addmm(
            0.5, b, 2.0, sp, a)), [m, c], False),
        "sparse_addmv": (both(lambda mod, sp, a, b: mod.sparse_addmv(
            0.5, b, 2.0, sp, a)), [v, y], False),
        "dense_sparse_matmul": (both(
            lambda mod, sp, a: mod.dense_sparse_matmul(a, sp)), [n], False),
        "add_to_dense": (both(lambda mod, sp, o: sp.add_to_dense(o)),
                         [other], False),
    }, js, ts


ALGEBRA = sorted(_algebra()[0])


@pytest.mark.parametrize("name", ALGEBRA)
def test_sparse_algebra_matches_jax(name):
    """The SparseTensorMath surface of ``tests/test_sparse.py:88`` on a
    (5, 7) matrix with 60% zeros at capacity 32, against JAX's."""
    table, js, ts = _algebra()
    f, operands, exact = table[name]
    rs = np.random.RandomState(11)
    dense = rs.randn(5, 7).astype(np.float32)
    dense[rs.rand(5, 7) < 0.6] = 0.0
    j, t = _pair(dense, 32)
    want = np.asarray(f(js)(j, *map(jnp.asarray, operands)))
    got = f(ts)(t, *map(torch.from_numpy, operands)).numpy()
    assert got.shape == want.shape
    if exact:
        assert np.array_equal(got, want), name
    else:
        assert max_rel_err(got, want) <= 1e-6, name


@pytest.mark.parametrize("dim", [1, 2])
def test_sparse_join_matches_jax(dim):
    """``sparse_join`` along the batch and the feature dim: the COO triple
    (padding slots stay at index 0) and the dense form."""
    from bigdl_tpu.tensor.sparse import sparse_join as jjoin
    from bigdl_tpu_torch.tensor.sparse import sparse_join as tjoin

    rs = np.random.default_rng(3)
    shapes = [(3, 4), (3, 6)] if dim == 2 else [(2, 5), (4, 5)]
    pairs = [_pair(_random_sparse(rs, *s), 20) for s in shapes]
    want = jjoin([p[0] for p in pairs], dim)
    got = tjoin([p[1] for p in pairs], dim)
    _same_triple(got, want)
    assert np.array_equal(got.to_dense().numpy(),
                          np.asarray(want.to_dense()))


def test_product_gradients_match_jax():
    """The gradients of ``sparse_dense_matmul`` with respect to the values
    and the dense operand, as JAX's autodiff gives them."""
    from bigdl_tpu.tensor.sparse import SparseTensor as JS
    from bigdl_tpu.tensor.sparse import sparse_dense_matmul as jmm
    from bigdl_tpu_torch.tensor.sparse import SparseTensor as TS
    from bigdl_tpu_torch.tensor.sparse import sparse_dense_matmul as tmm

    rs = np.random.default_rng(4)
    j, _ = _pair(_random_sparse(rs, 6, 9), 40)
    w = rs.standard_normal((9, 4)).astype(np.float32)
    ct = rs.standard_normal((6, 4)).astype(np.float32)
    _, pull = jax.vjp(lambda v, d: jmm(JS(j.indices, v, j.shape), d),
                      j.values, jnp.asarray(w))
    gv_want, gw_want = pull(jnp.asarray(ct))
    vals = torch.from_numpy(np.array(j.values)).requires_grad_()
    dense = torch.from_numpy(w).requires_grad_()
    out = tmm(TS(np.asarray(j.indices), vals, j.shape), dense)
    gv, gw = torch.autograd.grad(out, [vals, dense], torch.from_numpy(ct))
    assert max_rel_err(gv.numpy(), gv_want) <= 1e-6
    assert max_rel_err(gw.numpy(), gw_want) <= 1e-6


def test_duplicates_accumulate_and_padding_adds_zero():
    """Two entries at one (row, col) add up in every product, as in
    JAX's; the same entries with 30 padding slots give the same result
    bit for bit."""
    from bigdl_tpu.tensor.sparse import SparseTensor as JS
    from bigdl_tpu.tensor.sparse import sparse_dense_matmul as jmm
    from bigdl_tpu_torch.tensor.sparse import SparseTensor as TS
    from bigdl_tpu_torch.tensor.sparse import sparse_dense_matmul as tmm

    idx = np.int32([[0, 0, 2, 1, 0], [1, 1, 3, 0, 2]])
    vals = np.float32([1.5, -0.25, 2.0, 3.0, 0.5])
    w = np.random.default_rng(5).standard_normal((4, 3)).astype(np.float32)
    j, t = JS(idx, vals, (3, 4)), TS(idx, vals, (3, 4))
    dense = np.zeros((3, 4), np.float32)
    np.add.at(dense, tuple(idx), vals)
    assert np.array_equal(t.to_dense().numpy(), np.asarray(j.to_dense()))
    assert np.allclose(t.to_dense().numpy(), dense)
    got = tmm(t, torch.from_numpy(w)).numpy()
    assert max_rel_err(got, np.asarray(jmm(j, jnp.asarray(w)))) <= 1e-6
    padded = TS(np.concatenate([idx, np.zeros((2, 30), np.int32)], 1),
                np.concatenate([vals, np.zeros(30, np.float32)]), (3, 4))
    assert np.array_equal(tmm(padded, torch.from_numpy(w)).numpy(), got)


def _layer_cases():
    """name → (JAX layer, port layer, input): a (JAX, port) pair of
    SparseTensors, or a list of such pairs for a table."""
    import bigdl_tpu.nn as J
    import bigdl_tpu_torch.nn as T

    rs = np.random.default_rng(6)
    dense = _random_sparse(rs, 4, 12)
    a, b = _random_sparse(rs, 3, 4), _random_sparse(rs, 3, 6)
    ids = np.float32([[1, 3, 0], [2, 0, 0], [0, 0, 0], [5, 5, 4]])
    w_ids = np.float32([[2.0, 1.0, 0], [1.0, 0, 0], [0, 0, 0],
                        [0.5, 1.5, 3.0]])
    sp, sp_ids, sp_w = _pair(dense, 64), _pair(ids, 12), _pair(w_ids, 12)
    out = {
        "SparseLinear": (J.SparseLinear(12, 5), T.SparseLinear(12, 5), sp),
        "SparseLinear_no_bias": (J.SparseLinear(12, 3, with_bias=False),
                                 T.SparseLinear(12, 3, with_bias=False), sp),
        "SparseJoinTable": (J.SparseJoinTable(2), T.SparseJoinTable(2),
                            [_pair(a, 20), _pair(b, 20)]),
        "SparseJoinTable_dim1": (J.SparseJoinTable(1), T.SparseJoinTable(1),
                                 [_pair(a, 20), _pair(b[:, :4].copy(), 20)]),
    }
    for comb in ("sum", "mean", "sqrtn"):
        out[f"LookupTableSparse_{comb}"] = (
            J.LookupTableSparse(5, 4, comb), T.LookupTableSparse(5, 4, comb),
            sp_ids)
        out[f"LookupTableSparse_{comb}_weighted"] = (
            J.LookupTableSparse(5, 4, comb), T.LookupTableSparse(5, 4, comb),
            [sp_ids, sp_w])
    return out


LAYERS = sorted(_layer_cases())


@pytest.mark.parametrize("name", LAYERS)
def test_sparse_layer_matches_jax(name):
    """Each sparse layer from JAX's params (``numpy_trees``): the output
    (a SparseTensor's triple exactly for the join) and, for the layers
    with weights, every parameter's gradient for one numpy cotangent."""
    from bigdl_tpu_torch.utils.params_tree import load_jax_tree, named_leaves
    from tests.torch_parity import numpy_trees

    jl, tl, x = _layer_cases()[name]
    table = isinstance(x, list)
    jx = [p[0] for p in x] if table else x[0]
    tx = [p[1] for p in x] if table else x[1]
    params, _ = numpy_trees(jl, 8)
    if name.startswith("SparseJoinTable"):
        want = jl.apply(params, jx, {})[0]
        _same_triple(tl(tx), want)
        return
    load_jax_tree(tl, params)
    want, pull = jax.vjp(lambda p: jl.apply(p, jx, {})[0], params)
    ct = np.random.default_rng(9).standard_normal(want.shape).astype(
        np.float32)
    (gp_want,) = pull(jnp.asarray(ct))
    out = tl(tx)
    assert max_rel_err(out.detach().numpy(), want) <= 1e-5, name
    named = dict(tl.named_parameters())
    grads = torch.autograd.grad(out, list(named.values()),
                                torch.from_numpy(ct))
    by_name = named_leaves(tl, jax.device_get(gp_want))
    for (k, _), g in zip(named.items(), grads):
        assert max_rel_err(g.numpy(), by_name[k]) <= 1e-5, f"{name}.{k}"


def test_sparse_linear_equals_dense_linear():
    """``SparseLinear`` on a sparse batch equals ``Linear`` on its dense
    form with the same weights (``tests/test_sparse.py:34``)."""
    from bigdl_tpu_torch.nn import Linear, SparseLinear
    from bigdl_tpu_torch.tensor.sparse import SparseTensor

    dense = _random_sparse(np.random.default_rng(10), 4, 12)
    g = torch.Generator().manual_seed(0)
    sl = SparseLinear(12, 5, generator=g)
    dl = Linear(12, 5)
    dl.load_state_dict(sl.state_dict())
    got = sl(SparseTensor.from_dense(torch.from_numpy(dense), 64))
    want = dl(torch.from_numpy(dense))
    assert max_rel_err(got.detach().numpy(), want.detach().numpy()) <= 1e-6
