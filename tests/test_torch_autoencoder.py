"""The port's Autoencoder (``bigdl_tpu_torch/models/autoencoder.py``)
held against the JAX package's on the CPU: the model's forward and one
``Adagrad`` train step on a few synthetic digits from the same weights,
``train_main`` on 64 digits, and every new OptimMethod's state carried
across from JAX through ``load_jax_opt_state``.

Tolerances: the forward within f32 rounding (rtol 1e-5, atol 1e-4 on
outputs near 1); Adagrad's first step is ``lr·g / (|g| + 1e-10)``, about
``±lr``, so its accumulator (g²) is held at rtol 1e-4 of each tensor's
largest (the first layer's gradient sums 0-255 pixels, whose small
entries carry the summation order's cancellation) and the params within
1e-6 wherever JAX's gradient is above 1% of the tensor's largest, within
2·lr elsewhere (a sign there may be the summation order's); the
carried-over states step within rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401


def _digits(n=6):
    from bigdl_tpu_torch.dataset.mnist import load_samples

    return np.stack([s.features[0].reshape(-1) for s in load_samples(
        "/nonexistent", "train", synthetic_count=n)])


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model) with the JAX model's weights."""
    from bigdl_tpu.models.autoencoder import Autoencoder as JAE
    from bigdl_tpu.utils.random_gen import RNG
    from bigdl_tpu_torch.models.autoencoder import Autoencoder
    from bigdl_tpu_torch.utils.params_tree import load_jax_tree

    RNG.set_seed(5)
    jm = JAE(32)
    jm._ensure_params()
    tm = Autoencoder(32, device="cpu")
    load_jax_tree(tm, jax.device_get(jm.params))
    return jm, tm


def test_forward_matches_jax(pair):
    jm, tm = pair
    x = _digits()
    want = np.asarray(jm.apply(jm.params, jnp.asarray(x))[0])
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (6, 784)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_one_adagrad_step_matches_jax(pair):
    from bigdl_tpu.nn import MSECriterion as JMSE
    from bigdl_tpu.optim import Adagrad as JAdagrad
    from bigdl_tpu.optim.train_step import make_train_step as jmake
    from bigdl_tpu_torch.nn import MSECriterion
    from bigdl_tpu_torch.optim import Adagrad
    from bigdl_tpu_torch.optim.train_step import make_train_step
    from bigdl_tpu_torch.utils.params_tree import named_leaves

    jm, tm = pair
    x = _digits()
    jopt = JAdagrad(learning_rate=0.01)
    jp, js, _, jloss = jmake(jm, JMSE(), jopt)(
        jm.params, jopt.init_state(jm.params), jm.state, None,
        jnp.asarray(x), jnp.asarray(x))
    opt = Adagrad(learning_rate=0.01)
    params = {k: p.detach().clone() for k, p in tm.named_parameters()}
    params, state, _, loss = make_train_step(tm, MSECriterion(), opt)(
        params, opt.init_state(params), {}, None, torch.from_numpy(x),
        torch.from_numpy(x))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
    want_p = named_leaves(tm, jax.device_get(jp))
    want_a = named_leaves(tm, jax.device_get(js["accum"]))
    for k, v in params.items():
        acc = state["accum"][k].numpy()
        np.testing.assert_allclose(acc, want_a[k], rtol=1e-4,
                                   atol=1e-4 * want_a[k].max(), err_msg=k)
        clear = np.sqrt(want_a[k]) > 1e-2 * np.sqrt(want_a[k]).max()
        assert clear.mean() > 0.1, k
        np.testing.assert_allclose(v.numpy()[clear], want_p[k][clear],
                                   rtol=0, atol=1e-6, err_msg=k)
        # elsewhere a step may take the other sign: at most 2 lr apart
        np.testing.assert_allclose(v.numpy(), want_p[k], rtol=0,
                                   atol=0.02 + 1e-6, err_msg=k)


def test_train_main_runs_and_lowers_the_loss(tmp_path):
    """64 digits in a batch of 128: the one step's batch holds every
    digit twice, so its logged loss is the start model's MSE on the 64,
    which the trained model must beat."""
    from bigdl_tpu_torch.models.autoencoder import train_main
    from bigdl_tpu_torch.nn import Sigmoid
    from bigdl_tpu_torch.visualization import TrainSummary

    model = train_main(["--synthetic", "64", "--maxEpoch", "1", "--device",
                        "cpu", "--summary", str(tmp_path)])
    ts = TrainSummary(str(tmp_path), "train")
    (_, first), = ts.read_scalar("Loss")
    ts.close()
    assert isinstance(model[4], Sigmoid)
    x = torch.from_numpy(_digits(64))
    with torch.no_grad():
        after = float(((model(x) - x) ** 2).mean())
    assert np.isfinite(first) and after < first


def _methods():
    from bigdl_tpu.optim import optim_method as J
    from bigdl_tpu_torch.optim import optim_method as T

    return {"Adagrad": (J.Adagrad(0.01), T.Adagrad(0.01)),
            "Adadelta": (J.Adadelta(), T.Adadelta()),
            "Adamax": (J.Adamax(), T.Adamax()),
            "RMSprop": (J.RMSprop(), T.RMSprop()),
            "Ftrl": (J.Ftrl(0.05, l1_regularization_strength=0.01),
                     T.Ftrl(0.05, l1_regularization_strength=0.01)),
            "LarsSGD": (J.LarsSGD(0.1, weight_decay=0.01),
                        T.LarsSGD(0.1, weight_decay=0.01))}


@pytest.mark.parametrize("name", sorted(_methods()))
def test_jax_opt_state_round_trip(pair, name):
    """A JAX state after two steps, loaded with ``load_jax_opt_state``,
    takes the third step as JAX's does: params and every slot."""
    from bigdl_tpu_torch.optim.optim_method import load_jax_opt_state
    from bigdl_tpu_torch.utils.params_tree import named_leaves

    jm, tm = pair
    jmeth, tmeth = _methods()[name]
    rng = np.random.default_rng(4)
    params = jax.device_get(jm.params)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32),
        params) for _ in range(3)]
    state = jmeth.init_state(params)
    for g in grads[:2]:
        params, state = jmeth.update(g, state, params)
    p3, s3 = jmeth.update(grads[2], state, params)
    tstate = load_jax_opt_state(tm, jax.device_get(state))
    assert tstate["neval"] == 2 and set(tstate) == set(state)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in
               named_leaves(tm, jax.device_get(params)).items()}
    tgrads = {k: torch.from_numpy(v) for k, v in
              named_leaves(tm, grads[2]).items()}
    tparams, tstate = tmeth.update(tgrads, tstate, tparams)
    want = named_leaves(tm, jax.device_get(p3))
    for k, v in tparams.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name} {k}")
    for slot, tree in jax.device_get(s3).items():
        if slot == "neval":
            assert tstate["neval"] == int(tree) == 3
            continue
        for k, v in named_leaves(tm, tree).items():
            np.testing.assert_allclose(tstate[slot][k].numpy(), v, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name} {slot}")
