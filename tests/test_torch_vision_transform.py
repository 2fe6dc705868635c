"""The port's vision pipeline (``bigdl_tpu_torch/transform/vision/
image.py``) and ``Module.predict_image`` against the JAX package's on the
same numpy-seeded mats, on the CPU.

Tolerances, with their reasons:

* every ``FeatureTransformer``, ``Pipeline``, ``LocalImageFrame.transform``
  (per-feature ``RandomState(seed * 1_000_003 + i)``), ``MatToTensor``,
  ``ImageFrameToSample`` and ``ImageFrame.read`` / ``array``: bitwise (the
  same draws and numpy expressions; ``read`` decodes with the port's
  decoder, held bitwise to PIL on these PNG, BMP and PIL-written JPEG
  files);
* ``predict_image`` against JAX's on a LeNet-5 holding JAX's weights:
  1e-5 absolute, the tolerance of the port's Predictor twin
  (``tests/test_torch_native_pipeline.py``: f32 forwards summed in other
  orders); on a multi-output graph, within the JAX test's 1e-5 relative
  and 1e-6 absolute of one ``predict`` over all rows (the CPU's GEMM
  sums a batch of 2 and one of 5 in other orders).
"""

import os

import jax
import numpy as np
import pytest
from PIL import Image
from tests.torch_parity import one_torch_thread  # noqa: F401

import bigdl_tpu.transform.vision.image as jv
import bigdl_tpu_torch.transform.vision.image as tv


def _mat(h=13, w=17, seed=0):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(
        np.float32)


OPS = [
    ("Resize", (9, 11), {}), ("Resize", (26, 5), {}),
    ("AspectScale", (8,), {}), ("AspectScale", (40,), dict(max_size=50)),
    ("CenterCrop", (10, 6), {}), ("RandomCrop", (10, 6), {}),
    ("HFlip", (), {}), ("HFlip", (), dict(p=0.5)),
    ("Expand", (), {}), ("Expand", (3.0, (1.0, 2.0, 3.0)), {}),
    ("Brightness", (), {}), ("Contrast", (0.2, 0.9), {}),
    ("Saturation", (), {}), ("Hue", (), {}), ("ChannelOrder", (), {}),
    ("ChannelNormalize", (120.0, 110.0, 100.0, 60.0, 61.0, 62.0), {}),
]


def _apply(mod, name, args, kw, seed):
    feat = mod.ImageFeature(_mat(seed=seed), label=3, uri="u")
    rng = np.random.RandomState(seed)
    op = getattr(mod, name)(*args, **kw)
    out = op.apply_feature(feat, rng)
    return out, rng.rand()          # the draws each op took, compared too


@pytest.mark.parametrize("name,args,kw", OPS,
                         ids=[f"{n}{i}" for i, (n, _, _) in enumerate(OPS)])
def test_feature_transformers_are_bitwise_jax(name, args, kw):
    for seed in range(4):
        (want, wr), (got, gr) = (_apply(jv, name, args, kw, seed),
                                 _apply(tv, name, args, kw, seed))
        assert got.mat().dtype == want.mat().dtype == np.float32
        np.testing.assert_array_equal(got.mat(), want.mat())
        assert gr == wr and got["label"] == want["label"] == 3


def _pipeline(mod, means):
    return (mod.Resize(20, 24) >> mod.RandomTransformer(mod.HFlip(), 0.5)
            >> mod.RandomCrop(16, 16) >> mod.Brightness()
            >> mod.RandomTransformer(mod.Hue(), 0.5)
            >> mod.PixelNormalizer(means) >> mod.MatToTensor()
            >> mod.ImageFrameToSample())


def test_frames_pipelines_and_samples_are_bitwise_jax():
    mats = [_mat(15 + i, 19 - i, seed=i) for i in range(6)]
    means = np.random.RandomState(9).rand(16, 16, 3).astype(np.float32)
    out = {}
    for name, mod in (("jax", jv), ("port", tv)):
        frame = mod.ImageFrame.array(mats, labels=[1, 2, 3, 1, 2, 3], seed=5)
        assert len(frame) == 6
        out[name] = frame.transform(_pipeline(mod, means))
    for a, b in zip(out["port"].get_sample(), out["jax"].get_sample()):
        np.testing.assert_array_equal(a.feature(), b.feature())
        np.testing.assert_array_equal(a.label(), b.label())
        assert a.feature().shape == (3, 16, 16)
    for a, b in zip(out["port"].get_image(), out["jax"].get_image()):
        np.testing.assert_array_equal(a, b)
    assert out["port"].get_label() == out["jax"].get_label()
    # two inputs, no target
    t = tv.ImageFeature(_mat(), label=None)
    t["floats"], t["extra"] = np.ones((3, 2, 2)), np.zeros(4)
    s = tv.ImageFrameToSample(("floats", "extra"), None).apply_feature(
        t, None)["sample"]
    assert [f.shape for f in s.features] == [(3, 2, 2), (4,)]


@pytest.fixture(scope="module")
def picture_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("pictures")
    rng = np.random.RandomState(1)
    os.makedirs(root / "sub")
    for i, (name, kw) in enumerate([("a.png", {}), ("b.jpg", {"quality": 85}),
                                    ("c.bmp", {}),
                                    (os.path.join("sub", "d.jpeg"), {})]):
        Image.fromarray(rng.randint(0, 256, (11 + i, 14, 3)).astype(
            np.uint8)).save(root / name, **kw)
    (root / "notes.txt").write_text("skipped: not an image extension")
    return str(root)


def test_image_frame_read_is_bitwise_jax(picture_dir):
    want = jv.ImageFrame.read(picture_dir, seed=2)
    got = tv.ImageFrame.read(picture_dir, seed=2)
    assert [f["uri"] for f in got.features] == \
        [f["uri"] for f in want.features]
    assert len(got) == 4 and got.seed == 2
    for a, b in zip(got.get_image(), want.get_image()):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    one = os.path.join(picture_dir, "b.jpg")
    np.testing.assert_array_equal(tv.ImageFrame.read(one).get_image()[0],
                                  jv.ImageFrame.read(one).get_image()[0])


def _lenet_pair(seed=4):
    from bigdl_tpu.models import LeNet5 as JLeNet5
    from bigdl_tpu.utils.random_gen import RNG
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.utils.params_tree import load_jax_tree

    RNG.set_seed(seed)
    jm = JLeNet5(10)
    jm._ensure_params()
    tm = LeNet5(10, device="cpu")
    load_jax_tree(tm, jax.device_get(jm.params))
    return jm, tm


def test_predict_image_matches_jax():
    jm, tm = _lenet_pair()
    rs = np.random.RandomState(0)
    mats = [rs.rand(28, 28, 1).astype(np.float32) for _ in range(5)]
    jf = jv.ImageFrame.array(mats).transform(jv.MatToTensor())
    tf = tv.ImageFrame.array(mats).transform(tv.MatToTensor())
    assert jm.predict_image(jf, batch_per_partition=2) is jf
    assert tm.predict_image(tf, batch_per_partition=2) is tf
    for a, b in zip(tf.features, jf.features):
        assert a["predict"].shape == (10,)
        np.testing.assert_allclose(a["predict"], np.asarray(b["predict"]),
                                   rtol=0, atol=1e-5)
    tm.predict_image(tf, share_buffer=True)
    with pytest.raises(NotImplementedError):
        tm.predict_image(tf, output_layer="conv1")
    with pytest.raises(ValueError, match="MatToTensor"):
        tm.predict_image(tv.ImageFrame.array(mats))


def test_predict_image_on_a_multi_output_graph():
    import torch

    from bigdl_tpu_torch.nn import Graph, Input, Linear, Reshape

    torch.manual_seed(5)
    inp = Input()
    flat = Reshape([12], batch_mode=True).inputs(inp)
    model = Graph(inp, [Linear(12, 3, device="cpu").inputs(flat),
                        Linear(12, 2, device="cpu").inputs(flat)])
    mats = [np.random.RandomState(1).rand(2, 2, 3).astype(np.float32)
            for _ in range(5)]
    frame = tv.ImageFrame.array(mats).transform(tv.MatToTensor())
    model.predict_image(frame, batch_per_partition=2)
    want = model.predict(np.stack([f["floats"] for f in frame.features]))
    for j, f in enumerate(frame.features):
        assert [p.shape for p in f["predict"]] == [(3,), (2,)]
        for p, w in zip(f["predict"], want):      # batches of 2 against 5
            np.testing.assert_allclose(p, w[j], rtol=1e-5, atol=1e-6)
