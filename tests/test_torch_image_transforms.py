"""The port's image transformers, transformer chaining and image-folder
loader (``bigdl_tpu_torch/dataset/image.py``, ``transformer.py``,
``dataset.py``) against the JAX package's on the same numpy-seeded
inputs, on the CPU.

Tolerance: bitwise everywhere. Each random transformer draws from its
own ``np.random.RandomState(seed)`` in JAX's order and computes the same
numpy expressions; the folder loader decodes with the port's decoder,
which the decode tests hold bitwise to PIL on these files (PNG, and
JPEGs PIL wrote), then the same ``/ 255`` and numpy resize.
"""

import os

import numpy as np
import pytest
from PIL import Image
from tests.torch_parity import one_torch_thread  # noqa: F401

import bigdl_tpu.dataset.image as jimg
import bigdl_tpu.dataset.transformer as jtr
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.sample import Sample as JSample
import bigdl_tpu_torch.dataset.image as timg
import bigdl_tpu_torch.dataset.transformer as ttr
from bigdl_tpu_torch.dataset import DataSet as TDataSet
from bigdl_tpu_torch.dataset import Sample as TSample


def _samples(n=6, c=3, h=20, w=17, seed=0, cls=TSample):
    rng = np.random.RandomState(seed)
    return [cls(rng.rand(c, h, w).astype(np.float32) * 255,
                np.float32(i % 3 + 1)) for i in range(n)]


def _same(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.feature().dtype == b.feature().dtype
        np.testing.assert_array_equal(a.feature(), b.feature())
        np.testing.assert_array_equal(a.label(), b.label())


TRANSFORMERS = [
    ("BGRImgCropper", dict(crop_width=12, crop_height=9, seed=3)),
    ("BGRImgCropper", dict(crop_width=12, crop_height=9,
                           crop_method="center")),
    ("HFlip", dict(threshold=0.5, seed=4)),
    ("ColorJitter", dict(seed=5)),
    ("ColorJitter", dict(brightness=0.1, contrast=0.8, saturation=0.0,
                         seed=6)),
    ("Lighting", dict(alphastd=0.3, seed=7)),
    ("RandomResizedCrop", dict(size=11, seed=8)),
    ("RandomResizedCrop", dict(size=24, min_area=0.9, seed=9)),
    ("BGRImgNormalizer", dict(means=(1.0, 2.0, 3.0), stds=(4.0, 5.0, 6.0))),
    ("GreyImgNormalizer", dict(mean=3.0, std=7.0)),
]


@pytest.mark.parametrize("name,kw", TRANSFORMERS,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(TRANSFORMERS)])
def test_transformers_are_bitwise_jax(name, kw):
    c = 1 if name == "GreyImgNormalizer" else 3
    want = getattr(jimg, name)(**kw)(_samples(c=c, cls=JSample))
    got = getattr(timg, name)(**kw)(_samples(c=c))
    _same(got, want)


@pytest.mark.parametrize("shape,out", [((3, 20, 17), (7, 11)),
                                       ((1, 5, 9), (16, 16)),
                                       ((3, 8, 8), (8, 8)),
                                       ((2, 33, 1), (4, 3))])
def test_resize_bilinear_is_bitwise_jax(shape, out):
    img = np.random.RandomState(1).rand(*shape).astype(np.float32)
    got, want = timg.resize_bilinear(img, *out), jimg.resize_bilinear(img,
                                                                      *out)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_chains_fn_identity_and_batching_match_jax():
    def chain(mod, img_mod, cls):
        t = img_mod.HFlip(seed=2) >> mod.FnTransformer(
            lambda s: cls(s.feature() * 2, s.labels[0]))
        t = t.and_then(mod.Identity()) >> img_mod.BGRImgCropper(8, 8, seed=1)
        return t >> mod.SampleToBatch(4, drop_remainder=False)

    want = list(chain(jtr, jimg, JSample)(_samples(cls=JSample)))
    got = list(chain(ttr, timg, TSample)(_samples()))
    assert isinstance(chain(ttr, timg, TSample), ttr.ChainedTransformer)
    assert [b.size() for b in got] == [b.size() for b in want] == [4, 2]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.input, b.input)
        np.testing.assert_array_equal(a.target, b.target)
    # a dataset's transformer chain, shuffled stream: JAX's order
    jds = JDataSet.array(_samples(cls=JSample), seed=3) >> jimg.HFlip(seed=1)
    tds = TDataSet.array(_samples(), seed=3) >> timg.HFlip(seed=1)
    jit, tit = jds.data(train=True), tds.data(train=True)
    _same([next(tit) for _ in range(9)], [next(jit) for _ in range(9)])


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    """Three classes of PNG and JPEG files at odd sizes (one grey, one
    palette), written by PIL."""
    root = tmp_path_factory.mktemp("folder")
    rng = np.random.RandomState(0)
    for ci, cls in enumerate(["cat", "dog", "eel"]):
        os.makedirs(root / cls)
        for i in range(3):
            h, w = 20 + 7 * i, 31 - 5 * ci
            rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            im = Image.fromarray(rgb)
            if i == 0:
                im.save(root / cls / f"{i}.png")
            elif i == 1:
                (im.convert("L") if ci == 1 else im).save(
                    root / cls / f"{i}.jpg", quality=90)
            else:
                im.quantize(30).save(root / cls / f"{i}.png")
    (root / "not_a_class.txt").write_text("ignored: not a directory")
    return str(root)


@pytest.mark.parametrize("size", [16, 9])
def test_image_folder_samples_are_bitwise_jax(image_folder, size):
    want = jimg.image_folder_samples(image_folder, image_size=size)
    got = timg.image_folder_samples(image_folder, image_size=size)
    assert [float(s.label()) for s in got] == [1.0] * 3 + [2.0] * 3 + \
        [3.0] * 3
    assert got[0].feature().shape == (3, size, size)
    _same(got, want)
    ds = TDataSet.image_folder(image_folder, image_size=size)
    assert ds.size() == 9
    _same(ds.data(train=False), want)


def test_image_folder_names_the_file_it_cannot_read(tmp_path):
    os.makedirs(tmp_path / "a")
    (tmp_path / "a" / "x.gif").write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="x.gif: GIF"):
        timg.image_folder_samples(str(tmp_path))
