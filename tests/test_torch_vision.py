"""The port's image functions, augmenters, ``ImageIter`` and vision
datasets and transforms against the JAX package's.

Both run on the host in numpy, the random ones from numpy's global
generator, so each case seeds it the same before each package's run and
the results must agree: the iterator's batches bitwise; each augmenter
and transform within rtol 1e-5 and atol 1e-4, so exactly where the
result is an integer type (crops, flips, resizes of uint8), and within
f32 rounding for the float jitters (the same formulas; a matrix product
may sum in another order); a whole `CreateAugmenter` chain, which
normalises after the jitters, within atol 1e-3.
Datasets: MNIST / CIFAR10 / CIFAR100's seeded synthetic data (no files
here) item by item, ImageFolderDataset over PNGs written here,
ImageRecordDataset over a .rec written here.
"""
import warnings

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import image as ref_image
from mxnet_tpu import recordio as ref_rio
from mxnet_tpu.gluon.data import vision as ref_vision
from mxnet_tpu_torch import image
from mxnet_tpu_torch.gluon.data import vision

PIL = pytest.importorskip("PIL.Image")

torch.set_num_threads(1)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.numpy()
    return onp.asarray(a.asnumpy() if hasattr(a, "asnumpy") else a)


def _img(h=20, w=28, seed=0):
    return onp.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                 dtype=onp.uint8)


def _both(fn_mine, fn_theirs, seed=7):
    onp.random.seed(seed)
    got = fn_mine()
    onp.random.seed(seed)
    want = fn_theirs()
    return _np(got), _np(want)


AUGS = [("ResizeAug", (12,)), ("ForceResizeAug", ((10, 14),)),
        ("RandomCropAug", ((10, 12),)), ("CenterCropAug", ((10, 12),)),
        ("RandomSizedCropAug", ((9, 9),)), ("HorizontalFlipAug", (0.9,)),
        ("BrightnessJitterAug", (0.4,)), ("ContrastJitterAug", (0.4,)),
        ("SaturationJitterAug", (0.4,)), ("HueJitterAug", (0.3,)),
        ("LightingAug", (0.1, ref_image.PCA_EIGVAL, ref_image.PCA_EIGVEC)),
        ("ColorNormalizeAug", ((120.0, 110.0, 100.0), (50.0, 55.0, 60.0))),
        ("RandomGrayAug", (0.9,)), ("CastAug", ()),
        ("ColorJitterAug", (0.3, 0.3, 0.3))]


@pytest.mark.parametrize("name,args", AUGS, ids=[a[0] for a in AUGS])
def test_augmenters_equal_the_references(name, args):
    x = _img()
    for seed in (1, 2, 3):
        got, want = _both(lambda: getattr(image, name)(*args)(x),
                          lambda: getattr(ref_image, name)(*args)(x), seed)
        assert got.shape == want.shape and got.dtype == want.dtype
        onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_array_functions_equal_the_references():
    x = _img(17, 23)
    for fn, args in (("imresize", (11, 7)), ("resize_short", (9,)),
                     ("fixed_crop", (2, 3, 10, 8)),
                     ("fixed_crop", (2, 3, 10, 8, (5, 6)))):
        got, want = _both(lambda: getattr(image, fn)(x, *args),
                          lambda: getattr(ref_image, fn)(x, *args))
        onp.testing.assert_array_equal(got, want)
    for fn in ("center_crop", "random_crop"):
        onp.random.seed(4)
        g, gbox = getattr(image, fn)(x, (8, 6))
        onp.random.seed(4)
        w, wbox = getattr(ref_image, fn)(x, (8, 6))
        assert gbox == wbox
        onp.testing.assert_array_equal(_np(g), _np(w))
    onp.testing.assert_allclose(
        _np(image.color_normalize(x, 100.0, 50.0)),
        _np(ref_image.color_normalize(mx.np.array(x), 100.0, 50.0)),
        rtol=1e-6)


def test_create_augmenter_lists_equal_the_references():
    x = _img(40, 44)
    kw = dict(resize=36, rand_crop=True, rand_mirror=True, mean=True,
              std=True, brightness=0.2, contrast=0.2, saturation=0.2,
              hue=0.1, pca_noise=0.1, rand_gray=0.2)
    mine = image.CreateAugmenter((3, 24, 24), **kw)
    theirs = ref_image.CreateAugmenter((3, 24, 24), **kw)
    assert [type(a).__name__ for a in mine] == \
        [type(a).__name__ for a in theirs]
    assert [a.dumps() for a in mine] == [a.dumps() for a in theirs]

    def run(augs):
        img = x
        for a in augs:
            img = a(img)
        return img
    got, want = _both(lambda: run(mine), lambda: run(theirs))
    onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    d = tmp_path_factory.mktemp("vision")
    path = str(d / "imgs.rec")
    w = ref_rio.MXIndexedRecordIO(str(d / "imgs.idx"), path, "w")
    for i in range(10):
        w.write_idx(i, ref_rio.pack_img(ref_rio.IRHeader(0, float(i % 4), i,
                                                         0),
                                        _img(30, 26, seed=i), quality=90))
    w.close()
    return path


@pytest.mark.parametrize("kw", [dict(), dict(shuffle=True, seed=3),
                                dict(num_parts=2, part_index=1),
                                dict(last_batch_handle="discard")])
def test_imageiter_equals_the_reference(rec, kw):
    aug = dict(rand_crop=True, rand_mirror=True)
    runs = []
    for pkg in (image, ref_image):
        onp.random.seed(9)
        it = pkg.ImageIter(4, (3, 16, 16), path_imgrec=rec,
                           aug_list=pkg.CreateAugmenter((3, 16, 16), **aug),
                           **kw)
        out = []
        for _ in range(2):
            for b in it:
                out.append((_np(b.data[0]), _np(b.label[0]), b.pad))
            it.reset()
        runs.append(out)
    assert len(runs[0]) == len(runs[1]) > 0
    for (d1, l1, p1), (d2, l2, p2) in zip(*runs):
        assert p1 == p2
        onp.testing.assert_array_equal(d1, d2)
        onp.testing.assert_array_equal(l1, l2)


TRANSFORMS = [("ToTensor", ()), ("Normalize", ((0.5, 0.4, 0.3),
                                               (0.2, 0.3, 0.4))),
              ("Resize", (12,)), ("Resize", (12, True)),
              ("CenterCrop", (10,)), ("RandomCrop", (10, 2)),
              ("RandomResizedCrop", (9,)), ("RandomFlipLeftRight", ()),
              ("RandomFlipTopBottom", ()), ("RandomBrightness", (0.3,)),
              ("RandomContrast", (0.3,)), ("RandomSaturation", (0.3,)),
              ("RandomHue", (0.2,)), ("RandomColorJitter", (0.2, 0.2, 0.2,
                                                            0.1)),
              ("RandomLighting", (0.1,)), ("RandomGray", (0.7,)),
              ("Cast", ("float16",))]


@pytest.mark.parametrize("name,args", TRANSFORMS,
                         ids=[f"{a[0]}{i}" for i, a in enumerate(TRANSFORMS)])
def test_transforms_equal_the_references(name, args):
    x = _img()
    if name == "Normalize":
        x = x.transpose(2, 0, 1).astype(onp.float32) / 255
    mine = getattr(vision.transforms, name)(*args)
    theirs = getattr(ref_vision.transforms, name)(*args)
    for seed in (1, 2, 3):
        got, want = _both(lambda: mine(torch.from_numpy(x)),
                          lambda: theirs(x), seed)
        assert got.shape == want.shape and got.dtype == want.dtype
        onp.testing.assert_allclose(got.astype(onp.float64),
                                    want.astype(onp.float64), rtol=1e-5,
                                    atol=1e-4)
    comp = vision.transforms.Compose([vision.transforms.CenterCrop(8),
                                      vision.transforms.ToTensor()])
    assert comp(x if name != "Normalize" else _img(), 3)[1] == 3


def test_synthetic_datasets_equal_the_references():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, kw in (("MNIST", dict(train=False)),
                         ("CIFAR10", dict(train=False)),
                         ("CIFAR100", dict(train=False, fine_label=True))):
            root = "/nonexistent-dataset-root"
            mine = getattr(vision, name)(root=root, **kw)
            theirs = getattr(ref_vision, name)(root=root, **kw)
            assert len(mine) == len(theirs)
            for i in (0, 1, len(mine) - 1):
                (a, la), (b, lb) = mine[i], theirs[i]
                onp.testing.assert_array_equal(_np(a), _np(b))
                assert la == lb


def test_folder_and_record_datasets_equal_the_references(tmp_path, rec):
    for c, cls in enumerate(("cat", "dog")):
        (tmp_path / cls).mkdir()
        for i in range(2):
            PIL.fromarray(_img(9, 7, seed=10 * c + i)).save(
                tmp_path / cls / f"{i}.png")
    (tmp_path / "notes.txt").write_text("not a class folder")
    mine = vision.ImageFolderDataset(str(tmp_path))
    theirs = ref_vision.ImageFolderDataset(str(tmp_path))
    assert mine.synsets == theirs.synsets == ["cat", "dog"]
    for i in range(len(mine)):
        onp.testing.assert_array_equal(_np(mine[i][0]), _np(theirs[i][0]))
        assert mine[i][1] == theirs[i][1]
    mine = vision.ImageRecordDataset(rec)
    theirs = ref_vision.ImageRecordDataset(rec)
    assert len(mine) == len(theirs) == 10
    for i in (0, 9):
        onp.testing.assert_array_equal(_np(mine[i][0]), _np(theirs[i][0]))
        assert mine[i][1] == theirs[i][1]


def test_image_io_equals_the_references(tmp_path):
    x = _img()
    PIL.fromarray(x).save(tmp_path / "a.png")
    onp.testing.assert_array_equal(
        image.imread(str(tmp_path / "a.png")).numpy(),
        _np(ref_image.imread(str(tmp_path / "a.png"))))
    gray = image.imdecode(image.imencode(x, ".png"), flag=0)
    onp.testing.assert_array_equal(
        gray.numpy(), _np(ref_image.imdecode(ref_image.imencode(x, ".png"),
                                             flag=0)))
    assert gray.shape == (20, 28, 1)
    bgr = image.imdecode(image.imencode(x, ".png"), to_rgb=False)
    onp.testing.assert_array_equal(bgr.numpy(), x[:, :, ::-1])
