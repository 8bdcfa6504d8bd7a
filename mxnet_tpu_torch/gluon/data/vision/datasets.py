"""Vision datasets (counterpart of
`mxnet_tpu/gluon/data/vision/datasets.py`): MNIST, FashionMNIST,
CIFAR10/100, ImageFolderDataset and ImageRecordDataset.  Nothing is
downloaded: each of the first four reads its files under ``root`` when
they are there, and otherwise makes, with a warning, the reference's
seeded synthetic data of the real shapes and class counts (the same
arrays as the reference's).  Items are host numpy arrays (decoded images
host tensors) and labels.
"""
from __future__ import annotations

import gzip
import os
import struct
import warnings

import numpy as onp

from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._transform = transform
        self._train = train
        self._root = os.path.expanduser(root)
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):  # pragma: no cover - abstract
        raise NotImplementedError


def _synthetic(n, shape, num_classes, seed):
    rng = onp.random.RandomState(seed)
    data = rng.randint(0, 256, size=(n,) + shape).astype(onp.uint8)
    label = rng.randint(0, num_classes, size=(n,)).astype(onp.int32)
    return data, label


class MNIST(_DownloadedDataset):
    """28×28×1, 10 classes, 60k train / 10k test."""

    _n_train, _n_test = 60000, 10000
    _shape = (28, 28, 1)
    _classes = 10

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._files = {
            True: ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
            False: ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"),
        }
        super().__init__(root, train, transform)

    def _get_data(self):
        img_file, lbl_file = self._files[self._train]
        img_path = os.path.join(self._root, img_file)
        lbl_path = os.path.join(self._root, lbl_file)
        if os.path.exists(img_path) and os.path.exists(lbl_path):
            with gzip.open(lbl_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                label = onp.frombuffer(f.read(), dtype=onp.uint8).astype(onp.int32)
            with gzip.open(img_path, "rb") as f:
                _, num, rows, cols = struct.unpack(">IIII", f.read(16))
                data = onp.frombuffer(f.read(), dtype=onp.uint8).reshape(
                    num, rows, cols, 1)
        else:
            warnings.warn(
                f"{type(self).__name__}: files not found under {self._root} "
                "and no network egress; using deterministic synthetic data "
                "with the real shapes.")
            n = self._n_train if self._train else self._n_test
            data, label = _synthetic(n, self._shape, self._classes,
                                     seed=42 if self._train else 43)
        self._data = data
        self._label = label


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """32×32×3, 10 classes, 50k train / 10k test."""

    _n_train, _n_test = 50000, 10000
    _shape = (32, 32, 3)
    _classes = 10

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _read_batch(self, filename):
        raw = onp.fromfile(filename, dtype=onp.uint8).reshape(-1, 3073)
        return raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            raw[:, 0].astype(onp.int32)

    def _get_data(self):
        if self._train:
            files = [os.path.join(self._root, f"data_batch_{i}.bin")
                     for i in range(1, 6)]
        else:
            files = [os.path.join(self._root, "test_batch.bin")]
        if all(os.path.exists(f) for f in files):
            parts = [self._read_batch(f) for f in files]
            self._data = onp.concatenate([p[0] for p in parts])
            self._label = onp.concatenate([p[1] for p in parts])
        else:
            warnings.warn(
                f"{type(self).__name__}: files not found under {self._root}; "
                "using deterministic synthetic data with the real shapes.")
            n = self._n_train if self._train else self._n_test
            self._data, self._label = _synthetic(
                n, self._shape, self._classes, seed=44 if self._train else 45)


class CIFAR100(CIFAR10):
    _classes = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform)

    def _get_data(self):
        fname = os.path.join(self._root, "train.bin" if self._train
                             else "test.bin")
        if os.path.exists(fname):
            raw = onp.fromfile(fname, dtype=onp.uint8).reshape(-1, 3074)
            self._data = raw[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            self._label = raw[:, 1 if self._fine_label else 0].astype(onp.int32)
        else:
            warnings.warn(
                f"CIFAR100: files not found under {self._root}; using "
                "deterministic synthetic data with the real shapes.")
            n = self._n_train if self._train else self._n_test
            classes = 100 if self._fine_label else 20
            self._data, self._label = _synthetic(
                n, self._shape, classes, seed=46 if self._train else 47)


class ImageFolderDataset(Dataset):
    """A dataset of images in per-class folders (reference datasets.py)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png", ".bmp"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from ....image import imread
        img = imread(self.items[idx][0], flag=self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)


class ImageRecordDataset(Dataset):
    """Dataset over a packed ImageRecord file (reference
    `gluon/data/vision/datasets.py` ImageRecordDataset over im2rec output):
    each record is `pack_img` framed (IRHeader + encoded image), read through
    the native recordio core when built."""

    def __init__(self, filename, flag=1, transform=None):
        from ...data.dataset import RecordFileDataset
        self._base = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __len__(self):
        return len(self._base)

    def __getitem__(self, idx):
        from ....recordio import unpack_img
        record = self._base[idx]
        header, img = unpack_img(record, self._flag)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


__all__.append("ImageRecordDataset")
