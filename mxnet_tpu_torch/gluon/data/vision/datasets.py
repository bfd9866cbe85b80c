"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``; ref:
python/mxnet/gluon/data/vision/datasets.py).

Nothing is downloaded: datasets read standard files from `root` if
present (idx-format MNIST, CIFAR binary batches), otherwise the JAX
package's deterministic synthetic data with the right shapes and classes
(the same draws from the same seeds). Samples are host NDArrays; the
DataLoader moves batches to their device.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as onp

from ..dataset import Dataset
from ....context import cpu as _cpu
from ....ndarray.ndarray import array as _array


def array(a):
    return _array(a, _cpu())


class _DownloadableDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(array(self._data[idx]), self._label[idx])
        return array(self._data[idx]), self._label[idx]

    def __len__(self):
        return len(self._label)


def _synthetic(n, shape, num_classes, seed):
    rng = onp.random.RandomState(seed)
    data = (rng.rand(n, *shape) * 255).astype(onp.uint8)
    label = rng.randint(0, num_classes, n).astype(onp.int32)
    return data, label


class MNIST(_DownloadableDataset):
    """MNIST; reads idx files from root if available (ref: datasets.py MNIST)."""

    _train_files = ('train-images-idx3-ubyte', 'train-labels-idx1-ubyte')
    _test_files = ('t10k-images-idx3-ubyte', 't10k-labels-idx1-ubyte')
    _synth_n = 1024

    def __init__(self, root=os.path.join('~', '.mxnet', 'datasets', 'mnist'),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _read_idx(self, path):
        opener = gzip.open if path.endswith('.gz') else open
        with opener(path, 'rb') as f:
            magic = struct.unpack('>HBB', f.read(4))
            dims = struct.unpack('>' + 'I' * magic[2], f.read(4 * magic[2]))
            return onp.frombuffer(f.read(), dtype=onp.uint8).reshape(dims)

    def _get_data(self):
        files = self._train_files if self._train else self._test_files
        img_path = None
        for suffix in ('', '.gz'):
            cand = os.path.join(self._root, files[0] + suffix)
            if os.path.exists(cand):
                img_path = cand
                lab_path = os.path.join(self._root, files[1] + suffix)
                break
        if img_path:
            data = self._read_idx(img_path)
            label = self._read_idx(lab_path)
            self._data = data.reshape(-1, 28, 28, 1)
            self._label = label.astype(onp.int32)
        else:
            self._data, self._label = _synthetic(
                self._synth_n, (28, 28, 1), 10, 42 if self._train else 43)


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join('~', '.mxnet', 'datasets',
                                         'fashion-mnist'),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadableDataset):
    """CIFAR-10 from binary batches (ref: datasets.py CIFAR10)."""

    _synth_n = 1024

    def __init__(self, root=os.path.join('~', '.mxnet', 'datasets', 'cifar10'),
                 train=True, transform=None):
        self._num_classes = 10
        super().__init__(root, train, transform)

    def _read_batch(self, filename):
        with open(filename, 'rb') as fin:
            raw = onp.frombuffer(fin.read(), dtype=onp.uint8)
        row = 3072 + self._label_bytes()
        data = raw.reshape(-1, row)
        label = data[:, self._label_bytes() - 1].astype(onp.int32)
        img = data[:, self._label_bytes():].reshape(-1, 3, 32, 32)
        return img.transpose(0, 2, 3, 1), label

    def _label_bytes(self):
        return 1

    def _get_data(self):
        if self._train:
            files = [f'data_batch_{i}.bin' for i in range(1, 6)]
        else:
            files = ['test_batch.bin']
        paths = [os.path.join(self._root, f) for f in files]
        if all(os.path.exists(p) for p in paths):
            data, label = zip(*(self._read_batch(p) for p in paths))
            self._data = onp.concatenate(data)
            self._label = onp.concatenate(label)
        else:
            self._data, self._label = _synthetic(
                self._synth_n, (32, 32, 3), self._num_classes,
                44 if self._train else 45)


class CIFAR100(CIFAR10):
    def __init__(self, root=os.path.join('~', '.mxnet', 'datasets', 'cifar100'),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        self._num_classes = 100
        _DownloadableDataset.__init__(self, root, train, transform)

    def _label_bytes(self):
        return 2

    def _get_data(self):
        files = ['train.bin'] if self._train else ['test.bin']
        paths = [os.path.join(self._root, f) for f in files]
        if all(os.path.exists(p) for p in paths):
            data, label = zip(*(self._read_batch(p) for p in paths))
            self._data = onp.concatenate(data)
            self._label = onp.concatenate(label)
        else:
            self._data, self._label = _synthetic(
                self._synth_n, (32, 32, 3), 100, 46 if self._train else 47)


class ImageRecordDataset(Dataset):
    """Dataset over a RecordIO of packed images (ref: datasets.py
    ImageRecordDataset)."""

    def __init__(self, filename, flag=1, transform=None):
        from .... import recordio
        self._transform = transform
        self._flag = flag
        idx_file = os.path.splitext(filename)[0] + '.idx'
        self._record = recordio.MXIndexedRecordIO(idx_file, filename, 'r')

    def __getitem__(self, idx):
        from .... import recordio
        record = self._record.read_idx(self._record.keys[idx])
        header, img = recordio.unpack_img(record)
        label = header.label
        if self._transform is not None:
            return self._transform(array(img), label)
        return array(img), label

    def __len__(self):
        return len(self._record.keys)


class ImageFolderDataset(Dataset):
    """Images arranged in class folders (ref: datasets.py ImageFolderDataset)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = ['.jpg', '.jpeg', '.png']
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
        from PIL import Image
        img = onp.asarray(Image.open(self.items[idx][0]).convert(
            'RGB' if self._flag else 'L'))
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(array(img), label)
        return array(img), label

    def __len__(self):
        return len(self.items)
