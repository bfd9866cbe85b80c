from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,
                       ImageRecordDataset, ImageFolderDataset)
from . import transforms
