"""CIFAR-10 / CIFAR-100 from the standard python pickle files on disk
(``cifar-10-batches-py`` / ``cifar-100-python``), the port's own copy of
the JAX package's ``data/cifar.py``: nothing is downloaded, and the same
files give the same arrays.  ``iterate_cifar`` yields the ImageFolder
loader's batch layout."""

from __future__ import annotations

import os
import pickle
from typing import Iterator, Sequence

import numpy as np


class CIFAR:
    """images uint8 [N, 32, 32, 3]; labels int32 [N]."""

    def __init__(self, root: str, train: bool = True,
                 variant: str = "cifar100"):
        if variant == "cifar100":
            d = os.path.join(root, "cifar-100-python")
            files = ["train"] if train else ["test"]
            label_key = b"fine_labels"
        elif variant == "cifar10":
            d = os.path.join(root, "cifar-10-batches-py")
            files = ([f"data_batch_{i}" for i in range(1, 6)] if train
                     else ["test_batch"])
            label_key = b"labels"
        else:
            raise ValueError(f"unknown CIFAR variant: {variant}")
        imgs, labels = [], []
        for fn in files:
            path = os.path.join(d, fn)
            if not os.path.exists(path):
                raise FileNotFoundError(path)
            with open(path, "rb") as f:
                batch = pickle.load(f, encoding="bytes")
            imgs.append(batch[b"data"].reshape(-1, 3, 32, 32).transpose(
                0, 2, 3, 1))
            labels.extend(batch[label_key])
        self.images = np.concatenate(imgs).astype(np.uint8)
        self.labels = np.asarray(labels, np.int32)
        self.num_classes = 100 if variant == "cifar100" else 10

    def __len__(self) -> int:
        return len(self.labels)


def iterate_cifar(ds: CIFAR, indices: Sequence[int], batch_size: int,
                  drop_last: bool = True) -> Iterator[dict]:
    indices = np.asarray(indices)
    n = (len(indices) // batch_size if drop_last
         else -(-len(indices) // batch_size))
    for bi in range(n):
        idx = indices[bi * batch_size:(bi + 1) * batch_size]
        yield {"image": ds.images[idx], "label": ds.labels[idx]}
