"""ImageFolder dataset and the threaded host loader, the port's own copy of
the JAX package's ``data/imagefolder.py``: the same files, indices and
seed give the same uint8 batches, bit for bit.

The layout is torchvision's ImageFolder (one subdirectory a class, classes
in sorted order).  The host decodes and crops each image to a static
[size, size, 3] uint8 array; the trainer does the rest on the device
(normalisation, flip, random erasing, Mixup / CutMix).  Two decoders:

  * ``"native"``: the C++ libjpeg loader (``data/native``), bilinear,
    taken when it builds here, every file is a JPEG and the recipe is
    bilinear;
  * ``"pil"``: PIL (imported when a batch is decoded), bilinear or bicubic.

Every batch names the decoder that made it (``batch["decoder"]``).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from mrla_tpu_torch.data import native
from mrla_tpu_torch.data.transforms import (
    eval_transform_params,
    random_resized_crop_params,
)

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _pil_resample(interpolation: str):
    from PIL import Image

    try:
        return {"bilinear": Image.BILINEAR,
                "bicubic": Image.BICUBIC}[interpolation]
    except KeyError:
        raise ValueError(f"unknown interpolation {interpolation!r}") from None


class ImageFolder:
    """``root/<class>/<image>``; class indices in sorted name order."""

    def __init__(self, root: str):
        self.root = root
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise FileNotFoundError(f"no class directories under {root}")
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: list[tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append((os.path.join(cdir, fn),
                                         self.class_to_idx[c]))
        if not self.samples:
            raise FileNotFoundError(f"no images under {root}")

    def __len__(self) -> int:
        return len(self.samples)

    def load_train(self, idx: int, size: int, rng: np.random.Generator,
                   interpolation: str = "bilinear") -> np.ndarray:
        """RandomResizedCrop geometry drawn from ``rng`` -> [size, size, 3]
        uint8.  'bilinear' is the torchvision ResNet recipe's resampling,
        'bicubic' timm's (the DeiT recipe's)."""
        from PIL import Image

        resample = _pil_resample(interpolation)
        with Image.open(self.samples[idx][0]) as im:
            im = im.convert("RGB")
            w, h = im.size
            top, left, ch, cw = random_resized_crop_params(rng, h, w)
            im = im.resize((size, size), resample,
                           box=(left, top, left + cw, top + ch))
            return np.asarray(im, np.uint8)

    def load_eval(self, idx: int, size: int,
                  interpolation: str = "bilinear") -> np.ndarray:
        """Resize the shorter side to size / 0.875, centre crop ->
        [size, size, 3] uint8."""
        from PIL import Image

        resample = _pil_resample(interpolation)
        with Image.open(self.samples[idx][0]) as im:
            im = im.convert("RGB")
            w, h = im.size
            rh, rw, top, left, c = eval_transform_params(h, w, size)
            im = im.resize((rw, rh), resample)
            im = im.crop((left, top, left + c, top + c))
            return np.asarray(im, np.uint8)


def choose_decoder(dataset: ImageFolder, interpolation: str) -> str:
    """"native" where the C++ loader builds, every file is a JPEG and the
    resampling is bilinear, else "pil"."""
    if interpolation == "bilinear" and all(
            p.lower().endswith((".jpg", ".jpeg")) for p, _ in dataset.samples
    ) and native.available():
        return "native"
    return "pil"


def iterate_batches(dataset: ImageFolder, indices: Sequence[int],
                    batch_size: int, size: int = 224, train: bool = True,
                    seed: int = 0, num_threads: int = 8,
                    drop_last: Optional[bool] = None,
                    interpolation: str = "bilinear") -> Iterator[dict]:
    """Batches {"image": uint8 [B, S, S, 3], "label": int32 [B], "decoder":
    "native" or "pil"} in order, each made whole by one of ``num_threads``
    threads (batch i by thread i mod num_threads) and handed over through a
    bounded queue; a thread's error is raised here, at its batch.  A train
    batch's crops come from ``np.random.default_rng((seed, i))`` (PIL) or
    the seed ``seed * 1_000_003 + i`` (native).  ``drop_last`` defaults to
    ``train``."""
    if drop_last is None:
        drop_last = train
    indices = np.asarray(indices)
    n_batches = (len(indices) // batch_size if drop_last
                 else -(-len(indices) // batch_size))
    decoder = choose_decoder(dataset, interpolation)

    def make_batch(bi: int) -> dict:
        idxs = indices[bi * batch_size:(bi + 1) * batch_size]
        labels = np.asarray([dataset.samples[i][1] for i in idxs], np.int32)
        if decoder == "native":
            imgs = native.decode_batch(
                [dataset.samples[i][0] for i in idxs], size, train=train,
                seed=seed * 1_000_003 + bi, num_threads=2)
            return {"image": imgs, "label": labels, "decoder": decoder}
        rng = np.random.default_rng((seed, bi))
        imgs = np.empty((len(idxs), size, size, 3), np.uint8)
        for j, idx in enumerate(idxs):
            imgs[j] = (dataset.load_train(idx, size, rng, interpolation)
                       if train else
                       dataset.load_eval(idx, size, interpolation))
        return {"image": imgs, "label": labels, "decoder": decoder}

    q: queue.Queue = queue.Queue(maxsize=num_threads * 2)
    stop = threading.Event()

    def worker(worker_id: int) -> None:
        for bi in range(worker_id, n_batches, num_threads):
            if stop.is_set():
                return
            try:
                item = (bi, make_batch(bi))
            except Exception as e:  # raised in the consumer, not lost
                item = (bi, e)
            # a put that re-checks stop: a consumer that leaves early sets
            # it, and a plain put on a full queue would strand the thread
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue

    threads = [threading.Thread(target=worker, args=(t,), daemon=True)
               for t in range(min(num_threads, max(1, n_batches)))]
    for t in threads:
        t.start()
    try:
        pending: dict[int, dict] = {}
        for want in range(n_batches):
            while want not in pending:
                bi, batch = q.get()
                pending[bi] = batch
            batch = pending.pop(want)
            if isinstance(batch, Exception):
                raise batch
            yield batch
    finally:
        stop.set()
