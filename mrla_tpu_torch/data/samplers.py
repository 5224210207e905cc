"""Index samplers (numpy, host side), the port's own copy of the JAX
package's ``data/samplers.py``; the same arguments give the same arrays.

  * ``distributed_indices``: torch ``DistributedSampler`` semantics (the
    reference's resnet/train.py): a shuffle seeded by ``seed + epoch``, the
    list tiled up to a multiple of ``world_size`` (a dataset smaller than
    the world repeats whole, so every rank gets as many indices), then
    every ``world_size``-th index from ``rank``.
  * ``ra_sampler_indices``: the DeiT recipe's ``RASampler``: each index
    repeated ``num_repeats`` times after the shuffle, tiled and strided the
    same way, then cut to floor(n / 256) * 256 / world_size indices a rank
    (truncated to a multiple of 256 before the split across ranks).

The trainer passes its rank and world (rank 0 of 1 on one card).
"""

from __future__ import annotations

import math

import numpy as np


def distributed_indices(n: int, rank: int, world_size: int, epoch: int,
                        shuffle: bool = True, seed: int = 0) -> np.ndarray:
    if n == 0:
        return np.arange(0)
    if shuffle:
        order = np.random.default_rng(seed + epoch).permutation(n)
    else:
        order = np.arange(n)
    total = int(math.ceil(n / world_size)) * world_size
    order = np.tile(order, int(math.ceil(total / n)))[:total]
    return order[rank:total:world_size]


def ra_sampler_indices(n: int, rank: int, world_size: int, epoch: int,
                       num_repeats: int = 3, seed: int = 0) -> np.ndarray:
    if n == 0:
        return np.arange(0)
    order = np.random.default_rng(seed + epoch).permutation(n)
    repeated = np.repeat(order, num_repeats)
    total = int(math.ceil(len(repeated) / world_size)) * world_size
    repeated = np.tile(repeated,
                       int(math.ceil(total / len(repeated))))[:total]
    selected = repeated[rank:total:world_size]
    return selected[:int(math.floor(n // 256 * 256 / world_size))]
