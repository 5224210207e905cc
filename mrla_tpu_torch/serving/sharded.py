"""Data-parallel serving over a mesh: the port's counterpart of the JAX
package's ``serving/sharded.py``.

Each rank runs a single-card engine (``resnet_mrlal_forward``,
``resnet_mrlab_forward``, ``deit_forward``, ``precast_forward``, with its
``microbatch`` chains) on its own rows of the global batch, split over the
``data`` axis as ``shard_batch`` splits it, and returns its rows of the
output.  There are no collectives on the way: classification inference is
per-sample, so throughput scales with the ranks.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict

import torch

from mrla_tpu_torch.parallel.mesh import Mesh, batch_sharding
from mrla_tpu_torch.serving.resnet_mrlal import resnet_mrlal_forward


def make_sharded_forward(mesh: Mesh, forward: Callable = resnet_mrlal_forward,
                         axis: str = "data", **static_kw: Any):
    """``sharded(serving_params, x)``: ``forward(serving_params,
    x[rows], **static_kw)`` for this rank's rows of the global batch ``x``
    (which must divide by the axis size); the params are the whole
    (replicated) ones on every rank."""
    fwd = functools.partial(forward, **static_kw) if static_kw else forward

    def sharded(serving_params: Dict, x: torch.Tensor):
        return fwd(serving_params, x[batch_sharding(mesh, len(x), axis)])

    return sharded
