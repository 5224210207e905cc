"""The serving entries' ``microbatch`` option: a batch served as
independent chains of ``microbatch`` images, one after another.

The JAX package traces the chains side by side in one XLA program, which
interleaves one chain's MRLA gate barrier with another's convolutions and
fits the smaller activations in a TPU core's VMEM; it serves split by
default.  Here the chains run one after another in one CUDA stream, with
nothing to overlap them, so the port's entries default to ``microbatch=0``
(the unsplit forward).  The option keeps the JAX package's meaning: the
logits are the unsplit forward's, bit for bit on the CPU.  The trunks run
chain by chain and the classifier head once, on the chains' outputs
together: a CPU matrix product of a few rows may take another kernel than
one of many, and round otherwise.  On a card a convolution may take another
algorithm at another batch, so there the chains agree only within
rounding.
"""

from __future__ import annotations

from typing import Optional

import torch


def chains(x: torch.Tensor, microbatch: int) -> Optional[list]:
    """``x`` cut into chains of ``microbatch`` images along the batch, or
    None (serve unsplit) unless ``microbatch`` divides a larger batch."""
    b = x.shape[0]
    if microbatch and b > microbatch and b % microbatch == 0:
        return list(x.split(microbatch))
    return None
