"""The tail routes of resnet50_mrlal serving (``serving/tail_routes.py``)
against the JAX package, on the CPU, in fp32.

One Flax init of resnet50_mrlal at full width and depth feeds both: the
JAX engine prepares its serving params and ``ckpt.serving_params_from_jax``
carries them to the port.  32 px images, batch 2.  The ``rowtail`` route is
held to ``scripts/exp_tail.py:forward(..., "rowtail")``, whose row-tail
kernel is handed ``interpret=True`` (the JAX function's own argument; its
TPU interpret mode would take minutes here); the ``block_tail``
and ``copy`` routes to the JAX engine's ``resnet_mrlal_forward`` with
``use_pallas=False``, which computes the same function.  Tolerance
``rtol=2e-3, atol=3e-4``, as ``tests/test_serving.py``.  ``HWBC_MIN_W`` is
set to 4 so that at 32 px stages 1 and 2 take the HWBC block tail and
stages 3 and 4 the other, the split of 224 px.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mrla_tpu.kernels.mrla_rowtail as j_rowtail_mod
from mrla_tpu.serving import (
    prepare_inference_params as j_prepare,
    resnet_mrlal_forward as j_forward,
)
from mrla_tpu_torch.ckpt import serving_params_from_jax
from mrla_tpu_torch.kernels import (
    fused_block_tail,
    fused_epilogue,
    hwbc_copy,
    mrla_block_tail_fused_next,
    mrla_block_tail_hwbc,
    mrla_rowtail,
)
from mrla_tpu_torch.serving import resnet_mrlal_tail_forward
from mrla_tpu_torch.serving import tail_routes

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from exp_tail import forward as exp_tail_forward  # noqa: E402
from test_torch_resnet_mrlal import _flax_variables  # noqa: E402

RTOL, ATOL = 2e-3, 3e-4
PX, BATCH, CLASSES = 32, 2, 10
COUNTERS = {"block_tail": fused_block_tail.counter,
            "hwbc": mrla_block_tail_hwbc.counter,
            "rowtail": mrla_rowtail.counter,
            "copy": hwbc_copy.counter,
            "megatail": mrla_block_tail_fused_next.counter,
            "epilogue": fused_epilogue.counter}
# calls per forward of each route at 32 px with HWBC_MIN_W = 4
CALLS = {
    "rowtail": {"rowtail": 16},
    "block_tail": {"hwbc": 7, "block_tail": 9},
    "copy": {"hwbc": 7, "block_tail": 9, "copy": 3},
}


@pytest.fixture(scope="module")
def routes():
    """Both packages' logits of every route, and the port's call counts."""
    _, variables = _flax_variables((3, 4, 6, 3), PX, seed=12,
                                   num_classes=CLASSES)
    j_sp = jax.device_get(j_prepare(variables, dtype=jnp.float32))
    sp = serving_params_from_jax(j_sp, device="cpu", dtype=torch.float32)
    x = np.random.default_rng(12).standard_normal(
        (BATCH, PX, PX, 3)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_rowtail_mod, "mrla_rowtail", functools.partial(
            j_rowtail_mod.mrla_rowtail, interpret=True))
        want = {"rowtail": np.asarray(jax.jit(
            lambda p, xx: exp_tail_forward(p, xx, "rowtail"))(
                j_sp, jnp.asarray(x)))}
    want["block_tail"] = want["copy"] = np.asarray(
        j_forward(j_sp, jnp.asarray(x), use_pallas=False))
    got, calls = {}, {}
    saved = tail_routes.HWBC_MIN_W
    tail_routes.HWBC_MIN_W = 4
    try:
        for tail in tail_routes.TAILS:
            for c in COUNTERS.values():
                c.reset()
            got[tail] = resnet_mrlal_tail_forward(sp, torch.from_numpy(x),
                                                  tail)
            calls[tail] = {k: (c.calls, c.launches)
                           for k, c in COUNTERS.items()}
    finally:
        tail_routes.HWBC_MIN_W = saved
    return got, want, calls


@pytest.mark.parametrize("tail", ["rowtail", "block_tail", "copy"])
def test_tail_route_matches_jax(routes, tail):
    got, want, _ = routes
    assert got[tail].shape == (BATCH, CLASSES)
    assert got[tail].dtype == torch.float32
    np.testing.assert_allclose(got[tail].numpy(), want[tail], rtol=RTOL,
                               atol=ATOL)


def test_copy_route_equals_block_tail_route_bitwise(routes):
    got, _, _ = routes
    assert torch.equal(got["copy"], got["block_tail"])


@pytest.mark.parametrize("tail", ["rowtail", "block_tail", "copy"])
def test_tail_route_calls_its_kernels_and_launches_nothing_on_cpu(routes,
                                                                  tail):
    _, _, calls = routes
    want = {k: (CALLS[tail].get(k, 0), 0) for k in COUNTERS}
    assert calls[tail] == want


def test_unknown_tail_raises():
    with pytest.raises(ValueError, match="tail must be one of"):
        resnet_mrlal_tail_forward({"stem": {}, "blocks": []},
                                  torch.zeros(1, 8, 8, 3), "megatail")
