"""Port ops (mrla_tpu_torch.ops) against their JAX counterparts, fp32 CPU.

Inputs are made with seeded numpy and handed to both packages; weights in
the port's torch layouts are transposed to the JAX layouts at the
boundary.  Shapes include C=64 and W=7, which the TPU kernels' shape gates
rejected."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrla_tpu.ops import common as jops
from mrla_tpu.ops.mrla import MRLAParams as JMRLAParams
from mrla_tpu.ops.mrla import mrla_light_attention as j_mrla_light_attention
from mrla_tpu_torch import ops as tops

RTOL, ATOL = 1e-5, 1e-6


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("channels", [3, 16, 64, 128, 256, 512, 1024, 2048])
def test_eca_kernel_size(channels):
    assert tops.eca_kernel_size(channels) == jops.eca_kernel_size(channels)


@pytest.mark.parametrize("shape", [(2, 7, 7, 64), (3, 5, 9, 16)])
def test_global_avg_pool(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    _close(tops.global_avg_pool(torch.from_numpy(x)),
           jops.global_avg_pool(jnp.asarray(x)))


@pytest.mark.parametrize("c,k", [(64, 3), (256, 5), (512, 5), (2048, 7)])
def test_channel_conv1d(c, k):
    rng = np.random.default_rng(1)
    y = rng.standard_normal((3, c)).astype(np.float32)
    w = rng.standard_normal(k).astype(np.float32)
    _close(tops.channel_conv1d(torch.from_numpy(y), torch.from_numpy(w)),
           jops.channel_conv1d(jnp.asarray(y), jnp.asarray(w)))


@pytest.mark.parametrize("shape", [(2, 7, 7, 64), (1, 5, 9, 32)])
def test_depthwise_conv3x3(shape):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((shape[-1], 1, 3, 3)).astype(np.float32)
    _close(tops.depthwise_conv3x3(torch.from_numpy(x), torch.from_numpy(w)),
           jops.depthwise_conv3x3(jnp.asarray(x),
                                  jnp.asarray(w.transpose(2, 3, 1, 0))))


@pytest.mark.parametrize("shape", [(2, 7, 7, 64), (2, 8, 8, 16)])
def test_max_pool_same_torch(shape):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    _close(tops.max_pool_same_torch(torch.from_numpy(x), 3, 2),
           jops.max_pool_same_torch(jnp.asarray(x), 3, 2))


@pytest.mark.parametrize("shape,heads", [((2, 7, 7, 64), 2),
                                         ((2, 6, 5, 256), 8)])
def test_mrla_light_attention(shape, heads):
    rng = np.random.default_rng(4)
    c = shape[-1]
    k = tops.eca_kernel_size(c)
    x = rng.standard_normal(shape).astype(np.float32)
    wq = rng.standard_normal(k).astype(np.float32) * 0.5
    wk = rng.standard_normal(k).astype(np.float32) * 0.5
    wv = rng.standard_normal((c, 1, 3, 3)).astype(np.float32) * 0.3
    got = tops.mrla_light_attention(
        torch.from_numpy(x),
        tops.MRLAParams(torch.from_numpy(wq).reshape(1, 1, k),
                        torch.from_numpy(wk).reshape(1, 1, k),
                        torch.from_numpy(wv)),
        heads,
    )
    want = j_mrla_light_attention(
        jnp.asarray(x),
        JMRLAParams(jnp.asarray(wq), jnp.asarray(wk),
                    jnp.asarray(wv.transpose(2, 3, 1, 0))),
        heads,
    )
    _close(got, want)
