"""The port's DeiT token tail (mrla_tpu_torch.kernels.deit_token_tail)
against the JAX package: its Pallas kernel in interpret mode and the Flax
``MRLALightTokenModule`` whose semantics the kernel has.

Inputs come from a seeded numpy generator and go to both packages; the
Flax module's init supplies the weights, which reach the port through
``tail_params_from_jax``.  On the CPU the port's wrapper runs the plain
version, so that is what these tests hold to the JAX side.  Tolerances are
the JAX package's own (``tests/test_deit_tail_kernel.py``): max abs error
over max |ref| below 1e-5 in fp32 (the TPU kernel's rational erf, 1.5e-7
off the exact one, is inside it) and below 2e-2 in bf16, where the Flax
path rounds its intermediates and the kernel does not."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrla_tpu.kernels.deit_token_tail import (
    deit_token_tail as j_deit_token_tail,
    extract_tail_params as j_extract,
    pack_tail_params as j_pack,
)
from mrla_tpu.models.deit_mrla import MRLALightTokenModule as FlaxTokenModule
from mrla_tpu.ops.mrla import MRLAParams as JMRLAParams
from mrla_tpu.ops.mrla import mrla_light_attention as j_mrla_light_attention
from mrla_tpu_torch import ops as tops
from mrla_tpu_torch.ckpt import tail_params_from_jax
from mrla_tpu_torch.kernels import (
    TailParams,
    deit_token_tail,
    deit_token_tail_reference,
    pack_tail_params,
)
from mrla_tpu_torch.models import MRLALightTokenModule
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)


def _setup(b=16, n=197, c=384, dim_perhead=16, seed=0):
    """Seeded fp32 inputs, the Flax module with its variables, and the
    port's packed params converted from them."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, c).astype(np.float32)
    ot = rng.randn(b, n, c).astype(np.float32)
    mod = FlaxTokenModule(dim_perhead)
    variables = jax.device_get(
        mod.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(ot)))
    block = {"mrla": variables["params"]}
    packed = pack_tail_params(tail_params_from_jax(block))
    return x, ot, mod, variables, block, packed


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


# the three published widths (768 at a batch of 8, the least whose B * N
# the JAX kernel takes, to stay quick)
@pytest.mark.parametrize("c", [384, 192, 768])
def test_plain_version_matches_jax_kernel_f32(c):
    x, ot, _, _, block, packed = _setup(b=8 if c == 768 else 16, c=c)
    w, taps = j_pack(j_extract(block))
    want = j_deit_token_tail(jnp.asarray(x), jnp.asarray(ot), w, taps,
                             dim_perhead=16, interpret=True)
    got = deit_token_tail_reference(_torch(x), _torch(ot), packed, 16)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _rel(got, want) < 1e-5


def test_plain_version_matches_jax_kernel_bf16():
    x, ot, _, _, block, packed = _setup()
    w, taps = j_pack(j_extract(block))
    want = j_deit_token_tail(jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(ot, jnp.bfloat16), w, taps,
                             interpret=True).astype(jnp.float32)
    got = deit_token_tail_reference(_torch(x, torch.bfloat16),
                                    _torch(ot, torch.bfloat16), packed)
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) < 2e-2


@pytest.mark.parametrize("c", [384, 192])
def test_plain_version_matches_flax_module_f32(c):
    x, ot, mod, variables, _, packed = _setup(c=c, seed=1)
    want = jnp.asarray(x) + mod.apply(variables, jnp.asarray(x),
                                      jnp.asarray(ot))
    got = deit_token_tail_reference(_torch(x), _torch(ot), packed)
    assert _rel(got, want) < 1e-5


def test_plain_version_matches_flax_module_bf16():
    x, ot, mod, variables, _, packed = _setup(seed=2)
    xb, ob = jnp.asarray(x, jnp.bfloat16), jnp.asarray(ot, jnp.bfloat16)
    want = (xb + mod.apply(variables, xb, ob)).astype(jnp.float32)
    got = deit_token_tail_reference(_torch(x, torch.bfloat16),
                                    _torch(ot, torch.bfloat16), packed)
    assert _rel(got, want) < 2e-2


def test_cls_row_bypasses_mrla_and_ignores_ot():
    """The cls row is x_cls + normx(x_cls): no MRLA term, no ot."""
    x, ot, mod, variables, _, packed = _setup(b=4, seed=3)
    want = jnp.asarray(x) + mod.apply(variables, jnp.asarray(x),
                                      jnp.asarray(ot))
    got = deit_token_tail_reference(_torch(x), _torch(ot), packed)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want[:, 0]),
                               atol=1e-5)
    got2 = deit_token_tail_reference(_torch(x), _torch(ot) * 2.0, packed)
    assert torch.equal(got[:, 0], got2[:, 0])
    assert not torch.equal(got[:, 1:], got2[:, 1:])


# shapes the TPU kernel refuses: a 4x4 grid, B * N no multiple of 8, and
# the 3-tap channel convs of C = 64
@pytest.mark.parametrize("b,n,c,dim_perhead", [(3, 17, 128, 16),
                                               (3, 17, 64, 16),
                                               (2, 10, 64, 32)])
def test_plain_version_matches_port_module(b, n, c, dim_perhead):
    gen = torch.Generator().manual_seed(4)
    mod = MRLALightTokenModule(c, dim_perhead, generator=gen).eval()
    with torch.no_grad():  # LayerNorms away from the identity
        for ln in (mod.normx, mod.normo):
            ln.weight.uniform_(0.5, 1.5, generator=gen)
            ln.bias.uniform_(-0.5, 0.5, generator=gen)
    assert mod.mrla.Wq.weight.shape[-1] == tops.eca_kernel_size(c)
    rng = np.random.default_rng(4)
    x = _torch(rng.standard_normal((b, n, c)).astype(np.float32))
    ot = _torch(rng.standard_normal((b, n, c)).astype(np.float32))
    with torch.no_grad():
        want = x + mod(x, ot)
    packed = pack_tail_params(mod.state_dict())
    assert packed.vec.shape == (14, c) and packed.taps.shape[0] == 2
    got = deit_token_tail_reference(x, ot, packed, dim_perhead)
    assert _rel(got, want.numpy()) < 1e-5


def test_depthwise_taps_are_cross_correlation_in_row_major_order():
    """Row 5 + (dh + 1) * 3 + (dw + 1) of vec is the tap that multiplies
    the neighbour at (h + dh, w + dw): with one non-zero tap, the value of a
    grid token is its neighbour's normx times that tap."""
    c, s = 16, 4
    sd = MRLALightTokenModule(c, 16).state_dict()
    wv = torch.zeros(c, 1, 3, 3)
    wv[:, 0, 0, 2] = 2.0  # dh = -1, dw = +1
    sd["mrla.Wv.weight"] = wv
    sd["lambda_t"] = torch.zeros(c)
    packed = pack_tail_params(sd)
    assert torch.equal(packed.vec[5 + 0 * 3 + 2], torch.full((c,), 2.0))
    assert packed.vec[5:14].abs().sum() == 2.0 * c
    x = torch.randn(1, 1 + s * s, c,
                    generator=torch.Generator().manual_seed(5))
    normx = torch.nn.functional.layer_norm(x, (c,), eps=1e-6)
    # make the gate 1/2: zero taps for q
    packed = TailParams(packed.vec, torch.zeros_like(packed.taps))
    got = deit_token_tail_reference(x, x, packed, 16)
    h, w = 2, 1  # token (2, 1) reads (1, 2)
    v = torch.nn.functional.gelu(2.0 * normx[0, 1 + 1 * s + 2])
    torch.testing.assert_close(got[0, 1 + h * s + w],
                               x[0, 1 + h * s + w] + 0.5 * v,
                               rtol=1e-5, atol=1e-6)
    # the top row's neighbour above is outside the grid: no MRLA term
    torch.testing.assert_close(got[0, 1 + 0 * s + 1], x[0, 1 + 0 * s + 1],
                               rtol=0, atol=0)


@pytest.mark.parametrize("shape,heads", [((2, 7, 7, 64), 4),
                                         ((2, 14, 14, 192), 12)])
def test_mrla_light_attention_act_v_matches_jax(shape, heads):
    rng = np.random.default_rng(6)
    c = shape[-1]
    k = tops.eca_kernel_size(c)
    x = rng.standard_normal(shape).astype(np.float32)
    wq = rng.standard_normal(k).astype(np.float32) * 0.5
    wk = rng.standard_normal(k).astype(np.float32) * 0.5
    wv = rng.standard_normal((c, 1, 3, 3)).astype(np.float32) * 0.3
    params = tops.MRLAParams(_torch(wq), _torch(wk), _torch(wv))
    jparams = JMRLAParams(jnp.asarray(wq), jnp.asarray(wk),
                          jnp.asarray(wv.transpose(2, 3, 1, 0)))
    got = tops.mrla_light_attention(_torch(x), params, heads,
                                    act_v=torch.nn.functional.gelu)
    want = j_mrla_light_attention(
        jnp.asarray(x), jparams, heads,
        act_v=lambda v: jax.nn.gelu(v, approximate=False))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # without act_v nothing changes for the existing callers
    plain = tops.mrla_light_attention(_torch(x), params, heads)
    np.testing.assert_allclose(
        plain.numpy(),
        np.asarray(j_mrla_light_attention(jnp.asarray(x), jparams, heads)),
        rtol=1e-5, atol=1e-6)
    assert not torch.allclose(plain, got)


def test_cpu_tensors_take_the_plain_path_and_count_by_shape():
    x, ot, _, _, _, packed = _setup(b=2, seed=7)
    x, ot = _torch(x), _torch(ot)
    counter = deit_token_tail.counter
    counter.reset()
    got = deit_token_tail(x, ot, packed)
    torch.testing.assert_close(got, deit_token_tail_reference(x, ot, packed),
                               rtol=0, atol=0)
    assert (counter.calls, counter.launches) == (1, 0)
    assert not counter.by_shape
    counter.launch((2, 197, 384))  # what a launch on the card records
    counter.launch((2, 197, 384))
    assert counter.by_shape == {(2, 197, 384): 2} and counter.launches == 2
    counter.reset()
    assert (counter.calls, counter.launches, dict(counter.by_shape)) \
        == (0, 0, {})


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, ot, _, _, _, packed = _setup(b=1, seed=8)
    x, ot = _torch(x), _torch(ot)
    with pytest.raises(ValueError, match="square"):
        deit_token_tail(x[:, :196], ot[:, :196], packed)
    with pytest.raises(ValueError, match=r"\[B, N, C\]"):
        deit_token_tail(x, ot[:, :100], packed)
    with pytest.raises(ValueError, match="vec"):
        deit_token_tail(x, ot, TailParams(packed.vec[:, :192], packed.taps))
    with pytest.raises(ValueError, match="dim_perhead"):
        deit_token_tail(x, ot, packed, dim_perhead=100)
    with pytest.raises(ValueError, match="no kernel for device"):
        deit_token_tail(x.to("meta"), ot.to("meta"),
                        TailParams(*(t.to("meta") for t in packed)))
