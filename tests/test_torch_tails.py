"""The port's block tail from z, HWBC block tail, row tail and HWBC copy
against the JAX functions, on the CPU.

The JAX block tails (``mrla_block_tail_pallas``, ``mrla_block_tail_hwbc``)
and ``scripts/exp_boundary.py:hwbc_copy`` have no ``interpret`` argument;
they run here under ``pltpu.force_tpu_interpret_mode()``, and
``mrla_rowtail`` with ``interpret=True``.  Nothing in the JAX package is
edited for that.  On CPU tensors the port's wrappers run their plain
versions: they count the call and no launch.

Tolerances: bf16 outputs within 1 bf16 ulp of the largest |y| (both sides
round one fp32 value, summed in another order, once), x1 within 2 (its own
rounding and y's one-ulp flips); fp32 block tails within 1e-5; the fp32
row tail within the JAX row-tail test's own limits (y 1e-4, x1 5e-3,
``tests/test_rowtail_kernel.py``).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mrla_tpu.kernels.mrla_epilogue import (
    mrla_block_tail_pallas as j_block_tail,
    mrla_light_epilogue_reference as j_epilogue,
    mrla_light_gate as j_gate,
)
from mrla_tpu.kernels.mrla_epilogue_hwbc import (
    mrla_block_tail_hwbc as j_block_tail_hwbc,
)
from mrla_tpu.kernels.mrla_rowtail import mrla_rowtail as j_rowtail
from mrla_tpu_torch.kernels import (
    fused_block_tail,
    fused_block_tail_reference,
    fused_epilogue_reference,
    hwbc_copy,
    mrla_block_tail,
    mrla_block_tail_hwbc,
    mrla_light_gate,
    mrla_rowtail,
    rowtail_covers,
)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from exp_boundary import hwbc_copy as j_hwbc_copy  # noqa: E402
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

def _tail_args(rng, b, h, w, c, dtype=np.float32):
    """z, identity and the tail's vectors, numpy, as the JAX tests draw
    them (``tests/test_kernels_tpu.py``)."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {
        "z": f(b, h, w, c), "identity": f(b, h, w, c),
        "wq": f(5) * 0.2, "wk": f(5) * 0.2, "wv": f(3, 3, 1, c) * 0.2,
        "lam": f(c), "bn_scale": np.abs(f(c)), "bn_bias": f(c),
    }


def _jax_args(a, bf16: bool):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    if bf16:
        j["z"] = j["z"].astype(jnp.bfloat16)
        j["identity"] = j["identity"].astype(jnp.bfloat16)
    return j


def _torch_args(j, c):
    """The JAX inputs as torch tensors (bf16 bits carried through fp32)."""
    t = {}
    for k, v in j.items():
        t[k] = torch.from_numpy(np.array(v, np.float32))
        if v.dtype == jnp.bfloat16:
            t[k] = t[k].bfloat16()
    if "wv" in t:
        t["wv"] = t["wv"].reshape(9, c)
    return t


def _assert_ulps(got, want, ulps):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = ulps * 2.0 ** -7 * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol, (err, tol)


def _block_tail_call(fn, t, heads):
    return fn(t["z"], t["identity"], t["wq"], t["wk"], t["wv"], t["lam"],
              t["bn_scale"], t["bn_bias"], heads)


@pytest.mark.parametrize("b,h,w,c", [(2, 8, 8, 128), (8, 16, 16, 256)])
def test_block_tail_matches_jax_kernel(b, h, w, c):
    heads = c // 32
    j = _jax_args(_tail_args(np.random.default_rng(1), b, h, w, c), True)
    with pltpu.force_tpu_interpret_mode():
        want = _block_tail_call(j_block_tail, j, heads)
    t = _torch_args(j, c)
    fused_block_tail.counter.reset()
    got = _block_tail_call(mrla_block_tail, t, heads)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, w, c)
    assert (fused_block_tail.counter.calls,
            fused_block_tail.counter.launches) == (1, 0)
    _assert_ulps(got.float().numpy(), want, 1)


# odd W and C = 64, which the JAX kernel's shape gate refuses, down to the
# window's edges (rows of 1, 2 and 3 pixels); in fp32 the jnp oracle's
# relu(z + id) is the unrounded value the kernel uses
@pytest.mark.parametrize("b,h,w,c", [(2, 7, 7, 64), (3, 6, 5, 64),
                                     (2, 4, 1, 64), (1, 3, 2, 64),
                                     (2, 5, 3, 64)])
def test_block_tail_at_odd_widths_matches_jnp_oracle(b, h, w, c):
    heads = c // 32
    j = _jax_args(_tail_args(np.random.default_rng(2), b, h, w, c), False)
    out = jax.nn.relu(j["z"] + j["identity"])
    want = j_epilogue(out, j["identity"], j["wq"], j["wk"], j["wv"],
                      j["lam"], j["bn_scale"], j["bn_bias"], heads)
    t = _torch_args(j, c)
    for fn in (mrla_block_tail, mrla_block_tail_hwbc):
        got = _block_tail_call(fn, t, heads)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_block_tail_reference_is_the_epilogue_of_relu_z_plus_id():
    rng = np.random.default_rng(3)
    t = _torch_args(_jax_args(_tail_args(rng, 2, 5, 9, 128), False), 128)
    gate = torch.sigmoid(torch.from_numpy(
        rng.standard_normal((2, 128)).astype(np.float32)))
    vec = (t["wv"], t["lam"], t["bn_scale"], t["bn_bias"])
    got = fused_block_tail_reference(t["z"], t["identity"], gate, *vec)
    want = fused_epilogue_reference((t["z"] + t["identity"]).relu(),
                                    t["identity"], gate, *vec)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# the JAX test's shape (tests/test_kernels_tpu.py) and a batch of 3, which
# the JAX kernel takes as one batch tile of 3
@pytest.mark.parametrize("b,h,w,c", [(8, 16, 16, 256), (3, 16, 16, 256)])
def test_block_tail_hwbc_matches_jax_kernel(b, h, w, c):
    heads = 8
    j = _jax_args(_tail_args(np.random.default_rng(4), b, h, w, c), True)
    with pltpu.force_tpu_interpret_mode():
        want = _block_tail_call(j_block_tail_hwbc, j, heads)
    t = _torch_args(j, c)
    mrla_block_tail_hwbc.counter.reset()
    fused_block_tail.counter.reset()
    got = _block_tail_call(mrla_block_tail_hwbc, t, heads)
    assert (mrla_block_tail_hwbc.counter.calls,
            mrla_block_tail_hwbc.counter.launches) == (1, 0)
    assert fused_block_tail.counter.calls == 0  # its own counter
    _assert_ulps(got.float().numpy(), want, 1)


ROWTAIL_SHAPES = [(8, 6, 5, 256, 64), (8, 7, 7, 128, 128),
                  (16, 14, 14, 512, 256), (8, 2, 3, 128, 64)]


def _rowtail_case(b, h, w, c, c1, seed=42):
    """Inputs as ``tests/test_rowtail_kernel.py`` draws them: out, id, the
    gate of out, wv [3, 3, 1, C], W1 [C, C1] (JAX layout) and b1."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    out, idn = f(b, h, w, c), f(b, h, w, c)
    wq, wk = f(5), f(5)
    a = {"out": out, "identity": idn, "wv": f(3, 3, 1, c), "lam": f(c),
         "bn_scale": f(c), "bn_bias": f(c)}
    w1, b1 = f(c, c1) * 0.05, f(c1)
    gate = np.array(j_gate(jnp.asarray(out), jnp.asarray(wq),
                             jnp.asarray(wk), c // 32))
    return a, gate, w1, b1


@pytest.mark.parametrize("b,h,w,c,c1", ROWTAIL_SHAPES)
def test_rowtail_matches_jax_kernel_fp32(b, h, w, c, c1):
    a, gate, w1, b1 = _rowtail_case(b, h, w, c, c1)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    jy, jx1 = j_rowtail(j["out"], j["identity"], jnp.asarray(gate), j["wv"],
                        j["lam"], j["bn_scale"], j["bn_bias"],
                        jnp.asarray(w1), jnp.asarray(b1), interpret=True)
    jy_only = j_rowtail(j["out"], j["identity"], jnp.asarray(gate), j["wv"],
                        j["lam"], j["bn_scale"], j["bn_bias"],
                        interpret=True)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    t["wv"] = t["wv"].reshape(9, c)
    args = (t["out"], t["identity"], torch.from_numpy(gate), t["wv"],
            t["lam"], t["bn_scale"], t["bn_bias"])
    # the torch conv layout [C1, C, 1, 1]
    w1_t = torch.from_numpy(np.ascontiguousarray(w1.T))[:, :, None, None]
    mrla_rowtail.counter.reset()
    y, x1 = mrla_rowtail(*args, w1_t, torch.from_numpy(b1))
    y_only = mrla_rowtail(*args)
    assert (mrla_rowtail.counter.calls, mrla_rowtail.counter.launches) == (2,
                                                                          0)
    assert x1.shape == (b, h, w, c1) and rowtail_covers(c, c1)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4)
    np.testing.assert_allclose(x1.numpy(), np.asarray(jx1), atol=5e-3)
    np.testing.assert_allclose(y_only.numpy(), np.asarray(jy_only),
                               atol=1e-4)


def test_rowtail_matches_jax_kernel_bf16():
    b, h, w, c, c1 = 4, 7, 5, 256, 64
    a, gate, w1, b1 = _rowtail_case(b, h, w, c, c1, seed=7)
    a["out"] = np.maximum(a["out"], 0)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    for k in ("out", "identity"):
        j[k] = j[k].astype(jnp.bfloat16)
    jw1 = jnp.asarray(w1).astype(jnp.bfloat16)
    jy, jx1 = j_rowtail(j["out"], j["identity"], jnp.asarray(gate), j["wv"],
                        j["lam"], j["bn_scale"], j["bn_bias"], jw1,
                        jnp.asarray(b1), interpret=True)
    t = _torch_args(j, c)
    w1_t = torch.from_numpy(np.asarray(jw1, np.float32).T.copy()).bfloat16()
    y, x1 = mrla_rowtail(t["out"], t["identity"], torch.from_numpy(gate),
                         t["wv"], t["lam"], t["bn_scale"], t["bn_bias"],
                         w1_t, torch.from_numpy(b1))
    assert y.dtype == x1.dtype == torch.bfloat16
    _assert_ulps(y.float().numpy(), jy, 1)
    _assert_ulps(x1.float().numpy(), jx1, 2)


@pytest.mark.parametrize("c,c1,covered", [
    (256, 64, True), (1024, 512, True), (2048, 512, True), (2048, 0, True),
    (3328, 512, True), (96, 0, True), (96, 64, False), (256, 96, False),
    (4096, 512, False), (12, 0, False)])
def test_rowtail_covers(c, c1, covered):
    assert rowtail_covers(c, c1) is covered


# The (C, next C1) pairs the engine sends to the mega-tail today: layer1_0..2
# and layer2_0..3 at 224 px, and the same plus layer3_0..4 on the 800 x 1344
# detection trunk.  The kernel's ring must leave every one of them covered.
@pytest.mark.parametrize("c,c1", [
    (256, 64), (256, 128), (512, 128), (512, 256),
    (256, 64), (256, 128), (512, 128), (512, 256), (1024, 256)])
def test_megatail_covers_the_routed_pairs(c, c1):
    from mrla_tpu_torch.kernels import megatail_covers

    assert megatail_covers(c, c1)


# Every (C, C1) of the rowtail route at 224 px (C1 = 0: layer4_2, y alone).
@pytest.mark.parametrize("c,c1", [
    (256, 64), (256, 128), (512, 128), (512, 256), (1024, 256), (1024, 512),
    (2048, 512), (2048, 0)])
def test_rowtail_covers_the_route_shapes(c, c1):
    assert rowtail_covers(c, c1)


def test_rowtail_needs_w1_and_b1_together():
    t = _torch_args(_jax_args(_tail_args(np.random.default_rng(5), 1, 3, 3,
                                         64), False), 64)
    gate = torch.ones(1, 64)
    with pytest.raises(ValueError, match="go together"):
        mrla_rowtail(t["z"], t["identity"], gate, t["wv"], t["lam"],
                     t["bn_scale"], t["bn_bias"], torch.zeros(64, 64))


@pytest.mark.parametrize("b", [3, 8])
def test_hwbc_copy_is_a_new_equal_tensor(b):
    rng = np.random.default_rng(b)
    x = torch.from_numpy(rng.standard_normal((b, 4, 5, 64)).astype(
        np.float32)).bfloat16()
    hwbc_copy.counter.reset()
    y = hwbc_copy(x)
    assert torch.equal(y, x) and y.dtype == x.dtype
    assert y.data_ptr() != x.data_ptr() and y.is_contiguous()
    x.zero_()  # no alias: y keeps its values
    assert not torch.equal(y, x)
    assert (hwbc_copy.counter.calls, hwbc_copy.counter.launches) == (1, 0)


# sizes that are no multiple of a kernel block's share (1024 or 2048
# 16-byte vectors; 16 KB)
@pytest.mark.parametrize("shape", [(3, 4, 5, 64), (7, 33, 31, 136)])
def test_hwbc_copy_at_odd_sizes(shape):
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        shape).astype(np.float32)).bfloat16()
    y = hwbc_copy(x)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()


def test_hwbc_copy_matches_jax_at_a_batch_of_8():
    x = jnp.asarray(np.random.default_rng(6).standard_normal((8, 4, 4, 128)),
                    jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_hwbc_copy(x), np.float32)
    got = hwbc_copy(torch.from_numpy(np.asarray(x, np.float32)).bfloat16())
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_wrappers_raise_for_a_device_without_a_kernel():
    z = torch.empty(1, 3, 3, 64, device="meta")
    vec = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        hwbc_copy(z)
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_block_tail(z, z, torch.empty(1, 64, device="meta"),
                         torch.empty(9, 64, device="meta"), vec, vec, vec)
    with pytest.raises(ValueError, match="no kernel for device"):
        mrla_rowtail(z, z, torch.empty(1, 64, device="meta"),
                     torch.empty(9, 64, device="meta"), vec, vec, vec)


def test_gate_of_the_block_tail_rounds_the_sum_once():
    """mrla_block_tail's gate sees relu(z + id) rounded to bf16 once, as
    the JAX function's does (mrla_epilogue.py:202-205)."""
    rng = np.random.default_rng(8)
    j = _jax_args(_tail_args(rng, 2, 4, 4, 64), True)
    out = jax.nn.relu(j["z"].astype(jnp.float32)
                      + j["identity"].astype(jnp.float32)).astype(
                          jnp.bfloat16)
    want = j_gate(out, j["wq"], j["wk"], 2)
    t = _torch_args(j, 64)
    got = mrla_light_gate((t["z"] + t["identity"]).relu(), t["wq"], t["wk"],
                          2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
