"""Plain versions of the port's CUDA kernels against the JAX oracles, fp32 CPU.

The Pallas bodies of the JAX epilogue and mega-tail kernels have no
interpret mode, so their oracles are the JAX references: the epilogue
against ``mrla_light_epilogue_reference``, the mega-tail against that
reference followed by the 1x1 conv and ReLU, as the JAX package's on-chip
test builds it.  On a CPU tensor the wrappers run these plain versions:
they count the call and no launch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrla_tpu.kernels.mrla_epilogue import (
    mrla_light_epilogue_reference as j_epilogue,
    mrla_light_gate as j_gate,
)
from mrla_tpu_torch.kernels import (
    fused_epilogue,
    mrla_block_tail_fused_next,
    mrla_block_tail_fused_next_reference,
    mrla_light_epilogue,
    mrla_light_epilogue_reference,
    mrla_light_gate,
)
from mrla_tpu_torch.kernels._build import LaunchCounter

RTOL, ATOL = 1e-5, 1e-5

# (B, H, W, C, heads): a 7-wide map and C=64 (rejected by the TPU gates),
# a ragged 5x9 map, and C=256 with 8 heads as in stage 1
SHAPES = [(2, 7, 7, 64, 2), (3, 5, 9, 128, 4), (2, 8, 8, 256, 8)]


def _inputs(b, h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    k = 3 if c == 64 else 5
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {
        "out": np.maximum(f(b, h, w, c), 0),
        "identity": f(b, h, w, c),
        "wq": f(k) * 0.5,
        "wk": f(k) * 0.5,
        "wv": f(3, 3, 1, c) * 0.3,  # JAX HWIO; the port's [9, C] is a reshape
        "lam": f(c),
        "bn_scale": f(c) * 0.2 + 1.0,
        "bn_bias": f(c) * 0.2,
    }


def _torch(a, c):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    t["wv"] = t["wv"].reshape(9, c)
    return t


def _jax(a):
    return {k: jnp.asarray(v) for k, v in a.items()}


@pytest.mark.parametrize("b,h,w,c,heads", SHAPES)
def test_gate_matches_jax(b, h, w, c, heads):
    a = _inputs(b, h, w, c)
    t, j = _torch(a, c), _jax(a)
    got = mrla_light_gate(t["out"], t["wq"], t["wk"], heads)
    want = j_gate(j["out"], j["wq"], j["wk"], heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,h,w,c,heads", SHAPES)
def test_epilogue_reference_matches_jax(b, h, w, c, heads):
    a = _inputs(b, h, w, c, seed=1)
    t, j = _torch(a, c), _jax(a)
    got = mrla_light_epilogue_reference(**t, heads=heads)
    want = j_epilogue(**j, heads=heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("c1", [64, 128])
@pytest.mark.parametrize("b,h,w,c,heads", SHAPES)
def test_megatail_reference_matches_jax_composite(b, h, w, c, heads, c1):
    a = _inputs(b, h, w, c, seed=2)
    rng = np.random.default_rng(3)
    w1 = (rng.standard_normal((c, c1)) / np.sqrt(c)).astype(np.float32)
    b1 = (rng.standard_normal(c1) * 0.2).astype(np.float32)
    t, j = _torch(a, c), _jax(a)

    y_ref = j_epilogue(**j, heads=heads)
    x1_ref = jax.lax.conv_general_dilated(
        y_ref, jnp.asarray(w1).reshape(1, 1, c, c1), (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    x1_ref = jnp.maximum(x1_ref + jnp.asarray(b1), 0)

    gate = mrla_light_gate(t["out"], t["wq"], t["wk"], heads)
    w1_t = torch.from_numpy(np.ascontiguousarray(w1.T)).reshape(c1, c, 1, 1)
    y, x1 = mrla_block_tail_fused_next_reference(
        t["out"], t["identity"], gate, t["wv"], t["lam"], t["bn_scale"],
        t["bn_bias"], w1_t, torch.from_numpy(b1),
    )
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(x1.numpy(), np.asarray(x1_ref),
                               rtol=RTOL, atol=ATOL)


def test_cpu_tensors_take_the_plain_path_and_count():
    b, h, w, c, heads = SHAPES[0]
    t = _torch(_inputs(b, h, w, c, seed=4), c)
    fused_epilogue.counter.reset()
    mrla_block_tail_fused_next.counter.reset()

    y = mrla_light_epilogue(**t, heads=heads)
    torch.testing.assert_close(
        y, mrla_light_epilogue_reference(**t, heads=heads), rtol=0, atol=0)
    assert (fused_epilogue.counter.calls, fused_epilogue.counter.launches) \
        == (1, 0)

    gate = mrla_light_gate(t["out"], t["wq"], t["wk"], heads)
    w1, b1 = torch.randn(64, c), torch.randn(64)
    args = (t["out"], t["identity"], gate, t["wv"], t["lam"], t["bn_scale"],
            t["bn_bias"], w1, b1)
    got = mrla_block_tail_fused_next(*args)
    want = mrla_block_tail_fused_next_reference(*args)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=0, atol=0)
    counter = mrla_block_tail_fused_next.counter
    assert (counter.calls, counter.launches) == (1, 0)
    assert not counter.by_shape and not fused_epilogue.counter.by_shape


def test_launch_counter_counts_by_shape():
    counter = LaunchCounter()
    counter.calls += 3
    for key in [(2, 56, 56, 256, 64), (2, 56, 56, 256, 64), (2, 28, 28, 512, 128)]:
        counter.launch(key)
    assert counter.launches == 3
    assert counter.by_shape == {(2, 56, 56, 256, 64): 2, (2, 28, 28, 512, 128): 1}
    counter.reset()
    assert (counter.calls, counter.launches, dict(counter.by_shape)) == (0, 0, {})


def test_wrappers_reject_what_the_kernels_do_not_take():
    b, h, w, c, heads = SHAPES[0]
    t = _torch(_inputs(b, h, w, c, seed=5), c)
    gate = mrla_light_gate(t["out"], t["wq"], t["wk"], heads)
    rest = (t["wv"], t["lam"], t["bn_scale"], t["bn_bias"])
    with pytest.raises(ValueError, match="contiguous"):
        fused_epilogue(t["out"].transpose(1, 2), t["identity"], gate, *rest)
    with pytest.raises(ValueError, match="wv"):
        fused_epilogue(t["out"], t["identity"], gate,
                       t["wv"].reshape(c, 9), *rest[1:])
    with pytest.raises(ValueError, match="w1_next"):
        mrla_block_tail_fused_next(t["out"], t["identity"], gate, *rest,
                                   torch.zeros(64, c + 1), torch.zeros(64))
    meta = {k: v.to("meta") for k, v in t.items()}
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_epilogue(meta["out"], meta["identity"], gate.to("meta"),
                       meta["wv"], meta["lam"], meta["bn_scale"],
                       meta["bn_bias"])
