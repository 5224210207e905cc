"""The port's int8 PTQ engine (``mrla_tpu_torch/serving/quant.py``) against
the JAX package's (``mrla_tpu/serving/quant.py``).

One Flax init (layers 1-1-1-1, BN statistics perturbed, as the JAX test's
``_setup``) feeds both packages.  The forwards are compared on one quant
tree (the JAX tree carried across by ``quant_params_from_jax``), and the
port's ``prepare_quant_params`` against the JAX function's on the same
weights and calibration batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrla_tpu.models.resnet_mrla_light import ResNetMRLALight as FlaxResNet
from mrla_tpu.serving.quant import (
    prepare_quant_params as j_prepare_quant,
    resnet_mrlal_quant_forward as j_quant_forward,
)
from mrla_tpu_torch.ckpt import quant_params_from_jax, state_dict_from_jax
from mrla_tpu_torch.kernels import fused_epilogue
from mrla_tpu_torch.serving import (
    prepare_inference_params,
    resnet_mrlal_forward,
)
from mrla_tpu_torch.serving.quant import (
    _int_mm,
    _qconv,
    _percentile,
    prepare_quant_params,
    resnet_mrlal_quant_forward,
)
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

LAYERS = (1, 1, 1, 1)
FORMS = [(False, True), (True, True), (False, False)]  # (qe, qres)
LOGIT_TOL = 0.02  # of the logit scale: tests/test_serving_quant.py's bar


@pytest.fixture(scope="module")
def setup():
    """The JAX test's _setup: a Flax init with perturbed BN statistics, a
    calibration batch and a request batch; the JAX quant trees at absmax
    and at p99.9."""
    model = FlaxResNet(layers=list(LAYERS), num_classes=10)
    variables = jax.device_get(jax.jit(lambda key: model.init(
        key, jnp.zeros((1, 64, 64, 3)), train=False))(jax.random.key(0)))
    rng = np.random.default_rng(0)
    stats = jax.tree.map(
        lambda v: v + rng.uniform(0.1, 0.5, v.shape).astype(v.dtype),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    calib = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    x = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    qp = {q: jax.device_get(j_prepare_quant(
        variables, jnp.asarray(calib), layers=LAYERS, dim_perhead=32,
        percentile=q)) for q in (100.0, 99.9)}
    return {"variables": variables, "calib": calib, "x": x, "qp": qp,
            "sd": state_dict_from_jax(variables)}


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def test_int8_conv_exact_vs_numpy():
    """The im2col product is exact integer arithmetic plus one dequant
    multiply, at stride 1 and 2, and the 1x1 product over 2,048 channels
    (sums past 2^24) is exact in int32."""
    rng = np.random.default_rng(3)
    x = rng.integers(-127, 128, (2, 7, 6, 8)).astype(np.int8)
    k = rng.integers(-127, 128, (3, 3, 8, 16)).astype(np.int8)  # HWIO
    m = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    b = rng.uniform(-1, 1, 16).astype(np.float32)
    kq = torch.from_numpy(np.ascontiguousarray(
        k.transpose(3, 0, 1, 2).reshape(16, -1)))
    xp = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    for stride in (1, 2):
        ho, wo = (7 - 1) // stride + 1, (6 - 1) // stride + 1
        acc = np.zeros((2, ho, wo, 16), np.int64)
        for i in range(ho):
            for j in range(wo):
                patch = xp[:, i * stride:i * stride + 3,
                           j * stride:j * stride + 3, :]
                acc[:, i, j] = np.einsum("bhwc,hwco->bo", patch,
                                         k.astype(np.int64))
        want = acc.astype(np.float32) * m + b
        got = _qconv(torch.from_numpy(x), kq, torch.from_numpy(m),
                     torch.from_numpy(b), stride=stride).numpy()
        np.testing.assert_array_equal(got, want)
    a = rng.integers(-127, 128, (40, 2048)).astype(np.int8)
    w = np.full((24, 2048), 127, np.int8)
    a[0] = 127  # 2048 · 127² > 2^24
    got = _int_mm(torch.from_numpy(a), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(
        got, a.astype(np.int64) @ w.astype(np.int64).T)
    assert got.dtype == np.int32 and got[0, 0] == 2048 * 127 * 127


@pytest.mark.parametrize("qe,qres", FORMS)
def test_forward_on_one_tree_matches_jax(setup, qe, qres):
    qp = setup["qp"][100.0]
    want = np.asarray(j_quant_forward(
        qp, jnp.asarray(setup["x"]), layers=LAYERS, microbatch=0,
        quant_epilogue=qe, quant_residual=qres))
    tqp = quant_params_from_jax(qp, device="cpu")
    fused_epilogue.counter.reset()
    got = resnet_mrlal_quant_forward(
        tqp, torch.from_numpy(setup["x"]), layers=LAYERS, microbatch=0,
        quant_epilogue=qe, quant_residual=qres).numpy()
    assert _rel(got, want) < LOGIT_TOL, _rel(got, want)
    # the bf16 epilogue goes through the kernel's wrapper, one call a block
    assert fused_epilogue.counter.calls == (0 if qe else sum(LAYERS))


@pytest.mark.parametrize("q", [100.0, 99.9])
def test_prepare_quant_params_matches_jax(setup, q):
    """int8 kernels equal but for ±1 flips where the bf16 BN fold or the
    scale rounds otherwise (counted, and at most 0.5% of the entries);
    every scale within rtol 1e-2; the same at the p99.9 calibration."""
    want = quant_params_from_jax(setup["qp"][q], device="cpu")
    got = prepare_quant_params(setup["sd"], setup["calib"], layers=LAYERS,
                               dim_perhead=32, percentile=q, device="cpu")
    np.testing.assert_allclose(got["inv_a_stem"].numpy(),
                               want["inv_a_stem"].numpy(), rtol=1e-2)
    flips = total = 0
    for g, w in zip(got["blocks"], want["blocks"]):
        assert set(g) == set(w)
        for name, t in w.items():
            if t.dtype == torch.int8:
                d = (g[name].long() - t.long()).abs()
                assert int(d.max()) <= 1, name
                flips += int((d > 0).sum())
                total += d.numel()
            else:
                np.testing.assert_allclose(g[name].numpy(), t.numpy(),
                                           rtol=1e-2, atol=1e-6,
                                           err_msg=name)
    assert flips <= 0.005 * total, (flips, total)


def test_percentile_above_2_24_elements():
    """torch.quantile refuses this size; the kthvalue percentile is
    jnp.percentile's linear interpolation."""
    rng = np.random.default_rng(1)
    a = np.abs(rng.standard_normal((1 << 24) + 1001)).astype(np.float32)
    got = float(_percentile(torch.from_numpy(a), 99.9))
    want = float(np.percentile(a, 99.9))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("qe,qres", FORMS)
def test_chains_bitwise_unsplit(setup, qe, qres):
    tqp = quant_params_from_jax(setup["qp"][100.0], device="cpu")
    x = torch.from_numpy(setup["x"])
    full = resnet_mrlal_quant_forward(tqp, x, layers=LAYERS, microbatch=0,
                                      quant_epilogue=qe, quant_residual=qres)
    split = resnet_mrlal_quant_forward(tqp, x, layers=LAYERS, microbatch=2,
                                       quant_epilogue=qe,
                                       quant_residual=qres)
    np.testing.assert_array_equal(full.numpy(), split.numpy())


@pytest.mark.parametrize("qe,qres", FORMS)
def test_close_to_fp32_engine(setup, qe, qres):
    """PTQ is lossy: close to the port's fp32 engine on the same weights
    with the same top-1 on every row (the JAX test's bounds)."""
    sp = prepare_inference_params(setup["sd"], layers=LAYERS,
                                  dtype=torch.float32, device="cpu")
    x = torch.from_numpy(setup["x"])
    ref = resnet_mrlal_forward(sp, x, layers=LAYERS).numpy()
    qp = prepare_quant_params(setup["sd"], setup["calib"], layers=LAYERS,
                              device="cpu")
    got = resnet_mrlal_quant_forward(qp, x, layers=LAYERS, microbatch=0,
                                     quant_epilogue=qe,
                                     quant_residual=qres).numpy()
    assert _rel(got, ref) < (0.05 if not qres else 0.15)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
