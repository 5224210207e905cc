"""The port's resnet_mrlal model and serving engine against the JAX package.

One init feeds both packages: the Flax variables go to the port through
``state_dict_from_jax``, and the port's own init goes to Flax through the
JAX package's ``convert_resnet_state_dict``.  BN statistics and the bn3
scale are perturbed so that BN folding and every block's residual branch
do work.  Tolerances follow the JAX package's serving tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrla_tpu.ckpt import convert_resnet_state_dict
from mrla_tpu.models.resnet_mrla_light import ResNetMRLALight as FlaxResNet
from mrla_tpu.serving import (
    prepare_inference_params as j_prepare,
    resnet_mrlal_forward as j_forward,
)
from mrla_tpu_torch.ckpt import state_dict_from_jax
from mrla_tpu_torch.kernels import fused_epilogue, mrla_block_tail_fused_next
from mrla_tpu_torch.models import ResNetMRLALight, create_model
from mrla_tpu_torch.serving import (
    prepare_inference_params,
    resnet_mrlal_forward,
)
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

RTOL, ATOL = 2e-3, 3e-4


def _perturb(variables, seed):
    """Shift every BN's stats and give bn3 a non-zero scale (numpy tree)."""
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(
        lambda v: v + rng.uniform(0.1, 0.5, v.shape).astype(v.dtype),
        variables["batch_stats"],
    )
    params = jax.tree.map(np.asarray, variables["params"])
    for name, blk in params.items():
        if name.startswith("layer"):
            blk["bn3"]["scale"] = rng.uniform(
                0.1, 0.5, blk["bn3"]["scale"].shape).astype(np.float32)
    return {"params": params, "batch_stats": stats}


def _flax_variables(layers, px, seed, num_classes=10):
    model = FlaxResNet(layers=list(layers), num_classes=num_classes)
    variables = jax.device_get(jax.jit(lambda key: model.init(
        key, jnp.zeros((1, px, px, 3)), train=False))(jax.random.key(seed)))
    return model, _perturb(variables, seed)


def _flax_logits(model, variables, x):
    return np.asarray(model.apply(jax.tree.map(jnp.asarray, variables),
                                  jnp.asarray(x), train=False))


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]),
                                          err_msg=f"{path}/{k}")


def test_state_dict_from_jax_roundtrip():
    model, variables = _flax_variables((1, 2, 1, 1), 32, seed=0)
    sd = state_dict_from_jax(variables)
    _assert_trees_equal(convert_resnet_state_dict(sd), variables)
    # and the keys are exactly the port model's
    ResNetMRLALight([1, 2, 1, 1], num_classes=10).load_state_dict(sd,
                                                                  strict=True)


@pytest.mark.parametrize("init", ["flax", "torch"])
def test_model_matches_flax(init):
    layers = (1, 1, 1, 1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    if init == "flax":
        flax_model, variables = _flax_variables(layers, 64, seed=1)
        port = ResNetMRLALight(list(layers), num_classes=10)
        port.load_state_dict(state_dict_from_jax(variables))
    else:
        port = ResNetMRLALight(list(layers), num_classes=10,
                               generator=torch.Generator().manual_seed(1))
        variables = _perturb(convert_resnet_state_dict(port.state_dict()), 1)
        port.load_state_dict(state_dict_from_jax(variables))
        flax_model = FlaxResNet(layers=list(layers), num_classes=10)
    want = _flax_logits(flax_model, variables, x)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_serving_fp32_matches_jax_engine_and_flax_with_routing():
    """112 px, layers (2, 2, 1, 1): stage 1 is 28 wide, so layer1_0 and
    layer1_1 (whose next conv1 is layer2_0's, C1=128) take the mega-tail;
    the four narrower blocks take the epilogue."""
    layers = (2, 2, 1, 1)
    flax_model, variables = _flax_variables(layers, 112, seed=2)
    x = np.random.default_rng(2).standard_normal((2, 112, 112, 3)).astype(
        np.float32)
    want_flax = _flax_logits(flax_model, variables, x)
    want_engine = np.asarray(j_forward(
        j_prepare(variables, layers=layers, dtype=jnp.float32),
        jnp.asarray(x), layers=layers, use_pallas=False))

    sp = prepare_inference_params(state_dict_from_jax(variables),
                                  layers=layers, dtype=torch.float32,
                                  device="cpu")
    fused_epilogue.counter.reset()
    mrla_block_tail_fused_next.counter.reset()
    got = resnet_mrlal_forward(sp, torch.from_numpy(x), layers=layers).numpy()
    assert mrla_block_tail_fused_next.counter.calls == 2
    assert fused_epilogue.counter.calls == 4
    assert mrla_block_tail_fused_next.counter.launches == 0
    assert fused_epilogue.counter.launches == 0
    np.testing.assert_allclose(got, want_engine, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want_flax, rtol=RTOL, atol=ATOL)


def test_serving_bf16_agrees_on_predictions():
    layers = (1, 1, 1, 1)
    flax_model, variables = _flax_variables(layers, 64, seed=3)
    x = np.random.default_rng(3).standard_normal((4, 64, 64, 3)).astype(
        np.float32)
    want = _flax_logits(flax_model, variables, x)
    sp = prepare_inference_params(state_dict_from_jax(variables),
                                  layers=layers, dtype=torch.bfloat16,
                                  device="cpu")
    got = resnet_mrlal_forward(sp, torch.from_numpy(x), layers=layers)
    assert got.dtype == torch.float32
    assert (got.numpy().argmax(-1) == want.argmax(-1)).all()


def test_prepare_guards_the_layer_set():
    sd = ResNetMRLALight([1, 1, 1, 1], num_classes=10).state_dict()
    with pytest.raises(ValueError, match="does not match"):
        prepare_inference_params(sd, layers=(1, 2, 1, 1), device="cpu")


def test_entry_points_need_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sd = ResNetMRLALight([1, 1, 1, 1], num_classes=10).state_dict()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_inference_params(sd, layers=(1, 1, 1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("resnet50_mrlal", num_classes=10)


def test_port_init_matches_the_jax_init_recipe():
    g = torch.Generator().manual_seed(0)
    model = create_model("resnet50_mrlal", device="cpu", generator=g)
    again = create_model("resnet50_mrlal", device="cpu",
                         generator=torch.Generator().manual_seed(0))
    for (k, v), v2 in zip(model.state_dict().items(),
                          again.state_dict().values()):
        assert torch.equal(v, v2), k
    blk = model.layer3[0]
    assert torch.count_nonzero(blk.bn3.weight) == 0  # zero-init bn3
    lam = torch.cat([m.mrla.lambda_t.flatten() for m in model.modules()
                     if isinstance(m, type(blk))])
    assert abs(lam.mean().item()) < 0.05 and abs(lam.std().item() - 1) < 0.05
    wq = blk.mrla.mrla.Wq.weight
    assert wq.shape == (1, 1, 5) and wq.abs().max() <= 1 / 5 ** 0.5
    wv = blk.mrla.mrla.Wv.weight  # kaiming normal, fan_out = 1024 * 9
    assert abs(wv.std().item() / (2 / (1024 * 9)) ** 0.5 - 1) < 0.05


def test_entry_serves_resnet50_mrlal_in_bf16():
    import mrla_tpu_torch

    fn, (params, x) = mrla_tpu_torch.entry(device="cpu")
    assert x.shape == (8, 224, 224, 3) and x.dtype == torch.bfloat16
    assert params["stem"]["k"].dtype == torch.bfloat16
    logits = fn(params, x[:2, :64, :64])  # a smaller view on the CPU
    assert logits.shape == (2, 1000) and torch.isfinite(logits).all()


def test_entry_needs_a_card_unless_asked():
    import mrla_tpu_torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mrla_tpu_torch.entry()


@pytest.mark.parametrize("shared_stem", [True, False])
def test_microbatch_chains_bitwise_equal(shared_stem):
    """Chains of 4 images, the stem shared or not, give the unsplit logits
    bit for bit on the CPU (the JAX engine's guarantee,
    tests/test_serving.py::test_microbatch_chains_bitwise_equal)."""
    model = create_model("resnet50_mrlal", device="cpu", num_classes=10,
                         generator=torch.Generator().manual_seed(4))
    sp = prepare_inference_params(model, dtype=torch.float32, device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (16, 64, 64, 3)).astype(np.float32))
    full = resnet_mrlal_forward(sp, x)
    fused_epilogue.counter.reset()
    split = resnet_mrlal_forward(sp, x, microbatch=4,
                                 shared_stem=shared_stem)
    assert fused_epilogue.counter.calls == 4 * 16  # every chain's blocks
    assert torch.equal(full, split)
