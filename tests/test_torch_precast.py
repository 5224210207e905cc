"""The port's generic serving engine (``serving/precast.py``) against the
JAX package's ``precast_forward``: one arch of each new family (ResNeXt
with SE, EfficientNet-B0 with MRLA, ResMLP, PatchConvNet) and a plain
DeiT, in fp32 and in bf16; the leaves each keeps in fp32 against the JAX
rule (``_cast_tree``: any leaf under a module named ``*norm*`` or
``*bn*``), mapped through the weight bridge; ``microbatch`` chains bitwise
the unsplit forward; the registry against the JAX package's; the device
default and the archs it leaves to their own engines.

Weights and inputs from seeded numpy (``numpy_variables``; EfficientNet's
BN statistics from a pass over seeded images, its trunk cut to five
stages: ``five_stage_efficientnet``).  fp32 logits rtol 2e-3,
atol 3e-4 (``tests/test_serving.py``); bf16 against the JAX bf16 engine at
the port's DeiT engine's bf16 tolerance (atol 0.08, rtol 0.05,
``tests/test_torch_deit.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrla_tpu.models import list_models as jax_list_models
from mrla_tpu.models.deit import VisionTransformer as FlaxViT
from mrla_tpu.models.efficientnet_mrla import EfficientNet as FlaxEfficientNet
from mrla_tpu.models.patchconvnet import PatchConvNet as FlaxPatchConvNet
from mrla_tpu.models.resmlp import ResMLP as FlaxResMLP
from mrla_tpu.models.resnet import ResNet as FlaxResNet
from mrla_tpu.serving.deit import _cast_tree
from mrla_tpu.serving.deit import precast_forward as j_precast_forward
from mrla_tpu_torch.ckpt import (
    efficientnet_state_dict_from_jax,
    patchconvnet_state_dict_from_jax,
    resmlp_state_dict_from_jax,
    state_dict_from_jax,
    vit_state_dict_from_jax,
)
from mrla_tpu_torch.models import (
    EfficientNet,
    PatchConvNet,
    ResMLP,
    ResNet,
    VisionTransformer,
    list_models,
)
from mrla_tpu_torch.serving import (
    precast_forward,
    prepare_precast_inference_params,
)
from tests.test_torch_efficientnet import NO_DROP, _calibrated
from tests.test_torch_resnet_family import images, numpy_variables
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

FP32 = dict(rtol=2e-3, atol=3e-4)
BF16 = dict(rtol=0.05, atol=0.08)
RESNEXT = dict(se=True, groups=32, width_per_group=4)
VIT = dict(embed_dim=64, depth=2, num_heads=2, num_classes=10)

# family -> (Flax model of a dtype, port model, px, bridge)
FAMILIES = {
    "resnext_se": (
        lambda dt: FlaxResNet(layers=(1, 1, 1, 1), num_classes=10,
                              dtype=dt, **RESNEXT),
        lambda: ResNet((1, 1, 1, 1), 10, **RESNEXT), 32,
        state_dict_from_jax),
    "efficientnet_mrlal": (
        lambda dt: FlaxEfficientNet(num_classes=10, use_mrla=True,
                                    dtype=dt, **NO_DROP),
        lambda: EfficientNet(10, use_mrla=True, **NO_DROP), 64,
        efficientnet_state_dict_from_jax),
    "resmlp": (
        lambda dt: FlaxResMLP(embed_dim=64, depth=2, num_classes=10,
                              dtype=dt),
        lambda: ResMLP(img_size=64, embed_dim=64, depth=2, num_classes=10),
        64, resmlp_state_dict_from_jax),
    "patchconvnet": (
        lambda dt: FlaxPatchConvNet(embed_dim=64, depth=2, num_classes=10,
                                    dtype=dt),
        lambda: PatchConvNet(10, 64, 2), 64,
        patchconvnet_state_dict_from_jax),
    "deit_plain": (
        lambda dt: FlaxViT(dtype=dt, **VIT),
        lambda: VisionTransformer(img_size=64, **VIT), 64,
        lambda v: vit_state_dict_from_jax(v, "plain")),
}


@pytest.fixture(autouse=True)
def five_stage_efficientnet(monkeypatch):
    """EfficientNet-B0's first five stages (its full depth is held to Flax
    in tests/test_torch_efficientnet.py).  At a test's 64 px its last two
    stages run on 2 x 2 maps, whose BN statistics (eps 1e-3) make the
    random-weight trunk amplify bf16 rounding to 40% of the logits in both
    packages alike (each 0.74 to 0.95 from its own fp32 forward); on the
    first five each package's bf16 is 0.04 from its fp32."""
    import mrla_tpu.models.efficientnet_mrla as jeff
    import mrla_tpu_torch.models.efficientnet_mrla as teff

    for mod in (jeff, teff):
        monkeypatch.setattr(mod, "B0_BLOCKS", mod.B0_BLOCKS[:5])


def _setup(family):
    flax_model, port_model, px, bridge = FAMILIES[family]
    variables = numpy_variables(flax_model(jnp.float32), px)
    port = port_model()
    port.load_state_dict(bridge(variables), strict=True)
    if family.startswith("efficientnet"):
        variables = _calibrated(port, variables)
    return variables, port, px, bridge


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_precast_matches_jax(family, precision):
    """The served logits against the JAX engine's at one precision."""
    dt, tdt, tol = {"fp32": (jnp.float32, torch.float32, FP32),
                    "bf16": (jnp.bfloat16, torch.bfloat16, BF16)}[precision]
    variables, port, px, bridge = _setup(family)
    x = images(1, n=4, px=px)
    cast = {**variables, "params": _cast_tree(variables["params"], dt)}
    want = np.asarray(j_precast_forward(
        FAMILIES[family][0](dt), cast, jnp.asarray(x, dt), microbatch=0))
    model = prepare_precast_inference_params(port, port.state_dict(),
                                             device="cpu", dtype=tdt)
    got = precast_forward(model, torch.from_numpy(x).to(tdt))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **tol)
    assert want.std(0).mean() > 1e-2  # the images differ


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fp32_leaves_are_the_jax_rule(family):
    """A leaf the JAX engine keeps fp32 lands on a port tensor the port's
    engine keeps fp32, and no other: markers (1 for fp32) through the
    weight bridge against the served model's dtypes."""
    variables, port, _, bridge = _setup(family)
    cast = _cast_tree(variables["params"], jnp.bfloat16)
    marks = jax.tree.map(
        lambda a: np.full(a.shape, a.dtype == jnp.float32, np.float32), cast)
    stats = jax.tree.map(lambda a: np.ones(a.shape, np.float32),
                         variables.get("batch_stats", {}))
    want = bridge({"params": marks, "batch_stats": stats})
    served = prepare_precast_inference_params(port, device="cpu")
    got = served.state_dict()
    assert set(want) == set(got)
    kept = 0
    for k, m in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert bool(m.all()) or not bool(m.any()), k
        assert (got[k].dtype == torch.float32) == bool(m.all()), k
        kept += bool(m.all())
    assert kept > 0
    assert port.state_dict()[k].dtype == torch.float32  # the caller's copy


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_microbatch_chains_are_bitwise(family, dtype):
    _, port, px, _ = _setup(family)
    model = prepare_precast_inference_params(port, device="cpu",
                                             dtype=dtype)
    x = torch.from_numpy(images(2, n=8, px=px)).to(dtype)
    unsplit = precast_forward(model, x)
    assert torch.equal(precast_forward(model, x, microbatch=2), unsplit)
    assert torch.equal(precast_forward(model, x, microbatch=3), unsplit)


def test_registry_is_the_jax_registry():
    assert set(list_models()) == set(jax_list_models())
    assert len(list_models()) == 53


def test_entry_defaults_to_the_card_and_leaves_dedicated_archs():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            prepare_precast_inference_params(ResMLP(img_size=32, depth=1))
    # the DeiT-MRLA archs go to serving/deit.py (the token-tail kernel);
    # the resnet mrlal / mrlab archs are served here on an explicit
    # --engine precast of the eval CLI
    with pytest.raises(ValueError, match="own serving engine"):
        prepare_precast_inference_params("deit_mrlal_tiny_patch16_224",
                                         device="cpu", num_classes=10)
    for arch in ("resnet50_mrlal", "resnet50_mrlab"):
        served = prepare_precast_inference_params(arch, device="cpu",
                                                  num_classes=10)
        assert served.fc.weight.dtype == torch.bfloat16
        assert served.bn1.weight.dtype == torch.float32
    model = prepare_precast_inference_params("resnet50_dw", device="cpu",
                                             num_classes=10)
    assert model.conv1.weight.dtype == torch.bfloat16
    assert model.layer1[0].dwconv.weight.dtype == torch.bfloat16
    for t in (model.bn1.weight, model.bn1.running_var,
              model.layer1[0].bn_dw.bias, model.layer1[0].downsample[1].bias):
        assert t.dtype == torch.float32
    assert not model.training


def test_bridge_dispatch_covers_every_arch():
    """``converter_for`` sends each of the 53 archs to its family's
    converter (the JAX ``hub.convert_torch_state_dict`` sends
    ``efficientnet*`` to the ResNet converter, which cannot read it), by
    the module that registers the arch."""
    from mrla_tpu_torch.ckpt import converter_for
    from mrla_tpu_torch.models.registry import _REGISTRY

    family = {
        "resnet": state_dict_from_jax,
        "resnet_mrla_light": state_dict_from_jax,
        "resnet_mrla_base": state_dict_from_jax,
        "resnet_la_eq4": state_dict_from_jax,
        "efficientnet_mrla": efficientnet_state_dict_from_jax,
        "resmlp": resmlp_state_dict_from_jax,
        "patchconvnet": patchconvnet_state_dict_from_jax,
    }
    variant = {"deit": "plain", "deit_mrla": None}
    for arch, factory in _REGISTRY.items():
        module = factory.__module__.rsplit(".", 1)[-1]
        conv = converter_for(arch)
        if module in family:
            assert conv is family[module], arch
        else:
            assert conv.func is vit_state_dict_from_jax, arch
            want = variant[module] or ("light" if "_mrlal" in arch
                                       else "base")
            assert conv.keywords == {"variant": want}, arch
    assert len(_REGISTRY) == 53
