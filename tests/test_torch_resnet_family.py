"""The port's baseline ResNet / ResNeXt family (plain, SE, ECA, the dw
ablation) and its channel gates against the JAX package: ``se_gate`` /
``eca_gate``, ``SELayer`` / ``ECALayer``, each family at layers (1, 1, 1,
1) and 32 px in eval and in training (drop rates 0: the outputs and the
running statistics), the MRLA-base model with SE and with ECA, and the
weight bridge both ways.

Inputs and weights are made with seeded numpy (``numpy_variables``, which
the other model-zoo ``test_torch_*`` files share; the init's zero bn3
would leave every gate and the grouped 3x3 idle).  The Flax variables go
to the port through ``state_dict_from_jax``, and a port ``state_dict``
comes back unchanged through the JAX package's
``convert_resnet_state_dict``.  Tolerances: the gates as
``tests/test_torch_ops.py`` (rtol 1e-5, atol 1e-6); logits as the JAX
package's serving tests (rtol 2e-3, atol 3e-4); running statistics rtol
1e-4, atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrla_tpu import nn as jnn
from mrla_tpu import ops as jops
from mrla_tpu.ckpt import convert_resnet_state_dict
from mrla_tpu.models.resnet import ResNet as FlaxResNet
from mrla_tpu.models.resnet_mrla_base import ResNetMRLABase as FlaxMRLABase
from mrla_tpu_torch import ops as tops
from mrla_tpu_torch.ckpt import state_dict_from_jax
from mrla_tpu_torch.models import ResNet, ResNetMRLABase
from mrla_tpu_torch.nn import ECALayer, SELayer
from mrla_tpu_torch.serving import prepare_mrlab_inference_params
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

OPS = dict(rtol=1e-5, atol=1e-6)
LOGITS = dict(rtol=2e-3, atol=3e-4)
STATS = dict(rtol=1e-4, atol=1e-5)
LAYERS = (1, 1, 1, 1)

FAMILIES = {
    "plain": {},
    "se": {"se": True},
    "eca": {"eca": (5, 5, 5, 7)},
    "resnext": {"groups": 32, "width_per_group": 4, "se": True},
    "dw": {"dw_epilogue": True},
}


def numpy_variables(flax_model, px: int, seed: int = 0):
    """Flax variables of ``flax_model`` (at a ``px`` input) drawn from
    seeded numpy by leaf name: conv and Dense kernels N(0, 1/fan_in),
    biases N(0, 0.1); BN and LayerNorm scales and ResMLP alphas U(0.5,
    1.5), betas N(0, 0.3); layer scales U(0.05, 0.2); channel taps (ECA,
    MRLA Wq / Wk) U(-1, 1), λ N(0, 1), tokens N(0, 0.5); BN means N(0,
    0.1), variances U(0.5, 1.5).  No init runs (its zero bn3 and 1e-6
    layer scales would leave gates and blocks idle), so nothing compiles
    but the shapes' trace."""
    shapes = jax.eval_shape(lambda: flax_model.init(
        jax.random.key(0), jnp.zeros((1, px, px, 3)), train=False))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        names = [getattr(p, "key", "") for p in path]
        name, shape = names[-1], s.shape
        if names[0] == "batch_stats":
            x = (rng.uniform(0.5, 1.5, shape) if name == "var"
                 else rng.normal(0.0, 0.1, shape))
        elif name in ("kernel", "w1", "w2", "wv"):
            x = rng.normal(0.0, int(np.prod(shape[:-1])) ** -0.5, shape)
        elif name == "head_multi_kernel":  # [classes, C]
            x = rng.normal(0.0, shape[-1] ** -0.5, shape)
        elif name in ("scale", "alpha"):
            x = rng.uniform(0.5, 1.5, shape)
        elif name == "beta":
            x = rng.normal(0.0, 0.3, shape)
        elif "gamma" in name:
            x = rng.uniform(0.05, 0.2, shape)
        elif name in ("w", "wq", "wk"):
            x = rng.uniform(-1.0, 1.0, shape)
        elif name == "lambda_t":
            x = rng.normal(0.0, 1.0, shape)
        elif name in ("cls_token", "dist_token", "pos_embed"):
            x = rng.normal(0.0, 0.5, shape)
        else:  # biases
            x = rng.normal(0.0, 0.1, shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_forwards(flax_model):
    """A jitted (variables, eval images, train images) -> (eval logits,
    training logits, the batch statistics after them)."""
    def run(variables, x, x_train):
        logits = flax_model.apply(variables, x, train=False)
        out, upd = flax_model.apply(variables, x_train, train=True,
                                    mutable=["batch_stats"])
        return logits, out, upd.get("batch_stats", {})
    return jax.jit(run)


def images(seed, n=2, px=32):
    return np.random.default_rng(seed).standard_normal(
        (n, px, px, 3)).astype(np.float32)


def _pair(flax_model, port_model, px=32, seed=0):
    """(Flax variables, the port model on the same weights)."""
    variables = numpy_variables(flax_model, px, seed)
    port_model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return variables, port_model


def test_se_and_eca_gates_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 64)).astype(np.float32)
    w1 = rng.standard_normal((64, 4)).astype(np.float32) * 0.3
    w2 = rng.standard_normal((4, 64)).astype(np.float32) * 0.3
    taps = rng.uniform(-1, 1, 5).astype(np.float32)  # asymmetric
    got = tops.se_gate(torch.from_numpy(x), torch.from_numpy(w1.T.copy()),
                       torch.from_numpy(w2.T.copy()))
    want = jops.se_gate(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OPS)
    got = tops.eca_gate(torch.from_numpy(x), torch.from_numpy(taps))
    want = jops.eca_gate(jnp.asarray(x), jnp.asarray(taps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OPS)
    # the orientation: reversed taps give another gate
    flipped = tops.eca_gate(torch.from_numpy(x),
                            torch.from_numpy(taps[::-1].copy()))
    assert not np.allclose(flipped.numpy(), np.asarray(want), **OPS)


@pytest.mark.parametrize("kind", ["se", "eca"])
def test_gate_layers_match_flax(kind):
    x = images(2, px=4)[..., :1].repeat(64, -1) * np.linspace(
        -1, 1, 64, dtype=np.float32)
    if kind == "se":
        flax_layer, port = jnn.SELayer(), SELayer(64)
    else:
        flax_layer, port = jnn.ECALayer(), ECALayer(64)
    v = flax_layer.init(jax.random.key(0), jnp.asarray(x))["params"]
    if kind == "se":  # the converter's names: fc.0 / fc.2, [out, in]
        sd = {"fc.0.weight": np.asarray(v["w1"]).T,
              "fc.2.weight": np.asarray(v["w2"]).T}
    else:
        sd = {"conv.weight": np.asarray(v["w"]).reshape(1, 1, -1)}
    assert set(sd) == set(port.state_dict())
    port.load_state_dict({k: torch.from_numpy(np.array(a))
                          for k, a in sd.items()})
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    want = flax_layer.apply({"params": v}, jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **OPS)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_resnet_family_matches_flax(family):
    """Eval logits, then a training-mode forward (drop rates 0): its
    logits and every running statistic after it."""
    kw = FAMILIES[family]
    flax_model = FlaxResNet(layers=LAYERS, num_classes=10, **kw)
    variables, port = _pair(flax_model,
                            ResNet(LAYERS, num_classes=10, **kw))
    x, x_train = images(3), images(4, n=4)
    want, want_train, stats = jax_forwards(flax_model)(variables, x, x_train)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
        got_train = port.train()(torch.from_numpy(x_train))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    np.testing.assert_allclose(got_train.numpy(), np.asarray(want_train),
                               **LOGITS)
    want_sd = state_dict_from_jax({"params": variables["params"],
                                   "batch_stats": stats})
    for k, v in port.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(),
                                       **STATS, err_msg=k)


def test_features_only_gives_the_stage_maps():
    """``features_only``: no fc, the four stages' NHWC maps, the last of
    which the classifier pools."""
    gen = torch.Generator().manual_seed(1)
    full = ResNet(LAYERS, num_classes=10, se=True, generator=gen).eval()
    trunk = ResNet(LAYERS, se=True, features_only=True).eval()
    trunk.load_state_dict({k: v for k, v in full.state_dict().items()
                           if not k.startswith("fc.")}, strict=True)
    x = torch.from_numpy(images(6))
    with torch.no_grad():
        maps = trunk(x)
        logits = full(x)
    assert [tuple(m.shape) for m in maps] == [
        (2, 8, 8, 256), (2, 4, 4, 512), (2, 2, 2, 1024), (2, 1, 1, 2048)]
    torch.testing.assert_close(full.fc(maps[-1].mean(dim=(1, 2))), logits)


@pytest.mark.parametrize("gate", ["se", "eca"])
def test_mrlab_with_channel_gates_matches_flax(gate):
    kw = {"se": True} if gate == "se" else {"eca": (5, 5, 5, 7)}
    flax_model = FlaxMRLABase(layers=(1, 2), num_classes=10, **kw)
    variables, port = _pair(flax_model,
                            ResNetMRLABase((1, 2), num_classes=10, **kw))
    assert any(f".{gate}." in k for k in port.state_dict())
    x = images(5)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    want = jax.jit(lambda v, x: flax_model.apply(v, x, train=False))(
        variables, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    # the BN-folding engine has no gate to fold: it refuses the model
    with pytest.raises(ValueError, match="SE / ECA"):
        prepare_mrlab_inference_params(port, layers=(1, 2), device="cpu")


@pytest.mark.parametrize("family", ["se", "eca", "resnext", "dw"])
def test_weight_bridge_round_trips(family):
    """port state_dict -> the JAX converter -> ``state_dict_from_jax``:
    every entry comes back bitwise, with its shape."""
    gen = torch.Generator().manual_seed(0)
    port = ResNet(LAYERS, num_classes=10, generator=gen, **FAMILIES[family])
    sd = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    back = state_dict_from_jax(convert_resnet_state_dict(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    ResNet(LAYERS, num_classes=10, **FAMILIES[family]).load_state_dict(
        back, strict=True)
