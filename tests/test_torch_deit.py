"""The port's DeiT models and serving engine against the JAX package.

One set of weights feeds both packages: the port's own init, spread by
``spread_deit_weights`` so that LayerNorm affines, gates and heads do work,
goes to Flax through the JAX package's ``convert_vit_state_dict``; a Flax
init goes to the port through ``vit_state_dict_from_jax``.  Models are
built from the classes at a small size (embed 64, depth 2, 2 heads; the
MRLA-base variant at depth 6, so that its cache restarts once at block 4
and block 5's attention carries that block's grid rows to the cls row) at
224 px, so N = 197 as at full size.  fp32 tolerances are the resnet
slice's (``rtol=2e-3, atol=3e-4``); the bf16 one is the JAX package's
serving test's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrla_tpu.ckpt.torch_convert import convert_vit_state_dict
from mrla_tpu.models.deit import VisionTransformer as FlaxViT
from mrla_tpu.models.deit_mrla import ViTMRLA as FlaxViTMRLA
from mrla_tpu.serving.deit import deit_forward as j_deit_forward
from mrla_tpu_torch.ckpt import vit_state_dict_from_jax
from mrla_tpu_torch.kernels import deit_token_tail
from mrla_tpu_torch.models import (
    ViTMRLA,
    VisionTransformer,
    create_model,
    list_models,
)
from mrla_tpu_torch.serving import deit_forward, prepare_deit_inference_params
from mrla_tpu_torch.testing import spread_deit_weights
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

RTOL, ATOL = 2e-3, 3e-4
SMALL = dict(embed_dim=64, depth=2, num_heads=2, num_classes=10)
# kind -> (port class, Flax class, extra arguments, converter variant)
KINDS = {
    "plain": (VisionTransformer, FlaxViT, {}, "plain"),
    "distilled": (VisionTransformer, FlaxViT, {"distilled": True}, "plain"),
    "light": (ViTMRLA, FlaxViTMRLA, {}, "light"),
    "base": (ViTMRLA, FlaxViTMRLA, {"variant": "base", "depth": 6}, "base"),
}


def _kw(kind):
    return {**SMALL, **KINDS[kind][2]}


def _port_model(kind, seed):
    gen = torch.Generator().manual_seed(seed)
    return spread_deit_weights(KINDS[kind][0](**_kw(kind), generator=gen),
                               gen).eval()


def _flax_model(kind, dtype=jnp.float32):
    return KINDS[kind][1](**_kw(kind), dtype=dtype)


def _to_flax(port, kind):
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    return convert_vit_state_dict(sd, variant=KINDS[kind][3])


def _images(seed, n=2):
    return np.random.default_rng(seed).standard_normal(
        (n, 224, 224, 3)).astype(np.float32)


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]),
                                          err_msg=f"{path}/{k}")


@pytest.mark.parametrize("kind", list(KINDS))
def test_vit_state_dict_from_jax_roundtrip(kind):
    port_cls, _, extra, variant = KINDS[kind]
    variables = jax.device_get(_flax_model(kind).init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3)), train=False))
    sd = vit_state_dict_from_jax(variables, variant)
    _assert_trees_equal(convert_vit_state_dict(sd, variant), variables)
    # and the keys and shapes are exactly the port model's
    port_cls(**_kw(kind)).load_state_dict(sd, strict=True)


def test_vit_state_dict_from_jax_rejects_a_wrong_variant():
    variables = jax.device_get(_flax_model("light").init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3)), train=False))
    with pytest.raises(ValueError, match="does not fit"):
        vit_state_dict_from_jax(variables, "plain")
    with pytest.raises(ValueError, match="variant"):
        vit_state_dict_from_jax(variables, "base")


@pytest.mark.parametrize("kind", list(KINDS))
def test_model_matches_flax(kind):
    port = _port_model(kind, seed=1)
    variables = _to_flax(port, kind)
    x = _images(1)
    want = np.asarray(_flax_model(kind).apply(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    assert want.std() > 1e-2  # logits that differ from class to class
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_model_from_a_flax_init_matches_flax():
    flax_model = _flax_model("light")
    variables = jax.device_get(flax_model.init(
        jax.random.key(2), jnp.zeros((1, 224, 224, 3)), train=False))
    port = ViTMRLA(**SMALL).eval()
    port.load_state_dict(vit_state_dict_from_jax(variables, "light"))
    x = _images(2)
    want = np.asarray(flax_model.apply(variables, jnp.asarray(x),
                                       train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["light", "distilled", "base"])
def test_engine_fp32_matches_jax_engine(kind):
    port = _port_model(kind, seed=3)
    variables = jax.tree.map(jnp.asarray, _to_flax(port, kind))
    x = _images(3)
    want = np.asarray(j_deit_forward(_flax_model(kind), variables,
                                     jnp.asarray(x), microbatch=0))
    params = prepare_deit_inference_params(port, device="cpu",
                                           dtype=torch.float32)
    deit_token_tail.counter.reset()
    got = deit_forward(params, torch.from_numpy(x))
    assert got.dtype == torch.float32
    # every block's tail goes through the wrapper; no launch on the CPU
    counter = deit_token_tail.counter
    assert (counter.calls, counter.launches) == (
        SMALL["depth"] if kind == "light" else 0, 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    with torch.no_grad():  # and the engine is the model
        np.testing.assert_allclose(got.numpy(),
                                   port(torch.from_numpy(x)).numpy(),
                                   rtol=RTOL, atol=ATOL)


def test_engine_bf16_matches_jax_bf16_engine():
    port = _port_model("light", seed=4)
    variables = jax.tree.map(jnp.asarray, _to_flax(port, "light"))
    x = _images(4)
    from mrla_tpu.serving.deit import _cast_tree

    cast = {"params": _cast_tree(variables["params"], jnp.bfloat16)}
    want = np.asarray(j_deit_forward(
        _flax_model("light", jnp.bfloat16), cast,
        jnp.asarray(x, jnp.bfloat16), microbatch=0))
    params = prepare_deit_inference_params(port, device="cpu")
    assert params["blocks"][0]["qkv"][0].dtype == torch.bfloat16
    # LayerNorm affines and the tail's vectors stay fp32
    assert params["blocks"][0]["norm1"][0].dtype == torch.float32
    assert params["norm"][1].dtype == torch.float32
    assert params["blocks"][1]["tail"].vec.dtype == torch.float32
    got = deit_forward(params, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=0.08, rtol=0.05)


def test_prepare_from_an_arch_name_and_a_state_dict():
    src = create_model("deit_mrlal_tiny_patch16_224", device="cpu",
                       num_classes=7,
                       generator=torch.Generator().manual_seed(5))
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}
    params = prepare_deit_inference_params(
        "deit_mrlal_tiny_patch16_224", sd, device="cpu", dtype=torch.float32,
        num_classes=7)
    assert len(params["blocks"]) == 12 and params["dim_mrla"] == 16
    assert params["blocks"][11]["tail"].vec.shape == (14, 192)
    x = torch.from_numpy(_images(5, n=1))
    with torch.no_grad():
        want = src.eval()(x)
    torch.testing.assert_close(deit_forward(params, x), want, rtol=RTOL,
                               atol=ATOL)
    sd.pop("module.blocks.3.mrla.lambda_t")
    with pytest.raises(ValueError, match="does not match"):
        prepare_deit_inference_params("deit_mrlal_tiny_patch16_224", sd,
                                      device="cpu", num_classes=7)


def test_entry_points_need_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("deit_mrlal_tiny_patch16_224", num_classes=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_deit_inference_params(ViTMRLA(**SMALL))
    params = prepare_deit_inference_params(ViTMRLA(**SMALL), device="cpu")
    with pytest.raises(ValueError, match="images are on"):
        deit_forward(params, torch.zeros(1, 224, 224, 3, device="meta"))


# arch -> (embed, heads, patch, px, distilled, MRLA heads or None)
ARCHS = {
    "deit_tiny_patch16_224": (192, 3, 16, 224, False, None),
    "deit_small_patch16_224": (384, 6, 16, 224, False, None),
    "deit_base_patch16_224": (768, 12, 16, 224, False, None),
    "deit_tiny_patch8_224": (192, 3, 8, 224, False, None),
    "deit_tiny_distilled_patch16_224": (192, 3, 16, 224, True, None),
    "deit_small_distilled_patch16_224": (384, 6, 16, 224, True, None),
    "deit_base_distilled_patch16_224": (768, 12, 16, 224, True, None),
    "deit_base_patch16_384": (768, 12, 16, 384, False, None),
    "deit_base_distilled_patch16_384": (768, 12, 16, 384, True, None),
    "deit_mrlal_tiny_patch16_224": (192, 3, 16, 224, False, 12),
    "deit_mrlal_small_patch16_224": (384, 6, 16, 224, False, 24),
    "deit_mrlal_base_patch16_224": (768, 12, 16, 224, False, 48),
}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_registered_archs_have_the_published_widths(arch):
    embed, heads, patch, px, distilled, mrla_heads = ARCHS[arch]
    assert arch in list_models()
    with torch.device("meta"):  # shapes only: no weight is drawn
        model = create_model(arch, device="meta")
    assert len(model.blocks) == 12 and model.num_heads == heads
    assert model.distilled == distilled
    tokens = (px // patch) ** 2 + (2 if distilled else 1)
    assert model.pos_embed.shape == (1, tokens, embed)
    assert model.patch_embed.proj.weight.shape == (embed, 3, patch, patch)
    assert model.blocks[0].mlp.fc1.weight.shape == (4 * embed, embed)
    assert model.blocks[0].attn.qkv.weight.shape == (3 * embed, embed)
    assert model.head.weight.shape == (1000, embed)
    assert hasattr(model, "head_dist") == distilled
    assert model.norm.eps == 1e-6 and model.blocks[0].norm1.eps == 1e-6
    if mrla_heads is None:
        assert not hasattr(model.blocks[0], "mrla")
    else:
        tail = model.blocks[0].mrla
        assert tail.mrla.heads == mrla_heads
        assert tail.mrla.Wq.weight.shape == (1, 1, 5)
        assert tail.lambda_t.shape == (embed,)
        assert tail.normx.eps == 1e-6


def test_port_init_matches_the_jax_init_recipe():
    g = torch.Generator().manual_seed(0)
    model = ViTMRLA(embed_dim=192, depth=2, num_heads=3, generator=g)
    again = ViTMRLA(embed_dim=192, depth=2, num_heads=3,
                    generator=torch.Generator().manual_seed(0))
    for (k, v), v2 in zip(model.state_dict().items(),
                          again.state_dict().values()):
        assert torch.equal(v, v2), k
    w = model.blocks[1].mlp.fc1.weight  # truncated normal, std 0.02
    assert w.abs().max() <= 0.04 and abs(w.std().item() / 0.02 - 0.88) < 0.05
    assert model.pos_embed.abs().max() <= 0.04
    assert torch.count_nonzero(model.blocks[0].attn.qkv.bias) == 0
    assert torch.equal(model.norm.weight, torch.ones(192))
    lam = torch.cat([b.mrla.lambda_t for b in model.blocks])
    assert abs(lam.mean().item()) < 0.15 and abs(lam.std().item() - 1) < 0.1
    # dropout and DropPath rates are stored and the eval forward ignores them
    dropped = ViTMRLA(**SMALL, drop_rate=0.1, attn_drop_rate=0.1,
                      drop_path_rate=0.2,
                      generator=torch.Generator().manual_seed(1)).eval()
    kept = ViTMRLA(**SMALL, generator=torch.Generator().manual_seed(1)).eval()
    assert dropped.blocks[1].drop_path == 0.2 and dropped.drop_rate == 0.1
    x = torch.from_numpy(_images(6, n=1))
    with torch.no_grad():
        assert torch.equal(dropped(x), kept(x))


@pytest.mark.parametrize("kind", ["light", "base"])
def test_engine_microbatch_chains_bitwise_equal(kind):
    """Chains of 2 images give the unsplit logits bit for bit on the CPU,
    as the JAX engine's chains do; a microbatch that does not divide the
    batch serves it unsplit."""
    params = prepare_deit_inference_params(_port_model(kind, seed=7),
                                           device="cpu", dtype=torch.float32)
    x = torch.from_numpy(_images(7, n=4))
    full = deit_forward(params, x)
    assert torch.equal(full, deit_forward(params, x, microbatch=2))
    assert torch.equal(full, deit_forward(params, x, microbatch=3))


def test_base_variant_restarts_its_cache_every_four_blocks():
    """Block 4 of the MRLA-base variant attends to itself only: its cache
    starts anew, so a tail that saw the first four blocks' maps would give
    other logits (block 5's attention carries them to the cls row); and the
    engine serves the same restart."""
    port = _port_model("base", seed=8)
    params = prepare_deit_inference_params(port, device="cpu",
                                           dtype=torch.float32)
    assert params["variant"] == "base" and params["mrlab_size"] == 4
    assert "tail" not in params["blocks"][0]
    x = torch.from_numpy(_images(8))
    with torch.no_grad():
        want = port(x)
    got = deit_forward(params, x)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    port.mrlab_size = params["mrlab_size"] = 6
    with torch.no_grad():
        never = port(x)
    torch.testing.assert_close(deit_forward(params, x), never, rtol=RTOL,
                               atol=ATOL)
    # and the restart shows in the logits, beyond the tolerance above
    assert not torch.allclose(never, want, rtol=RTOL, atol=ATOL)


MRLAB_ARCHS = {"deit_mrlab_tiny_patch16_224": (192, 3),
               "deit_mrlab_small_patch16_224": (384, 6),
               "deit_mrlab_base_patch16_224": (768, 12)}


@pytest.mark.parametrize("arch", list(MRLAB_ARCHS))
def test_registered_mrlab_archs_have_the_published_widths(arch):
    embed, heads = MRLAB_ARCHS[arch]
    assert arch in list_models()
    with torch.device("meta"):
        model = create_model(arch, device="meta")
    assert (model.variant, model.mrlab_size, model.dim_mrla) == ("base", 4,
                                                                 16)
    assert len(model.blocks) == 12 and model.num_heads == heads
    # the reference's dpr = [0.1] * 12, stored for training
    assert all(b.drop_path == 0.1 for b in model.blocks)
    tail = model.blocks[0].mrla
    assert tail.mrla.heads == embed // 16 and tail.normx.eps == 1e-6
    assert not hasattr(tail, "normo") and not hasattr(tail, "lambda_t")
    assert tail.mrla.Wv.weight.shape == (embed, 1, 3, 3)
