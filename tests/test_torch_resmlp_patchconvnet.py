"""The port's ResMLP and PatchConvNet (single- and multi-class) against
the JAX package's Flax classes built with the same keywords (depth 2,
width 64, 64 px): eval logits, training-mode logits (rates 0), and the
``state_dict`` names: a port ``state_dict`` goes to Flax through the
reference mapping that ``tests/test_resmlp_patchconvnet.py`` applies to
the reference models' ``state_dict``s, and comes back unchanged.

Weights and inputs from seeded numpy (``numpy_variables``: layer scales
U(0.05, 0.2), where the init's 1e-4 to 1e-6 would hide every block).
Logits rtol 2e-3, atol 3e-4 (``tests/test_serving.py``)."""

import jax
import numpy as np
import pytest
import torch

from mrla_tpu.models.patchconvnet import PatchConvNet as FlaxPatchConvNet
from mrla_tpu.models.resmlp import ResMLP as FlaxResMLP
from mrla_tpu_torch.ckpt import (
    patchconvnet_state_dict_from_jax,
    resmlp_state_dict_from_jax,
)
from mrla_tpu_torch.models import PatchConvNet, ResMLP
from tests.test_torch_resnet_family import images, numpy_variables

LOGITS = dict(rtol=2e-3, atol=3e-4)
DEPTH, C, NCLS, PX = 2, 64, 10, 64


def _conv(w):  # OIHW -> HWIO
    return np.transpose(w, (2, 3, 1, 0))


def reference_resmlp_params(sd):
    """tests/test_resmlp_patchconvnet.py's mapping of a reference ResMLP
    ``state_dict`` onto the Flax tree."""
    params = {
        "patch_embed": {"proj": {
            "kernel": _conv(sd["patch_embed.proj.weight"]),
            "bias": sd["patch_embed.proj.bias"]}},
        "norm": {"alpha": sd["norm.alpha"], "beta": sd["norm.beta"]},
        "head": {"kernel": sd["head.weight"].T, "bias": sd["head.bias"]},
    }
    for i in range(DEPTH):
        p = f"blocks.{i}."
        lin = lambda n: {"kernel": sd[p + n + ".weight"].T,
                         "bias": sd[p + n + ".bias"]}
        params[f"block{i}"] = {
            "norm1": {"alpha": sd[p + "norm1.alpha"],
                      "beta": sd[p + "norm1.beta"]},
            "norm2": {"alpha": sd[p + "norm2.alpha"],
                      "beta": sd[p + "norm2.beta"]},
            "attn": lin("attn"),
            "mlp": {"fc1": lin("mlp.fc1"), "fc2": lin("mlp.fc2")},
            "gamma_1": sd[p + "gamma_1"], "gamma_2": sd[p + "gamma_2"]}
    return params


def reference_patchconvnet_params(sd, multiclass):
    """tests/test_resmlp_patchconvnet.py's mapping of a reference
    PatchConvnet ``state_dict`` (single- or multi-class) onto the Flax
    tree."""
    lin = lambda p: {"kernel": sd[p + ".weight"].T, "bias": sd[p + ".bias"]}
    ln = lambda p: {"scale": sd[p + ".weight"], "bias": sd[p + ".bias"]}
    t = "blocks_token_only.0"
    params = {
        "patch_embed": {f"conv{i}": {"kernel": _conv(
            sd[f"patch_embed.proj.{2 * i}.0.weight"])} for i in range(4)},
        "cls_token": sd["cls_token"],
        "cls_gamma_1": sd[f"{t}.gamma_1"], "cls_gamma_2": sd[f"{t}.gamma_2"],
        "cls_norm1": ln(f"{t}.norm1"), "cls_norm2": ln(f"{t}.norm2"),
        "cls_attn": {k: lin(f"{t}.attn.{k}") for k in ("q", "k", "v",
                                                        "proj")},
        "cls_mlp": {"fc1": lin(f"{t}.mlp.fc1"), "fc2": lin(f"{t}.mlp.fc2")},
        "norm": ln("norm"),
    }
    if multiclass:
        params["head_multi_kernel"] = np.stack(
            [sd[f"head.{i}.weight"][0] for i in range(NCLS)])
        params["head_multi_bias"] = np.concatenate(
            [sd[f"head.{i}.bias"] for i in range(NCLS)])
    else:
        params["head"] = lin("head")
    for i in range(DEPTH):
        p = f"blocks.{i}."
        q = p + "attn.qkv_pos."
        params[f"norm{i}"] = ln(p + "norm1")
        params[f"gamma_{i}"] = sd[p + "gamma_1"]
        params[f"block{i}"] = {
            "pw1": {"kernel": _conv(sd[q + "0.weight"]),
                    "bias": sd[q + "0.bias"]},
            "dw": {"kernel": _conv(sd[q + "2.weight"]),
                   "bias": sd[q + "2.bias"]},
            "se_fc1": {"kernel": sd[q + "4.conv_reduce.weight"][:, :, 0, 0].T,
                       "bias": sd[q + "4.conv_reduce.bias"]},
            "se_fc2": {"kernel": sd[q + "4.conv_expand.weight"][:, :, 0, 0].T,
                       "bias": sd[q + "4.conv_expand.bias"]},
            "pw2": {"kernel": _conv(sd[q + "5.weight"]),
                    "bias": sd[q + "5.bias"]}}
    return params


CASES = {
    "resmlp": (lambda: FlaxResMLP(embed_dim=C, depth=DEPTH, num_classes=NCLS,
                                  init_scale=0.1),
               lambda: ResMLP(img_size=PX, embed_dim=C, depth=DEPTH,
                              num_classes=NCLS, init_scale=0.1),
               resmlp_state_dict_from_jax, reference_resmlp_params),
    "patchconvnet": (
        lambda: FlaxPatchConvNet(embed_dim=C, depth=DEPTH, num_classes=NCLS,
                                 init_scale=0.1),
        lambda: PatchConvNet(NCLS, C, DEPTH, init_scale=0.1),
        patchconvnet_state_dict_from_jax,
        lambda sd: reference_patchconvnet_params(sd, False)),
    "patchconvnet_multi": (
        lambda: FlaxPatchConvNet(embed_dim=C, depth=DEPTH, num_classes=NCLS,
                                 init_scale=1e-4, multiclass=True),
        lambda: PatchConvNet(NCLS, C, DEPTH, init_scale=1e-4,
                             multiclass=True),
        patchconvnet_state_dict_from_jax,
        lambda sd: reference_patchconvnet_params(sd, True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_matches_flax_and_keeps_the_reference_names(case):
    flax_cls, port_cls, bridge, reference = CASES[case]
    flax_model, port = flax_cls(), port_cls()
    variables = numpy_variables(flax_model, PX)
    port.load_state_dict(bridge(variables), strict=True)
    x = images(0, n=2, px=PX)
    run = jax.jit(lambda v, x, train: flax_model.apply(v, x, train=train),
                  static_argnums=2)
    with torch.no_grad():
        for train in (False, True):  # rates 0: the same function
            got = port.train(train)(torch.from_numpy(x)).numpy()
            want = np.asarray(run(variables, x, train))
            np.testing.assert_allclose(got, want, **LOGITS)
    assert want.std(0).mean() > 1e-2  # the images differ
    # the reference's names: its mapping reads the port's state_dict
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = reference(sd)
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                      jax.tree_util.tree_leaves_with_path(t)}
    want_leaves = flat(variables["params"])
    assert set(flat(back)) == set(want_leaves)
    for k, v in flat(back).items():
        np.testing.assert_array_equal(v, want_leaves[k], err_msg=k)


def test_multiclass_attention_excludes_the_class_tokens():
    """The multi-class block's keys and values are the patch tokens only;
    the single-query block's include the cls token."""
    port = PatchConvNet(NCLS, C, DEPTH, multiclass=True)
    attn = port.blocks_token_only[0].attn
    assert attn.num_cls == NCLS
    u = torch.randn(2, NCLS + 16, C)
    seen = []
    attn.k.register_forward_hook(lambda m, a, o: seen.append(a[0].shape))
    attn(u)
    assert seen == [(2, 16, C)]
    single = PatchConvNet(NCLS, C, DEPTH).blocks_token_only[0].attn
    single.k.register_forward_hook(lambda m, a, o: seen.append(a[0].shape))
    single(u[:, NCLS - 1:])
    assert seen[-1] == (2, 17, C)
