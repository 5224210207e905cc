"""The port's hub surface (``mrla_tpu_torch/hub.py``): the cases of
``tests/test_hub.py``, a reference checkpoint through both packages'
``hub.load`` on the same weights, and the three defects of the JAX
function that the port does not copy: ``deit_mrlab_*`` routed to the
ResNet converter, ``efficientnet*`` unreadable, and ``dict()`` on the
checkpoint tuple of a run directory."""

import numpy as np
import pytest
import torch

from mrla_tpu import hub as jax_hub
from mrla_tpu_torch import hub
from mrla_tpu_torch.models import create_model, list_models
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)


def test_attribute_resolves_registered_arch():
    assert callable(hub.resnet50_mrlal)
    assert "resnet50_mrlal" in dir(hub)
    assert hub.list_models() == list_models()
    assert hub.dependencies == ["torch"]
    with pytest.raises(AttributeError, match="not a registered arch"):
        hub.definitely_not_a_model


def test_load_fresh_init_runs():
    model, sd = hub.load("resnet50", image_size=64, num_classes=10,
                         device="cpu")
    assert not model.training
    with torch.inference_mode():
        assert model(torch.zeros(2, 64, 64, 3)).shape == (2, 10)
    assert sd.keys() == model.state_dict().keys()
    again, sd2 = hub.load("resnet50", num_classes=10, device="cpu")
    other, sd3 = hub.load("resnet50", num_classes=10, seed=1, device="cpu")
    assert torch.equal(sd["fc.weight"], sd2["fc.weight"])
    assert not torch.equal(sd["fc.weight"], sd3["fc.weight"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            hub.load("resnet50", num_classes=10)


def test_load_torch_checkpoint_matches_jax_hub(tmp_path):
    """A reference .pth.tar ({"state_dict": ...} with a module. prefix)
    through both packages' hub.load: the port's weights are the file's,
    and the JAX package's converted tree carries the same weights back."""
    from mrla_tpu_torch.ckpt import state_dict_from_jax

    src = create_model("resnet50_mrlal", device="cpu",
                       generator=torch.Generator().manual_seed(3)).eval()
    path = tmp_path / "ref.pth.tar"
    torch.save({"state_dict": {f"module.{k}": v
                               for k, v in src.state_dict().items()}}, path)
    model, sd = hub.load("resnet50_mrlal", str(path), device="cpu")
    assert not model.training
    for k, v in src.state_dict().items():
        assert torch.equal(sd[k], v), k
    _, variables = jax_hub.load("resnet50_mrlal", str(path))
    back = state_dict_from_jax(variables)
    for k, v in back.items():
        assert torch.equal(v, sd[k].to(v.dtype)), k
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        assert torch.equal(model(x), src(x))


def test_convert_dispatch_rejects_unknown_family_and_wrong_keys():
    with pytest.raises(ValueError, match="no torch-checkpoint converter"):
        hub.convert_torch_state_dict("resmlp_12", {})
    with pytest.raises(ValueError, match="does not match"):
        hub.convert_torch_state_dict(
            "resnet50", {"module.fc.weight": torch.zeros(2, 2)})


def test_pth_read_without_full_unpickling(tmp_path):
    """weights_only=True: a checkpoint that needs arbitrary unpickling is
    refused."""
    src = create_model("resnet50", device="cpu", num_classes=10)
    path = tmp_path / "pickled.pth"
    torch.save({"state_dict": src.state_dict(),
                "args": np.random.default_rng(0)}, path)
    with pytest.raises(Exception, match="[Ww]eights only"):
        hub.load("resnet50", str(path), num_classes=10, device="cpu")


def test_named_apply_order_and_paths():
    tree = {"a": {"b": {"w": 1}, "c": {"w": 2}}, "d": {"w": 3}}
    seen = []
    hub.named_apply(lambda subtree, name: seen.append(name), tree,
                    include_root=True)
    # depth-first: children before parents, root last (reference order)
    assert seen == ["a.b", "a.c", "a", "d", ""]
    pre = []
    hub.named_apply(lambda subtree, name: pre.append(name), tree,
                    depth_first=False, include_root=True)
    assert pre == ["", "a", "a.b", "a.c", "d"]
    # on a module, the reference helper's order over named_children
    m = torch.nn.Sequential(torch.nn.Sequential(torch.nn.Linear(1, 1)),
                            torch.nn.ReLU())
    mods = []
    assert hub.named_apply(lambda module, name: mods.append(name), m) is m
    assert mods == ["0.0", "0", "1"]


def test_deit_mrlab_routes_to_the_vit_family():
    """The JAX dispatch sends deit_mrlab_* to the ResNet converter
    (hub.py:60), which cannot read a token layout."""
    arch = "deit_mrlab_tiny_patch16_224"
    sd = create_model(arch, device="cpu", num_classes=10).state_dict()
    with pytest.raises(KeyError):
        jax_hub.convert_torch_state_dict(arch, sd)
    assert hub.convert_torch_state_dict(arch, sd).keys() == sd.keys()


def test_efficientnet_checkpoint_loads(tmp_path):
    """The JAX dispatch sends efficientnet* to the ResNet converter
    (hub.py:67-68); the port's modules read the reference keys."""
    src = create_model("efficientnet_b0", device="cpu", num_classes=10,
                       generator=torch.Generator().manual_seed(1))
    path = tmp_path / "eff.pth"
    torch.save(src.state_dict(), path)
    model, sd = hub.load("efficientnet_b0", str(path), num_classes=10,
                         device="cpu")
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        assert torch.equal(model(x), src.eval()(x))


def test_load_reads_a_port_run_directory(tmp_path):
    """A run directory of the port's trainer: best.pt, else
    checkpoint.pt (the JAX function calls dict() on the restore's tuple,
    hub.py:114)."""
    from mrla_tpu_torch.ckpt import read_model_state_dict
    from mrla_tpu_torch.train.cli import main as train_main

    run_dir = str(tmp_path / "run")
    train_main(["--device", "cpu", "-a", "resnet50", "--layers", "1", "1",
                "1", "1", "--data", "synthetic", "--epochs", "1",
                "--synthetic-steps", "1", "-b", "2", "--image-size", "32",
                "--num-classes", "2", "--output-dir", run_dir])
    model, sd = hub.load("resnet50", run_dir, num_classes=2,
                         layers=[1, 1, 1, 1], device="cpu")
    want = (read_model_state_dict(run_dir, "best")
            or read_model_state_dict(run_dir))
    assert all(torch.equal(sd[k], v) for k, v in want.items())
    with pytest.raises(FileNotFoundError):
        hub.load("resnet50", str(tmp_path), num_classes=2, device="cpu")
