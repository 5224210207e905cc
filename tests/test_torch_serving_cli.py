"""The port's eval CLI (``mrla_tpu_torch/serving/cli.py``) against the JAX
package's (``mrla_tpu/serving/cli.py``): engine routing for every arch,
both packages' engines on one saved ``.pth``, both CLIs on one tiny
ImageFolder (PNG files, so both decode with PIL), the precast route for
la_eq4 and deit_mrlal, and ``--resume`` from a run directory of the port's
trainer.  The models are cut to a few blocks by patching the CLIs'
``create_model``."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import mrla_tpu.models
import mrla_tpu.utils.compile_cache
from mrla_tpu.models import list_models as jax_list_models
from mrla_tpu.models.resnet_mrla_light import ResNetMRLALight as FlaxResNet
from mrla_tpu.serving import cli as jcli
from mrla_tpu_torch.data.imagefolder import ImageFolder, iterate_batches
from mrla_tpu_torch.data.transforms import normalize
from mrla_tpu_torch.kernels import deit_token_tail, fused_epilogue
from mrla_tpu_torch.models import (
    ResNetLAEq4,
    ResNetMRLALight,
    ViTMRLA,
    create_model,
    list_models,
)
from mrla_tpu_torch.serving import cli
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

LAYERS = [1, 1, 1, 1]
LOGIT_TOL = 0.02  # of the logit scale, between the two bf16 engines
COMMON = ["-b", "4", "--image-size", "64", "--num-classes", "2",
          "--workers", "2"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("imagefolder")
    rng = np.random.default_rng(0)
    for c, cls in enumerate(("class_a", "class_b")):
        d = root / "val" / cls
        d.mkdir(parents=True)
        for i in range(5):
            arr = rng.integers(0, 255, (80, 80, 3), dtype=np.uint8)
            arr[..., c] //= 2  # a class the weights can tell apart
            Image.fromarray(arr).save(d / f"{i}.png")
    return str(root)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A seeded port model's state_dict saved as a reference checkpoint,
    BN statistics moved so that the folds do work."""
    model = ResNetMRLALight(LAYERS, num_classes=2,
                            generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    sd = model.state_dict()
    for k, v in sd.items():
        if k.endswith(("running_mean", "running_var")):
            v.add_(torch.rand(v.shape, generator=gen) * 0.4 + 0.1)
    path = str(tmp_path_factory.mktemp("ckpt") / "ref.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               path)
    return path


@pytest.fixture()
def small(monkeypatch):
    """Both CLIs build their models at a few blocks; the JAX CLI's
    compile cache stays off."""
    real = create_model
    classes = {"resnet50_mrlal": ResNetMRLALight,
               "resnet50_la_eq4": ResNetLAEq4}

    def port_create(arch, device="cuda", **kw):
        if arch in classes:
            return classes[arch](LAYERS, **kw,
                                 generator=torch.Generator().manual_seed(0)
                                 ).to(device)
        if arch == "deit_mrlal_tiny_patch16_224":
            return ViTMRLA(img_size=64, embed_dim=192, depth=2, num_heads=3,
                           **kw, generator=torch.Generator().manual_seed(0)
                           ).to(device)
        return real(arch, device=device, **kw)

    monkeypatch.setattr(cli, "create_model", port_create)
    monkeypatch.setattr(mrla_tpu.models, "create_model",
                        lambda arch, **kw: FlaxResNet(layers=LAYERS, **kw))
    monkeypatch.setattr(mrla_tpu.utils.compile_cache,
                        "enable_compile_cache", lambda: None)


def test_pick_engine_equals_jax_for_every_arch():
    archs = list_models()
    assert len(archs) == 53 and set(archs) == set(jax_list_models())
    for arch in archs:
        assert cli._pick_engine(arch) == jcli._pick_engine(arch), arch
        assert (cli._precast_microbatch_default(arch)
                == jcli._precast_microbatch_default(arch)), arch


def test_quant_rejected_off_mrlal():
    with pytest.raises(ValueError, match="mrlal engine only"):
        cli.make_engine_forward("resnet50", None, None, engine="precast",
                                quant="int8", calib_x=object())


def _tree_batches(tree):
    ds = ImageFolder(os.path.join(tree, "val"))
    b = next(iterate_batches(ds, np.arange(len(ds)), len(ds), 64,
                             train=False, num_threads=1, drop_last=False))
    return normalize(torch.from_numpy(b["image"])), b["label"]


def test_engines_and_clis_agree_across_packages(tree, checkpoint, small,
                                                capsys):
    """The two packages' make_engine_forward on one .pth (both bf16
    engines) give logits within LOGIT_TOL of the logit scale; both CLIs
    print the same keys, engine and image count; the port's accuracies
    are a direct count over its own logits, and equal JAX's where no
    image's top-2 gap is under the tolerance."""
    import jax.numpy as jnp

    argv = ["-a", "resnet50_mrlal", "--data", tree, "--torch", checkpoint,
            *COMMON]
    x, labels = _tree_batches(tree)
    args = cli.build_argparser().parse_args(argv)
    fwd = cli.make_engine_forward(
        "resnet50_mrlal", cli.create_model("resnet50_mrlal", device="cpu",
                                           num_classes=2),
        cli._load_variables(args, None), device="cpu")
    got = fwd(x.to(torch.bfloat16)).numpy()
    jargs = jcli.build_argparser().parse_args(argv)
    jmodel = FlaxResNet(layers=LAYERS, num_classes=2)
    jfwd = jcli.make_engine_forward("resnet50_mrlal", jmodel,
                                    jcli._load_variables(jargs, jmodel))
    want = np.asarray(jfwd(jnp.asarray(x.numpy(), jnp.bfloat16)))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < LOGIT_TOL * scale

    theirs = jcli.main(argv)
    ours = cli.main(argv + ["--device", "cpu"])
    assert set(ours) == set(theirs)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == ours
    for key in ("arch", "engine", "images"):
        assert ours[key] == theirs[key], key
    assert ours["engine"] == "mrlal" and ours["images"] == 10
    assert ours["acc1"] == round(
        100.0 * float((got.argmax(-1) == labels).mean()), 3)
    assert ours["acc5"] == 100.0  # two classes
    top2 = np.sort(want, axis=-1)
    if (top2[:, -1] - top2[:, -2]).min() > LOGIT_TOL * scale:
        assert ours["acc1"] == theirs["acc1"]


@pytest.mark.parametrize("arch", ["resnet50_la_eq4",
                                  "deit_mrlal_tiny_patch16_224"])
def test_precast_route_serves_la_eq4_and_deit_mrlal(tree, small, arch):
    """_pick_engine sends both to precast: la_eq4 through the generic
    engine's module forward, deit_mrlal through the DeiT engine and its
    token-tail wrapper; the accuracies are a direct count over the
    engine's logits."""
    deit_token_tail.counter.reset()
    res = cli.main(["-a", arch, "--data", tree, *COMMON, "--limit", "6",
                    "--device", "cpu"])
    assert res["engine"] == "precast" and res["images"] == 6
    assert (deit_token_tail.counter.calls > 0) == arch.startswith("deit")
    model = cli.create_model(arch, device="cpu", num_classes=2)
    fwd = cli.make_engine_forward(arch, model, model.state_dict(),
                                  device="cpu")
    x, labels = _tree_batches(tree)
    logits = fwd(x[:6].to(torch.bfloat16)).numpy()
    assert res["acc1"] == round(
        100.0 * float((logits.argmax(-1) == labels[:6]).mean()), 3)


def test_quant_int8_cli(tree, small):
    """--quant int8: calibrated on the first batch, the bf16 epilogue on
    the kernel's wrapper, every image counted."""
    fused_epilogue.counter.reset()
    res = cli.main(["-a", "resnet50_mrlal", "--data", tree, *COMMON,
                    "--quant", "int8", "--limit", "6", "--device", "cpu"])
    assert res["engine"] == "mrlal" and res["images"] == 6
    assert fused_epilogue.counter.calls > 0


def test_resume_from_a_port_run_directory(tree, small, tmp_path):
    """Train briefly with the port's trainer, then evaluate its run
    directory through --resume: the weights are the run's."""
    from mrla_tpu_torch.ckpt import read_model_state_dict
    from mrla_tpu_torch.train.cli import main as train_main

    run_dir = str(tmp_path / "run")
    train_main(["--device", "cpu", "-a", "resnet50_mrlal", "--layers", "1",
                "1", "1", "1", "--data", "synthetic", "--epochs", "1",
                "--synthetic-steps", "2", "-b", "4", "--image-size", "32",
                "--num-classes", "2", "--output-dir", run_dir])
    res = cli.main(["-a", "resnet50_mrlal", "--data", tree, *COMMON,
                    "--resume", run_dir, "--limit", "4", "--device", "cpu"])
    assert res["images"] == 4 and res["engine"] == "mrlal"
    args = cli.build_argparser().parse_args(
        ["--data", tree, "--resume", run_dir])
    sd = cli._load_variables(args, None)
    want = read_model_state_dict(run_dir, "best") or read_model_state_dict(
        run_dir)
    assert all(torch.equal(sd[k], want[k]) for k in want)
    with pytest.raises(FileNotFoundError):
        cli._load_variables(cli.build_argparser().parse_args(
            ["--data", tree, "--resume", str(tmp_path)]), None)


# options of one package alone, each with its reason: the JAX daemon's
# RoIAlign backend switch (the port always runs its kernel on the presets'
# exact grid) and its XLA compile cache; the port's --device (the card by
# default, the CPU on request)
PARSER_GAPS = {"cli": ({"device"}, set()),
               "server": ({"device"}, {"roi_backend", "no_compile_cache"})}


@pytest.mark.parametrize("which", ["cli", "server"])
def test_the_serving_parsers_share_their_defaults(which, monkeypatch):
    """Every option the port's eval CLI / daemon shares with the JAX
    package's has the same default; the options of one package alone are
    exactly the listed gaps."""
    import argparse

    from mrla_tpu.serving import server as jserver
    from mrla_tpu_torch.serving import server

    argv = ["--data", "x"] if which == "cli" else []
    if which == "cli":
        want = vars(jcli.build_argparser().parse_args(argv))
        got = vars(cli.build_argparser().parse_args(argv))
    else:
        # the JAX daemon builds its parser inside main: read what it parses
        parsed = {}

        class Parsed(Exception):
            pass

        real = argparse.ArgumentParser.parse_args

        def capture(self, args=None, namespace=None):
            parsed.update(vars(real(self, args, namespace)))
            raise Parsed

        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(Parsed):
            jserver.main(argv)
        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", real)
        want, got = parsed, vars(server.build_argparser().parse_args(argv))
    ours, theirs = PARSER_GAPS[which]
    assert set(got) - set(want) == ours
    assert set(want) - set(got) == theirs
    shared = set(want) & set(got)
    assert len(shared) >= 12
    assert {k: (want[k], got[k]) for k in shared if want[k] != got[k]} == {}
