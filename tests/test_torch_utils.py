"""The port's utilities against the JAX package's: parameter counts, the
FLOP count's band (``mrla_tpu_torch/utils/flops.py`` states why the two
counts differ), the log tools on the same files, and the launch repair
(``init_distributed`` joins a group on the card unless asked for the
CPU)."""

import json
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mrla_tpu.models import create_model as jax_create_model
from mrla_tpu.models.deit import VisionTransformer as FlaxViT
from mrla_tpu.models.resnet import ResNet as FlaxResNet
from mrla_tpu.utils import count_flops as jax_count_flops
from mrla_tpu.utils import count_params as jax_count_params
from mrla_tpu.utils import logtools as jax_logtools
from mrla_tpu_torch.models import VisionTransformer, create_model
from mrla_tpu_torch.models.resnet import ResNet
from mrla_tpu_torch.parallel import launch
from mrla_tpu_torch.utils import count_flops, count_params, logtools
from mrla_tpu_torch.utils.flops import profile_model

FLOP_BAND = (0.8, 1.1)  # the port's count over XLA's, flops.py's docstring


def _flax_params(model, px):
    return jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, px, px, 3)), train=False))


@pytest.mark.parametrize("arch", ["resnet50_mrlal", "deit_tiny_patch16_224",
                                  "efficientnet_b0"])
def test_count_params_equals_jax(arch):
    want = jax_count_params(_flax_params(jax_create_model(arch), 224)
                            ["params"])
    model = create_model(arch, device="cpu")
    assert count_params(model) == want
    # a state_dict: its BN statistics are not parameters
    assert count_params(model.state_dict()) == want


@pytest.mark.parametrize("case", ["resnet", "deit"])
def test_flops_within_the_stated_band(case):
    px = 64
    if case == "resnet":
        jm = FlaxResNet(layers=[1, 1, 1, 1], num_classes=10)
        pm = ResNet(layers=[1, 1, 1, 1], num_classes=10)
    else:
        kw = dict(img_size=px, patch_size=16, embed_dim=192, depth=2,
                  num_heads=3, num_classes=10)
        jm, pm = FlaxViT(**kw), VisionTransformer(**kw)
    want = jax_count_flops(jm, (1, px, px, 3), _flax_params(jm, px))
    got = count_flops(pm, (1, px, px, 3), device="cpu")
    assert FLOP_BAND[0] <= got / want <= FLOP_BAND[1], got / want
    assert pm.training  # the count leaves the mode as it was


def test_profile_model_keys_and_no_silent_cpu():
    got = profile_model("resnet50", (1, 32, 32, 3), device="cpu",
                        num_classes=10)
    # the JAX function's keys (mrla_tpu/utils/flops.py:profile_model)
    assert set(got) == {"model", "params", "params_m", "flops", "gflops"}
    assert got["params"] == count_params(
        create_model("resnet50", device="cpu", num_classes=10))
    assert got["gflops"] == round(got["flops"] / 1e9, 3) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            count_flops(ResNet(layers=[1], num_classes=2), (1, 32, 32, 3))


def test_logtools_equal_jax_on_the_same_files(tmp_path):
    run = tmp_path / "run"
    os.makedirs(run)
    with open(run / "val_acc1.txt", "w") as f:
        f.write("0 10.0\n1 30.0\nstray\n2 20.0\n")
    with open(run / "train_loss.txt", "w") as f:
        f.write("0 2.0\n1 1.0\n3 0.5\n")
    with open(run / "log.txt", "w") as f:
        for e, a in [(0, 10.0), (1, 30.0), (2, 20.0)]:
            f.write(json.dumps({"epoch": e, "test_acc1": a}) + "\n")
        f.write("not json\n")
    for fn, path in [("best_from_txt", run / "val_acc1.txt"),
                     ("best_from_jsonl", run / "log.txt"),
                     ("best_from_txt", run / "missing.txt")]:
        assert getattr(logtools, fn)(str(path)) == \
            getattr(jax_logtools, fn)(str(path))
    assert logtools.best_from_txt(str(run / "val_acc1.txt")) == {
        "epoch": 1, "value": 30.0}
    ours, theirs = tmp_path / "ours.csv", tmp_path / "theirs.csv"
    assert logtools.txt_to_csv(str(run), str(ours)) == \
        jax_logtools.txt_to_csv(str(run), str(theirs)) == 4
    assert ours.read_text() == theirs.read_text()
    assert logtools.plot_curves(str(run), str(tmp_path / "o.png")) == \
        jax_logtools.plot_curves(str(run), str(tmp_path / "t.png"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_init_distributed_defaults_to_the_card(monkeypatch):
    """With a launch environment and no card, joining a group raises
    unless the caller asks for the CPU (which then joins over gloo)."""
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
           "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not launch.initialized()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.init_distributed()
    assert not launch.initialized()
    try:
        info = launch.init_distributed(device="cpu")
        assert dist.get_backend() == "gloo"
        assert info == {"process_index": 0, "process_count": 1,
                        "local_devices": 1, "global_devices": 1}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
