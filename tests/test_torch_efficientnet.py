"""The port's EfficientNet-B0 and EfficientNet-B0 with MRLA-light against
the JAX package: eval and training-mode forwards at full depth and 64 px
(drop rates 0: the logits and every running statistic), the parameter
counts against the Flax init's, the MRLA placement (9 of the 16 blocks,
as ``tests/test_efficientnet.py`` pins it), one RMSpropTF step against
``make_train_step``, and the trainer CLI on the archs whose own drop rates
are nonzero, with the JAX package's argv (``tests/test_cli_archs.py``).

Weights and inputs from seeded numpy (``numpy_variables``), the BN
statistics set on both sides from a pass over seeded images; the Flax
variables reach the port through ``efficientnet_state_dict_from_jax``.
Tolerances: logits rtol 2e-3, atol 3e-4 (``tests/test_serving.py``);
running statistics rtol 1e-4, atol 1e-5; the step as
``tests/test_torch_train.py`` (loss rtol 1e-5, every parameter rtol 5e-4,
atol 5e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrla_tpu.models.efficientnet_mrla import EfficientNet as FlaxEfficientNet
from mrla_tpu.ops.common import eca_kernel_size
from mrla_tpu.train import create_train_state as j_create_train_state
from mrla_tpu.train import losses as j_losses
from mrla_tpu.train import make_train_step
from mrla_tpu.train import optim as j_optim
from mrla_tpu_torch.ckpt import (
    arch_state_dict_from_jax,
    efficientnet_state_dict_from_jax,
)
from mrla_tpu_torch.models import EfficientNet, create_model
from mrla_tpu_torch.train import cli, create_train_state, label_smoothing_ce
from mrla_tpu_torch.train import optim, train_step
from tests.test_torch_resnet_family import (
    images,
    jax_forwards,
    numpy_variables,
)
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

LOGITS = dict(rtol=2e-3, atol=3e-4)
STATS = dict(rtol=1e-4, atol=1e-5)
PARAMS = dict(rtol=5e-4, atol=5e-5)
PX = 64
NO_DROP = dict(drop_rate=0.0, drop_path_rate=0.0)
REPEATS = (1, 2, 2, 3, 3, 4, 1)
CHANNELS = (16, 24, 40, 80, 112, 192, 320)


def _calibrated(port, variables):
    """Every BN's statistics set on both sides to their average over a pass
    of 8 seeded images (statistics drawn at random would leave the deep
    trunk's activations shrinking block by block, and the logits blind to
    the image)."""
    bns = {n: m for n, m in port.named_modules()
           if isinstance(m, torch.nn.BatchNorm2d)}
    for m in bns.values():
        m.reset_running_stats()
        m.momentum = None  # a cumulative average
    with torch.no_grad():
        port.train()(torch.from_numpy(images(9, n=8, px=PX)))
    stats = {}
    for name, m in bns.items():
        m.momentum = 0.1
        *path, leaf = name.split(".")  # the keys are the Flax paths
        node = stats
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = {"mean": m.running_mean.numpy().copy(),
                      "var": m.running_var.numpy().copy()}
    return {**variables, "batch_stats": stats}


def _pair(use_mrla, seed=0):
    flax_model = FlaxEfficientNet(num_classes=10, use_mrla=use_mrla,
                                  **NO_DROP)
    variables = numpy_variables(flax_model, PX, seed)
    port = EfficientNet(10, use_mrla=use_mrla, **NO_DROP)
    port.load_state_dict(efficientnet_state_dict_from_jax(variables),
                         strict=True)
    return flax_model, _calibrated(port, variables), port


@pytest.mark.parametrize("use_mrla", [False, True], ids=["b0", "mrlal_b0"])
def test_efficientnet_matches_flax(use_mrla):
    flax_model, variables, port = _pair(use_mrla)
    x, x_train = images(0, n=2, px=PX), images(1, n=4, px=PX)
    want, want_train, stats = jax_forwards(flax_model)(variables, x, x_train)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
        got_train = port.train()(torch.from_numpy(x_train))
    assert np.asarray(want).std(0).mean() > 1e-2  # the images differ
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    np.testing.assert_allclose(got_train.numpy(), np.asarray(want_train),
                               **LOGITS)
    want_sd = efficientnet_state_dict_from_jax(
        {"params": variables["params"], "batch_stats": stats})
    for k, v in port.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(),
                                       **STATS, err_msg=k)


@pytest.mark.parametrize("arch", ["efficientnet_b0", "efficientnet_mrlal_b0"])
def test_parameter_counts_match_the_flax_init(arch):
    flax_model = FlaxEfficientNet(use_mrla="mrlal" in arch)
    shapes = jax.eval_shape(lambda: flax_model.init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3)), train=False))
    want = sum(int(np.prod(p.shape))
               for p in jax.tree.leaves(shapes["params"]))
    port = create_model(arch, device="cpu")
    assert sum(p.numel() for p in port.parameters()) == want
    # the bridge is total: every Flax leaf lands on a port key
    sd = arch_state_dict_from_jax(arch, jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    port.load_state_dict(sd, strict=True)


def test_mrla_placement():
    """MRLA-light on exactly the residual blocks (stride 1, in == out):
    every block but the first of each stage, 9 of 16; the parameter delta
    is 2k + 9C + C + 2C a block."""
    mrlal = create_model("efficientnet_mrlal_b0", device="cpu")
    plain = create_model("efficientnet_b0", device="cpu")
    have = {n for n in mrlal.block_names
            if getattr(mrlal, n).mrla is not None}
    want = {f"stage{si}_{bi}" for si, rep in enumerate(REPEATS)
            for bi in range(1, rep)}
    assert have == want and len(have) == 9
    count = lambda m: sum(p.numel() for p in m.parameters())
    assert count(mrlal) - count(plain) == sum(
        (rep - 1) * (2 * eca_kernel_size(c) + 12 * c)
        for rep, c in zip(REPEATS, CHANNELS))
    blk = mrlal.stage4_1.mrla
    assert blk.mrla.heads == 112 // 8
    assert blk.mrla.Wq.weight.numel() == eca_kernel_size(112)
    assert mrlal.stage4_1.bn_mrla.eps == 1e-3  # the TF BN eps


def test_rmsproptf_step_matches_jax(monkeypatch):
    """One RMSpropTF (weight decay 1e-5) + label-smoothing step of
    efficientnet_mrlal_b0 on B0's first three stages (both packages read
    the block table when they build: a shorter compile; the stages hold
    both expand ratios, both kernel sizes and two MRLA blocks): the loss,
    every parameter and running statistic."""
    import mrla_tpu.models.efficientnet_mrla as jeff
    import mrla_tpu_torch.models.efficientnet_mrla as teff

    for mod in (jeff, teff):
        monkeypatch.setattr(mod, "B0_BLOCKS", mod.B0_BLOCKS[:3])
    flax_model, variables, port = _pair(True, seed=2)
    assert sum(m.mrla is not None for m in port.modules()
               if isinstance(m, teff.MBConv)) == 2
    lr = 0.048
    j_state = j_create_train_state(
        flax_model, jax.random.key(0), jnp.zeros((1, PX, PX, 3)),
        j_optim.rmsprop_tf(lr, weight_decay=1e-5), variables=variables)
    j_step = jax.jit(make_train_step(
        loss_fn=lambda lo, la: j_losses.label_smoothing_ce(lo, la, 0.1)))
    state = create_train_state(
        port, optim.rmsprop_tf(port.parameters(), lr, weight_decay=1e-5),
        lambda s: lr)
    batch = {"image": images(3, n=4, px=PX),
             "label": np.array([1, 7, 3, 1], np.int32)}
    j_state, j_met = j_step(j_state, jax.tree.map(jnp.asarray, batch),
                            jax.random.key(1))
    met = train_step(state, {k: torch.from_numpy(v)
                             for k, v in batch.items()},
                     lambda lo, la: label_smoothing_ce(lo, la, 0.1))
    np.testing.assert_allclose(float(met["loss"]), float(j_met["loss"]),
                               rtol=1e-5)
    want = efficientnet_state_dict_from_jax(
        {"params": j_state.params, "batch_stats": j_state.batch_stats})
    for k, v in state.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(
                v.numpy(), want[k].numpy(),
                **(STATS if "running" in k else PARAMS), err_msg=k)


@pytest.mark.parametrize("arch,extra", [
    ("efficientnet_mrlal_b0", ["--opt", "rmsproptf", "--scheduler", "exp"]),
    ("deit_mrlab_tiny_patch16_224", ["--opt", "adamw", "--scheduler",
                                     "cosine"]),
])
def test_cli_internal_dropout_archs_train(arch, extra, tmp_path):
    """The JAX package's argv (its own nonzero drop rates get the trainer's
    generator), plus ``--device cpu``."""
    result = cli.main([
        "-a", arch, "--data", "synthetic", "--num-classes", "8",
        "--image-size", "64", "-b", "8", "--epochs", "1",
        "--synthetic-steps", "1", "--lr", "0.01", "--warmup-epochs", "1",
        "--output-dir", str(tmp_path), "--device", "cpu"] + extra)
    assert "best_acc1" in result and np.isfinite(result["loss"]).all()


def test_cli_drop_path_keyword_and_teacher_default():
    """``--drop-path`` is a DropPath rate schedule for EfficientNet
    (``drop_path_rate``) and a flat rate for the resnet families
    (``drop_path``); ``--teacher-arch`` defaults to resnet50, as in JAX."""
    parse = cli.build_parser().parse_args
    assert parse([]).teacher_arch == "resnet50"
    cpu = torch.device("cpu")
    eff = cli.build_model(parse(["-a", "efficientnet_mrlal_b0",
                                 "--drop-path", "0.32"]), cpu)
    assert eff.stage1_1.drop_path.rate == pytest.approx(0.32 * 2 / 16)
    assert eff.head_drop.p == 0.2  # the arch's own dropout
    dw = cli.build_model(parse(["-a", "resnet50_dw", "--drop-path", "0.1",
                                "--layers", "1", "2", "1", "1"]), cpu)
    assert dw.layers == (1, 2, 1, 1)
    assert all(b.drop_path.rate == 0.1 for b in dw.layer2)
