"""The port's classification training against the JAX package's: train
steps of a small resnet_mrlal (SGD + label smoothing; fused epilogue; EMA
and clipping) and of a small DeiT-MRLA (AdamW + cosine + EMA) against
``make_train_step`` with the optax chains, the BN running-variance rule,
the distilled model's train output, ``remat``, and the CLI on the CPU.

One init feeds both packages: the port's, with bn3 scales drawn from
U(0.1, 0.5) and the BN statistics shifted (so that every residual branch
works and the running update shows), goes to Flax through
``convert_resnet_state_dict`` / ``convert_vit_state_dict`` and comes back
through ``state_dict_from_jax`` / ``vit_state_dict_from_jax``.  Tolerances
are the JAX package's (``tests/test_fused_train.py:102-110``): the loss
``rtol 1e-5``, every parameter ``rtol 5e-4, atol 5e-5``, every running
statistic ``rtol 1e-4, atol 1e-5``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from mrla_tpu.ckpt import convert_resnet_state_dict
from mrla_tpu.ckpt.torch_convert import convert_vit_state_dict
from mrla_tpu.models.deit import VisionTransformer as FlaxViT
from mrla_tpu.models.deit_mrla import ViTMRLA as FlaxViTMRLA
from mrla_tpu.models.resnet_mrla_light import ResNetMRLALight as FlaxResNet
from mrla_tpu.train import create_train_state as j_create_train_state
from mrla_tpu.train import losses as j_losses
from mrla_tpu.train import make_train_step
from mrla_tpu.train import optim as j_optim
from mrla_tpu.train import schedules as j_schedules
from mrla_tpu_torch.ckpt import state_dict_from_jax, vit_state_dict_from_jax
from mrla_tpu_torch.models import ResNetMRLALight, ViTMRLA, VisionTransformer
from mrla_tpu_torch.models.common import BatchNorm2d
from mrla_tpu_torch.nn import set_generator
from mrla_tpu_torch.testing import spread_deit_weights
from mrla_tpu_torch.train import (
    create_train_state,
    label_smoothing_ce,
    train_step,
)
from mrla_tpu_torch.train import cli, optim, schedules
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=5e-4, atol=5e-5)
STAT_TOL = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(embed_dim=64, depth=2, num_heads=2, num_classes=10)


def _numpy_copy(model):
    """The state_dict as numpy copies: ``jnp.asarray`` may alias a numpy
    array, and the port's step updates its tensors in place while an
    asynchronously dispatched JAX step may still read them."""
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def _smooth(lo, la):
    return label_smoothing_ce(lo, la, 0.1)


def _j_smooth(lo, la):
    return j_losses.label_smoothing_ce(lo, la, 0.1)


def _resnet(seed, fused=False):
    gen = torch.Generator().manual_seed(seed)
    model = ResNetMRLALight([1, 1], num_classes=10, generator=gen,
                            fused_epilogue=fused)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, BatchNorm2d):
                if name.endswith("bn3"):
                    m.weight.uniform_(0.1, 0.5, generator=gen)
                m.running_mean.uniform_(-0.2, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return model


def _batch(seed, n=4, px=32, k=10):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((n, px, px, 3)).astype(np.float32),
            "label": (rng.permutation(n) % k).astype(np.int32)}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _assert_state_dict(got, want, what, key_bias=None):
    """Every entry at its tolerance.  With ``key_bias = (init, bound)``:
    a DeiT block's key bias (the middle third of ``attn.qkv.bias``) has an
    exact gradient of 0 (the softmax over the keys is blind to it), so
    AdamW moves it by the sign of rounding noise, up to lr a step, on
    either side; it is held to moving within ``bound`` of ``init``."""
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            continue
        ref = want[k]
        if key_bias is not None and k.endswith("attn.qkv.bias"):
            c = v.numel() // 3
            init, bound = key_bias[0][k][c:2 * c], key_bias[1]
            for side in (v, ref):
                assert (side[c:2 * c] - init).abs().max() <= bound, k
            v, ref = v.clone(), ref.clone()
            v[c:2 * c] = ref[c:2 * c] = 0
        tol = STAT_TOL if "running" in k else PARAM_TOL
        torch.testing.assert_close(v, ref, **tol,
                                   msg=lambda m: f"{what}: {k}\n{m}")


def _resnet_run(case):
    """(port state, JAX state, losses) after the case's steps."""
    fused, steps, ema, clip = {
        "sgd_label_smoothing": (False, 1, 0.0, None),
        "fused_epilogue": (True, 1, 0.0, None),
        "ema_clip": (False, 2, 0.9, 0.5),
    }[case]
    port = _resnet(0, fused)
    sd = _numpy_copy(port)
    variables = jax.tree.map(jnp.asarray, convert_resnet_state_dict(sd))
    model = FlaxResNet(layers=[1, 1], num_classes=10, fused_epilogue=fused)
    j_state = j_create_train_state(
        model, jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
        j_optim.sgd_torch(0.05, 0.9, 1e-4), ema_decay=ema,
        variables=variables)
    j_step = jax.jit(make_train_step(loss_fn=_j_smooth, grad_clip_norm=clip))
    state = create_train_state(
        port, optim.sgd_torch(port.parameters(), 0.05, 0.9, 1e-4),
        lambda s: 0.05, ema_decay=ema)
    losses = []
    for i in range(steps):
        batch = _batch(i)
        j_state, j_met = j_step(j_state, jax.tree.map(jnp.asarray, batch),
                                jax.random.key(1))
        met = train_step(state, _torch_batch(batch), _smooth,
                         grad_clip_norm=clip)
        losses.append((float(met["loss"]), float(j_met["loss"])))
    return state, j_state, losses


@pytest.mark.parametrize("case", ["sgd_label_smoothing", "fused_epilogue",
                                  "ema_clip"])
def test_resnet_train_step_matches_jax(case):
    """One SGD + label-smoothing step (the fused epilogue on both sides
    for "fused_epilogue"; two steps with clipping and EMA 0.9 for
    "ema_clip"): the loss, every parameter and running statistic, and the
    EMA's parameters and statistics."""
    state, j_state, losses = _resnet_run(case)
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    want = state_dict_from_jax({"params": j_state.params,
                                "batch_stats": j_state.batch_stats})
    _assert_state_dict(state.model.state_dict(), want, "live")
    if state.ema is not None:
        want_ema = state_dict_from_jax({"params": j_state.ema_params,
                                        "batch_stats":
                                            j_state.ema_batch_stats})
        _assert_state_dict(state.ema.state_dict(), want_ema, "ema")


def test_batch_norm_running_variance_is_the_jax_rule():
    """running = 0.9·running + 0.1·var(ddof=0), as flax's nn.BatchNorm
    (torch's nn.BatchNorm2d would take var(ddof=1))."""
    x = np.random.default_rng(0).standard_normal((2, 2, 2, 3)).astype(
        np.float32)
    bn = BatchNorm2d(3).train()
    y = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                            epsilon=1e-5)
    v = flax_bn.init(jax.random.key(0), jnp.asarray(x))
    j_y, upd = flax_bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    stats = upd["batch_stats"]
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 + 0.1 * x.reshape(-1, 3).var(0),
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(
        stats["var"]), rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(
        stats["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(j_y), rtol=1e-5, atol=1e-5)
    assert int(bn.num_batches_tracked) == 1


def _deit_pair(variant, px):
    kw = dict(SMALL, img_size=px)
    if variant == "base":
        kw.update(variant="base", depth=5, drop_path_rate=0.0)
    gen = torch.Generator().manual_seed(3)
    port = spread_deit_weights(ViTMRLA(**kw, generator=gen), gen)
    sd = _numpy_copy(port)
    variables = jax.tree.map(jnp.asarray, convert_vit_state_dict(
        sd, variant=variant))
    kw.pop("img_size")
    return port, FlaxViTMRLA(**kw), variables


@pytest.mark.parametrize("variant,px,steps", [("light", 224, 3),
                                              ("base", 64, 2)])
def test_deit_adamw_cosine_ema_steps_match_jax(variant, px, steps):
    """AdamW (the timm no-decay groups) on a cosine schedule with warm-up,
    label smoothing and EMA 0.9; the base variant (its cache through the
    backward) at 64 px."""
    port, model, variables = _deit_pair(variant, px)
    init = {k: v.clone() for k, v in port.state_dict().items()}
    sched = dict(base_lr=1e-3, total_epochs=2, steps_per_epoch=steps,
                 warmup_epochs=1)
    j_state = j_create_train_state(
        model, jax.random.key(0), jnp.zeros((1, px, px, 3)),
        j_optim.adamw_timm(j_schedules.cosine_with_warmup(**sched),
                           variables["params"], weight_decay=0.05),
        ema_decay=0.9, variables=variables)
    j_step = jax.jit(make_train_step(loss_fn=_j_smooth))
    lr = schedules.cosine_with_warmup(**sched)
    state = create_train_state(
        port, optim.adamw_timm(port, 0.0, weight_decay=0.05), lr,
        ema_decay=0.9)
    for i in range(steps):
        batch = _batch(10 + i, n=2, px=px)
        j_state, j_met = j_step(j_state, jax.tree.map(jnp.asarray, batch),
                                jax.random.key(1))
        met = train_step(state, _torch_batch(batch), _smooth)
        np.testing.assert_allclose(float(met["loss"]), float(j_met["loss"]),
                                   rtol=LOSS_RTOL)
    # Adam's step is at most about lr (its bias-corrected ratio <= 1 here)
    bound = 1.01 * sum(lr(s) for s in range(steps))
    for what, tree, got in (("live", j_state.params, state.model),
                            ("ema", j_state.ema_params, state.ema)):
        want = vit_state_dict_from_jax({"params": tree}, variant)
        _assert_state_dict(got.state_dict(), want, what, (init, bound))


def test_distilled_deit_train_output_is_the_two_heads():
    gen = torch.Generator().manual_seed(4)
    port = spread_deit_weights(VisionTransformer(**SMALL, distilled=True,
                                                 generator=gen), gen)
    sd = _numpy_copy(port)
    variables = convert_vit_state_dict(sd, variant="plain")
    x = _batch(5, n=2, px=224)["image"]
    j_cls, j_dist = FlaxViT(**SMALL, distilled=True).apply(
        variables, jnp.asarray(x), train=True)
    cls, dist = port.train()(torch.from_numpy(x))
    for got, want in ((cls, j_cls), (dist, j_dist)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=2e-3, atol=3e-4)
    with torch.no_grad():  # eval: the mean of the two heads
        torch.testing.assert_close(port.eval()(torch.from_numpy(x)),
                                   (cls + dist) / 2, rtol=1e-5, atol=1e-6)


def test_remat_recomputes_with_the_same_masks_and_one_stat_update():
    x = torch.from_numpy(_batch(6)["image"])

    def run(remat):
        model = ResNetMRLALight([1, 1], num_classes=10, drop_path=0.3,
                                drop_rate=0.2, remat=remat,
                                generator=torch.Generator().manual_seed(0))
        set_generator(model, torch.Generator().manual_seed(7))
        (model(x) ** 2).sum().backward()
        return model

    a, b = run(False), run(True)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(q.grad, p.grad, rtol=1e-6, atol=1e-7,
                                   msg=n)
    for (n, s), t in zip(a.named_buffers(), b.buffers()):
        assert torch.equal(s, t), n
    assert int(b.layer1[0].bn1.num_batches_tracked) == 1


def _cli(tmp, *extra):
    return cli.main(["-a", "resnet50_mrlal", "--layers", "1", "1", "1", "1",
                     "--data", "synthetic",
                     "--synthetic-steps", "2", "--batch-size", "4",
                     "--image-size", "32", "--num-classes", "3",
                     "--label-smooth", "0.1", "--device", "cpu",
                     "--output-dir", str(tmp), *extra])


def test_cli_trains_evaluates_and_resumes_at_the_next_epoch(tmp_path):
    run = tmp_path / "run"
    res1 = _cli(run, "--epochs", "1")
    assert [h["epoch"] for h in res1["history"]] == [0]
    assert len(res1["loss"]) == 2 and np.isfinite(res1["loss"]).all()
    for name in ("train_loss.txt", "val_acc1.txt", "val_acc5.txt",
                 "log.txt", "checkpoint.pt", "best.pt", "epoch_0.pt"):
        assert os.path.exists(run / name), name
    ev = _cli(run, "--epochs", "1", "--resume", str(run), "-e")
    assert ev["acc1"] == res1["history"][-1]["acc1"]
    # the same epoch budget trains nothing more; a larger one the rest
    assert _cli(run, "--epochs", "1", "--resume", str(run))["history"] == []
    res3 = _cli(run, "--epochs", "2", "--resume", str(run))
    assert [h["epoch"] for h in res3["history"]] == [1]
    assert res3["state"].step == 4
    assert open(run / "val_acc1.txt").read().splitlines()[-1].startswith(
        "1 ")


def test_cli_deit_recipe_with_distillation(tmp_path):
    res = cli.main(["-a", "deit_mrlal_tiny_patch16_224", "--image-size",
                    "32", "--num-classes", "3", "--batch-size", "4",
                    "--synthetic-steps", "2", "--epochs", "1", "--opt",
                    "adamw", "--lr", "5e-4", "--lr-scale-512", "--wd",
                    "0.05", "--scheduler", "cosine", "--ema-decay", "0.99",
                    "--mixup", "0.8", "--cutmix", "1.0", "--label-smooth",
                    "0.1", "--drop-path", "0.1", "--distillation-type",
                    "hard", "--clip-grad", "1.0", "--device", "cpu",
                    "--output-dir", str(tmp_path)])
    assert np.isfinite(res["loss"]).all()
    assert res["state"].ema is not None
    assert res["state"].model.blocks[-1].drop_path == 0.1


def test_cli_needs_a_card_unless_asked_and_raises_on_missing_sources(
        tmp_path):
    """Without ``--device cpu`` the CLI asks for the card; a fine-tune or
    teacher directory without a checkpoint and a data root without class
    directories raise, as in the JAX trainer."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--output-dir", str(tmp_path)])
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="--finetune"):
        _cli(tmp_path / "ft", "--finetune", str(empty))
    with pytest.raises(FileNotFoundError, match="--teacher-resume"):
        _cli(tmp_path / "t", "--distillation-type", "hard",
             "--teacher-resume", str(empty))
    (tmp_path / "data" / "train").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="no class directories"):
        _cli(tmp_path / "d", "--data", str(tmp_path / "data"))
