"""The port's training pieces against the JAX package: losses, schedules,
optimizers (three updates each against the optax chains), the AdamW
no-decay groups, DropPath / dropout, the synthetic source, the transforms
and the eval step.

Inputs are made from numpy seeds; one init feeds both packages
(``convert_resnet_state_dict`` / ``convert_vit_state_dict``).  Tolerances
are the JAX package's own: optimizers ``rtol 1e-5, atol 1e-6``
(``tests/test_optim_sched.py``), losses and schedules at fp32 rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mrla_tpu.ckpt import convert_resnet_state_dict
from mrla_tpu.ckpt.torch_convert import convert_vit_state_dict
from mrla_tpu.data import synthetic as j_synthetic
from mrla_tpu.data import transforms as j_transforms
from mrla_tpu.models.resnet_mrla_light import ResNetMRLALight as FlaxResNet
from mrla_tpu.train import create_train_state as j_create_train_state
from mrla_tpu.train import losses as j_losses
from mrla_tpu.train import make_eval_step
from mrla_tpu.train import optim as j_optim
from mrla_tpu.train import schedules as j_schedules
from mrla_tpu_torch.ckpt import state_dict_from_jax, vit_state_dict_from_jax
from mrla_tpu_torch.data import (
    MixDraw,
    apply_mixup_cutmix,
    center_crop_resize,
    draw_erasing,
    draw_mixup_cutmix,
    eval_transform_params,
    mixup_cutmix,
    normalize,
    random_erasing,
    random_flip,
    synthetic_batches,
)
from mrla_tpu_torch.models import ResNetMRLALight, ViTMRLA
from mrla_tpu_torch.nn import DropPath, Dropout, set_generator
from mrla_tpu_torch.ops import drop_path, dropout
from mrla_tpu_torch.train import (
    create_train_state,
    cross_entropy,
    distillation_loss,
    eval_step,
    label_smoothing_ce,
    soft_target_ce,
)
from mrla_tpu_torch.train import optim, schedules

SMALL_VIT = dict(embed_dim=64, depth=2, num_heads=2, num_classes=10)


def _numpy_copy(model):
    """The state_dict as numpy copies: ``jnp.asarray`` may alias a numpy
    array, and the port's step updates its tensors in place while an
    asynchronously dispatched JAX step may still read them."""
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------- losses


@pytest.mark.parametrize("kind", ["ce", "smooth", "soft"])
def test_losses_match_jax(kind):
    rng = np.random.default_rng(0)
    logits = _np(rng, 6, 10) * 3
    labels = rng.integers(0, 10, 6).astype(np.int32)
    soft = rng.dirichlet(np.ones(10), 6).astype(np.float32)
    t_logits, t_labels = torch.from_numpy(logits), torch.from_numpy(labels)
    if kind == "ce":
        got = cross_entropy(t_logits, t_labels)
        want = j_losses.cross_entropy(jnp.asarray(logits),
                                      jnp.asarray(labels))
    elif kind == "smooth":
        got = label_smoothing_ce(t_logits, t_labels, 0.1)
        want = j_losses.label_smoothing_ce(jnp.asarray(logits),
                                           jnp.asarray(labels), 0.1)
    else:
        got = soft_target_ce(t_logits, torch.from_numpy(soft))
        want = j_losses.soft_target_ce(jnp.asarray(logits), jnp.asarray(soft))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("kind,tau", [("soft", 1.0), ("soft", 3.0),
                                      ("hard", 1.0), ("none", 1.0)])
def test_distillation_loss_matches_jax(kind, tau):
    rng = np.random.default_rng(1)
    s, t = _np(rng, 5, 12) * 2, _np(rng, 5, 12) * 2
    got = distillation_loss(torch.tensor(1.25), torch.from_numpy(s),
                            torch.from_numpy(t), kind=kind, alpha=0.3,
                            tau=tau)
    want = j_losses.distillation_loss(jnp.float32(1.25), jnp.asarray(s),
                                      jnp.asarray(t), kind=kind, alpha=0.3,
                                      tau=tau)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if kind == "soft":  # the reference's / K: the term is O(1 / K)
        kl = distillation_loss(torch.tensor(0.0), torch.from_numpy(s),
                               torch.from_numpy(t), kind, 1.0, tau)
        assert 0 < float(kl) < 1.0


# ------------------------------------------------------------ schedules

SCHEDULES = {
    "step": (lambda m: m.step_with_warmup(0.1, 10, warmup_epochs=3,
                                          decay_every_epochs=4), 120),
    "cosine": (lambda m: m.cosine_with_warmup(0.05, 8, 10, warmup_epochs=2,
                                              min_lr=1e-4), 90),
    "multistep": (lambda m: m.multistep_with_warmup(
        0.1, 10, milestones_epochs=(3, 6), warmup_epochs=2), 90),
    "exp": (lambda m: m.exponential_decay_with_warmup(
        0.048, 10, decay_epochs=2.4, warmup_epochs=1), 90),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_jax(name):
    make, n = SCHEDULES[name]
    port, ref = make(schedules), make(j_schedules)
    got = np.array([port(s) for s in range(n)])
    want = np.array([float(ref(jnp.int32(s))) for s in range(n)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


# ----------------------------------------------------------- optimizers


class _Toy(torch.nn.Module):
    """A kernel, a bias and a position embedding (not decayed)."""

    def __init__(self, p0):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(p0["w"].copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(p0["b"].copy()))
        self.pos_embed = torch.nn.Parameter(
            torch.from_numpy(p0["pos_embed"].copy()))


def _toy_run(kind, steps=3):
    rng = np.random.default_rng(2)
    p0 = {"w": _np(rng, 4, 3), "b": _np(rng, 4),
          "pos_embed": _np(rng, 1, 2, 3)}
    grads = [{k: _np(rng, *v.shape) for k, v in p0.items()}
             for _ in range(steps)]
    sched_p = schedules.cosine_with_warmup(0.1, 2, 2, warmup_epochs=1)
    sched_j = j_schedules.cosine_with_warmup(0.1, 2, 2, warmup_epochs=1)
    model = _Toy(p0)
    if kind == "sgd":
        opt = optim.sgd_torch(model.parameters(), sched_p(0), 0.9, 1e-2)
        tx = j_optim.sgd_torch(sched_j, 0.9, 1e-2)
    elif kind == "adamw":
        opt = optim.adamw_timm(model, sched_p(0), weight_decay=0.05)
        tx = j_optim.adamw_timm(sched_j, p0, weight_decay=0.05)
    else:
        opt = optim.rmsprop_tf(model.parameters(), sched_p(0),
                               weight_decay=1e-2)
        tx = j_optim.rmsprop_tf(sched_j, weight_decay=1e-2)
    params = jax.tree.map(jnp.asarray, p0)
    state = tx.init(params)
    for step, g in enumerate(grads):
        for group in opt.param_groups:
            group["lr"] = sched_p(step)
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(g[name])
        opt.step()
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state,
                                   params)
        params = optax.apply_updates(params, updates)
    return model, params


@pytest.mark.parametrize("kind", ["sgd", "adamw", "rmsproptf"])
def test_optimizers_match_optax_over_three_updates(kind):
    model, params = _toy_run(kind)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params[name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_rmsprop_tf_one_step_by_hand():
    """sq0 = 1, g = 1 -> sq = 1; g' = 1 / sqrt(1 + eps); p -= lr·g'."""
    p = torch.nn.Parameter(torch.tensor([1.0]))
    opt = optim.rmsprop_tf([p], 0.1, decay=0.9, momentum=0.9, eps=1e-3)
    p.grad = torch.tensor([1.0])
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(),
                               [1.0 - 0.1 / np.sqrt(1.0 + 1e-3)], rtol=1e-6)


def _decayed_by_jax(model, kind):
    sd = _numpy_copy(model)
    if kind == "resnet":
        variables = convert_resnet_state_dict(sd)
    else:
        variables = convert_vit_state_dict(sd, variant="light")
    mask = j_optim.no_decay_mask(variables["params"])

    def fill(m, leaf):
        if isinstance(m, dict):
            return {k: fill(m[k], leaf[k]) for k in m}
        return np.full(np.shape(leaf), bool(m))

    masked = {"params": fill(mask, variables["params"])}
    if kind == "resnet":
        masked["batch_stats"] = variables["batch_stats"]
        port = state_dict_from_jax(masked)
    else:
        port = vit_state_dict_from_jax(masked, "light")
    names = dict(model.named_parameters())
    assert set(names) <= set(port)
    return {n for n in names if bool(port[n].all())}


# (some names not decayed, some decayed) of each model
NAMED = {
    "resnet": ({"layer1.0.mrla.mrla.Wq.weight", "layer1.0.mrla.mrla.Wk.weight",
                "layer1.0.mrla.lambda_t", "layer1.0.bn_mrla.weight",
                "layer2.0.downsample.1.bias", "bn1.weight", "fc.bias"},
               {"conv1.weight", "layer1.0.conv2.weight",
                "layer1.0.mrla.mrla.Wv.weight", "fc.weight"}),
    "deit": ({"cls_token", "pos_embed", "blocks.0.mrla.lambda_t",
              "blocks.0.mrla.mrla.Wq.weight", "blocks.1.mrla.mrla.Wk.weight",
              "blocks.0.norm1.weight", "blocks.0.mrla.normo.bias",
              "blocks.0.attn.qkv.bias", "norm.weight", "head.bias"},
             {"patch_embed.proj.weight", "blocks.0.attn.qkv.weight",
              "blocks.1.mlp.fc2.weight", "blocks.0.mrla.mrla.Wv.weight",
              "head.weight"}),
}


@pytest.mark.parametrize("kind", ["resnet", "deit"])
def test_adamw_no_decay_groups_are_the_jax_mask(kind):
    gen = torch.Generator().manual_seed(0)
    if kind == "resnet":
        model = ResNetMRLALight([1, 1], num_classes=10, generator=gen)
    else:
        model = ViTMRLA(**SMALL_VIT, generator=gen)
    want = _decayed_by_jax(model, kind)
    yes, no = optim.decay_groups(model)
    assert set(yes) == want
    assert set(no) == set(dict(model.named_parameters())) - want
    opt = optim.adamw_timm(model, 1e-3, weight_decay=0.05)
    params = dict(model.named_parameters())
    assert [g["weight_decay"] for g in opt.param_groups] == [0.05, 0.0]
    assert {id(p) for p in opt.param_groups[0]["params"]} == {
        id(params[n]) for n in want}
    # named: the MRLA taps and λ (1-D in the JAX tree), biases, norms and
    # tokens are not decayed; every other weight is
    assert NAMED[kind][0] <= set(no) and NAMED[kind][1] <= set(yes)
    assert all(params[n].ndim >= 2 for n in yes)


# ------------------------------------------------------- drop and data


@pytest.mark.parametrize("fn,rate", [(drop_path, 0.25), (dropout, 0.4)])
def test_drop_keeps_at_rate_and_scales(fn, rate):
    x = torch.rand(4000, 3, 5) + 0.5
    g = torch.Generator().manual_seed(0)
    y = fn(x, rate, g, True)
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / (1 - rate))
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.02
    if fn is drop_path:  # whole samples
        assert torch.equal(kept.all(dim=(1, 2)), kept.any(dim=(1, 2)))
    # eval mode or rate 0: the identity; the same generator seed: the same
    assert fn(x, rate, g, False) is x and fn(x, 0.0, g, True) is x
    assert torch.equal(fn(x, rate, torch.Generator().manual_seed(0), True), y)
    with pytest.raises(ValueError, match="generator"):
        fn(x, rate, None, True)


def test_drop_modules_take_the_generator_set_on_the_model():
    model = torch.nn.Sequential(DropPath(0.5), Dropout(0.5)).train()
    set_generator(model, torch.Generator().manual_seed(3))
    x = torch.ones(64, 8)
    a = model(x)
    set_generator(model, torch.Generator().manual_seed(3))
    assert torch.equal(model(x), a) and (a == 0).any()
    assert torch.equal(model.eval()(x), x)


@pytest.mark.parametrize("learnable", [False, True])
def test_synthetic_batches_bitwise(learnable):
    kw = dict(image_size=16, num_classes=7, steps=3, seed=5,
              learnable=learnable)
    for got, want in zip(synthetic_batches(4, **kw),
                         j_synthetic.synthetic_batches(4, **kw)):
        for k in ("image", "label"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_normalize_and_eval_geometry_match_jax():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (2, 5, 6, 3)).astype(np.uint8)
    np.testing.assert_allclose(normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(j_transforms.normalize(
                                   jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    for h, w, crop in ((300, 400, 224), (500, 333, 224), (64, 48, 32),
                       (97, 130, 224)):
        assert eval_transform_params(h, w, crop) == \
            j_transforms.eval_transform_params(h, w, crop)


@pytest.mark.parametrize("hw,out", [((300, 400), 224), ((97, 130), 224),
                                    ((90, 60), 32)])
def test_center_crop_resize_matches_jax(hw, out):
    """A downscale (300 x 400 -> 256 x 341, 90 x 60 -> 54 x 36) and an
    upscale (97 x 130 -> 256 x 343); values in [0, 255]."""
    img = np.random.default_rng(4).uniform(0, 255, hw + (3,)).astype(
        np.float32)
    got = center_crop_resize(torch.from_numpy(img), out)
    want = np.asarray(j_transforms.center_crop_resize(jnp.asarray(img),
                                                      out))
    assert got.shape == want.shape == (out, out, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def _jax_draw(images, out, targets, labels, k, ls):
    """The JAX call's draw, read off its output: λ from the targets, the
    mode from whether every pixel is one of the pair's, the box from where
    the output took the reversed batch."""
    off = ls / k
    on = 1.0 - ls + off
    i = int(np.nonzero(labels != labels[::-1])[0][0])
    lam = (targets[i, labels[i]] - off) / (on - off)
    flipped = images[::-1]
    took = out == flipped
    if not np.all(took | (out == images)):
        return MixDraw(False, float(lam), (0, 0, 0, 0))
    rows = np.nonzero(took.all(axis=(0, 3)).any(1))[0]
    cols = np.nonzero(took.all(axis=(0, 3)).any(0))[0]
    box = ((rows[0], rows[-1] + 1, cols[0], cols[-1] + 1) if rows.size
           else (0, 0, 0, 0))
    return MixDraw(True, float(lam), tuple(int(v) for v in box))


@pytest.mark.parametrize("seed", range(6))
def test_mixup_cutmix_applied_with_the_jax_draws(seed):
    rng = np.random.default_rng(seed)
    images = _np(rng, 6, 12, 10, 3)
    labels = np.array([0, 1, 2, 3, 4, 5], np.int32)
    out, targets = j_transforms.mixup_cutmix(
        jax.random.key(seed), jnp.asarray(images), jnp.asarray(labels), 7,
        label_smoothing=0.1)
    out, targets = np.asarray(out), np.asarray(targets)
    draw = _jax_draw(images, out, targets, labels, 7, 0.1)
    got, got_t = apply_mixup_cutmix(torch.from_numpy(images),
                                    torch.from_numpy(labels), 7, draw, 0.1)
    np.testing.assert_allclose(got.numpy(), out, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_t.numpy(), targets, rtol=1e-5,
                               atol=1e-6)
    if draw.use_cutmix:  # λ is the box's uncovered share
        y0, y1, x0, x1 = draw.box
        np.testing.assert_allclose(
            draw.lam, 1 - (y1 - y0) * (x1 - x0) / 120, atol=1e-6)


def test_mixup_cutmix_draws_from_the_host_generator():
    x = torch.from_numpy(_np(np.random.default_rng(0), 4, 8, 8, 3))
    y = torch.arange(4)
    a = mixup_cutmix(np.random.default_rng(9), x, y, 5)
    b = mixup_cutmix(np.random.default_rng(9), x, y, 5)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    cut = draw_mixup_cutmix(np.random.default_rng(1), 8, 8, switch_prob=1.0)
    mix = draw_mixup_cutmix(np.random.default_rng(1), 8, 8, switch_prob=0.0)
    assert cut.use_cutmix and not mix.use_cutmix and 0 <= mix.lam <= 1
    (y0, y1, x0, x1) = cut.box
    assert cut.lam == pytest.approx(1 - (y1 - y0) * (x1 - x0) / 64)
    np.testing.assert_allclose(a[1].sum(-1).numpy(), 1.0, rtol=1e-6)


def test_random_erasing_and_flip():
    x = torch.from_numpy(_np(np.random.default_rng(5), 6, 20, 16, 3))
    boxes = draw_erasing(np.random.default_rng(2), 6, 20, 16, prob=1.0)
    y = random_erasing(np.random.default_rng(2), x,
                       torch.Generator().manual_seed(0), prob=1.0)
    for i, (top, left, eh, ew) in enumerate(boxes):
        assert 1 <= eh <= 19 and 1 <= ew <= 15
        inside = torch.zeros(20, 16, dtype=torch.bool)
        inside[top:top + eh, left:left + ew] = True
        assert torch.equal(y[i][~inside], x[i][~inside])
        assert not torch.isclose(y[i][inside], x[i][inside]).any()
    none = random_erasing(np.random.default_rng(2), x,
                          torch.Generator().manual_seed(0), prob=0.0)
    assert torch.equal(none, x)
    f = random_flip(x, torch.Generator().manual_seed(1))
    flipped = [torch.equal(f[i], x[i].flip(1)) for i in range(6)]
    kept = [torch.equal(f[i], x[i]) for i in range(6)]
    assert all(a != b for a, b in zip(flipped, kept)) and any(flipped)


# ------------------------------------------------------------ eval step


def test_eval_step_top1_top5_with_valid_mask():
    gen = torch.Generator().manual_seed(0)
    port = ResNetMRLALight([1, 1], num_classes=10, generator=gen).eval()
    sd = _numpy_copy(port)
    variables = convert_resnet_state_dict(sd)
    model = FlaxResNet(layers=[1, 1], num_classes=10)
    j_state = j_create_train_state(
        model, jax.random.key(0), jnp.zeros((1, 32, 32, 3)), optax.sgd(0.1),
        variables=jax.tree.map(jnp.asarray, variables))
    rng = np.random.default_rng(6)
    x = _np(rng, 8, 32, 32, 3)
    logits = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    order = np.argsort(-logits, axis=-1)
    # rows 0-2 hit top-1, 3-5 only top-5, 6-7 miss both
    labels = np.concatenate([order[:3, 0], order[3:6, 3],
                             order[6:, 9]]).astype(np.int32)
    valid = np.array([1, 1, 0, 1, 0, 1, 1, 0], bool)
    want = make_eval_step()(j_state, {"image": jnp.asarray(x),
                                      "label": jnp.asarray(labels),
                                      "valid": jnp.asarray(valid)})
    state = create_train_state(port, torch.optim.SGD(port.parameters(), 0.1),
                               lambda s: 0.1)
    got = eval_step(state, {"image": torch.from_numpy(x),
                            "label": torch.from_numpy(labels),
                            "valid": torch.from_numpy(valid)})
    assert {k: int(v) for k, v in got.items()} == {
        k: int(v) for k, v in want.items()} == {"top1": 2, "top5": 4,
                                                "count": 5}
    with pytest.raises(ValueError, match="EMA"):
        eval_step(state, {"image": torch.from_numpy(x),
                          "label": torch.from_numpy(labels)}, use_ema=True)
