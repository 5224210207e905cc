"""The port's RetinaNet (anchors, soft-NMS, targets, the focal loss, the FPN's
``start_level`` / ``add_extra_convs``, the head, the detector, its decode,
its training step, the serving pyramid) against the JAX package, in fp32
on the CPU.

The detector is the port's (layers (1, 1, 1, 1), full widths, 3 classes,
the head spread by ``testing.training_retinanet``), carried to Flax by the
JAX package's own ``convert_mmdet_state_dict``: that the converted tree
applies in JAX and gives the port's outputs proves the mmdet keys.

Tolerances: anchor targets and NMS picks exactly; box and loss arithmetic
fed the same inputs 1e-5 of the largest |value| (fp32 ulps of exp / log);
network outputs the JAX package's serving tolerances (rtol 2e-3, atol
3e-4, as ``tests/test_torch_detect.py``); a training step's loss terms,
gradients and running statistics 1e-4 of the largest |value| of each
tensor (fp32 sums in another order, as ``tests/test_torch_detect_train.py``),
but the gradients of a step with BN on batch statistics 5e-3 of their
norm (``GRAD_NORM_TOL``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrla_tpu.ckpt.detect_convert import convert_mmdet_state_dict
from mrla_tpu.detect import bbox as j_bbox
from mrla_tpu.detect import losses as j_losses
from mrla_tpu.detect import retinanet as j_retina
from mrla_tpu.detect.anchors import num_base_anchors as j_num_base_anchors
from mrla_tpu.detect.anchors import pyramid_anchors as j_pyramid_anchors
from mrla_tpu.detect.fpn import FPN as JFPN
from mrla_tpu.detect.targets import anchor_targets as j_anchor_targets
from mrla_tpu.serving import detect as j_serving
from mrla_tpu_torch.ckpt import converter_for, retinanet_state_dict_from_jax
from mrla_tpu_torch.detect import bbox, losses, retinanet
from mrla_tpu_torch.detect.anchors import num_base_anchors, pyramid_anchors
from mrla_tpu_torch.detect.fpn import FPN
from mrla_tpu_torch.detect.targets import anchor_targets
from mrla_tpu_torch.serving.detect import detect_forward, prepare_detect_params
from mrla_tpu_torch.testing import images, training_retinanet
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

RTOL, ATOL = 2e-3, 3e-4
LAYERS = (1, 1, 1, 1)
HW = (96, 128)  # P3 12 x 16 .. P7 1 x 1; not square, so x / y faults show
STRIDES = (8, 16, 32, 64, 128)


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    with jax.default_matmul_precision("float32"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rel * max(np.abs(want).max(), 1.0), err


def _allclose(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL)


def _boxes(rng, shape, canvas=(96.0, 128.0), smin=6.0, smax=60.0):
    xy = rng.uniform(0, 1, shape + (2,)) * np.array(canvas[::-1])
    wh = rng.uniform(smin, smax, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _sizes(hw=HW):
    out, h, w = [], hw[0] // 8, hw[1] // 8
    for _ in STRIDES:
        out.append((h, w))
        h, w = -(-h // 2), -(-w // 2)
    return out


def _level_outputs(rng, b=2, c=3, a=9):
    return [(2 * rng.standard_normal((b, h, w, a * c)).astype(np.float32)
             - 2.0,
             0.3 * rng.standard_normal((b, h, w, a * 4)).astype(np.float32))
            for h, w in _sizes()]


def _gts(rng, b=2, g=5):
    gt = _boxes(rng, (b, g))
    valid = np.ones((b, g), bool)
    valid[0, 3:] = False
    gt[0, 3:] = 0.0  # padded zero rows: log(0) deltas, masked
    labels = rng.integers(0, 3, (b, g)).astype(np.int32)
    return gt, labels, valid


@pytest.fixture(scope="module")
def retina():
    """The port's detector, its mmdet state_dict carried to Flax, the JAX
    module and two images."""
    model = training_retinanet(0, LAYERS, 3, px=HW)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    variables = jax.tree.map(lambda a: jnp.array(np.array(a)),
                             convert_mmdet_state_dict(sd, num_laterals=3))
    jm = j_retina.RetinaNet(layers=LAYERS, num_classes=3)
    x = images(torch.Generator().manual_seed(1), 2, HW)
    return model, sd, variables, jm, x


# ------------------------------------------------------- anchors, NMS, loss


def test_num_base_anchors_and_anchors_match():
    for spo, ratios in ((3, (0.5, 1.0, 2.0)), (2, (1.0,)), (1, (0.5, 2.0))):
        assert num_base_anchors(spo, ratios) == j_num_base_anchors(
            spo, ratios)
    for g, w in zip(pyramid_anchors(_sizes(), STRIDES),
                    j_pyramid_anchors(_sizes(), STRIDES)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("method", ["linear", "gaussian"])
def test_soft_nms_matches(method):
    rng = np.random.default_rng(2)
    boxes = _boxes(rng, (2, 60))
    scores = rng.uniform(0.0, 1.0, (2, 60)).astype(np.float32)
    boxes[:, 10:14] = boxes[:, :1]  # exact duplicates: IoU 1, decay 0
    scores[:, 20:30] = 0.0  # absent
    got = bbox.soft_nms_fixed(_t(boxes), _t(scores), 0.3, 40, method)
    for i in range(2):
        want = jax.jit(lambda b, s: j_bbox.soft_nms_fixed(
            b, s, 0.3, 40, method))(jnp.asarray(boxes[i]),
                                    jnp.asarray(scores[i]))
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[2]))
        _close(got[1][i], want[1])
    assert torch.isfinite(got[1]).all() and got[2].any()


def test_anchor_targets_and_focal_loss_match():
    rng = np.random.default_rng(3)
    anchors = np.concatenate(pyramid_anchors(_sizes(), STRIDES))
    gt, labels, valid = _gts(rng)
    got = anchor_targets(_t(anchors), _t(gt), _t(labels), _t(valid), 3)
    want = jax.jit(jax.vmap(lambda g, l, v: j_anchor_targets(
        jnp.asarray(anchors), g, l, v, 3)))(jnp.asarray(gt),
                                            jnp.asarray(labels),
                                            jnp.asarray(valid))
    for k in (0, 1, 3, 4):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    _close(got[2], want[2])
    assert int(got[4].sum()) > 0 and (got[1] == 0).any()  # pos and ignored
    logits = 4 * rng.standard_normal((500, 3)).astype(np.float32)
    target = (rng.random((500, 3)) < 0.3).astype(np.float32)
    _close(losses.sigmoid_focal_loss(_t(logits), _t(target)),
           j_losses.sigmoid_focal_loss(jnp.asarray(logits),
                                       jnp.asarray(target)))


def test_get_bboxes_matches():
    """Identical head outputs: boxes, scores, labels and valid; nms_pre 150
    keeps a top-k on the two largest levels."""
    rng = np.random.default_rng(4)
    outs = _level_outputs(rng)
    got = retinanet.get_bboxes([(_t(c), _t(r)) for c, r in outs], HW,
                               nms_pre=150)
    want = jax.jit(lambda o: j_retina.get_bboxes(o, HW, nms_pre=150))(
        [(jnp.asarray(c), jnp.asarray(r)) for c, r in outs])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert got[3].sum(1).min() > 10


def test_retinanet_loss_and_grad_match():
    rng = np.random.default_rng(5)
    outs = _level_outputs(rng)
    gt, labels, valid = _gts(rng)

    def jloss(o):
        r = j_losses.retinanet_loss(o, jnp.asarray(gt), jnp.asarray(labels),
                                    jnp.asarray(valid), 3)
        return r["loss"], r

    (_, want), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        [(jnp.asarray(c), jnp.asarray(r)) for c, r in outs])
    leaves = [(_t(c).requires_grad_(), _t(r).requires_grad_())
              for c, r in outs]
    got = losses.retinanet_loss(leaves, _t(gt), _t(labels), _t(valid), 3)
    got["loss"].backward()
    assert int(got["num_pos"]) == int(want["num_pos"]) > 0
    for k in ("loss", "loss_cls", "loss_bbox"):
        _close(got[k].item(), float(want[k]))
    for (gc, gr), (wc, wr) in zip(leaves, jg):
        _close(gc.grad, wc, 1e-4)
        _close(gr.grad, wr, 1e-4)


# ----------------------------------------------------------- neck and head


def _neck_tree(neck: FPN):
    """The port FPN's weights as the JAX FPN's params."""
    tree, n = {}, neck.num_laterals
    for i, m in enumerate(neck.lateral_convs):
        tree[f"lateral{i}"] = m.conv
    for i, m in enumerate(neck.fpn_convs):
        tree[f"fpn_conv{i}" if i < n else f"extra_conv{i}"] = m.conv
    return {k: {"kernel": jnp.asarray(c.weight.detach().permute(
                    2, 3, 1, 0).numpy()),
                "bias": jnp.asarray(c.bias.detach().numpy())}
            for k, c in tree.items()}


@pytest.mark.parametrize("extra", ["on_input", "on_output"])
def test_fpn_start_level_matches(extra):
    gen = torch.Generator().manual_seed(6)
    chans = (64, 96, 128, 160)
    neck = FPN(in_channels=chans, out_channels=32, num_outs=5, start_level=1,
               add_extra_convs=extra, generator=gen)
    assert len(neck.lateral_convs) == 3 and len(neck.fpn_convs) == 5
    feats = [torch.randn(2, 24 // 2 ** i, 30 // 2 ** i + 1, c, generator=gen)
             for i, c in enumerate(chans)]
    got = neck(feats)
    want = JFPN(out_channels=32, num_outs=5, start_level=1,
                add_extra_convs=extra).apply(
        {"params": _neck_tree(neck)}, [jnp.asarray(f.numpy()) for f in feats])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _allclose(g.detach(), w)


def test_retina_head_init_and_sharing():
    model = retinanet.RetinaNet(LAYERS, num_classes=3,
                                generator=torch.Generator().manual_seed(7))
    head = model.bbox_head
    prior = -np.log((1 - 0.01) / 0.01)
    assert torch.allclose(head.retina_cls.bias, torch.full((27,), prior))
    assert head.retina_reg.bias.abs().max() == 0
    convs = [m.conv for m in (*head.cls_convs, *head.reg_convs)]
    assert len(convs) == 8
    for c in convs + [head.retina_cls, head.retina_reg]:
        assert abs(c.weight.std().item() - 0.01) < 0.001
    # one head, applied to every level
    calls = []
    handle = head.register_forward_hook(lambda m, a, o: calls.append(
        (a[0], o)))
    x = images(torch.Generator().manual_seed(8), 1, HW)
    with torch.no_grad():
        outs = model.eval()(x)
        handle.remove()
        assert len(calls) == 5
        for (f, o), level in zip(calls, outs):
            ref = head(f)
            assert torch.equal(o[0], level[0]) and torch.equal(ref[0],
                                                               level[0])
            assert torch.equal(ref[1], level[1])


# ---------------------------------------------------------- the detector


def test_retinanet_forward_matches_jax(retina):
    """The port's forward against RetinaNet.apply on the tree the JAX
    package's converter made of the port's state_dict; the bridge back
    gives the state_dict again."""
    model, sd, variables, jm, x = retina
    with torch.no_grad():
        got = model(x)
    want = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        variables, jnp.asarray(x.numpy()))
    assert [tuple(c.shape) for c, _ in got] == [
        (2, h, w, 27) for h, w in _sizes()]
    for (gc, gr), (wc, wr) in zip(got, want):
        _allclose(gc, wc)
        _allclose(gr, wr)
    back = converter_for("retinanet_r50mrlal_fpn_1x_coco")(variables)
    assert back.keys() == sd.keys()
    for k, v in back.items():  # the bridge counts no BN batches
        assert torch.equal(v, sd[k]) or k.endswith("num_batches_tracked"), k
    assert retinanet_state_dict_from_jax is converter_for("retinanet")


def test_detect_forward_start_level_matches_jax(retina):
    """The serving pyramid with RetinaNet's neck against the JAX
    ``detect_forward`` and the module's P3..P7."""
    model, _, variables, _, x = retina
    params = prepare_detect_params(model, LAYERS, torch.float32, "cpu")
    got = detect_forward(params, x, LAYERS, start_level=1,
                         add_extra_convs="on_input")
    jp = j_serving.prepare_detect_params(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}, LAYERS, jnp.float32)
    want = j_serving.detect_forward(jp, jnp.asarray(x.numpy()), LAYERS,
                                    start_level=1, add_extra_convs="on_input")
    with torch.no_grad():
        own = model.neck(model.backbone(x))
    for g, w, o in zip(got, want, own):
        _allclose(g, w)
        _allclose(g, o)


def _step(model, x, batch):
    out = losses.retinanet_loss(model(x), *batch, num_classes=3)
    out["loss"].backward()
    return out


# BN on the batch statistics of 2 images (12 values a channel on layer4's
# 3 x 4 map) amplifies the two forwards' fp32 differences: the step's
# gradients agree to 1-2e-3 of their norm, where the same step with the BN
# frozen agrees to 4e-5 (and the loss terms to 4e-7 either way)
GRAD_NORM_TOL = 5e-3
LEAVES = ("bbox_head.retina_cls.weight", "bbox_head.reg_convs.3.conv.bias",
          "neck.fpn_convs.3.conv.weight", "neck.lateral_convs.0.conv.weight",
          "backbone.layer4.0.conv2.weight", "backbone.layer2.0.bn_mrla.weight")
STATS = ("backbone.bn1", "backbone.layer1.0.bn3", "backbone.layer4.0.bn_mrla")


def test_training_step_matches_jax_without_norm_eval(retina):
    """``--no-norm-eval``'s step: BN on batch statistics.  The loss terms,
    the gradients of a few leaves and the running statistics against
    jax.value_and_grad of retinanet_loss with mutable batch_stats."""
    model, sd, variables, jm, x = retina
    rng = np.random.default_rng(9)
    gt, labels, valid = _gts(rng)
    batch = (_t(gt), _t(labels), _t(valid))

    def loss_fn(params):
        outs, mut = jm.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             jnp.asarray(x.numpy()), train=True,
                             mutable=["batch_stats"])
        r = j_losses.retinanet_loss(outs, jnp.asarray(gt),
                                    jnp.asarray(labels), jnp.asarray(valid),
                                    3)
        return r["loss"], (r, mut["batch_stats"])

    (_, (want, jstats)), jg = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    jgrads = retinanet_state_dict_from_jax(
        {"params": jg, "batch_stats": jstats})
    jnew = retinanet_state_dict_from_jax(
        {"params": variables["params"], "batch_stats": jstats})

    model.load_state_dict(sd)
    model.train()
    try:
        got = _step(model, x, batch)
        params = dict(model.named_parameters())
        grads = {k: params[k].grad.clone() for k in LEAVES}
        now = {k: v.clone() for k, v in model.state_dict().items()}
    finally:
        model.eval()
        model.load_state_dict(sd)
        model.zero_grad(set_to_none=True)
    assert int(got["num_pos"]) == int(want["num_pos"]) > 0
    for k in ("loss", "loss_cls", "loss_bbox"):
        _close(got[k].item(), float(want[k]), 1e-4)
    for k in LEAVES:
        w = np.asarray(jgrads[k])
        assert np.linalg.norm(grads[k].numpy() - w) <= GRAD_NORM_TOL * \
            np.linalg.norm(w), k
    for prefix in STATS:
        for s in ("running_mean", "running_var"):
            k = f"{prefix}.{s}"
            assert not torch.equal(now[k], sd[k]), k  # the statistics moved
            _close(now[k], jnew[k], 1e-4)


def test_remat_gradients_equal(retina):
    """``--remat`` recomputes the backbone blocks in the backward, BN frozen
    as the presets train: every gradient bit for bit as without it."""
    model, sd, _, _, x = retina
    x = x[:, :64, :64].contiguous()  # any size does; the smallest with P7
    rng = np.random.default_rng(10)
    gt, labels, valid = _gts(rng)
    batch = (_t(gt), _t(labels), _t(valid))
    remat = retinanet.RetinaNet(LAYERS, num_classes=3, remat=True).eval()
    remat.load_state_dict(sd)
    grads = []
    for m in (model, remat):
        m.zero_grad(set_to_none=True)
        _step(m, x, batch)
        grads.append({k: p.grad.clone() for k, p in m.named_parameters()})
    model.zero_grad(set_to_none=True)
    assert grads[0].keys() == grads[1].keys()
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k
    assert grads[0]["backbone.layer1.0.conv1.weight"].abs().max() > 0
