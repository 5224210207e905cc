"""The port's detection modules against the JAX package, in fp32 on the CPU.

Inputs are made from seeds with numpy and handed to both packages.  The
detectors are initialised once, by the port (``FasterRCNN`` / ``MaskRCNN``
with the heads spread by ``testing.spread_detector_weights``, so that
scores differ between anchors and classes), and carried to Flax by the
JAX package's ``convert_mmdet_two_stage``; the bridge back,
``detector_state_dict_from_jax``, is held to that converter both ways.
Tolerances: 1e-5 relative to the largest |value| for box and NMS
arithmetic fed the same inputs (fp32 ulps of exp / sigmoid), and the JAX
package's serving tolerances (rtol 2e-3, atol 3e-4) for network outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrla_tpu.ckpt.detect_convert import convert_mmdet_two_stage
from mrla_tpu.detect import anchors as j_anchors
from mrla_tpu.detect import bbox as j_bbox
from mrla_tpu.detect import two_stage as j_two
from mrla_tpu.detect.fpn import FPN as JFPN
from mrla_tpu.models.resnet_mrla_light import ResNetMRLALight as JResNet
from mrla_tpu_torch.ckpt import detector_state_dict_from_jax
from mrla_tpu_torch.detect import anchors, bbox, two_stage
from mrla_tpu_torch.detect.fpn import FPN
from mrla_tpu_torch.models import ResNetMRLALight
from mrla_tpu_torch.testing import spread_detector_weights
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

RTOL, ATOL = 2e-3, 3e-4
KW = dict(layers=(1, 1, 1, 1), num_classes=4, rpn_nms_pre=100,
          num_proposals=20, roi_sampling_ratio=0)


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    with jax.default_matmul_precision("float32"):
        yield


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rel * max(np.abs(want).max(), 1.0), err


def _boxes(rng, n, canvas=100.0, smin=2.0, smax=60.0):
    xy = rng.uniform(0, canvas, (n, 2))
    wh = rng.uniform(smin, smax, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ------------------------------------------------------------- box arithmetic


@pytest.mark.parametrize("sizes,strides,base,spo", [
    ([(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)], (4, 8, 16, 32, 64), 8.0, 1),
    ([(5, 7), (3, 4)], (8, 16), 4.0, 3),
])
def test_anchors_match(sizes, strides, base, spo):
    got = anchors.pyramid_anchors(sizes, strides, base, spo)
    want = j_anchors.pyramid_anchors(sizes, strides, base, spo)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_box_coding_matches():
    rng = np.random.default_rng(0)
    rois = _boxes(rng, 300)
    deltas = rng.standard_normal((300, 4)).astype(np.float32) * 2.0
    deltas[:5, 2:] = 9.0  # beyond |log(wh_ratio_clip)|: clamped
    for kw in ({}, {"stds": (0.1, 0.1, 0.2, 0.2), "max_shape": (80, 120)}):
        got = bbox.delta2bbox(_t(rois), _t(deltas), **kw)
        _close(got, j_bbox.delta2bbox(jnp.asarray(rois), jnp.asarray(deltas),
                                      **kw))
    gt = _boxes(rng, 300)
    got = bbox.bbox2delta(_t(rois), _t(gt), stds=(0.1, 0.1, 0.2, 0.2))
    _close(got, j_bbox.bbox2delta(jnp.asarray(rois), jnp.asarray(gt),
                                  stds=(0.1, 0.1, 0.2, 0.2)))
    a, b = _boxes(rng, 50), _boxes(rng, 70)
    b[:3] = a[:3]  # identical boxes: IoU 1
    b[3] = [5, 5, 5, 9]  # zero area
    _close(bbox.bbox_overlaps(_t(a), _t(b)),
           j_bbox.bbox_overlaps(jnp.asarray(a), jnp.asarray(b)))


def _nms_case(kind, rng):
    n = 200
    boxes = _boxes(rng, n, canvas=60.0, smin=10.0, smax=40.0)
    scores = rng.uniform(0.01, 1.0, n).astype(np.float32)
    if kind == "ties":  # equal scores, duplicate boxes, equal both
        scores[::3] = scores[0]
        boxes[10:20] = boxes[0]
        scores[10:20] = 0.5
    elif kind == "absent":  # zero and negative scores are never picked
        scores[::2] = 0.0
        scores[1::7] = -0.3
    elif kind == "few":  # fewer candidates than slots
        scores[5:] = 0.0
    return boxes, scores


@pytest.mark.parametrize("kind", ["random", "ties", "absent", "few"])
@pytest.mark.parametrize("thr", [0.3, 0.7])
def test_nms_fixed_matches(kind, thr):
    boxes, scores = _nms_case(kind, np.random.default_rng(1))
    idx, valid = bbox.nms_fixed(_t(boxes), _t(scores), thr, 60)
    j_idx, j_valid = j_bbox.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores),
                                      thr, 60)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))


def test_nms_fixed_batched_equals_per_image():
    rng = np.random.default_rng(2)
    cases = [_nms_case(k, rng) for k in ("random", "ties", "absent")]
    boxes = _t(np.stack([c[0] for c in cases]))
    scores = _t(np.stack([c[1] for c in cases]))
    idx, valid = bbox.nms_fixed(boxes, scores, 0.5, 40)
    for i in range(3):
        one = bbox.nms_fixed(boxes[i], scores[i], 0.5, 40)
        assert torch.equal(idx[i], one[0]) and torch.equal(valid[i], one[1])


@pytest.mark.parametrize("specific", [True, False])
def test_multiclass_nms_fixed_matches(specific):
    rng = np.random.default_rng(3)
    n, k = 120, 5
    boxes = _boxes(rng, n * k, canvas=60.0, smin=10.0, smax=40.0)
    boxes = boxes.reshape(n, k, 4) if specific else boxes[:n]
    scores = rng.dirichlet(np.ones(k + 1), n)[:, :k].astype(np.float32)
    scores[::4] = scores[0]  # ties across rows
    scores[:, 2] *= 0.1  # a class mostly under the threshold
    got = bbox.multiclass_nms_fixed(_t(boxes), _t(scores), 0.05, 0.5, 30,
                                    pre_nms_top_n=200)
    want = j_bbox.multiclass_nms_fixed(jnp.asarray(boxes),
                                       jnp.asarray(scores), 0.05, 0.5, 30,
                                       pre_nms_top_n=200)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_rpn_proposals_match():
    """The same head outputs through both: levels above and below nms_pre,
    objectness logits spread and with exact ties."""
    rng = np.random.default_rng(4)
    sizes = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    outs = []
    for h, w in sizes:
        # distinct logits 0.01 apart, then exact ties
        cls = np.stack([rng.permutation(h * w * 3).reshape(h, w, 3)
                        for _ in range(2)]).astype(np.float32) * 0.01 - 2.0
        cls[:, ::2, ::3] = 0.25  # ties
        reg = rng.standard_normal((2, h, w, 12)).astype(np.float32) * 0.3
        outs.append((cls, reg))
    got = two_stage.rpn_proposals([(_t(c), _t(r)) for c, r in outs],
                                  (64, 64), nms_pre=150, max_per_img=80)
    want = jax.jit(lambda o: j_two.rpn_proposals(
        o, (64, 64), nms_pre=150, max_per_img=80))(
        [(jnp.asarray(c), jnp.asarray(r)) for c, r in outs])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(got[0], want[0])
    _close(got[1], want[1])


# ------------------------------------------------------------------ modules


def test_features_only_matches():
    model = ResNetMRLALight([1, 1, 1, 1], features_only=True,
                            generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.1, 0.5)
                m.running_mean.uniform_(-0.2, 0.2)
    assert not hasattr(model, "fc")
    x = np.random.default_rng(5).standard_normal((2, 64, 96, 3)).astype(
        np.float32)
    with torch.no_grad():
        got = model(_t(x))
    from mrla_tpu.ckpt import convert_resnet_state_dict

    v = convert_resnet_state_dict(model.state_dict())
    jm = JResNet(layers=[1, 1, 1, 1], features_only=True,
                 use_drop_path=False)
    want = jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(
        v, jnp.asarray(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), RTOL, ATOL)


def test_fpn_matches():
    rng = np.random.default_rng(6)
    neck = FPN(generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in neck.parameters():
            p.normal_(0.0, 0.05)
    # odd sizes: the top-down upsample is not an exact 2x
    ins = [rng.standard_normal((2, h, w, c)).astype(np.float32)
           for (h, w), c in zip([(17, 25), (9, 13), (5, 7), (3, 4)],
                                (256, 512, 1024, 2048))]
    with torch.no_grad():
        got = neck([_t(a) for a in ins])
    params = {}  # OIHW -> HWIO, as the JAX package's neck converter
    for kind, name in (("lateral_convs", "lateral"),
                       ("fpn_convs", "fpn_conv")):
        for i, m in enumerate(getattr(neck, kind)):
            params[f"{name}{i}"] = {
                "kernel": m.conv.weight.detach().numpy().transpose(2, 3, 1, 0),
                "bias": m.conv.bias.detach().numpy()}
    want = jax.jit(JFPN(out_channels=256, num_outs=5).apply)(
        {"params": params}, [jnp.asarray(a) for a in ins])
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), RTOL, ATOL)


@pytest.mark.parametrize("head", ["rpn", "bbox", "mask"])
def test_heads_match(head):
    rng = np.random.default_rng(7)
    gen = torch.Generator().manual_seed(2)
    if head == "rpn":
        mod = two_stage.RPNHead(64, 64, 3, gen)
        jmod = j_two.RPNHead(feat_channels=64, num_anchors=3)
        x = rng.standard_normal((2, 9, 11, 64))
        scope = "rpn_head"
        prefix = "rpn_head."
    elif head == "bbox":
        mod = two_stage.Shared2FCBBoxHead(32, num_classes=6, generator=gen)
        jmod = j_two.Shared2FCBBoxHead(num_classes=6)
        x = rng.standard_normal((2, 5, 7, 7, 32))
        scope, prefix = "bbox_head", "roi_head.bbox_head."
    else:
        mod = two_stage.FCNMaskHead(32, 32, num_classes=3, generator=gen)
        jmod = j_two.FCNMaskHead(num_classes=3, conv_out_channels=32)
        x = rng.standard_normal((2, 3, 14, 14, 32))
        scope, prefix = "mask_head", "roi_head.mask_head."
    with torch.no_grad():
        for p in mod.parameters():  # every weight and bias matters
            p.normal_(0.0, 0.1)
    x = x.astype(np.float32)
    sd = {prefix + k: v for k, v in mod.state_dict().items()}
    params = {"params": _head_tree(scope, sd)}
    with torch.no_grad():
        got = mod(_t(x))
    want = jmod.apply(params, jnp.asarray(x))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), RTOL, ATOL)


def _head_tree(scope, sd):
    from mrla_tpu.ckpt import detect_convert as dc

    return {"rpn_head": dc._convert_rpn_head,
            "bbox_head": dc._convert_bbox_head,
            "mask_head": dc._convert_mask_head}[scope](sd)


# ---------------------------------------------------------------- detectors


@pytest.fixture(scope="module")
def detectors():
    """Port MaskRCNN / FasterRCNN at layers (1, 1, 1, 1), full widths,
    spread heads, perturbed BN statistics; their Flax trees."""
    out = {}
    for name, cls in (("faster", two_stage.FasterRCNN),
                      ("mask", two_stage.MaskRCNN)):
        gen = torch.Generator().manual_seed(3)
        model = cls(generator=gen, **KW).eval()
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.weight.uniform_(0.1, 0.5, generator=gen)
                    m.running_var.uniform_(0.5, 1.5, generator=gen)
        spread_detector_weights(model, gen, px=(128, 128))
        out[name] = (model, convert_mmdet_two_stage(model.state_dict()))
    return out


def _images(seed, b=2, hw=(128, 128)):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, *hw, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ["faster", "mask"])
def test_detector_eval_outputs_match(detectors, name):
    model, v = detectors[name]
    jcls = j_two.MaskRCNN if name == "mask" else j_two.FasterRCNN
    jm = jcls(**KW)
    x = _images(8)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, jnp.asarray(x))
    with torch.no_grad():
        got = model(_t(x))
    for g, w in zip(got["feats"], want["feats"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), RTOL, ATOL)
    for (gc, gr), (wc, wr) in zip(got["rpn"], want["rpn"]):
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), RTOL, ATOL)
        np.testing.assert_allclose(gr.numpy(), np.asarray(wr), RTOL, ATOL)
    np.testing.assert_array_equal(got["proposal_valid"].numpy(),
                                  np.asarray(want["proposal_valid"]))
    np.testing.assert_allclose(got["proposals"].numpy(),
                               np.asarray(want["proposals"]), 1e-4, 1e-3)
    np.testing.assert_allclose(got["cls"].numpy(), np.asarray(want["cls"]),
                               RTOL, ATOL)
    np.testing.assert_allclose(got["reg"].numpy(), np.asarray(want["reg"]),
                               RTOL, ATOL)
    if name == "mask":  # the mask branch on the same pooled features
        feats = np.random.default_rng(9).standard_normal(
            (2, 3, 14, 14, 256)).astype(np.float32)
        with torch.no_grad():
            g = model.mask_forward(_t(feats))
        w = jm.apply(v, jnp.asarray(feats),
                     method=j_two.FasterRCNN.mask_forward)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), RTOL, ATOL)


@pytest.mark.parametrize("name", ["faster", "mask"])
def test_two_stage_predict_matches(detectors, name):
    model, v = detectors[name]
    jcls = j_two.MaskRCNN if name == "mask" else j_two.FasterRCNN
    jm = jcls(**KW)
    x = _images(10)
    want = jax.jit(lambda v, x: j_two.two_stage_predict(
        jm, v, x, max_per_img=10))(v, jnp.asarray(x))
    got = two_stage.two_stage_predict(model, _t(x), max_per_img=10)
    assert set(got) == set(want)
    assert got["det_valid"].sum() > 0
    np.testing.assert_array_equal(got["det_valid"].numpy(),
                                  np.asarray(want["det_valid"]))
    np.testing.assert_array_equal(got["det_labels"].numpy(),
                                  np.asarray(want["det_labels"]))
    np.testing.assert_allclose(got["det_boxes"].numpy(),
                               np.asarray(want["det_boxes"]), 1e-4, 1e-3)
    np.testing.assert_allclose(got["det_scores"].numpy(),
                               np.asarray(want["det_scores"]), RTOL, ATOL)
    if name == "mask":
        np.testing.assert_allclose(got["masks"].numpy(),
                                   np.asarray(want["masks"]), RTOL, ATOL)


# ------------------------------------------------------------ weight bridge


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]),
                                          err_msg=f"{path}/{k}")


@pytest.mark.parametrize("name", ["faster", "mask"])
def test_weight_bridge_roundtrip(detectors, name):
    """port state_dict -> convert_mmdet_two_stage -> the bridge gives back
    the same tensors under the same keys, and the tree has the JAX
    detector's structure and shapes."""
    model, v = detectors[name]
    sd = model.state_dict()
    back = detector_state_dict_from_jax(v)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    jcls = j_two.MaskRCNN if name == "mask" else j_two.FasterRCNN
    shapes = jax.eval_shape(lambda: j_two.init_detector(
        jcls(**KW), jax.random.key(0), jnp.zeros((1, 128, 128, 3))))
    _assert_trees_equal(jax.tree.map(lambda a: a.shape, v),
                        jax.tree.map(lambda a: a.shape, shapes))


def test_weight_bridge_from_jax_tree():
    """A Flax tree of JAX-init shapes with seeded values -> the bridge ->
    the port model loads it strictly -> the converter gives the tree back
    (the fc re-index and the deconv rot180 undone exactly)."""
    jm = j_two.MaskRCNN(**KW)
    shapes = jax.eval_shape(lambda: j_two.init_detector(
        jm, jax.random.key(0), jnp.zeros((1, 64, 64, 3))))
    rng = np.random.default_rng(11)
    tree = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    sd = detector_state_dict_from_jax(tree)
    two_stage.MaskRCNN(**KW).load_state_dict(sd, strict=True)
    _assert_trees_equal(convert_mmdet_two_stage(sd), tree)
