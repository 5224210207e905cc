"""The port's detection training (targets, samplers, losses, one SGD step,
the schedule, the trainer and its evaluator) against the JAX package, in
fp32 on the CPU.

The samplers' uniforms are the ones the JAX functions draw from their keys,
split as they split them, handed to the port as tensors; so both packages
sample the same rows.  The detectors are the port's (layers (1, 1, 1, 1),
full widths, 3 classes, heads spread by ``testing.training_detector``),
carried to Flax by ``convert_mmdet_two_stage``; the JAX gradient tree comes
back through ``detector_state_dict_from_jax`` (a linear relayout), so the
two are compared parameter by parameter.

Tolerances: targets, sampled rows and counts exactly; box arithmetic fed
the same inputs 1e-5 of the largest |value| (fp32 ulps of exp / log); loss
terms of the whole step, every gradient and every update 1e-4 of the
largest |value| of each tensor: fp32 sums in another order (the step's
gradients agree to some 4e-6 of their largest value); an update, read as
the difference of two fp32 parameters, also within two of their ulps.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mrla_tpu.ckpt.detect_convert import convert_mmdet_two_stage
from mrla_tpu.data.synthetic import synthetic_detection_batches as j_batches
from mrla_tpu.detect import coco_eval as j_coco
from mrla_tpu.detect import targets as j_targets
from mrla_tpu.detect import train_cli as j_cli
from mrla_tpu.detect import two_stage as j_two
from mrla_tpu.detect import two_stage_train as j_train
from mrla_tpu_torch.ckpt import detector_state_dict_from_jax
from mrla_tpu_torch.data.synthetic import synthetic_detection_batches
from mrla_tpu_torch.detect import coco_eval, train_cli
from mrla_tpu_torch.detect import two_stage_train as train
from mrla_tpu_torch.detect.configs import PRESETS
from mrla_tpu_torch.detect.targets import max_iou_assign
from mrla_tpu_torch.testing import training_detector
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

KW = dict(layers=(1, 1, 1, 1), num_classes=3, rpn_nms_pre=100,
          num_proposals=30, roi_sampling_ratio=0)
RCNN_NUM, RPN_NUM = 16, 32  # the JAX package's own training-step test


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


def _boxes(rng, shape, canvas=128.0, smin=4.0, smax=60.0):
    xy = rng.uniform(0, canvas, shape + (2,))
    wh = rng.uniform(smin, smax, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _uniforms(key, b, n, draws):
    """The uniforms the JAX sampler of one stage draws from ``key``: per
    image ``jax.random.split(key, b)``, then ``split`` into (pos, neg)
    and, for the R-CNN stage, the ordering draw."""
    out = []
    for k in jax.random.split(key, b):
        if draws == 2:  # rpn_loss: random_sample(k)
            kp, kn = jax.random.split(k)
            ks = [kp, kn]
        else:  # rcnn_targets: ks, kg = split(k); random_sample(ks)
            ks, kg = jax.random.split(k)
            kp, kn = jax.random.split(ks)
            ks = [kp, kn, kg]
        out.append([np.asarray(jax.random.uniform(q, (n,))) for q in ks])
    return _t(np.asarray(out, np.float32))


# ----------------------------------------------------------- assignment


@pytest.mark.parametrize("low_quality", [True, False])
def test_max_iou_assign_matches(low_quality):
    rng = np.random.default_rng(1)
    anchors = _boxes(rng, (300,))
    gt = _boxes(rng, (2, 6))
    gt[:, 3] = gt[:, 1]  # a gt repeated: ties, the later one wins
    gt[:, 2] = anchors[7]  # a gt equal to an anchor: IoU exactly 1
    valid = np.array([[True] * 5 + [False], [True, True, False] * 2])
    got = max_iou_assign(_t(anchors), _t(gt), _t(valid), 0.5, 0.4, 0.1,
                         match_low_quality=low_quality)
    want = jax.jit(jax.vmap(lambda g, v: j_targets.max_iou_assign(
        jnp.asarray(anchors), g, v, 0.5, 0.4, 0.1,
        match_low_quality=low_quality)))(jnp.asarray(gt), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == 2).any() or (got == 4).any()


def test_random_sample_matches_and_keeps_budgets():
    rng = np.random.default_rng(2)
    pos = rng.random((3, 400)) < np.array([[0.5], [0.02], [0.0]])
    neg = ~pos & (rng.random((3, 400)) < 0.8)
    key = jax.random.key(5)
    u = _uniforms(key, 3, 400, 2)
    got_p, got_n = train.random_sample(_t(pos), _t(neg), 256, 0.5, u[:, 0],
                                       u[:, 1])
    sample = jax.jit(lambda k, p, n: j_train.random_sample(k, p, n, 256, 0.5))
    for i, k in enumerate(jax.random.split(key, 3)):
        wp, wn = sample(k, jnp.asarray(pos[i]), jnp.asarray(neg[i]))
        np.testing.assert_array_equal(got_p[i].numpy(), np.asarray(wp))
        np.testing.assert_array_equal(got_n[i].numpy(), np.asarray(wn))
    counts = (got_p.sum(1) + got_n.sum(1)).tolist()
    assert got_p.sum(1).tolist()[0] == 128 and counts[0] == 256
    assert counts[1] == 256 and counts[2] == 256
    assert not (got_p & ~_t(pos)).any() and not (got_n & ~_t(neg)).any()


# ------------------------------------------------------ targets and losses


def _level_outputs(rng, b=2, sizes=((16, 16), (8, 8), (4, 4), (2, 2),
                                    (1, 1))):
    return [(rng.standard_normal((b, h, w, 3)).astype(np.float32),
             0.3 * rng.standard_normal((b, h, w, 12)).astype(np.float32))
            for h, w in sizes]


def _gts(rng, b=2, g=4, canvas=64.0):
    gt = _boxes(rng, (b, g), canvas, 8.0, 40.0)
    valid = np.ones((b, g), bool)
    valid[0, 3] = False
    gt[0, 3] = 0.0  # a padded zero row
    labels = rng.integers(0, 3, (b, g)).astype(np.int32)
    return gt, labels, valid


def test_rpn_loss_matches():
    rng = np.random.default_rng(3)
    outs = _level_outputs(rng)
    gt, _, valid = _gts(rng)
    key = jax.random.key(7)
    n = sum(c.shape[1] * c.shape[2] * 3 for c, _ in outs)
    got = train.rpn_loss([(_t(c), _t(r)) for c, r in outs], _t(gt),
                         _t(valid), _uniforms(key, 2, n, 2), num_samples=64)
    want = jax.jit(lambda o, g, v, k: j_train.rpn_loss(
        o, g, v, k, num_samples=64))(
        [(jnp.asarray(c), jnp.asarray(r)) for c, r in outs],
        jnp.asarray(gt), jnp.asarray(valid), key)
    assert int(got["num_pos"]) == int(want["num_pos"]) > 0
    for k in ("loss_rpn_cls", "loss_rpn_bbox"):
        _close(float(got[k]), float(want[k]), 1e-5)


@pytest.mark.parametrize("low_quality", [False, True])
def test_rcnn_targets_match(low_quality):
    rng = np.random.default_rng(4)
    gt, labels, valid = _gts(rng)
    props = np.concatenate([_boxes(rng, (2, 50), 64.0, 4.0, 40.0),
                            np.repeat(gt, 5, 1) + rng.normal(
                                0, 2, (2, 20, 4)).astype(np.float32)], 1)
    pvalid = rng.random((2, 70)) > 0.1
    key = jax.random.key(9)
    u = _uniforms(key, 2, 74, 3)
    got = train.rcnn_targets(_t(props), _t(pvalid), _t(gt), _t(labels),
                             _t(valid), 3, u, num=24,
                             match_low_quality=low_quality)
    want = jax.jit(lambda *a: j_train.rcnn_targets(
        *a, 3, num=24, match_low_quality=low_quality))(
        key, jnp.asarray(props), jnp.asarray(pvalid), jnp.asarray(gt),
        jnp.asarray(labels), jnp.asarray(valid))
    assert set(got) == set(want)
    for k in ("roi_valid", "labels", "gt_index", "label_weights",
              "bbox_weights"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("rois", "bbox_targets"):
        _close(got[k], want[k])
    # positives lead the prefix; gt boxes are among the candidates
    pos = got["bbox_weights"].numpy() > 0
    assert pos.any() and (np.diff(pos.astype(int), axis=1) <= 0).all()


def test_rcnn_and_mask_losses_match():
    rng = np.random.default_rng(5)
    b, r, k = 2, 12, 3
    targets = {
        "labels": rng.integers(0, k + 1, (b, r)).astype(np.int32),
        "label_weights": (rng.random((b, r)) > 0.2).astype(np.float32),
        "bbox_targets": rng.standard_normal((b, r, 4)).astype(np.float32),
        "bbox_weights": (rng.random((b, r)) > 0.5).astype(np.float32),
        "rois": _boxes(rng, (b, r), 64.0, 8.0, 40.0),
        "gt_index": rng.integers(0, 3, (b, r)).astype(np.int32),
    }
    cls = rng.standard_normal((b, r, k + 1)).astype(np.float32)
    reg = rng.standard_normal((b, r, 4 * k)).astype(np.float32)
    tt = {n: _t(v).long() if v.dtype == np.int32 else _t(v)
          for n, v in targets.items()}
    jt = {n: jnp.asarray(v) for n, v in targets.items()}
    got = train.rcnn_loss(_t(cls), _t(reg), tt)
    want = jax.jit(j_train.rcnn_loss)(jnp.asarray(cls), jnp.asarray(reg), jt)
    for n in ("loss_cls", "loss_bbox"):
        _close(float(got[n]), float(want[n]))
    masks = np.zeros((b, 3, 96, 96), np.float32)
    for i in range(b):
        for g in range(3):
            x0, y0 = rng.integers(0, 60, 2)
            masks[i, g, y0:y0 + 30, x0:x0 + 25] = 1.0
    logits = 3 * rng.standard_normal((b, r, 28, 28, k)).astype(np.float32)
    got = train.mask_loss(_t(logits), tt, _t(masks))
    want = jax.jit(j_train.mask_loss)(jnp.asarray(logits), jt,
                                      jnp.asarray(masks))
    _close(float(got), float(want))


# ------------------------------------------------------ one training step


def _step_inputs(name):
    model = training_detector(3, name == "mask", px=(128, 128), **KW)
    batch = next(synthetic_detection_batches(
        2, image_size=128, num_classes=3, steps=1, max_gt=4, seed=11,
        with_masks=name == "mask"))
    return model, batch


def _jax_step(name, model, batch, key):
    jcls = j_two.MaskRCNN if name == "mask" else j_two.FasterRCNN
    jm = jcls(**KW)
    # copies: the converted leaves may share the port's parameter memory,
    # which the port's optimizer then updates in place
    v = jax.tree.map(lambda a: jnp.array(np.array(a)),
                     convert_mmdet_two_stage(model.state_dict()))
    x = jnp.asarray(batch["image"])

    def loss_fn(params):
        total, losses, _ = j_train.faster_rcnn_train_loss(
            jm, {"params": params, "batch_stats": v["batch_stats"]}, x,
            jnp.asarray(batch["gt_boxes"]), jnp.asarray(batch["gt_labels"]),
            jnp.asarray(batch["gt_valid"]), key, train=False,
            gt_masks=(jnp.asarray(batch["gt_masks"]) if name == "mask"
                      else None),
            rcnn_num=RCNN_NUM, rpn_num=RPN_NUM)
        return total, losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    return v, losses, grads


def _argv(name):
    return ["--preset", f"{name}_rcnn_r50mrlal_fpn_1x_coco",
            "--batch-size", "2", "--lr", "0.01", "--warmup-iters", "3",
            "--steps-per-epoch", "1"]


@pytest.mark.parametrize("name", ["faster", "mask"])
def test_training_step_matches_jax(name):
    """Loss terms, every parameter's gradient, and the parameters after two
    SGD steps on that gradient (decay, momentum, the warmup schedule and
    frozen stages) against jax.value_and_grad of faster_rcnn_train_loss and
    optax's update."""
    model, batch = _step_inputs(name)
    key = jax.random.key(1)
    v, want, jgrads = _jax_step(name, model, batch, key)

    x = _t(batch["image"])
    _, rpn_outs = model.rpn_forward(x)
    n_anchors = sum(c.shape[1] * c.shape[2] * c.shape[3] for c, _ in rpn_outs)
    k_rpn, k_rcnn = jax.random.split(key)
    rand = {"rpn": _uniforms(k_rpn, 2, n_anchors, 2),
            "rcnn": _uniforms(k_rcnn, 2, 4 + KW["num_proposals"], 3)}
    for p in model.parameters():
        p.requires_grad_(True)
    total, got, targets = train.faster_rcnn_train_loss(
        model, x, _t(batch["gt_boxes"]), _t(batch["gt_labels"]),
        _t(batch["gt_valid"]), rand,
        gt_masks=_t(batch["gt_masks"]) if name == "mask" else None,
        rcnn_num=RCNN_NUM, rpn_num=RPN_NUM)
    total.backward()

    terms = ["loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox",
             "loss"] + (["loss_mask"] if name == "mask" else [])
    assert set(terms) <= set(got)
    assert int(got["num_pos"]) == int(want["num_pos"]) > 0
    assert targets["bbox_weights"].sum() > 0
    for k in terms:
        w = float(want[k])
        assert np.isfinite(w) and abs(got[k].item() - w) <= 1e-4 * abs(w), k

    jg = detector_state_dict_from_jax(
        {"params": jgrads, "batch_stats": v["batch_stats"]})
    params = dict(model.named_parameters())
    for k, p in params.items():
        want_g = jg[k].numpy()
        tol = 1e-4 * np.abs(want_g).max()
        assert np.abs(p.grad.numpy() - want_g).max() <= tol, k
    assert any(p.grad.abs().max() > 0 for k, p in params.items()
               if k.startswith("backbone.layer1.")), "layer1 gets a gradient"

    # two SGD steps on that gradient: the port's optimizer and optax's
    args = train_cli.parse_args(_argv(name) + ["--device", "cpu"])
    jargs = j_cli.parse_args(_argv(name))
    preset = PRESETS[args.preset]
    schedule, _ = train_cli.make_schedule(args, preset, 1)
    before = {k: p.detach().clone() for k, p in params.items()}
    opt = train_cli.make_optimizer(args, model, schedule)
    for step in range(2):
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        opt.step()
    jsched, _ = j_cli.make_schedule(jargs, preset, 1)
    tx = j_cli.make_optimizer(jargs, jsched, v["params"])

    @jax.jit  # one program: optax's eager updates compile each leaf's ops
    def sgd(p, state):
        updates, state = tx.update(jgrads, state, p)
        return optax.apply_updates(p, updates), state

    jp, state = v["params"], tx.init(v["params"])
    for _ in range(2):
        jp, state = sgd(jp, state)
    jnew = detector_state_dict_from_jax(
        {"params": jp, "batch_stats": v["batch_stats"]})
    frozen = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1.")
    for k, p in params.items():
        if k.startswith(frozen):
            assert not p.requires_grad, k
            assert torch.equal(p.detach(), before[k]), k
            assert torch.equal(jnew[k], before[k]), k
            continue
        got_u = (p.detach() - before[k]).numpy()
        want_u = (jnew[k] - before[k]).numpy()
        # read as a difference of fp32 parameters: plus their rounding
        tol = (1e-4 * np.abs(want_u).max()
               + 2 * np.spacing(before[k].abs().max().item(), dtype=np.float32))
        assert np.abs(got_u - want_u).max() <= tol, k


def test_schedule_matches_jax():
    argv = ["--preset", "faster_rcnn_r50mrlal_fpn_1x_coco", "--batch-size",
            "8", "--warmup-iters", "40", "--steps-per-epoch", "10"]
    args = train_cli.parse_args(argv)
    jargs = j_cli.parse_args(argv)
    preset = PRESETS[args.preset]
    sched, epochs = train_cli.make_schedule(args, preset, 10)
    jsched, jepochs = j_cli.make_schedule(jargs, preset, 10)
    assert epochs == jepochs == 12
    for step in (0, 1, 20, 39, 40, 79, 80, 81, 109, 110, 119):
        want = float(jsched(step))
        assert abs(sched(step) - want) <= 1e-6 * want, step
    assert sched(40) == 0.01 and abs(sched(80) - 0.001) < 1e-12


# ------------------------------------------------------- data and trainer


def test_synthetic_batches_match_jax():
    for with_masks in (False, True):
        got = next(synthetic_detection_batches(2, 64, 5, 1, 4, 3, with_masks))
        want = next(j_batches(2, 64, 5, 1, 4, 3, with_masks))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_coco_eval_matches_jax():
    rng = np.random.default_rng(6)
    preds, gts = [], []
    for _ in range(4):
        gb = _boxes(rng, (5,), 100.0, 6.0, 50.0)
        gl = rng.integers(0, 3, 5)
        pb = np.concatenate([gb + rng.normal(0, 3, gb.shape),
                             _boxes(rng, (4,), 100.0, 6.0, 50.0)])
        masks = np.zeros((5, 100, 160), bool)
        pm = np.zeros((9, 100, 160), bool)
        for i, bx in enumerate(gb.astype(int)):
            masks[i, bx[1]:bx[3], bx[0]:bx[2]] = True
        for i, bx in enumerate(np.clip(pb, 0, 99).astype(int)):
            pm[i, bx[1]:bx[3], bx[0]:bx[2]] = True
        gts.append({"boxes": gb, "labels": gl, "masks": masks})
        preds.append({"boxes": pb.astype(np.float32),
                      "scores": rng.random(9).astype(np.float32),
                      "labels": np.concatenate([gl, rng.integers(0, 3, 4)]),
                      "masks": pm})
    for kind in ("bbox", "segm"):
        got = coco_eval.evaluate_detections(preds, gts, 3, iou_kind=kind)
        want = j_coco.evaluate_detections(preds, gts, 3, iou_kind=kind)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["AP50"] > 0
    soft = rng.random((3, 28, 28)).astype(np.float32)
    boxes = _boxes(rng, (3,), 60.0, 5.0, 30.0)
    np.testing.assert_array_equal(
        coco_eval.paste_masks(soft, boxes, (64, 80)),
        j_coco.paste_masks(soft, boxes, (64, 80)))


def test_trainer_runs_on_cpu_and_writes_its_log(tmp_path):
    # batch 1: two steps and a one-image evaluation
    out = train_cli.main([
        "--device", "cpu", "--preset", "mask_rcnn_r50mrlal_fpn_1x_coco",
        "--backbone-layers", "1", "1", "1", "1", "--img-size", "128",
        "--num-classes", "3", "--max-gt", "4", "--batch-size", "1",
        "--epochs", "1", "--steps-per-epoch", "2", "--eval-steps", "1",
        "--rpn-proposals", "100", "--rcnn-samples", "64",
        "--output-dir", str(tmp_path)])
    lines = [json.loads(s) for s in open(tmp_path / "log.jsonl")]
    assert len(lines) == 1 and lines[0]["step"] == 2
    for k in ("loss", "loss_rpn_cls", "loss_rpn_bbox", "loss_cls",
              "loss_bbox", "loss_mask"):
        assert np.isfinite(lines[0][k]), k
    assert 0.0 <= lines[0]["mAP"] <= 1.0 and "mask_mAP" in lines[0]
    assert len(out["step_s"]) == 2


def test_trainer_needs_a_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--output-dir", str(tmp_path)])
    small = ["--device", "cpu", "--backbone-layers", "1", "1", "1", "1",
             "--output-dir", str(tmp_path)]
    with pytest.raises(SystemExit, match="requires --train-ann"):
        train_cli.main(small + ["--data", "coco"])
    with pytest.raises(FileNotFoundError):
        train_cli.main(small + ["--torch", str(tmp_path / "absent.pth")])


# option -> why the two detection trainers' defaults differ on purpose
DELIBERATE = {
    # the COCO canvas (ROADMAP.md, deliberate differences): the JAX
    # trainer's --img-size is 256 whatever the data, though its help says
    # "coco default 800 1344"; the port's is 800 x 1344 on COCO and the
    # same 256 on synthetic data (checked below)
    "img_size": "the COCO canvas",
    # None in the JAX trainer resolves to 0 on its RoIAlign kernel (the
    # presets' exact adaptive grid, free there) and to 2 on its XLA
    # gather; the port always runs its kernel, so 0
    "roi_sampling_ratio": "the grid the JAX kernel path takes",
}


@pytest.mark.parametrize("trainer", ["detect", "classify"])
def test_the_two_parsers_share_their_defaults(trainer):
    """Every option the two trainers share has the same default, but the
    deliberate differences listed with their reasons; the detection
    trainers both default to RetinaNet."""
    from mrla_tpu.train import cli as j_cls_cli
    from mrla_tpu_torch.train import cli as cls_cli

    if trainer == "detect":
        want, got = vars(j_cli.parse_args([])), vars(train_cli.parse_args([]))
        assert got["preset"] == want["preset"] == \
            "retinanet_r50mrlal_fpn_1x_coco"
        assert train_cli.canvas_hw(train_cli.parse_args([])) == (256, 256)
        assert want["img_size"] == [256]
        skip = DELIBERATE
    else:
        want = vars(j_cls_cli.build_parser().parse_args([]))
        got = vars(cls_cli.build_parser().parse_args([]))
        skip = {}
    shared = set(want) & set(got)
    assert len(shared) > 20
    differ = {k: (want[k], got[k]) for k in shared if want[k] != got[k]}
    assert set(differ) == set(skip), differ
