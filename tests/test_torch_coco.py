"""The port's COCO data (masks, the dataset, ``coco_batches``) and the
detection trainer's COCO path and options (``--data coco``, the evaluator,
``--torch``, ``--eval-only``, ``--resume``, ``--pretrained-backbone``,
``--no-norm-eval``) against the JAX package, on the CPU.

The data are seeded COCO-format splits that ``testing.write_coco_split``
writes here: JPEGs of three sizes, polygon, RLE and compressed-RLE masks,
crowd and degenerate annotations, sparse category ids.  Masks and batches
must be bit for bit the JAX package's.  The trainers are compared on the
same weights (the port's state_dict saved as a .pth, which the JAX
trainer's ``--torch`` converts): the mAP of the whole val split, whose
length the batch does not divide, equal; training on the tree resumes
bit for bit an unbroken run.
"""

import json

import jax
import numpy as np
import pytest
import torch

from mrla_tpu.data import coco as j_coco
from mrla_tpu.detect import train_cli as j_cli
from mrla_tpu_torch.ckpt.io import save_checkpoint
from mrla_tpu_torch.data import coco
from mrla_tpu_torch.detect import train_cli
from mrla_tpu_torch.detect.backbone import load_backbone_from_classification
from mrla_tpu_torch.models.resnet_mrla_light import ResNetMRLALight
from mrla_tpu_torch.testing import (
    mask_runs,
    rle_string,
    training_detector,
    training_retinanet,
    write_coco_split,
)
from mrla_tpu_torch.train.state import TrainState
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

CATS = (7, 13, 90)  # sparse, as COCO's
SIZES = [(60, 80), (80, 60), (50, 72)]
CANVAS = (64, 96)
N_VAL = 3  # the batch of 2 leaves a ragged last batch
LAYERS = ["--backbone-layers", "1", "1", "1", "1"]
PRESETS = {"retinanet": "retinanet_r50mrlal_fpn_1x_coco",
           "faster": "faster_rcnn_r50mrlal_fpn_1x_coco",
           "mask": "mask_rcnn_r50mrlal_fpn_1x_coco"}


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    with jax.default_matmul_precision("float32"):
        yield


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    # objects large against the canvas, so that the spread detectors' boxes
    # find some of them (a mAP above 0 for the trainers to agree on)
    train = write_coco_split(str(root), "train", 4, SIZES, CATS, seed=0,
                             extent=(0.35, 0.9))
    val = write_coco_split(str(root), "val", N_VAL, SIZES, CATS, seed=1,
                           extent=(0.35, 0.9))
    return train, val


def _coco_argv(tree, name, out, *extra):
    (ta, ti), (va, vi) = tree
    return ["--preset", PRESETS[name], "--data", "coco", "--train-ann", ta,
            "--train-imgs", ti, "--val-ann", va, "--val-imgs", vi,
            "--img-size", *map(str, CANVAS), "--num-classes", "3",
            "--max-gt", "8", "--batch-size", "2", "--epochs", "1",
            "--rpn-proposals", "50", "--rcnn-samples", "32",
            "--roi-sampling-ratio", "2", "--warmup-iters", "2", *LAYERS,
            "--output-dir", str(out), *extra]


# ---------------------------------------------------------------- masks


def test_masks_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(6):
        h, w = rng.integers(5, 40, 2)
        m = rng.random((h, w)) < 0.4
        runs = mask_runs(m)
        for counts in (runs, rle_string(runs), rle_string(runs).encode()):
            rle = {"size": [int(h), int(w)], "counts": counts}
            got = coco.rle_to_mask(rle)
            np.testing.assert_array_equal(got, j_coco.rle_to_mask(rle))
            np.testing.assert_array_equal(got, m)
        polys = [list(rng.uniform(-3, max(h, w) + 3, 2 * int(k)))
                 for k in rng.integers(3, 7, 2)]
        for seg in (polys, polys[:1]):
            np.testing.assert_array_equal(
                coco.segmentation_to_mask(seg, h, w),
                j_coco.segmentation_to_mask(seg, h, w))
    assert coco.polygons_to_mask([[2, 3, 8, 3, 8, 7, 2, 7]], 10, 12).sum() \
        == 24


@pytest.mark.parametrize("split,train,masks,extras", [
    (0, True, False, False),  # shuffled, flipped
    (0, True, True, False),  # with masks
    (1, False, True, True),  # eval: extras, crowds, the ragged tail
])
def test_coco_batches_match_jax(tree, split, train, masks, extras):
    ann, imgs = tree[split]
    ds, jds = coco.CocoDetection(ann, imgs), j_coco.CocoDetection(ann, imgs)
    assert ds.cat2label == jds.cat2label == {7: 0, 13: 1, 90: 2}
    assert len(ds) == len(jds) and ds.items == jds.items
    kw = dict(canvas_hw=CANVAS, max_gt=8, shuffle=train, augment=train,
              seed=3, with_masks=masks, with_eval_extras=extras)
    got = list(coco.coco_batches(ds, 2, **kw))
    want = list(j_coco.coco_batches(jds, 2, **kw))
    assert len(got) == len(want) == -(-len(ds) // 2)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    svalid = np.concatenate([b["sample_valid"] for b in got])
    assert svalid.sum() == len(ds) and svalid[-1] == (len(ds) % 2 == 0)
    if extras:
        assert any(b["crowd_valid"].any() for b in got)


# -------------------------------------------------------------- trainer


def _init_pth(name, path):
    """A detector whose heads score the images (spread), saved as an
    mmdet-keyed .pth.  The mask head's logits are lifted well above 0, so
    that a pasted mask fills most of its box and the segm metrics read
    above 0 (random logits near 0 match no instance)."""
    if name == "retinanet":
        model = training_retinanet(0, (1, 1, 1, 1), 3, px=CANVAS)
    else:
        model = training_detector(0, name == "mask", (1, 1, 1, 1), 3,
                                  px=CANVAS, num_proposals=50,
                                  roi_sampling_ratio=2)
    if name == "mask":
        with torch.no_grad():
            logits = model.roi_head.mask_head.conv_logits
            logits.weight.mul_(0.1)
            logits.bias.fill_(3.0)
    torch.save({"state_dict": {f"module.{k}": v
                               for k, v in model.state_dict().items()}},
               path)
    return path


class _Jitted:
    """A Flax module whose ``apply`` runs jitted (one compile per method
    and keywords) and whose ``init`` gives empty collections (``--torch``
    replaces both): the JAX trainer calls them eagerly, which costs a
    minute a run at these sizes on the CPU."""

    def __init__(self, module):
        self._module, self._fns = module, {}

    def __getattr__(self, name):
        return getattr(self._module, name)

    def _jit(self, which, method, kw):
        key = (which, method, repr(sorted(kw.items())))
        if key not in self._fns:
            fn = getattr(self._module, which)
            self._fns[key] = jax.jit(
                lambda first, *a: fn(first, *a, method=method, **kw))
        return self._fns[key]

    def init(self, rngs, *args, method=None, **kw):
        return {"params": {}, "batch_stats": {}}

    def apply(self, variables, *args, method=None, **kw):
        return self._jit("apply", method, kw)(variables, *args)


def _jit_jax_trainer(monkeypatch):
    from mrla_tpu.detect import retinanet as j_retina
    from mrla_tpu.detect import two_stage as j_two

    build = j_cli.build_model
    monkeypatch.setattr(j_cli, "build_model", lambda args: (
        lambda m, kind: (_Jitted(m), kind))(*build(args)))
    monkeypatch.setattr(j_retina, "get_bboxes", jax.jit(
        j_retina.get_bboxes, static_argnames=("img_shape", "score_thr")))
    monkeypatch.setattr(j_two, "two_stage_predict", jax.jit(
        j_two.two_stage_predict, static_argnames=("model", "score_thr")))
    monkeypatch.setattr("mrla_tpu.utils.compile_cache.enable_compile_cache",
                        lambda *a, **k: None)


def _record_scoring(monkeypatch, module):
    """Every ``evaluate_detections`` call of ``module`` (a coco_eval) as
    (iou_kind, preds, gts), passed on to the real function."""
    calls, real = [], module.evaluate_detections

    def rec(preds, gts, **kw):
        calls.append((kw.get("iou_kind", "bbox"), preds, gts))
        return real(preds, gts, **kw)

    monkeypatch.setattr(module, "evaluate_detections", rec)
    return calls


@pytest.mark.parametrize("name", ["retinanet", "faster", "mask"])
def test_trainer_on_coco_matches_jax(tree, tmp_path, monkeypatch, name):
    """One .pth (a detector whose heads score the images) through the
    port's and the JAX trainer's ``--torch --eval-only``: the same mAP over
    exactly the 3 val images (the padded row of the last batch skipped),
    and the same detections and ground truths handed to the scorer, image
    by image: boxes over ``scale`` with the json areas and the crowd
    regions for the bbox protocol; for the mask preset, the segm protocol
    in canvas space over the non-crowd instances."""
    from mrla_tpu.detect import coco_eval as j_eval
    from mrla_tpu_torch.detect import coco_eval

    _jit_jax_trainer(monkeypatch)
    init = str(_init_pth(name, tmp_path / "init.pth"))
    argv = _coco_argv(tree, name, tmp_path / "eval", "--eval-only",
                      "--torch", init)
    got_calls = _record_scoring(monkeypatch, coco_eval)
    want_calls = _record_scoring(monkeypatch, j_eval)
    got = train_cli.main(argv + ["--device", "cpu"])
    want = j_cli.main(argv)
    assert got["val_count"] == N_VAL and got["mAP"] > 0
    keys = ["mAP", "AP50", "AP75", "AR@100"]
    if name == "mask":
        keys += ["mask_mAP", "mask_AP50", "mask_AP75"]
        assert got["mask_AP50"] > 0
    for k in keys:
        assert got[k] == pytest.approx(float(want[k]), abs=1e-6), k
    kinds = ["bbox", "segm"] if name == "mask" else ["bbox"]
    assert [c[0] for c in got_calls] == [c[0] for c in want_calls] == kinds
    for (kind, gp, gg), (_, wp, wg) in zip(got_calls, want_calls):
        assert len(gp) == len(wp) == len(gg) == len(wg) == N_VAL
        for g, w in zip(gg, wg):  # the loader's: bit for bit
            assert g.keys() == w.keys(), kind
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        for g, w in zip(gp, wp):
            assert g.keys() == w.keys(), kind
            np.testing.assert_array_equal(g["labels"], w["labels"])
            np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-3)
            np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-5)
            if "masks" in w:  # pasted: a pixel on a box's edge may flip
                assert (g["masks"] != w["masks"]).mean() < 1e-3


# ------------------------------------------------------- trainer options


def _synthetic(name, out, *extra):
    return ["--device", "cpu", "--preset", PRESETS[name], *LAYERS,
            "--img-size", "64", "--num-classes", "3", "--max-gt", "4",
            "--batch-size", "2", "--steps-per-epoch", "1", "--eval-every",
            "0", "--rpn-proposals", "50", "--rcnn-samples", "16",
            "--warmup-iters", "2", "--lr", "0.01", "--output-dir", str(out),
            *extra]


@pytest.mark.parametrize("name", ["retinanet", "faster"])
def test_coco_training_resumes_bitwise(tree, tmp_path, name):
    """Two epochs on the COCO tree straight equal one epoch, then
    ``--resume`` for one, bit for bit (weights, BN statistics, the
    optimizer's momentum).  RetinaNet's straight run evaluates at its end
    (every val image counted once), and ``--eval-only --resume`` gives
    that mAP again."""
    def argv(out, *extra):  # batch 4: one step an epoch, a ragged val
        return _coco_argv(tree, name, tmp_path / out, "--device", "cpu",
                          "--lr", "0.01", "--rcnn-samples", "16",
                          "--batch-size", "4", "--eval-every", "0", *extra)

    evals = ("--eval-every", "2") if name == "retinanet" else ()
    straight = train_cli.main(argv("a", "--epochs", "2", *evals))
    train_cli.main(argv("b", "--epochs", "1"))
    resumed = train_cli.main(argv("b", "--epochs", "2", "--resume",
                                  str(tmp_path / "b")))
    assert len(resumed["loss"]) == 1  # epoch 1 only
    assert resumed["loss"] == straight["loss"][1:]
    a, b = straight["model"].state_dict(), resumed["model"].state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    ca = torch.load(tmp_path / "a" / "checkpoint.pt", weights_only=True)
    cb = torch.load(tmp_path / "b" / "checkpoint.pt", weights_only=True)
    assert ca["epoch"] == cb["epoch"] == 1 and ca["step"] == cb["step"] == 2
    for sa, sb in zip(ca["optimizer"]["state"].values(),
                      cb["optimizer"]["state"].values()):
        assert torch.equal(sa["momentum_buffer"], sb["momentum_buffer"])
    if evals:
        line = json.loads(open(tmp_path / "a" / "log.jsonl").readlines()[-1])
        ev = train_cli.main(argv("c", "--eval-only", "--resume",
                                 str(tmp_path / "a")))
        assert ev["mAP"] == line["mAP"]
        assert ev["val_count"] == line["val_count"] == N_VAL


def test_mask_preset_scores_segm_on_coco(tree, tmp_path, monkeypatch):
    """The mask preset's evaluation on COCO data, fed detections that are
    the ground truths themselves (canvas boxes, soft masks of ones): every
    box found in the original image's coordinates with the crowd regions
    ignored (bbox mAP 1); each mask its box, pasted in canvas space and
    scored against the non-crowd instances' masks only (segm AP50 1: a box
    overlaps its instance by about 1, an ellipse by about pi / 4, so that
    more than half of the ten IoU thresholds pass: a mask misplaced by the
    letterbox scale reads 0.27); every val image counted once."""
    args = train_cli.parse_args(_coco_argv(tree, "mask", tmp_path,
                                           "--device", "cpu"))
    batches = iter(list(train_cli.data_iter(args, train=False, epoch=0)))

    def oracle(args, model, x):
        batch = next(batches)
        np.testing.assert_array_equal(x.numpy(), batch["image"])
        v = batch["gt_valid"]
        return {"det_boxes": batch["gt_boxes"], "det_scores":
                v.astype(np.float32), "det_labels": batch["gt_labels"],
                "det_valid": v, "masks": np.ones(v.shape + (28, 28),
                                                 np.float32)}

    monkeypatch.setattr(train_cli, "predict", oracle)
    out = train_cli.evaluate(args, torch.nn.Module(), 0, torch.device("cpu"))
    assert out["val_count"] == N_VAL
    assert out["mAP"] == out["AR@100"] == 1.0
    assert out["mask_AP50"] == 1.0 and 0.5 < out["mask_mAP"] < 1.0


def test_pretrained_backbone_from_a_classification_run(tmp_path):
    """The backbone equal to a port classification checkpoint's trunk, the
    neck and head at their init; a trunk of another depth or width
    refused."""
    cls = ResNetMRLALight([1, 1, 1, 1], num_classes=10,
                          generator=torch.Generator().manual_seed(5))
    opt = torch.optim.SGD(cls.parameters(), lr=0.1)
    save_checkpoint(str(tmp_path / "cls"), TrainState(cls, opt, lambda s: 0.1),
                    0)
    argv = _synthetic("retinanet", tmp_path / "det")
    args = train_cli.parse_args(argv + ["--pretrained-backbone",
                                        str(tmp_path / "cls")])
    model = train_cli.build_model(args, torch.device("cpu"))
    train_cli.load_weights(args, model)
    init = train_cli.build_model(train_cli.parse_args(argv),
                                 torch.device("cpu")).state_dict()
    src = cls.state_dict()
    for k, v in model.state_dict().items():
        if k.startswith("backbone."):
            assert torch.equal(v, src[k[len("backbone."):]]), k
        else:
            assert torch.equal(v, init[k]), k
    assert not torch.equal(model.state_dict()["backbone.conv1.weight"],
                           init["backbone.conv1.weight"])
    deeper = train_cli.build_model(train_cli.parse_args(
        argv + ["--backbone-layers", "1", "1", "2", "1"]),
        torch.device("cpu"))
    with pytest.raises(KeyError, match="layer3.1"):
        load_backbone_from_classification(deeper, src)
    wide = dict(src, **{"conv1.weight": torch.zeros(32, 3, 7, 7)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_backbone_from_classification(model, wide)


def test_norm_eval_freezes_and_no_norm_eval_moves_statistics(tmp_path):
    stats = {}
    for flag in ((), ("--no-norm-eval",)):
        args = train_cli.parse_args(_synthetic("retinanet", tmp_path, *flag))
        before = {k: v.clone() for k, v in train_cli.build_model(
            args, torch.device("cpu")).state_dict().items()
            if "running_" in k}
        out = train_cli.main(_synthetic("retinanet", tmp_path / str(len(flag)),
                                        "--epochs", "1", *flag))
        after = out["model"].state_dict()
        stats[flag] = [torch.equal(v, after[k]) for k, v in before.items()]
    assert all(stats[()])  # the presets' frozen BN
    assert not any(stats[("--no-norm-eval",)])
