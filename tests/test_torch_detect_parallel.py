"""Data-parallel detection training in the port on the CPU: the faster
preset's step at two gloo ranks against the JAX package's step on its
8-device mesh, RetinaNet's at two ranks against the port's one-rank step
on the global batch, per-rank normalisers (the injected fault), the
trainer's ``--dp``, ``rank_shard_indices`` against the JAX function, and
every trainable parameter reached by each preset's loss (DDP runs with
``find_unused_parameters`` off).

One launch of two gloo ranks computes every rank-side check of this file
(``parallel.checks.detection_test_job``), the ranks fresh interpreters
that import torch and the port only; the JAX mesh step runs here meanwhile.

The faster preset is ``tests/test_detect_multidevice.py``'s: layers
(1, 1, 1, 1), 4 classes, 64 px, batch 8, ``rpn_nms_pre`` 64, 32 proposals,
16 R-CNN samples, BN frozen, a 2 x 2 RoIAlign grid.  Its weights are the
port's seeded detector with the RPN and box head spread
(``testing.training_detector``: at an init the proposals' scores tie, and
which of them survive NMS hangs on rounding), carried to Flax by
``convert_mmdet_two_stage`` as ``tests/test_torch_detect_train.py`` does
(the JAX init would compile for 10 s here), so one set of weights feeds
both.  Each rank's samplers take its rows of the
uniforms the JAX step draws over the global batch.  Limits are the JAX
test's own: the loss ``rtol 1e-4``, every gradient ``rtol 5e-3, atol
2e-4``.  RetinaNet (batch 16, BN on batch statistics, as the JAX DP test
runs it) is held at the same limits, with ``num_pos`` exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mrla_tpu.ckpt.detect_convert import convert_mmdet_two_stage
from mrla_tpu.detect import train_cli as j_cli
from mrla_tpu.detect import two_stage as j_two
from mrla_tpu.detect import two_stage_train as j_train
from mrla_tpu.parallel import make_mesh
from mrla_tpu_torch.ckpt import detector_state_dict_from_jax
from mrla_tpu_torch.detect import train_cli
from mrla_tpu_torch.detect.retinanet import RetinaNet
from mrla_tpu_torch.parallel import checks
from mrla_tpu_torch.parallel.spawn import start_ranks
from mrla_tpu_torch.testing import training_detector
from tests.test_torch_detect_train import _uniforms
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

LOSS_RTOL = 1e-4
GRAD_TOL = dict(rtol=5e-3, atol=2e-4)
WORLD, PX, CLASSES = 2, 64, 4
FASTER_KW = dict(layers=(1, 1, 1, 1), num_classes=CLASSES, rpn_nms_pre=64,
                 num_proposals=32, roi_sampling_ratio=2)
RCNN_NUM = 16
PRESETS = ("retinanet_r50mrlal_fpn_1x_coco",
           "faster_rcnn_r50mrlal_fpn_1x_coco",
           "mask_rcnn_r50mrlal_fpn_1x_coco")


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    with jax.default_matmul_precision("float32"):
        yield


def _gt(rng, b):
    xy = rng.uniform(4, 24, (b, 2, 2))
    wh = rng.uniform(12, 32, (b, 2, 2))
    return {"image": rng.standard_normal((b, PX, PX, 3)).astype(np.float32),
            "gt_boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
            "gt_labels": rng.integers(0, CLASSES, (b, 2)).astype(np.int64),
            "gt_valid": rng.random((b, 2)) < 0.9}


def _faster_spec():
    """(spec of the rank step, JAX module and variables, batch, key): the
    port's seeded detector carried to Flax through the bridge."""
    port = training_detector(1, layers=(1, 1, 1, 1), num_classes=CLASSES,
                             px=(PX, PX), **{k: v for k, v in
                                             FASTER_KW.items()
                                             if k not in ("layers",
                                                          "num_classes")})
    jm = j_two.FasterRCNN(**FASTER_KW)
    sd = {k: v.detach().clone() for k, v in port.state_dict().items()}
    variables = jax.tree.map(lambda a: jnp.asarray(np.array(a)),
                             convert_mmdet_two_stage(sd))
    batch = _gt(np.random.default_rng(5), 8)
    key = jax.random.key(3)
    k_rpn, k_rcnn = jax.random.split(key)
    n_anchors = 3 * sum((PX // s) ** 2 for s in (4, 8, 16, 32, 64))
    uniforms = {"rpn": _uniforms(k_rpn, 8, n_anchors, 2).numpy(),
                "rcnn": _uniforms(k_rcnn, 8, 2 + 32, 3).numpy()}
    spec = {"kind": "faster", "model": FASTER_KW, "state_dict": sd,
            "batch": batch, "uniforms": uniforms, "rcnn_num": RCNN_NUM,
            "lr": 0.01}
    return spec, jm, variables, batch, key


def _jax_mesh_step(jm, variables, batch, key):
    """The faster loss's value and gradient on the 8-device mesh, the
    gradient in the port's keys."""
    def step(params, images, gb, gl, gv):
        def loss_fn(p):
            total, _, _ = j_train.faster_rcnn_train_loss(
                jm, {"params": p, "batch_stats": variables["batch_stats"]},
                images, gb, gl, gv, key, train=False, rcnn_num=RCNN_NUM)
            return total
        return jax.value_and_grad(loss_fn)(params)

    mesh = make_mesh(axes=("data",), shape=(8,))
    shard = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(
        mesh, P("data", *([None] * (np.ndim(a) - 1)))))
    with mesh:
        loss, grads = jax.jit(step)(
            jax.device_put(variables["params"], NamedSharding(mesh, P())),
            *(shard(batch[k]) for k in ("image", "gt_boxes")),
            shard(batch["gt_labels"].astype(np.int32)),
            shard(batch["gt_valid"]))
    return float(loss), detector_state_dict_from_jax(jax.device_get(
        {"params": grads, "batch_stats": variables["batch_stats"]}))


def _retina_spec():
    model = RetinaNet(layers=(1, 1, 1, 1), num_classes=CLASSES,
                      generator=torch.Generator().manual_seed(0))
    return {"kind": "retinanet",
            "model": {"layers": (1, 1, 1, 1), "num_classes": CLASSES},
            "state_dict": model.state_dict(), "norm_eval": False,
            "batch": _gt(np.random.default_rng(0), 16), "lr": 0.01}


def _cli_argv(out, *extra):
    return ["--preset", PRESETS[1], "--device", "cpu", "--backbone-layers",
            "1", "1", "1", "1", "--img-size", str(PX), "--num-classes", "3",
            "--max-gt", "4", "--batch-size", "4", "--epochs", "1",
            "--steps-per-epoch", "2", "--eval-steps", "1", "--rpn-proposals",
            "32", "--rcnn-samples", "16", "--output-dir", str(out), *extra]


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    work = tmp_path_factory.mktemp("detect_dp")
    faster, jm, variables, batch, key = _faster_spec()
    spec = {"faster": faster, "retinanet": _retina_spec(),
            "cli": _cli_argv(work / "det2", "--dp", "2"),
            "cli_mismatch": _cli_argv(work / "bad", "--dp", "3")}
    torch.save(spec, work / "spec.pt")
    ranks = start_ranks(checks.detection_test_job, WORLD, str(work),
                        args=(str(work),), threads=2)
    try:
        jax_step = _jax_mesh_step(jm, variables, batch, key)
    finally:
        results = ranks.join()
    return {"work": work, "spec": spec, "ranks": results, "jax": jax_step}


def _grads_within(got, want):
    return all(torch.allclose(v, want[k], **GRAD_TOL) for k, v in got.items())


def test_faster_two_rank_step_matches_the_jax_mesh_step(dp):
    """Loss and every gradient of the 2-rank step (each rank's rows of the
    JAX draws) against the JAX mesh step; per-rank normalisers fail."""
    j_loss, j_grads = dp["jax"]
    sound = dp["ranks"][0]["faster"]["global"]
    np.testing.assert_allclose(sound["terms"]["loss"], j_loss,
                               rtol=LOSS_RTOL)
    assert sound["grads"].keys() <= j_grads.keys()
    for k, got in sound["grads"].items():
        torch.testing.assert_close(got, j_grads[k], **GRAD_TOL,
                                   msg=lambda m: f"{k}\n{m}")
    fault = dp["ranks"][0]["faster"]["replica_norm"]
    assert not (abs(fault["terms"]["loss"] - j_loss) <= LOSS_RTOL * j_loss
                and _grads_within(fault["grads"], j_grads)), \
        "per-rank normalisers pass the check"
    assert dp["ranks"][1]["faster"]["global"]["same"]


def test_retinanet_two_rank_step_is_one_rank_on_the_global_batch(dp):
    """RetinaNet with BN on batch statistics: the 2-rank step's loss terms,
    num_pos (exact) and gradients against the port's 1-rank step on the
    global batch; a per-rank avg_factor fails."""
    want = checks.detection_step(dp["spec"]["retinanet"], device="cpu")
    sound = dp["ranks"][0]["retinanet"]["global"]
    assert sound["terms"]["num_pos"] == want["terms"]["num_pos"] > 0
    for k in ("loss", "loss_cls", "loss_bbox"):
        np.testing.assert_allclose(sound["terms"][k], want["terms"][k],
                                   rtol=LOSS_RTOL, err_msg=k)
    for k, w in want["grads"].items():
        torch.testing.assert_close(sound["grads"][k], w, **GRAD_TOL,
                                   msg=lambda m: f"{k}\n{m}")
    fault = dp["ranks"][0]["retinanet"]["replica_norm"]
    assert not (abs(fault["terms"]["loss"] - want["terms"]["loss"])
                <= LOSS_RTOL * want["terms"]["loss"]
                and _grads_within(fault["grads"], want["grads"])), \
        "a per-rank avg_factor passes the check"
    assert dp["ranks"][1]["retinanet"]["global"]["same"]


def test_trainer_dp2_is_one_rank_on_the_global_batch(dp, tmp_path):
    """``--dp 2``: the same losses on both ranks, equal to a 1-rank run of
    the same global batch; one log line, the checkpoint from rank 0 only,
    the val count exact; the checkpoint resumes at 1 rank; a ``--dp``
    that does not match the world raises."""
    work = dp["work"]
    r0, r1 = (r["cli"] for r in dp["ranks"])
    assert r0["loss"] == r1["loss"] and len(r0["loss"]) == 2
    one = train_cli.main(_cli_argv(tmp_path / "det1"))
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=1e-4)
    assert r0["val_count"] == r1["val_count"] == one["val_count"] == 4
    assert (r0["saves"], r1["saves"]) == (1, 0)
    lines = open(work / "det2" / "log.jsonl").read().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["step"] == 2
    resumed = train_cli.main(_cli_argv(work / "det2", "--epochs", "2",
                                       "--resume", str(work / "det2")))
    assert len(resumed["loss"]) == 2  # epoch 1 only
    for r in dp["ranks"]:
        assert "does not match the launch's world of 2" in r["mismatch"]


def test_dp_above_one_without_a_launch_names_torchrun(tmp_path):
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        train_cli.main(_cli_argv(tmp_path, "--dp", "2"))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 15, 16, 17, 100])
def test_rank_shard_indices_match_jax(n):
    for world in (1, 2, 3, 4):
        for local_bs in (1, 2, 3):
            shards = [train_cli.rank_shard_indices(n, r, world, local_bs)
                      for r in range(world)]
            for r, got in enumerate(shards):
                want = j_cli.rank_shard_indices(n, r, world, local_bs)
                if want is None:
                    assert got is None
                else:
                    np.testing.assert_array_equal(got, want)
            if shards[0] is not None:  # the same steps on every rank
                assert len({len(s) // local_bs for s in shards}) == 1


@pytest.mark.parametrize("preset", PRESETS)
def test_each_presets_loss_reaches_every_trainable_parameter(preset):
    """DDP runs with ``find_unused_parameters`` off, so every parameter
    that ``frozen_stages`` leaves trainable must get a gradient from the
    step's loss (with frozen BN and, for RetinaNet, with BN trained)."""
    argv = _cli_argv("unused", "--preset", preset)
    for extra in ([], ["--no-norm-eval"]) if "retina" in preset else ([],):
        args = train_cli.parse_args(argv + extra)
        model = train_cli.build_model(args, torch.device("cpu"))
        schedule, _ = train_cli.make_schedule(
            args, train_cli.PRESETS[preset], 1)
        train_cli.make_optimizer(args, model, schedule)  # frozen stages
        step = train_cli.StepLoss(model, preset, 3, 16)
        batch = train_cli.to_device(next(iter(train_cli.data_iter(
            args, True, 0))), "cpu")
        total, _ = step(batch, torch.Generator().manual_seed(0))
        total.backward()
        trainable = [n for n, p in model.named_parameters()
                     if p.requires_grad]
        assert trainable and not [n for n, p in model.named_parameters()
                                  if p.requires_grad and p.grad is None]
        assert not any(p.requires_grad for n, p in model.named_parameters()
                       if n.startswith("backbone.layer1."))
