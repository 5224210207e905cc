"""Data parallelism in the port (``mrla_tpu_torch/parallel``) on the CPU:
the launch functions, a rank's rows of the global batch, BN over the
global batch, one classification step at two gloo ranks against the JAX
package's step on its 8-device mesh, and the trainer at two ranks.

One launch of two gloo ranks computes every rank-side check of this file
(``parallel.checks.classification_test_job``): the ranks are fresh
interpreters (the spawn start method) that import torch and the port only,
joined through a file store under the test's temporary directory.  The JAX
side runs here, on conftest's 8 virtual devices, while the ranks run.

One init feeds both packages: the Flax init of a ``(1, 1)``
ResNetMRLALight (10 classes, 32 px; ``tests/test_train_multidevice.py``),
its bn3 scales drawn from U(0.1, 0.5) and its running statistics moved
with seeded numpy (so that every residual branch works and the running
update shows), carried to the port by ``state_dict_from_jax``.  Limits are
those of ``tests/test_torch_train.py``: the loss ``rtol 1e-5``, every
parameter ``rtol 5e-4, atol 5e-5``, every running statistic ``rtol 1e-4,
atol 1e-5``; the BN stack's outputs and gradients at the running
statistics' limits.  Per-replica BN, the injected fault, must fail them.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mrla_tpu.models.resnet_mrla_light import ResNetMRLALight as FlaxResNet
from mrla_tpu.parallel import make_mesh
from mrla_tpu.parallel import shard_batch as j_shard_batch
from mrla_tpu.train import create_train_state as j_create_train_state
from mrla_tpu.train import make_train_step
from mrla_tpu_torch.ckpt import state_dict_from_jax
from mrla_tpu_torch.parallel import checks, init_distributed, initialized
from mrla_tpu_torch.parallel.spawn import start_ranks
from mrla_tpu_torch.train import cli

LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=5e-4, atol=5e-5)
STAT_TOL = dict(rtol=1e-4, atol=1e-5)
WORLD, GLOBAL_BATCH, LR = 2, 16, 0.05


def _write_tree(root, per_class, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    for c, n in enumerate(per_class):
        d = os.path.join(root, f"class_{c}")
        os.makedirs(d)
        for i in range(n):
            arr = rng.integers(0, 255, (40 + 4 * i, 48, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"{i}.png"))


def _cli_argv(out, *extra):
    return ["-a", "resnet50_mrlal", "--layers", "1", "1", "1", "1",
            "--image-size", "32", "--num-classes", "3", "-b", "4",
            "--epochs", "1", "--device", "cpu", "--print-freq", "1000",
            "--output-dir", str(out), *extra]


def _flax_init():
    """The Flax init with spread bn3 scales and moved statistics (numpy)."""
    model = FlaxResNet(layers=[1, 1], num_classes=10)
    variables = jax.device_get(jax.jit(
        lambda k: model.init(k, jnp.zeros((1, 32, 32, 3)), train=False))(
            jax.random.key(0)))
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, v: _spread(rng, jax.tree_util.keystr(path),
                                np.array(v)), variables)
    return model, variables


def _spread(rng, path, v):
    if "bn3" in path and "scale" in path:
        return rng.uniform(0.1, 0.5, v.shape).astype(np.float32)
    if "'mean'" in path:
        return rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)
    if "'var'" in path:
        return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return v


def _jax_mesh_step(model, variables, batch):
    """``make_train_step`` on the 8-device mesh: (loss, port state_dict)."""
    state = j_create_train_state(
        model, jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
        optax.sgd(LR, momentum=0.9),
        variables=jax.tree.map(jnp.asarray, variables))
    mesh = make_mesh(axes=("data", "model"), shape=(8, 1))
    state = jax.device_put(state, NamedSharding(mesh, P()))
    with mesh:
        state, met = jax.jit(make_train_step())(
            state, j_shard_batch(batch, mesh), jax.random.key(2))
    sd = state_dict_from_jax(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))
    return float(met["loss"]), sd


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The inputs, the two ranks' results and the JAX mesh step."""
    work = tmp_path_factory.mktemp("dp")
    model, variables = _flax_init()
    rng = np.random.default_rng(2)
    batch = {"image": rng.standard_normal(
                 (GLOBAL_BATCH, 32, 32, 3)).astype(np.float32),
             "label": (np.arange(GLOBAL_BATCH) % 10).astype(np.int64)}
    tree = work / "tree"
    _write_tree(str(tree / "train"), (4, 4), 0)
    _write_tree(str(tree / "val"), (3, 2), 1)  # 5: ragged over 2 ranks
    spec = {
        "global_batch": {"x": np.arange(24, dtype=np.float32).reshape(8, 3)},
        "bn": {"seed": 3, "x": rng.standard_normal((8, 16, 5, 5)).astype(
                   np.float32) * 2 + 1,
               "cot": rng.standard_normal((8, 16, 5, 5)).astype(np.float32)},
        "cls": {"model": {"layers": [1, 1], "num_classes": 10},
                "state_dict": state_dict_from_jax(variables), "batch": batch,
                "lr": LR, "momentum": 0.9, "weight_decay": 0.0},
        "cli": {"synthetic": _cli_argv(work / "syn2", "--data", "synthetic",
                                       "--synthetic-steps", "2"),
                "tree": _cli_argv(work / "tree2", "--data", str(tree),
                                  "--workers", "1")},
    }
    torch.save(spec, work / "spec.pt")
    ranks = start_ranks(checks.classification_test_job, WORLD,
                        str(work), args=(str(work),), threads=2)
    try:
        j_loss, j_sd = _jax_mesh_step(model, variables, {
            "image": batch["image"], "label": batch["label"].astype(
                np.int32)})
    finally:
        results = ranks.join()
    return {"work": work, "spec": spec, "ranks": results,
            "jax": (j_loss, j_sd)}


def _within(got, want, what):
    """Whether every entry of ``got`` is within its limit of ``want``."""
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = STAT_TOL if "running" in k else PARAM_TOL
        if not torch.allclose(v, want[k], **tol):
            print(f"{what}: {k} beyond its limit")
            return False
    return True


def test_init_distributed_is_a_no_op_at_world_1(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() == {"process_index": 0, "process_count": 1,
                                  "local_devices": 1, "global_devices": 1}
    assert not initialized()


def test_launch_functions_and_rows_across_two_ranks(dp):
    r0, r1 = dp["ranks"]
    for r, res in enumerate(dp["ranks"]):
        assert res["info"] == {"process_index": r, "process_count": WORLD,
                               "local_devices": 1, "global_devices": WORLD}
        assert res["gathered"] == {"rank": 1.0, "one": 2.0}
        assert not res["jax_imported"]
    assert (r0["main"], r1["main"]) == (True, False)
    np.testing.assert_array_equal(
        np.concatenate([r0["rows"]["x"], r1["rows"]["x"]]),
        dp["spec"]["global_batch"]["x"])


def test_global_batch_norm_at_two_ranks_is_one_rank_on_the_global_batch(dp):
    """A stack of BatchNorm2d at 2 ranks against 1 rank on the global
    batch: the output, the input gradient, the weight and bias gradients,
    the running statistics (the biased rule); per-replica BN fails."""
    want = checks.bn_step(dp["spec"]["bn"], device="cpu")
    bn_buffers = want["buffers"]

    def errors(variant):
        got = [r["bn"][variant] for r in dp["ranks"]]
        out = {k: not torch.allclose(torch.cat([g[k] for g in got]),
                                     want[k], **STAT_TOL)
               for k in ("y", "dx")}
        for g in got:
            for n, t in g["grads"].items():
                out[n] = out.get(n, False) or not torch.allclose(
                    t, want["grads"][n], **STAT_TOL)
            for n, t in g["buffers"].items():
                out[n] = out.get(n, False) or not torch.allclose(
                    t.double(), bn_buffers[n].double(), **STAT_TOL)
        return out

    sound = errors("global")
    assert not any(sound.values()), sound
    assert all(errors("replica_bn")[k] for k in ("y", "dx")), \
        "per-replica BN passes the check"
    assert int(bn_buffers["0.num_batches_tracked"]) == 1


def test_two_rank_step_matches_the_jax_mesh_step(dp):
    """The 2-rank gloo DDP step (global BN) against ``make_train_step`` on
    the 8-device mesh; per-replica BN fails the same limits; the ranks'
    weights after the step are bitwise equal."""
    j_loss, j_sd = dp["jax"]
    sound = dp["ranks"][0]["cls"]["global"]
    np.testing.assert_allclose(sound["loss"], j_loss, rtol=LOSS_RTOL)
    assert _within(sound["state"], j_sd, "global")
    fault = dp["ranks"][0]["cls"]["replica_bn"]
    assert not _within(fault["state"], j_sd, "replica_bn"), \
        "per-replica BN passes the check"
    for variant in ("global", "fused", "remat"):
        assert dp["ranks"][1]["cls"][variant]["same"], variant


def test_two_rank_fused_epilogue_and_remat_steps(dp):
    """The fused train epilogue's step at 2 ranks against 1 rank on the
    global batch; the remat step against the plain one at 2 ranks, the
    running statistics updated once."""
    want = checks.classification_step(dp["spec"]["cls"], "fused",
                                      device="cpu")
    got = dp["ranks"][0]["cls"]["fused"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert _within(got["state"], want["state"], "fused")
    remat = dp["ranks"][0]["cls"]["remat"]
    plain = dp["ranks"][0]["cls"]["global"]
    np.testing.assert_allclose(remat["loss"], plain["loss"], rtol=LOSS_RTOL)
    assert _within(remat["state"], plain["state"], "remat")
    tracked = {k: int(v) for k, v in remat["state"].items()
               if k.endswith("num_batches_tracked")}
    assert tracked and set(tracked.values()) == {1}, tracked


def test_trainer_at_two_ranks_is_one_rank_on_the_global_batch(dp):
    """Synthetic data, 1 epoch of 2 steps: the same loss on both ranks,
    equal to a 1-rank run of the same global batch; one log line, the
    checkpoint from rank 0 only, the val count exact; the checkpoint
    written at 2 ranks resumes at 1."""
    work = dp["work"]
    r0, r1 = (r["synthetic"] for r in dp["ranks"])
    assert r0["loss"] == r1["loss"] and len(r0["loss"]) == 2
    one = cli.main(_cli_argv(work / "syn1", "--data", "synthetic",
                             "--synthetic-steps", "2"))
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=1e-4)
    assert r0["val_count"] == r1["val_count"] == one["val_count"] == 8
    assert (r0["saves"], r1["saves"]) == (1, 0)
    lines = open(work / "syn2" / "log.txt").read().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["epoch"] == 0
    resumed = cli.main(_cli_argv(work / "syn2", "--data", "synthetic",
                                 "--synthetic-steps", "2", "--epochs", "2",
                                 "--resume", str(work / "syn2")))
    assert [h["epoch"] for h in resumed["history"]] == [1]
    assert resumed["state"].step == 4


def test_trainer_at_two_ranks_on_an_image_tree_counts_each_val_image(dp):
    """Real data at 2 ranks: the samplers' rank and world (8 images, 2
    steps of 2 a rank), and validation over 5 images, strided and padded
    on each rank, counting each once."""
    r0, r1 = (r["tree"] for r in dp["ranks"])
    assert r0["loss"] == r1["loss"] and len(r0["loss"]) == 2
    assert np.isfinite(r0["loss"]).all()
    assert r0["val_count"] == r1["val_count"] == 5
    assert (r0["saves"], r1["saves"]) == (1, 0)
