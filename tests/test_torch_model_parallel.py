"""Model and pipeline parallelism in the port (``mrla_tpu_torch/parallel``,
``serving/sharded.py``) on the CPU, against the JAX package's functions on
conftest's 8 virtual devices.

One launch of four gloo ranks computes every rank-side check of this file
(``parallel.checks.model_parallel_test_job``); the ranks are fresh
interpreters that import torch and the port only.  The JAX side runs here
while they run.  One set of Flax variables feeds both packages through the
weight bridge (``ckpt.state_dict_from_jax`` and its DeiT and RetinaNet
forms).

  * TP: ``tests/test_train_multidevice.py``'s ``ResNetMRLALight([1, 1])``
    (10 classes, 32 px, batch 8; bn3 scales spread and statistics moved, as
    ``tests/test_torch_parallel.py`` does), ``min_elements = 1 << 10``, on
    a (data 2, model 2) mesh, against ``make_train_step`` on
    ``shard_train_state`` over a (1, 2) JAX mesh (``_jax_tp`` says why not
    (2, 2)), at ``tests/test_torch_parallel.py``'s limits.
  * Pipeline: ``tests/test_pipeline.py``'s tiny ``ViTMRLA`` (depth 8, embed
    32, 2 heads) and plain distilled DeiT, on pipe 4 and on data 2 x pipe 2,
    against ``make_pipelined_vit`` at ``atol 2e-5``.
  * Serving: ``resnet_mrlal_forward`` (layers 1-1-1-1, fp32) and a RetinaNet
    (layers 1-1-1-1, 3 classes) with ``get_bboxes`` over four data ranks,
    against the JAX functions on the whole batch, at
    ``tests/test_serving_sharded.py``'s limits.
  * ``dryrun_multichip(4, device="cpu")``: its own four ranks, started
    first, in a thread, while the rest is set up.  The JAX pipeline and
    serving references compile in threads of their own meanwhile.
"""

import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mrla_tpu.detect.retinanet import RetinaNet as FlaxRetinaNet
from mrla_tpu.detect.retinanet import get_bboxes as j_get_bboxes
from mrla_tpu.models.deit import VisionTransformer as FlaxViT
from mrla_tpu.models.deit_mrla import ViTMRLA as FlaxViTMRLA
from mrla_tpu.models.resnet_mrla_light import ResNetMRLALight as FlaxResNet
from mrla_tpu.parallel import make_mesh as j_make_mesh
from mrla_tpu.parallel import shard_batch as j_shard_batch
from mrla_tpu.parallel import shard_train_state as j_shard_train_state
from mrla_tpu.parallel import tp_shardings as j_tp_shardings
from mrla_tpu.parallel.pipeline import make_pipelined_vit as j_pipelined
from mrla_tpu.serving import prepare_inference_params as j_prepare
from mrla_tpu.serving import resnet_mrlal_forward as j_resnet_forward
from mrla_tpu.train import create_train_state as j_create_train_state
from mrla_tpu.train import make_train_step
from mrla_tpu_torch import dryrun_multichip
from mrla_tpu_torch.ckpt import (
    retinanet_state_dict_from_jax,
    state_dict_from_jax,
    vit_state_dict_from_jax,
)
from mrla_tpu_torch.models.deit import VisionTransformer
from mrla_tpu_torch.models.deit_mrla import ViTMRLA
from mrla_tpu_torch.parallel import (
    checks,
    local_mesh,
    make_pipelined_vit,
    stack_block_params,
    unstack_block_params,
)
from mrla_tpu_torch.parallel.mesh import Axis, Mesh
from mrla_tpu_torch.parallel.spawn import start_ranks
from tests.test_torch_parallel import LR, _flax_init
from tests.test_torch_resnet_family import numpy_variables
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=5e-4, atol=5e-5)
STAT_TOL = dict(rtol=1e-4, atol=1e-5)
PIPE_ATOL = 2e-5
SERVE_TOL = dict(rtol=1e-3, atol=1e-2)
WORLD, TP_BATCH, PIPE_LR = 4, 8, 0.1
TINY = dict(patch_size=16, num_classes=13, embed_dim=32, depth=8,
            num_heads=2, dim_mrla=16, variant="light")
DISTILLED = dict(patch_size=16, num_classes=11, embed_dim=32, depth=8,
                 num_heads=2, distilled=True)
SERVE_LAYERS = (1, 1, 1, 1)
RETINA_PX = 64


class _Background:
    """``fn(*args, **kw)`` in a thread; :meth:`result` joins it."""

    def __init__(self, fn, *args, **kw):
        self.out, self.err = None, None

        def run():
            try:
                self.out = fn(*args, **kw)
            except BaseException as e:  # handed to the caller in result()
                self.err = e
        self.thread = threading.Thread(target=run)
        self.thread.start()

    def result(self):
        self.thread.join()
        if self.err is not None:
            raise self.err
        return self.out


def _ce(logits, labels):
    return optax.softmax_cross_entropy_with_integer_labels(
        logits, labels).mean()


def _jax_tp(model, variables, batch):
    """(loss, the port state_dict after the step, the leaves that
    ``tp_shardings`` shards at 1 << 10 on a (2, 2) mesh under the bridge).
    The step is ``make_train_step`` on ``shard_train_state`` over a (data
    1, model 2) mesh: on a (2, 2) mesh XLA's partitioner moves the
    depthwise Wv of layer1 otherwise than one device does, by as much as
    the update itself, with the parameters replicated as well as sharded,
    where the (1, 2) and (4, 1) meshes agree with one device."""
    state = j_create_train_state(
        model, jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
        optax.sgd(LR, momentum=0.9),
        variables=jax.tree.map(jnp.asarray, variables))
    plan = j_tp_shardings(
        variables["params"], j_make_mesh(axes=("data", "model"),
                                         shape=(2, 2),
                                         devices=jax.devices()[:4]),
        min_elements=1 << 10)
    mesh = j_make_mesh(axes=("data", "model"), shape=(1, 2),
                       devices=jax.devices()[:2])
    marked = jax.tree.map(
        lambda v, sh: np.broadcast_to(
            np.arange(v.shape[-1], dtype=np.float32) + 1, v.shape)
        if sh.spec != P() else np.zeros(v.shape, np.float32),
        variables["params"], plan)
    sharded = {k: v for k, v in state_dict_from_jax(
        {"params": marked,
         "batch_stats": jax.tree.map(np.zeros_like,
                                     variables["batch_stats"])}).items()
        if v.is_floating_point() and v.numel() and v.abs().min() > 0}
    state = j_shard_train_state(state, mesh)
    with mesh:
        state, met = jax.jit(make_train_step())(
            state, j_shard_batch(batch, mesh), jax.random.key(2))
    sd = state_dict_from_jax(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))
    return float(met["loss"]), sd, sharded


def _jax_pipeline(tiny, params, dist, dist_params, x, labels):
    """The JAX pipelined forwards, gradients and stacked-layout step."""
    devices = jax.devices()[:4]
    mesh4 = j_make_mesh(axes=("pipe",), shape=(4,), devices=devices)
    fwd, _ = j_pipelined(tiny, mesh4, num_microbatches=4)
    tx = optax.sgd(PIPE_LR, momentum=0.9)

    def run(p, x, y):
        """The logits, the gradients through the pipelined forward and the
        SGD step they make (the stacked layout's step, as optax steps
        leaf by leaf)."""
        (_, logits), g = jax.value_and_grad(
            lambda p: (lambda lo: (_ce(lo, y), lo))(fwd(p, x)),
            has_aux=True)(p)
        upd, _ = tx.update(g, tx.init(p))
        return logits, g, optax.apply_updates(p, upd)

    mesh22 = j_make_mesh(axes=("data", "pipe"), shape=(2, 2),
                         devices=devices)
    fwd22, _ = j_pipelined(tiny, mesh22, num_microbatches=2,
                           data_axis="data")
    fwd_dist, _ = j_pipelined(dist, mesh4, num_microbatches=4)
    with mesh4:
        logits, grads, stepped = jax.jit(run)(params, x, labels)
        dist_out = jax.jit(lambda p, x: (fwd_dist(p, x),
                                         fwd_dist(p, x, True)))(
            dist_params, x)
    with mesh22:
        logits22 = jax.jit(fwd22)(params, x)
    as_sd = lambda tree, kind="light": {  # noqa: E731
        k: v for k, v in vit_state_dict_from_jax(
            {"params": jax.device_get(tree)}, kind).items()}
    return {"pipe4": np.asarray(logits), "dp2xpipe2": np.asarray(logits22),
            "grads": as_sd(grads), "step": as_sd(stepped),
            "dist eval": np.asarray(dist_out[0]),
            "dist train": tuple(np.asarray(t) for t in dist_out[1])}


def _jax_serving(resnet_vars, retina, retina_vars, x, x_det):
    sp = j_prepare(resnet_vars, layers=SERVE_LAYERS, dtype=jnp.float32)
    logits = jax.jit(lambda sp, x: j_resnet_forward(
        sp, x, layers=SERVE_LAYERS, microbatch=0))(sp, x)

    def detect(v, x):
        outs = retina.apply(v, x, train=False)
        return j_get_bboxes(outs, img_shape=(RETINA_PX, RETINA_PX),
                            score_thr=0.005, max_per_img=5)

    dets = jax.jit(detect)(retina_vars, x_det)
    return np.asarray(logits), [np.asarray(t) for t in dets]


def _pipe_spec(kind, kw, sd, x, labels, mesh=None, m=4, **flags):
    spec = {"model": (kind, dict(kw, img_size=32)), "state_dict": sd,
            "x": x, "labels": labels, "microbatches": m, "lr": PIPE_LR,
            **flags}
    if mesh is not None:
        spec["mesh"] = mesh
    return spec


@pytest.fixture(scope="module")
def mp(tmp_path_factory):
    """The inputs, the four ranks' results and the JAX references."""
    work = tmp_path_factory.mktemp("mp")
    dryrun = _Background(dryrun_multichip, WORLD, device="cpu")
    tiny, dist = FlaxViTMRLA(**TINY), FlaxViT(**DISTILLED)
    tiny_vars = numpy_variables(tiny, 32, seed=0)
    dist_vars = numpy_variables(dist, 32, seed=4)
    x = np.random.default_rng(1).standard_normal((8, 32, 32, 3)).astype(
        np.float32)
    labels = np.arange(8) % 13
    jax_pipe = _Background(_jax_pipeline, tiny, tiny_vars["params"], dist,
                           dist_vars["params"], x, labels)
    resnet_vars = numpy_variables(FlaxResNet(layers=list(SERVE_LAYERS),
                                             num_classes=10), 32, seed=5)
    retina = FlaxRetinaNet(layers=(1, 1, 1, 1), num_classes=3)
    retina_vars = numpy_variables(retina, RETINA_PX, seed=7)
    xs = np.random.default_rng(6).standard_normal((8, 32, 32, 3)).astype(
        np.float32)
    x_det = np.random.default_rng(7).standard_normal(
        (8, RETINA_PX, RETINA_PX, 3)).astype(np.float32)
    jax_serve = _Background(_jax_serving, resnet_vars, retina, retina_vars,
                            xs, x_det)
    model, variables = _flax_init()
    rng = np.random.default_rng(2)
    batch = {"image": rng.standard_normal(
                 (TP_BATCH, 32, 32, 3)).astype(np.float32),
             "label": (np.arange(TP_BATCH) % 10).astype(np.int64)}
    tiny_sd = vit_state_dict_from_jax(tiny_vars, "light")
    dist_sd = vit_state_dict_from_jax(dist_vars, "plain")
    tx, tl = torch.from_numpy(x), torch.from_numpy(labels)
    pipe4, pipe22 = (("pipe",), (4,)), (("data", "pipe"), (2, 2))
    spec = {
        "tp": {"model": {"layers": [1, 1], "num_classes": 10},
               "state_dict": state_dict_from_jax(variables), "batch": batch,
               "lr": LR, "momentum": 0.9, "weight_decay": 0.0,
               "mesh": (2, 2), "min_elements": 1 << 10},
        "pipe": {
            "pipe4": (_pipe_spec("light", TINY, tiny_sd, tx, tl, pipe4,
                                 grads=True, step=True), "global"),
            "pipe4 fault": (_pipe_spec("light", TINY, tiny_sd, tx, tl,
                                       pipe4, step=True), "pipe_sum_out"),
            "dp2xpipe2": (_pipe_spec("light", TINY, tiny_sd, tx, tl,
                                     pipe22, m=2, step=True), "global"),
            "dist eval": (_pipe_spec("plain", DISTILLED, dist_sd, tx, tl,
                                     pipe4), "global"),
            "dist train": (_pipe_spec("plain", DISTILLED, dist_sd, tx, tl,
                                      pipe4, train=True), "global"),
        },
        "serving": {
            "x": torch.from_numpy(xs),
            "resnet": (SERVE_LAYERS, state_dict_from_jax(resnet_vars)),
            "retina": ({"layers": (1, 1, 1, 1), "num_classes": 3},
                       retinanet_state_dict_from_jax(retina_vars)),
            "img_shape": (RETINA_PX, RETINA_PX),
            "x_det": torch.from_numpy(x_det)},
    }
    torch.save(spec, work / "spec.pt")
    ranks = start_ranks(checks.model_parallel_test_job, WORLD, str(work),
                        args=(str(work),), threads=1)
    try:
        jax_tp = _jax_tp(model, variables, {
            "image": batch["image"],
            "label": batch["label"].astype(np.int32)})
    finally:
        results = ranks.join()
        ran = dryrun.result()
    return {"spec": spec, "ranks": results, "tp": jax_tp,
            "pipe": jax_pipe.result(), "serve": jax_serve.result(),
            "dryrun": ran}


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


def test_ranks_import_no_jax(mp):
    assert not any(r["jax_imported"] for r in mp["ranks"])


def test_tp_sharded_keys_are_the_jax_plan_under_the_bridge(mp):
    """The port's sharded leaves at 1 << 10 on a (2, 2) mesh are exactly
    the image, under the bridge, of the leaves that the JAX
    ``tp_shardings`` shards; each is halved on the dim that holds JAX's
    last axis."""
    want = mp["tp"][2]
    for r in mp["ranks"]:
        got = r["tp"]["global"]["sharded"]
        assert set(got) == set(want)
        for k, marked in want.items():
            dims = [d for d in range(marked.ndim)
                    if not torch.equal(marked, marked.narrow(d, 0, 1)
                                       .expand_as(marked))]
            full = list(marked.shape)
            full[dims[0]] //= 2
            assert len(dims) == 1 and got[k] == tuple(full), k


def test_each_model_rank_stores_half_of_each_sharded_leaf(mp):
    """In the parameters and in the momenta; its bytes of both below the
    replicated model's."""
    full = {k: tuple(v.shape) for k, v in mp["tp"][1].items()}
    for r in mp["ranks"]:
        res = r["tp"]["global"]
        assert res["momenta"] == res["sharded"]
        for k, shape in res["sharded"].items():
            assert np.prod(shape) * 2 == np.prod(full[k]), k
        whole = sum(np.prod(full[k]) for k in full
                    if "running" not in k and "tracked" not in k) * 4 * 2
        assert res["bytes"] < whole


def test_tp_step_matches_the_jax_mesh_step(mp):
    """The (2, 2) TP step against ``make_train_step`` on
    ``shard_train_state``; the data replicas bitwise equal after it."""
    j_loss, j_sd, _ = mp["tp"]
    sound = mp["ranks"][0]["tp"]["global"]
    np.testing.assert_allclose(sound["loss"], j_loss, rtol=LOSS_RTOL)
    assert _within(sound["state"], j_sd, "global")
    assert all(r["tp"]["global"]["same"] for r in mp["ranks"])


@pytest.mark.parametrize("fault", ["tp_sum_grad", "world_ddp"])
def test_tp_faults_fail_the_limits(mp, fault):
    """The gathers' backward summing over the model group, and DDP over the
    world (its first broadcast overwrites model rank 1's shards with rank
    0's, its mean mixes channels): each fails the step's limits."""
    got = mp["ranks"][0]["tp"][fault]
    assert not _within(got["state"], mp["tp"][1], fault)


def test_bn_over_the_world_group_equals_the_data_group(mp):
    """BN's moments over the world (``world_bn``) give the data group's
    step: the count is summed with the sums, so the model replicas double
    both, and the backward's doubled cotangent meets a doubled count."""
    got = mp["ranks"][0]["tp"]["world_bn"]
    np.testing.assert_allclose(got["loss"], mp["tp"][0], rtol=LOSS_RTOL)
    assert _within(got["state"], mp["tp"][1], "world_bn")


def test_model_and_pipe_collectives_agree_in_both_forms(mp):
    """all_gather_into_tensor and batch_isend_irecv against the all-reduce
    and broadcast forms (which gloo carries for CUDA tensors): bitwise."""
    for r in mp["ranks"]:
        assert all(r["comm"].values()), r["comm"]


def test_stack_block_params_round_trip_bitwise(mp):
    sd = mp["spec"]["pipe"]["pipe4"][0]["state_dict"]
    stacked, rest = stack_block_params(sd, TINY["depth"])
    assert stacked["attn.qkv.weight"].shape[0] == TINY["depth"]
    back = unstack_block_params(stacked, rest)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())


def _rows(name):
    """The ranks whose rows make up the global batch: every data index at
    pipe index 0."""
    return [0] if name.startswith(("pipe4", "dist")) else [0, 2]


@pytest.mark.parametrize("name", ["pipe4", "dp2xpipe2"])
def test_pipelined_forward_matches_jax(mp, name):
    got = torch.cat([mp["ranks"][r]["pipe"][name]["logits"]
                     for r in _rows(name)])
    np.testing.assert_allclose(got.numpy(), mp["pipe"][name],
                               atol=PIPE_ATOL)
    for r, res in enumerate(mp["ranks"]):  # each pipe rank: its rows'
        first = r - r % 2 if name == "dp2xpipe2" else 0
        assert torch.equal(res["pipe"][name]["logits"],
                           mp["ranks"][first]["pipe"][name]["logits"]), r


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_pipelined_distilled_deit_matches_jax(mp, mode):
    got = mp["ranks"][0]["pipe"][f"dist {mode}"]["logits"]
    want = mp["pipe"][f"dist {mode}"]
    if mode == "train":
        assert isinstance(got, tuple) and len(got) == 2
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, atol=PIPE_ATOL)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=PIPE_ATOL)


def test_pipelined_gradients_match_jax(mp):
    """Through ``forward`` from ordinary weights: every block's gradient on
    every pipe rank, as JAX's replicated params get it."""
    want = mp["pipe"]["grads"]
    for r in mp["ranks"]:
        got = r["pipe"]["pipe4"]["grads"]
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                       atol=PIPE_ATOL, err_msg=k)


def _stepped(mp, name):
    """The whole weights after a resident-layout step: each pipe rank's
    span (at data index 0) and rank 0's rest."""
    ranks = mp["ranks"]
    spans = [0, 1, 2, 3] if name.startswith("pipe4") else [0, 1]
    stacked = {k: torch.cat([ranks[r]["pipe"][name]["span"][k]
                             for r in spans])
               for k in ranks[0]["pipe"][name]["span"]}
    return unstack_block_params(stacked, ranks[0]["pipe"][name]["rest"])


def _step_within(got, want) -> bool:
    return all(np.allclose(got[k].numpy(), v.numpy(), atol=PIPE_ATOL,
                           rtol=0) for k, v in want.items())


@pytest.mark.parametrize("name", ["pipe4", "dp2xpipe2"])
def test_pipelined_step_matches_jax(mp, name):
    """One SGD step from the resident layout (the data replicas' gradients
    averaged) against the JAX stacked-layout step; the data replicas
    bitwise equal after it."""
    assert _step_within(_stepped(mp, name), mp["pipe"]["step"])
    assert all(r["pipe"][name]["same"] for r in mp["ranks"])


def test_pipeline_broadcast_summing_over_stages_fails(mp):
    """The final broadcast's backward summing the stages' cotangents."""
    assert not _step_within(_stepped(mp, "pipe4 fault"), mp["pipe"]["step"])


def _mesh(s: int) -> Mesh:
    """A ("pipe",) mesh of S positions seen from position 0 (the refusals
    are raised before any collective)."""
    return Mesh(("pipe",), np.arange(s), {"pipe": Axis(None, range(s), 0)})


@pytest.mark.parametrize("case", ["drop_rate", "attn_drop_rate",
                                  "drop_path_rate", "base", "type",
                                  "depth", "batch"])
def test_pipeline_refusals(case):
    kw = dict(TINY, img_size=32)
    mesh, m = _mesh(4), 4
    if case in ("drop_rate", "attn_drop_rate", "drop_path_rate"):
        kw[case] = 0.1
        err, match = ValueError, case
    elif case == "base":
        kw["variant"] = "base"
        err, match = ValueError, "light variant"
    elif case == "depth":
        mesh, err, match = _mesh(3), ValueError, "depth 8 % pipe 3"
    elif case == "batch":
        m, err, match = 3, ValueError, "batch 8 % microbatches 3"
    if case == "type":
        model, err, match = torch.nn.Linear(2, 2), TypeError, "Linear"
    else:
        model = ViTMRLA(**kw)
    with pytest.raises(err, match=match):
        fwd, _ = make_pipelined_vit(model, mesh, m)
        fwd(model.state_dict(), torch.zeros(8, 32, 32, 3))


@pytest.mark.parametrize("mb", [0, 1])
def test_sharded_serving_matches_jax(mp, mb):
    """Four data ranks, each its two rows through the port's
    ``resnet_mrlal_forward``, against the JAX engine on the whole batch."""
    got = torch.cat([r["serving"][f"resnet mb{mb}"]["out"]
                     for r in mp["ranks"]])
    np.testing.assert_allclose(got.numpy(), mp["serve"][0], **SERVE_TOL)


def test_sharded_detection_serving_matches_jax(mp):
    """RetinaNet + ``get_bboxes`` over four data ranks: labels and validity
    exact, scores and boxes at the JAX serving test's limits."""
    got = [torch.cat([r["serving"]["retinanet"]["out"][i]
                      for r in mp["ranks"]]).numpy() for i in range(4)]
    (gb, gs, gl, gv), (wb, ws, wl, wv) = got, mp["serve"][1]
    assert wv.any()
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gl[wv], wl[wv])
    np.testing.assert_allclose(gs[wv], ws[wv], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(gb[wv], wb[wv], rtol=1e-3, atol=0.5)


def test_vision_transformer_is_pipelined_by_its_own_class():
    """The plain DeiT goes through the same schedule (its blocks are
    ``ViTBlock``s): on ``local_mesh()``, which has no pipe axis, one stage
    gives the module's logits."""
    model = VisionTransformer(img_size=32, **DISTILLED).eval()
    fwd, _ = make_pipelined_vit(model, local_mesh(), 2)
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(fwd(model.state_dict(), x), model(x),
                                   rtol=0, atol=1e-6)


def test_dryrun_multichip_on_four_cpu_ranks(mp):
    """The five steps at n = 4: TP 2 on (a)-(d), the pipeline step (e),
    one line each, finite losses, the data replicas bitwise equal."""
    ran = mp["dryrun"]
    assert ran["tp"] == 2
    names = ["ok", "mrlab ok", "deit ok", "detect ok", "pipeline ok"]
    assert list(ran["steps"]) == names
    assert [line.split(": ")[1].split(",")[0] for line in ran["lines"]] \
        == names
    for name, step in ran["steps"].items():
        assert math.isfinite(step["loss"]) and step["same"], name
