"""Rank jobs that hold the parallel paths to their one-process forms: one
step of a classifier or a detector on this rank's rows of a global batch,
under DDP (and, given a mesh, tensor parallelism over its ``model`` axis),
with the data replicas' weights compared bit for bit afterwards; the
pipelined DeiT's forward, gradients and step; sharded serving.  Called at
world 1 (no process group) the step functions give the reference: the step
on the whole global batch.  Like every entry point of the port they run on
the card unless given another device.

Each step takes an injected fault by name, the forms that the checks must
catch: ``replica_bn`` (BN moments of the rank's rows), ``replica_norm``
(the detection losses' normalisers of the rank's rows), ``world_bn`` (BN
moments over the world rather than the data group), ``tp_sum_grad`` (the
TP gathers' backward summing over the model group) and ``pipe_sum_out``
(the pipeline's final broadcast's backward summing over the stages).
``tests/test_torch_parallel.py``, ``tests/test_torch_detect_parallel.py``,
``tests/test_torch_model_parallel.py`` and ``chip_smoke.py`` start the
ranks (``parallel/spawn.py``); the tests' jobs run every rank-side check
of their file in one launch.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn

from mrla_tpu_torch.models.common import BatchNorm2d
from mrla_tpu_torch.parallel import comm, launch, pipeline, sharding
from mrla_tpu_torch.parallel.launch import (
    all_gather_metrics,
    global_mean,
    global_sum,
    init_distributed,
    is_main_process,
    rank,
    world_size,
)
from mrla_tpu_torch.parallel.mesh import (
    Axis,
    data_parallel,
    make_mesh,
    shard_batch,
)
from mrla_tpu_torch.parallel.sharding import (
    gather_state_dict,
    shard_train_state,
)

FAULTS = ("replica_bn", "replica_norm", "world_bn", "tp_sum_grad",
          "pipe_sum_out")


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def fault(kind: str):
    """A context that injects the fault ``kind`` (none for another name)."""
    if kind == "replica_bn":
        return _patched(BatchNorm2d, "_global_batch_norm",
                        BatchNorm2d._replica_batch_norm)
    if kind == "replica_norm":
        return _patched(launch, "global_sum", lambda t: t)
    if kind == "world_bn":
        return _patched(BatchNorm2d, "moment_group",
                        lambda self: (None, world_size()))
    if kind == "tp_sum_grad":
        return _patched(sharding._Gather, "cotangent",
                        staticmethod(comm.all_reduce))
    if kind == "pipe_sum_out":
        return _patched(pipeline._GPipe, "output_cotangent",
                        staticmethod(comm.all_reduce))
    return contextlib.nullcontext()


def same_across_ranks(tensors: Iterable[torch.Tensor],
                      axis: Optional[Axis] = None) -> bool:
    """Whether this rank's tensors equal those of the first rank of
    ``axis`` (by default the world) bit for bit (True on one rank): their
    bytes, broadcast from that rank."""
    flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])
    if axis is None:
        axis = Axis(None, range(world_size()), rank())
    if axis.size == 1:
        return True
    ref = flat.clone()
    dist.broadcast(ref, axis.ranks[0], group=axis.group)
    return bool(torch.equal(flat, ref))


def state_bytes(state) -> int:
    """The bytes this rank stores of the parameters and the optimizer's
    state."""
    total = sum(p.numel() * p.element_size()
                for p in state.model.parameters())
    for per in state.optimizer.state.values():
        total += sum(v.numel() * v.element_size() for v in per.values()
                     if torch.is_tensor(v))
    return total


def _rows(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch of numpy arrays, on ``device``."""
    return {k: torch.as_tensor(v).to(device)
            for k, v in shard_batch(batch).items()}


def _cpu(named) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in named}


def bn_stack(seed: int, channels: int = 16) -> torch.nn.Module:
    """Two BatchNorm2d around a ReLU, with seeded scales and biases, in
    training mode (the global-BN check's module)."""
    gen = torch.Generator().manual_seed(seed)
    stack = torch.nn.Sequential(BatchNorm2d(channels), torch.nn.ReLU(),
                                BatchNorm2d(channels))
    with torch.no_grad():
        for m in stack:
            if isinstance(m, BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.5, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return stack.train()


def bn_step(spec: Dict[str, Any], variant: str = "global",
            device="cuda") -> Dict:
    """The BN stack's forward on this rank's rows of ``spec["x"]`` (NCHW),
    the backward of sum(y · cot); the output and input-gradient rows, the
    weight and bias gradients summed over the ranks, the running
    statistics (on the CPU)."""
    stack = bn_stack(spec["seed"], spec["x"].shape[1]).to(device)
    rows = _rows({"x": spec["x"], "cot": spec["cot"]}, device)
    x = rows["x"].requires_grad_()
    with fault(variant):
        y = stack(x)
        (y * rows["cot"]).sum().backward()
    grads = {n: global_sum(p.grad).cpu() for n, p in stack.named_parameters()}
    return {"y": y.detach().cpu(), "dx": x.grad.cpu(), "grads": grads,
            "buffers": _cpu(stack.named_buffers())}


def calls(jobs, device="cuda") -> list:
    """``[step(spec, variant, device) for step, spec, variant in jobs]``
    (a rank job), with TF32 off, as the fp32 references they are held to
    run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return [step(spec, v, device) for step, spec, v in jobs]


def variants(step, spec: Dict[str, Any], names, device="cuda") -> Dict:
    """``{name: step(spec, name, device)}`` (a rank job; :func:`calls`)."""
    return dict(zip(names, calls([(step, spec, v) for v in names], device)))


def classification_step(spec: Dict[str, Any], variant: str = "global",
                        device="cuda") -> Dict:
    """One SGD step of ``ResNetMRLALight(**spec["model"])`` from
    ``spec["state_dict"]`` on this rank's rows of ``spec["batch"]``, through
    DDP when a group is joined; ``variant``: "global", a fault, "fused"
    (the fused train epilogue), "remat" or "world_ddp" (DDP over the world
    rather than the data group).  With ``spec["mesh"]`` (D, M) the ranks
    form a ``("data", "model")`` mesh and the state is tensor-parallel over
    ``model`` (``spec["min_elements"]``, default
    1 << 16).  Returns the loss (the mean over the data group), the whole
    state after the step (rank 0's; others None), whether this rank's
    equals its data axis' first rank's bit for bit, and this rank's stored
    shapes of the sharded leaves, of their momenta and its bytes of
    parameters and optimizer state."""
    from mrla_tpu_torch.models import ResNetMRLALight
    from mrla_tpu_torch.train import (
        create_train_state,
        cross_entropy,
        label_smoothing_ce,
        train_step,
    )
    from mrla_tpu_torch.train.optim import sgd_torch

    model = ResNetMRLALight(**spec["model"], fused_epilogue=variant == "fused",
                            remat=variant == "remat")
    model.load_state_dict(spec["state_dict"])
    model.to(device)
    opt = sgd_torch(model.parameters(), spec["lr"], spec["momentum"],
                    spec["weight_decay"])
    state = create_train_state(model, opt, lambda step: spec["lr"])
    mesh = make_mesh(("data", "model"), spec["mesh"]) if "mesh" in spec \
        else None
    if mesh is not None:
        shard_train_state(state, mesh,
                          min_elements=spec.get("min_elements", 1 << 16))
    smooth = spec.get("label_smooth", 0.0)
    loss_fn = ((lambda lo, la: label_smoothing_ce(lo, la, smooth))
               if smooth else cross_entropy)
    with mesh or contextlib.nullcontext():
        state.ddp = (nn.parallel.DistributedDataParallel(model)
                     if variant == "world_ddp"
                     else data_parallel(model, device))
        with fault(variant):
            loss = train_step(state, _rows(spec["batch"], device),
                              loss_fn)["loss"]
        loss = float(global_mean(loss))
    sd = gather_state_dict(model)
    params = dict(model.named_parameters())
    sharded = {k: tuple(params[k].shape)
               for k, d in getattr(model, "tp_plan", {}).items()
               if d is not None}
    return {"loss": loss,
            "state": _cpu(sd.items()) if is_main_process() else None,
            "same": same_across_ranks(model.state_dict().values(),
                                      mesh and mesh.axis("data")),
            "sharded": sharded,
            "momenta": {k: tuple(opt.state[params[k]]["momentum_buffer"]
                                 .shape) for k in sharded},
            "bytes": state_bytes(state)}


def detection_step(spec: Dict[str, Any], variant: str = "global",
                   device="cuda") -> Dict:
    """One SGD step (momentum 0.9, every parameter trained; BN frozen
    unless ``spec["norm_eval"]`` is false) of a detector
    (``spec["kind"]``: "faster" or "retinanet", built from
    ``spec["model"]`` and ``spec["state_dict"]``) through the trainer's
    ``StepLoss`` on this rank's rows of ``spec["batch"]``, in DDP when a
    group is joined; the samplers take this rank's rows of
    ``spec["uniforms"]`` or draw from a generator seeded
    ``spec["seed"]``.  The rank's loss is scaled by the world, as the
    trainer's.  Returns the global loss terms, the gradients (rank 0's),
    the RoIAlign launches by shape, and whether the weights after the step
    equal rank 0's bit for bit."""
    from mrla_tpu_torch.detect.retinanet import RetinaNet
    from mrla_tpu_torch.detect.train_cli import StepLoss
    from mrla_tpu_torch.detect.two_stage import FasterRCNN
    from mrla_tpu_torch.kernels import roi_align_patch

    retina = spec["kind"] == "retinanet"
    model = (RetinaNet if retina else FasterRCNN)(**spec["model"])
    model.load_state_dict(spec["state_dict"])
    model.to(device).train(not spec.get("norm_eval", True))
    model.requires_grad_(True)
    preset = ("retinanet" if retina else "faster_rcnn") + \
        "_r50mrlal_fpn_1x_coco"
    net = data_parallel(StepLoss(model, preset, spec["model"]["num_classes"],
                                 spec.get("rcnn_num", 512)), device)
    batch = _rows(spec["batch"], device)
    if "uniforms" in spec:
        rand = _rows(spec["uniforms"], device)
    else:
        rand = torch.Generator(device=device).manual_seed(spec.get("seed", 0))
    roi_align_patch.counter.reset()
    with fault(variant):
        total, losses = net(batch, rand)
        (total * launch.data_size()).backward()
    launches = dict(roi_align_patch.counter.by_shape)
    keys = sorted(losses)
    terms = global_sum(torch.stack([losses[k].detach().float()
                                    for k in keys]))
    grads = _cpu((n, p.grad) for n, p in model.named_parameters())
    opt = torch.optim.SGD(model.parameters(), lr=spec["lr"], momentum=0.9)
    opt.step()
    return {"terms": dict(zip(keys, terms.tolist())),
            "grads": grads if is_main_process() else None,
            "launches": launches,
            "same": same_across_ranks(model.state_dict().values())}


def _counting(module, name: str):
    """Patch ``module.name`` with a wrapper that counts its calls."""
    real, calls = getattr(module, name), []

    def wrapper(*a, **kw):
        calls.append(None)
        return real(*a, **kw)
    return _patched(module, name, wrapper), calls


def classification_test_job(work: str) -> Dict:
    """The rank side of ``tests/test_torch_parallel.py`` (its inputs in
    ``<work>/spec.pt``): the launch functions, the batch's rows, the BN
    stack, the classification steps and the trainer on synthetic data and
    on an image tree."""
    from mrla_tpu_torch.train import cli

    spec = torch.load(os.path.join(work, "spec.pt"), weights_only=False)
    out: Dict[str, Any] = {"info": init_distributed(device="cpu"),
                           "main": is_main_process(),
                           "gathered": all_gather_metrics(
                               {"rank": float(rank()), "one": 1.0}),
                           "rows": shard_batch(spec["global_batch"]),
                           "jax_imported": "jax" in __import__("sys").modules}
    out["bn"] = {v: bn_step(spec["bn"], v, "cpu")
                 for v in ("global", "replica_bn")}
    out["cls"] = {v: classification_step(spec["cls"], v, "cpu")
                  for v in ("global", "replica_bn", "fused", "remat")}
    for name, argv in spec["cli"].items():
        patch, calls = _counting(cli, "save_checkpoint")
        with patch:
            res = cli.main(argv)
        out[name] = {"loss": res.get("loss"), "val_count": res["val_count"],
                     "saves": len(calls)}
    return out


def detection_test_job(work: str) -> Dict:
    """The rank side of ``tests/test_torch_detect_parallel.py`` (its inputs
    in ``<work>/spec.pt``): the faster step (the JAX draws' uniforms) and
    the RetinaNet step, each sound and with per-rank normalisers, the
    trainer with ``--dp 2``, and a ``--dp`` that does not match the
    world."""
    from mrla_tpu_torch.ckpt import io
    from mrla_tpu_torch.detect import train_cli

    spec = torch.load(os.path.join(work, "spec.pt"), weights_only=False)
    out: Dict[str, Any] = {}
    for kind in ("faster", "retinanet"):
        out[kind] = {v: detection_step(spec[kind], v, "cpu")
                     for v in ("global", "replica_norm")}
    patch, calls = _counting(io, "save_checkpoint")
    with patch:
        res = train_cli.main(spec["cli"])
    out["cli"] = {"loss": res["loss"], "val_count": res["val_count"],
                  "saves": len(calls)}
    try:
        train_cli.main(spec["cli_mismatch"])
        out["mismatch"] = None
    except SystemExit as e:
        out["mismatch"] = str(e)
    return out




def kernel_counters() -> Dict[str, Any]:
    """Every kernel wrapper's launch counter, by the kernels line's key."""
    from mrla_tpu_torch.kernels import (
        deit_token_tail,
        fused_block_tail,
        fused_epilogue,
        hwbc_copy,
        mrla_block_tail_fused_next,
        mrla_block_tail_hwbc,
        mrla_rowtail,
        roi_align_patch,
        stage4_resident,
    )

    return {"megatail": mrla_block_tail_fused_next.counter,
            "epilogue": fused_epilogue.counter,
            "stage4": stage4_resident.counter,
            "deit_tail": deit_token_tail.counter,
            "roi_align": roi_align_patch.counter,
            "block_tail": fused_block_tail.counter,
            "block_tail_hwbc": mrla_block_tail_hwbc.counter,
            "rowtail": mrla_rowtail.counter,
            "copy": hwbc_copy.counter}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _pipelined_model(spec: Dict[str, Any]):
    from mrla_tpu_torch.models.deit import VisionTransformer
    from mrla_tpu_torch.models.deit_mrla import ViTMRLA

    kind, kw = spec["model"]
    return (ViTMRLA if kind == "light" else VisionTransformer)(**kw)


def pipeline_step(spec: Dict[str, Any], variant: str = "global",
                  device="cuda") -> Dict:
    """The pipelined DeiT of ``spec`` (``"model"``: ("light" | "plain",
    kwargs), ``"state_dict"``, ``"x"``, ``"labels"``, ``"mesh"``: (axes,
    shape), ``"microbatches"``, ``"lr"``) on this rank: the logits of the
    ordinary-weights forward (this rank's rows; with ``"train"`` a
    distilled model's pair), with ``"grads"`` the gradients of the mean
    cross entropy through it (whole, on every rank), and with ``"step"``
    one SGD step (momentum 0.9) from the resident layout, its gradients
    averaged over the data axis: the loss, this rank's span and the rest
    after it, and its ms.  Without ``"mesh"``: the same forward, gradients
    and step through the module itself, the reference."""
    from mrla_tpu_torch.parallel.mesh import average_gradients, batch_sharding
    from mrla_tpu_torch.parallel.pipeline import (
        make_pipelined_vit,
        pipeline_shardings,
        stack_block_params,
    )

    model = _pipelined_model(spec).to(device)
    sd = {k: v.to(device) for k, v in spec["state_dict"].items()}
    x, labels = spec["x"].to(device), spec["labels"].to(device)
    train = spec.get("train", False)
    out: Dict[str, Any] = {}
    ce = torch.nn.functional.cross_entropy
    if "mesh" not in spec:
        model.load_state_dict(sd)
        model.train(train)
        with torch.no_grad():
            out["logits"] = _to_cpu(model(x))
        if spec.get("grads"):
            model.zero_grad()
            ce(model(x), labels).backward()
            out["grads"] = _cpu((k, p.grad) for k, p in
                                model.named_parameters())
        if spec.get("step"):
            opt = torch.optim.SGD(model.parameters(), lr=spec["lr"],
                                  momentum=0.9)
            opt.zero_grad()
            _sync(device)
            t0 = time.perf_counter()
            loss = ce(model(x), labels)
            loss.backward()
            opt.step()
            _sync(device)
            out["ms"] = (time.perf_counter() - t0) * 1e3
            out["loss"] = float(loss.detach())
            out["state"] = _cpu(model.state_dict().items())
        return out
    mesh = make_mesh(*spec["mesh"])
    data = "data" if "data" in mesh.axis_names else None
    fwd, fwd_stacked = make_pipelined_vit(model, mesh,
                                          spec["microbatches"],
                                          data_axis=data)
    rows = labels[batch_sharding(mesh, len(labels), data)] if data \
        else labels
    with torch.no_grad():
        out["logits"] = _to_cpu(fwd(sd, x, train))
    if spec.get("grads"):
        params = {k: v.clone().requires_grad_() for k, v in sd.items()}
        ce(fwd(params, x), rows).backward()
        out["grads"] = _cpu((k, p.grad) for k, p in params.items())
    if spec.get("step"):
        stacked, rest = stack_block_params(sd, len(model.blocks))
        span = {k: v.requires_grad_() for k, v in
                pipeline_shardings(mesh, stacked).items()}
        rest = {k: v.clone().requires_grad_() for k, v in rest.items()}
        leaves = list(span.values()) + list(rest.values())
        opt = torch.optim.SGD(leaves, lr=spec["lr"], momentum=0.9)
        _sync(device)
        t0 = time.perf_counter()
        with mesh, fault(variant):
            loss = ce(fwd_stacked(span, rest, x), rows)
            loss.backward()
            average_gradients(leaves)
        opt.step()
        _sync(device)
        out["ms"] = (time.perf_counter() - t0) * 1e3
        with mesh:
            out["loss"] = float(global_mean(loss.detach()))
        out["span"] = _cpu(span.items())
        out["rest"] = _cpu(rest.items())
        out["same"] = (same_across_ranks(leaves, mesh.axis(data))
                       if data else True)
    return out


def _to_cpu(t):
    if isinstance(t, (tuple, list)):
        return tuple(v.detach().cpu() for v in t)
    return t.detach().cpu()


def _engine(kind: str, weights, device, dtype):
    """(forward, its params) of a serving case: "resnet_mrlal" ((layers,
    state_dict)), "deit" ((arch, state_dict)) or "retinanet" ((kwargs,
    state_dict): the module and ``get_bboxes``)."""
    from mrla_tpu_torch import serving

    spec, sd = weights
    if kind == "resnet_mrlal":
        return serving.resnet_mrlal_forward, serving.prepare_inference_params(
            sd, layers=spec, dtype=dtype, device=device)
    if kind == "deit":
        return serving.deit_forward, serving.prepare_deit_inference_params(
            spec, sd, device=device, dtype=dtype)
    from mrla_tpu_torch.detect.retinanet import RetinaNet

    model = RetinaNet(**spec)
    model.load_state_dict(sd)
    return _detections, model.to(device).eval()


def sharded_serving(spec: Dict[str, Any], device="cuda") -> Dict:
    """``serving.make_sharded_forward`` over a ``("data",)`` mesh of the
    world: for each case of ``spec["cases"]`` (name -> (engine kind,
    weights, static kwargs, global batch); :func:`_engine`), in
    ``spec["dtype"]`` (fp32 by default), this rank's rows of the engine's
    output, the kernel launches by shape across ``spec["requests"]``
    requests (counted from 0 just before them), and, with
    ``spec["timed"]``, the seconds of that many forwards after one."""
    from mrla_tpu_torch.serving import make_sharded_forward

    mesh = make_mesh(("data",), (world_size(),))
    out: Dict[str, Any] = {}
    for name, (kind, weights, kw, x) in spec["cases"].items():
        engine, params = _engine(kind, weights, device,
                                 spec.get("dtype", torch.float32))
        x = x.to(device)
        fwd = make_sharded_forward(mesh, engine, **kw)
        counters = kernel_counters()
        for c in counters.values():
            c.reset()
        with torch.no_grad():
            got = [fwd(params, x) for _ in range(spec.get("requests", 1))]
        _sync(device)
        res = {"out": _to_cpu(got[0]),
               "launches": {k: dict(c.by_shape) for k, c in counters.items()
                            if c.launches}}
        timed = spec.get("timed", 0)
        if timed:
            with torch.no_grad():
                fwd(params, x)
                _sync(device)
                if world_size() > 1:  # the ranks' timed runs overlap
                    dist.barrier()
                t0 = time.perf_counter()
                for _ in range(timed):
                    fwd(params, x)
                _sync(device)
            res["s"] = time.perf_counter() - t0
        out[name] = res
    return out


def _comm_forms() -> Dict[str, bool]:
    """The all-gather and the shift in both forms (``comm.NATIVE``) on a
    ("pipe",) mesh of the world: whether they agree bit for bit and with
    what was sent."""
    mesh = make_mesh(("pipe",), (world_size(),))
    ax = mesh.axis("pipe")
    gen = torch.Generator().manual_seed(ax.index)
    t = torch.randn(3, 2, 5, generator=gen)
    forms = {}
    for native in (True, False):
        with _patched(comm, "NATIVE", native):
            gathered = comm.all_gather(t, 1, ax)
            got = torch.zeros_like(t)
            if ax.index < ax.size - 1:
                comm.send(t, ax.index + 1, ax)
            if ax.index > 0:
                comm.recv(got, ax.index - 1, ax)
        forms[native] = (gathered, got)
    prev = torch.randn(3, 2, 5, generator=torch.Generator().manual_seed(
        ax.index - 1)) if ax.index > 0 else torch.zeros(3, 2, 5)
    mine = forms[True][0].narrow(1, 2 * ax.index, 2)
    return {"gather_forms_equal": torch.equal(forms[True][0], forms[False][0]),
            "shift_forms_equal": torch.equal(forms[True][1], forms[False][1]),
            "gather_holds_mine": torch.equal(mine, t),
            "shift_holds_prev": torch.equal(forms[True][1], prev)}


def model_parallel_test_job(work: str) -> Dict:
    """The rank side of ``tests/test_torch_model_parallel.py`` (its inputs
    in ``<work>/spec.pt``): the TP step on a (2, 2) mesh, sound and with
    its faults; the two forms of the model and pipe collectives; the
    pipelined forwards, gradients and steps; sharded serving."""
    spec = torch.load(os.path.join(work, "spec.pt"), weights_only=False)
    out: Dict[str, Any] = {"jax_imported": "jax" in __import__("sys").modules}
    out["tp"] = {v: classification_step(spec["tp"], v, "cpu")
                 for v in ("global", "tp_sum_grad", "world_bn", "world_ddp")}
    out["comm"] = _comm_forms()
    out["pipe"] = {name: pipeline_step(s, v, "cpu")
                   for name, (s, v) in spec["pipe"].items()}
    serving = spec["serving"]
    serving["cases"] = {
        f"resnet mb{mb}": ("resnet_mrlal", serving["resnet"],
                           {"layers": serving["resnet"][0],
                            "microbatch": mb}, serving["x"])
        for mb in (0, 1)}
    serving["cases"]["retinanet"] = ("retinanet", serving["retina"],
                                     {"img_shape": serving["img_shape"]},
                                     serving["x_det"])
    out["serving"] = sharded_serving(serving, "cpu")
    return out


def _detections(model, x, img_shape):
    """A RetinaNet's ``get_bboxes`` detections of ``x`` (the serving test's
    thresholds: score 0.005, 5 an image)."""
    from mrla_tpu_torch.detect.retinanet import get_bboxes

    return get_bboxes(model(x), img_shape=img_shape, score_thr=0.005,
                      max_per_img=5)
