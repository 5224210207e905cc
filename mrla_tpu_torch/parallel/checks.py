"""Rank jobs that hold the data-parallel path to its one-process form: one
step of a classifier or a detector on this rank's rows of a global batch,
under DDP, with the two ranks' weights compared bit for bit afterwards.
Called at world 1 (no process group) the same functions give the
reference: the step on the whole global batch.

Each step takes an injected fault by name, the per-replica forms that the
checks must catch: ``replica_bn`` (BN moments of the rank's rows) and
``replica_norm`` (the detection losses' normalisers of the rank's rows).
``tests/test_torch_parallel.py``, ``tests/test_torch_detect_parallel.py``
and ``chip_smoke.py`` start the ranks (``parallel/spawn.py``); the tests'
jobs (:func:`classification_test_job`, :func:`detection_test_job`) run
every rank-side check of their file in one launch.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Iterable

import torch
import torch.distributed as dist

from mrla_tpu_torch.models.common import BatchNorm2d
from mrla_tpu_torch.parallel import launch
from mrla_tpu_torch.parallel.launch import (
    all_gather_metrics,
    global_mean,
    global_sum,
    init_distributed,
    is_main_process,
    rank,
    world_size,
)
from mrla_tpu_torch.parallel.mesh import data_parallel, shard_batch

FAULTS = ("replica_bn", "replica_norm")


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
    return contextlib.nullcontext()


def same_across_ranks(tensors: Iterable[torch.Tensor]) -> bool:
    """Whether this rank's tensors equal rank 0's bit for bit (True at
    world 1): their bytes, broadcast from rank 0."""
    flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])
    if world_size() == 1:
        return True
    ref = flat.clone()
    dist.broadcast(ref, 0)
    return bool(torch.equal(flat, ref))


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
            device="cpu") -> Dict:
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


def variants(step, spec: Dict[str, Any], names, device="cpu") -> Dict:
    """``{name: step(spec, name, device)}`` (a rank job), with TF32 off, as
    the fp32 reference it is held to runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {v: step(spec, v, device) for v in names}


def classification_step(spec: Dict[str, Any], variant: str = "global",
                        device="cpu") -> Dict:
    """One SGD step of ``ResNetMRLALight(**spec["model"])`` from
    ``spec["state_dict"]`` on this rank's rows of ``spec["batch"]``, through
    DDP when a group is joined; ``variant``: "global", a fault, "fused"
    (the fused train epilogue) or "remat".  Returns the loss (the mean
    over the ranks), the state after the step (rank 0's; others None) and
    whether this rank's equals rank 0's bit for bit."""
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
    state.ddp = data_parallel(model, device)
    smooth = spec.get("label_smooth", 0.0)
    loss_fn = ((lambda lo, la: label_smoothing_ce(lo, la, smooth))
               if smooth else cross_entropy)
    with fault(variant):
        loss = train_step(state, _rows(spec["batch"], device),
                          loss_fn)["loss"]
    sd = model.state_dict()
    return {"loss": float(global_mean(loss)),
            "state": _cpu(sd.items()) if is_main_process() else None,
            "same": same_across_ranks(sd.values())}


def detection_step(spec: Dict[str, Any], variant: str = "global",
                   device="cpu") -> Dict:
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
        (total * world_size()).backward()
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
    out: Dict[str, Any] = {"info": init_distributed(),
                           "main": is_main_process(),
                           "gathered": all_gather_metrics(
                               {"rank": float(rank()), "one": 1.0}),
                           "rows": shard_batch(spec["global_batch"]),
                           "jax_imported": "jax" in __import__("sys").modules}
    out["bn"] = {v: bn_step(spec["bn"], v) for v in ("global", "replica_bn")}
    out["cls"] = {v: classification_step(spec["cls"], v)
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
        out[kind] = {v: detection_step(spec[kind], v)
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


