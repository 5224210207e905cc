"""``dryrun_multichip(n)``: the port's counterpart of the repository's
``__graft_entry__.dryrun_multichip``.

It starts ``n`` ranks on this host (``parallel/spawn.py``) and runs the
JAX function's five steps, one SGD step each, on small shapes:

  (a) full-depth ``resnet50_mrlal`` (drop path 0.1, 64 px) on a
      ``("data", "model")`` mesh, tensor-parallel with ``model`` = 2 when
      n is even and at least 4 (``parallel/sharding.py``), else 1;
  (b) ``ResNetMRLABase`` at layers [2, 2], 32 px, under the same rules;
  (c) DeiT-MRLA light (embed 64, depth 2, drop path 0.1, 64 px), the same;
  (d) RetinaNet at layers (1, 1, 1, 1), 4 classes, 64 px, data-parallel
      with replicated parameters, on the JAX step's seeded ground truths;
  (e) when n % 4 == 0, the pipelined DeiT-MRLA (embed 64, depth 4) on a
      ``("data", "pipe")`` mesh with pipe 4 and 2 microbatches, its blocks
      resident by stage (``parallel/pipeline.py``).

Each step's loss must be finite, and after it the data replicas must hold
bitwise-equal weights.  Rank 0's one line a step is printed, as the JAX
function prints it.  The ranks run on the card unless ``device="cpu"``:
``backend`` defaults to NCCL when there is a card a rank, else gloo (ranks
sharing a card).
"""

from __future__ import annotations

import math
import tempfile
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from mrla_tpu_torch._device import resolve_device


def _rank_device(kind: str) -> torch.device:
    from mrla_tpu_torch.parallel import rank

    if kind != "cuda":
        return torch.device(kind)
    dev = torch.device("cuda", rank() % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _classifier_step(model, mesh, dev, images, labels, lr: float = 0.1,
                     droppath_seed=None) -> Dict:
    """One SGD step (momentum 0.9) of ``model`` on this rank's rows, TP
    over the mesh's ``model`` axis and DDP over its ``data`` axis."""
    from mrla_tpu_torch.nn.layers import set_generator
    from mrla_tpu_torch.parallel import (
        data_parallel,
        global_mean,
        shard_batch,
        shard_train_state,
    )
    from mrla_tpu_torch.parallel.checks import same_across_ranks
    from mrla_tpu_torch.train import create_train_state, train_step
    from mrla_tpu_torch.train.optim import sgd_torch

    if droppath_seed is not None:  # the same masks on a data slice's ranks
        set_generator(model, torch.Generator(device=dev).manual_seed(
            droppath_seed + mesh.index("data")))
    opt = sgd_torch(model.parameters(), lr, 0.9)
    state = create_train_state(model, opt, lambda step: lr)
    shard_train_state(state, mesh)
    with mesh:
        state.ddp = data_parallel(model, dev)
        rows = {k: torch.as_tensor(v).to(dev) for k, v in shard_batch(
            {"image": images, "label": labels}).items()}
        loss = float(global_mean(train_step(state, rows)["loss"]))
    return {"loss": loss, "step": state.step,
            "same": same_across_ranks(model.state_dict().values(),
                                      mesh.axis("data"))}


def _retinanet_step(mesh, dev, batch: int) -> Dict:
    """(d): one SGD step of a small RetinaNet, BN on batch statistics over
    the data group, parameters replicated on the model axis."""
    from mrla_tpu_torch.detect.losses import retinanet_loss
    from mrla_tpu_torch.detect.retinanet import RetinaNet
    from mrla_tpu_torch.parallel import (
        data_parallel,
        data_size,
        global_sum,
        shard_batch,
    )
    from mrla_tpu_torch.parallel.checks import same_across_ranks

    model = RetinaNet(layers=(1, 1, 1, 1), num_classes=4,
                      generator=torch.Generator().manual_seed(6)).to(dev)
    rng = np.random.default_rng(3)
    images = rng.standard_normal((batch, 64, 64, 3)).astype(np.float32)
    xy = rng.uniform(4, 24, (batch, 2, 2))
    wh = rng.uniform(12, 32, (batch, 2, 2))
    gt = {"image": images,
          "gt_boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
          "gt_labels": rng.integers(0, 4, (batch, 2)),
          "gt_valid": rng.random((batch, 2)) < 0.8}
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    with mesh:
        net = data_parallel(model.train(), dev)
        rows = {k: torch.as_tensor(v).to(dev)
                for k, v in shard_batch(gt).items()}
        losses = retinanet_loss(net(rows["image"]), rows["gt_boxes"],
                                rows["gt_labels"], rows["gt_valid"],
                                num_classes=4)
        # the normalisers are the global batch's: DDP's mean of the
        # ranks' scaled losses is the global loss's gradient
        (losses["loss"] * data_size()).backward()
        opt.step()
        loss = float(global_sum(losses["loss"].detach()))
    return {"loss": loss,
            "same": same_across_ranks(model.state_dict().values(),
                                      mesh.axis("data"))}


def _pipeline_step(n: int, dev) -> Dict:
    """(e): one SGD step of the pipelined DeiT-MRLA from the resident
    layout, gradients averaged over the data axis."""
    from mrla_tpu_torch.models.deit_mrla import ViTMRLA
    from mrla_tpu_torch.parallel import (
        average_gradients,
        batch_sharding,
        global_mean,
        make_mesh,
        make_pipelined_vit,
        pipeline_shardings,
        stack_block_params,
    )
    from mrla_tpu_torch.parallel.checks import same_across_ranks

    pipe = 4
    mesh = make_mesh(("data", "pipe"), (n // pipe, pipe))
    model = ViTMRLA(img_size=64, embed_dim=64, depth=4, num_heads=2,
                    dim_mrla=16, variant="light", patch_size=16,
                    num_classes=1000,
                    generator=torch.Generator().manual_seed(7))
    bp = (n // pipe) * 4
    xs = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (bp, 64, 64, 3)).astype(np.float32)).to(dev)
    labels = (torch.arange(bp) % 1000)[batch_sharding(mesh, bp)].to(dev)
    _, fwd_stacked = make_pipelined_vit(model, mesh, num_microbatches=2,
                                        data_axis="data")
    stacked, rest = stack_block_params(
        {k: v.to(dev) for k, v in model.state_dict().items()}, 4)
    leaves = [t.requires_grad_() for t in
              list(pipeline_shardings(mesh, stacked).values())
              + list(rest.values())]
    span = dict(zip(stacked, leaves[:len(stacked)]))
    rest = dict(zip(rest, leaves[len(stacked):]))
    opt = torch.optim.SGD(leaves, lr=0.1, momentum=0.9)
    with mesh:
        loss = F.cross_entropy(fwd_stacked(span, rest, xs), labels)
        loss.backward()
        average_gradients(leaves)
        opt.step()
        loss = float(global_mean(loss.detach()))
    return {"loss": loss, "same": same_across_ranks(leaves,
                                                     mesh.axis("data"))}


def _rank_job(n: int, kind: str) -> Dict:
    """The five steps on this rank; rank 0's lines and every result."""
    from mrla_tpu_torch.models import create_model
    from mrla_tpu_torch.models.resnet_mrla_base import ResNetMRLABase
    from mrla_tpu_torch.models.deit_mrla import ViTMRLA
    from mrla_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = _rank_device(kind)
    tp = 2 if (n % 2 == 0 and n >= 4) else 1
    mesh = make_mesh(("data", "model"), (n // tp, tp))
    batch = (n // tp) * 2
    labels = np.arange(batch) % 1000
    out: Dict[str, Dict] = {}
    seeded = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    rng = lambda s, px: np.random.default_rng(s).standard_normal(  # noqa
        (batch, px, px, 3)).astype(np.float32)

    model = create_model("resnet50_mrlal", device=dev, drop_path=0.1,
                         generator=seeded(0))
    out["ok"] = _classifier_step(model, mesh, dev, rng(0, 64), labels,
                                 droppath_seed=1)
    model = ResNetMRLABase(layers=[2, 2], num_classes=1000,
                           generator=seeded(2)).to(dev)
    out["mrlab ok"] = _classifier_step(model, mesh, dev, rng(1, 32), labels)
    model = ViTMRLA(img_size=64, embed_dim=64, depth=2, num_heads=2,
                    dim_mrla=16, variant="light", patch_size=16,
                    drop_path_rate=0.1, generator=seeded(4)).to(dev)
    out["deit ok"] = _classifier_step(model, mesh, dev, rng(2, 64), labels,
                                      droppath_seed=5)
    out["detect ok"] = _retinanet_step(mesh, dev, batch)
    if n % 4 == 0:
        out["pipeline ok"] = _pipeline_step(n, dev)
    for name, res in out.items():
        if not math.isfinite(res["loss"]):
            raise AssertionError(f"non-finite {name} loss: {res['loss']}")
        if not res["same"]:
            raise AssertionError(f"{name}: the data replicas' weights "
                                 "differ after the step")
    lines = [f"dryrun_multichip({n}): {name}, loss={res['loss']:.4f}"
             for name, res in out.items()]
    return {"lines": lines, "steps": out, "tp": tp}


def dryrun_multichip(n_devices: int, device="cuda", backend=None) -> Dict:
    """Start ``n_devices`` ranks and run the five steps (module docstring);
    prints rank 0's lines and returns its results (``{"lines", "steps",
    "tp"}``).  Raises if a rank fails, a loss is not finite or the data
    replicas differ.  On the CPU each rank takes one thread."""
    from mrla_tpu_torch.parallel.spawn import run_ranks

    dev = resolve_device(device)
    if backend is None:
        backend = ("nccl" if dev.type == "cuda"
                   and torch.cuda.device_count() >= n_devices else "gloo")
    threads = 0 if dev.type == "cuda" else 1
    with tempfile.TemporaryDirectory() as work:
        results: List[Dict] = run_ranks(_rank_job, n_devices, work,
                                        args=(n_devices, dev.type),
                                        backend=backend, threads=threads,
                                        timeout=900.0)
    for line in results[0]["lines"]:
        print(line)
    return results[0]
