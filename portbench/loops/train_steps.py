"""Training steps through the port's trainer: the model, optimizer,
schedule, loss and Mixup / CutMix that ``train/cli.py`` builds from a
recipe's flags, stepped by ``train/steps.py:train_step`` on batches drawn
on the device from the seed (a stream of their own, ahead of the step).

Set-up builds one training state on the benchmark's weights and drives
it through its first ``checked_steps`` steps with the window's own call
and feed, on batches that all differ; those steps are what the reference
follows (the parameters, the BN running statistics and the EMA).  The
same state warms up for ``WARM_S`` more in the window's loop, then runs
the window.

Traffic file keys:
    kind           "train_steps"
    batch          images a step (on one card)
    train_images   the epoch's images (ImageNet-1k's train set), which
                   with the batch sets the schedule's steps an epoch
    start_epoch    the schedule's epoch at the first step (its end of
                   warm-up: the peak learning rate)
    checked_steps  the first steps the reference follows
    recipe         the trainer's flags, by name (``--label-smooth`` is
                   ``label_smooth``; true for a switch)

End to end:
    train_img_per_s  images of the steps completed in the window over the
                     window, which ends on a synchronize after the last
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from portbench.core import checks
from portbench.reference import init
from portbench.reference import train as reference_train
from portbench.reference.common import FP32, Precision

E2E = ("train_img_per_s",)
WARM_S = 1.0
STEPS = ("mrla_tpu_torch.train.steps", "train_step")


def trainer_flags(cfg: dict, tr: dict, device) -> list:
    """The trainer's command line for this cell."""
    flags = ["-a", cfg["arch"], "-b", str(tr["batch"]), "--image-size",
             str(cfg["image_size"]), "--num-classes", str(cfg["num_classes"]),
             "--device", str(device)]
    if "layers" in cfg:
        flags += ["--layers", *map(str, cfg["layers"])]
    for key, value in tr["recipe"].items():
        flag = "--" + key.replace("_", "-")
        if value is True:
            flags.append(flag)
        elif value is not False:
            flags += [flag, str(value)]
    return flags


class ProgramTrainer:
    """The port's training state on the benchmark's weights."""

    def __init__(self, run, sd: dict):
        cfg, tr, device, seed = run.cfg, run.traffic, run.device, run.seed
        cli = importlib.import_module("mrla_tpu_torch.train.cli")
        state_mod = importlib.import_module("mrla_tpu_torch.train.state")
        layers = importlib.import_module("mrla_tpu_torch.nn.layers")
        losses = importlib.import_module("mrla_tpu_torch.train.losses")
        self.transforms = importlib.import_module(
            "mrla_tpu_torch.data.transforms")
        self.steps = importlib.import_module(STEPS[0])
        args = cli.build_parser().parse_args(trainer_flags(cfg, tr, device))
        self.args, self.seed = args, seed
        model = cli.build_model(args, device)
        model.load_state_dict(sd)
        spe = tr["train_images"] // tr["batch"]
        optimizer, schedule = cli.build_optimizer(args, model, spe)
        self.state = state_mod.create_train_state(
            model, optimizer, schedule, ema_decay=args.ema_decay)
        self.state.step = tr["start_epoch"] * spe
        self.drop_gen = init.seeded(seed, 3, device=device)
        layers.set_generator(model, self.drop_gen)
        self.soft = args.mixup > 0 or args.cutmix > 0
        if self.soft:
            self.loss_fn = losses.soft_target_ce
        elif args.label_smooth > 0:
            self.loss_fn = lambda logits, labels: losses.label_smoothing_ce(
                logits, labels, args.label_smooth)
        else:
            self.loss_fn = losses.cross_entropy
        self.start = {n: t.detach().clone() for n, t in self._kept().items()}

    def step(self, i: int, images, labels) -> dict:
        a = self.args
        if self.soft:
            images, labels = self.transforms.mixup_cutmix(
                mix_rng(self.seed, i), images, labels, a.num_classes,
                mixup_alpha=max(a.mixup, 1e-8),
                cutmix_alpha=max(a.cutmix, 1e-8),
                label_smoothing=a.label_smooth)
        return getattr(self.steps, STEPS[1])(
            self.state, {"image": images, "label": labels}, self.loss_fn,
            grad_clip_norm=a.clip_grad, bf16=a.bf16)

    def _params(self) -> dict:
        return dict(self.state.model.named_parameters())

    def _kept(self) -> dict:
        """The parameters and the BN running statistics, by name."""
        stats = {n: b for n, b in self.state.model.named_buffers()
                 if n.endswith(reference_train.STATS)}
        return {**self._params(), **stats}

    def first_grads(self) -> dict:
        """Each leaf's gradient as the optimizer got it at its first step,
        worked out from its state: SGD's momentum buffer less the decay
        it added, AdamW's first moment over (1 - beta1)."""
        by_id = {id(p): n for n, p in self._params().items()}
        out = {}
        for group in self.state.optimizer.param_groups:
            for p in group["params"]:
                st = self.state.optimizer.state[p]
                n = by_id[id(p)]
                if "momentum_buffer" in st:
                    g = st["momentum_buffer"] - group["weight_decay"] \
                        * self.start[n]
                else:
                    g = st["exp_avg"] / (1.0 - group["betas"][0])
                out[n] = g.detach().cpu()
        return out

    def changes(self) -> dict:
        """Each leaf's change since set-up built the state, each BN
        running statistic's and, with an EMA, each EMA entry's; in host
        memory.  The state as built is not kept after."""
        params = self._params()
        out = {"change": {}, "stat_change": {}}
        for n, t in self._kept().items():
            key = "change" if n in params else "stat_change"
            out[key][n] = (t.detach() - self.start[n]).cpu()
        if self.state.ema is not None:
            ema = self.state.ema.state_dict()
            out["ema_change"] = {n: (ema[n] - t).cpu()
                                 for n, t in self.start.items()}
        self.start = None
        return out


# what set-up builds and the window steps; ``calibrate.py`` puts the
# reference in its place
TRAINER = ProgramTrainer


def mix_rng(seed: int, i: int) -> np.random.Generator:
    """Step i's Mixup / CutMix generator, on the host."""
    return np.random.default_rng([seed, 7, i])


def reference_steps(run, sd: dict, q: Precision = FP32
                    ) -> reference_train.Steps:
    """The reference's training state on the weights ``sd``, with the
    cell's recipe, Mixup / CutMix draws and stochastic-depth masks."""
    tr = run.traffic
    spe = tr["train_images"] // tr["batch"]
    return reference_train.Steps(
        run.system.reference, sd, run.cfg, tr["recipe"] | {"batch": tr["batch"]},
        lambda i: mix_rng(run.seed, i), init.seeded(run.seed, 3,
                                                    device=run.device),
        tr["start_epoch"] * spe, spe, q)


def run(run) -> dict:
    cfg, tr, dev = run.cfg, run.traffic, run.device
    batch, px, classes = tr["batch"], cfg["image_size"], cfg["num_classes"]
    cuda = dev.type == "cuda"
    spans, win = run.spans, run.window
    sd = run.weights()
    run.stamp("weights")

    def draw(i: int):
        gen = init.seeded(run.seed, 4, i, device=dev)
        images = init.images(gen, batch, px, dev)
        labels = torch.randint(0, classes, (batch,), generator=gen,
                               device=dev)
        return images, labels

    def step(i: int):
        with spans("draw"):
            images, labels = run.on_side_stream(lambda: draw(i))
        with spans("step"):
            return trainer.step(i, images, labels)

    checked = tr["checked_steps"]
    trainer = TRAINER(run, sd)
    run.stamp("program")
    losses = []
    for i in range(checked):
        losses.append(float(step(i)["loss"]))
        if i == 0:
            first = trainer.first_grads()
    # kept in host memory until the reference has run
    got = trainer.changes() | {"losses": losses, "first_grad": first}
    del first
    # more warm-up in the window's loop, WARM_S at the least
    start, i = time.perf_counter(), checked
    while time.perf_counter() - start < WARM_S:
        step(i)
        i += 1
    if cuda:
        torch.cuda.synchronize()

    win.begin()
    window_first = i
    while time.perf_counter() - win.t0 < run.seconds:
        step(i)
        i += 1
    with spans("synchronize"):
        if cuda:
            torch.cuda.synchronize()
    win.end()
    done = i - window_first
    win.units, win.images = done, done * batch
    run.read_memory_peak()
    del trainer
    run.free_program()

    ref = reference_steps(run, sd)
    for i in range(checked):
        ref.step(*draw(i))
    ref = ref.result()
    values, where = checks.train_checks(got, ref, run.system.reference.HEAD)
    run.note(where | {"losses": got["losses"],
                      "ref_losses": list(ref["losses"])})
    return {"e2e": {"train_img_per_s": done * batch / win.seconds},
            "values": values, "attempted": done, "failed": 0}
