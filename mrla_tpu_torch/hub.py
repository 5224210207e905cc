"""Torch-hub entry point: the port's counterpart of the JAX package's
``hub.py``.

The reference's hub surface is ``deit/hubconf.py:3-8``, which re-exports
every registered constructor so that ``torch.hub.load(repo, name)``
resolves it by attribute, and ``deit/helpers.py:19-27``'s ``named_apply``
(a depth-first module walk).  The registry already holds every
constructor, so here:

- attribute access on this module resolves any registered arch name
  (``from mrla_tpu_torch import hub; model = hub.deit_small_patch16_224()``);
- :func:`load` creates a model and loads its weights in one call, from a
  reference ``.pth`` checkpoint or a run directory of the port's trainers,
  and returns ``(model, state_dict)``, the model in eval mode on the
  device;
- :func:`named_apply` is the reference helper, on an ``nn.Module`` as the
  reference has it and on a nested mapping as the JAX package has it.

The port's modules carry the reference's own key names, so a reference
``state_dict`` needs no converter, only the checks of
:func:`convert_torch_state_dict`.  The JAX package's run directories are
orbax checkpoints; the port reads its own (``ckpt/io.py``).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from mrla_tpu_torch._device import resolve_device
from mrla_tpu_torch.models import registry

# The reference lists its hub deps (hubconf.py:8); ours for symmetry.
dependencies = ["torch"]

# the arch families whose reference checkpoints load here
_TOKEN_FAMILIES = ("deit", "vit")
_CONV_FAMILIES = ("resnet", "resnext", "efficientnet")


def __getattr__(name: str):
    """PEP 562: resolve any registered arch name as a module attribute."""
    try:
        return registry.get_model_ctor(name)
    except KeyError:
        raise AttributeError(
            f"module 'mrla_tpu_torch.hub' has no attribute '{name}' "
            f"(not a registered arch; see mrla_tpu_torch.hub.list_models())"
        ) from None


def __dir__():
    return sorted(set(globals()) | set(registry.list_models()))


def list_models() -> list:
    return registry.list_models()


def convert_torch_state_dict(arch: str, state_dict: Mapping[str, Any],
                             model: Optional[nn.Module] = None
                             ) -> Dict[str, torch.Tensor]:
    """A reference ``state_dict`` for ``arch`` -> the port's.

    The families the JAX package converts load here: the token layout
    (``deit*`` / ``vit*``, ``deit_mrlab_*`` included) and the
    convolutional nets (``resnet*``, ``resnext*``, ``efficientnet*``).  A
    ``module.`` prefix is stripped and the keys must be exactly those of
    ``model`` (built from ``arch`` on the CPU when not given); other
    families raise ValueError, as in the JAX package."""
    if not arch.startswith(_TOKEN_FAMILIES + _CONV_FAMILIES):
        raise ValueError(
            f"no torch-checkpoint converter for arch family '{arch}'; "
            "load the weights manually (see docs/RUNBOOK.md)"
        )
    sd = {k.removeprefix("module."): v for k, v in state_dict.items()}
    if model is None:
        model = registry.create_model(arch, device="cpu")
    want = set(model.state_dict())
    if set(sd) != want:
        raise ValueError(
            f"the checkpoint does not match {arch}: "
            f"missing={sorted(want - set(sd))[:3]} "
            f"extra={sorted(set(sd) - want)[:3]}")
    return sd


def _read_checkpoint(name: str, checkpoint: str,
                     model: nn.Module) -> Dict[str, torch.Tensor]:
    if os.path.isdir(checkpoint):
        from mrla_tpu_torch.ckpt.io import read_model_state_dict

        for entry in ("best", "checkpoint"):
            sd = read_model_state_dict(checkpoint, entry)
            if sd is not None:
                return sd
        raise FileNotFoundError(
            f"no 'best' or 'checkpoint' entry under {checkpoint}")
    sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
    if isinstance(sd, dict):
        sd = sd.get("state_dict", sd.get("model", sd))
    return convert_torch_state_dict(name, sd, model)


def load(
    name: str,
    checkpoint: Optional[str] = None,
    *,
    image_size: int = 224,
    seed: int = 0,
    device="cuda",
    **kwargs,
) -> Tuple[nn.Module, Dict[str, torch.Tensor]]:
    """Create a registered model with its weights in one call.

    The hub analog of ``torch.hub.load(..., name, pretrained=True)``:
    without ``checkpoint`` the weights are the constructor's, drawn from
    ``seed``; a ``.pth`` file is read with ``weights_only=True`` and checked
    by :func:`convert_torch_state_dict`; a directory is a run directory of
    the port's trainers (its ``best.pt``, else ``checkpoint.pt``).
    ``image_size`` is the JAX signature's (a Flax init needs an input
    shape; a PyTorch module builds its weights without one).

    Returns ``(model, state_dict)``: the model in eval mode on ``device``,
    holding those weights; run it with ``model(x)`` on NHWC images."""
    del image_size
    dev = resolve_device(device)
    model = registry.create_model(
        name, device="cpu", generator=torch.Generator().manual_seed(seed),
        **kwargs)
    if checkpoint is not None:
        model.load_state_dict(_read_checkpoint(name, checkpoint, model))
    model = model.to(dev).eval()
    return model, model.state_dict()


def named_apply(
    fn: Callable,
    module_or_tree: Any,
    name: str = "",
    depth_first: bool = True,
    include_root: bool = False,
) -> Any:
    """The reference's module walk (helpers.py:19-27).

    On an ``nn.Module`` it calls ``fn(module=..., name=...)`` on every
    submodule with its dotted name; on a nested mapping (the JAX package's
    variables tree) ``fn(subtree=..., name=...)`` on every mapping node.
    Children come before their parent with ``depth_first`` (the root last
    when ``include_root``), after it otherwise.  ``fn`` mutates in place;
    the argument is returned for chaining."""
    is_module = isinstance(module_or_tree, nn.Module)
    call = ((lambda node, path: fn(module=node, name=path)) if is_module
            else (lambda node, path: fn(subtree=node, name=path)))
    if not depth_first and include_root:
        call(module_or_tree, name)
    children = (module_or_tree.named_children() if is_module
                else ((k, v) for k, v in module_or_tree.items()
                      if isinstance(v, Mapping)))
    for child_name, child in children:
        path = f"{name}.{child_name}" if name else child_name
        named_apply(fn, child, name=path, depth_first=depth_first,
                    include_root=True)
    if depth_first and include_root:
        call(module_or_tree, name)
    return module_or_tree
