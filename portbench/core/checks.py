"""The numbers that decide ``correct``, and the decision.

Serving (logits of the requests the window answered, against the
reference's on the same images):

    logit_err        ||got - ref|| / ||ref - ref's mean over the images||
                     over every compared logit: with random weights most
                     of a logit is shared by every image, so the error is
                     measured against the part that differs from image to
                     image (the program's ``chip_smoke.logit_error``)
    logit_err_worst  the largest of one image's ||got - ref||, over the
                     root mean square of one image's ||ref - mean||: a
                     single answer altered shows here

Training (the first steps, against the reference's steps on the same
batches, each taken by the worst leaf, its gap measured against the
reference's norm of that leaf or of the median leaf, the larger):

    loss_gap         the largest |loss - ref loss| / |ref loss| of a step
    grad_gap         the first gradient's norm, as the optimizer got it
    update_gap       the change of the parameters over the steps, over
                     the elements whose reference gradient is not nought
                     to rounding: at least a thousandth of the median
                     leaf's root mean square gradient (a key's bias under
                     softmax, which AdamW moves by round-off alone, is
                     left out by this rule on the reference's gradient)
    grad_gap_median, update_gap_median
                     the same gaps of the median leaf: steady from seed to
                     seed where the worst leaf is rounding amplified (a
                     gradient that comes back through many batch-
                     normalised layers)
    head_grad_err    ||got - ref|| / ||ref|| of the output layer's weight
                     gradient, the one gradient that no backward pass
                     through the network amplifies: it reads the
                     forward's precision
    stat_gap, stat_gap_median
                     the change of each BN running statistic over the
                     steps (a family with BatchNorm)
    ema_gap, ema_gap_median
                     the change of each EMA entry over the steps, over
                     the elements ``update_gap`` keeps (a recipe with an
                     EMA)
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

GRAD_FLOOR = 1e-3  # of the median leaf's gradient norm


def logit_checks(got: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    got, ref = got.double(), ref.double()
    spread = ref - ref.mean(0)
    err = got - ref
    per_image = err.norm(dim=1)
    typical = spread.norm(dim=1).pow(2).mean().sqrt()
    return {"logit_err": float(err.norm() / spread.norm()),
            "logit_err_worst": float(per_image.max() / typical)}


def _gaps(got: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's |got - ref| over the larger of ref and the median
    leaf's ref (inf where got is not finite)."""
    med = float(np.median(list(ref.values())))
    out = {}
    for n in ref:
        gap = abs(got[n] - ref[n]) / max(ref[n], med, 1e-300)
        out[n] = gap if math.isfinite(gap) else math.inf
    return out


def _worst(gaps: Dict[str, float], got, ref, k: int = 4) -> list:
    return [[n, gaps[n], got[n], ref[n]] for n in
            sorted(gaps, key=lambda n: -gaps[n])[:k]]


def train_checks(got: dict, ref: dict, head: str
                 ) -> Tuple[Dict[str, float], dict]:
    """``got`` and ``ref``: {"losses": [steps], "first_grad": {leaf:
    tensor}, "change": {leaf: tensor}, and where the state has them
    "stat_change" and "ema_change": {entry: tensor}}.  Returns the numbers
    and, for the record, the entry each was worst at and the share of each
    leaf's elements left out of the changes, where over 1%."""
    if set(got["first_grad"]) != set(ref["first_grad"]):
        raise ValueError("the program's leaves are not the reference's: "
                         f"{sorted(set(got['first_grad']) ^ set(ref['first_grad']))[:4]}")
    g_ref = ref["first_grad"]
    dev = next(iter(g_ref.values())).device
    norm = lambda t: float(t.double().norm())
    gr = {n: norm(g) for n, g in g_ref.items()}
    gp = {n: norm(g.to(dev)) for n, g in got["first_grad"].items()}
    head_err = norm(got["first_grad"][head].to(dev) - g_ref[head])
    floor = GRAD_FLOOR * float(np.median(
        [gr[n] / math.sqrt(g.numel()) for n, g in g_ref.items()]))
    keep, left_out = {}, {}
    for n, g in g_ref.items():
        keep[n] = g.abs() >= floor
        share = 1.0 - float(keep[n].float().mean())
        if share > 0.01:
            left_out[n] = share

    def changes(key: str) -> Tuple[Dict[str, float], Dict[str, float]]:
        """(program's, reference's) norm of each entry's change, over the
        elements kept, leaving out a leaf with none kept."""
        cp, cr = {}, {}
        for n, t in ref[key].items():
            k = keep.get(n)
            if k is not None and not bool(k.any()):
                continue
            cr[n] = norm(t if k is None else t[k])
            c = got[key][n].to(dev)
            cp[n] = norm(c if k is None else c[k])
        return cp, cr

    lp = np.asarray(got["losses"], float)
    lr = np.asarray(ref["losses"], float)
    loss_gap = float(np.max(np.abs(lp - lr) / np.abs(lr)))
    if not np.all(np.isfinite(lp)):
        loss_gap = math.inf
    g_gaps = _gaps(gp, gr)
    values = {"loss_gap": loss_gap,
              "grad_gap": max(g_gaps.values()),
              "grad_gap_median": float(np.median(list(g_gaps.values()))),
              "head_grad_err": head_err / max(gr[head], 1e-300)}
    where = {"grad_gap_worst": _worst(g_gaps, gp, gr),
             "left_out_of_update": left_out}
    for name, key in (("update", "change"), ("stat", "stat_change"),
                      ("ema", "ema_change")):
        if not ref.get(key):
            continue
        c_got, c_ref = changes(key)
        gaps = _gaps(c_got, c_ref)
        values[f"{name}_gap"] = max(gaps.values())
        values[f"{name}_gap_median"] = float(np.median(list(gaps.values())))
        where[f"{name}_gap_worst"] = _worst(gaps, c_got, c_ref)
    return values, where


def decide(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[
        bool, Dict[str, dict]]:
    """(correct, {number: {"value", "limit"}}) over the numbers that have
    a limit: correct when each is finite and at most its limit, and at
    least one number was compared."""
    checked = {n: {"value": values[n], "limit": limits[n]}
               for n in limits if n in values}
    missing = [n for n in limits if n not in values]
    ok = bool(checked) and not missing and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checked.values())
    for n in missing:
        checked[n] = {"value": None, "limit": limits[n]}
    return ok, checked
