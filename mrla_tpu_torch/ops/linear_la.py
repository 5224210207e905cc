"""Linear layer attention with a running state of fixed size over the
layer axis (Katharopoulos-style), NHWC at the API.

Three granularities of one recurrence:

    s <- s + φ(K)ᵀ V        (the running key-value summary)
    z <- z + φ(K)           (the running normaliser)
    out = (φ(Q) s) / (φ(Q) · (z + eps))

with φ(x) = elu(x) + 1 by default.  Q and K are the k-tap channel convs of
the fp32 GAP descriptor, V the depthwise 3x3 of the map (the MRLA
projections); the state is fp32, the output in the input's dtype.

``linear_la_step`` keeps the full-rank state s [B, C, C·H·W]; with
``svd=True`` it carries s between layers factorised as (u, σ, vh), which
``svd_rank`` may truncate.  An SVD is unique only up to the signs of
paired singular vectors and their order among equal singular values:
compare reconstructions, not factors.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from mrla_tpu_torch.ops.common import (
    channel_conv1d,
    depthwise_conv3x3,
    global_avg_pool,
)
from mrla_tpu_torch.ops.mrla import MRLAParams


def elu_feature_map(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x) + 1.0


def _qkv(x: torch.Tensor, params: MRLAParams, phi: Callable):
    """φ(q), φ(k) [B, C] fp32 and v [B, H, W, C] in the input's dtype."""
    y = global_avg_pool(x)
    q = phi(channel_conv1d(y, params.wq.float()))
    k = phi(channel_conv1d(y, params.wk.float()))
    return q, k, depthwise_conv3x3(x, params.wv)


def svd_compress(s: torch.Tensor, rank: Optional[int] = None):
    """The state s [B, C, D] -> its reduced SVD (u, σ, vh), truncated to
    the top ``rank`` singular triples when given."""
    u, sig, vh = torch.linalg.svd(s, full_matrices=False)
    if rank is not None:
        u, sig, vh = u[..., :rank], sig[..., :rank], vh[..., :rank, :]
    return u, sig, vh


def svd_reconstruct(fac) -> torch.Tensor:
    """(u, σ, vh) -> u·diag(σ)·vh."""
    u, sig, vh = fac
    return (u * sig[..., None, :]) @ vh


def linear_la_step(x: torch.Tensor, s, z: Optional[torch.Tensor],
                   params: MRLAParams, phi: Callable = elu_feature_map,
                   eps: float = 1e-6, svd: bool = False,
                   svd_rank: Optional[int] = None):
    """Full-rank step: s [B, C, C·H·W] (or its factors with ``svd``),
    z [B, C]; None starts the recurrence.  Returns (out [B, H, W, C], s,
    z)."""
    b, h, w, c = x.shape
    q, k, v = _qkv(x, params, phi)
    kv = k[:, :, None] * v.float().reshape(b, 1, c * h * w)
    if svd and s is not None:
        s = svd_reconstruct(s)
    s = kv if s is None else s + kv
    z = k if z is None else z + k
    qz = 1.0 / (q * (z + eps)).sum(-1)  # [B]
    out = torch.einsum("bc,bcd->bd", q, s) * qz[:, None]
    if svd:
        s = svd_compress(s, svd_rank)
    return out.reshape(b, h, w, c).to(x.dtype), s, z


def linear_cla_step(x: torch.Tensor, s: Optional[torch.Tensor],
                    z: Optional[torch.Tensor], params: MRLAParams,
                    phi: Callable = elu_feature_map, eps: float = 1e-6):
    """Channel-wise step (a head a channel): s [B, C, H·W], z [B, C]."""
    b, h, w, c = x.shape
    q, k, v = _qkv(x, params, phi)
    kv = k[:, :, None] * v.float().reshape(b, h * w, c).transpose(1, 2)
    s = kv if s is None else s + kv
    z = k if z is None else z + k
    qz = 1.0 / (q * (z + eps))
    out = q[:, :, None] * s * qz[:, :, None]  # [B, C, HW]
    return out.transpose(1, 2).reshape(b, h, w, c).to(x.dtype), s, z


def linear_gla_step(x: torch.Tensor, s: Optional[torch.Tensor],
                    z: Optional[torch.Tensor], params: MRLAParams,
                    groups: int, phi: Callable = elu_feature_map,
                    eps: float = 1e-6):
    """Group-wise step: s [B, g, d, d, H·W] with d = C / g, z [B, g, d]."""
    b, h, w, c = x.shape
    d = c // groups
    q, k, v = _qkv(x, params, phi)
    qg, kg = q.reshape(b, groups, d), k.reshape(b, groups, d)
    vf = v.float().reshape(b, h * w, groups, d)
    kv = torch.einsum("bgc,bpgs->bgcsp", kg, vf)
    s = kv if s is None else s + kv
    zg = kg if z is None else z + kg
    qz = 1.0 / (qg * (zg + eps)).sum(-1)  # [B, g]
    out = torch.einsum("bgc,bgcsp->bpgs", qg, s) * qz[:, None, :, None]
    return out.reshape(b, h, w, c).to(x.dtype), s, zg
