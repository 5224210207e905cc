"""Functional MRLA attention variants (NHWC, PyTorch).

  * MRLA-light (paper eq. 8): a per-head sigmoid gate on the
    single-position Q·K product of the GAP descriptor scales a
    depthwise-3x3 value map.
  * MRLA-base (paper eq. 6): each layer appends its key (the GAP
    descriptor's channel conv, [B, C] fp32) and its value map (the
    depthwise 3x3, [B, H, W, C] in the activation's dtype) to its stage's
    cache, and attends over the layer axis t with a softmax.
  * LA (paper eq. 4): the non-recurrent ablation, recomputing every key and
    value from the stacked context of the stage's layers.

The heads own contiguous blocks of d = C / heads channels, so a [B, heads]
weight is broadcast to [B, C] by repeating each head's value d times.

The weighted sum over t reads each cached value map once: one fused
multiply-add a layer into an fp32 accumulator, with the weights rounded to
the value maps' dtype first (the JAX package's einsum casts them the same
way), and the result rounded to that dtype once.  A permuting einsum would
copy the whole cache in every block.

The cache grows without copies: ``cache_buffers`` allocates a stage's
[B, T, C] and [B, T, H, W, C] buffers once, an ``MRLACache`` holds views of
their first t slots, and ``mrla_base_attention`` writes the next layer into
slot t in place while the buffers have room (it concatenates only a cache
that is not such a view).  Continue a cache once: a second continuation
from the same views would write the same slot.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Union

import torch

from mrla_tpu_torch.ops.common import (
    channel_conv1d,
    depthwise_conv3x3,
    global_avg_pool,
    rowwise,
)


class MRLAParams(NamedTuple):
    """Weights of one MRLA attention layer.

    wq, wk: the k channel-axis taps (any shape with k elements).
    wv:     [C, 1, 3, 3] depthwise value kernel.
    """

    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor


def _qkv(x: torch.Tensor, params: MRLAParams, heads: int):
    """(q [B, g, d] fp32, k [B, C] fp32, v [B, H, W, C]) of one layer."""
    b, c = x.shape[0], x.shape[-1]
    y = global_avg_pool(x)
    q = channel_conv1d(y, params.wq.float()).reshape(b, heads, c // heads)
    k = channel_conv1d(y, params.wk.float())
    return q, k, depthwise_conv3x3(x, params.wv)


def mrla_light_attention(x: torch.Tensor, params: MRLAParams, heads: int,
                         act_v: Optional[Callable] = None) -> torch.Tensor:
    """[B, H, W, C] block output -> [B, H, W, C] gated value map (the caller
    adds λ ⊙ o_{t-1}).  ``act_v``, if given, is applied to V before the gate
    (the DeiT variant passes the exact-erf GELU)."""
    d = x.shape[-1] // heads
    q, k, v = _qkv(x, params, heads)
    k = k.reshape(q.shape)
    attn = rowwise(torch.sigmoid,
                   (q * k).sum(-1) * (1.0 / math.sqrt(d)))  # [B, g]
    if act_v is not None:
        v = act_v(v)
    gate = attn.repeat_interleave(d, dim=-1).to(v.dtype)  # [B, C]
    return v * gate[:, None, None, :]


class MRLACache(NamedTuple):
    """A stage's MRLA-base cache of t layers.

    k: [B, t, C] fp32 keys; v: [B, t, H, W, C] value maps in the activation
    dtype (the memory hot spot: stage 1 of resnet50 at 224 px holds three
    [56, 56, 256] maps an image)."""

    k: torch.Tensor
    v: torch.Tensor


def cache_buffers(b: int, t_max: int, h: int, w: int, c: int,
                  dtype: torch.dtype, device) -> tuple:
    """A stage's key and value buffers for ``t_max`` layers, uninitialised:
    [B, T, C] fp32 and [B, T, H, W, C] in ``dtype``.  No slot is read
    before it is written."""
    return (torch.empty(b, t_max, c, dtype=torch.float32, device=device),
            torch.empty(b, t_max, h, w, c, dtype=dtype, device=device))


def _append(cached: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``cached`` [B, t, ...] with ``new`` [B, ...] as slot t: in place when
    ``cached`` is a view of a buffer with a free slot t (its batch stride
    spans more than t slots), else by a concatenation.  In training (a
    graph being built) always by a concatenation: a write into the buffer
    would change the maps the earlier layers' sums saved for the
    backward."""
    b, t = cached.shape[:2]
    s0, s1 = cached.stride()[:2]
    slot = new[0].numel()
    end = cached.storage_offset() + (b - 1) * s0 + (t + 1) * s1
    graph = torch.is_grad_enabled() and (new.requires_grad
                                         or cached.requires_grad)
    if (not graph and s1 == slot and s0 >= (t + 1) * s1
            and cached.dtype == new.dtype
            and end * cached.element_size()
            <= cached.untyped_storage().nbytes()):
        grown = cached.as_strided((b, t + 1, *cached.shape[2:]),
                                  cached.stride(), cached.storage_offset())
        grown[:, t] = new
        return grown
    return torch.cat([cached, new[:, None].to(cached.dtype)], dim=1)


def _weighted_sum(attn: torch.Tensor, v: torch.Tensor,
                  n: int) -> torch.Tensor:
    """sum over t < n of attn[:, :, t] (head-broadcast) · v[:, t] ->
    [B, H, W, C] in v's dtype.  The weights are rounded to v's dtype, the
    products summed in fp32, each cached map read once."""
    b, g = attn.shape[:2]
    c = v.shape[-1]
    wts = attn.to(v.dtype).float().repeat_interleave(c // g, dim=1)
    wts = wts.transpose(1, 2)[:, :, None, None, :]  # [B, T, 1, 1, C]
    out = v[:, 0] * wts[:, 0]
    for s in range(1, n):
        out.addcmul_(v[:, s], wts[:, s])
    return out.to(v.dtype)


def _logits(q: torch.Tensor, k: torch.Tensor, heads: int) -> torch.Tensor:
    """q [B, g, d] · k [B, T, C] over d, scaled -> [B, g, T] fp32."""
    b, t, c = k.shape
    d = c // heads
    kh = k.float().reshape(b, t, heads, d)
    return torch.einsum("bgd,btgd->bgt", q, kh) * (1.0 / math.sqrt(d))


def mrla_base_attention(x: torch.Tensor, params: MRLAParams, heads: int,
                        cache: Optional[MRLACache],
                        max_t: Optional[int] = None
                        ) -> tuple[torch.Tensor, MRLACache]:
    """MRLA-base: softmax over the layer axis t against the stage's growing
    cache, this layer included.  ``cache=None`` starts a stage (the
    reference's init_cell), in buffers for ``max_t`` layers (default 1).

    x: [B, H, W, C] block output.  Returns (out [B, H, W, C], the cache
    with this layer appended)."""
    b, h, w, c = x.shape
    q, k_t, v_t = _qkv(x, params, heads)
    if cache is None:
        k_buf, v_buf = cache_buffers(b, max_t or 1, h, w, c, v_t.dtype,
                                     x.device)
        cache = MRLACache(k_buf[:, :0], v_buf[:, :0])
    cache = MRLACache(_append(cache.k, k_t), _append(cache.v, v_t))
    attn = torch.softmax(_logits(q, cache.k, heads), dim=-1)
    return _weighted_sum(attn, cache.v, cache.k.shape[1]), cache


def mrla_base_attention_fixed(x: torch.Tensor, params: MRLAParams,
                              heads: int, k_buf: torch.Tensor,
                              v_buf: torch.Tensor, t: Union[int, torch.Tensor]
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """MRLA-base against fixed-size buffers (the JAX package's lax.scan
    form): this layer is written to slot ``t`` in place, the logits of the
    slots after t are masked with -inf over the whole [B, T_max] buffer,
    and the sum over t reads the written slots only (the masked ones weigh
    exactly 0, whatever the buffer holds there).

    k_buf: [B, T_max, C]; v_buf: [B, T_max, H, W, C]; t: the number of
    layers cached before this one.  Returns (out, k_buf, v_buf)."""
    t = int(t)
    q, k_t, v_t = _qkv(x, params, heads)
    k_buf[:, t] = k_t
    v_buf[:, t] = v_t
    logits = _logits(q, k_buf, heads)
    keep = torch.arange(k_buf.shape[1], device=x.device) <= t
    attn = torch.softmax(logits.masked_fill(~keep, -math.inf), dim=-1)
    return _weighted_sum(attn, v_buf, t + 1), k_buf, v_buf


def la_eq4_attention(x: torch.Tensor, ctx: torch.Tensor, params: MRLAParams,
                     heads: int) -> torch.Tensor:
    """LA (eq. 4): the query from x [B, H, W, C], keys and values recomputed
    from the stacked context ctx [B, t, H, W, C] of the stage's layers
    (this one included), softmax over t.  Returns [B, H, W, C]."""
    b, t, h, w, c = ctx.shape
    y = global_avg_pool(x)
    q = channel_conv1d(y, params.wq.float()).reshape(b, heads, c // heads)
    flat = ctx.reshape(b * t, h, w, c)
    k = channel_conv1d(global_avg_pool(flat), params.wk.float())
    v = depthwise_conv3x3(flat, params.wv).reshape(b, t, h, w, c)
    attn = torch.softmax(_logits(q, k.reshape(b, t, c), heads), dim=-1)
    return _weighted_sum(attn, v, t)
