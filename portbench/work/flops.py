"""Model FLOPs of one image's forward, from a configuration's sizes.

Two FLOPs a multiply-add, over the convolutions (depthwise and the
channel taps included, every tap of the window counted, padded or not),
the matrix products and attention's two products; no element-wise work.
That is the count ``torch.utils.flop_counter.FlopCounterMode`` makes of
the reference's forward (``tests/test_portbench_work.py`` holds them
equal).  A training step is three forwards' worth (forward, and the
backward's two products a forward product).  Each family's module
``systems/<family>.py`` names its function as ``flops_per_image``.
"""

from __future__ import annotations

from portbench.reference.common import eca_kernel_size


def _conv(out_hw: int, cin: int, cout: int, k: int, groups: int = 1) -> int:
    return out_hw * out_hw * cout * (cin // groups) * k * k


def resnet_mrlal(cfg: dict) -> float:
    """ResNet bottlenecks with MRLA-light: the 7 x 7 stem, each block's
    three convolutions and downsample, its depthwise 3 x 3 value and its
    two channel-tap convolutions of the pooled map, the fc."""
    px, w, e = cfg["image_size"], cfg["stem_width"], cfg["expansion"]
    hw = (px + 1) // 2
    macs = _conv(hw, 3, w, 7)
    hw = (hw + 1) // 2  # max pool
    inplanes, planes = w, w
    for s, n in enumerate(cfg["layers"]):
        for b in range(n):
            stride = 2 if (b == 0 and s > 0) else 1
            out_hw = (hw + stride - 1) // stride
            c = planes * e
            macs += _conv(hw, inplanes, planes, 1)
            macs += _conv(out_hw, planes, planes, 3)
            macs += _conv(out_hw, planes, c, 1)
            if b == 0:
                macs += _conv(out_hw, inplanes, c, 1)
            macs += _conv(out_hw, c, c, 3, groups=c)
            macs += 2 * c * eca_kernel_size(c)
            inplanes, hw = c, out_hw
        planes *= 2
    macs += inplanes * cfg["num_classes"]
    return 2.0 * macs


def deit_mrlal(cfg: dict) -> float:
    """ViT blocks with the MRLA-light token tail: the patch embedding,
    each block's qkv, attention's q k^T and (softmax) v, proj, fc1, fc2,
    the tail's depthwise 3 x 3 and two channel-tap convolutions, the
    head."""
    c, p, px = cfg["embed_dim"], cfg["patch_size"], cfg["image_size"]
    s = px // p
    n = 1 + s * s
    hidden = int(c * cfg["mlp_ratio"])
    macs = _conv(s, 3, c, p)
    per_block = (n * c * 3 * c + 2 * n * n * c + n * c * c
                 + 2 * n * c * hidden + _conv(s, c, c, 3, groups=c)
                 + 2 * c * eca_kernel_size(c))
    macs += cfg["depth"] * per_block + c * cfg["num_classes"]
    return 2.0 * macs

