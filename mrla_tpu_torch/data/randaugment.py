"""RandAugment (timm's ``rand-m9-mstd0.5``) on the device, the port's own
copy of the JAX package's ``data/randaugment.py``.

Each image takes ``num_layers`` ops from a pool of 16, each at a level
drawn from N(magnitude, mag_std) clipped to [0, 10] and with a random
sign.  Images are float [H, W, 3] in 0..255.  The geometric ops warp by an
affine map (output pixel -> input point), sample bilinearly and fill
outside the image with grey 128; the colour ops are elementwise, as the
JAX ops compute them (equalize is PIL's ``ImageOps.equalize``).

Every op takes a batch [N, H, W, 3] with a level and a sign an image ([N]
float32 tensors), so that ``rand_augment`` runs each op once a layer on
the images that drew it.  The JAX function draws from ``jax.random``; the
port draws each image's op, level and sign from the caller's
``torch.Generator`` instead (the two streams cannot agree), and the ops are
held to the JAX ops one by one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MAX_LEVEL = 10.0


def _col(v: torch.Tensor) -> torch.Tensor:
    """[N] -> [N, 1, 1, 1], to broadcast over [N, H, W, 3]."""
    return v[:, None, None, None]


def _factor(level: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    return 1.0 + sign * level / MAX_LEVEL * 0.9


def affine_sample(img: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Inverse-warp img [N, H, W, 3] by mat [N, 2, 3] (output -> input
    coordinates, x first), bilinear, grey 128 outside."""
    n, h, w, _ = img.shape
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=img.device),
        torch.arange(w, dtype=torch.float32, device=img.device),
        indexing="ij")
    m = mat[:, :, :, None, None]  # [N, 2, 3, 1, 1]
    sx = m[:, 0, 0] * xx + m[:, 0, 1] * yy + m[:, 0, 2]
    sy = m[:, 1, 0] * xx + m[:, 1, 1] * yy + m[:, 1, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    batch = torch.arange(n, device=img.device)[:, None, None]

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yi = yi.clamp(0, h - 1).long()
        xi = xi.clamp(0, w - 1).long()
        return torch.where(valid[..., None], img[batch, yi, xi],
                           torch.full((), 128.0, device=img.device))

    top = gather(y0, x0) * (1 - wx) + gather(y0, x0 + 1) * wx
    bot = gather(y0 + 1, x0) * (1 - wx) + gather(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def _blend(a, b, factor):
    return a + (b - a) * factor


def _grayscale(img):
    g = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    return torch.stack([g, g, g], -1)


def _affine(level, sign, row0, row1) -> torch.Tensor:
    """[N, 2, 3] from two rows of three [N] (or scalar) entries."""
    full = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                     device=level.device).expand_as(level)
    return torch.stack([torch.stack([full(v) for v in row0], -1),
                        torch.stack([full(v) for v in row1], -1)], 1)


# --- ops: (img [N, H, W, 3] float 0..255, level [N], sign [N]) -> img ---

def identity(img, level, sign):
    return img


def auto_contrast(img, level, sign):
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    scale = 255.0 / torch.clamp(hi - lo, min=1e-5)
    return torch.where(hi > lo, (img - lo) * scale, img)


def equalize(img, level, sign):
    """Per-channel histogram equalisation (PIL ImageOps.equalize)."""
    n, h, w, _ = img.shape
    ci = img.clamp(0, 255).to(torch.int64)  # truncates, as astype(int32)
    planes = ci.permute(0, 3, 1, 2).reshape(n * 3, h * w)
    offset = torch.arange(n * 3, device=img.device)[:, None] * 256
    hist = torch.bincount((planes + offset).reshape(-1),
                          minlength=n * 3 * 256).reshape(n * 3, 256)
    step = (hist.sum(-1, keepdim=True) - hist[:, 255:]) // 255
    cum_excl = hist.cumsum(-1) - hist
    lut = ((step // 2 + cum_excl) // step.clamp(min=1)).clamp(0, 255)
    out = lut.gather(1, planes).to(torch.float32)
    out = out.reshape(n, 3, h, w).permute(0, 2, 3, 1)
    keep = (step > 0).reshape(n, 3)[:, None, None, :]
    return torch.where(keep, out, img)


def invert(img, level, sign):
    return 255.0 - img


def rotate(img, level, sign):
    rad = sign * level / MAX_LEVEL * 30.0 * math.pi / 180.0
    _, h, w, _ = img.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    c, s = torch.cos(rad), torch.sin(rad)
    return affine_sample(img, _affine(
        level, sign, (c, -s, cx - c * cx + s * cy),
        (s, c, cy - s * cx - c * cy)))


def posterize(img, level, sign):
    bits = 4 - (level / MAX_LEVEL * 4).to(torch.int32)
    # shift by at most 7 and zero the bits == 0 case (PIL's posterize to 0
    # bits is an all-zero image)
    shift = _col((8 - bits).clamp(0, 7).to(torch.uint8))
    vals = img.to(torch.uint8)
    out = torch.bitwise_left_shift(torch.bitwise_right_shift(vals, shift),
                                   shift)
    out = torch.where(_col(bits <= 0), torch.zeros_like(out), out)
    return out.to(torch.float32)


def solarize(img, level, sign):
    thresh = _col(256.0 - level / MAX_LEVEL * 256.0)
    return torch.where(img >= thresh, 255.0 - img, img)


def solarize_add(img, level, sign):
    add = _col(level / MAX_LEVEL * 110.0)
    return torch.where(img < 128.0, (img + add).clamp(0, 255), img)


def color(img, level, sign):
    return _blend(_grayscale(img), img,
                  _col(_factor(level, sign))).clamp(0, 255)


def contrast(img, level, sign):
    mean = _grayscale(img).mean(dim=(1, 2, 3), keepdim=True)
    return _blend(mean.expand_as(img), img,
                  _col(_factor(level, sign))).clamp(0, 255)


def brightness(img, level, sign):
    return (img * _col(_factor(level, sign))).clamp(0, 255)


def sharpness(img, level, sign):
    kernel = torch.tensor([[1, 1, 1], [1, 5, 1], [1, 1, 1]],
                          dtype=torch.float32, device=img.device) / 13.0
    blurred = F.conv2d(img.permute(0, 3, 1, 2),
                       kernel.expand(3, 1, 3, 3), padding=1,
                       groups=3).permute(0, 2, 3, 1)
    return _blend(blurred, img, _col(_factor(level, sign))).clamp(0, 255)


def shear_x(img, level, sign):
    v = sign * level / MAX_LEVEL * 0.3
    return affine_sample(img, _affine(level, sign, (1.0, v, 0.0),
                                      (0.0, 1.0, 0.0)))


def shear_y(img, level, sign):
    v = sign * level / MAX_LEVEL * 0.3
    return affine_sample(img, _affine(level, sign, (1.0, 0.0, 0.0),
                                      (v, 1.0, 0.0)))


def translate_x(img, level, sign):
    v = sign * level / MAX_LEVEL * 0.45 * img.shape[2]
    return affine_sample(img, _affine(level, sign, (1.0, 0.0, v),
                                      (0.0, 1.0, 0.0)))


def translate_y(img, level, sign):
    v = sign * level / MAX_LEVEL * 0.45 * img.shape[1]
    return affine_sample(img, _affine(level, sign, (1.0, 0.0, 0.0),
                                      (0.0, 1.0, v)))


OPS = [identity, auto_contrast, equalize, invert, rotate, posterize,
       solarize, solarize_add, color, contrast, brightness, sharpness,
       shear_x, shear_y, translate_x, translate_y]


@torch.no_grad()
def rand_augment(generator: torch.Generator, images: torch.Tensor,
                 magnitude: float = 9.0, mag_std: float = 0.5,
                 num_layers: int = 2) -> torch.Tensor:
    """RandAugment of a uint8 / float [B, H, W, 3] batch (0..255) on its
    own device; float32 out.  ``generator`` lives on that device."""
    img = images.to(torch.float32)
    b, dev = img.shape[0], img.device
    draw = dict(generator=generator, device=dev)
    op = torch.randint(0, len(OPS), (num_layers, b), **draw)
    level = (magnitude + mag_std * torch.randn(num_layers, b, **draw)).clamp(
        0.0, MAX_LEVEL)
    sign = torch.where(torch.rand(num_layers, b, **draw) < 0.5, 1.0, -1.0)
    for layer in range(num_layers):
        out = img.clone()
        for k in op[layer].unique().tolist():
            rows = (op[layer] == k).nonzero().squeeze(1)
            out[rows] = OPS[k](img[rows], level[layer, rows],
                               sign[layer, rows])
        img = out
    return img
