"""The port's RoIAlign backward (the plain version and the autograd
``Function`` on CPU tensors) against ``jax.grad`` through the JAX package's
Pallas ``roi_align_patch`` in interpret mode (its custom VJP, the TPU
backward kernel).

Sizes of the JAX package's own VJP test (``tests/test_roialign_patch.py``,
``test_grad_matches_xla_gather``): a 4-level pyramid 64x88 / 32x44 / 16x22 /
8x11 at C = 128 (a 256 x 352 canvas), 24 realistic, overlapping rois per
image, invalid rows, sampling ratios 2 and 0.  Tolerance: 2e-4 of the
largest |gradient| of a level, that test's own (fp32 sums in another
order).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrla_tpu.kernels.roialign_patch import roi_align_patch as j_patch
from mrla_tpu_torch.detect.roi_align import (
    GEOM_VALID,
    roi_align_backward_reference,
    roi_align_reference,
    roi_geometry,
)
from mrla_tpu_torch.kernels import roi_align_patch

SIZES = [(64, 88), (32, 44), (16, 22), (8, 11)]
STRIDES = (4, 8, 16, 32)
REL = 2e-4


def _case(seed, b=2, p=24, c=128, out=7):
    """Features, realistic rois (clamped to the canvas), valid and a
    cotangent, as the JAX VJP test draws them."""
    rng = np.random.default_rng(seed)
    feats = [rng.standard_normal((b, h, w, c)).astype(np.float32)
             for h, w in SIZES]
    ch, cw = 256, 352
    scale = np.exp(rng.uniform(np.log(8.0), np.log(700.0), (b, p)))
    ar = np.exp(rng.uniform(np.log(1 / 3), np.log(3.0), (b, p)))
    w, h = scale * np.sqrt(ar), scale / np.sqrt(ar)
    cx, cy = rng.uniform(0, cw, (b, p)), rng.uniform(0, ch, (b, p))
    r = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    r[..., 0::2] = np.clip(r[..., 0::2], 0, cw)
    r[..., 1::2] = np.clip(r[..., 1::2], 0, ch)
    valid = rng.random((b, p)) > 0.2
    ct = rng.standard_normal((b, p, out, out, c)).astype(np.float32)
    return feats, r.astype(np.float32), valid, ct


def _jax_grads(feats, rois, valid, ct, sr, out=7):
    def loss(fs, r, v):
        return jnp.sum(j_patch(fs, r, v, STRIDES, out, sr,
                               interpret=True) * jnp.asarray(ct))

    return jax.grad(loss, argnums=(0, 1, 2))(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois),
        jnp.asarray(valid, jnp.float32))


def _assert_levels_close(got, want):
    hit = 0
    for level, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (level, g.shape, w.shape)
        scale = np.abs(w).max()
        if scale > 0:
            hit += 1
            assert np.abs(g - w).max() <= REL * scale, level
        else:
            assert np.abs(g).max() == 0.0, level
    assert hit >= 3, "the rois should reach at least three levels"


@pytest.mark.parametrize("sr", [2, 0])
def test_plain_backward_matches_jax_vjp(sr):
    feats, rois, valid, ct = _case(7 + sr)
    want, d_rois, d_valid = _jax_grads(feats, rois, valid, ct, sr)
    geom, smax = roi_geometry(torch.from_numpy(rois),
                              torch.from_numpy(valid), SIZES, STRIDES, 7, sr)
    got = roi_align_backward_reference(torch.from_numpy(ct), geom, SIZES, 7,
                                       smax)
    _assert_levels_close([g.numpy() for g in got], want)
    # the JAX VJP sends nothing to the rois or to valid
    assert np.abs(np.asarray(d_rois)).max() == 0.0
    assert np.abs(np.asarray(d_valid)).max() == 0.0


@pytest.mark.parametrize("sr", [2, 0])
def test_function_backward_matches_jax_vjp(sr):
    """The wrapper's autograd on CPU tensors: gradients to every level as
    JAX's, none to the rois (they are detached) or valid."""
    feats, rois, valid, ct = _case(17 + sr)
    want, _, _ = _jax_grads(feats, rois, valid, ct, sr)
    tf = [torch.from_numpy(f).requires_grad_() for f in feats]
    tr = torch.from_numpy(rois).requires_grad_()
    roi_align_patch.counter.reset()
    out = roi_align_patch(tf, tr, torch.from_numpy(valid), STRIDES, 7, sr)
    assert out.requires_grad and out.grad_fn is not None
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), tf + [tr],
                              allow_unused=True)
    assert got[-1] is None  # no gradient to the rois
    assert roi_align_patch.counter.launches == 0  # CPU: the plain versions
    _assert_levels_close([g.numpy() for g in got[:-1]], want)


def test_autograd_of_plain_forward_agrees():
    """The explicit transpose equals autograd through the forward's
    indexing ops (a second derivation of the same gradient)."""
    feats, rois, valid, ct = _case(30, out=14)
    tf = [torch.from_numpy(f).requires_grad_() for f in feats]
    geom, smax = roi_geometry(torch.from_numpy(rois),
                              torch.from_numpy(valid), SIZES, STRIDES, 14, 0)
    out = roi_align_reference(tf, geom, 14, smax)
    want = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), tf)
    got = roi_align_backward_reference(torch.from_numpy(ct), geom, SIZES, 14,
                                       smax)
    _assert_levels_close(got, want)


def test_invalid_rois_contribute_nothing():
    feats, rois, valid, ct = _case(40)
    geom, smax = roi_geometry(torch.from_numpy(rois),
                              torch.from_numpy(valid), SIZES, STRIDES, 7, 0)
    base = roi_align_backward_reference(torch.from_numpy(ct), geom, SIZES, 7,
                                        smax)
    # a cotangent on the invalid rows alone reaches no level
    only_invalid = torch.from_numpy(ct) * torch.from_numpy(
        ~valid)[..., None, None, None]
    for g in roi_align_backward_reference(only_invalid, geom, SIZES, 7, smax):
        assert torch.count_nonzero(g) == 0
    # and making a valid roi invalid removes exactly its share
    geom2 = geom.clone()
    i = int(np.flatnonzero(valid[0])[0])
    geom2[0, i, GEOM_VALID] = 0.0
    drop = roi_align_backward_reference(torch.from_numpy(ct), geom2, SIZES,
                                        7, smax)
    one = torch.zeros_like(torch.from_numpy(ct))
    one[0, i] = torch.from_numpy(ct)[0, i]
    share = roi_align_backward_reference(one, geom, SIZES, 7, smax)
    for a, b, s in zip(base, drop, share):
        assert torch.allclose(a - b, s, atol=1e-5)


def test_gradcheck_on_the_cpu_function():
    """Finite differences of the Function at a tiny size.  It is linear in
    the features, so the differences are exact up to fp32 rounding: fp32
    tolerances (the plain version sums in fp32)."""
    rng = np.random.default_rng(50)
    feats = [torch.from_numpy(rng.standard_normal((1, h, w, 8))
                              .astype(np.float32)).requires_grad_()
             for h, w in ((8, 12), (4, 6))]
    rois = torch.tensor([[[2.0, 3.0, 30.0, 20.0], [0.0, 0.0, 47.0, 31.0],
                          [10.0, 5.0, 14.0, 40.0]]])
    valid = torch.tensor([[True, True, False]])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # fp32, not fp64
        assert torch.autograd.gradcheck(
            lambda *fs: roi_align_patch(list(fs), rois, valid, (4, 8), 3, 0,
                                        finest_scale=24.0),
            feats, eps=0.5, atol=1e-4, rtol=1e-3, fast_mode=True)
