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
    GEOM_LEVEL,
    GEOM_VALID,
    roi_align_backward_reference,
    roi_align_reference,
    roi_footprint,
    roi_geometry,
)
from mrla_tpu_torch.kernels import roi_align_patch
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

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
    # 12 rois a image, 5 of them invalid, at C = 16: four plain backward
    # passes stay cheap, and the check needs no width
    feats, rois, valid, ct = _case(40, p=12, c=16)
    assert (~valid).any() and valid[0].any()
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


def _touched_and_boxes(feats_hw, strides, rois, valid, out=7, sr=0):
    """Per roi: the cells the plain backward gives a weight (a cotangent of
    ones on the roi's own channel, so no sum cancels) and its box."""
    b, p = rois.shape[:2]
    geom, smax = roi_geometry(torch.from_numpy(rois), torch.from_numpy(valid),
                              feats_hw, strides, out, sr)
    ct = torch.zeros(b, p, out, out, p)
    ct[:, torch.arange(p), :, :, torch.arange(p)] = 1.0
    grads = roi_align_backward_reference(ct, geom, feats_hw, out, smax)
    boxes = roi_footprint(geom, feats_hw, out, smax).reshape(b, p, 4)
    assert boxes.dtype == torch.int32
    lvl = geom[..., GEOM_LEVEL].long()
    for i in range(b):
        for j in range(p):
            yield grads[lvl[i, j]][i, :, :, j] != 0, boxes[i, j].tolist()


def _assert_footprints(feats_hw, strides, rois, valid, out=7, sr=0):
    for touched, (y0, y1, x0, x1) in _touched_and_boxes(
            feats_hw, strides, rois, valid, out, sr):
        rows = torch.nonzero(touched.any(1)).flatten().tolist()
        cols = torch.nonzero(touched.any(0)).flatten().tolist()
        if not rows:
            assert (y0, y1, x0, x1) == (0, 0, 0, 0)
            continue
        # every touched cell inside, at most one cell of slack a side
        assert y0 <= rows[0] and rows[-1] < y1, (rows, y0, y1)
        assert x0 <= cols[0] and cols[-1] < x1, (cols, x0, x1)
        assert rows[0] - y0 <= 1 and y1 - 1 - rows[-1] <= 1
        assert cols[0] - x0 <= 1 and x1 - 1 - cols[-1] <= 1


@pytest.mark.parametrize("sr,out", [(0, 7), (2, 7), (0, 14)])
def test_footprint_holds_every_touched_cell(sr, out):
    """The JAX VJP test's roi sets: realistic, overlapping rois on four
    levels, invalid rows among them."""
    _, rois, valid, _ = _case(60 + sr + out, c=8)
    assert (~valid).any()
    _assert_footprints(SIZES, STRIDES, rois, valid, out, sr)


def test_footprint_at_edge_rois():
    """Off the canvas, partly off it, smaller than a cell, on the clamped
    top level (past the canvas too), aspect 3 both ways, zero extent, and
    invalid (the empty box)."""
    rois = np.array([[
        [-90.0, -80.0, -20.0, -10.0],     # off the canvas: reaches nothing
        [-40.0, 30.0, 60.0, 90.0],        # partly off it
        [100.5, 40.2, 101.5, 40.9],       # under one cell
        [12.0, 12.0, 12.0, 12.0],         # zero extent
        [-50.0, -100.0, 400.0, 360.0],    # the clamped top level
        [-200.0, -150.0, 500.0, 420.0],   # top level, past the canvas
        [20.0, 60.0, 290.0, 150.0],       # aspect 3, wide
        [200.0, 10.0, 240.0, 130.0],      # aspect 3, tall
        [30.0, 30.0, 80.0, 90.0],         # invalid
    ]], np.float32)
    valid = np.ones(rois.shape[:2], bool)
    valid[0, -1] = False
    for sr in (0, 2):
        _assert_footprints(SIZES, STRIDES, rois, valid, 7, sr)
    geom, smax = roi_geometry(torch.from_numpy(rois), torch.from_numpy(valid),
                              SIZES, STRIDES, 7, 0)
    boxes = roi_footprint(geom, SIZES, 7, smax)
    assert boxes[0].tolist() == [0, 0, 0, 0]
    assert boxes[-1].tolist() == [0, 0, 0, 0]
    assert geom[0, 4, GEOM_LEVEL] == 3 and geom[0, 5, GEOM_LEVEL] == 3
    assert boxes[5].tolist() == [0, 8, 0, 11]  # the whole 8 x 11 level
