"""The factorisation the CUDA RoIAlign forward relies on, held where there
is no card: each roi's pooling is ``Ay @ feat @ Ax^T`` with the folded
per-axis weights of ``detect.roi_align.axis_weights``.

The weights are held to the JAX kernel's ``_axis_matrix``
(``mrla_tpu/kernels/roialign_patch.py``) with its patch origin at cell 0
and the patch spanning the whole level, on the rois of
``tests/test_torch_roialign.py`` and on hard cases: rois spanning the
whole top level, point-like rois and rois wider than 56 cells.  The
product is held to the plain version ``roi_align_reference`` within 196
fp32 roundings of max|feature| (``chip_smoke.py``'s fp32 limit: the plain
version sums up to 4 x 7 x 7 weighted terms a bin, the product the same
terms in another order); the JAX kernel's 56-cell patch drops the terms of
a roi wider than that, and the factorisation must not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrla_tpu.kernels.roialign_patch import _axis_matrix
from mrla_tpu.kernels.roialign_patch import roi_align_patch as j_patch
from mrla_tpu_torch.detect.roi_align import (
    GEOM_BIN_X,
    GEOM_BIN_Y,
    GEOM_GX,
    GEOM_GY,
    GEOM_LEVEL,
    GEOM_VALID,
    GEOM_X1,
    GEOM_Y1,
    axis_weights,
    roi_align_reference,
    roi_geometry,
)
from test_torch_roialign import CANVAS, SIZES, STRIDES, _feats, _rois, _valid
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

ROI_FP32_TERMS = 4 * 7 * 7


def _hard_rois(b=2):
    """Rois spanning the whole top level (clamped to it), point-like rois
    and rois wider (and taller) than 56 cells on the finest level."""
    ch, cw = CANVAS
    r = np.array([
        [-16.0, -16.0, cw + 16.0, ch + 16.0],  # the whole canvas: level 3
        [0.0, 0.0, cw, ch],
        [100.0, 60.0, 100.25, 60.25],  # points
        [3.0, 250.0, 3.1, 250.1],
        [380.0, 10.0, 380.5, 10.5],
        [10.0, 30.0, 270.0, 70.0],  # 65 cells wide on level 0
        [40.0, 2.0, 80.0, 254.0],  # 63 cells tall on level 0
        [0.0, 100.0, 384.0, 130.0],  # 96 wide: the whole of level 0
    ], dtype=np.float32)
    return np.broadcast_to(r, (b,) + r.shape).copy()


def _rois_of(kind, rng):
    return _rois(rng) if kind == "realistic" else _hard_rois()


def _per_roi(geom, out_size, smax):
    """Ay [R, O, H_max], Ax [R, O, W_max] of every roi, with its level,
    image and validity."""
    g = geom.reshape(-1, geom.shape[-1])
    lvl = g[:, GEOM_LEVEL].long()
    hs = torch.tensor([h for h, _ in SIZES])[lvl]
    ws = torch.tensor([w for _, w in SIZES])[lvl]
    ay = axis_weights(g[:, GEOM_Y1], g[:, GEOM_BIN_Y], g[:, GEOM_GY], hs,
                      out_size, smax, max(h for h, _ in SIZES))
    ax = axis_weights(g[:, GEOM_X1], g[:, GEOM_BIN_X], g[:, GEOM_GX], ws,
                      out_size, smax, max(w for _, w in SIZES))
    return g, lvl, ay, ax


@pytest.mark.parametrize("kind", ["realistic", "hard"])
@pytest.mark.parametrize("sr,out_size", [(0, 7), (2, 7), (0, 14)])
def test_axis_weights_match_jax_axis_matrix(kind, sr, out_size):
    rng = np.random.default_rng(50 + sr + out_size)
    rois = torch.from_numpy(_rois_of(kind, rng))
    geom, smax = roi_geometry(rois, None, SIZES, STRIDES, out_size, sr)
    g, lvl, ay, ax = _per_roi(geom, out_size, smax)
    hs = np.array([h for h, _ in SIZES], np.float32)[lvl.numpy()]
    ws = np.array([w for _, w in SIZES], np.float32)[lvl.numpy()]
    gn = g.numpy()

    def jax_axis(start, bin_size, gg, n, cells):
        f = jax.vmap(lambda s, b, k, m: _axis_matrix(
            s, b, k, jnp.float32(0.0), m, cells, out_size, smax))
        return np.asarray(f(jnp.asarray(start), jnp.asarray(bin_size),
                            jnp.asarray(gg), jnp.asarray(n)))

    want_y = jax_axis(gn[:, GEOM_Y1], gn[:, GEOM_BIN_Y], gn[:, GEOM_GY], hs,
                      ay.shape[-1])
    want_x = jax_axis(gn[:, GEOM_X1], gn[:, GEOM_BIN_X], gn[:, GEOM_GX], ws,
                      ax.shape[-1])
    # each entry sums at most a few slot weights of at most 1: fp32 order
    np.testing.assert_allclose(ay.numpy(), want_y, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ax.numpy(), want_x, rtol=0, atol=1e-6)
    # a bin's weights along an axis add up to at most 1
    assert float(ay.sum(-1).max()) <= 1.0 + 1e-6
    assert float(ax.sum(-1).max()) <= 1.0 + 1e-6


@pytest.mark.parametrize("kind", ["realistic", "hard"])
@pytest.mark.parametrize("sr,out_size", [(0, 7), (2, 7), (0, 14)])
def test_separable_product_equals_reference(kind, sr, out_size):
    rng = np.random.default_rng(60 + sr + out_size)
    feats = [torch.from_numpy(f) for f in _feats(rng, c=32)]
    rois = torch.from_numpy(_rois_of(kind, rng))
    valid = torch.from_numpy(_valid(rng, p=rois.shape[1]))
    geom, smax = roi_geometry(rois, valid, SIZES, STRIDES, out_size, sr)
    want = roi_align_reference(feats, geom, out_size, smax)
    g, lvl, ay, ax = _per_roi(geom, out_size, smax)
    b, p = rois.shape[:2]
    got = torch.zeros_like(want).reshape(b * p, out_size, out_size, -1)
    for r in range(b * p):
        f = feats[int(lvl[r])][r // p]
        h, w = f.shape[:2]
        got[r] = torch.einsum("oy,yxc,px->opc", ay[r, :, :h], f,
                              ax[r, :, :w]) * g[r, GEOM_VALID]
    got = got.reshape(want.shape)
    tol = ROI_FP32_TERMS * 2.0 ** -24 * max(f.abs().max().item()
                                            for f in feats)
    assert (got - want).abs().max().item() <= tol
    if kind == "hard":  # the wide rois are on level 0 and not empty
        wide = geom[0, 5:8]
        assert (wide[:, GEOM_LEVEL] == 0).all()
        assert (wide[:, GEOM_BIN_X] * out_size > 56).any()
        assert (wide[:, GEOM_BIN_Y] * out_size > 56).any()


def test_jax_patch_drops_what_the_factorisation_keeps():
    """A roi 65 cells wide on level 0: the JAX kernel (interpret mode)
    loses the terms past its 56-cell patch, the factorisation and the
    port's plain version keep them."""
    rng = np.random.default_rng(70)
    feats = _feats(rng, b=1)
    rois = _hard_rois(b=1)[:, 5:6]
    ref = np.asarray(j_patch([jnp.asarray(f) for f in feats],
                             jnp.asarray(rois), None, STRIDES, 7, 0,
                             interpret=True))
    tf = [torch.from_numpy(f) for f in feats]
    geom, smax = roi_geometry(torch.from_numpy(rois), None, SIZES, STRIDES,
                              7, 0)
    want = roi_align_reference(tf, geom, 7, smax)
    _, _, ay, ax = _per_roi(geom, 7, smax)
    h, w = SIZES[0]
    got = torch.einsum("oy,yxc,px->opc", ay[0, :, :h], tf[0][0],
                       ax[0, :, :w])
    tol = ROI_FP32_TERMS * 2.0 ** -24 * max(np.abs(f).max() for f in feats)
    assert (got - want[0, 0]).abs().max().item() <= tol
    # the patch covers 56 of the 65 cells: the last output columns differ
    assert np.abs(ref[0, 0] - want[0, 0].numpy()).max() > 100 * tol
