"""The port's RoIAlign (geometry + plain version, and the kernel wrapper on
CPU tensors) against the JAX package's ``batched_roi_align`` and its Pallas
kernel ``roi_align_patch`` in interpret mode.

A 4-level pyramid 64x96 / 32x48 / 16x24 / 8x12 at C = 128 (a 256 x 384
canvas), with realistic rois, rois partly or wholly off the canvas,
zero-extent and invalid rows, and rois whose sqrt(area) sits exactly on a
level boundary (56 * 2^k).  Tolerance: 2e-4 of max|ref|, as the JAX
package's own kernel test (fp32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrla_tpu.detect.roi_align import batched_roi_align as j_roi_align
from mrla_tpu.detect.roi_align import map_roi_levels as j_levels
from mrla_tpu.kernels.roialign_patch import roi_align_patch as j_patch
from mrla_tpu_torch.detect.roi_align import (
    GEOM_GX,
    GEOM_GY,
    GEOM_LEVEL,
    batched_roi_align,
    default_max_grid,
    map_roi_levels,
    roi_align_reference,
    roi_geometry,
)
from mrla_tpu_torch.kernels import roi_align_patch
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

SIZES = [(64, 96), (32, 48), (16, 24), (8, 12)]
STRIDES = (4, 8, 16, 32)
CANVAS = (256, 384)
REL = 2e-4


def _feats(rng, b=2, c=128):
    return [rng.standard_normal((b, h, w, c)).astype(np.float32)
            for h, w in SIZES]


def _rois(rng, b=2, p=40):
    """Realistic rois (clamped to the canvas), then the hard cases."""
    ch, cw = CANVAS
    scale = np.exp(rng.uniform(np.log(8.0), np.log(300.0), (b, p)))
    ar = np.exp(rng.uniform(np.log(1 / 3), np.log(3.0), (b, p)))
    w, h = scale * np.sqrt(ar), scale / np.sqrt(ar)
    cx, cy = rng.uniform(0, cw, (b, p)), rng.uniform(0, ch, (b, p))
    r = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    r[..., 0::2] = np.clip(r[..., 0::2], 0, cw)
    r[..., 1::2] = np.clip(r[..., 1::2], 0, ch)
    r[:, 0] = [-40.0, -30.0, 60.0, 50.0]  # partly off the canvas
    r[:, 1] = [350.0, 230.0, 420.0, 300.0]  # past the bottom-right corner
    r[:, 2] = [-90.0, -90.0, -20.0, -10.0]  # wholly off the canvas
    r[:, 3] = 0.0  # zero extent (a padded row)
    r[:, 4] = [10.0, 10.0, 10.0, 60.0]  # zero width
    # sqrt(area) exactly 56, 112, 224, 448: the level boundaries
    for i, side in enumerate((56.0, 112.0, 224.0, 448.0)):
        r[:, 5 + i] = [20.0, 20.0, 20.0 + side, 20.0 + side]
    r[:, 9] = [3.0, 7.0, 3.0 + 64.0, 7.0 + 196.0]  # 112^2 as 64 x 196
    return r.astype(np.float32)


def _valid(rng, b=2, p=40):
    v = rng.random((b, p)) > 0.15
    v[:, 3] = False
    return v


@pytest.mark.parametrize("sr", [0, 1, 2])
def test_plain_version_matches_jax(sr):
    rng = np.random.default_rng(sr)
    feats, rois, valid = _feats(rng), _rois(rng), _valid(rng)
    ref = np.asarray(j_roi_align([jnp.asarray(f) for f in feats],
                                 jnp.asarray(rois), jnp.asarray(valid),
                                 STRIDES, 7, sr))
    got = batched_roi_align([torch.from_numpy(f) for f in feats],
                            torch.from_numpy(rois), torch.from_numpy(valid),
                            STRIDES, 7, sr).numpy()
    assert got.shape == ref.shape == (2, 40, 7, 7, 128)
    assert np.abs(got - ref).max() <= REL * np.abs(ref).max()
    assert np.abs(got[:, 3]).max() == 0.0  # invalid rows zeroed


@pytest.mark.parametrize("sr,out_size", [(0, 7), (2, 7), (0, 14)])
def test_wrapper_on_cpu_matches_pallas_interpret(sr, out_size):
    """The kernel's wrapper (plain version for CPU tensors) against the TPU
    kernel run in interpret mode, where its 56-cell patch covers the rois
    (it does for every roi here)."""
    rng = np.random.default_rng(10 + sr + out_size)
    feats, rois, valid = _feats(rng), _rois(rng, p=24), _valid(rng, p=24)
    ref = np.asarray(j_patch([jnp.asarray(f) for f in feats],
                             jnp.asarray(rois), jnp.asarray(valid), STRIDES,
                             out_size, sr, interpret=True))
    roi_align_patch.counter.reset()
    got = roi_align_patch([torch.from_numpy(f) for f in feats],
                          torch.from_numpy(rois), torch.from_numpy(valid),
                          STRIDES, out_size, sr).numpy()
    assert roi_align_patch.counter.calls == 1
    assert roi_align_patch.counter.launches == 0  # CPU: the plain version
    assert np.abs(got - ref).max() <= REL * np.abs(ref).max()


def test_levels_and_sample_counts_match_jax():
    rng = np.random.default_rng(20)
    rois = _rois(rng, p=40)
    lvl = map_roi_levels(torch.from_numpy(rois), 4).numpy()
    np.testing.assert_array_equal(lvl, np.asarray(j_levels(jnp.asarray(rois),
                                                           4)))
    # the boundary rois: 56 -> 0, 112 -> 1, 224 -> 2, 448 -> 3 (clamped)
    np.testing.assert_array_equal(lvl[:, 5:10], [[0, 1, 2, 3, 1]] * 2)
    geom, smax = roi_geometry(torch.from_numpy(rois), None, SIZES, STRIDES,
                              7, 0)
    assert smax == default_max_grid(SIZES, 7) == 7
    np.testing.assert_array_equal(geom[..., GEOM_LEVEL].numpy(), lvl)
    g = geom[..., GEOM_GY:GEOM_GX + 1]
    assert g.min() >= 1 and g.max() <= smax
    assert torch.equal(g, g.round())


def test_bf16_form_is_widen_compute_narrow():
    """bf16 features in, bf16 out == widen to fp32, pool, narrow once."""
    rng = np.random.default_rng(30)
    feats = [torch.from_numpy(f).bfloat16() for f in _feats(rng)]
    rois, valid = torch.from_numpy(_rois(rng)), torch.from_numpy(_valid(rng))
    got = roi_align_patch(feats, rois, valid, STRIDES, 7, 0)
    assert got.dtype == torch.bfloat16
    want = roi_align_patch([f.float() for f in feats], rois, valid, STRIDES,
                           7, 0).bfloat16()
    assert torch.equal(got, want)


def test_reference_reads_the_geometry():
    """A level moved in the geometry moves the result: the plain version
    decides nothing itself."""
    rng = np.random.default_rng(40)
    feats = [torch.from_numpy(f) for f in _feats(rng, b=1)]
    rois = torch.from_numpy(_rois(rng, b=1, p=12))
    geom, smax = roi_geometry(rois, None, SIZES, STRIDES, 7, 0)
    a = roi_align_reference(feats, geom, 7, smax)
    moved = geom.clone()
    moved[..., GEOM_LEVEL] = (moved[..., GEOM_LEVEL] + 1).clamp(max=3)
    b = roi_align_reference(feats, moved, 7, smax)
    changed = (geom[0, :, GEOM_LEVEL] < 3)
    assert not torch.allclose(a[0, changed], b[0, changed])


@pytest.mark.parametrize("bad", ["levels", "rois", "channels"])
def test_wrapper_rejects_bad_shapes(bad):
    feats = [torch.zeros(1, h, w, 16) for h, w in SIZES]
    rois = torch.zeros(1, 3, 4)
    strides = STRIDES
    if bad == "levels":
        strides = STRIDES[:3]
    elif bad == "rois":
        rois = torch.zeros(1, 3, 5)
    else:
        feats[2] = torch.zeros(1, 16, 24, 8)
    with pytest.raises(ValueError):
        roi_align_patch(feats, rois, None, strides)
