"""The port's CUDA kernels against their plain versions on the card.

Marked ``gpu``; each test skips (inside the ``cuda`` fixture) when no CUDA
device is present.  This file imports no JAX, so on a machine without it
run it without the JAX-forcing conftest:

    python -m pytest --noconftest -m gpu -q tests/test_torch_gpu.py

Tolerances: the kernel and its plain version round the same fp32 value,
summed in another order, to bf16 once, so y agrees to one bf16 ulp at the
largest |y|; x1 to two (its own rounding plus y's rare one-ulp flips).
The stage kernel's y to two as well: its own rounding, plus the rare
one-ulp flips of the bf16 intermediates (y, x1, o) that travel on.  The
DeiT token tail's out to one, as y.
"""

import pytest
import torch

from mrla_tpu_torch.kernels import (
    TailParams,
    deit_token_tail,
    deit_token_tail_reference,
    fused_epilogue,
    fused_epilogue_reference,
    mrla_block_tail_fused_next,
    mrla_block_tail_fused_next_reference,
    mrla_light_gate,
    stage4_resident,
    stage4_resident_reference,
)
from mrla_tpu_torch.serving import (
    deit_forward,
    prepare_deit_inference_params,
    prepare_inference_params,
    resnet_mrlal_forward,
)
from mrla_tpu_torch.testing import deit_tail_case, stage4_case

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _tail(gen, b, h, w, c):
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    return dict(
        out=rnd(b, h, w, c).relu_().bfloat16(),
        identity=rnd(b, h, w, c).bfloat16(),
        gate=torch.sigmoid(rnd(b, c)),
        wv=rnd(9, c) * 0.3,
        lam=rnd(c),
        bn_scale=rnd(c) * 0.2 + 1.0,
        bn_bias=rnd(c) * 0.2,
    )


def _assert_ulps(got, want, ulps):
    want = want.float()
    tol = ulps * 2.0 ** -7 * want.abs().max().item()
    err = (got.float() - want).abs().max().item()
    assert err <= tol, (err, tol)


# ragged maps (pixels not a multiple of the 64-pixel tile, W=7, B=1) and
# the main-path shapes at a small batch
@pytest.mark.parametrize("b,h,w,c", [(1, 5, 7, 64), (3, 7, 7, 2048),
                                     (2, 14, 14, 1024), (2, 9, 11, 256)])
def test_epilogue_kernel_matches_plain(cuda, b, h, w, c):
    a = _tail(cuda, b, h, w, c)
    fused_epilogue.counter.reset()
    y = fused_epilogue(**a)
    assert fused_epilogue.counter.launches == 1
    _assert_ulps(y, fused_epilogue_reference(**a), 1)


# and the W1 ring's edges: C = 64 and 128 (fewer K chunks than ring
# stages), a ragged P = 3 x 5 x 7, one column chunk and several, the
# detection shape
@pytest.mark.parametrize("b,h,w,c,c1", [(1, 5, 7, 64, 64),
                                        (2, 56, 56, 256, 64),
                                        (2, 56, 56, 256, 128),
                                        (3, 28, 28, 512, 128),
                                        (2, 28, 28, 512, 256),
                                        (2, 9, 11, 256, 256),
                                        (3, 5, 7, 128, 128),
                                        (3, 5, 7, 256, 64),
                                        (3, 5, 7, 512, 256),
                                        (1, 50, 84, 1024, 256)])
def test_megatail_kernel_matches_plain(cuda, b, h, w, c, c1):
    a = _tail(cuda, b, h, w, c)
    w1 = (torch.randn(c1, c, 1, 1, generator=cuda, device="cuda")
          / c ** 0.5).bfloat16()
    b1 = torch.randn(c1, generator=cuda, device="cuda") * 0.2
    mrla_block_tail_fused_next.counter.reset()
    y, x1 = mrla_block_tail_fused_next(**a, w1_next=w1, b1_next=b1)
    assert mrla_block_tail_fused_next.counter.launches == 1
    y_ref, x1_ref = mrla_block_tail_fused_next_reference(
        **a, w1_next=w1, b1_next=b1)
    _assert_ulps(y, y_ref, 1)
    _assert_ulps(x1, x1_ref, 2)


def test_cuda_wrappers_reject_fp32_activations(cuda):
    a = _tail(cuda, 1, 4, 4, 64)
    a["out"] = a["out"].float()
    a["identity"] = a["identity"].float()
    with pytest.raises(TypeError, match="bfloat16"):
        fused_epilogue(**a)


# the C entry points refuse these with cudaErrorInvalidValue (1)
@pytest.mark.parametrize("c,c1", [(96, 64), (256, 32), (256, 192)])
def test_megatail_entry_point_rejects_unsupported_widths(cuda, c, c1):
    a = _tail(cuda, 1, 4, 4, c)
    w1 = torch.zeros(c1, c, device="cuda", dtype=torch.bfloat16)
    b1 = torch.zeros(c1, device="cuda")
    mrla_block_tail_fused_next.counter.reset()
    with pytest.raises(RuntimeError, match="cudaError 1"):
        mrla_block_tail_fused_next(**a, w1_next=w1, b1_next=b1)
    assert mrla_block_tail_fused_next.counter.launches == 0
    torch.cuda.synchronize()  # no error was left pending on the card


def test_epilogue_entry_point_rejects_c_not_multiple_of_8(cuda):
    a = _tail(cuda, 1, 4, 4, 12)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        fused_epilogue(**a)


# the published widths at ragged row counts (49, 147 and 784 rows against
# tiles of 64 and 128), and one narrow width the kernel takes
@pytest.mark.parametrize("b,cin,c1,c,ktap", [(1, 1024, 512, 2048, 5),
                                             (3, 1024, 512, 2048, 5),
                                             (16, 1024, 512, 2048, 5),
                                             (3, 256, 128, 512, 3)])
def test_stage4_kernel_matches_plain(cuda, b, cin, c1, c, ktap):
    ob, xs, packed = stage4_case(cuda, b, cin, c1, c, ktap)
    assert not xs.is_contiguous() and xs.shape == (b, 7, 7, cin)
    stage4_resident.counter.reset()
    y = stage4_resident(ob, xs, packed)
    torch.cuda.synchronize()
    assert stage4_resident.counter.by_shape == {(b, cin, c1, c): 1}
    assert y.shape == (b, 7, 7, c) and y.dtype == torch.bfloat16
    _assert_ulps(y, stage4_resident_reference(ob, xs, packed), 2)


# C1 = 64 is no multiple of the 128-column tile: cudaErrorInvalidValue (1)
def test_stage4_entry_point_rejects_unsupported_widths(cuda):
    ob, xs, packed = stage4_case(cuda, 2, 128, 64, 256, 3)
    stage4_resident.counter.reset()
    with pytest.raises(RuntimeError, match="cudaError 1"):
        stage4_resident(ob, xs, packed)
    assert stage4_resident.counter.launches == 0
    torch.cuda.synchronize()  # no error was left pending on the card
    with pytest.raises(TypeError, match="bfloat16"):
        stage4_resident(ob.float(), xs, packed)


def test_serving_routes_through_the_kernels(cuda):
    """112 px, layers (2, 2, 1, 1): 2 mega-tail and 4 epilogue launches, and
    the bf16 engine on the card agrees with the fp32 engine on the CPU."""
    from mrla_tpu_torch.models.resnet_mrla_light import ResNetMRLALight

    layers = (2, 2, 1, 1)
    model = ResNetMRLALight(list(layers), num_classes=10,
                            generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.1, 0.5)
    x = torch.randn(4, 112, 112, 3, generator=torch.Generator().manual_seed(1))
    want = resnet_mrlal_forward(
        prepare_inference_params(model, layers, torch.float32, "cpu"), x,
        layers)
    params = prepare_inference_params(model, layers, torch.bfloat16, "cuda")
    fused_epilogue.counter.reset()
    mrla_block_tail_fused_next.counter.reset()
    got = resnet_mrlal_forward(params, x.cuda(), layers).cpu()
    # layer1_0 -> layer1_1 (C1=64), layer1_1 -> layer2_0 across the stage
    # boundary (C1=128); layer2_0 .. layer4_0 through the epilogue
    assert mrla_block_tail_fused_next.counter.by_shape == {
        (4, 28, 28, 256, 64): 1, (4, 28, 28, 256, 128): 1}
    assert fused_epilogue.counter.by_shape == {
        (4, 14, 14, 512): 2, (4, 7, 7, 1024): 1, (4, 4, 4, 2048): 1}
    assert torch.isfinite(got).all()
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_gate_runs_on_the_card(cuda):
    a = _tail(cuda, 2, 7, 7, 256)
    wq = torch.randn(5, generator=cuda, device="cuda")
    g = mrla_light_gate(a["out"], wq, wq, 8)
    assert g.shape == (2, 256) and g.device.type == "cuda"
    want = mrla_light_gate(a["out"].cpu(), wq.cpu(), wq.cpu(), 8)
    torch.testing.assert_close(g.cpu(), want, rtol=1e-5, atol=1e-6)


# the three published widths, a batch whose B * N is no multiple of 8, a
# 4x4 and a 3x3 grid, 3-tap channel convs (C = 64) and heads of 32 channels
@pytest.mark.parametrize("b,n,c,d,ktap", [(16, 197, 384, 16, 5),
                                          (3, 197, 384, 16, 5),
                                          (5, 197, 192, 16, 5),
                                          (3, 197, 768, 16, 5),
                                          (3, 17, 128, 16, 5),
                                          (2, 10, 64, 32, 3),
                                          (1, 577, 1024, 16, 7)])
def test_deit_tail_kernel_matches_plain(cuda, b, n, c, d, ktap):
    x, ot, packed = deit_tail_case(cuda, b, n, c, ktap)
    deit_token_tail.counter.reset()
    out = deit_token_tail(x, ot, packed, d)
    torch.cuda.synchronize()
    assert deit_token_tail.counter.by_shape == {(b, n, c): 1}
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert out.data_ptr() not in (x.data_ptr(), ot.data_ptr())
    _assert_ulps(out, deit_token_tail_reference(x, ot, packed, d), 1)


def test_deit_tail_cls_rows_do_not_depend_on_ot(cuda):
    x, ot, packed = deit_tail_case(cuda, 4, 197, 384)
    out = deit_token_tail(x, ot, packed)
    out2 = deit_token_tail(x, ot * 2, packed)
    assert torch.equal(out[:, 0], out2[:, 0])
    assert not torch.equal(out[:, 1:], out2[:, 1:])


# the C entry point refuses these with cudaErrorInvalidValue (1): C no
# multiple of 32, C above 1024, an even number of channel taps
@pytest.mark.parametrize("c,d,ktap", [(48, 16, 5), (2048, 16, 5),
                                      (64, 16, 4)])
def test_deit_tail_entry_point_rejects_unsupported_shapes(cuda, c, d, ktap):
    x, ot, packed = deit_tail_case(cuda, 2, 17, c, ktap)
    deit_token_tail.counter.reset()
    with pytest.raises(RuntimeError, match="cudaError 1"):
        deit_token_tail(x, ot, packed, d)
    assert deit_token_tail.counter.launches == 0
    torch.cuda.synchronize()  # no error was left pending on the card
    with pytest.raises(TypeError, match="bfloat16"):
        deit_token_tail(x.float(), ot.float(), packed, d)
    with pytest.raises(ValueError, match="contiguous"):
        deit_token_tail(x, ot, TailParams(packed.vec.t().contiguous().t(),
                                          packed.taps), d)


def test_deit_serving_routes_through_the_tail_kernel(cuda):
    """A 3-block ViTMRLA of width 64: one launch per block, and the bf16
    engine on the card agrees with the fp32 engine on the CPU."""
    from mrla_tpu_torch.models import ViTMRLA
    from mrla_tpu_torch.testing import spread_deit_weights

    gen = torch.Generator().manual_seed(0)
    model = spread_deit_weights(
        ViTMRLA(embed_dim=64, depth=3, num_heads=2, num_classes=10,
                generator=gen), gen)
    x = torch.randn(4, 224, 224, 3, generator=gen)
    want = deit_forward(
        prepare_deit_inference_params(model, device="cpu",
                                      dtype=torch.float32), x)
    params = prepare_deit_inference_params(model, device="cuda")
    deit_token_tail.counter.reset()
    got = deit_forward(params, x.cuda()).cpu()
    assert deit_token_tail.counter.by_shape == {(4, 197, 64): 3}
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=0.08, rtol=0.05)


# the mega-tail's C entry point takes exactly what megatail_covers states
@pytest.mark.parametrize("c,c1", [(1024, 256), (1472, 256), (1536, 64),
                                  (1536, 256), (1024, 512), (2048, 64),
                                  (2048, 256), (1408, 256), (1408, 128),
                                  (1600, 64), (1664, 64)])
def test_megatail_entry_point_agrees_with_megatail_covers(cuda, c, c1):
    from mrla_tpu_torch.kernels import megatail_covers

    a = _tail(cuda, 1, 2, 3, c)
    w1 = torch.zeros(c1, c, device="cuda", dtype=torch.bfloat16)
    b1 = torch.zeros(c1, device="cuda")
    if megatail_covers(c, c1):
        mrla_block_tail_fused_next(**a, w1_next=w1, b1_next=b1)
    else:
        with pytest.raises(RuntimeError, match="cudaError 1"):
            mrla_block_tail_fused_next(**a, w1_next=w1, b1_next=b1)
    torch.cuda.synchronize()  # no error was left pending on the card


def _roi_case(gen, b, p, c, hw=((200, 336), (100, 168), (50, 84), (25, 42)),
              canvas=(800, 1344), dtype=torch.bfloat16):
    """A pyramid (the detection path's level sizes by default; the top
    level 42 wide, no multiple of 8) and realistic rois with the hard
    cases: off the canvas, zero extent, invalid rows."""
    feats = [torch.randn(b, h, w, c, generator=gen, device="cuda").to(dtype)
             for h, w in hw]
    ch, cw = canvas
    u = lambda *s: torch.rand(*s, generator=gen, device="cuda")
    scale = torch.exp(u(b, p) * 4.5 + 2.0)  # 7 .. 665 px
    ar = torch.exp((u(b, p) - 0.5) * 2.2)
    w, h = scale * ar.sqrt(), scale / ar.sqrt()
    cx, cy = u(b, p) * cw, u(b, p) * ch
    rois = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    rois[..., 0::2] = rois[..., 0::2].clamp(0, cw)
    rois[..., 1::2] = rois[..., 1::2].clamp(0, ch)
    rois[:, 0] = torch.tensor([-40.0, -30.0, 60.0, 50.0])
    rois[:, 1] = 0.0
    valid = u(b, p) > 0.1
    valid[:, 1] = False
    return feats, rois, valid


# the detection path's box head (O = 7, adaptive grid) and mask head (O =
# 14) shapes at a small batch, a static grid, fp32 in / out, and a narrow C
# on a small pyramid
@pytest.mark.parametrize("b,p,o,c,sr,dtype", [
    (2, 300, 7, 256, 0, torch.bfloat16),
    (2, 50, 14, 256, 0, torch.bfloat16),
    (1, 64, 7, 256, 2, torch.bfloat16),
    (1, 64, 7, 256, 0, torch.float32),
    (3, 17, 7, 8, 0, torch.float32),
])
def test_roi_align_kernel_matches_plain(cuda, b, p, o, c, sr, dtype):
    from mrla_tpu_torch.detect.roi_align import (
        roi_align_reference,
        roi_geometry,
    )
    from mrla_tpu_torch.kernels import roi_align_patch

    feats, rois, valid = _roi_case(cuda, b, p, c, dtype=dtype)
    roi_align_patch.counter.reset()
    got = roi_align_patch(feats, rois, valid, out_size=o, sampling_ratio=sr)
    torch.cuda.synchronize()
    assert roi_align_patch.counter.by_shape == {(b, p, o, c): 1}
    assert got.shape == (b, p, o, o, c) and got.dtype == dtype
    geom, smax = roi_geometry(rois, valid, [f.shape[1:3] for f in feats],
                              (4, 8, 16, 32), o, sr)
    want = roi_align_reference([f.float() for f in feats], geom, o, smax)
    assert torch.count_nonzero(got[:, 1]) == 0  # invalid rows are zero
    if dtype == torch.bfloat16:
        _assert_ulps(got, want, 1)
    else:  # fp32 sums of at most 4 * 7 * 7 weighted terms, reassociated
        tol = 196 * 2.0 ** -24 * max(f.abs().max().item() for f in feats)
        assert (got - want).abs().max().item() <= tol


def test_roi_align_entry_point_rejects(cuda):
    from mrla_tpu_torch.kernels import roi_align_patch

    feats, rois, valid = _roi_case(cuda, 1, 4, 12,
                                   hw=((16, 16), (8, 8), (4, 4), (2, 2)),
                                   canvas=(64, 64))
    roi_align_patch.counter.reset()
    with pytest.raises(RuntimeError, match="cudaError 1"):  # C % 8 != 0
        roi_align_patch(feats, rois, valid)
    assert roi_align_patch.counter.launches == 0
    torch.cuda.synchronize()
    with pytest.raises(TypeError, match="bfloat16 or"):
        roi_align_patch([f.half() for f in feats], rois, valid)


def test_detection_serving_routes_through_the_kernels(cuda):
    """A (1, 1, 1, 1) Faster R-CNN at 128 x 160: one RoIAlign launch at
    (B, proposals, 7, 256), and finite detections on the card."""
    from mrla_tpu_torch.detect.two_stage import FasterRCNN
    from mrla_tpu_torch.kernels import roi_align_patch
    from mrla_tpu_torch.serving import (
        prepare_detect_params,
        two_stage_detections,
    )
    from mrla_tpu_torch.testing import spread_detector_weights

    gen = torch.Generator().manual_seed(0)
    model = spread_detector_weights(
        FasterRCNN(layers=(1, 1, 1, 1), num_classes=5, generator=gen).eval(),
        gen, px=(128, 160))
    params = prepare_detect_params(model, (1, 1, 1, 1))
    x = torch.randn(2, 128, 160, 3, generator=gen).cuda()
    roi_align_patch.counter.reset()
    boxes, scores, labels, valid = two_stage_detections(
        params, x, layers=(1, 1, 1, 1), num_proposals=200, rpn_nms_pre=300)
    torch.cuda.synchronize()
    assert roi_align_patch.counter.by_shape == {(2, 200, 7, 256): 1}
    assert torch.isfinite(boxes).all() and torch.isfinite(scores).all()
    assert valid.sum(1).min() > 0


def _grad_tol(ct, geom, hw, o, smax):
    """Each cell of the backward sums at most a few hundred weighted
    cotangent terms, in another order than the plain version's: 64 fp32
    roundings of the sum of its terms' magnitudes, cell by cell."""
    from mrla_tpu_torch.detect.roi_align import roi_align_backward_reference

    mags = roi_align_backward_reference(ct.abs(), geom, hw, o, smax)
    return [64 * 2.0 ** -24 * m + 1e-30 for m in mags]


# 1 to 4 levels, C 8 and 256, out 7, 14 and 77 (the largest taken), the
# adaptive and a static grid; the rois include invalid rows and rois off
# the canvas
@pytest.mark.parametrize("levels,b,p,o,c,sr", [
    (4, 2, 300, 7, 256, 0),
    (4, 2, 50, 14, 256, 0),
    (4, 1, 64, 7, 256, 2),
    (3, 2, 40, 7, 8, 0),
    (2, 1, 33, 14, 8, 2),
    (1, 3, 17, 7, 256, 0),
    (2, 1, 12, 77, 8, 0),
])
def test_roi_align_grad_kernel_matches_plain(cuda, levels, b, p, o, c, sr):
    from mrla_tpu_torch.detect.roi_align import (
        roi_align_backward_reference,
        roi_geometry,
    )
    from mrla_tpu_torch.kernels import roi_align_grad_kernel, roi_align_patch

    hw = ((200, 336), (100, 168), (50, 84), (25, 42))[:levels]
    strides = (4, 8, 16, 32)[:levels]
    feats, rois, valid = _roi_case(cuda, b, p, c, hw=hw, dtype=torch.float32)
    geom, smax = roi_geometry(rois, valid, hw, strides, o, sr)
    ct = torch.randn(b, p, o, o, c, generator=cuda, device="cuda")
    roi_align_patch.counter.reset()
    got = roi_align_grad_kernel(ct, geom, hw, smax)
    again = roi_align_grad_kernel(ct, geom, hw, smax)
    torch.cuda.synchronize()
    assert roi_align_patch.counter.by_shape == {("bwd", b, p, o, c): 2}
    want = roi_align_backward_reference(ct, geom, hw, o, smax)
    for g, a, w, tol in zip(got, again, want, _grad_tol(ct, geom, hw, o,
                                                        smax)):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert ((g - w).abs() <= tol).all()
        assert torch.equal(g, a)  # a fixed order of sums: the same bits
    # invalid rois add nothing: a cotangent on them alone reaches no cell
    only_invalid = ct * (~valid)[..., None, None, None]
    for g in roi_align_grad_kernel(only_invalid, geom, hw, smax):
        assert torch.count_nonzero(g) == 0


def _grad_levels(cuda, hw, strides, rois, valid, o=7, c=64):
    """The backward kernel and its plain version on given rois (one
    image), with a seeded cotangent: (kernel grads, plain grads, tols,
    geometry, smax, cotangent)."""
    from mrla_tpu_torch.detect.roi_align import (
        roi_align_backward_reference,
        roi_geometry,
    )
    from mrla_tpu_torch.kernels import roi_align_grad_kernel

    geom, smax = roi_geometry(rois, valid, hw, strides, o, 0)
    b, p = rois.shape[:2]
    ct = torch.randn(b, p, o, o, c, generator=cuda, device="cuda")
    got = roi_align_grad_kernel(ct, geom, hw, smax)
    again = roi_align_grad_kernel(ct, geom, hw, smax)
    torch.cuda.synchronize()
    want = roi_align_backward_reference(ct, geom, hw, o, smax)
    for g, a, w, tol in zip(got, again, want, _grad_tol(ct, geom, hw, o,
                                                        smax)):
        assert ((g - w).abs() <= tol).all()
        assert torch.equal(g, a)
    return got, want, geom, smax, ct


PYRAMID = ((200, 200), (100, 100), (50, 50), (25, 25))  # 800 x 800


def test_roi_align_grad_kernel_one_hot_tile(cuda):
    """512 rois on one box (the hot tile of a detection step: every roi
    of the image reaches the same few tiles), valid or not."""
    rois = torch.tensor([310.0, 290.0, 470.0, 440.0], device="cuda")
    rois = rois.expand(1, 512, 4).contiguous()
    valid = torch.rand(1, 512, generator=cuda, device="cuda") > 0.25
    got, _, _, _, _ = _grad_levels(cuda, PYRAMID, (4, 8, 16, 32), rois,
                                   valid)
    assert torch.count_nonzero(got[1]) > 0  # a 160 x 150 roi lands on P3


def test_roi_align_grad_kernel_narrow_rois_on_one_tile(cuda):
    """The rois of an untrained detector's step: points and slivers under
    a cell wide on the canvas's bottom edge, hundreds on one tile (each of
    their cells takes up to O x O bins: the folded path), with ordinary
    rois among them; at O = 7 and O = 14."""
    u = lambda *s: torch.rand(*s, generator=cuda, device="cuda")
    x = 400.0 + u(1, 512) * 24.0
    w = u(1, 512) * 0.8
    y1 = torch.where(u(1, 512) < 0.5, 800.0, u(1, 512) * 700.0)
    rois = torch.stack([x, y1, x + w, torch.full_like(x, 800.0)], -1)
    rois[0, ::8] = torch.tensor([380.0, 700.0, 452.0, 780.0])
    valid = u(1, 512) > 0.1
    for o in (7, 14):
        _, _, geom, _, _ = _grad_levels(cuda, PYRAMID, (4, 8, 16, 32), rois,
                                        valid, o=o)
        assert (geom[0, :, 7] == 0).float().mean() > 0.8


def test_roi_align_grad_kernel_roi_spans_the_top_level(cuda):
    """Rois larger than the canvas on the clamped top level: one roi
    reaches every cell of P5, and each tile of it sums many bins."""
    rois = torch.tensor([[[-40.0, -60.0, 840.0, 830.0],
                          [0.0, 0.0, 800.0, 800.0],
                          [100.0, 5.0, 790.0, 420.0]]], device="cuda")
    valid = torch.ones(1, 3, dtype=torch.bool, device="cuda")
    got, _, geom, _, _ = _grad_levels(cuda, PYRAMID, (4, 8, 16, 32), rois,
                                      valid, o=14)
    assert (geom[0, :, 7] == 3).all()
    assert (got[3][0].abs().sum(-1) > 0).all()  # every cell of P5


def test_roi_align_grad_kernel_level_without_rois_is_zero(cuda):
    """Levels no roi maps to come back exactly zero (the uncleared buffers
    are written by their tiles all the same)."""
    rois = torch.tensor([[[10.0, 20.0, 60.0, 70.0], [300.0, 300.0, 340.0,
                                                     350.0],
                          [500.0, 100.0, 760.0, 380.0]]], device="cuda")
    valid = torch.ones(1, 3, dtype=torch.bool, device="cuda")
    got, _, geom, _, _ = _grad_levels(cuda, PYRAMID, (4, 8, 16, 32), rois,
                                      valid)
    assert sorted(geom[0, :, 7].long().tolist()) == [0, 0, 2]
    assert torch.count_nonzero(got[0]) > 0 and torch.count_nonzero(got[2]) > 0
    for lv in (1, 3):
        assert torch.count_nonzero(got[lv]) == 0


def test_roi_align_grad_entry_point_writes_every_cell(cuda):
    """The C entry point over NaN-filled buffers (the levels and the
    scratch) gives the wrapper's result: every cell of every level is
    written, zeros included, and the kernels read of the scratch only what
    they wrote; the boxes it writes are roi_footprint's."""
    from mrla_tpu_torch.detect.roi_align import roi_footprint, roi_geometry
    from mrla_tpu_torch.kernels import roi_align_grad_kernel
    from mrla_tpu_torch.kernels._build import check
    from mrla_tpu_torch.kernels.roialign_patch import (
        grad_scratch,
        launch_grad,
        scratch_boxes,
    )

    hw = ((100, 168), (50, 84), (25, 42), (13, 21))
    feats, rois, valid = _roi_case(cuda, 2, 60, 64, hw=hw, canvas=(400, 672),
                                   dtype=torch.float32)
    rois[:, 2:6, 3] = rois[:, 2:6, 1]  # zero-height rois: folded
    geom, smax = roi_geometry(rois, valid, hw, (4, 8, 16, 32), 7, 0)
    ct = torch.randn(2, 60, 7, 7, 64, generator=cuda, device="cuda")
    want = roi_align_grad_kernel(ct, geom, hw, smax)
    bufs = [torch.full((2, h, w, 64), float("nan"), device="cuda")
            for h, w in hw]
    scratch = grad_scratch(ct, hw, fill=0xFF)  # NaN as fp32, -1 as int32
    check(launch_grad(bufs, geom, ct, scratch, smax), "roi_align_bwd")
    torch.cuda.synchronize()
    for g, w in zip(bufs, want):
        assert torch.equal(g, w)
    # the kernel's boxes are its plain version's, bit for bit
    assert torch.equal(scratch_boxes(scratch, 120),
                       roi_footprint(geom, hw, 7, smax))


def test_roi_align_grad_entry_point_rejects(cuda):
    from mrla_tpu_torch.detect.roi_align import roi_geometry
    from mrla_tpu_torch.kernels import roi_align_grad_kernel, roi_align_patch

    hw = ((16, 16), (8, 8))
    _, rois, valid = _roi_case(cuda, 1, 4, 8, hw=hw, canvas=(64, 64))
    geom, smax = roi_geometry(rois, valid, hw, (4, 8), 7, 0)
    roi_align_patch.counter.reset()
    with pytest.raises(RuntimeError, match="cudaError 1"):  # C % 8 != 0
        roi_align_grad_kernel(torch.randn(1, 4, 7, 7, 12, device="cuda"),
                              geom, hw, smax)
    with pytest.raises(TypeError, match="float32"):
        roi_align_grad_kernel(torch.randn(1, 4, 7, 7, 8, device="cuda")
                              .bfloat16(), geom, hw, smax)
    geom78, smax78 = roi_geometry(rois, valid, hw, (4, 8), 78, 0)
    with pytest.raises(RuntimeError, match="cudaError 1"):  # O > 77
        roi_align_grad_kernel(torch.randn(1, 4, 78, 78, 8, device="cuda"),
                              geom78, hw, smax78)
    assert roi_align_patch.counter.launches == 0
    torch.cuda.synchronize()


def test_roi_align_autograd_on_the_card(cuda):
    """torch.autograd.grad of a seeded function of roi_align_patch on CUDA
    tensors: the backward kernel runs (one launch), and the gradient to
    every level equals the CPU Function's."""
    from mrla_tpu_torch.kernels import roi_align_patch

    hw = ((100, 168), (50, 84), (25, 42), (13, 21))
    feats, rois, valid = _roi_case(cuda, 2, 200, 256, hw=hw,
                                   canvas=(400, 672), dtype=torch.float32)
    ct = torch.randn(2, 200, 7, 7, 256, generator=cuda, device="cuda")

    def grads(fs, r, v, w):
        fs = [f.detach().requires_grad_() for f in fs]
        out = roi_align_patch(fs, r, v, (4, 8, 16, 32), 7, 0)
        return torch.autograd.grad((out * w).sum(), fs)

    roi_align_patch.counter.reset()
    got = grads(feats, rois, valid, ct)
    torch.cuda.synchronize()
    assert roi_align_patch.counter.by_shape == {(2, 200, 7, 256): 1,
                                                ("bwd", 2, 200, 7, 256): 1}
    want = grads([f.cpu() for f in feats], rois.cpu(), valid.cpu(), ct.cpu())
    for g, w in zip(got, want):
        assert torch.count_nonzero(g) > 0
        scale = w.abs().max().item()
        assert (g.cpu() - w).abs().max().item() <= 1e-5 * scale


def test_detection_training_step_on_the_card(cuda):
    """A (1, 1, 1, 1) Faster R-CNN's training step on the card against the
    same step on the CPU (same weights, batch and uniforms): the RPN loss
    terms, and on the CPU's sampled rois the R-CNN loss terms and their
    gradient to P2..P5 (what the backward kernel produces)."""
    from mrla_tpu_torch.kernels import roi_align_patch
    from mrla_tpu_torch.testing import (
        detection_batch,
        rcnn_pyramid_grads,
        train_uniforms,
        training_detector,
    )

    model = training_detector(0, layers=(1, 1, 1, 1), num_classes=5,
                              rpn_nms_pre=300, num_proposals=200)
    batch = detection_batch(1, 2, 160, 5, 4, False)
    rand = train_uniforms(2, 2, 3 * sum(s * s for s in (40, 20, 10, 5, 3)),
                          4 + 200)
    want_l, targets, want_g = rcnn_pyramid_grads(model, batch, rand,
                                                 rcnn_num=64, rpn_num=64)
    roi_align_patch.counter.reset()
    got_l, _, got_g = rcnn_pyramid_grads(
        model.to("cuda"), {k: v.cuda() for k, v in batch.items()}, rand,
        targets, rcnn_num=64, rpn_num=64)
    torch.cuda.synchronize()
    assert roi_align_patch.counter.by_shape == {(2, 64, 7, 256): 1,
                                                ("bwd", 2, 64, 7, 256): 1}
    for k in ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox"):
        assert abs(got_l[k].item() - want_l[k].item()) <= \
            1e-4 * abs(want_l[k].item()), k
    assert torch.count_nonzero(want_g[0]) > 0  # small rois: mostly P2
    for g, w in zip(got_g, want_g):
        assert (g.cpu() - w).norm() <= 1e-4 * w.norm()


def _block_tail_case(gen, b, h, w, c):
    a = _tail(gen, b, h, w, c)
    z = (torch.randn(b, h, w, c, generator=gen, device="cuda")).bfloat16()
    return dict(a, z=z)


# rows of W = 1, 2, 3, 5 and 7 pixels (the window's edges), rows longer
# than a segment (W = 100, 150), B = 1, C = 8 and C = 2048, and main-path
# widths at a small batch
@pytest.mark.parametrize("b,h,w,c", [
    (3, 2, 7, 64), (1, 5, 7, 256), (2, 28, 28, 512), (3, 7, 7, 2048),
    (2, 3, 1, 64), (1, 4, 2, 8), (2, 1, 3, 128), (1, 6, 5, 2048),
    (2, 3, 100, 64), (1, 2, 150, 16), (1, 56, 56, 256), (2, 9, 11, 8)])
def test_block_tail_kernels_match_plain(cuda, b, h, w, c):
    from mrla_tpu_torch.kernels import (
        fused_block_tail,
        fused_block_tail_reference,
        mrla_block_tail,
        mrla_block_tail_hwbc,
    )

    a = _block_tail_case(cuda, b, h, w, c)
    args = (a["z"], a["identity"], a["gate"], a["wv"], a["lam"],
            a["bn_scale"], a["bn_bias"])
    fused_block_tail.counter.reset()
    y = fused_block_tail(*args)
    torch.cuda.synchronize()
    assert fused_block_tail.counter.by_shape == {(b, h, w, c): 1}
    _assert_ulps(y, fused_block_tail_reference(*args), 1)
    # the two gated entry points launch the same kernel, each on its own
    # counter, and agree with the plain version on the CPU
    wq = torch.randn(5, generator=cuda, device="cuda") * 0.3
    full = (a["z"], a["identity"], wq, wq, a["wv"], a["lam"], a["bn_scale"],
            a["bn_bias"], max(1, c // 32))
    mrla_block_tail_hwbc.counter.reset()
    y_hwbc = mrla_block_tail_hwbc(*full)
    y_block = mrla_block_tail(*full)
    assert mrla_block_tail_hwbc.counter.by_shape == {(b, h, w, c): 1}
    assert fused_block_tail.counter.by_shape == {(b, h, w, c): 2}
    assert torch.equal(y_hwbc, y_block)
    cpu = mrla_block_tail(*(t.cpu() if torch.is_tensor(t) else t
                            for t in full))
    _assert_ulps(y_block.cpu(), cpu, 1)


def test_block_tail_entry_point_rejects_c_not_multiple_of_8(cuda):
    from mrla_tpu_torch.kernels import fused_block_tail

    a = _block_tail_case(cuda, 1, 4, 4, 12)
    fused_block_tail.counter.reset()
    with pytest.raises(RuntimeError, match="cudaError 1"):
        fused_block_tail(a["z"], a["identity"], a["gate"], a["wv"], a["lam"],
                         a["bn_scale"], a["bn_bias"])
    assert fused_block_tail.counter.launches == 0
    torch.cuda.synchronize()


# C1 = 64 and 512, H = 2, W = 7, B = 3; C = 2048 takes the 48-pixel tile;
# C1 = 0 is y alone; and the W1 ring's edges: C = 64 and 128 (fewer K
# chunks than ring stages), a ragged P = 3 x 5 x 7, one column chunk and
# several, C = 2048 at B = 1, the detection shape, C1 % 128 != 0 at
# C = 2048 and the widest C taken (both the 32-pixel tile with 32-deep K
# chunks)
@pytest.mark.parametrize("b,h,w,c,c1", [(3, 2, 7, 256, 64),
                                        (1, 5, 7, 1024, 512),
                                        (3, 7, 7, 2048, 512),
                                        (2, 14, 14, 1024, 256),
                                        (3, 2, 7, 192, 0),
                                        (3, 7, 7, 2048, 0),
                                        (3, 5, 7, 64, 64),
                                        (3, 5, 7, 128, 128),
                                        (3, 5, 7, 256, 256),
                                        (3, 5, 7, 512, 256),
                                        (1, 7, 7, 2048, 512),
                                        (1, 50, 84, 1024, 256),
                                        (3, 5, 7, 2048, 192),
                                        (2, 5, 7, 3392, 64)])
def test_rowtail_kernel_matches_plain(cuda, b, h, w, c, c1):
    from mrla_tpu_torch.kernels import mrla_rowtail, mrla_rowtail_reference

    a = _tail(cuda, b, h, w, c)
    args = (a["out"], a["identity"], a["gate"], a["wv"], a["lam"],
            a["bn_scale"], a["bn_bias"])
    w1 = (torch.randn(c1, c, 1, 1, generator=cuda, device="cuda")
          / c ** 0.5).bfloat16()
    b1 = torch.randn(c1, generator=cuda, device="cuda") * 0.2
    extra = (w1, b1) if c1 else ()
    mrla_rowtail.counter.reset()
    got = mrla_rowtail(*args, *extra)
    torch.cuda.synchronize()
    assert mrla_rowtail.counter.by_shape == {(b, h, w, c, c1): 1}
    want = mrla_rowtail_reference(*args, *extra)
    if c1:
        _assert_ulps(got[0], want[0], 1)
        _assert_ulps(got[1], want[1], 2)
        assert got[1].shape == (b, h, w, c1)
    else:
        _assert_ulps(got, want, 1)


# the C entry point refuses these with cudaErrorInvalidValue (1), as
# rowtail_covers states: C % 64 with x1, C1 % 64, a tile beyond 227 KB
# (the widest taken is 3392)
@pytest.mark.parametrize("c,c1", [(96, 64), (256, 96), (4096, 512),
                                  (3456, 64), (3456, 512)])
def test_rowtail_entry_point_agrees_with_rowtail_covers(cuda, c, c1):
    from mrla_tpu_torch.kernels import mrla_rowtail, rowtail_covers

    assert not rowtail_covers(c, c1)
    a = _tail(cuda, 1, 2, 3, c)
    w1 = torch.zeros(c1, c, device="cuda", dtype=torch.bfloat16)
    b1 = torch.zeros(c1, device="cuda")
    mrla_rowtail.counter.reset()
    with pytest.raises(RuntimeError, match="cudaError 1"):
        mrla_rowtail(a["out"], a["identity"], a["gate"], a["wv"], a["lam"],
                     a["bn_scale"], a["bn_bias"], w1, b1)
    assert mrla_rowtail.counter.launches == 0
    torch.cuda.synchronize()
    with pytest.raises(TypeError, match="bfloat16"):
        mrla_rowtail(a["out"].float(), a["identity"].float(), a["gate"],
                     a["wv"], a["lam"], a["bn_scale"], a["bn_bias"])


# what the C side launches at (C, C1) is the tile and the shared memory the
# wrappers' rules state (megatail_tile, rowtail_tile, tail_x1_smem_bytes)
@pytest.mark.parametrize("kind,c,c1", [
    ("megatail", 256, 64), ("megatail", 256, 128), ("megatail", 512, 128),
    ("megatail", 512, 256), ("megatail", 1024, 256), ("rowtail", 1024, 256),
    ("rowtail", 1024, 512), ("rowtail", 2048, 512), ("rowtail", 2048, 192),
    ("rowtail", 3392, 64)])
def test_tail_x1_tiles_agree_with_the_wrappers(cuda, kind, c, c1):
    import ctypes

    from mrla_tpu_torch.kernels._build import library
    from mrla_tpu_torch.kernels.mrla_megatail import (
        RING_STAGES,
        megatail_tile,
        tail_x1_smem_bytes,
    )
    from mrla_tpu_torch.kernels.mrla_rowtail import rowtail_tile

    out = (ctypes.c_int * 6)()
    err = getattr(library(), f"mrla_{kind}_describe")(c, c1,
                                                       ctypes.addressof(out))
    assert err == 0
    blocks_per_sm, bm, cn, stages, kc, smem = out
    tile = (megatail_tile if kind == "megatail" else rowtail_tile)(c, c1)
    assert (bm, cn, kc) == tile and stages == RING_STAGES
    assert smem == tail_x1_smem_bytes(c, tile) and blocks_per_sm >= 1


# sizes that are no multiple of a block's share of the copy (1024 16-byte
# vectors)
@pytest.mark.parametrize("b,h,w,c", [(3, 2, 7, 64), (3, 56, 56, 256),
                                     (3, 4, 5, 64), (7, 33, 31, 136)])
def test_hwbc_copy_kernel_is_a_new_equal_tensor(cuda, b, h, w, c):
    from mrla_tpu_torch.kernels import hwbc_copy

    x = torch.randn(b, h, w, c, generator=cuda, device="cuda").bfloat16()
    hwbc_copy.counter.reset()
    y = hwbc_copy(x)
    torch.cuda.synchronize()
    assert hwbc_copy.counter.by_shape == {(b, h, w, c): 1}
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    x.zero_()
    assert not torch.equal(y, x)


@pytest.mark.parametrize("b,h,w,c", [(3, 4, 5, 64), (1, 1, 1, 8),
                                     (7, 33, 31, 136), (128, 56, 56, 256)])
def test_hwbc_copy_entry_point_copies_every_byte(cuda, b, h, w, c):
    """The copy kernel's C entry point gives a bitwise copy over a
    NaN-filled buffer, at sizes that are no multiple of a block's 1024
    vectors."""
    from mrla_tpu_torch.kernels._build import library

    x = torch.randn(b, h, w, c, generator=cuda, device="cuda").bfloat16()
    y = torch.full_like(x, float("nan"))
    err = library().hwbc_copy_bf16(x.data_ptr(), y.data_ptr(), b, h, w, c,
                                   torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(y, x)


def test_hwbc_copy_entry_point_rejects_c_not_multiple_of_8(cuda):
    from mrla_tpu_torch.kernels import hwbc_copy

    x = torch.zeros(2, 3, 3, 12, device="cuda", dtype=torch.bfloat16)
    hwbc_copy.counter.reset()
    with pytest.raises(RuntimeError, match="cudaError 1"):
        hwbc_copy(x)
    assert hwbc_copy.counter.launches == 0
    torch.cuda.synchronize()
    with pytest.raises(TypeError, match="bfloat16"):
        hwbc_copy(x.float())


def test_tail_routes_launch_their_kernels(cuda):
    """112 px, layers (2, 2, 1, 1): each route's launches by shape, finite
    logits near the fp32 CPU engine's, and the copy route bitwise equal to
    the block-tail route."""
    from mrla_tpu_torch.kernels import (
        fused_block_tail,
        hwbc_copy,
        mrla_block_tail_hwbc,
        mrla_rowtail,
    )
    from mrla_tpu_torch.models.resnet_mrla_light import ResNetMRLALight
    from mrla_tpu_torch.serving import resnet_mrlal_tail_forward

    layers = (2, 2, 1, 1)
    model = ResNetMRLALight(list(layers), num_classes=10,
                            generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.1, 0.5)
    x = torch.randn(3, 112, 112, 3, generator=torch.Generator().manual_seed(1))
    want = resnet_mrlal_forward(
        prepare_inference_params(model, layers, torch.float32, "cpu"), x,
        layers)
    params = prepare_inference_params(model, layers, torch.bfloat16, "cuda")
    counters = (fused_block_tail.counter, mrla_block_tail_hwbc.counter,
                mrla_rowtail.counter, hwbc_copy.counter)
    expect = {
        "rowtail": [{}, {}, {(3, 28, 28, 256, 64): 1,
                             (3, 28, 28, 256, 128): 1,
                             (3, 14, 14, 512, 128): 1,
                             (3, 14, 14, 512, 256): 1,
                             (3, 7, 7, 1024, 512): 1,
                             (3, 4, 4, 2048, 0): 1}, {}],
        "block_tail": [{(3, 14, 14, 512): 2, (3, 7, 7, 1024): 1,
                        (3, 4, 4, 2048): 1}, {(3, 28, 28, 256): 2}, {}, {}],
    }
    # copies after the first three blocks
    expect["copy"] = expect["block_tail"][:3] + [{(3, 28, 28, 256): 2,
                                                  (3, 14, 14, 512): 1}]
    logits = {}
    for tail, want_counts in expect.items():
        for c in counters:
            c.reset()
        logits[tail] = resnet_mrlal_tail_forward(params, x.cuda(), tail,
                                                 layers).cpu()
        assert [dict(c.by_shape) for c in counters] == want_counts, tail
        assert torch.isfinite(logits[tail]).all()
        assert torch.equal(logits[tail].argmax(-1), want.argmax(-1)), tail
    assert torch.equal(logits["copy"], logits["block_tail"])
