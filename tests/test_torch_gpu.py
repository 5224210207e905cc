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

import copy
import math

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


# ragged maps, W = 7, B = 1 and the main-path shapes at a small batch; the
# window's edges: rows of W = 1, 2, 3 and 5 pixels, rows longer than a
# segment (W = 100, 150), C = 8 and C = 2048; the detection shape
@pytest.mark.parametrize("b,h,w,c", [
    (1, 5, 7, 64), (3, 7, 7, 2048), (2, 14, 14, 1024), (2, 9, 11, 256),
    (2, 3, 1, 64), (1, 4, 2, 8), (2, 1, 3, 128), (1, 6, 5, 2048),
    (2, 3, 100, 64), (1, 2, 150, 16), (2, 9, 11, 8), (1, 50, 84, 1024)])
def test_epilogue_kernel_matches_plain(cuda, b, h, w, c):
    a = _tail(cuda, b, h, w, c)
    fused_epilogue.counter.reset()
    y = fused_epilogue(**a)
    torch.cuda.synchronize()
    assert fused_epilogue.counter.by_shape == {(b, h, w, c): 1}
    _assert_ulps(y, fused_epilogue_reference(**a), 1)


# the mega-tail computes y through mrla_tail_y8, the tap loop the epilogue's
# window replaced: the two y must be the same bits
@pytest.mark.parametrize("b,h,w,c,c1", [(2, 14, 14, 1024, 256),
                                        (1, 50, 84, 1024, 256)])
def test_epilogue_y_is_the_megatail_y(cuda, b, h, w, c, c1):
    a = _tail(cuda, b, h, w, c)
    w1 = (torch.randn(c1, c, generator=cuda, device="cuda")
          / c ** 0.5).bfloat16()
    b1 = torch.randn(c1, generator=cuda, device="cuda") * 0.2
    y_mega, _ = mrla_block_tail_fused_next(**a, w1_next=w1, b1_next=b1)
    assert torch.equal(fused_epilogue(**a), y_mega)


@pytest.mark.parametrize("b,h,w,c", [(128, 14, 14, 1024), (128, 7, 7, 2048),
                                     (8, 50, 84, 1024), (2, 3, 150, 8)])
def test_epilogue_describe_covers_every_row(cuda, b, h, w, c):
    """The launch mrla_epilogue_describe reports: segments that tile each
    row, a thread per (segment, 8 channels), at least one block an SM."""
    import ctypes

    from mrla_tpu_torch.kernels._build import check, library

    out = (ctypes.c_int * 6)()
    check(library().mrla_epilogue_describe(b, h, w, c, ctypes.addressof(out)),
          "mrla_epilogue_describe")
    seg, threads, per_sm, blocks, ring, packed = out
    segs = -(-w // seg)
    assert 0 < seg <= w and segs == -(-w // 64) and seg * segs >= w
    assert blocks == -(-(b * h * segs * (c // 8)) // threads)
    assert per_sm >= 1 and ring >= 2 and packed in (0, 1)


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


# the published widths at batches around the whole-image tiles (two images
# a tile: an odd last tile at 1, 3, 5, 11; 4, 6 and 16 even) and the
# 128-row tiles of x1 (49 .. 784 rows), and one narrow width the kernel takes
@pytest.mark.parametrize("b,cin,c1,c,ktap", [(1, 1024, 512, 2048, 5),
                                             (3, 1024, 512, 2048, 5),
                                             (4, 1024, 512, 2048, 5),
                                             (5, 1024, 512, 2048, 5),
                                             (6, 1024, 512, 2048, 5),
                                             (11, 1024, 512, 2048, 5),
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


# xs from a parent map whose image stride is no 7 row strides (a padded
# map): id0 then takes whole-image tiles in place of image-row tiles
@pytest.mark.parametrize("b", [1, 6])
def test_stage4_kernel_takes_xs_of_any_pixel_strides(cuda, b):
    ob, xs, packed = stage4_case(cuda, b, 1024, 512, 2048)
    big = torch.zeros(b, 15, 14, 1024, dtype=xs.dtype, device="cuda")
    big[:, 0:14:2, 0:14:2] = xs
    xs2 = big[:, 0:14:2, 0:14:2]
    assert xs2.stride(0) != 7 * xs2.stride(1) and torch.equal(xs2, xs)
    y = stage4_resident(ob, xs2, packed)
    _assert_ulps(y, stage4_resident_reference(ob, xs, packed), 2)


# more images than a round of blocks holds (each block several tiles, the
# two consumer warpgroups taking turns)
@pytest.mark.parametrize("b", [5, 40])
def test_stage4_two_launches_bitwise_equal_and_every_element_written(cuda, b):
    from mrla_tpu_torch.kernels._build import library
    from mrla_tpu_torch.kernels.mrla_stage4 import entry_args, scratch

    ob, xs, packed = stage4_case(cuda, b, 1024, 512, 2048)
    y = stage4_resident(ob, xs, packed)
    assert torch.equal(stage4_resident(ob, xs, packed), y)
    # through the C entry point into NaN-filled output and scratch
    out = torch.full_like(y, float("nan"))
    buffers = {k: v.fill_(float("nan")) for k, v in
               scratch(b, 512, 2048, "cuda").items()}
    err = library().mrla_stage4_bf16(
        *entry_args(ob, xs, packed, buffers, out),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0 and torch.equal(out, y)


# each launch's tiles as the kernel reports them cover the B * 49 rows once
# (the last tile may run past them) and the output channels in 128-column
# tiles, one block an SM at most, each block within sm_90's shared memory
@pytest.mark.parametrize("b", [1, 2, 5, 128])
def test_stage4_describe_tiles_cover_every_row_once(cuda, b):
    import ctypes

    from mrla_tpu_torch.kernels._build import library

    cin, c1, c = 1024, 512, 2048
    plan = (ctypes.c_int * 48)()
    assert library().mrla_stage4_describe(b, cin, c1, c,
                                          ctypes.addressof(plan)) == 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # id0, z0, then x1, o, z of blocks 1 and 2
    widths = [c, c, c1, c1, c, c1, c1, c]
    for i, n in enumerate(widths):
        tiles, blocks, rows, cols, stages, smem = plan[6 * i:6 * i + 6]
        m_tiles, rest = divmod(tiles, n // 128)
        assert rest == 0 and (m_tiles - 1) * rows < b * 49 <= m_tiles * rows
        assert cols == (136 if i in (1, 4, 7) else 128)
        assert blocks == min(tiles, sms) and stages > 0
        assert 0 < smem <= 232448


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
# single image, the 384 px base model's grid, a 4x4 and a 3x3 grid, 3-tap
# channel convs (C = 64) and heads of 32 channels; the 24 x 24 grid at
# C = 192 and a single image at C = 768
@pytest.mark.parametrize("b,n,c,d,ktap", [(16, 197, 384, 16, 5),
                                          (3, 197, 384, 16, 5),
                                          (1, 197, 384, 16, 5),
                                          (5, 197, 192, 16, 5),
                                          (3, 197, 768, 16, 5),
                                          (2, 577, 768, 16, 5),
                                          (3, 17, 128, 16, 5),
                                          (2, 10, 64, 32, 3),
                                          (1, 577, 1024, 16, 7),
                                          (2, 577, 192, 16, 5),
                                          (1, 197, 768, 16, 5)])
def test_deit_tail_kernel_matches_plain(cuda, b, n, c, d, ktap):
    x, ot, packed = deit_tail_case(cuda, b, n, c, ktap)
    deit_token_tail.counter.reset()
    out = deit_token_tail(x, ot, packed, d)
    torch.cuda.synchronize()
    assert deit_token_tail.counter.by_shape == {(b, n, c): 1}
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert out.data_ptr() not in (x.data_ptr(), ot.data_ptr())
    _assert_ulps(out, deit_token_tail_reference(x, ot, packed, d), 1)


# two runs of a batch bitwise equal; through the C entry point into an
# output of NaNs, every element written
@pytest.mark.parametrize("b,n,c", [(4, 197, 384), (3, 197, 768)])
def test_deit_tail_two_launches_bitwise_equal_and_every_element_written(
        cuda, b, n, c):
    from mrla_tpu_torch.kernels._build import library

    x, ot, packed = deit_tail_case(cuda, b, n, c)
    out = deit_token_tail(x, ot, packed)
    assert torch.equal(deit_token_tail(x, ot, packed), out)
    lib, ktap = library(), packed.taps.shape[1]
    scratch = torch.empty(
        b * lib.deit_token_tail_scratch_per_image(n, c, 16, ktap),
        device="cuda")
    nan = torch.full_like(x, float("nan"))
    assert lib.deit_token_tail_bf16(
        x.data_ptr(), ot.data_ptr(), packed.vec.data_ptr(),
        packed.taps.data_ptr(), scratch.data_ptr(), nan.data_ptr(), b, n, c,
        16, ktap, torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(nan, out)


# the window never reads across images: image 1's out is the same bits
# whether its neighbours in memory hold zeros or large values, and so are
# images 0 and 2 whatever image 1 holds
@pytest.mark.parametrize("n,c", [(197, 384), (577, 192), (10, 64)])
def test_deit_tail_images_do_not_reach_each_other(cuda, n, c):
    x, ot, packed = deit_tail_case(cuda, 3, n, c)
    big = lambda t: (torch.rand(t.shape, generator=cuda, device="cuda")
                     * 2000 - 1000).bfloat16()

    def with_images(images, fill):
        x2, ot2 = x.clone(), ot.clone()
        for i in images:
            x2[i], ot2[i] = fill(x2[i]), fill(ot2[i])
        return deit_token_tail(x2, ot2, packed)

    zeros = torch.zeros_like
    assert torch.equal(with_images((0, 2), zeros)[1],
                       with_images((0, 2), big)[1])
    a, b = with_images((1,), zeros), with_images((1,), big)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert not torch.equal(a[1], b[1])


def test_deit_tail_early_pass2_reads_only_this_launchs_scratch(cuda):
    """Pass 2 is a dependent launch in every call: its blocks start while
    pass 1 still runs and wait for it before they read the gates and the
    rows' statistics.  At the main shape, a launch on a scratch that holds
    another input's gates and statistics (what a read before the wait, or
    through a cache that missed pass 1's writes, would take) gives the bits
    of a launch on a NaN-filled scratch, twice, within 1 ulp of the plain
    version."""
    from mrla_tpu_torch.kernels._build import library

    b, n, c = 128, 197, 384
    x, ot, packed = deit_tail_case(cuda, b, n, c)
    x2, ot2, _ = deit_tail_case(cuda, b, n, c)
    lib, ktap = library(), packed.taps.shape[1]
    scratch = torch.full(
        (b * lib.deit_token_tail_scratch_per_image(n, c, 16, ktap),),
        float("nan"), device="cuda")

    def launch(xs, ots):
        out = torch.empty_like(xs)
        assert lib.deit_token_tail_bf16(
            xs.data_ptr(), ots.data_ptr(), packed.vec.data_ptr(),
            packed.taps.data_ptr(), scratch.data_ptr(), out.data_ptr(), b, n,
            c, 16, ktap, torch.cuda.current_stream().cuda_stream) == 0
        return out

    first = launch(x, ot)
    other = launch(x2, ot2)  # the scratch now holds x2's gates and rows
    for _ in range(2):
        assert torch.equal(launch(x, ot), first)
        launch(x2, ot2)
    torch.cuda.synchronize()
    assert not torch.equal(other, first)
    _assert_ulps(first, deit_token_tail_reference(x, ot, packed), 1)


@pytest.mark.parametrize("b,n,c", [(128, 197, 384), (128, 197, 192),
                                   (128, 197, 768), (128, 577, 768),
                                   (3, 17, 128), (1, 577, 1024)])
def test_deit_tail_describe(cuda, b, n, c):
    """The launch deit_token_tail_describe reports: a pass-2 block a row of
    C / 8 threads, blocks that cover the B * S grid rows once, a pass-1
    block of whole warps, both passes resident."""
    import ctypes

    from mrla_tpu_torch.kernels._build import check, library

    out = (ctypes.c_int * 15)()
    check(library().deit_token_tail_describe(b, n, c, ctypes.addressof(out)),
          "deit_token_tail_describe")
    s = math.isqrt(n - 1)
    threads, rows, blocks, ring, pass1_threads = out[10:15]
    assert threads == rows * (c // 8) <= 256 and rows >= 1
    assert blocks == -(-(b * s) // rows) and ring >= 2
    assert pass1_threads % 32 == 0 and 32 <= pass1_threads <= 1024
    assert out[4] >= 1 and out[9] >= 1  # blocks an SM, each pass


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


def _roi_check(feats, rois, valid, strides, o, sr, max_grid=None,
               finest=56.0):
    """The wrapper against the plain version in fp32 (1 bf16 ulp at
    max|out| for bf16, 196 fp32 roundings of max|feature| for fp32); two
    launches of the C entry point over NaN-filled outputs must write every
    element and give the same bits."""
    from mrla_tpu_torch.detect.roi_align import (
        roi_align_reference,
        roi_geometry,
    )
    from mrla_tpu_torch.kernels import roi_align_patch
    from mrla_tpu_torch.kernels._build import check
    from mrla_tpu_torch.kernels.roialign_patch import launch_fwd

    got = roi_align_patch(feats, rois, valid, strides, o, sr, finest,
                          max_grid)
    geom, smax = roi_geometry(rois, valid, [f.shape[1:3] for f in feats],
                              strides, o, sr, finest, max_grid)
    want = roi_align_reference([f.float() for f in feats], geom, o, smax)
    if feats[0].dtype == torch.bfloat16:
        _assert_ulps(got, want, 1)
    else:
        tol = 196 * 2.0 ** -24 * max(f.abs().max().item() for f in feats)
        assert (got - want).abs().max().item() <= tol
    runs = []
    for _ in range(2):
        out = torch.full_like(got, float("nan"))
        check(launch_fwd(feats, geom, out, smax), "roi_align_fwd")
        torch.cuda.synchronize()
        runs.append(out)
    assert not runs[0].isnan().any()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], got)
    return got, want


# the separable kernel's hard cases on the detection path's pyramid: rois
# clamped to the whole top level (P5 is 25 x 42), point-like rois (each
# 2 x 2 cells take every bin), rois wider than 56 cells (on P2: 400 x 12
# px), bf16 and fp32, at 7 x 7 and 14 x 14
@pytest.mark.parametrize("case", ["top_level", "points", "wide"])
@pytest.mark.parametrize("o,dtype", [(7, torch.bfloat16), (14, torch.bfloat16),
                                     (7, torch.float32)])
def test_roi_align_kernel_hard_rois(cuda, case, o, dtype):
    feats, rois, valid = _roi_case(cuda, 2, 24, 256, dtype=dtype)
    u = torch.rand(2, 24, 2, generator=cuda, device="cuda")
    if case == "top_level":  # the whole canvas and more: level 3, clamped
        rois[:] = torch.tensor([-8.0, -8.0, 1352.0, 808.0], device="cuda")
        rois[:, 1::2, 2:] -= u[:, 1::2] * 300  # big enough for level 3
    elif case == "points":
        xy = u * torch.tensor([1344.0, 800.0], device="cuda")
        rois[:] = torch.cat([xy, xy + 0.25], -1)
    else:  # wider than 56 cells on P2, and tall ones
        x0 = u[..., 0] * 900
        y0 = u[..., 1] * 780
        rois[:] = torch.stack([x0, y0, x0 + 400.0, y0 + 12.0], -1)
        rois[:, 1::2] = torch.stack([y0[:, 1::2], x0[:, 1::2] * 0.5,
                                     y0[:, 1::2] + 12.0,
                                     x0[:, 1::2] * 0.5 + 300.0], -1)
    valid[:, 0] = False
    got, _ = _roi_check(feats, rois, valid, (4, 8, 16, 32), o, 0)
    assert torch.count_nonzero(got[:, 0]) == 0  # invalid rows are zero
    if case == "wide":
        from mrla_tpu_torch.detect.roi_align import map_roi_levels

        assert (map_roi_levels(rois[valid], 4) == 0).all()


def test_roi_align_kernel_gt_crop_form(cuda):
    """The gt mask crop as training runs it: one level at stride 1 (the
    masks of an 800 x 800 canvas as C = 32 fp32 channels), 28 x 28 bins,
    a 1 x 1 grid, every roi on the one level."""
    masks = (torch.rand(2, 800, 800, 32, generator=cuda, device="cuda")
             > 0.5).float()
    u = torch.rand(2, 64, 4, generator=cuda, device="cuda")
    xy = u[..., :2] * 700
    wh = 4 + u[..., 2:] * 300
    rois = torch.cat([xy, xy + wh], -1)
    _roi_check([masks], rois, None, (1,), 28, 1, finest=1e9)


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


def _mrlab_case(layers, seed=0):
    """A small resnet_mrlab with bn3 and bn_mrla scales from U(0.1, 0.5) and
    running variances from U(0.5, 1.5), and 4 seeded 64 px images."""
    from mrla_tpu_torch.models import ResNetMRLABase

    gen = torch.Generator().manual_seed(seed)
    model = ResNetMRLABase(list(layers), num_classes=10,
                           generator=gen).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.1, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return model, torch.randn(4, 64, 64, 3, generator=gen)


@pytest.mark.parametrize("use_scan", [False, True])
def test_mrlab_engine_on_the_card_matches_the_cpu(cuda, use_scan,
                                                  monkeypatch):
    """The eq. 6 engine in fp32 on the card against the CPU, in either
    cache form, launching none of the port's kernels; each stage's cache
    buffers are allocated once, and the slots not yet written (filled with
    NaN here) never reach the logits."""
    import mrla_tpu_torch.serving.resnet_mrlab as engine
    from mrla_tpu_torch.ops import cache_buffers
    from mrla_tpu_torch.serving import (
        prepare_mrlab_inference_params,
        resnet_mrlab_forward,
    )

    layers = (2, 3, 2, 2)
    model, x = _mrlab_case(layers)
    want = resnet_mrlab_forward(
        prepare_mrlab_inference_params(model, layers, torch.float32, "cpu"),
        x, layers, use_scan=use_scan)
    made = []

    def nan_buffers(*args):
        made.append(args)
        return tuple(b.fill_(float("nan")) for b in cache_buffers(*args))

    monkeypatch.setattr(engine, "cache_buffers", nan_buffers)
    params = prepare_mrlab_inference_params(model, layers, torch.float32,
                                            "cuda")
    fused_epilogue.counter.reset()
    mrla_block_tail_fused_next.counter.reset()
    got = resnet_mrlab_forward(params, x.cuda(), layers,
                               use_scan=use_scan).cpu()
    assert [a[1] for a in made] == list(layers)
    assert all(a[-1].type == "cuda" for a in made)
    assert fused_epilogue.counter.calls == 0
    assert mrla_block_tail_fused_next.counter.calls == 0
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=2e-3, atol=3e-4)



def _no_kernel_counters():
    from mrla_tpu_torch.kernels import (
        fused_block_tail,
        hwbc_copy,
        mrla_block_tail_hwbc,
        mrla_rowtail,
        roi_align_patch,
    )

    return [c.counter for c in (
        fused_epilogue, mrla_block_tail_fused_next, stage4_resident,
        deit_token_tail, roi_align_patch, fused_block_tail,
        mrla_block_tail_hwbc, mrla_rowtail, hwbc_copy)]


@pytest.mark.parametrize("fused", [False, True])
def test_classification_train_step_on_the_card(cuda, fused):
    """One SGD + label-smoothing step of a (1, 1, 1, 1) resnet_mrlal (bn3
    scales drawn from U(0.1, 0.5)) on the card against the same step on
    the CPU, fp32: the loss, every parameter and running statistic at the
    JAX parity tolerances; the step launches none of the port's kernels."""
    from mrla_tpu_torch.models import ResNetMRLALight
    from mrla_tpu_torch.train import (
        create_train_state,
        label_smoothing_ce,
        train_step,
    )
    from mrla_tpu_torch.train.optim import sgd_torch

    gen = torch.Generator().manual_seed(0)
    model = ResNetMRLALight([1, 1, 1, 1], num_classes=10, generator=gen,
                            fused_epilogue=fused)
    with torch.no_grad():
        for name, m in model.named_modules():
            if name.endswith("bn3"):
                m.weight.uniform_(0.1, 0.5, generator=gen)
    batch = {"image": torch.randn(4, 64, 64, 3, generator=gen),
             "label": torch.arange(4) % 10}
    out = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev)
        state = create_train_state(m, sgd_torch(m.parameters(), 0.05, 0.9,
                                                1e-4), lambda s: 0.05)
        for c in _no_kernel_counters():
            c.reset()
        met = train_step(state, {k: v.to(dev) for k, v in batch.items()},
                         lambda lo, la: label_smoothing_ce(lo, la, 0.1))
        assert all(c.calls == 0 for c in _no_kernel_counters())
        out[dev] = (met["loss"].item(), {k: v.cpu() for k, v in
                                         m.state_dict().items()})
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * out["cpu"][0]
    for k, v in out["cuda"][1].items():
        tol = (dict(rtol=1e-4, atol=1e-5) if "running" in k
               else dict(rtol=5e-4, atol=5e-5))
        torch.testing.assert_close(v, out["cpu"][1][k], **tol)


def test_fused_train_epilogue_on_the_card(cuda):
    """The fused train epilogue on the card against autograd through the
    module path's composition on the card, fp32: (ret, mean, var) and
    every input's gradient at the JAX package's tolerances; in bf16 the
    same op gives finite outputs and gradients."""
    from mrla_tpu_torch.ops import MRLAParams
    from mrla_tpu_torch.ops.fused_train import (
        fused_epilogue_module_equivalent,
        fused_light_epilogue_train,
    )

    b, h, w, c, heads = 4, 14, 14, 256, 8
    rnd = lambda *s: torch.randn(*s, generator=cuda, device="cuda")  # noqa
    base = [rnd(b, h, w, c).relu_(), rnd(b, h, w, c), rnd(1, 1, 5) * 0.3,
            rnd(1, 1, 5) * 0.3, rnd(c, 1, 3, 3) * 0.3, rnd(c) * 0.5,
            rnd(c) * 0.2 + 1.0, rnd(c) * 0.2]

    def loss(ret, mean, var):
        return (ret ** 2).sum() + (mean * 0.1).sum() + (var * 0.05).sum()

    fused = [t.clone().requires_grad_() for t in base]
    plain = [t.clone().requires_grad_() for t in base]
    got = fused_light_epilogue_train(*fused, heads)
    o, i, q, k, v, lam, s, bias = plain
    want = fused_epilogue_module_equivalent(o, i, MRLAParams(q, k, v), lam,
                                            s, bias, heads)
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
    loss(*got).backward()
    loss(*want).backward()
    for a, r in zip(fused, plain):
        torch.testing.assert_close(a.grad, r.grad, rtol=2e-4, atol=2e-4)
    half = [t.clone() for t in base]
    half[0], half[1] = half[0].bfloat16(), half[1].bfloat16()
    for t in half:
        t.requires_grad_()
    loss(*fused_light_epilogue_train(*half, heads)).backward()
    assert all(torch.isfinite(t.grad).all() for t in half)


@pytest.mark.parametrize("arch", ["efficientnet_mrlal_b0",
                                  "resnext50_32x4d_se"])
def test_precast_engine_on_the_card_matches_the_cpu(cuda, arch):
    """The generic engine in fp32 on the card against the CPU at bs4
    (seeded stand-ins, 64 px), launching none of the port's kernels; in
    bf16 on the card its logits are finite."""
    from mrla_tpu_torch.serving import (
        precast_forward,
        prepare_precast_inference_params,
    )
    from mrla_tpu_torch.testing import images, zoo_serving_model

    model = zoo_serving_model(arch, 0, px=64)
    x = images(torch.Generator().manual_seed(1), 4, 64)
    want = precast_forward(prepare_precast_inference_params(
        model, device="cpu", dtype=torch.float32), x)
    for c in _no_kernel_counters():
        c.reset()
    got = precast_forward(prepare_precast_inference_params(
        model, device="cuda", dtype=torch.float32), x.cuda()).cpu()
    served = prepare_precast_inference_params(model, device="cuda")
    bf16 = precast_forward(served, x.cuda())
    assert all(c.calls == 0 for c in _no_kernel_counters())
    torch.testing.assert_close(got, want, rtol=2e-3, atol=3e-4)
    assert torch.isfinite(bf16).all() and bf16.dtype == torch.float32


def test_efficientnet_train_step_on_the_card(cuda):
    """One RMSpropTF + label-smoothing step of a seeded
    efficientnet_mrlal_b0 (64 px, bs4, fp32) on the card against the CPU:
    the loss, every parameter and running statistic at the JAX parity
    tolerances; no kernel of the port launches."""
    from mrla_tpu_torch.testing import images, zoo_serving_model
    from mrla_tpu_torch.train import (
        create_train_state,
        label_smoothing_ce,
        train_step,
    )
    from mrla_tpu_torch.train.optim import rmsprop_tf

    model = zoo_serving_model("efficientnet_mrlal_b0", 0, px=64,
                              num_classes=10)
    batch = {"image": images(torch.Generator().manual_seed(2), 4, 64),
             "label": torch.arange(4) % 10}
    out = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev)
        state = create_train_state(
            m, rmsprop_tf(m.parameters(), 0.048, weight_decay=1e-5),
            lambda s: 0.048)
        for c in _no_kernel_counters():
            c.reset()
        met = train_step(state, {k: v.to(dev) for k, v in batch.items()},
                         lambda lo, la: label_smoothing_ce(lo, la, 0.1))
        assert all(c.calls == 0 for c in _no_kernel_counters())
        out[dev] = (met["loss"].item(), {k: v.cpu() for k, v in
                                         m.state_dict().items()})
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * out["cpu"][0]
    for k, v in out["cuda"][1].items():
        tol = (dict(rtol=1e-4, atol=1e-5) if "running" in k
               else dict(rtol=5e-4, atol=5e-5))
        torch.testing.assert_close(v, out["cpu"][1][k], **tol, msg=k)


def _jpeg_tree(root, per_class, seed=0):
    """Smooth seeded JPEGs of two sizes under root/class_<c>/."""
    import os

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    for c, n in enumerate(per_class):
        os.makedirs(root / f"class_{c}")
        for i in range(n):
            coarse = rng.integers(0, 256, (4, 5, 3)).astype(np.uint8)
            size = (75, 50) if (c + i) % 2 else (48, 64)
            Image.fromarray(coarse).resize(size, Image.BICUBIC).save(
                root / f"class_{c}" / f"{i}.jpg", quality=90)
    return str(root)


@pytest.mark.parametrize("interpolation", ["bilinear", "bicubic"])
def test_imagefolder_decoder_on_the_card_matches_its_plain_version(
        cuda, tmp_path, interpolation):
    """The loader, threaded as the trainer runs it, against the same
    decoder image by image (bitwise), and the card's normalisation of its
    batch against the host's."""
    import numpy as np

    from mrla_tpu_torch.data import (
        ImageFolder,
        choose_decoder,
        iterate_batches,
        native,
        normalize,
    )

    ds = ImageFolder(_jpeg_tree(tmp_path, [5, 4]))
    decoder = choose_decoder(ds, interpolation)
    assert decoder == ("native" if interpolation == "bilinear"
                       and native.available() else "pil")
    idx = np.random.default_rng(0).permutation(len(ds))
    for train in (True, False):
        batches = list(iterate_batches(ds, idx, 4, 40, train=train, seed=3,
                                       num_threads=3,
                                       interpolation=interpolation))
        assert [len(b["label"]) for b in batches] == (
            [4, 4] if train else [4, 4, 1])
        for bi, b in enumerate(batches):
            assert b["decoder"] == decoder
            ids = idx[bi * 4:(bi + 1) * 4]
            if decoder == "native":
                want = native.decode_batch([ds.samples[i][0] for i in ids],
                                           40, train, seed=3 * 1_000_003
                                           + bi, num_threads=1)
            else:
                rng = np.random.default_rng((3, bi))
                want = np.stack([ds.load_train(i, 40, rng, interpolation)
                                 if train else
                                 ds.load_eval(i, 40, interpolation)
                                 for i in ids])
            np.testing.assert_array_equal(b["image"], want)
            x = torch.from_numpy(b["image"])
            torch.testing.assert_close(normalize(x.cuda()).cpu(),
                                       normalize(x), rtol=0, atol=1e-5)


def test_classification_cli_on_an_imagefolder_on_the_card(cuda, tmp_path):
    """The trainer on a JPEG tree on the card: finite losses, the decoder
    of every batch, each val image counted once (a ragged last batch), no
    kernel of the port."""
    from mrla_tpu_torch.data import native
    from mrla_tpu_torch.train import cli

    root = tmp_path / "tree"
    _jpeg_tree(root / "train", [6, 6])
    _jpeg_tree(root / "val", [3, 2], seed=1)
    for c in _no_kernel_counters():
        c.reset()
    res = cli.main(["-a", "resnet50_mrlal", "--layers", "1", "1", "1", "1",
                    "--data", str(root), "--image-size", "32",
                    "--num-classes", "2", "-b", "4", "--epochs", "1",
                    "--workers", "2", "--random-erase", "0.25", "--mixup",
                    "0.8", "--device", "cuda", "--output-dir",
                    str(tmp_path / "run")])
    assert all(c.calls == 0 for c in _no_kernel_counters())
    assert len(res["loss"]) == 3 and all(map(math.isfinite, res["loss"]))
    want = "native" if native.available() else "pil"
    assert res["decoders"] == {"train": [want] * 3, "val": [want] * 2}
    assert res["val_count"] == 5


def test_retinanet_forward_and_decode_on_the_card(cuda):
    """A (1, 1, 1, 1) RetinaNet in fp32 (TF32 off) on the card against the
    CPU: every level's maps, and get_bboxes on the card of the CPU's maps
    against get_bboxes on the CPU (the same detections).  No kernel of the
    port launches on this path."""
    import copy

    from mrla_tpu_torch.detect.retinanet import get_bboxes
    from mrla_tpu_torch.kernels import fused_epilogue, roi_align_patch
    from mrla_tpu_torch.testing import images, training_retinanet

    model = training_retinanet(0, (1, 1, 1, 1), 3, px=(96, 128))
    x = images(torch.Generator().manual_seed(1), 2, (96, 128))
    with torch.no_grad():
        want = model(x)
        card = copy.deepcopy(model).cuda()
        roi_align_patch.counter.reset()
        fused_epilogue.counter.reset()
        got = card(x.cuda())
        dets = get_bboxes([(c.cuda(), r.cuda()) for c, r in want], (96, 128))
    torch.cuda.synchronize()
    assert roi_align_patch.counter.launches == 0
    assert fused_epilogue.counter.launches == 0
    for (gc, gr), (wc, wr) in zip(got, want):
        for g, w in ((gc, wc), (gr, wr)):
            assert (g.cpu() - w).norm() <= 1e-4 * w.norm()
    ref = get_bboxes(want, (96, 128))
    assert torch.equal(dets[3].cpu(), ref[3]) and ref[3].any()
    assert torch.equal(dets[2].cpu(), ref[2])
    assert (dets[0].cpu() - ref[0]).abs().max() <= 1e-4 * ref[0].abs().max()


def test_retinanet_loss_on_the_card(cuda):
    """retinanet_loss and its gradient to the head outputs on the card
    against the CPU (fp32 sums in another order)."""
    from mrla_tpu_torch.detect.losses import retinanet_loss

    gen = torch.Generator().manual_seed(3)
    sizes = [(12, 16), (6, 8), (3, 4), (2, 2), (1, 1)]
    outs = [(2 * torch.randn(2, h, w, 27, generator=gen) - 2,
             0.3 * torch.randn(2, h, w, 36, generator=gen)) for h, w in sizes]
    xy = torch.rand(2, 5, 2, generator=gen) * torch.tensor([128.0, 96.0])
    gt = torch.cat([xy, xy + 8 + 50 * torch.rand(2, 5, 2, generator=gen)], -1)
    labels = torch.randint(0, 3, (2, 5), generator=gen)
    valid = torch.ones(2, 5, dtype=torch.bool)
    valid[0, 3:] = False
    res = []
    for dev in ("cpu", "cuda"):
        leaves = [(c.to(dev).requires_grad_(), r.to(dev).requires_grad_())
                  for c, r in ((c.clone(), r.clone()) for c, r in outs)]
        out = retinanet_loss(leaves, gt.to(dev), labels.to(dev),
                             valid.to(dev), 3)
        out["loss"].backward()
        res.append((out, [g.grad.cpu() for pair in leaves for g in pair]))
    (want, wg), (got, gg) = res
    assert int(got["num_pos"]) == int(want["num_pos"]) > 0
    for k in ("loss_cls", "loss_bbox"):
        assert abs(got[k].item() - want[k].item()) <= 1e-5 * want[k].item()
    for g, w in zip(gg, wg):
        assert (g - w).norm() <= 1e-5 * w.norm() + 1e-12


def test_retinanet_pyramid_routes_through_the_kernels(cuda):
    """detect_forward with RetinaNet's neck (start_level=1, on_input) at
    256 x 384: the trunk's tails through the kernels (mega-tail and
    epilogue launches), P3..P7 against the module's fp32 pyramid."""
    from mrla_tpu_torch.kernels import (
        fused_epilogue,
        mrla_block_tail_fused_next,
    )
    from mrla_tpu_torch.serving import detect_forward, prepare_detect_params
    from mrla_tpu_torch.testing import images, training_retinanet

    model = training_retinanet(0, (1, 1, 1, 1), 3, px=(96, 128))
    x = images(torch.Generator().manual_seed(2), 2, (256, 384))
    with torch.no_grad():
        want = model.neck(model.backbone(x))
    params = prepare_detect_params(model, (1, 1, 1, 1))
    fused_epilogue.counter.reset()
    mrla_block_tail_fused_next.counter.reset()
    got = detect_forward(params, x.cuda(), (1, 1, 1, 1), start_level=1,
                         add_extra_convs="on_input")
    torch.cuda.synchronize()
    assert (fused_epilogue.counter.launches
            + mrla_block_tail_fused_next.counter.launches) == 4
    assert [tuple(p.shape[1:3]) for p in got] == [
        (32, 48), (16, 24), (8, 12), (4, 6), (2, 3)]
    for g, w in zip(got, want):
        assert (g.float().cpu() - w).norm() <= 0.08 * w.norm()


def test_detection_trainer_on_coco_on_the_card(cuda, tmp_path):
    """The trainer on a seeded COCO-format tree on the card: one RetinaNet
    epoch, then --eval-only --resume over the whole val split (3 images,
    batch 2: the padded row skipped) with the run's mAP."""
    import json

    from mrla_tpu_torch.detect import train_cli
    from mrla_tpu_torch.testing import write_coco_split

    (ta, ti), (va, vi) = (write_coco_split(
        str(tmp_path), split, n, [(60, 80), (80, 60)], (7, 13, 90), seed)
        for split, n, seed in (("train", 4, 0), ("val", 3, 1)))
    argv = ["--device", "cuda", "--preset", "retinanet_r50mrlal_fpn_1x_coco",
            "--data", "coco", "--train-ann", ta, "--train-imgs", ti,
            "--val-ann", va, "--val-imgs", vi, "--img-size", "128", "192",
            "--backbone-layers", "1", "1", "1", "1", "--num-classes", "3",
            "--batch-size", "2", "--epochs", "1", "--output-dir",
            str(tmp_path / "run")]
    res = train_cli.main(argv)
    line = json.loads(open(tmp_path / "run" / "log.jsonl").readline())
    assert len(res["loss"]) == 2 and all(math.isfinite(v)
                                          for v in res["loss"])
    ev = train_cli.main(argv + ["--eval-only", "--resume",
                                str(tmp_path / "run")])
    assert ev["val_count"] == line["val_count"] == 3
    assert ev["mAP"] == line["mAP"]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_init_distributed_on_nccl_at_world_1(cuda, monkeypatch, tmp_path):
    """The launch environment of one rank: NCCL on cuda:0, an all-reduce
    of a CUDA tensor, and the classification trainer's step through DDP;
    the group is left again on return."""
    import torch.distributed as dist

    from mrla_tpu_torch.parallel import (
        global_sum,
        init_distributed,
        initialized,
    )
    from mrla_tpu_torch.train import cli

    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    info = init_distributed(device="cuda")
    try:
        assert info["process_count"] == 1 and dist.get_backend() == "nccl"
        t = torch.arange(4.0, device="cuda")
        dist.all_reduce(t)
        assert torch.equal(t, torch.arange(4.0, device="cuda"))
        assert torch.equal(global_sum(t), t)
    finally:
        dist.destroy_process_group()
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    res = cli.main(["-a", "resnet50_mrlal", "--layers", "1", "1", "1", "1",
                    "--image-size", "32", "--num-classes", "3", "-b", "4",
                    "--synthetic-steps", "2", "--epochs", "1",
                    "--output-dir", str(tmp_path)])
    assert len(res["loss"]) == 2 and all(map(math.isfinite, res["loss"]))
    assert res["state"].ddp is not None and not initialized()


def _rank_variants(tmp_path, step, spec, names):
    from mrla_tpu_torch.parallel import checks
    from mrla_tpu_torch.parallel.spawn import run_ranks

    return run_ranks(checks.variants, 2, str(tmp_path),
                     args=(step, spec, names, "cuda:0"), timeout=300)


def test_global_batch_norm_through_gloo_on_the_card(cuda, tmp_path):
    """Two gloo ranks sharing cuda:0: a BN stack on CUDA tensors at 2 ranks
    against 1 rank on the global batch on the card (output, input gradient,
    weight gradients, running statistics); per-replica BN fails."""
    from mrla_tpu_torch.parallel import checks

    gen = torch.Generator().manual_seed(0)
    spec = {"seed": 3, "x": torch.randn(8, 64, 7, 7, generator=gen) * 2 + 1,
            "cot": torch.randn(8, 64, 7, 7, generator=gen)}
    want = checks.bn_step(spec, device="cuda")
    ranks = _rank_variants(tmp_path, checks.bn_step, spec,
                           ("global", "replica_bn"))
    tol = dict(rtol=1e-4, atol=1e-5)
    for k in ("y", "dx"):
        got = torch.cat([r["global"][k] for r in ranks])
        torch.testing.assert_close(got, want[k], **tol)
        bad = torch.cat([r["replica_bn"][k] for r in ranks])
        assert not torch.allclose(bad, want[k], **tol), k
    for r in ranks:
        for k, v in want["grads"].items():
            torch.testing.assert_close(r["global"]["grads"][k], v, **tol)
        for k, v in want["buffers"].items():
            torch.testing.assert_close(r["global"]["buffers"][k], v, **tol)


def test_per_rank_normaliser_fault_fails_on_the_card(cuda, tmp_path):
    """A small RetinaNet step at two gloo ranks on cuda:0 against one rank
    on the global batch on the card: num_pos exact, the loss and every
    gradient within the CPU test's limits; a per-rank avg_factor fails."""
    from mrla_tpu_torch.detect.retinanet import RetinaNet
    from mrla_tpu_torch.parallel import checks

    gen = torch.Generator().manual_seed(0)
    model = RetinaNet(layers=(1, 1, 1, 1), num_classes=4, generator=gen)
    xy = torch.rand(8, 2, 2, generator=gen) * 20 + 4
    wh = torch.rand(8, 2, 2, generator=gen) * 20 + 12
    spec = {"kind": "retinanet",
            "model": {"layers": (1, 1, 1, 1), "num_classes": 4},
            "state_dict": model.state_dict(), "norm_eval": False, "lr": 0.01,
            "batch": {"image": torch.randn(8, 64, 64, 3, generator=gen),
                      "gt_boxes": torch.cat([xy, xy + wh], -1),
                      "gt_labels": torch.randint(0, 4, (8, 2), generator=gen),
                      "gt_valid": torch.ones(8, 2, dtype=torch.bool)}}
    want = checks.detection_step(spec, device="cuda")
    ranks = _rank_variants(tmp_path, checks.detection_step, spec,
                           ("global", "replica_norm"))
    tol = dict(rtol=5e-3, atol=2e-4)
    sound, fault = ranks[0]["global"], ranks[0]["replica_norm"]
    assert sound["terms"]["num_pos"] == want["terms"]["num_pos"] > 0
    assert abs(sound["terms"]["loss"] - want["terms"]["loss"]) <= \
        1e-4 * want["terms"]["loss"]
    for k, v in want["grads"].items():
        torch.testing.assert_close(sound["grads"][k], v, **tol)
    assert abs(fault["terms"]["loss"] - want["terms"]["loss"]) > \
        1e-4 * want["terms"]["loss"]
    assert ranks[1]["global"]["same"]


def test_int8_product_on_the_card_is_exact_and_refuses_bad_shapes(cuda):
    """torch._int_mm (cuBLASLt) is exact in int32; shapes it does not take
    raise (no fallback)."""
    from mrla_tpu_torch.serving.quant import _int_mm

    a = torch.randint(-127, 128, (100, 2048), dtype=torch.int8,
                      device="cuda", generator=cuda)
    w = torch.randint(-127, 128, (64, 2048), dtype=torch.int8,
                      device="cuda", generator=cuda)
    got = _int_mm(a, w).cpu()
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), a.cpu().long() @ w.cpu().long().t())
    for m, k, n in [(16, 64, 64), (32, 60, 64), (32, 64, 60)]:
        with pytest.raises(ValueError, match="M > 16"):
            _int_mm(torch.zeros(m, k, dtype=torch.int8, device="cuda"),
                    torch.zeros(n, k, dtype=torch.int8, device="cuda"))


def test_quant_engine_on_the_card_matches_the_cpu(cuda):
    """prepare_quant_params and resnet_mrlal_quant_forward on the card
    against the CPU on the same tree: the bf16 epilogue through the
    kernel, one launch a block a chain; logits within 0.02 of their
    scale."""
    from mrla_tpu_torch.models import ResNetMRLALight
    from mrla_tpu_torch.serving.quant import (
        prepare_quant_params,
        resnet_mrlal_quant_forward,
    )

    layers = (1, 1, 1, 1)
    model = ResNetMRLALight(layers, num_classes=10,
                            generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    calib = torch.randn(16, 64, 64, 3, generator=g)
    x = torch.randn(32, 64, 64, 3, generator=g)
    qp_cpu = prepare_quant_params(model, calib, layers, device="cpu")
    qp = prepare_quant_params(model, calib.cuda(), layers, device="cuda")
    for qres in (False, True):
        ref = resnet_mrlal_quant_forward(qp_cpu, x, layers, microbatch=16,
                                         quant_residual=qres).numpy()
        fused_epilogue.counter.reset()
        got = resnet_mrlal_quant_forward(qp, x.cuda(), layers, microbatch=16,
                                         quant_residual=qres).cpu().numpy()
        assert fused_epilogue.counter.launches == 2 * sum(layers)
        scale = abs(ref).max()
        assert abs(got - ref).max() < 0.02 * scale


def test_batching_daemon_on_the_card(cuda):
    """The daemon's flusher and completer threads on the card: the rows of
    a padded bf16 batch are the engine's own forward of them."""
    import io
    import json
    import threading
    import urllib.request

    import numpy as np

    from mrla_tpu_torch.models import ResNetMRLALight
    from mrla_tpu_torch.serving.server import build_server

    model = ResNetMRLALight((1, 1, 1, 1), num_classes=10,
                            generator=torch.Generator().manual_seed(0))
    httpd, beng = build_server("resnet50_mrlal", None, batch_size=8,
                               image_size=64, num_classes=10, port=0,
                               device="cuda", model=model)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        imgs = np.random.default_rng(0).standard_normal(
            (3, 64, 64, 3)).astype(np.float32)
        buf = io.BytesIO()
        np.save(buf, imgs)
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/predict",
            data=buf.getvalue(), method="POST",
            headers={"Content-Type": "application/x-npy"})
        with urllib.request.urlopen(req, timeout=120) as r:
            got = np.asarray(json.loads(r.read())["predictions"])
        x = torch.from_numpy(np.concatenate([imgs] + [imgs[:1]] * 5))
        want = beng.fwd(x.to("cuda", torch.bfloat16)).cpu().numpy()[:3]
        assert abs(got - want).max() <= 0.05 * abs(want).max()
        assert beng.stats == {"requests": 3, "batches": 1, "padded_rows": 5}
    finally:
        httpd.shutdown()
        httpd.server_close()
        beng.close()


def test_hub_load_on_the_card(cuda):
    from mrla_tpu_torch import hub

    model, sd = hub.load("resnet50_mrlal", device="cuda")
    assert sd["fc.weight"].device.type == "cuda"
    with torch.inference_mode():
        out = model(torch.randn(2, 224, 224, 3, device="cuda",
                                generator=cuda))
    assert out.shape == (2, 1000) and torch.isfinite(out).all()
