"""The port's detection serving path against the JAX package, in fp32 on the
CPU: the pyramid export (``detect_forward``), the whole two-stage path
(``two_stage_detections`` against ``two_stage_predict``), and the
engine's mega-tail route at detection widths.

Weights are the port's own seeded init, carried to Flax by the JAX
package's converters; BN statistics are perturbed so that folding does
work.  Tolerances follow the JAX package's serving tests (rtol 2e-3,
atol 3e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mrla_tpu_torch.serving.resnet_mrlal as engine
from mrla_tpu.ckpt.detect_convert import (
    convert_mmdet_state_dict,
    convert_mmdet_two_stage,
)
from mrla_tpu.detect import MRLABackboneFPN as JBackboneFPN
from mrla_tpu.detect import two_stage as j_two
from mrla_tpu.serving import detect_forward as j_detect_forward
from mrla_tpu.serving import prepare_detect_params as j_prepare
from mrla_tpu_torch.detect import MRLABackboneFPN
from mrla_tpu_torch.detect.two_stage import FasterRCNN, MaskRCNN
from mrla_tpu_torch.kernels import fused_epilogue
from mrla_tpu_torch.models import ResNetMRLALight
from mrla_tpu_torch.serving import (
    detect_forward,
    prepare_detect_params,
    prepare_inference_params,
    resnet_mrlal_forward,
    two_stage_detections,
)
from mrla_tpu_torch.testing import spread_detector_weights
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

RTOL, ATOL = 2e-3, 3e-4
LAYERS = (1, 1, 1, 1)


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    with jax.default_matmul_precision("float32"):
        yield


def _perturb_bn(model, gen):
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.1, 0.5, generator=gen)
                m.running_mean.normal_(0.0, 0.3, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return model


def _images(seed, b=2, hw=(64, 64)):
    return np.random.default_rng(seed).standard_normal(
        (b, *hw, 3)).astype(np.float32)


def test_detect_forward_matches_jax():
    gen = torch.Generator().manual_seed(0)
    model = _perturb_bn(MRLABackboneFPN(LAYERS, generator=gen), gen).eval()
    v = convert_mmdet_state_dict(model.state_dict())
    x = _images(1)
    want_engine = j_detect_forward(j_prepare(v, layers=LAYERS,
                                             dtype=jnp.float32),
                                   jnp.asarray(x), layers=LAYERS)
    want_module = JBackboneFPN(layers=LAYERS).apply(
        {"params": v["params"], "batch_stats": v["batch_stats"]},
        jnp.asarray(x), train=False)
    params = prepare_detect_params(model, LAYERS, torch.float32, "cpu")
    got = detect_forward(params, torch.from_numpy(x), LAYERS)
    with torch.no_grad():
        got_module = model(torch.from_numpy(x))
    assert len(got) == len(want_engine) == 5
    for g, gm, we, wm in zip(got, got_module, want_engine, want_module):
        np.testing.assert_allclose(g.numpy(), np.asarray(we), RTOL, ATOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(wm), RTOL, ATOL)
        np.testing.assert_allclose(gm.numpy(), np.asarray(wm), RTOL, ATOL)


def test_detect_params_need_a_card_unless_asked():
    model = MRLABackboneFPN(LAYERS).eval()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prepare_detect_params(model, LAYERS)


@pytest.mark.parametrize("preset", ["faster_rcnn_r50mrlal_fpn_1x_coco",
                                    "mask_rcnn_r50mrlal_fpn_1x_coco"])
def test_two_stage_detections_match_jax(preset):
    """The served path (BN-folded trunk, pre-cast heads) against the JAX
    package's two_stage_predict on the same weights: the same detections
    (valid, labels) and boxes, scores and masks within tolerance."""
    mask = preset.startswith("mask")
    gen = torch.Generator().manual_seed(1)
    kw = dict(layers=LAYERS, num_classes=4, rpn_nms_pre=100,
              num_proposals=20, roi_sampling_ratio=0)
    model = _perturb_bn((MaskRCNN if mask else FasterRCNN)(generator=gen,
                                                           **kw), gen).eval()
    spread_detector_weights(model, gen, px=(128, 160))
    v = convert_mmdet_two_stage(model.state_dict())
    jm = (j_two.MaskRCNN if mask else j_two.FasterRCNN)(**kw)
    x = _images(2, hw=(128, 160))
    want = jax.jit(lambda v, x: j_two.two_stage_predict(
        jm, v, x, max_per_img=10))(v, jnp.asarray(x))
    params = prepare_detect_params(model, LAYERS, torch.float32, "cpu")
    got = two_stage_detections(params, torch.from_numpy(x), preset,
                               max_per_img=10, num_proposals=20,
                               rpn_nms_pre=100, layers=LAYERS)
    names = ["det_boxes", "det_scores", "det_labels", "det_valid"]
    assert len(got) == 4 + mask
    assert got[3].sum() > 0
    np.testing.assert_array_equal(got[3].numpy(),
                                  np.asarray(want["det_valid"]))
    np.testing.assert_array_equal(got[2].numpy(),
                                  np.asarray(want["det_labels"]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[names[0]]),
                               1e-4, 1e-3)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[names[1]]),
                               RTOL, ATOL)
    if mask:
        assert got[4].shape == (2, 10, 28, 28)
        np.testing.assert_allclose(got[4].numpy(), np.asarray(want["masks"]),
                                   RTOL, ATOL)


def test_stage_hook_sees_the_served_pipeline():
    """A ``stage`` hook sees every stage of the served path in order, and
    a recorded stage run again on its inputs gives the served output."""
    gen = torch.Generator().manual_seed(2)
    model = MaskRCNN(layers=LAYERS, num_classes=3, generator=gen).eval()
    params = prepare_detect_params(model, LAYERS, torch.float32, "cpu")
    x = torch.from_numpy(_images(3))
    seen = []

    def record(name, fn, *args, **kw):
        out = fn(*args, **kw)
        seen.append((name, lambda: fn(*args, **kw), out))
        return out

    got = two_stage_detections(params, x, "mask_rcnn_r50mrlal_fpn_1x_coco",
                               num_proposals=20, rpn_nms_pre=100,
                               layers=LAYERS, stage=record)
    assert [n for n, _, _ in seen] == [
        "backbone", "FPN", "RPN head", "proposals (top-k, decode, NMS)",
        "RoIAlign 7x7", "box head", "decode + class-wise NMS",
        "RoIAlign 14x14", "mask head + select"]
    assert all(torch.equal(g, w) for g, w in zip(got[:4], seen[6][2]))
    assert torch.equal(got[4], seen[8][2])
    with torch.inference_mode():
        assert torch.equal(seen[4][1](), seen[4][2])


def test_mask_preset_needs_a_mask_head():
    model = FasterRCNN(layers=LAYERS, num_classes=3).eval()
    params = prepare_detect_params(model, LAYERS, torch.float32, "cpu")
    with pytest.raises(ValueError, match="mask head"):
        two_stage_detections(params, torch.zeros(1, 64, 64, 3),
                             "mask_rcnn_r50mrlal_fpn_1x_coco", layers=LAYERS)


# What the mega-tail kernel (csrc/mrla_megatail.cu) takes, from its source:
# C % 64 == 0, C1 in {64, 128, 256}, and a block's shared memory, a bf16 y
# tile [64, C], a ring of 3 W1 chunks [columns, 64] (128 columns above
# C = 256 where C1 % 128 == 0, else 64) and 1 KB to align them, within
# 232448 bytes.
def _kernel_takes(c, c1):
    cols = 128 if c > 256 and c1 % 128 == 0 else 64
    return (c % 64 == 0 and c1 in (64, 128, 256)
            and 2 * (64 * c + 3 * cols * 64) + 1024 <= 232448)


@pytest.mark.parametrize("width", [448, 896])
def test_megatail_route_stays_within_the_kernel(width, monkeypatch):
    """A full-width resnet50_mrlal trunk at a detection-sized width: every
    block whose map is 28 or more wide used to go to the mega-tail, which
    cannot take layer3_5 -> layer4_0 (C1 = 512) nor stage 4 (C = 2048; at
    896 px its map is 28 wide).  Each (C, C1) sent there must be one the
    kernel takes; the rest take the epilogue.  The table is the one the
    800 x 1344 detection path runs."""
    model = ResNetMRLALight([3, 4, 6, 3], num_classes=10,
                            generator=torch.Generator().manual_seed(2)).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.1, 0.5)
    params = prepare_inference_params(model, dtype=torch.float32,
                                      device="cpu")
    sent = []
    tail = engine.mrla_block_tail_fused_next

    def recording_tail(out, identity, gate, wv, lam, s, b, w1, b1):
        sent.append((out.shape[3], w1.shape[0]))
        return tail(out, identity, gate, wv, lam, s, b, w1, b1)

    monkeypatch.setattr(engine, "mrla_block_tail_fused_next", recording_tail)
    x = torch.randn(1, 32, width, 3,
                    generator=torch.Generator().manual_seed(3))
    fused_epilogue.counter.reset()
    got = resnet_mrlal_forward(params, x)
    refused = [s for s in sent if not _kernel_takes(*s)]
    assert not refused, f"sent to the mega-tail but not taken: {refused}"
    assert sent == ([(256, 64), (256, 64), (256, 128)]
                    + [(512, 128)] * 3 + [(512, 256)] + [(1024, 256)] * 5)
    assert fused_epilogue.counter.calls == 4  # layer3_5, layer4_0..2
    with torch.no_grad():
        want = model(x)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_megatail_covers_states_the_kernel():
    from mrla_tpu_torch.kernels import megatail_covers

    for c in range(64, 4097, 64):
        for c1 in (32, 64, 128, 192, 256, 512):
            assert megatail_covers(c, c1) == _kernel_takes(c, c1), (c, c1)
    assert not megatail_covers(96, 64)
    assert megatail_covers(1024, 256) and not megatail_covers(1024, 512)
    assert not megatail_covers(2048, 64)


def test_detect_forward_microbatch_chains_bitwise_equal():
    """The pyramid of chains of 2 images is the unsplit pyramid, bit for
    bit on the CPU, as the JAX engine's chains are its unsplit output."""
    gen = torch.Generator().manual_seed(9)
    model = _perturb_bn(MRLABackboneFPN(LAYERS, generator=gen), gen).eval()
    params = prepare_detect_params(model, LAYERS, torch.float32, "cpu")
    x = torch.from_numpy(_images(9, b=4))
    full = detect_forward(params, x, LAYERS)
    split = detect_forward(params, x, LAYERS, microbatch=2)
    assert len(split) == len(full) == 5
    for a, b in zip(full, split):
        assert torch.equal(a, b)
