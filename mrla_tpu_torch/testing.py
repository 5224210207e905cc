"""Seeded stand-ins for a trained model and real images, for smoke runs,
profiles and on-card tests of the serving path (``chip_smoke.py``,
``profile_serving.py``, ``tests/test_torch_gpu.py``).

``serving_model`` (resnet50_mrlal): random weights alone make a poor
serving check: with freshly initialised BN statistics and pure-noise
images, every image gives almost the same logits.
So bn3 gets a non-zero scale (it is zero-initialised, which would leave
every residual branch idle), the BN statistics are set from a pass over
seeded images, and the images are smooth colour fields with their own
contrast and colour cast.

``mrlab_serving_model`` (the resnet MRLA-base archs): the same, with the
bn_mrla scales spread too, so that the cross-layer term reaches the logits.

``zoo_serving_model`` (the baseline ResNet / ResNeXt with SE, ECA or the
dw ablation, EfficientNet-B0 with MRLA, ResMLP, PatchConvNet): the same
remedies for those families; its docstring says which init hides which
fault.

``deit_serving_model``: a DeiT's LayerNorms need no calibration, but its
weights are redrawn wider than the init's (``spread_deit_weights``), so that
the logits show what every part of the trunk computed.

``detector_serving_model`` (the two-stage presets): ``serving_model``'s
trunk, and RPN and box-head weights fitted to their measured inputs
(``spread_detector_weights``), so that objectness and class scores differ
between anchors, rois and classes and every image keeps detections over
the 0.05 threshold.

Detection training (``chip_smoke.py``'s training phase and
``tests/test_torch_detect_train.py``): ``training_detector`` (the same
spread heads on any depth), ``train_uniforms`` (the samplers' draws, handed
to the CPU and the card alike) and ``detection_batch``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mrla_tpu_torch.kernels import TailParams, pack_stage4_params
from mrla_tpu_torch.models import PatchConvNet, create_model
from mrla_tpu_torch.serving.resnet_mrlal import _conv


def images(gen: torch.Generator, n: int, px=224) -> torch.Tensor:
    """n seeded NHWC fp32 images on the CPU, ``px`` square or (H, W):
    smooth random colour fields plus pixel noise, each with its own contrast
    and colour cast, so that images differ after the global pool as real
    ones do."""
    h, w = (px, px) if isinstance(px, int) else px
    lo = torch.randn(n, 3, 7, 7, generator=gen)
    x = F.interpolate(lo, size=(h, w), mode="bilinear", align_corners=False)
    x = x + 0.3 * torch.randn(n, 3, h, w, generator=gen)
    x = x * (0.5 + 2.5 * torch.rand(n, 1, 1, 1, generator=gen))
    x = x + torch.randn(n, 3, 1, 1, generator=gen)
    return x.permute(0, 2, 3, 1).contiguous()


def _calibrated(model: torch.nn.Module, gen: torch.Generator,
                spread=("bn3",), px=224) -> torch.nn.Module:
    """``model`` in eval mode, the scales of the BNs whose names end in one
    of ``spread`` drawn from U(0.1, 0.5) and every BN's statistics averaged
    over a pass of 16 seeded ``px`` images."""
    bns = [(n, m) for n, m in model.named_modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for name, bn in bns:
            if name.endswith(spread):
                bn.weight.uniform_(0.1, 0.5, generator=gen)
            bn.reset_running_stats()
            bn.momentum = None  # cumulative average over the calibration
        model.train()(images(gen, 16, px))
    for _, bn in bns:
        bn.momentum = 0.1
    return model.eval()


def serving_model(seed: int) -> torch.nn.Module:
    """resnet50_mrlal on the CPU from ``seed``, in eval mode, with bn3
    scales drawn from U(0.1, 0.5) and the BN statistics averaged over a
    pass of 16 seeded 224 px images."""
    gen = torch.Generator().manual_seed(seed)
    return _calibrated(create_model("resnet50_mrlal", device="cpu",
                                    generator=gen), gen)


def mrlab_serving_model(seed: int, arch: str = "resnet50_mrlab"
                        ) -> torch.nn.Module:
    """A registered ``resnet*_mrlab*`` arch on the CPU from ``seed``, in
    eval mode, with bn3 and bn_mrla scales drawn from U(0.1, 0.5), so that
    every residual branch and the cross-layer term reach the logits, and
    the BN statistics averaged over a pass of 16 seeded 224 px images."""
    gen = torch.Generator().manual_seed(seed)
    return _calibrated(create_model(arch, device="cpu", generator=gen), gen,
                       spread=("bn3", "bn_mrla"))


def stage4_case(gen: torch.Generator, b: int, cin: int = 1024,
                c1: int = 512, c: int = 2048, ktap: int = 5,
                dtype: torch.dtype = torch.bfloat16):
    """Seeded operands (ob, xs, packed) of ``stage4_resident`` on ``gen``'s
    device, made as the engine makes them: three final-stage serving
    blocks (layouts of ``prepare_inference_params``) are packed, and a
    stage input map x [b, 14, 14, cin] goes through block 0's conv1 and
    stride-2 conv2 to ob, and as the strided view x[:, ::2, ::2, :] to xs.
    Weights are scaled by their fan-in so that every activation of the
    chain stays of order 1, as BN-folded trained weights keep them."""
    dev = gen.device
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)

    def conv(out_ch, in_ch, k, gain):
        w = rnd(out_ch, in_ch, k, k) * (gain / (in_ch * k * k)) ** 0.5
        return (w.to(dtype).contiguous(memory_format=torch.channels_last),
                (rnd(out_ch) * 0.1).to(dtype))

    blocks = []
    for i in range(3):
        p = {}
        p["k1"], p["b1"] = conv(c1, c if i else cin, 1, 2.0)
        p["k2"], p["b2"] = conv(c1, c1, 3, 2.0)
        p["k3"], p["b3"] = conv(c, c1, 1, 0.5)
        if i == 0:
            p["kd"], p["bd"] = conv(c, cin, 1, 1.0)
        p["wq"] = (torch.rand(ktap, generator=gen, device=dev) * 2 - 1) \
            / ktap ** 0.5
        p["wk"] = (torch.rand(ktap, generator=gen, device=dev) * 2 - 1) \
            / ktap ** 0.5
        p["wv"] = rnd(9, c) * 0.2
        p["lam"] = rnd(c) * 0.5
        p["bn_scale"] = rnd(c) * 0.1 + 1.0
        p["bn_bias"] = rnd(c) * 0.1
        blocks.append(p)
    x = rnd(b, 14, 14, cin).relu_().to(dtype)
    p0 = blocks[0]
    x1 = _conv(x, p0["k1"], p0["b1"]).relu_()
    ob = _conv(x1, p0["k2"], p0["b2"], stride=2).relu_().contiguous()
    return ob, x[:, ::2, ::2, :], pack_stage4_params(blocks, dtype)


def spread_deit_weights(model: torch.nn.Module,
                        gen: torch.Generator) -> torch.nn.Module:
    """Redraw a DeiT's weights in place, spread as a trained model's are
    and not as the init's.

    At the init (std 0.02) the attention and MLP branches are a hundredth
    of the residual stream, every tail gate is 1/2 and the depthwise value
    is small, so the logits would hardly notice a wrong ``ot``, a shifted
    gate or a swapped tail.  Here the qkv / proj / fc weights keep their
    input's variance (std 1/sqrt(fan_in)), LayerNorm weights are U(0.5,
    1.5) and biases N(0, 0.5), the tail's channel taps are U(-2, 2) and its
    depthwise weights N(0, 0.5), and the heads are N(0, 0.05).  λ keeps its
    init, N(0, 1)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 2)[-2:]
            if leaf[0] in ("head", "head_dist"):
                if leaf[1] == "weight":
                    p.normal_(0.0, 0.05, generator=gen)
            elif leaf[0] in ("qkv", "proj", "fc1", "fc2") \
                    and "patch_embed" not in name:
                if leaf[1] == "weight":
                    p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
            elif leaf[0].startswith("norm"):
                if leaf[1] == "weight":
                    p.uniform_(0.5, 1.5, generator=gen)
                else:
                    p.normal_(0.0, 0.5, generator=gen)
            elif leaf[0] in ("Wq", "Wk"):
                p.uniform_(-2.0, 2.0, generator=gen)
            elif leaf[0] == "Wv":
                p.normal_(0.0, 0.5, generator=gen)
    return model


def deit_serving_model(arch: str, seed: int, **model_kw) -> torch.nn.Module:
    """A registered ``deit_*`` / ``deit_mrlal_*`` / ``deit_mrlab_*`` arch on
    the CPU from ``seed``, in eval mode, its weights spread by
    :func:`spread_deit_weights`."""
    gen = torch.Generator().manual_seed(seed)
    model = create_model(arch, device="cpu", generator=gen, **model_kw)
    return spread_deit_weights(model, gen).eval()


def deit_tail_case(gen: torch.Generator, b: int, n: int = 197, c: int = 384,
                   ktap: int = 5, dtype: torch.dtype = torch.bfloat16):
    """Seeded operands (x, ot, packed) of ``deit_token_tail`` on ``gen``'s
    device: tokens of order 1 with a mean and a scale of their own per row,
    LayerNorm affines away from the identity, λ ~ N(0, 1), depthwise taps
    N(0, 0.3) and channel taps U(-1, 1)."""
    dev = gen.device
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)

    def tokens():
        t = rnd(b, n, c) * (0.5 + torch.rand(b, n, 1, generator=gen,
                                             device=dev))
        return (t + 0.5 * rnd(b, n, 1)).to(dtype)

    vec = torch.cat([
        torch.stack([1.0 + 0.2 * rnd(c), 0.2 * rnd(c),
                     1.0 + 0.2 * rnd(c), 0.2 * rnd(c), rnd(c)]),
        0.3 * rnd(9, c),
    ])
    taps = torch.rand(2, ktap, generator=gen, device=dev) * 2 - 1
    return tokens(), tokens(), TailParams(vec.contiguous(), taps)


def spread_detector_weights(model: torch.nn.Module, gen: torch.Generator,
                            px=(256, 384)) -> torch.nn.Module:
    """Redraw a ``FasterRCNN`` / ``MaskRCNN``'s RPN and box-head weights in
    place, so that its outputs depend on the image as a trained detector's
    do.

    At the mmdet init the RPN's convs are N(0, 0.01) (every anchor scores
    0.5 +- 0.001, so the proposals are an accident of rounding) and
    ``fc_cls`` is N(0, 0.01) (every class scores about 1/81, under the 0.05
    threshold, so no image keeps a detection).  Here each redrawn layer is
    fitted to its input as measured on 2 seeded ``px`` images through the
    model on the CPU (fp32): ``rpn_conv`` keeps its input's scale (He), and
    ``rpn_cls`` / ``rpn_reg`` / ``fc_cls`` / ``fc_reg`` are drawn from
    N(0, gain / (sqrt(fan_in) * rms)), where rms is that of their input less
    its mean over positions or rois, with a bias that cancels the mean
    input's share.  Gains: objectness logits of std 2, RPN deltas 0.2, class
    logits 3 (the top class of a roi takes some 0.15 of the softmax, over
    the 0.05 threshold), box deltas 1 (0.1 to 0.2 after the target stds).
    The mask head keeps its init."""
    rpn = model.rpn_head
    head = model.roi_head.bbox_head
    seen = {}

    def fit(layer, inputs, gain):
        """inputs [N, fan_in]: the layer's input vectors."""
        mean = inputs.mean(0)
        rms = (inputs - mean).pow(2).mean().sqrt().item()
        w = layer.weight
        with torch.no_grad():
            w.normal_(0.0, gain / (w[0].numel() ** 0.5 * rms), generator=gen)
            w2 = w.reshape(w.shape[0], -1)
            if w2.shape[1] == mean.numel():
                layer.bias.copy_(-(w2 @ mean))
            else:  # a 3x3 conv: the centre of a constant map
                layer.bias.copy_(-(w.sum((2, 3)) @ mean))

    def grab(name):
        def hook(_, args):
            seen[name] = args[0].detach().float().reshape(
                -1, args[0].shape[-1])
        return hook

    x = images(gen, 2, px)
    with torch.no_grad():
        feats = model.extract_feats(x.to(model.dtype))
        pixels = torch.cat([f.reshape(-1, f.shape[-1]) for f in feats])
        fit(rpn.rpn_conv, pixels, 2.0 ** 0.5)
        t = torch.cat([rpn.rpn_conv(f.permute(0, 3, 1, 2)).relu()
                       .permute(0, 2, 3, 1).reshape(-1, f.shape[-1])
                       for f in feats])
        fit(rpn.rpn_cls, t, 2.0)
        fit(rpn.rpn_reg, t, 0.2)
        handle = head.fc_cls.register_forward_pre_hook(grab("fc"))
        model(x)
        handle.remove()
        fit(head.fc_cls, seen["fc"], 3.0)
        fit(head.fc_reg, seen["fc"], 1.0)
    return model


def detector_serving_model(seed: int, preset: str =
                           "faster_rcnn_r50mrlal_fpn_1x_coco",
                           num_classes: int = 80) -> torch.nn.Module:
    """A two-stage preset's detector on the CPU from ``seed``, in eval
    mode: the backbone is :func:`serving_model`'s resnet50_mrlal (bn3 scale
    U(0.1, 0.5), BN statistics from seeded images), the neck and heads are
    drawn from the same seed and the heads spread by
    :func:`spread_detector_weights`."""
    from mrla_tpu_torch.detect.configs import PRESETS
    from mrla_tpu_torch.detect.two_stage import FasterRCNN, MaskRCNN

    p = PRESETS[preset]
    if tuple(p.backbone_layers) != (3, 4, 6, 3):
        raise ValueError(f"{preset}: only resnet50_mrlal trunks are seeded")
    gen = torch.Generator().manual_seed(seed)
    cls = MaskRCNN if p.with_mask else FasterRCNN
    model = cls(layers=p.backbone_layers, num_classes=num_classes,
                roi_sampling_ratio=0, generator=gen)
    trunk = {k: v for k, v in serving_model(seed).state_dict().items()
             if not k.startswith("fc.")}
    model.backbone.load_state_dict(trunk, strict=True)
    # fitted at half the daemon's 800 x 1344 in each axis: at 800 x 1344
    # the class logits then spread with a std near 3 (fitted at 256 x 384
    # they reach 5.8 there and the top scores saturate at 1.0)
    return spread_detector_weights(model.eval(), gen, px=(400, 672))


def training_detector(seed: int, with_mask: bool = False,
                      layers=(3, 4, 6, 3), num_classes: int = 80,
                      px=(128, 128), **model_kw) -> torch.nn.Module:
    """A ``FasterRCNN`` / ``MaskRCNN`` on the CPU from ``seed``, in eval
    mode (the presets' frozen BN), for the training checks: BN scales drawn
    from U(0.1, 0.5) and running variances from U(0.5, 1.5) (bn3 is
    zero-initialised, which would leave every residual branch idle), and
    the RPN and box head spread by :func:`spread_detector_weights` on ``px``
    images, so that proposals and samples do not hang on rounding."""
    from mrla_tpu_torch.detect.two_stage import FasterRCNN, MaskRCNN

    gen = torch.Generator().manual_seed(seed)
    cls = MaskRCNN if with_mask else FasterRCNN
    model = cls(layers=layers, num_classes=num_classes, generator=gen,
                **model_kw).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.1, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return spread_detector_weights(model, gen, px=px)


def train_uniforms(seed: int, b: int, n_anchors: int, n_rcnn: int) -> dict:
    """The samplers' uniforms of one training step (``faster_rcnn_train_loss``
    takes them in place of a generator), drawn with numpy from ``seed``:
    {"rpn": [b, 2, n_anchors], "rcnn": [b, 3, n_rcnn]} fp32 on the CPU."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.random((b, r, n)).astype(np.float32))
            for k, r, n in (("rpn", 2, n_anchors), ("rcnn", 3, n_rcnn))}


def detection_batch(seed: int, b: int, px: int, num_classes: int,
                    max_gt: int, with_masks: bool) -> dict:
    """One batch of the synthetic squares task as CPU tensors (image,
    gt_boxes, gt_labels, gt_valid, and gt_masks with ``with_masks``)."""
    from mrla_tpu_torch.data.synthetic import synthetic_detection_batches

    batch = next(synthetic_detection_batches(
        b, image_size=px, num_classes=num_classes, steps=1, max_gt=max_gt,
        seed=seed, with_masks=with_masks))
    return {k: torch.from_numpy(v) for k, v in batch.items()
            if k != "sample_valid"}


def rcnn_pyramid_grads(model, batch: dict, rand: dict, targets=None,
                       **loss_kw):
    """One ``faster_rcnn_train_loss`` of ``model`` on ``batch`` (tensors on
    the model's device) with the uniforms ``rand``, and the gradient of its
    R-CNN loss (loss_cls + loss_bbox) to P2..P5, which the RoIAlign
    backward produces.  Through the loss's ``stage`` hook: with ``targets``
    given (the sampled rois of another run) the "R-CNN targets" stage
    returns them in place of this device's own, and the "RoIAlign 7x7"
    stage takes detached P2..P5 leaves.  Returns (loss terms, targets,
    gradients of P2..P5)."""
    from mrla_tpu_torch.detect.two_stage_train import faster_rcnn_train_loss

    dev = batch["image"].device
    leaves = []

    def hook(name, fn, *args, **kw):
        if name == "R-CNN targets" and targets is not None:
            return {k: v.to(dev) for k, v in targets.items()}
        if name == "RoIAlign 7x7":
            leaves.extend(f.detach().requires_grad_() for f in args[0][:4])
            args = (leaves,) + args[1:]
        return fn(*args, **kw)

    _, losses, used = faster_rcnn_train_loss(
        model, batch["image"], batch["gt_boxes"], batch["gt_labels"],
        batch["gt_valid"], rand, gt_masks=batch.get("gt_masks"), stage=hook,
        **loss_kw)
    grads = torch.autograd.grad(losses["loss_cls"] + losses["loss_bbox"],
                                leaves)
    return ({k: v.detach() for k, v in losses.items()}, used,
            [g.detach() for g in grads])


def spread_token_weights(model: torch.nn.Module,
                         gen: torch.Generator) -> torch.nn.Module:
    """Redraw a ResMLP's or a PatchConvNet's weights in place, spread as a
    trained model's are and not as the init's.

    Their layer scales start at 1e-5 or 1e-6 (ResMLP-24, PatchConvNet-S60),
    which leaves every block a millionth of the residual stream: the logits
    would not move if a block's body were wired wrong, or if ``gamma_1``
    and ``gamma_2`` were swapped.  And their std-0.02 weights shrink every
    branch further.  Here every layer scale is U(0.05, 0.2); every Linear
    and conv weight N(0, 1/fan_in) (the heads N(0, 0.05)), their biases
    N(0, 0.1); LayerNorm and Affine weights U(0.5, 1.5), biases N(0, 0.5).
    The cls token keeps its init.  A PatchConvNet's class attention (one
    query) gets a key projection of a quarter of its query projection: with
    a random pair the cls token's own key takes 1/197 of the weight, and a
    class attention that left it out of its keys and values would not
    show; so it takes about 0.4."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            owner = name.rsplit(".", 2)[-2] if "." in name else ""
            if "gamma" in leaf:
                p.uniform_(0.05, 0.2, generator=gen)
            elif owner.startswith("norm") or leaf in ("alpha", "beta"):
                if leaf in ("weight", "alpha"):
                    p.uniform_(0.5, 1.5, generator=gen)
                else:
                    p.normal_(0.0, 0.5, generator=gen)
            elif name.startswith("head"):
                if leaf == "weight":
                    p.normal_(0.0, 0.05, generator=gen)
            elif leaf == "weight" and p.dim() >= 2:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
            elif leaf == "bias":
                p.normal_(0.0, 0.1, generator=gen)
        if isinstance(model, PatchConvNet) and not model.multiclass:
            attn = model.blocks_token_only[0].attn
            attn.k.weight.copy_(0.25 * attn.q.weight)
    return model


def zoo_serving_model(arch: str, seed: int, px=224,
                      **model_kw) -> torch.nn.Module:
    """A registered baseline resnet / resnext (SE, ECA, dw), EfficientNet,
    ResMLP or PatchConvNet arch on the CPU from ``seed``, in eval mode,
    with weights under which a wiring fault in a block body reaches the
    logits.

    * ResNet / ResNeXt: bn3 is zero-initialised (``zero_init_last_bn``),
      which leaves every residual branch idle, and with it the SE and ECA
      gates and the grouped 3x3: a gate skipped or its taps reversed would
      not move the logits.  Its scales are drawn from U(0.1, 0.5), and
      bn_dw's too (the dw branch).  With bn3's zero bias every channel of
      the gate's descriptor averages alike, so a gate is near 1/2 on every
      channel and reversed ECA taps (U(±1/√k)) change little: bn3's biases
      are drawn from N(0, 0.5) and the ECA taps from U(-1, 1).
    * EfficientNet: no BN starts at zero, but the init's statistics (mean
      0, variance 1) leave every BN far from its batch's, so BN eps or a
      skipped SE would hardly show.
    * Every BN's statistics are averaged over a pass of 16 seeded ``px``
      images (with the drop rates at 0), as ``serving_model`` does.
    * ResMLP / PatchConvNet have no BN: their layer scales and weights are
      spread by :func:`spread_token_weights`.
    """
    gen = torch.Generator().manual_seed(seed)
    if arch.startswith("efficientnet"):
        model_kw = {"drop_rate": 0.0, "drop_path_rate": 0.0, **model_kw}
    if arch.startswith("resmlp"):
        model_kw = {"img_size": px, **model_kw}
    model = create_model(arch, device="cpu", generator=gen, **model_kw)
    if arch.startswith(("resmlp", "patchconvnet")):
        return spread_token_weights(model, gen).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bn3.bias"):
                p.normal_(0.0, 0.5, generator=gen)
            elif name.endswith("eca.conv.weight"):
                p.uniform_(-1.0, 1.0, generator=gen)
    return _calibrated(model, gen, spread=("bn3", "bn_dw"), px=px)
