#!/usr/bin/env python3
"""Drive the PyTorch port (mrla_tpu_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py          # from the root of the repository

Phases, in order; any failure raises and the script exits non-zero:

  1. device: the card's name, the device count and nvidia-smi's name and
     power limit;
  2. build: nvcc compiles the kernels from mrla_tpu_torch/csrc (one process
     per source, in parallel); ptxas' registers / shared memory / spills of
     each kernel are printed;
  3. kernels: each kernel's wrapper against its plain PyTorch version on the
     card, in bf16, at every shape the main paths (224 px, batch 128) give
     it, and the epilogue and mega-tail also at every shape the detection
     path (800 x 1344, batch 8) gives them, and the epilogue at the two
     int8-engine shapes no other path gives it ([64,56,56,256] and
     [64,28,28,512], chains of 64), with its time (CUDA events),
     its bound and the plain version's time; the DeiT token tail also at
     the other two published widths, at a batch of 3 and at the 384 px
     base model's 24 x 24 grid ([128,577,768]), its cls rows with ot
     doubled, and each shape's two passes as deit_token_tail_describe
     reports them (registers, spills, blocks an SM); the block tail from
     z (the HWBC block tail's kernel too), the row tail and the copy at every shape the tail routes give
     them and at the JAX package's test shapes (the row tail with and
     without x1; the copy held bitwise, a new tensor, and timed in turns
     with x.clone()); at each mega-tail and row-tail shape also, as
     diagnostics, the row tail's y alone, the product alone as one PyTorch
     expression, and the launch's tile, blocks an SM and waves; at each
     block-tail and epilogue shape the segment a thread walks, its ring,
     blocks an SM and waves (mrla_{block_tail,epilogue}_describe), and the
     epilogue's y held bitwise to the mega-tail's y (the tap loop the
     window replaced) where the mega-tail takes the shape; the stage
     kernel and the DeiT token tail run twice and must be
     bitwise equal, the stage kernel printing each of its eight launches'
     tiles and waves as mrla_stage4_describe reports them (each launch's
     tiles covering every row once and fitting shared memory);
  4. serving: resnet50_mrlal at 224 px, batch 128, bf16 through the
     BN-folded engine for 4 requests, from seeded random weights with a
     non-zero bn3 scale and BN statistics set from seeded images
     (mrla_tpu_torch/testing.py), on both routes: the per-block kernels
     (use_stage4=False) and the stage kernel (attach_stage4,
     use_stage4=True).  On each route the counts are set to 0 just before
     the requests and read just after; the launches counted by shape must
     be exactly the tables below (7 mega-tail + 9 epilogue per forward; 7
     mega-tail + 6 epilogue + 1 stage kernel), the logits finite, and,
     against the port's own fp32 forward on the CPU for 32 images, the
     top-1 class the same for the 8 whose fp32 decision is clearest and
     the logit error (see logit_error) within LOGIT_ERROR_TOL; the engine
     with one wiring fault (in any one block; in the stage kernel's
     packing or its strided input) must fail that check;
  5. throughput: img/s over 20 forwards of each route, in turns, and the
     peak device memory; then the three tail routes on the same params
     (serving/tail_routes.py: rowtail, every block's tail in the row-tail
     kernel, the next conv1 inside it; block_tail, the HWBC block tail on
     maps 28 or more wide and the block tail on the rest; copy, block_tail
     with the copy kernel after each stage-1 block): 4 requests each with
     the launches by shape exactly the tables below (no mega-tail nor
     epilogue launch), the same logit check with one injected wiring
     fault per route that must fail it (TAIL_FAULTS), copy's logits
     bitwise block_tail's, and img/s in turns with the default route;
  6. serving and throughput of deit_mrlal_small_patch16_224 (full depth,
     224 px, batch 128, bf16) through prepare_deit_inference_params /
     deit_forward, from seeded weights spread as a trained model's
     (mrla_tpu_torch/testing.py): exactly 12 token-tail launches per
     forward at (128, 197, 384), finite logits, the same top-1 and
     logit-error check (DEIT_LOGIT_ERROR_TOL), and four injected wiring
     faults that must each fail it;
 6b. the MRLA-base paths, plain PyTorch with no kernel of the port (every
     count must read 0 across their requests), at 224 px, batch 128, bf16,
     from seeded models (mrla_tpu_torch/testing.py: mrlab_serving_model,
     deit_serving_model): resnet50_mrlab through
     prepare_mrlab_inference_params / resnet_mrlab_forward for 4 requests
     with use_scan False (the growing cache) and then True (the masked
     fixed-length form), finite logits, the top-1 and logit-error check
     against the port's fp32 CPU model on 32 images
     (MRLAB_LOGIT_ERROR_TOL), three injected wiring faults that must each
     fail it (the cache not carried, a sigmoid over t, the ReLU on attn
     dropped), the max |Δlogit| between the two forms, and img/s of each
     form in turns with the peak memory; resnet50_mrlab22 (2 requests, the
     same check, img/s); deit_mrlab_small_patch16_224 through
     deit_forward (4 requests, the check with DEIT_MRLAB_LOGIT_ERROR_TOL,
     the fault of a cache never restarted, img/s twice);
 6c. resnet_mrlal_forward with microbatch=32 and shared_stem on the
     seeded params and requests of phase 4 (made anew), against the
     unsplit forward: the max
     |Δlogit| and the logit error within LOGIT_ERROR_TOL (no bits are
     promised on the card), and img/s of both in turns;
  7. two-stage detection: faster_rcnn_r50mrlal_fpn_1x_coco (and the mask
     preset) at 800 x 1344, batch 8, bf16, full depth, 80 classes, through
     prepare_detect_params / two_stage_detections, from a seeded detector
     (mrla_tpu_torch/testing.py: detector_serving_model).  First the
     RoIAlign kernel against its plain version on the rois the path makes
     (8 x 1000 proposals at 7 x 7; 8 x 100 detections at 14 x 14), in bf16
     and in fp32, with its time, bound and plain time, and two launches of
     its C entry point over NaN-filled outputs that must write every
     element and give the same bits.  Then 2 requests on
     each preset with the launches counted by shape (RoIAlign 1 per
     forward, 2 with masks; mega-tail 12 and epilogue 4, the table below),
     finite outputs and a detection in every image; against the port's fp32
     forward on the CPU (the nn.Module MaskRCNN, 2 images): the pyramid
     P2..P6, and the RoI features and the box head's (cls, reg) on the
     CPU's proposals, each within its tolerance, while each of four
     injected wiring faults (the box head flattening [7, 7, C] where
     [C, 7, 7] is wanted, rois with x and y swapped, the level mapping one
     level up, one FPN top-down add left out) fails it; img/s over 20
     forwards of each preset and the peak memory;
  8. two-stage detection training (fp32, TF32 off): the RoIAlign backward
     kernel against its plain version on the sampled rois of one 800 x 800,
     batch 8 step of the mask preset (512 rois at 7 x 7, 128 at 14 x 14)
     with a seeded cotangent, run twice (the two runs bitwise equal), with
     its time (the rois' boxes inside), bound and plain time, and the
     forward kernel at the training shapes (the box and mask heads' rois
     and the gt mask crop: one level, C = 32, 28 x 28), each with the same
     two launches over NaN; the wrapper's autograd on the
     card against CPU copies, and a backward that
     ignores valid, which must fail that check; one full-depth step at 800
     x 800, batch 2, on the card against the same step on the CPU (loss
     terms; the R-CNN loss's gradient to P2..P5 on the CPU's sampled rois),
     with three injected backward faults (x and y swapped, the gradient one
     level up, the cotangent dropped) that must each fail it; the trainer
     (detect/train_cli.py main) at 800 x 800, batch 8, 80 classes for the
     faster preset, the mask preset and the faster preset with --bf16: 2 +
     8 steps with the counts set to 0 just before and read just after,
     ms / step, img/s, peak memory, finite losses and the RoIAlign launches
     per step by shape (forward, backward, gt mask crop; the tables below);
     a small detector learning the synthetic task (the loss must fall);
 8b. classification training (fp32 with TF32 off unless --bf16): (a)
     one SGD step (momentum 0.9, weight decay 1e-4, label smoothing 0.1,
     lr 0.1) of a seeded resnet50_mrlal (full depth, 224 px, batch 8,
     1000 classes; testing.serving_model) on the card against the same
     step on the CPU: the loss, the largest error of any parameter's and
     any running statistic's update relative to that update (norms), each
     within CLS_STEP_TOLS, while each of four injected faults (weight
     decay left out, label smoothing left out, λ·identity dropped from
     the epilogue, BN's running variance unbiased) must fail that check;
     then the same step with fused_epilogue=True against the unfused step
     on the card, within the same limits; (b) the trainer
     (train/cli.py main) on the synthetic source for 2 + 8 steps of the
     ResNet recipe (resnet50_mrlal, 224 px, batch 128, --bf16, SGD, step
     LR with 3 warm-up epochs, label smoothing 0.1), in turns without and
     with --fused-epilogue, and of the DeiT recipe
     (deit_mrlal_tiny_patch16_224, 224 px, batch 256, --bf16, AdamW lr
     5e-4 · 256/512, wd 0.05, cosine, EMA 0.99996, Mixup 0.8, CutMix 1.0,
     label smoothing 0.1, drop path 0.1): ms / step (mean of the 8),
     img/s, the peak memory, finite losses, every kernel count 0 across
     the steps; (c) a (1, 1, 1, 1) resnet_mrlal learning
     synthetic-learnable at 64 px, 10 classes, for 300 steps: the loss
     must fall to CLS_LEARN_RATIO_TOL of its start, and top-1 of -e on
     the last checkpoint must pass CLS_LEARN_ACC1; (d) the phase's wall
     time;
 8c. the model zoo, plain PyTorch with no kernel of the port (every count
     must read 0): (a) efficientnet_mrlal_b0 (BASELINE.json config 3),
     resnet50_se, resnext50_32x4d_eca, resnet50_dw, resmlp_24 and
     patchconvnet_s60 at 224 px, batch 128, bf16, full depth, from seeded
     stand-ins (mrla_tpu_torch/testing.py: zoo_serving_model), through
     prepare_precast_inference_params / precast_forward: 8 requests each,
     finite logits, the top-1 and logit-error check against the port's
     fp32 CPU forward on 16 images within the arch's ZOO_LOGIT_ERROR_TOL,
     and injected wiring faults that must each fail it (ZOO_FAULTS); then
     img/s of each arch twice, in turns, with ms / forward and the peak
     memory; (b) one fp32 RMSpropTF step of the seeded full-depth
     efficientnet_mrlal_b0 (224 px, batch 8) on the card against the CPU,
     within CLS_STEP_TOLS, λ·identity dropped failing it; the EfficientNet
     recipe (train/cli.py main, batch 384, RMSpropTF lr 0.048, exponential
     decay, --bf16) for 2 + 8 steps: ms / step, img/s, the peak memory and
     the host draw's time beside the step; (c) the phase's wall time;
 8d. classification training on real data, plain PyTorch (every count
     must read 0 across the phase): (a) what decodes here: Pillow's
     version, the native JPEG loader's build or its error, nvjpeg.h (the
     card machine has Pillow and no libjpeg headers, so PIL decodes every
     batch there); (b) a seeded JPEG tree of ImageNet-like sizes in a
     temporary directory: 10 classes x 128 train images, 300 val; (c) the
     loader's batch (train and eval, bilinear and bicubic, bs128, 224 px)
     bitwise the same decoder called image by image on the same indices
     and seed, the card's normalisation of it against the host's, the
     loader's img/s; (d) train/cli.py main on the tree for the ResNet
     recipe (one epoch of 10 steps, then validation), with --profile-dir:
     ms / step over steps 1-4 with the data time beside it (the loader's
     wait, the batch's copy and augmentation), img/s,
     the peak memory, finite losses, the decoder of every batch, the val
     count 300 (a ragged last batch), a Chrome trace holding CUDA kernel
     events; (e) the DeiT recipe with --repeated-aug and random erasing (5
     steps, bicubic), the same prints and checks; (f) --finetune of a
     deit_mrlal_tiny checkpoint at 224 px to 384 px and 10 classes with
     the EMA: before the first step the position embedding equal to
     interpolate_pos_embed of the saved one, fresh [10, 192] heads, every
     other weight and the EMA equal to the saved weights; then 2 steps on
     the tree; (g) --teacher-resume: a resnet50 checkpoint as the teacher
     of deit_tiny_distilled, its logits equal to the reloaded
     checkpoint's, while the random-init teacher (the injected fault) must
     fail that check; (h) the phase's wall time, within REAL_WALL_S;
  8e. RetinaNet, COCO data and the detection trainer's options, at full
     depth, published widths and 80 classes: (a) retinanet_r50mrlal_fpn_1x
     _coco served through the module under bf16 autocast at 800 x 1344,
     batch 8, from a seeded detector (testing.retinanet_serving_model): 2
     requests with every kernel count 0, a detection in every image;
     against the port's fp32 forward on the CPU for 2 images each level's
     (cls, reg) maps and get_bboxes' detections within RETINA_TOLS, while
     three injected wiring faults (the first extra conv fed P5, the anchors
     scale-major, levels P4..P7 through an unshared head) must each fail
     it; img/s over 20 forwards and the peak memory; then detect_forward
     with start_level=1, add_extra_convs="on_input": its P3..P7 against
     the module's within DET_TOLS["pyramid"], the mega-tail and epilogue
     launches per forward the detection trunk's table; (b) one full-depth
     RetinaNet training step (800 x 800, batch 2, fp32) on the card
     against the CPU: loss terms, num_pos, the gradients of the head and
     of P3..P7 within RETINA_STEP_TOLS, while α and 1 - α swapped, the
     avg_factor per image and neg_iou_thr 0.5 must each fail it; (c) a
     seeded COCO-format tree in a temporary dir (64 train, 20 val JPEGs at
     COCO-like sizes, COCO's sparse category ids, polygon, RLE, crowd and
     degenerate annotations) and detect/train_cli.py main on it at 800 x
     1344, batch 8, one epoch (8 steps; 2 + 6 timed) for RetinaNet fp32
     (then the val split's mAP, scored with no threshold),
     RetinaNet --bf16, faster_rcnn fp32 and mask_rcnn --remat: ms / step,
     img/s, the peak memory, the loader's wait, finite losses, the
     RoIAlign launches per step by shape (none for RetinaNet, no other
     kernel); --eval-only --resume (val count exactly 20: the ragged
     tail's padding skipped) and --eval-only --torch of the trained
     weights must give the run's mAP and evaluate its weights bit for bit
     (which differ from the init); --resume continues at epoch 1; (d)
     one --bf16 step's loss terms of RetinaNet and of the faster preset
     (on the fp32 step's sampled rois) against the fp32 step on the card
     within BF16_STEP_TOL, which the ground-truth boxes cast to bf16 must
     fail, and against the same losses recomputed on the CPU in fp32 from
     the step's own head outputs within BF16_LOSS_TOL, which the logits
     fed to the focal / softmax loss in bf16 must fail; the phase's wall
     time;
 8f. data parallelism (parallel/, DDP with BN over the global batch):
     (a) NCCL at world 1, the launch environment of one rank set in-process
     (a free localhost port): the ResNet recipe of 8b(b) (2 + 8 steps) and
     the faster preset's trainer with --dp 1 (800 x 800, batch 8, 2 + 8
     steps), each in turns with the same run without a process group: ms
     / step (DDP's cost at world 1), finite losses, the classification
     run's kernel counts 0, the RoIAlign launches per step by shape phase
     8's table (rows 8 and 9 under DDP), one log line (rank 0's); (b) two
     gloo ranks sharing the card (NCCL takes one card a rank), started
     after the build (parallel/spawn.py), against the same step at world 1
     on the global batch on the card, fp32: one SGD step of the seeded
     full-depth resnet50_mrlal (224 px, global batch 16, 8 a rank; the
     loss and the largest error of any parameter's and running
     statistic's update within CLS_STEP_TOLS), per-replica BN (the
     injected fault) failing them, the fused epilogue's step against its
     world-1 step; one step of the seeded full-depth faster preset (800 x
     800, global batch 4, 2 a rank, the samplers' uniforms fixed: loss
     terms and gradients within DP_DET_TOLS), per-rank normalisers (the
     fault) failing them, 1 RoIAlign forward and 1 backward in each rank;
     the two ranks' weights bitwise equal after every sound step; the
     phase's wall time beside DP_WALL_S;
  8g. model and pipeline parallelism (parallel/mesh.py, sharding.py,
     pipeline.py, serving/sharded.py, dryrun.py): (a) sharded serving:
     make_sharded_forward over a one-rank mesh with NCCL at world 1 equal
     to the engine bitwise; then two gloo ranks sharing the card, each
     serving its 64 rows of resnet50_mrlal (224 px, global batch 128, bf16,
     MP_REQUESTS requests) and of deit_mrlal_small_patch16_224 (full
     depth), its logits held to the single-card engine on the whole batch
     under the engine's logit_error bar, the kernel launches per rank by
     shape exactly the main paths' tables at 64 rows (rows 1, 3 and 7 of
     the kernels line), img/s per rank and of both together beside the
     single-card engine's; (b) tensor parallelism: two gloo ranks on a data
     1 x model 2 mesh, one fp32 SGD step (TF32 off) of the seeded full-depth
     resnet50_mrlal (224 px, global batch 8, the step of 8b(a)) against the
     same step at world 1 on the card within CLS_STEP_TOLS, while the
     gathers' backward summing over the model group (tp_sum_grad) must fail
     them; each rank's parameter + momentum bytes against the replicated
     model's; (c) the pipeline: two gloo ranks on a pipe 2 mesh, the
     full-depth deit_mrlal_small_patch16_224 at 224 px, batch 32, 4
     microbatches, fp32: its forward held to the unpipelined module on the
     card within MP_PIPE_FWD_TOL, one SGD step from the resident layout
     held to the module's step within CLS_STEP_TOLS, the final broadcast's
     backward summing over the stages (pipe_sum_out) failing them, ms a
     step against world 1; (d) dryrun_multichip(4, backend="gloo") on the
     card: its five lines and finite losses; the phase's wall time beside
     MP_WALL_S.  No earlier phase is cut for it;
  8h. the serving surface (serving/server.py, quant.py, cli.py, hub.py,
     utils/; SURF_WALL_S is the target): (a) the batching daemon
     (build_server, resnet50_mrlal, 224 px, batch 128, bf16, 127.0.0.1
     port 0) under 256 single-image npy requests from 16 client threads,
     one JSON request of 3 images and one ?topk=5: every response against
     the engine's own forward of its image (bitwise or not, printed;
     logit_error within LOGIT_ERROR_TOL), /stats against the requests
     sent, the launches exactly the main path's table (7 mega-tail + 9
     epilogue) times the batches flushed, requests/s, p50 / p99 latency
     and the padded share; the responders given the batch's rows shifted
     by one (the injected fault) must fail the check; (b) the int8 engine
     (prepare_quant_params on 128 seeded images; int8 and int8-fast at
     224 px, batch 128, chains of 64): the epilogue's launches exactly 32
     a forward by shape (QUANT_EPILOGUE_SHAPES); every block against the
     fp32 fake-quant reference on the card fed the engine's own block
     input (fake_quant_block: kernels dequantised with scales taken from
     the BN-folded kernels, not the tree's multipliers), max |Δ| over max
     |out| within QUANT_LOGIT_TOL, the end-to-end gap printed beside it;
     a scale fault (inv_a1 in place of a1 in block 0's conv2 multiplier)
     and a requantisation moved before conv2's ReLU must each fail it;
     top-1 against the bf16 engine on its 8 clearest images (held for
     int8, printed for the lossy int8-fast); img/s of int8, int8-fast and
     the bf16 engine in turns; (c) the detections daemons at 800 x 1344,
     batch 8, one batch each: RetinaNet and faster (and mask, ?masks=1)
     answering JSON equal to the direct call on the same batch, launches
     by shape (RoIAlign 1 a batch, 2 with masks; the trunk's table; none
     for RetinaNet), masks of [n, 28, 28]; the pyramid daemon's npz
     levels bitwise detect_forward's; (d) the eval CLI (serving/cli.py
     main) on phase 8d's JPEG tree with --limit 256 for resnet50_mrlal,
     resnet50_mrlab, resnet50_se, resnet50_la_eq4,
     deit_mrlal_small_patch16_224 and resnet50_mrlal --quant int8, each
     from a seeded --torch checkpoint: the engine JAX's _pick_engine
     names, images 256, acc1 / acc5 equal to a direct loop over the same
     engine, the launches per forward by shape (the token tail 12 at
     (128, 197, 384)); (e) hub.load("resnet50_mrlal") on the card (finite
     logits), profile_model of resnet50_mrlal and deit_mrlal_small, the
     log tools on phase 8d's ResNet run directory;
  9. one JSON line listing each ported kernel, its per-forward (per-step
     for the backward) numbers weighted by the launches counted by shape on
     its main path, and its launches on the other paths (the DDP training
     run of 8f, the sharded-serving ranks of 8g and phase 8h's paths among
     them, 8g's and the int8 engine's also by shape), and the rows of the
     shapes only other paths give it;
 10. the nvidia-smi line, then the result line
     {"ok": true, "device": {"platform": "gpu", ...}}.

It needs one CUDA card and exits non-zero without printing a result when
there is none, or when the mrla_tpu_torch package is not beside it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

BATCH, PX, REQUESTS, TIMED_FORWARDS = 128, 224, 4, 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12
TAIL_FP32_OPS = 24  # per element: 9 taps (FMA = 2), gate, λ·id, BN, residual
# logit_error of the served bf16 logits against the fp32 CPU forward: a
# sound run on an H100 reads 0.0179, and one wiring fault in one block
# 0.115 at the least (both printed by this script; readings in PERF.md)
LOGIT_ERROR_TOL = 0.05

# The shapes the resnet50_mrlal main path (224 px, batch 128) gives each
# kernel, keyed as the wrapper's counter keys its launches, with a label
# and the launches per forward: (B, H, W, C) for the epilogue and
# (B, H, W, C, C1) for the mega-tail.  serve() asserts that the main path
# launched exactly these.
EPILOGUE_SHAPES = {
    (BATCH, 14, 14, 1024): ("stage3", 6),
    (BATCH, 7, 7, 2048): ("stage4", 3),
}
# The int8 engine (phase 8h) serves the batch in chains of 64 and runs the
# epilogue after every block; phase 3 holds and times it also at the two
# of those shapes that no other path gives it (launches per int8 forward).
QUANT_MICROBATCH = 64
QUANT_NEW_SHAPES = {
    (QUANT_MICROBATCH, 56, 56, 256): ("int8 stage1", 6),
    (QUANT_MICROBATCH, 28, 28, 512): ("int8 stage2", 8),
}
# With use_stage4=True the stage kernel, keyed (B, CIN, C1, C), takes the
# place of stage 4's three epilogues.
STAGE4_SHAPES = {
    (BATCH, 1024, 512, 2048): ("layer4_0 conv3 .. layer4_2", 1),
}
# The DeiT main path: deit_mrlal_small_patch16_224, keyed (B, N, C).
DEIT_ARCH = "deit_mrlal_small_patch16_224"
DEIT_TAIL_SHAPES = {
    (BATCH, 197, 384): ("blocks 0..11", 12),
}
# further shapes the token tail is checked at: the other published widths,
# a batch whose B * N is no multiple of 8 and the 384 px base model's
# 24 x 24 grid
DEIT_TAIL_EXTRA_SHAPES = [(BATCH, 197, 192), (BATCH, 197, 768), (3, 197, 384),
                          (BATCH, 577, 768)]
# per element: two LayerNorms (8 each), GAP, 9 taps (FMA = 2), erf GELU
# (about 23), gate, λ·normo, residual
DEIT_TAIL_FP32_OPS = 60
# logit_error of the served DeiT logits: a sound run on an H100 and the
# least of the four injected faults are printed by this script (readings in
# PERF.md); the bf16 engine on the CPU reads 0.018 and the least fault 0.34
DEIT_LOGIT_ERROR_TOL = 0.06
# The MRLA-base paths (224 px, batch 128, bf16): plain PyTorch, no kernel of
# the port.  Their logit_error limits lie between the sound reading on an
# H100 and the least injected fault, both printed by this script: resnet50
# _mrlab 0.0268 and 1.03 (the ReLU on attn dropped), mrlab22 0.0216,
# deit_mrlab_small 0.0193 and 0.174 (readings in PERF.md).
MRLAB_ARCH, MRLAB22_ARCH = "resnet50_mrlab", "resnet50_mrlab22"
DEIT_MRLAB_ARCH = "deit_mrlab_small_patch16_224"
MRLAB_PATHS = {False: "resnet50_mrlab growing cache",
               True: "resnet50_mrlab masked cache"}
MRLAB22_PATH, DEIT_MRLAB_PATH = "resnet50_mrlab22", "deit_mrlab_small"
MRLAB_LOGIT_ERROR_TOL = 0.05
DEIT_MRLAB_LOGIT_ERROR_TOL = 0.06
# no_cache: each block attends to itself only; sigmoid: a sigmoid in place
# of the softmax over t; no_relu: the ReLU on attn dropped
MRLAB_FAULTS = ("no_cache", "sigmoid", "no_relu")
MICROBATCH = 32  # the microbatch phase: chains of 32 on resnet50_mrlal
MEGATAIL_SHAPES = {
    (BATCH, 56, 56, 256, 64): ("layer1_0..1", 2),
    (BATCH, 56, 56, 256, 128): ("layer1_2", 1),
    (BATCH, 28, 28, 512, 128): ("layer2_0..2", 3),
    (BATCH, 28, 28, 512, 256): ("layer2_3", 1),
}

# The tail routes of resnet50_mrlal serving (serving/tail_routes.py) at 224
# px, batch 128, keyed as the wrappers' counters key their launches:
# (B, H, W, C, C1) for the row tail (C1 = 0: y alone), (B, H, W, C) for the
# block tails and the copy.  serve_tail_routes() asserts exactly these.
TAIL_PATHS = {t: f"tail route {t}" for t in ("rowtail", "block_tail",
                                               "copy")}
ROWTAIL_SHAPES = {
    (BATCH, 56, 56, 256, 64): ("layer1_0..1", 2),
    (BATCH, 56, 56, 256, 128): ("layer1_2", 1),
    (BATCH, 28, 28, 512, 128): ("layer2_0..2", 3),
    (BATCH, 28, 28, 512, 256): ("layer2_3", 1),
    (BATCH, 14, 14, 1024, 256): ("layer3_0..4", 5),
    (BATCH, 14, 14, 1024, 512): ("layer3_5", 1),
    (BATCH, 7, 7, 2048, 512): ("layer4_0..1", 2),
    (BATCH, 7, 7, 2048, 0): ("layer4_2", 1),
}
HWBC_SHAPES = {  # maps 28 or more wide: the HWBC block tail
    (BATCH, 56, 56, 256): ("stage1", 3),
    (BATCH, 28, 28, 512): ("stage2", 4),
}
BLOCK_TAIL_SHAPES = {
    (BATCH, 14, 14, 1024): ("stage3", 6),
    (BATCH, 7, 7, 2048): ("stage4", 3),
}
COPY_SHAPES = {(BATCH, 56, 56, 256): ("after layer1_0..2", 3)}
TAIL_TABLES = {
    "rowtail": {"rowtail": ROWTAIL_SHAPES},
    "block_tail": {"block_tail_hwbc": HWBC_SHAPES,
                   "block_tail": BLOCK_TAIL_SHAPES},
    "copy": {"block_tail_hwbc": HWBC_SHAPES, "block_tail": BLOCK_TAIL_SHAPES,
             "copy": COPY_SHAPES},
}
# further shapes the new kernels are checked at: the JAX package's tests'
# (tests/test_kernels_tpu.py, tests/test_rowtail_kernel.py, each row tail
# also without x1) and odd ones
BLOCK_TAIL_EXTRA_SHAPES = [(2, 8, 8, 128), (8, 16, 16, 256), (3, 16, 16, 256),
                           (3, 2, 7, 64)]
ROWTAIL_EXTRA_SHAPES = [
    (b, h, w, c, c1) for b, h, w, c, c1_ in [
        (8, 6, 5, 256, 64), (8, 7, 7, 128, 128), (16, 14, 14, 512, 256),
        (8, 2, 3, 128, 64)] for c1 in (c1_, 0)]
COPY_EXTRA_SHAPES = [(3, 4, 5, 64), (8, 4, 4, 128)]
# one wiring fault in one block of each route, each of which must fail the
# logit check: the row tail given zeros for the identity of its ls·id term
# (at a stage-1, a stage-2 and the last block); the block tail given z and
# the identity swapped (an HWBC and a plain block tail); the copy after
# layer1_1 handing on its copy of layer1_0's output
TAIL_FAULTS = {"rowtail": [("no_id", 0), ("no_id", 5), ("no_id", 15)],
               "block_tail": [("swap", 0), ("swap", 10)],
               "copy": [("stale", 1)]}

# The detection path: two-stage presets at the daemon's defaults (batch 8,
# 800 x 1344, bf16, 1000 proposals, 100 detections, score_thr 0.05).  Its
# trunk sends a block to the mega-tail only where the kernel covers (C, next
# C1) (megatail_covers): not layer3_5 (next C1 512) nor stage 4 (C 2048).
DET_PRESET = "faster_rcnn_r50mrlal_fpn_1x_coco"
MASK_PRESET = "mask_rcnn_r50mrlal_fpn_1x_coco"
DET_PATH, MASK_PATH = "faster_rcnn_r50mrlal", "mask_rcnn_r50mrlal"
DET_BATCH, DET_HW, DET_REQUESTS = 8, (800, 1344), 2
DET_MEGATAIL_SHAPES = {
    (DET_BATCH, 200, 336, 256, 64): ("det layer1_0..1", 2),
    (DET_BATCH, 200, 336, 256, 128): ("det layer1_2", 1),
    (DET_BATCH, 100, 168, 512, 128): ("det layer2_0..2", 3),
    (DET_BATCH, 100, 168, 512, 256): ("det layer2_3", 1),
    (DET_BATCH, 50, 84, 1024, 256): ("det layer3_0..4", 5),
}
DET_EPILOGUE_SHAPES = {
    (DET_BATCH, 50, 84, 1024): ("det layer3_5", 1),
    (DET_BATCH, 25, 42, 2048): ("det layer4_0..2", 3),
}
# RoIAlign, keyed (B, P, out, C): the box head's input on both presets, the
# mask head's on the mask preset
ROI_SHAPES = {(DET_BATCH, 1000, 7, 256): ("box head", 1)}
MASK_ROI_SHAPES = {(DET_BATCH, 100, 14, 256): ("mask head", 1)}
# fp32 RoIAlign: a bin sums at most 4 corners x 7 x 7 slots of weights that
# add up to at most 1, so reassociation moves it by at most that many fp32
# roundings of the largest |feature|
ROI_FP32_TERMS = 4 * 7 * 7
ROI_FP32_OPS = 8  # per sample and channel: 4 corners, multiply and add
# Errors of the served bf16 detection path against the port's fp32 forward
# on the CPU (see det_errors): the pyramid and the RoI features relative to
# their norm, the box head's (cls, reg) relative to their image- and
# roi-dependent part.  Set between the sound reading and the least injected
# fault (both printed by this script; readings in PERF.md).
DET_TOLS = {"pyramid": 0.08, "roi": 0.08, "head": 0.15}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` in ms: CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, mm_flops: float, ew_flops: float):
    """The least time (ms) the card could take and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(mm_flops / BF16_TENSOR_FLOPS, ew_flops / FP32_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def tail_inputs(gen, shape):
    dev = "cuda"
    b, h, w, c = shape
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    return dict(
        out=rnd(b, h, w, c).mul_(0.5).relu_().bfloat16(),
        identity=rnd(b, h, w, c).bfloat16(),
        gate=torch.sigmoid(rnd(b, c)),
        wv=rnd(9, c).mul_(0.3),
        lam=rnd(c),
        bn_scale=rnd(c).mul_(0.2).add_(1.0),
        bn_bias=rnd(c).mul_(0.2),
    )


def ulp_tol(ref: torch.Tensor, ulps: int) -> float:
    """``ulps`` bf16 units in the last place at the largest |ref|."""
    return ulps * 2.0 ** -7 * ref.abs().max().item()


def tail_x1_diagnostics(lib, kind: str, a: dict, w1, b1, shape) -> dict:
    """What sets the time of a tail + next-conv1 kernel ("megatail" or
    "rowtail", csrc/tail_x1.cuh) at ``shape`` (B, H, W, C, C1): the row
    tail's y alone (its C1 = 0 kernel) on the same map; the product alone,
    relu(y @ W1^T + b1) in bf16 on the same [P, C] x [C, C1] as one PyTorch
    expression (a diagnostic: the port never calls it, and it is not the
    kernel's function); and the launch's tile, its blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and waves."""
    import ctypes

    from mrla_tpu_torch.kernels._build import check
    from mrla_tpu_torch.kernels.mrla_rowtail import _fold

    b, h, w, c, c1 = shape
    gs, ls = _fold(a["gate"], a["lam"], a["bn_scale"])
    y = torch.empty_like(a["out"])
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [a["out"].data_ptr(), a["identity"].data_ptr(), gs.data_ptr(),
            a["wv"].data_ptr(), ls.data_ptr(), a["bn_bias"].data_ptr()]
    y_only_ms = cuda_ms(lambda: lib.mrla_rowtail_bf16(
        *ptrs, None, None, y.data_ptr(), None, b, h, w, c, 0, stream))
    y2d, b1h = a["out"].reshape(-1, c), b1.bfloat16()
    product_ms = cuda_ms(lambda: torch.relu(y2d @ w1.t() + b1h))
    out = (ctypes.c_int * 6)()
    check(getattr(lib, f"mrla_{kind}_describe")(c, c1, ctypes.addressof(out)),
          f"mrla_{kind}_describe (C={c}, C1={c1})")
    per_sm, pixels, cols, stages, depth, smem = out
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-b * h * w // pixels)
    return dict(y_only_ms=y_only_ms, product_ms=product_ms,
                blocks_per_sm=per_sm, blocks=blocks,
                waves=blocks / (per_sm * sms),
                tile=dict(pixels=pixels, columns=cols, ring_stages=stages,
                          k_depth=depth, smem_bytes=smem))


def diagnostics_text(d: dict) -> str:
    t = d["tile"]
    return (f"y alone {d['y_only_ms']:.4f} ms, product alone (torch, "
            f"diagnostic) {d['product_ms']:.4f} ms; tile {t['pixels']} px x "
            f"{t['columns']} cols, {t['ring_stages']} x {t['k_depth']}-deep "
            f"ring, {t['smem_bytes']} B; {d['blocks_per_sm']} blocks an SM, "
            f"{d['blocks']} blocks, {d['waves']:.2f} waves")


def check_kernels(lib):
    from mrla_tpu_torch.kernels import (
        fused_epilogue,
        fused_epilogue_reference,
        megatail_covers,
        mrla_block_tail_fused_next,
        mrla_block_tail_fused_next_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {"epilogue": {}, "megatail": {}}
    for shape, (stage, _) in {**EPILOGUE_SHAPES, **DET_EPILOGUE_SHAPES,
                              **QUANT_NEW_SHAPES}.items():
        b, h, w, c = shape
        a = tail_inputs(gen, shape)
        y = fused_epilogue(**a)
        y_ref = fused_epilogue_reference(**a)
        err = (y.float() - y_ref.float()).abs().max().item()
        tol = ulp_tol(y_ref.float(), 1)
        # the mega-tail's y phase is the tap loop the epilogue's window
        # replaced (mrla_tail_y8): where it takes the shape, y must be its
        # bits
        same = None
        if megatail_covers(c, 256):
            w1 = torch.zeros(256, c, dtype=torch.bfloat16, device="cuda")
            same = torch.equal(y, mrla_block_tail_fused_next(
                **a, w1_next=w1, b1_next=torch.zeros(256, device="cuda"))[0])
        ptrs = [a[k].data_ptr() for k in ("out", "identity", "gate", "wv",
                                          "lam", "bn_scale", "bn_bias")]
        stream = torch.cuda.current_stream().cuda_stream
        ms = cuda_ms(lambda: lib.mrla_epilogue_bf16(
            *ptrs, y.data_ptr(), b, h, w, c, stream))
        plain_ms = cuda_ms(lambda: fused_epilogue_reference(**a), iters=5)
        n = b * h * w * c
        bound_ms, by = bound(3 * n * 2 + b * c * 4 + 12 * c * 4, 0,
                             TAIL_FP32_OPS * n)
        launch = window_launch(lib, "epilogue", shape)
        bits = ("n/a (the mega-tail takes no C = %d)" % c if same is None
                else "bitwise the mega-tail's" if same
                else "DIFFERS FROM the mega-tail's")
        rows["epilogue"][shape] = dict(
            shape=f"{stage} [{b},{h},{w},{c}]", max_abs_err=err,
            tol=tol, y_bitwise_megatail_y=same, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=by, **launch)
        print(f"epilogue {stage} [{b},{h},{w},{c}] bf16: max|Δy| {err:.3g}"
              f" (tol {tol:.3g}: 1 bf16 ulp at max|y|; both round one fp32"
              f" value summed in another order); y {bits} | kernel"
              f" {ms:.4f} ms, bound"
              f" {bound_ms:.4f} ms ({by}), plain {plain_ms:.4f} ms | "
              f"{launch_text(launch)}")
        if not err <= tol:
            raise AssertionError(f"epilogue {stage}: {err} > {tol}")
        if same is False:
            raise AssertionError(f"epilogue {stage}: y is not the mega-tail's")
        del a, y, y_ref

    for shape, (stage, _) in {**MEGATAIL_SHAPES,
                              **DET_MEGATAIL_SHAPES}.items():
        b, h, w, c, c1 = shape
        a = tail_inputs(gen, shape[:4])
        w1 = (torch.randn(c1, c, generator=gen, device="cuda")
              / c ** 0.5).bfloat16()
        b1 = torch.randn(c1, generator=gen, device="cuda") * 0.2
        y, x1 = mrla_block_tail_fused_next(**a, w1_next=w1, b1_next=b1)
        y_ref, x1_ref = mrla_block_tail_fused_next_reference(
            **a, w1_next=w1, b1_next=b1)
        err_y = (y.float() - y_ref.float()).abs().max().item()
        err_x1 = (x1.float() - x1_ref.float()).abs().max().item()
        tol_y = ulp_tol(y_ref.float(), 1)
        tol_x1 = ulp_tol(x1_ref.float(), 2)
        ptrs = [a[k].data_ptr() for k in ("out", "identity", "gate", "wv",
                                          "lam", "bn_scale", "bn_bias")]
        stream = torch.cuda.current_stream().cuda_stream
        ms = cuda_ms(lambda: lib.mrla_megatail_bf16(
            *ptrs, w1.data_ptr(), b1.data_ptr(), y.data_ptr(), x1.data_ptr(),
            b, h, w, c, c1, stream))
        plain_ms = cuda_ms(lambda: mrla_block_tail_fused_next_reference(
            **a, w1_next=w1, b1_next=b1), iters=5)
        p = b * h * w
        n = p * c
        nbytes = (3 * n * 2 + p * c1 * 2 + c * c1 * 2 + c1 * 4
                  + b * c * 4 + 12 * c * 4)
        bound_ms, by = bound(nbytes, 2 * p * c * c1, TAIL_FP32_OPS * n)
        diag = tail_x1_diagnostics(lib, "megatail", a, w1, b1, shape)
        rows["megatail"][shape] = dict(
            shape=f"{stage} [{b},{h},{w},{c}] C1={c1}",
            max_abs_err=max(err_y, err_x1), tol=min(tol_y, tol_x1), ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, **diag)
        print(f"megatail {stage} [{b},{h},{w},{c}] C1={c1} bf16: "
              f"max|Δy| {err_y:.3g} (tol {tol_y:.3g}: 1 bf16 ulp at max|y|), "
              f"max|Δx1| {err_x1:.3g} (tol {tol_x1:.3g}: 2 bf16 ulps at "
              f"max|x1|, its own rounding plus y's one-ulp flips) | kernel "
              f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), plain "
              f"{plain_ms:.4f} ms | {diagnostics_text(diag)}")
        if not (err_y <= tol_y and err_x1 <= tol_x1):
            raise AssertionError(f"megatail {stage}: y {err_y} > {tol_y} or "
                                 f"x1 {err_x1} > {tol_x1}")
        del a, y, x1, y_ref, x1_ref
    rows["stage4"] = check_stage4(gen)
    rows["deit_tail"] = check_deit_tail(lib, gen)
    # the HWBC block tail launches the block-tail kernel: one set of rows
    rows["block_tail"] = rows["block_tail_hwbc"] = check_block_tail(lib, gen)
    rows["rowtail"] = check_rowtail(lib, gen)
    rows["copy"] = check_copy(lib, gen)
    torch.cuda.synchronize()
    return rows


def window_launch(lib, kind: str, shape) -> dict:
    """The launch of a window tail kernel (kind "block_tail" or
    "epilogue", csrc/tail_window.cuh) at ``shape`` (B, H, W, C), as its
    describe entry point reports it: the segment a thread walks, threads a
    block, columns in a thread's cp.async ring, blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), blocks and waves; the
    epilogue's also whether its window holds packed bf16 or fp32."""
    import ctypes

    from mrla_tpu_torch.kernels._build import check

    out = (ctypes.c_int * 6)()
    check(getattr(lib, f"mrla_{kind}_describe")(*shape, ctypes.addressof(out)),
          f"mrla_{kind}_describe {shape}")
    seg, threads, per_sm, blocks, stages, packed = out
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    d = dict(segment=seg, threads=threads, blocks_per_sm=per_sm,
             blocks=blocks, waves=blocks / (per_sm * sms),
             ring_columns=stages)
    if kind == "epilogue":
        d["window"] = "packed bf16" if packed else "fp32"
    return d


def launch_text(launch: dict) -> str:
    window = f", a {launch['window']} window" if "window" in launch else ""
    return (f"segment {launch['segment']} px, {launch['threads']} threads "
            f"a block, a ring of {launch['ring_columns']} columns{window}, "
            f"{launch['blocks_per_sm']} blocks an SM, {launch['blocks']} "
            f"blocks, {launch['waves']:.2f} waves")


def check_block_tail(lib, gen):
    """The block-tail kernel (the route's mrla_block_tail and
    mrla_block_tail_hwbc) against its plain version at every shape of the
    block_tail route and the JAX tests' shapes, with its launch (segment,
    blocks an SM, waves)."""
    from mrla_tpu_torch.kernels import (
        fused_block_tail,
        fused_block_tail_reference,
    )

    rows = {}
    shapes = {**HWBC_SHAPES, **BLOCK_TAIL_SHAPES}
    shapes.update({s: ("JAX test / odd", 0) for s in BLOCK_TAIL_EXTRA_SHAPES})
    for shape, (stage, _) in shapes.items():
        b, h, w, c = shape
        a = tail_inputs(gen, shape)
        a["z"] = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        args = [a[k] for k in ("z", "identity", "gate", "wv", "lam",
                               "bn_scale", "bn_bias")]
        y = fused_block_tail(*args)
        y_ref = fused_block_tail_reference(*args)
        err = (y.float() - y_ref.float()).abs().max().item()
        tol = ulp_tol(y_ref.float(), 1)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in args]
        ms = cuda_ms(lambda: lib.mrla_block_tail_bf16(
            *ptrs, y.data_ptr(), b, h, w, c, stream))
        plain_ms = cuda_ms(lambda: fused_block_tail_reference(*args), iters=5)
        n = b * h * w * c
        # relu(z + id) adds 2 operations an element to the epilogue's
        bound_ms, by = bound(3 * n * 2 + b * c * 4 + 12 * c * 4, 0,
                             (TAIL_FP32_OPS + 2) * n)
        launch = window_launch(lib, "block_tail", shape)
        rows[shape] = dict(
            shape=f"{stage} [{b},{h},{w},{c}]", max_abs_err=err, tol=tol,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
            **launch)
        print(f"block tail {stage} [{b},{h},{w},{c}] bf16: max|Δy| {err:.3g}"
              f" (tol {tol:.3g}: 1 bf16 ulp at max|y|) | kernel {ms:.4f} ms,"
              f" bound {bound_ms:.4f} ms ({by}), plain {plain_ms:.4f} ms | "
              f"{launch_text(launch)}")
        if not err <= tol:
            raise AssertionError(f"block tail {shape}: {err} > {tol}")
        del a, args, y, y_ref
    return rows


def check_rowtail(lib, gen):
    """The row-tail kernel against its plain version at every shape of the
    rowtail route and the JAX row-tail test's shapes, with and without x1."""
    from mrla_tpu_torch.kernels import mrla_rowtail, mrla_rowtail_reference
    from mrla_tpu_torch.kernels.mrla_rowtail import _fold

    rows = {}
    shapes = dict(ROWTAIL_SHAPES)
    shapes.update({s: ("JAX test", 0) for s in ROWTAIL_EXTRA_SHAPES})
    for shape, (stage, _) in shapes.items():
        b, h, w, c, c1 = shape
        a = tail_inputs(gen, shape[:4])
        args = [a[k] for k in ("out", "identity", "gate", "wv", "lam",
                               "bn_scale", "bn_bias")]
        w1 = (torch.randn(c1, c, generator=gen, device="cuda")
              / c ** 0.5).bfloat16()
        b1 = torch.randn(c1, generator=gen, device="cuda") * 0.2
        extra = [w1, b1] if c1 else []
        got = mrla_rowtail(*args, *extra)
        want = mrla_rowtail_reference(*args, *extra)
        y, y_ref = (got[0], want[0]) if c1 else (got, want)
        err_y = (y.float() - y_ref.float()).abs().max().item()
        tol_y = ulp_tol(y_ref.float(), 1)
        err_x1, tol_x1 = 0.0, math.inf
        if c1:
            err_x1 = (got[1].float() - want[1].float()).abs().max().item()
            tol_x1 = ulp_tol(want[1].float(), 2)
        gs, ls = _fold(a["gate"], a["lam"], a["bn_scale"])
        x1 = got[1] if c1 else None
        ptr = lambda t: t.data_ptr() if t is not None else None
        ptrs = [a["out"].data_ptr(), a["identity"].data_ptr(), gs.data_ptr(),
                a["wv"].data_ptr(), ls.data_ptr(), a["bn_bias"].data_ptr(),
                ptr(w1 if c1 else None), ptr(b1 if c1 else None),
                y.data_ptr(), ptr(x1)]
        stream = torch.cuda.current_stream().cuda_stream
        ms = cuda_ms(lambda: lib.mrla_rowtail_bf16(*ptrs, b, h, w, c, c1,
                                                   stream))
        plain_ms = cuda_ms(lambda: mrla_rowtail_reference(*args, *extra),
                           iters=5)
        p = b * h * w
        n = p * c
        nbytes = (3 * n * 2 + p * c1 * 2 + c * c1 * 2 + c1 * 4 + b * c * 4
                  + 11 * c * 4)
        bound_ms, by = bound(nbytes, 2 * p * c * c1, TAIL_FP32_OPS * n)
        diag = (tail_x1_diagnostics(lib, "rowtail", a, w1, b1, shape)
                if c1 else {})
        rows[shape] = dict(
            shape=f"{stage} [{b},{h},{w},{c}] C1={c1}",
            max_abs_err=max(err_y, err_x1), tol=min(tol_y, tol_x1), ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, **diag)
        print(f"row tail {stage} [{b},{h},{w},{c}] C1={c1} bf16: max|Δy| "
              f"{err_y:.3g} (tol {tol_y:.3g}: 1 bf16 ulp at max|y|), "
              f"max|Δx1| {err_x1:.3g} (tol {tol_x1:.3g}: 2 bf16 ulps at "
              f"max|x1|) | kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({by}), plain {plain_ms:.4f} ms"
              + (f" | {diagnostics_text(diag)}" if diag else ""))
        if not (err_y <= tol_y and err_x1 <= tol_x1):
            raise AssertionError(f"row tail {shape}: y {err_y} > {tol_y} or "
                                 f"x1 {err_x1} > {tol_x1}")
        del a, args, got, want, y, y_ref, x1
    return rows


def check_copy(lib, gen):
    """The copy kernel held bitwise to its input at the copy route's shape
    and odd ones, a new tensor each time, through the wrapper and through
    its C entry point over a NaN-filled buffer; the kernel and x.clone()
    timed in turns: clone, kernel, kernel, clone, each reading the mean of
    100 launches after 20 (they differ by tenths of a percent).  ms is the
    kernel's two readings' mean, library_ms the clones'."""
    from mrla_tpu_torch.kernels import hwbc_copy, hwbc_copy_reference
    from mrla_tpu_torch.kernels._build import check

    rows = {}
    shapes = dict(COPY_SHAPES)
    shapes.update({s: ("odd", 0) for s in COPY_EXTRA_SHAPES})
    stream = torch.cuda.current_stream().cuda_stream
    for shape, (stage, _) in shapes.items():
        b, h, w, c = shape
        x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        y = hwbc_copy(x)
        z = torch.full_like(x, float("nan"))
        launch = lambda: lib.hwbc_copy_bf16(x.data_ptr(), z.data_ptr(), b, h,
                                            w, c, stream)
        check(launch(), "hwbc_copy_bf16")
        torch.cuda.synchronize()
        same = (torch.equal(y, x) and y.data_ptr() != x.data_ptr()
                and torch.equal(z, x))
        ms_of = lambda fn: cuda_ms(fn, iters=100, warmup=20)
        turns = [ms_of(lambda: x.clone()), ms_of(launch), ms_of(launch),
                 ms_of(lambda: x.clone())]
        clone, kernel = turns[::3], turns[1:3]
        ms = sum(kernel) / 2
        library_ms = sum(clone) / 2
        plain_ms = cuda_ms(lambda: hwbc_copy_reference(x), iters=5)
        n = b * h * w * c
        bound_ms, by = bound(4 * n, 0, 0)
        rows[shape] = dict(
            shape=f"{stage} [{b},{h},{w},{c}]", max_abs_err=0.0 if same else
            (y.float() - x.float()).abs().max().item(), tol=0.0, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
            library_ms=library_ms, clone_ms=clone, kernel_ms=kernel)
        print(f"copy {stage} [{b},{h},{w},{c}] bf16: "
              f"{'bitwise equal, a new tensor' if same else 'DIFFERS'} (the "
              f"wrapper and the entry point) | kernel {ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({by}), plain {plain_ms:.4f} ms, x.clone() "
              f"{library_ms:.4f} ms | in turns: "
              + ", ".join(f"{t:.4f}" for t in turns) + " ms")
        if not same:
            raise AssertionError(f"copy {shape}: not a new equal tensor")
        del x, y, z
    return rows


def deit_tail_plan(lib, b, n, c) -> str:
    """The token tail's two passes at [b, n, c] as the kernel reports them
    (deit_token_tail_describe): each pass's block, registers, spills and
    blocks an SM, pass 2's grid and ring."""
    import ctypes

    from mrla_tpu_torch.kernels._build import check

    out = (ctypes.c_int * 15)()
    check(lib.deit_token_tail_describe(b, n, c, ctypes.addressof(out)),
          f"deit_token_tail_describe [{b},{n},{c}]")
    o = list(out)
    return (f"pass 1: a block of {o[14]} threads an image, {o[0]} registers,"
            f" {o[1]} B spilled, {o[3]} B shared, {o[4]} blocks an SM; pass "
            f"2: {o[12]} blocks of {o[10]} threads ({o[11]} grid rows), "
            f"{o[5]} registers, {o[6]} B spilled, {o[8]} B shared, {o[9]} "
            f"blocks an SM, a ring of {o[13]} columns")


def check_deit_tail(lib, gen):
    """The DeiT token tail against its plain version at the main path's
    shape, the other published widths, a batch of 3 and the 384 px grid,
    from seeded tokens and weights (mrla_tpu_torch/testing.py); two
    launches bitwise equal; the cls rows blind to ot."""
    from mrla_tpu_torch.kernels import (
        deit_token_tail,
        deit_token_tail_reference,
    )
    from mrla_tpu_torch.testing import deit_tail_case

    rows = {}
    for shape in list(DEIT_TAIL_SHAPES) + DEIT_TAIL_EXTRA_SHAPES:
        b, n, c = shape
        x, ot, packed = deit_tail_case(gen, b, n, c)
        out = deit_token_tail(x, ot, packed)
        again = deit_token_tail(x, ot, packed)
        torch.cuda.synchronize()
        rerun_same = torch.equal(out, again)
        ref = deit_token_tail_reference(x, ot, packed)
        err = (out.float() - ref.float()).abs().max().item()
        tol = ulp_tol(ref.float(), 1)
        # the cls rows take x + LN_x(x) and must not see ot
        cls_same = torch.equal(deit_token_tail(x, ot * 2, packed)[:, 0],
                               out[:, 0])
        ktap = packed.taps.shape[1]
        scratch = torch.empty(
            b * lib.deit_token_tail_scratch_per_image(n, c, 16, ktap),
            device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        ms = cuda_ms(lambda: lib.deit_token_tail_bf16(
            x.data_ptr(), ot.data_ptr(), packed.vec.data_ptr(),
            packed.taps.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            b, n, c, 16, ktap, stream))
        plain_ms = cuda_ms(
            lambda: deit_token_tail_reference(x, ot, packed), iters=5)
        elems = b * n * c
        bound_ms, by = bound(3 * elems * 2 + 14 * c * 4 + 2 * ktap * 4, 0,
                             DEIT_TAIL_FP32_OPS * elems)
        rows[shape] = dict(
            shape=f"x, ot [{b},{n},{c}]", max_abs_err=err, tol=tol,
            reruns_bitwise_equal=rerun_same, cls_rows_unchanged=cls_same,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)
        print(f"deit tail [{b},{n},{c}] bf16: max|Δout| {err:.3g} (tol "
              f"{tol:.3g}: 1 bf16 ulp at max|out| = "
              f"{ref.float().abs().max().item():.3g}; both round one fp32 "
              f"value summed in another order); two launches "
              f"{'bitwise equal' if rerun_same else 'DIFFER'}; cls rows with "
              f"ot doubled {'unchanged' if cls_same else 'CHANGED'} | kernel "
              f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), plain "
              f"{plain_ms:.4f} ms | {deit_tail_plan(lib, b, n, c)}")
        if not err <= tol:
            raise AssertionError(f"deit tail {shape}: {err} > {tol}")
        if not rerun_same:
            raise AssertionError(f"deit tail {shape}: two launches differ")
        if not cls_same:
            raise AssertionError(f"deit tail {shape}: the cls rows depend "
                                 "on ot")
        del x, ot, out, again, ref, scratch
    return rows


STAGE4_STEPS = ("id0", "z0 + tail 0", "x1 1", "o 1", "z1 + tail 1", "x1 2",
                "o 2", "z2 + tail 2")


def stage4_plan(lib, b, cin, c1, c) -> str:
    """The stage kernel's eight launches at batch b as the kernel reports
    them (mrla_stage4_describe): tiles, blocks, tile shape and waves (two
    consumer warpgroups a block).  Each launch's tiles must cover the
    B * 49 rows once (the last tile may run past them) and its 128-channel
    columns, and its blocks fit the card's shared memory."""
    import ctypes

    from mrla_tpu_torch.kernels._build import check

    plan = (ctypes.c_int * 48)()
    check(lib.mrla_stage4_describe(b, cin, c1, c, ctypes.addressof(plan)),
          "mrla_stage4_describe")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    m = b * 49
    parts = []
    for i, step in enumerate(STAGE4_STEPS):
        tiles, blocks, rows, cols, stages, smem = plan[6 * i:6 * i + 6]
        n = c if step.startswith(("id0", "z")) else c1
        m_tiles, rest = divmod(tiles, n // 128)
        if (rest or not (m_tiles - 1) * rows < m <= m_tiles * rows
                or cols < 128 or blocks != min(tiles, sms)
                or not 0 < smem <= 232448):  # a block's most on sm_90
            raise AssertionError(f"stage4 plan of {step} at B = {b}: "
                                 f"{list(plan[6 * i:6 * i + 6])}")
        parts.append(f"{step}: {tiles} tiles {rows}x{cols}, {blocks} blocks, "
                     f"{stages} stages, {tiles / (2 * sms):.2f} waves")
    return "; ".join(parts)


def check_stage4(gen):
    """The stage kernel against its plain version at the main path's shape,
    from seeded weights scaled by fan-in (mrla_tpu_torch/testing.py); two
    launches bitwise equal; each launch's tiles and waves."""
    from mrla_tpu_torch.kernels import (
        stage4_resident,
        stage4_resident_reference,
    )
    from mrla_tpu_torch.kernels._build import library
    from mrla_tpu_torch.testing import stage4_case

    rows = {}
    for shape, (stage, _) in STAGE4_SHAPES.items():
        b, cin, c1, c = shape
        # xs is a strided view of the stage's input, read in place
        ob, xs, packed = stage4_case(gen, b, cin, c1, c)
        y = stage4_resident(ob, xs, packed)
        again = stage4_resident(ob, xs, packed)
        torch.cuda.synchronize()
        rerun_same = torch.equal(y, again)
        y_ref = stage4_resident_reference(ob, xs, packed)
        err = (y.float() - y_ref.float()).abs().max().item()
        tol = ulp_tol(y_ref.float(), 2)
        ms = cuda_ms(lambda: stage4_resident(ob, xs, packed))
        plain_ms = cuda_ms(lambda: stage4_resident_reference(ob, xs, packed),
                           iters=3, warmup=1)
        m = b * 49
        weights = c1 * c + cin * c + 2 * (c * c1 + 9 * c1 * c1 + c1 * c)
        vectors = (2 * c + 2 * 2 * c1 + 2 * c + 3 * 12 * c) * 4
        nbytes = 2 * weights + 2 * m * (c1 + cin + c) + vectors
        bound_ms, by = bound(nbytes, 2 * m * weights,
                             3 * TAIL_FP32_OPS * m * c)
        plan = stage4_plan(library(), b, cin, c1, c)
        rows[shape] = dict(
            shape=f"{stage} ob [{b},7,7,{c1}] xs [{b},7,7,{cin}] -> "
                  f"[{b},7,7,{c}]", max_abs_err=err, tol=tol, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, plan=plan)
        print(f"stage4 {rows[shape]['shape']} bf16: max|Δy| {err:.3g} (tol "
              f"{tol:.3g}: 2 bf16 ulps at max|y| = "
              f"{y_ref.float().abs().max().item():.3g}; y's own rounding of "
              f"fp32 sums taken in another order, plus the rare one-ulp "
              f"flips of the bf16 y, x1 and o that travel on); two launches "
              f"{'bitwise equal' if rerun_same else 'DIFFER'} | kernel "
              f"{ms:.4f} ms ({2 * m * weights / ms / 1e9:.1f} TFLOP/s), "
              f"bound {bound_ms:.4f} ms ({by}), plain {plain_ms:.4f} ms | "
              f"{plan}")
        if not err <= tol:
            raise AssertionError(f"stage4: {err} > {tol}")
        if not rerun_same:
            raise AssertionError("stage4: two launches differ")
    return rows


RESNET_PATHS = {False: "use_stage4=False", True: "use_stage4=True"}
DEIT_PATH = "deit_mrlal_small"


def all_counters():
    """Every kernel wrapper's launch counter, by the kernels line's key."""
    from mrla_tpu_torch.parallel.checks import kernel_counters

    return kernel_counters()


def check_logits_out(out) -> None:
    if out.shape != (BATCH, 1000) or not torch.isfinite(out).all():
        raise AssertionError("logits not finite or of the wrong shape")


def counted(forward, batches, route: str, want: dict,
            check_out=check_logits_out, desc=f"{PX}px bs{BATCH} bf16"):
    """Drive a main path: every wrapper's counts are set to 0 just before
    the requests and read just after.  The launches per forward by shape
    must be exactly ``want``, and ``check_out`` must pass on every output.
    Returns (outputs, launches, launches per forward by shape)."""
    counters = all_counters()
    for c in counters.values():
        c.reset()
    outs = [forward(xb) for xb in batches]
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    per_forward = {k: {s: n / len(batches) for s, n in c.by_shape.items()}
                   for k, c in counters.items()}
    print(f"serving {route}, {desc}, {len(batches)} requests: "
          f"launches {launches}; per forward by shape {per_forward}")
    if per_forward != want:
        raise AssertionError(f"{route}: launches per forward "
                             f"{per_forward} != {want}")
    for out in outs:
        try:
            check_out(out)
        except AssertionError as e:
            raise AssertionError(f"{route}: {e}") from None
    return outs, launches, per_forward


def throughput(forward, batches, route: str, smi: str,
               consume=lambda out: out.sum(), batch=BATCH,
               desc=f"{PX}px bs{BATCH} bf16"):
    """img/s of ``forward`` over TIMED_FORWARDS forwards ending in a
    synchronize, after two, every output consumed; and the peak memory."""
    torch.cuda.reset_peak_memory_stats()
    total = torch.zeros((), device="cuda")
    for xb in batches[:2]:
        total += consume(forward(xb))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TIMED_FORWARDS):  # every output consumed
        total += consume(forward(batches[i % len(batches)]))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not torch.isfinite(total):
        raise AssertionError("non-finite outputs in the timed run")
    print(f"throughput {route}, {desc}: "
          f"{TIMED_FORWARDS * batch / dt:.1f} img/s "
          f"({dt / TIMED_FORWARDS * 1e3:.2f} ms/forward over "
          f"{TIMED_FORWARDS} forwards), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, on {smi}")


def serve(smi: str):
    from mrla_tpu_torch.serving import (
        attach_stage4,
        prepare_inference_params,
        resnet_mrlal_forward,
    )
    from mrla_tpu_torch.testing import images, serving_model

    model = serving_model(0)
    params = attach_stage4(prepare_inference_params(
        model, dtype=torch.bfloat16, device="cuda"))
    gen = torch.Generator().manual_seed(1)
    host_batches = [images(gen, BATCH, PX) for _ in range(REQUESTS)]
    batches = [xb.cuda() for xb in host_batches]
    tables = {k: {} for k in all_counters()}
    tables.update(megatail=MEGATAIL_SHAPES, epilogue=EPILOGUE_SHAPES,
                  stage4=STAGE4_SHAPES)
    stage4_epilogues = {s: v for s, v in EPILOGUE_SHAPES.items()
                        if v[0] == "stage4"}
    with torch.no_grad():
        ref = model(host_batches[0][:32])  # the port's fp32 CPU forward

    def forward(use_stage4):
        return lambda xb: resnet_mrlal_forward(params, xb,
                                               use_stage4=use_stage4)

    launches, per_forward = {}, {}
    for use_stage4 in (False, True):
        route = RESNET_PATHS[use_stage4]
        want = {k: {s: n for s, (_, n) in table.items()}
                for k, table in tables.items()}
        if use_stage4:
            for s in stage4_epilogues:
                del want["epilogue"][s]
        else:
            want["stage4"] = {}
        logits, launches[route], per_forward[route] = counted(
            forward(use_stage4), batches, f"resnet50_mrlal {route}", want)
        check_logits(ref, logits[0][:32].cpu(), route, LOGIT_ERROR_TOL)
        check_faults(params, host_batches[0][:32].cuda(), ref, use_stage4)

    for use_stage4 in (False, True, True, False):  # in turns, on one card
        throughput(forward(use_stage4), batches,
                   f"resnet50_mrlal {RESNET_PATHS[use_stage4]}", smi)
    tail_launches, tail_per_forward = serve_tail_routes(
        params, batches, host_batches, ref, forward(False), smi)
    launches.update(tail_launches)
    per_forward.update(tail_per_forward)
    return launches, per_forward


def serve_tail_routes(params, batches, host_batches, ref, default, smi):
    """The three tail routes (serving/tail_routes.py) on the serving params
    of serve(): counted requests, the logit check against the same fp32 CPU
    forward with one injected fault per route, the copy route bitwise equal
    to the block-tail route, and img/s in turns with the default route."""
    from mrla_tpu_torch.serving import resnet_mrlal_tail_forward

    def forward(tail):
        return lambda xb: resnet_mrlal_tail_forward(params, xb, tail)

    launches, per_forward, logits = {}, {}, {}
    for tail, table in TAIL_TABLES.items():
        route = TAIL_PATHS[tail]
        want = {k: {} for k in all_counters()}
        for key, shapes in table.items():
            want[key] = {s: n for s, (_, n) in shapes.items()}
        logits[tail], launches[route], per_forward[route] = counted(
            forward(tail), batches, f"resnet50_mrlal {route}", want)
        check_logits(ref, logits[tail][0][:32].cpu(), route, LOGIT_ERROR_TOL)
    same = all(torch.equal(a, b) for a, b in zip(logits["copy"],
                                                 logits["block_tail"]))
    print(f"tail route copy: logits of the {len(batches)} requests "
          f"{'bitwise equal to' if same else 'DIFFER from'} the block_tail "
          f"route's")
    if not same:
        raise AssertionError("the copy route changes the logits")
    del logits

    x32 = host_batches[0][:32].cuda()
    errs = {f"{tail} {kind}@{at}": logit_error(
        faulty_tail_forward(params, x32, tail, kind, at), ref)
        for tail, faults in TAIL_FAULTS.items() for kind, at in faults}
    print("logit error with one wiring fault on a tail route (route "
          "kind@block or @copy): " + ", ".join(f"{k} {v:.4g}"
                                               for k, v in errs.items()))
    missed = [k for k, v in errs.items() if not v > LOGIT_ERROR_TOL]
    if missed:
        raise AssertionError(f"the logit check misses the faults {missed}")

    turns = [(RESNET_PATHS[False], default)] + [
        (route, forward(tail)) for tail, route in TAIL_PATHS.items()]
    for route, fn in turns + turns[::-1]:  # in turns, on one card
        throughput(fn, batches, f"resnet50_mrlal {route}", smi)
    return launches, per_forward


def faulty_tail_forward(params, x, tail: str, kind: str, at: int):
    """A tail route with one wiring fault (TAIL_FAULTS) at call ``at`` of
    its kernel wrapper."""
    import mrla_tpu_torch.serving.tail_routes as routes

    saved = {k: getattr(routes, k) for k in (
        "mrla_rowtail", "mrla_block_tail", "mrla_block_tail_hwbc",
        "hwbc_copy")}
    calls = itertools.count()

    def no_id(out, identity, *rest):
        if next(calls) == at:
            identity = torch.zeros_like(identity)
        return saved["mrla_rowtail"](out, identity, *rest)

    def swapped(name):
        def tail_fn(z, identity, *rest):
            if next(calls) == at:
                z, identity = identity, z
            return saved[name](z, identity, *rest)
        return tail_fn

    previous = []

    def stale(y):
        i = next(calls)
        previous.append(y)
        return saved["hwbc_copy"](previous[i - 1] if i == at else y)

    if kind == "no_id":
        routes.mrla_rowtail = no_id
    elif kind == "swap":
        routes.mrla_block_tail = swapped("mrla_block_tail")
        routes.mrla_block_tail_hwbc = swapped("mrla_block_tail_hwbc")
    else:
        routes.hwbc_copy = stale
    try:
        return routes.resnet_mrlal_tail_forward(params, x, tail).cpu()
    finally:
        for k, v in saved.items():
            setattr(routes, k, v)


def serve_deit(smi: str):
    """The DeiT main path: serving, the logit check with its four injected
    faults, and throughput.  Returns (launches, launches per forward by
    shape) of the four requests, keyed as serve()'s."""
    from mrla_tpu_torch.serving import (
        deit_forward,
        prepare_deit_inference_params,
    )
    from mrla_tpu_torch.testing import deit_serving_model, images

    model = deit_serving_model(DEIT_ARCH, 0)
    params = prepare_deit_inference_params(model, device="cuda",
                                           dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(2)
    host_batches = [images(gen, BATCH, PX) for _ in range(REQUESTS)]
    batches = [xb.cuda() for xb in host_batches]
    with torch.no_grad():
        ref = model(host_batches[0][:32])  # the port's fp32 CPU forward

    forward = lambda xb: deit_forward(params, xb)
    want = {k: {} for k in all_counters()}
    want["deit_tail"] = {s: n for s, (_, n) in DEIT_TAIL_SHAPES.items()}
    logits, launches, per_forward = counted(forward, batches, DEIT_ARCH, want)
    check_logits(ref, logits[0][:32].cpu(), DEIT_PATH, DEIT_LOGIT_ERROR_TOL)
    x32 = host_batches[0][:32].cuda()
    errs = {kind: logit_error(faulty_deit_forward(params, x32, kind), ref)
            for kind in DEIT_FAULTS}
    print(f"logit error with {DEIT_PATH}, one wiring fault in every block: "
          + ", ".join(f"{k} {v:.4g}" for k, v in errs.items()))
    missed = [k for k, v in errs.items() if not v > DEIT_LOGIT_ERROR_TOL]
    if missed:
        raise AssertionError(f"the logit check misses the faults {missed}")

    for _ in range(2):
        throughput(forward, batches, DEIT_ARCH, smi)
    return launches, per_forward


# ot: the tail's ot taken after the attention residual, not the block input;
# next: block i's tail run with block i + 1's packed params (the last with
# the first's); cls: the cls row sent through the MRLA branch as a grid
# token without neighbours; heads: the gate's heads shifted by one
DEIT_FAULTS = ("ot", "next", "cls", "heads")


def faulty_deit_forward(params, x, kind: str) -> torch.Tensor:
    """The DeiT engine with one wiring fault (DEIT_FAULTS) in every block.
    The grid rows of the last block never reach the logits, so a fault in
    one block alone could go unseen by construction."""
    import torch.nn.functional as F

    import mrla_tpu_torch.serving.deit as eng
    from mrla_tpu_torch.kernels.deit_token_tail import tail_terms

    block, tail = eng._block, eng.deit_token_tail
    blocks = params["blocks"]

    def faulty_block(x, p, heads, d):
        y = F.linear(eng._layer_norm(x, *p["norm1"]), *p["qkv"])
        x1 = F.linear(eng.attention(y, heads), *p["proj"]).add_(x)
        y = F.gelu(F.linear(eng._layer_norm(x1, *p["norm2"]), *p["fc1"]))
        return tail(F.linear(y, *p["fc2"]).add_(x1), x1, p["tail"], d)

    def faulty_tail(x, ot, packed, d):
        if kind == "next":
            at = next(i for i, p in enumerate(blocks) if p["tail"] is packed)
            return tail(x, ot, blocks[(at + 1) % len(blocks)]["tail"], d)
        x32, normx, normo, gate, v = tail_terms(x, ot, packed, d)
        lam = packed.vec[4]
        if kind == "heads":
            gate = gate.roll(d, dims=-1)
        cls = x32[:, :1] + normx[:, :1]
        if kind == "cls":  # the centre tap alone: no neighbours
            cls = (x32[:, :1] + F.gelu(normx[:, :1] * packed.vec[9])
                   * gate[:, None] + lam * normo[:, :1])
        grid = x32[:, 1:] + v * gate[:, None] + lam * normo[:, 1:]
        return torch.cat([cls, grid], dim=1).to(x.dtype)

    if kind == "ot":
        eng._block = faulty_block
    else:
        eng.deit_token_tail = faulty_tail
    try:
        return eng.deit_forward(params, x).cpu()
    finally:
        eng._block, eng.deit_token_tail = block, tail


def no_kernels():
    """A counted path's table for a path that launches none of the port's
    kernels."""
    return {k: {} for k in all_counters()}


def max_delta(a, b) -> float:
    return max((x.float() - y.float()).abs().max().item()
               for x, y in zip(a, b))


def serve_mrlab(smi: str):
    """The MRLA-base paths: resnet50_mrlab in both cache forms (the logit
    check with its three injected faults, the forms against each other,
    img/s in turns), resnet50_mrlab22 and deit_mrlab_small (the logit
    check; the DeiT one with its fault).  None of them may launch a kernel
    of the port.  Returns (launches, launches per forward by shape) keyed by
    path, as serve()'s."""
    from mrla_tpu_torch.serving import (
        deit_forward,
        prepare_deit_inference_params,
        prepare_mrlab_inference_params,
        resnet_mrlab_forward,
    )
    from mrla_tpu_torch.testing import (
        deit_serving_model,
        images,
        mrlab_serving_model,
    )

    gen = torch.Generator().manual_seed(3)
    host_batches = [images(gen, BATCH, PX) for _ in range(REQUESTS)]
    batches = [xb.cuda() for xb in host_batches]
    x32 = batches[0][:32]
    launches, per_forward = {}, {}

    model = mrlab_serving_model(0)
    params = prepare_mrlab_inference_params(model, device="cuda")
    with torch.no_grad():
        ref = model(host_batches[0][:32])  # the port's fp32 CPU forward
    del model

    def forward(use_scan):
        return lambda xb: resnet_mrlab_forward(params, xb, use_scan=use_scan)

    logits = {}
    for use_scan, path in MRLAB_PATHS.items():
        logits[use_scan], launches[path], per_forward[path] = counted(
            forward(use_scan), batches, path, no_kernels())
        check_logits(ref, logits[use_scan][0][:32].cpu(), path,
                     MRLAB_LOGIT_ERROR_TOL)
    print(f"{MRLAB_ARCH}: max|Δlogit| between the growing and the masked "
          f"cache forms over the {len(batches)} requests: "
          f"{max_delta(logits[False], logits[True]):.4g}")
    del logits
    errs = {kind: logit_error(faulty_mrlab_forward(params, x32, kind), ref)
            for kind in MRLAB_FAULTS}
    print(f"logit error with {MRLAB_ARCH}, one wiring fault in every block "
          "(sound reading above): "
          + ", ".join(f"{k} {v:.4g}" for k, v in errs.items()))
    missed = [k for k, v in errs.items() if not v > MRLAB_LOGIT_ERROR_TOL]
    if missed:
        raise AssertionError(f"the logit check misses the faults {missed}")
    for use_scan in (False, True, True, False):  # in turns, on one card
        throughput(forward(use_scan), batches, MRLAB_PATHS[use_scan], smi)
    del params

    model = mrlab_serving_model(0, MRLAB22_ARCH)
    params = prepare_mrlab_inference_params(model, device="cuda",
                                            deep_stem=False)
    with torch.no_grad():
        ref = model(host_batches[0][:32])
    del model
    fwd22 = lambda xb: resnet_mrlab_forward(params, xb, relu_on_attn=False)
    out, launches[MRLAB22_PATH], per_forward[MRLAB22_PATH] = counted(
        fwd22, batches[:2], MRLAB22_PATH, no_kernels())
    check_logits(ref, out[0][:32].cpu(), MRLAB22_PATH, MRLAB_LOGIT_ERROR_TOL)
    throughput(fwd22, batches, MRLAB22_PATH, smi)
    del params, out

    model = deit_serving_model(DEIT_MRLAB_ARCH, 0)
    params = prepare_deit_inference_params(model, device="cuda")
    with torch.no_grad():
        ref = model(host_batches[0][:32])
    del model
    fwd_deit = lambda xb: deit_forward(params, xb)
    out, launches[DEIT_MRLAB_PATH], per_forward[DEIT_MRLAB_PATH] = counted(
        fwd_deit, batches, DEIT_MRLAB_PATH, no_kernels())
    check_logits(ref, out[0][:32].cpu(), DEIT_MRLAB_PATH,
                 DEIT_MRLAB_LOGIT_ERROR_TOL)
    period, params["mrlab_size"] = params["mrlab_size"], len(params["blocks"])
    try:  # the fault: the cache never restarts
        err = logit_error(deit_forward(params, x32).cpu(), ref)
    finally:
        params["mrlab_size"] = period
    print(f"logit error with {DEIT_MRLAB_PATH}, the cache never restarted: "
          f"{err:.4g}")
    if not err > DEIT_MRLAB_LOGIT_ERROR_TOL:
        raise AssertionError("the logit check misses the fault")
    for _ in range(2):
        throughput(fwd_deit, batches, DEIT_MRLAB_PATH, smi)
    return launches, per_forward


def faulty_mrlab_forward(params, x, kind: str) -> torch.Tensor:
    """The resnet50_mrlab engine (growing cache) with one wiring fault
    (MRLAB_FAULTS) in every block."""
    import mrla_tpu_torch.serving.resnet_mrlab as eng
    from mrla_tpu_torch.ops import mrla as ops

    if kind == "no_relu":
        return eng.resnet_mrlab_forward(params, x, relu_on_attn=False).cpu()
    attend = eng.mrla_base_attention

    def own_layer_only(out, p, heads, cache, max_t=None):
        return attend(out, p, heads, None)[0], cache

    def sigmoid_over_t(out, p, heads, cache, max_t=None):
        q, k_t, v_t = ops._qkv(out, p, heads)
        cache = ops.MRLACache(ops._append(cache.k, k_t),
                              ops._append(cache.v, v_t))
        attn = torch.sigmoid(ops._logits(q, cache.k, heads))
        return ops._weighted_sum(attn, cache.v, cache.k.shape[1]), cache

    eng.mrla_base_attention = (own_layer_only if kind == "no_cache"
                               else sigmoid_over_t)
    try:
        return eng.resnet_mrlab_forward(params, x).cpu()
    finally:
        eng.mrla_base_attention = attend


def check_microbatch(smi: str):
    """resnet_mrlal_forward with microbatch=MICROBATCH and shared_stem
    against the unsplit forward, on serve()'s seeded params and requests:
    the logits within LOGIT_ERROR_TOL of each other (a convolution may take
    another algorithm at batch 32 than at 128, so no bits are promised on
    the card), and img/s of both in turns."""
    from mrla_tpu_torch.serving import (
        prepare_inference_params,
        resnet_mrlal_forward,
    )
    from mrla_tpu_torch.testing import images, serving_model

    params = prepare_inference_params(serving_model(0), device="cuda")
    gen = torch.Generator().manual_seed(1)
    batches = [images(gen, BATCH, PX).cuda() for _ in range(REQUESTS)]
    unsplit = lambda xb: resnet_mrlal_forward(params, xb)
    split = lambda xb: resnet_mrlal_forward(params, xb, microbatch=MICROBATCH,
                                            shared_stem=True)
    a = [unsplit(xb) for xb in batches]
    b = [split(xb) for xb in batches]
    for out in b:
        check_logits_out(out)
    err = max(logit_error(y.cpu(), x.cpu()) for x, y in zip(a, b))
    print(f"resnet50_mrlal microbatch={MICROBATCH} shared_stem=True against "
          f"the unsplit forward, {len(batches)} requests: max|Δlogit| "
          f"{max_delta(a, b):.4g}, logit error {err:.4g} (tol "
          f"{LOGIT_ERROR_TOL}); bitwise equal: "
          f"{all(torch.equal(x, y) for x, y in zip(a, b))}")
    if not err <= LOGIT_ERROR_TOL:
        raise AssertionError(f"microbatch: logit error {err}")
    route = f"resnet50_mrlal microbatch={MICROBATCH} shared_stem"
    for fn, name in [(unsplit, "resnet50_mrlal unsplit"), (split, route),
                     (split, route), (unsplit, "resnet50_mrlal unsplit")]:
        throughput(fn, batches, name, smi)


def logit_error(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| over the part of ``ref`` that differs from image to
    image, ||ref - its mean over the images||.  With random weights most of
    each logit is shared by every image, so an error measured against the
    logits themselves would hide a fault that leaves that share in place."""
    return ((got - ref).norm() / (ref - ref.mean(0)).norm()).item()


def faulty_forward(params, x, kind: str, at: int) -> torch.Tensor:
    """The serving engine with one wiring fault in block ``at`` (its tail
    call): ``handoff`` passes on x1 = relu(conv1(out)) of the block's map
    before the tail instead of conv1 of y; ``identity`` gives the tail the
    block's own map as its identity."""
    import mrla_tpu_torch.serving.resnet_mrlal as eng

    tail, epi = eng.mrla_block_tail_fused_next, eng.mrla_light_epilogue
    calls = itertools.count()

    def faulty_tail(out, identity, *rest):
        hit = next(calls) == at
        y, x1 = tail(out, out if hit and kind == "identity" else identity,
                     *rest)
        if hit and kind == "handoff":
            x1 = eng._conv(out, rest[-2], rest[-1]).relu_()
        return y, x1

    def faulty_epi(out, identity, *rest):
        hit = next(calls) == at
        return epi(out, out if hit and kind == "identity" else identity,
                   *rest)

    eng.mrla_block_tail_fused_next, eng.mrla_light_epilogue = (faulty_tail,
                                                              faulty_epi)
    try:
        return eng.resnet_mrlal_forward(params, x).cpu()
    finally:
        eng.mrla_block_tail_fused_next, eng.mrla_light_epilogue = tail, epi


def faulty_stage4_forward(params, x, kind: str) -> torch.Tensor:
    """The use_stage4=True engine with one fault at the stage kernel:
    ``swapped`` packs blocks 1 and 2 in each other's place; ``xs`` hands the
    kernel the odd pixels x[:, 1::2, 1::2, :] of the stage's input."""
    import mrla_tpu_torch.serving.resnet_mrlal as eng
    from mrla_tpu_torch.kernels import pack_stage4_params

    kernel, packed = eng.stage4_resident, params["stage4"]

    def odd_pixels(ob, xs, p):
        shift = (xs.stride(1) + xs.stride(2)) // 2  # one row and one column
        return kernel(ob, xs.as_strided(xs.shape, xs.stride(),
                                        xs.storage_offset() + shift), p)

    if kind == "swapped":
        b0, b1, b2 = params["blocks"][-3:]
        params["stage4"] = pack_stage4_params([b0, b2, b1],
                                              dtype=b0["k3"].dtype)
    else:
        eng.stage4_resident = odd_pixels
    try:
        return eng.resnet_mrlal_forward(params, x, use_stage4=True).cpu()
    finally:
        eng.stage4_resident, params["stage4"] = kernel, packed


def check_logits(ref, got, route: str, tol: float):
    """The served bf16 logits of 32 (or 16) images against the port's own
    fp32 forward on the CPU: top-1 on the 8 clearest images, and
    logit_error within ``tol``."""
    # A random 1000-way head puts some images on a near tie, where the top-1
    # class is decided by rounding; the 8 with the largest fp32 top-1
    # margin are compared.
    top2 = ref.topk(2, dim=-1).values
    margins = top2[:, 0] - top2[:, 1]
    pick = margins.argsort(descending=True)[:8]
    err = logit_error(got, ref)
    print(f"{route}: top-1 vs the port's fp32 CPU forward on the 8 clearest "
          f"of {len(ref)} images: bf16 {got[pick].argmax(-1).tolist()} fp32 "
          f"{ref[pick].argmax(-1).tolist()}; least margin of the 8 "
          f"{margins[pick].min().item():.4g}; top-1 agrees on "
          f"{(got.argmax(-1) == ref.argmax(-1)).sum().item()}/{len(ref)}; "
          f"max|Δlogit|"
          f" {(got - ref).abs().max().item():.4g}, max|logit| "
          f"{ref.abs().max().item():.4g}; logit error {err:.4g} (tol "
          f"{tol})")
    if not torch.equal(got[pick].argmax(-1), ref[pick].argmax(-1)):
        raise AssertionError(f"{route}: top-1 disagrees with the fp32 CPU "
                             "forward")
    if not err <= tol:
        raise AssertionError(f"{route}: logit error {err} > {tol}")


def check_faults(params, x, ref, use_stage4: bool):
    """The same logit check on the engine with one wiring fault: on the
    per-block route, every block and both faults; on the stage-kernel
    route, the two faults at the stage kernel.  Each must fail the check,
    or the check could not see such a fault."""
    if use_stage4:
        errs = {kind: logit_error(faulty_stage4_forward(params, x, kind), ref)
                for kind in ("swapped", "xs")}
        label = "use_stage4=True, one fault at the stage kernel"
    else:
        faults = [("handoff", i) for i in range(
            sum(n for _, n in MEGATAIL_SHAPES.values()))]
        faults += [("identity", i) for i in range(len(params["blocks"]))]
        errs = {f"{kind}@{at}": logit_error(
            faulty_forward(params, x, kind, at), ref) for kind, at in faults}
        label = "use_stage4=False, one wiring fault (kind@block)"
    print(f"logit error with {label}: "
          + ", ".join(f"{k} {v:.4g}" for k, v in errs.items()))
    missed = [k for k, v in errs.items() if not v > LOGIT_ERROR_TOL]
    if missed:
        raise AssertionError(f"the logit check misses the faults {missed}")


def roi_axes(hw, b, geom, out_size: int, smax: int):
    """Each roi's two axis tables as the kernels build them (cells and
    weights of every bin and sample slot, detect/roi_align.py:axis_samples),
    with its level, image and validity."""
    from mrla_tpu_torch.detect.roi_align import axis_samples

    g = geom.reshape(-1, geom.shape[-1])
    p = geom.shape[1]
    lvl = g[:, 7].long()
    img = torch.arange(b, device=g.device).repeat_interleave(p)
    hs = torch.tensor([h for h, _ in hw], device=g.device)
    ws = torch.tensor([w for _, w in hw], device=g.device)
    ys = axis_samples(g[:, 0], g[:, 2], g[:, 4], hs[lvl], out_size, smax)
    xs = axis_samples(g[:, 1], g[:, 3], g[:, 5], ws[lvl], out_size, smax)
    return ys, xs, lvl, img, g[:, 6] > 0


def footprint_cells(hw, b, geom, out_size: int, smax: int) -> int:
    """Pyramid cells the rois' samples touch with a weight: the union over
    the valid rois of each roi's touched rows x touched columns."""
    (ylo, yhi, wylo, wyhi), (xlo, xhi, wxlo, wxhi), lvl, img, valid = \
        roi_axes(hw, b, geom, out_size, smax)
    rows = torch.cat([torch.where(wylo > 0, ylo, -1),
                      torch.where(wyhi > 0, yhi, -1)], -1).flatten(1)
    cols = torch.cat([torch.where(wxlo > 0, xlo, -1),
                      torch.where(wxhi > 0, xhi, -1)], -1).flatten(1)
    cells = 0
    for lv, (h, w) in enumerate(hw):
        m = valid & (lvl == lv)
        r, c, i = rows[m][:, :, None], cols[m][:, None, :], img[m]
        keep = (r >= 0) & (c >= 0)
        i = i[:, None, None].expand_as(keep)
        canvas = torch.zeros(b, h, w, dtype=torch.bool, device=geom.device)
        canvas[i[keep], r.expand_as(keep)[keep], c.expand_as(keep)[keep]] = 1
        cells += int(canvas.sum())
    return cells


def roi_work(feats, geom, out_size: int, smax: int, out_bytes: int):
    """(bytes, fp32 operations) that one RoIAlign over ``geom`` needs on
    this data: the pyramid cells the rois' samples touch read once, the
    output written once, the geometry read once; 4 corners x (multiply,
    add) per live sample and channel."""
    b, c = feats[0].shape[0], feats[0].shape[-1]
    hw = [tuple(f.shape[1:3]) for f in feats]
    (_, _, wylo, wyhi), (_, _, wxlo, wxhi), _, _, valid = \
        roi_axes(hw, b, geom, out_size, smax)
    n_y = ((wylo + wyhi) > 0).flatten(1).sum(1).double()
    n_x = ((wxlo + wxhi) > 0).flatten(1).sum(1).double()
    ops = (valid * n_y * n_x).sum().item() * c * ROI_FP32_OPS
    cells = footprint_cells(hw, b, geom, out_size, smax)
    nbytes = (cells * c * feats[0].element_size()
              + geom.shape[0] * geom.shape[1] * out_size ** 2 * c * out_bytes
              + geom.numel() * 4)
    return nbytes, ops


def grad_work(hw, b, c, geom, out_size: int, smax: int):
    """(bytes, fp32 operations) that one RoIAlign backward over ``geom``
    needs on this data: the valid rois' fp32 cotangent read once, the fp32
    gradient buffers written once, the geometry read once (what the kernel
    writes and reads again, its scratch and the rows of rois that meet
    several tiles, is its cost, not the function's); per valid roi, bin,
    channel and pair of distinct (y, x) cells of the bin one multiply and
    one add."""
    (ylo, yhi, wylo, wyhi), (xlo, xhi, wxlo, wxhi), _, _, valid = \
        roi_axes(hw, b, geom, out_size, smax)

    def distinct(lo, hi, wlo, whi):  # [R, O]: cells with weight, per bin
        cells = torch.cat([torch.where(wlo > 0, lo, -1),
                           torch.where(whi > 0, hi, -1)], -1).sort(-1).values
        new = torch.ones_like(cells, dtype=torch.bool)
        new[..., 1:] = cells[..., 1:] != cells[..., :-1]
        return (new & (cells >= 0)).sum(-1).double()

    n_y = distinct(ylo, yhi, wylo, wyhi).sum(1)
    n_x = distinct(xlo, xhi, wxlo, wxhi).sum(1)
    pairs = (valid * n_y * n_x).sum().item()
    buffers = sum(b * h * w for h, w in hw) * c * 4
    nbytes = (int(valid.sum()) * out_size ** 2 * c * 4 + buffers
              + geom.numel() * 4)
    return nbytes, 2 * pairs * c


def library_roi_align_ms(feats, geom, out_size: int, strides):
    """torchvision.ops.roi_align per level (aligned, adaptive grid) on the
    same rois, where torchvision is installed; else None.  A yardstick
    only: the port never calls it."""
    try:
        from torchvision.ops import roi_align
    except ImportError:
        return None
    g = geom.reshape(-1, geom.shape[-1])
    p = geom.shape[1]
    img = torch.arange(feats[0].shape[0], device=g.device).repeat_interleave(p)
    per_level = []
    for lv, (f, st) in enumerate(zip(feats, strides)):
        m = g[:, 7] == lv
        y1, x1 = g[m, 0] + 0.5, g[m, 1] + 0.5  # back to image coordinates
        y2 = y1 + g[m, 2] * out_size
        x2 = x1 + g[m, 3] * out_size
        boxes = torch.stack([img[m].float(), x1 * st, y1 * st, x2 * st,
                             y2 * st], 1)
        per_level.append((f.permute(0, 3, 1, 2), boxes, 1.0 / st))
    return cuda_ms(lambda: [roi_align(f, bx, out_size, sc, 0, True)
                            for f, bx, sc in per_level])


def roi_reruns(feats, geom, o: int, smax: int, got) -> bool:
    """Two launches of the forward's C entry point over NaN-filled outputs:
    True when both write every element and give ``got``'s bits."""
    from mrla_tpu_torch.kernels._build import check
    from mrla_tpu_torch.kernels.roialign_patch import launch_fwd

    ok = True
    for _ in range(2):
        out = torch.full_like(got, float("nan"))
        check(launch_fwd(feats, geom, out, smax), "roi_align_fwd")
        torch.cuda.synchronize()
        ok &= torch.equal(out, got)
    return ok


def check_roi_align(params):
    """The RoIAlign kernel against its plain version on the rois the
    detection path makes from seeded images: the proposals of the box head
    (8 x 1000, 7 x 7) and the detections of the mask head (8 x 100,
    14 x 14), through the wrapper in the path's bf16 form, and through the
    launcher in the fp32 form; both held to the plain version in fp32."""
    from mrla_tpu_torch.detect.roi_align import (
        roi_align_reference,
        roi_geometry,
    )
    from mrla_tpu_torch.detect.two_stage import ROI_STRIDES
    from mrla_tpu_torch.kernels.roialign_patch import (
        roi_align_kernel,
        roi_align_patch,
    )
    from mrla_tpu_torch.serving import two_stage_detections
    from mrla_tpu_torch.testing import images

    roi_inputs = []  # (feats, rois, valid, out) of each RoIAlign stage

    def keep_roi_inputs(name, fn, *args, **kw):
        if name.startswith("RoIAlign"):
            roi_inputs.append(args)
        return fn(*args, **kw)

    x = images(torch.Generator().manual_seed(4), DET_BATCH, DET_HW).to("cuda")
    two_stage_detections(params, x, MASK_PRESET, stage=keep_roi_inputs)
    feats = roi_inputs[0][0]
    pyramid = [f.contiguous() for f in feats[:4]]
    pyramid32 = [f.float() for f in pyramid]
    cases = {next(iter(ROI_SHAPES)): roi_inputs[0][1:],
             next(iter(MASK_ROI_SHAPES)): roi_inputs[1][1:]}
    rows = {}
    for shape, (rois, rv, o) in cases.items():
        label = {**ROI_SHAPES, **MASK_ROI_SHAPES}[shape][0]
        got = roi_align_patch(pyramid, rois, rv, ROI_STRIDES, o, 0)
        geom, smax = roi_geometry(rois, rv, [f.shape[1:3] for f in pyramid],
                                  ROI_STRIDES, o, 0)
        want = roi_align_reference(pyramid32, geom, o, smax)
        err = (got.float() - want).abs().max().item()
        tol = ulp_tol(want, 1)
        got32 = roi_align_kernel(pyramid32, geom, o, smax)
        err32 = (got32 - want).abs().max().item()
        reruns = (roi_reruns(pyramid, geom, o, smax, got)
                  and roi_reruns(pyramid32, geom, o, smax, got32))
        tol32 = ROI_FP32_TERMS * 2.0 ** -24 * max(
            f.abs().max().item() for f in pyramid32)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: roi_align_kernel(pyramid, geom, o, smax))
        ms32 = cuda_ms(lambda: roi_align_kernel(pyramid32, geom, o, smax))
        plain_ms = cuda_ms(lambda: roi_align_reference(pyramid, geom, o, smax),
                           iters=3, warmup=1)
        nbytes, ops = roi_work(pyramid, geom, o, smax, 2)
        bound_ms, by = bound(nbytes, 0, ops)
        lib_ms = library_roi_align_ms(pyramid, geom, o, ROI_STRIDES)
        g = geom.reshape(-1, geom.shape[-1])
        live = g[:, 6] > 0
        levels = torch.bincount(g[live, 7].long(), minlength=4).tolist()
        mean_g = (g[live, 4] * g[live, 5]).mean().item()
        rows[shape] = dict(
            shape=f"{label} [{shape[0]},{shape[1]}] rois, out {o}x{o}, "
                  f"C {shape[3]}", max_abs_err=max(err, err32), tol=tol,
            reruns_bitwise_equal=reruns, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=by, library_ms=lib_ms, fp32_ms=ms32)
        print(f"roi_align {label} {list(got.shape)}: valid rois "
              f"{int(live.sum())}, by level {levels}, mean gy*gx "
              f"{mean_g:.2f}; bf16 max|Δ| {err:.3g} (tol {tol:.3g}: 1 bf16 "
              f"ulp at max|out| = {want.abs().max().item():.3g}; both round "
              f"one fp32 value summed in another order); fp32 max|Δ| "
              f"{err32:.3g} (tol {tol32:.3g}: {ROI_FP32_TERMS} fp32 "
              f"roundings of max|feature|); two launches over NaN "
              f"{'write every element, bitwise equal' if reruns else 'DIFFER'}"
              f" | kernel {ms:.4f} ms (fp32 "
              f"{ms32:.4f}), bound {bound_ms:.4f} ms ({by}: "
              f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP), plain "
              f"{plain_ms:.4f} ms, library "
              f"{'n/a (no torchvision)' if lib_ms is None else lib_ms}")
        if not (err <= tol and err32 <= tol32):
            raise AssertionError(f"roi_align {label}: bf16 {err} > {tol} or "
                                 f"fp32 {err32} > {tol32}")
        if not reruns:
            raise AssertionError(f"roi_align {label}: a launch left an "
                                 f"element unwritten or two differ")
        del got, got32, want
    return rows


def check_detections(out) -> None:
    boxes, scores, labels, valid = out[:4]
    b, m = DET_BATCH, 100
    if (boxes.shape != (b, m, 4) or scores.shape != (b, m)
            or labels.shape != (b, m) or valid.shape != (b, m)):
        raise AssertionError("detections of the wrong shape")
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
        raise AssertionError("detections not finite")
    if valid.sum(1).min() < 1:
        raise AssertionError(f"an image without detections: "
                             f"{valid.sum(1).tolist()}")
    if len(out) > 4 and (out[4].shape != (b, m, 28, 28)
                         or not torch.isfinite(out[4]).all()):
        raise AssertionError("masks not finite or of the wrong shape")


def rel_err(got, ref) -> float:
    return ((got.float().cpu() - ref).norm() / ref.norm()).item()


def det_errors(params, x2, ref) -> dict:
    """The served bf16 path on 2 images against the port's fp32 forward on
    the CPU (``ref``: the module's outputs and its RoI features ``roi``):
    the pyramid (largest relative error of P2..P6), the RoI features on
    the CPU's proposals (relative), and the box head's
    (cls, reg) on them, relative to their roi-dependent part (with random
    weights much of each output is shared by every roi)."""
    from mrla_tpu_torch.serving import detect as det

    with torch.inference_mode():
        feats = det.detect_forward(params, x2)
        pyramid = max(rel_err(g, r) for g, r in zip(feats, ref["feats"]))
        props = ref["proposals"].to("cuda")
        pvalid = ref["proposal_valid"].to("cuda")
        roi = det.roi_feats(feats, props, pvalid, 7)
        cls, reg = det.bbox_head(params["bbox_head"], roi)
        head = max(
            ((g.float().cpu() - r).norm() / (r - r.mean(1, keepdim=True))
             .norm()).item()
            for g, r in ((cls, ref["cls"]), (reg, ref["reg"])))
        return {"pyramid": pyramid, "roi": rel_err(roi, ref["roi"]),
                "head": head}


# flatten: the box head's first fc in mmdet's [C, 7, 7] column order on
# NHWC-flattened RoI features; xy: rois with x and y swapped; level: the
# level mapping one level up; fpn_add: the top-down add into P4 left out
DET_FAULTS = {"flatten": "head", "xy": "roi", "level": "roi",
              "fpn_add": "pyramid"}


def faulty_det_errors(params, x2, ref, model, kind: str) -> dict:
    """det_errors of the served path with one wiring fault (DET_FAULTS)."""
    import mrla_tpu_torch.detect.fpn as fpn_mod
    import mrla_tpu_torch.detect.roi_align as ra
    import mrla_tpu_torch.serving.detect as det

    roi_feats, levels, up = det.roi_feats, ra.map_roi_levels, \
        fpn_mod.upsample_nearest_to
    p = params
    if kind == "flatten":
        w0 = model.roi_head.bbox_head.shared_fcs[0].weight
        p = {**params, "bbox_head": {
            **params["bbox_head"],
            "fc0": (w0.detach().to("cuda", torch.bfloat16).contiguous(),
                    params["bbox_head"]["fc0"][1])}}
    elif kind == "xy":
        det.roi_feats = lambda feats, rois, *a: roi_feats(
            feats, rois[..., [1, 0, 3, 2]], *a)
    elif kind == "level":
        ra.map_roi_levels = lambda rois, n, *a: (
            levels(rois, n, *a) + 1).clamp(max=n - 1)
    else:
        calls = itertools.count()
        fpn_mod.upsample_nearest_to = lambda x, h, w: (
            up(x, h, w) * (0.0 if next(calls) == 0 else 1.0))
    try:
        return det_errors(p, x2, ref)
    finally:
        det.roi_feats, ra.map_roi_levels = roi_feats, levels
        fpn_mod.upsample_nearest_to = up


def serve_detect(smi: str):
    """The detection main paths: the RoIAlign kernel check on the path's
    rois, the counted requests of both presets, the check against the fp32
    CPU forward with its four injected faults, and throughput.  Returns
    (RoIAlign rows, launches, launches per forward by shape) keyed by
    path."""
    from mrla_tpu_torch.serving import (
        prepare_detect_params,
        two_stage_detections,
    )
    from mrla_tpu_torch.testing import detector_serving_model, images

    t0 = time.perf_counter()
    # one seeded Mask R-CNN: the faster preset runs its box path
    model = seeded("mask_rcnn", lambda: detector_serving_model(0,
                                                              MASK_PRESET))
    params = prepare_detect_params(model, dtype=torch.bfloat16,
                                   device="cuda")
    gen = torch.Generator().manual_seed(3)
    host = [images(gen, DET_BATCH, DET_HW) for _ in range(DET_REQUESTS)]
    batches = [xb.to("cuda") for xb in host]
    t1 = time.perf_counter()
    with torch.no_grad():
        ref = model(host[0][:2])  # the port's fp32 CPU forward
        ref["roi"] = model.roi_feats(ref["feats"], ref["proposals"],
                                     ref["proposal_valid"])
    print(f"detector: seeded and spread in {t1 - t0:.1f} s; fp32 CPU "
          f"forward of 2 images in {time.perf_counter() - t1:.1f} s")

    rows = check_roi_align(params)
    desc = f"{DET_HW[0]}x{DET_HW[1]} bs{DET_BATCH} bf16"
    launches, per_forward = {}, {}
    for path, preset, extra in ((DET_PATH, DET_PRESET, {}),
                                (MASK_PATH, MASK_PRESET, MASK_ROI_SHAPES)):
        want = {k: {} for k in all_counters()}
        want["megatail"] = {s: n for s, (_, n) in DET_MEGATAIL_SHAPES.items()}
        want["epilogue"] = {s: n for s, (_, n) in DET_EPILOGUE_SHAPES.items()}
        want["roi_align"] = {s: n for s, (_, n) in
                             {**ROI_SHAPES, **extra}.items()}
        outs, launches[path], per_forward[path] = counted(
            lambda xb, preset=preset: two_stage_detections(params, xb,
                                                           preset),
            batches, path, want, check_detections, desc)
        print(f"{path}: detections per image {outs[0][3].sum(1).tolist()}, "
              f"labels of image 0 {outs[0][2][0, :8].tolist()}, scores "
              f"{[round(v, 3) for v in outs[0][1][0, :4].tolist()]}")
        del outs

    x2 = host[0][:2].to("cuda")
    errs = det_errors(params, x2, ref)
    print(f"{DET_PATH} against the fp32 CPU forward (2 images): "
          + ", ".join(f"{k} {v:.4g} (tol {DET_TOLS[k]})"
                      for k, v in errs.items()))
    over = [k for k, v in errs.items() if not v <= DET_TOLS[k]]
    if over:
        raise AssertionError(f"{DET_PATH}: {over} beyond tolerance")
    for kind, metric in DET_FAULTS.items():
        fe = faulty_det_errors(params, x2, ref, model, kind)
        print(f"{DET_PATH} with the fault {kind}: "
              + ", ".join(f"{k} {v:.4g}" for k, v in fe.items()))
        if not fe[metric] > DET_TOLS[metric]:
            raise AssertionError(f"the {metric} check misses the fault "
                                 f"{kind}")

    for path, preset in ((DET_PATH, DET_PRESET), (MASK_PATH, MASK_PRESET),
                         (MASK_PATH, MASK_PRESET), (DET_PATH, DET_PRESET)):
        throughput(lambda xb, preset=preset: two_stage_detections(
            params, xb, preset), batches, path, smi,
            consume=lambda out: out[1].sum(), batch=DET_BATCH, desc=desc)
    return rows, launches, per_forward


# The detection training path: the two-stage presets through the trainer
# entry point (detect/train_cli.py) at 800 x 800, batch 8, 80 classes, fp32
# (TF32 off), seeded weights.  Per step the RoIAlign wrapper launches,
# keyed (B, P, out, C) forward and ("bwd", B, P, out, C) backward: the box
# head's 512 sampled rois; with masks the mask head's first 128 and the gt
# mask crop (one level, stride 1, the gt axis as channels, fp32 canvas).
TRAIN_PATH = "faster_rcnn_r50mrlal training"
TRAIN_BATCH, TRAIN_PX, TRAIN_MAX_GT = 8, 800, 32
TRAIN_WARMUP, TRAIN_TIMED = 2, 8
TRAIN_ROI = {(TRAIN_BATCH, 512, 7, 256): "box head"}
TRAIN_MASK_ROI = {(TRAIN_BATCH, 128, 14, 256): "mask head",
                  (TRAIN_BATCH, 128, 28, TRAIN_MAX_GT): "gt mask crop"}
# each cell of the backward sums at most a few hundred weighted cotangent
# terms, in another order than the plain version's: 64 fp32 roundings of
# the sum of its terms' magnitudes, cell by cell (test_torch_gpu.py holds
# the same)
GRAD_ROUNDINGS = 64
# the in-situ step: full depth, 800 x 800, batch 2.  Card against CPU, both
# fp32: the loss terms relative, the gradient of the R-CNN loss to each of
# P2..P5 relative to its norm.  The gradient reads about 1e-3 where the loss
# terms agree to 1e-7: box-head ReLUs whose input lies within fp32 noise of
# 0 switch between the two, each moving the gradient by its share (the
# card with the plain backward reads the same, printed beside).  Limits
# between the sound reading and the least injected fault (both printed by
# this script; readings in PERF.md).
INSITU_PX, INSITU_BATCH = 800, 2
INSITU_TOLS = {"loss": 1e-3, "grad": 0.02}
# the wrapper's autograd on the card against the CPU: a function linear in
# the features, so the two differ only by the order of fp32 sums (relative
# norm about 2e-6); the valid-ignored fault reads near 0.6
AUTOGRAD_TOL = 1e-4
# backward faults: x and y swapped, the gradient sent one level up, the
# cotangent dropped (in situ); valid ignored (the autograd check: in situ
# the loss gives an unsampled roi a zero cotangent, so it cannot show there)
GRAD_FAULTS = ("xy", "level", "dropped")
# the learning check: a small detector on the synthetic squares task
LEARN_ARGV = ["--preset", DET_PRESET, "--backbone-layers", "1", "1", "1",
              "1", "--img-size", "128", "--num-classes", "3", "--max-gt",
              "4", "--batch-size", "8", "--epochs", "2", "--steps-per-epoch",
              "150", "--eval-steps", "3", "--rpn-proposals", "100",
              "--rcnn-samples", "64", "--warmup-iters", "100", "--lr",
              "0.005", "--eval-every", "2"]
LEARN_WINDOW = 20  # steps averaged at the start and at the end
# the mean loss of the last LEARN_WINDOW steps over that of the first
LEARN_RATIO_TOL = 0.6

# The classification training phase (8b).  (a) One step, card against CPU,
# fp32: the loss relative; for each parameter (running statistic) the
# norm of the two updates' difference over the norm of the CPU's update,
# the largest over all of them.  An update whose RMS is below
# CLS_UPDATE_FLOOR counts as at the floor: some bn_mrla biases' gradients
# are at fp32 noise (updates of 1e-9 whose card and CPU values differ by
# as much).  Limits between the sound reading and the least injected
# fault (both printed by this script; readings in PERF.md).
CLS_PX, CLS_STEP_BATCH, CLS_LR = 224, 8, 0.1
CLS_UPDATE_FLOOR = 1e-6
CLS_STEP_TOLS = {"loss": 1e-4, "param": 0.05, "stat": 0.01}
# weight decay left out, label smoothing left out, λ·identity dropped from
# the epilogue, BN's running variance unbiased (torch's default)
CLS_FAULTS = ("no_weight_decay", "no_label_smoothing", "no_lambda_identity",
              "unbiased_running_var")
CLS_WARMUP, CLS_TIMED = 2, 8
CLS_RECIPES = {
    "resnet": ["-a", "resnet50_mrlal", "--image-size", str(CLS_PX), "-b",
               "128", "--opt", "sgd", "--lr", "0.1", "--scheduler", "step",
               "--warmup-epochs", "3", "--label-smooth", "0.1"],
    "deit": ["-a", "deit_mrlal_tiny_patch16_224", "--image-size",
             str(CLS_PX), "-b", "256", "--opt", "adamw", "--lr", "5e-4",
             "--lr-scale-512", "--wd", "0.05", "--scheduler", "cosine",
             "--warmup-epochs", "5", "--ema-decay", "0.99996", "--mixup",
             "0.8", "--cutmix", "1.0", "--label-smooth", "0.1",
             "--drop-path", "0.1"],
    # phase 8c: the README's EfficientNet recipe per card
    "efficientnet": ["-a", "efficientnet_mrlal_b0", "--image-size",
                     str(CLS_PX), "-b", "384", "--opt", "rmsproptf", "--lr",
                     "0.048", "--scheduler", "exp"],
}
CLS_LEARN_ARGV = ["-a", "resnet50_mrlal", "--layers", "1", "1", "1", "1",
                  "--data", "synthetic-learnable", "--image-size", "64",
                  "--num-classes", "10", "-b", "32", "--epochs", "2",
                  "--synthetic-steps", "150", "--lr", "0.05",
                  "--warmup-epochs", "0", "--label-smooth", "0.1"]
CLS_LEARN_RATIO_TOL, CLS_LEARN_ACC1 = 0.6, 50.0

# The model zoo phase (8c).  The logit error of the served bf16 logits of
# each arch against its fp32 CPU forward on ZOO_REF_IMAGES images; each
# limit lies between the sound reading and the least injected fault (both
# printed by this script; readings in PERF.md).
ZOO_ARCHS = ("efficientnet_mrlal_b0", "resnet50_se", "resnext50_32x4d_eca",
             "resnet50_dw", "resmlp_24", "patchconvnet_s60")
ZOO_REQUESTS, ZOO_REF_IMAGES = 8, 16
ZOO_LOGIT_ERROR_TOL = {"efficientnet_mrlal_b0": 0.2, "resnet50_se": 0.1,
                       "resnext50_32x4d_eca": 0.2, "resnet50_dw": 0.2,
                       "resmlp_24": 0.05, "patchconvnet_s60": 0.1}
ZOO_FAULTS = {
    # every BN at torch's eps; λ·identity dropped in every MRLA block; the
    # MRLA recurrence given h for x; the SE gate skipped in stage3_1
    "efficientnet_mrlal_b0": ("bn_eps_1e-5", "no_lambda_identity",
                              "mrla_ot_is_h", "no_se_stage3_1"),
    "resnet50_se": ("no_se",),  # in every block
    "resnext50_32x4d_eca": ("eca_taps_reversed",),
    "resnet50_dw": ("no_dw_branch",),
    "resmlp_24": ("gammas_swapped",),
    "patchconvnet_s60": ("cls_not_in_kv",),
}
ZOO_STEP_ARCH, ZOO_STEP_LR = "efficientnet_mrlal_b0", 0.048
ZOO_STEP_FAULT = "no_lambda_identity"
ZOO_REDUCED = ("RandAugment (rand-m9-mstd0.5): the trainer has no flag for "
               "it, in either package; synthetic noise images (real images "
               "in phase 8d)")

# The real-data training phase (8d).  A seeded JPEG tree of ImageNet-like
# sizes (h, w): REAL_CLASSES x REAL_PER_CLASS train images (10 steps of
# the ResNet recipe's batch) and REAL_VAL val images (two full batches and
# a ragged 44).  The card's decoder is held bitwise to the same decoder
# called image by image on the same indices and seed (the threaded loader
# must not reorder, drop or reseed a batch), the card's normalisation to
# the host's within REAL_NORM_TOL.  The teacher's logits to the reloaded
# checkpoint's within REAL_TEACHER_TOL (fp32, one card), the random-init
# teacher beyond it.
REAL_CLASSES, REAL_PER_CLASS, REAL_VAL = 10, 128, 300
REAL_SIZES = [(375, 500), (500, 375), (333, 500), (480, 640), (300, 300)]
REAL_PX, REAL_BATCH, REAL_WORKERS = 224, 128, 8
REAL_NORM_TOL = 1e-5
REAL_TEACHER_TOL = 1e-4
REAL_FT_PX, REAL_FT_BATCH, REAL_AUX_BATCH = 384, 32, 16
REAL_TIMED = (1, 5)  # the steps of ms / step: after the first, before the
# profiled steps 5-14 (cli.PROFILE_STEPS) of the ResNet run
REAL_WALL_S = 150.0
CARD = "cuda"  # the device of phases 8d to 8f (a CPU rehearsal sets it)
REAL_RECIPES = {
    "resnet": CLS_RECIPES["resnet"] + ["--bf16", "--epochs", "1"],
    "deit": CLS_RECIPES["deit"] + ["--bf16", "--epochs", "1",
                                   "--repeated-aug", "--random-erase",
                                   "0.25"],
}


def split_roi_counts(counter, steps: int):
    """(launches, launches per step by shape) of the RoIAlign counter,
    apart for the forward ("roi_align") and the backward
    ("roi_align_bwd")."""
    fwd = {s: n for s, n in counter.by_shape.items() if s[0] != "bwd"}
    bwd = {s: n for s, n in counter.by_shape.items() if s[0] == "bwd"}
    return ({"roi_align": sum(fwd.values()),
             "roi_align_bwd": sum(bwd.values())},
            {"roi_align": {s: n / steps for s, n in fwd.items()},
             "roi_align_bwd": {s: n / steps for s, n in bwd.items()}})


def train_argv(preset: str, steps: int, extra=()):
    """train_cli's arguments for the full-width training path."""
    return ["--preset", preset, "--img-size", str(TRAIN_PX), "--batch-size",
            str(TRAIN_BATCH), "--num-classes", "80", "--max-gt",
            str(TRAIN_MAX_GT), "--epochs", "1", "--steps-per-epoch",
            str(steps), "--eval-every", "0", "--device", "cuda", *extra]


def check_roi_align_grad():
    """The backward kernel against its plain version on the rois of one
    full-size training step of the mask preset (taken through the loss's
    stage hook) with a seeded cotangent, twice (the two runs must be
    bitwise equal); its time, bound and the plain version's time; and the
    forward kernel at the training shapes in fp32."""
    from mrla_tpu_torch.detect import train_cli
    from mrla_tpu_torch.detect.roi_align import (
        roi_align_backward_reference,
        roi_align_reference,
        roi_footprint,
        roi_geometry,
    )
    from mrla_tpu_torch.detect.two_stage import ROI_STRIDES
    from mrla_tpu_torch.detect.two_stage_train import faster_rcnn_train_loss
    from mrla_tpu_torch.kernels.roialign_patch import (
        roi_align_grad_kernel,
        roi_align_kernel,
    )

    args = train_cli.parse_args(train_argv(MASK_PRESET, 1))
    model = train_cli.build_model(args, torch.device("cuda"))
    batch = train_cli.to_device(next(train_cli.data_iter(args, True, 0)),
                                "cuda")
    seen = {}

    def keep(name, fn, *a, **kw):
        if "RoIAlign" in name:
            seen[name] = a
        return fn(*a, **kw)

    with torch.no_grad():
        faster_rcnn_train_loss(
            model, batch["image"], batch["gt_boxes"], batch["gt_labels"],
            batch["gt_valid"], torch.Generator("cuda").manual_seed(5),
            gt_masks=batch["gt_masks"], stage=keep)
    feats = [f.float().contiguous() for f in seen["RoIAlign 7x7"][0][:4]]
    hw = [tuple(f.shape[1:3]) for f in feats]
    gen = torch.Generator("cuda").manual_seed(6)
    rows, cases = {}, {}
    for name, o in (("RoIAlign 7x7", 7), ("mask RoIAlign 14x14", 14)):
        rois, valid = seen[name][1], seen[name][2]
        b, p, c = rois.shape[0], rois.shape[1], feats[0].shape[-1]
        geom, smax = roi_geometry(rois, valid, hw, ROI_STRIDES, o, 0)
        cases[name] = (feats, o, smax, geom)
        ct = torch.randn(b, p, o, o, c, generator=gen, device="cuda")
        got = roi_align_grad_kernel(ct, geom, hw, smax)
        again = roi_align_grad_kernel(ct, geom, hw, smax)
        want = roi_align_backward_reference(ct, geom, hw, o, smax)
        mags = roi_align_backward_reference(ct.abs(), geom, hw, o, smax)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        worst = max(((g - w).abs() / (GRAD_ROUNDINGS * 2.0 ** -24 * m
                                      + 1e-30)).max().item()
                    for g, w, m in zip(got, want, mags))
        boxes_same = torch.equal(kernel_boxes(ct, geom, hw, smax),
                                 roi_footprint(geom, hw, o, smax))
        ms = cuda_ms(lambda: roi_align_grad_kernel(ct, geom, hw, smax))
        plain_ms = cuda_ms(lambda: roi_align_backward_reference(
            ct, geom, hw, o, smax), iters=3, warmup=1)
        nbytes, ops = grad_work(hw, b, c, geom, o, smax)
        bound_ms, by = bound(nbytes, 0, ops)
        g = geom.reshape(-1, geom.shape[-1])
        live = g[:, 6] > 0
        levels = torch.bincount(g[live, 7].long(), minlength=4).tolist()
        rows[("bwd", b, p, o, c)] = dict(
            shape=f"{TRAIN_PATH} {name}: [{b},{p}] rois, out {o}x{o}, C {c}",
            max_abs_err=err, reruns_bitwise_equal=same, tol_ratio=worst,
            boxes_are_roi_footprint=boxes_same,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
            library_ms=None)
        print(f"roi_align_bwd {name} [{b},{p},{o},{o},{c}] fp32: valid rois "
              f"{int(live.sum())}, by level {levels}; max|Δgrad| {err:.3g} "
              f"(worst cell at {worst:.3g} of its limit, {GRAD_ROUNDINGS} "
              f"fp32 roundings of the sum of its terms' magnitudes); two "
              f"runs {'bitwise equal' if same else 'DIFFER'} at max|grad| "
              f"{max(w.abs().max().item() for w in want):.4g}; its rois' "
              f"boxes {'are' if boxes_same else 'DIFFER FROM'} "
              f"roi_footprint's bit for bit | kernel {ms:.4f} ms (its "
              f"per-roi pass inside), bound "
              f"{bound_ms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.3f} GFLOP), plain {plain_ms:.4f} ms, library "
              f"n/a (no PyTorch call computes it)")
        if not worst <= 1.0:
            raise AssertionError(f"roi_align_bwd {name}: a cell beyond its "
                                 f"limit ({worst:.3g})")
        if not same:
            raise AssertionError(f"roi_align_bwd {name}: two runs differ")
        if not boxes_same:
            raise AssertionError(f"roi_align_bwd {name}: its boxes are not "
                                 f"roi_footprint's")
        del got, again, want, mags, ct
    cases["gt mask crop"] = crop_case(seen["mask RoIAlign 14x14"], batch)
    for name, case in cases.items():
        time_forward(name, *case)
    return rows


def kernel_boxes(ct, geom, hw, smax) -> torch.Tensor:
    """The rois' boxes as the backward kernel computes them: its C entry
    point over uncleared buffers, the start of its scratch read back."""
    from mrla_tpu_torch.kernels._build import check
    from mrla_tpu_torch.kernels.roialign_patch import (
        grad_scratch,
        launch_grad,
        scratch_boxes,
    )

    b, p, _, _, c = ct.shape
    bufs = [torch.empty(b, h, w, c, device="cuda") for h, w in hw]
    scratch = grad_scratch(ct, hw, fill=0xFF)
    check(launch_grad(bufs, geom, ct, scratch, smax), "roi_align_bwd")
    torch.cuda.synchronize()
    return scratch_boxes(scratch, b * p)


def crop_case(mask_inputs, batch):
    """The gt mask crop's operands: the masks as channels (fp32 canvas, the
    gt axis padded to a multiple of 8) and the geometry of the mask rois."""
    from mrla_tpu_torch.detect.roi_align import roi_geometry

    m4 = batch["gt_masks"].permute(0, 2, 3, 1).float().contiguous()
    geom, smax = roi_geometry(mask_inputs[1], None, [m4.shape[1:3]], (1,),
                              28, 1, 1e9)
    return [m4], 28, smax, geom


def time_forward(name, feats, o, smax, geom):
    """The forward kernel at a training shape (fp32): its error against the
    plain version, time, bound and plain time."""
    from mrla_tpu_torch.detect.roi_align import roi_align_reference
    from mrla_tpu_torch.kernels.roialign_patch import roi_align_kernel

    got = roi_align_kernel(feats, geom, o, smax)
    want = roi_align_reference(feats, geom, o, smax)
    err = (got - want).abs().max().item()
    tol = ROI_FP32_TERMS * 2.0 ** -24 * max(f.abs().max().item()
                                            for f in feats)
    reruns = roi_reruns(feats, geom, o, smax, got)
    ms = cuda_ms(lambda: roi_align_kernel(feats, geom, o, smax))
    plain_ms = cuda_ms(lambda: roi_align_reference(feats, geom, o, smax),
                       iters=3, warmup=1)
    nbytes, ops = roi_work(feats, geom, o, smax, 4)
    bound_ms, by = bound(nbytes, 0, ops)
    print(f"roi_align fwd, training {name} {list(got.shape)} fp32: "
          f"max|Δ| {err:.3g} (tol {tol:.3g}); two launches over NaN "
          f"{'write every element, bitwise equal' if reruns else 'DIFFER'}"
          f" | kernel {ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), plain "
          f"{plain_ms:.4f} ms")
    if not (err <= tol and reruns):
        raise AssertionError(f"roi_align fwd {list(got.shape)}: {err} > "
                             f"{tol} or the reruns differ")


def check_roi_align_autograd():
    """torch.autograd.grad of a seeded function of roi_align_patch on CUDA
    tensors against the same on CPU copies (the wrapper's autograd on the
    card: on a wrapper whose CUDA output has no gradient this fails), and
    the valid-ignored fault of the backward, which must fail it."""
    import mrla_tpu_torch.kernels.roialign_patch as rp

    gen = torch.Generator("cuda").manual_seed(7)
    hw = ((100, 168), (50, 84), (25, 42), (13, 21))
    b, p, c = 2, 200, 256
    feats = [torch.randn(b, h, w, c, generator=gen, device="cuda")
             for h, w in hw]
    u = lambda *s: torch.rand(*s, generator=gen, device="cuda")
    scale = torch.exp(u(b, p) * 4.0 + 2.0)
    ar = torch.exp((u(b, p) - 0.5) * 2.2)
    cx, cy = u(b, p) * 672, u(b, p) * 400
    w, h = scale * ar.sqrt(), scale / ar.sqrt()
    rois = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    valid = u(b, p) > 0.2
    ct = torch.randn(b, p, 7, 7, c, generator=gen, device="cuda")

    def grads(fs, r, v, wt):
        fs = [f.detach().requires_grad_() for f in fs]
        out = rp.roi_align_patch(fs, r, v, (4, 8, 16, 32), 7, 0)
        return torch.autograd.grad((out * wt).sum(), fs)

    want = grads([f.cpu() for f in feats], rois.cpu(), valid.cpu(), ct.cpu())

    def err(got):
        return max(((g.cpu() - w).norm() / w.norm()).item()
                   for g, w in zip(got, want))

    rp.roi_align_patch.counter.reset()
    sound = err(grads(feats, rois, valid, ct))
    launched = dict(rp.roi_align_patch.counter.by_shape)
    real = rp.roi_align_grad_kernel

    def valid_ignored(g, geom, *a):
        geom = geom.clone()
        geom[..., 6] = 1.0
        return real(g, geom, *a)

    rp.roi_align_grad_kernel = valid_ignored
    try:
        fault = err(grads(feats, rois, valid, ct))
    finally:
        rp.roi_align_grad_kernel = real
    tol = AUTOGRAD_TOL
    print(f"roi_align_patch autograd on the card against the CPU (2 x 200 "
          f"rois, 7x7, C 256, seeded cotangent): gradient error {sound:.3g} "
          f"(tol {tol}), launches {launched}; with valid ignored in the "
          f"backward {fault:.3g}")
    if not (sound <= tol and launched.get(("bwd", b, p, 7, c)) == 1):
        raise AssertionError("roi_align_patch autograd on the card")
    if not fault > tol:
        raise AssertionError("the autograd check misses the valid fault")


def insitu_errors(model, batch, rand, ref, targets):
    """One training step of the card's model against the CPU's (``ref``:
    its loss terms and gradients to P2..P5) on the CPU's sampled rois."""
    from mrla_tpu_torch.testing import rcnn_pyramid_grads

    losses, _, grads = rcnn_pyramid_grads(model, batch, rand, targets)
    loss = max(abs(losses[k].item() - ref[0][k].item()) / abs(ref[0][k].item())
               for k in ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls",
                         "loss_bbox"))
    # per level relative to its norm; a level no roi reaches (zero on the
    # CPU) relative to the norm of the whole gradient
    whole = torch.cat([w.flatten() for w in ref[2]]).norm()
    grad = max(((g.cpu() - w).norm() / (w.norm() if w.norm() > 0 else whole))
               .item() for g, w in zip(grads, ref[2]))
    return {"loss": loss, "grad": grad}


def check_insitu():
    """One full-depth training step on the card against the same step on
    the CPU (INSITU_PX square, INSITU_BATCH images, the same weights and
    uniforms, the CPU's sampled rois fed to both), and the three backward
    faults in situ."""
    import mrla_tpu_torch.kernels.roialign_patch as rp
    from mrla_tpu_torch.detect.roi_align import (
        map_roi_levels,
        roi_align_backward_reference,
    )
    from mrla_tpu_torch.testing import (
        detection_batch,
        rcnn_pyramid_grads,
        train_uniforms,
        training_detector,
    )

    t0 = time.perf_counter()
    model = training_detector(0, num_classes=80, px=(256, 256))
    batch = detection_batch(2, INSITU_BATCH, INSITU_PX, 80, TRAIN_MAX_GT,
                            False)
    side = [-(-INSITU_PX // 4)]  # P2, then each level halves, rounding up
    for _ in range(4):
        side.append(-(-side[-1] // 2))
    n_anchors = 3 * sum(h * h for h in side)
    rand = train_uniforms(3, INSITU_BATCH, n_anchors,
                          TRAIN_MAX_GT + model.num_proposals)
    ref = rcnn_pyramid_grads(model, batch, rand)
    targets = ref[1]
    levels = torch.bincount(map_roi_levels(
        targets["rois"][targets["roi_valid"]], 4), minlength=4).tolist()
    print(f"in-situ step: full depth {INSITU_PX}x{INSITU_PX} bs"
          f"{INSITU_BATCH}, CPU step in {time.perf_counter() - t0:.1f} s; "
          f"{int(targets['roi_valid'].sum())} sampled rois by level "
          f"{levels}; gradient norms of P2..P5 "
          f"{[round(w.norm().item(), 6) for w in ref[2]]}")
    model = model.to("cuda")
    batch = {k: v.to("cuda") for k, v in batch.items()}
    own = rcnn_pyramid_grads(model, batch, rand)[1]
    same = all(torch.equal(own[k].cpu(), targets[k]) for k in
               ("roi_valid", "labels", "gt_index"))
    print(f"in-situ step: the card's own sampled rois "
          f"{'equal' if same else 'differ from'} the CPU's; the CPU's are "
          f"fed to both")
    errs = insitu_errors(model, batch, rand, ref, targets)
    print("in-situ step against the CPU: " + ", ".join(
        f"{k} {v:.4g} (tol {INSITU_TOLS[k]})" for k, v in errs.items()))
    if any(not v <= INSITU_TOLS[k] for k, v in errs.items()):
        raise AssertionError(f"in-situ step beyond tolerance: {errs}")
    real = rp.roi_align_grad_kernel
    rp.roi_align_grad_kernel = lambda g, geom, hw, smax: \
        roi_align_backward_reference(g, geom, hw, g.shape[2], smax)
    try:
        plain = insitu_errors(model, batch, rand, ref, targets)
    finally:
        rp.roi_align_grad_kernel = real
    print(f"in-situ step with the plain backward on the card in place of the "
          f"kernel: gradient error {plain['grad']:.4g}")

    def faulty(kind):
        def grad_kernel(g, geom, hw, smax):
            geom = geom.clone()
            if kind == "xy":
                geom[..., [0, 1, 2, 3, 4, 5]] = geom[..., [1, 0, 3, 2, 5, 4]]
            elif kind == "level":
                geom[..., 7] = (geom[..., 7] + 1).clamp(max=len(hw) - 1)
            out = real(g, geom, hw, smax)
            return [o.zero_() for o in out] if kind == "dropped" else out
        return grad_kernel

    for kind in GRAD_FAULTS:
        rp.roi_align_grad_kernel = faulty(kind)
        try:
            fe = insitu_errors(model, batch, rand, ref, targets)
        finally:
            rp.roi_align_grad_kernel = real
        print(f"in-situ step with the backward fault {kind}: gradient error "
              f"{fe['grad']:.4g}")
        if not fe["grad"] > INSITU_TOLS["grad"]:
            raise AssertionError(f"the in-situ check misses the fault {kind}")


def train_path(preset: str, smi: str, extra=()):
    """train_cli.main at full width: TRAIN_WARMUP + TRAIN_TIMED steps with
    the counts set to 0 just before and read just after; ms / step and
    img/s over the timed steps, the peak memory, the launches by shape."""
    from mrla_tpu_torch.detect import train_cli
    from mrla_tpu_torch.kernels import roi_align_patch

    steps = TRAIN_WARMUP + TRAIN_TIMED
    counters = all_counters()
    with tempfile.TemporaryDirectory() as out:
        argv = train_argv(preset, steps, extra) + ["--output-dir", out]
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        res = train_cli.main(argv)
        torch.cuda.synchronize()
        launches, per_step = split_roi_counts(roi_align_patch.counter, steps)
        for k, c in counters.items():
            if k != "roi_align":
                launches[k], per_step[k] = c.launches, {
                    s: n / steps for s, n in c.by_shape.items()}
        lines = open(os.path.join(out, "log.jsonl")).readlines()
    if len(lines) != 1:  # one epoch, rank 0's line
        raise AssertionError(f"{preset}: {len(lines)} lines in log.jsonl")
    line = json.loads(lines[0])
    step_ms = sum(res["step_s"][TRAIN_WARMUP:]) / TRAIN_TIMED * 1e3
    data_ms = sum(res["data_s"][TRAIN_WARMUP:]) / TRAIN_TIMED * 1e3
    losses = {k: v for k, v in line.items() if k.startswith("loss")}
    desc = (f"{preset}{' ' + ' '.join(extra) if extra else ''}, "
            f"{TRAIN_PX}x{TRAIN_PX} bs{TRAIN_BATCH}")
    print(f"training {desc}: {step_ms:.2f} ms/step, "
          f"{TRAIN_BATCH / step_ms * 1e3:.2f} img/s over {TRAIN_TIMED} steps "
          f"after {TRAIN_WARMUP} (data {data_ms:.1f} ms/step beside it), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"GiB, on {smi}; last losses {losses}; RoIAlign launches per step "
          f"{per_step['roi_align']} forward, {per_step['roi_align_bwd']} "
          f"backward")
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"{desc}: non-finite losses {losses}")
    want = dict(TRAIN_ROI)
    if preset == MASK_PRESET:
        want.update(TRAIN_MASK_ROI)
    want_fwd = {s: 1.0 for s in want}
    want_bwd = {("bwd", *s): 1.0 for s in want if s[2] != 28}
    if (per_step["roi_align"] != want_fwd
            or per_step["roi_align_bwd"] != want_bwd
            or any(per_step[k] for k in counters if k != "roi_align")):
        raise AssertionError(f"{desc}: launches per step {per_step}, want "
                             f"{want_fwd} and {want_bwd}")
    del res
    return launches, per_step, step_ms


def check_learning(smi: str):
    """A small detector learns the synthetic squares task on the card."""
    from mrla_tpu_torch.detect import train_cli

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        res = train_cli.main(LEARN_ARGV + ["--device", "cuda",
                                           "--output-dir", out])
        lines = [json.loads(s) for s in open(os.path.join(out, "log.jsonl"))]
    loss = res["loss"]
    first = sum(loss[:LEARN_WINDOW]) / LEARN_WINDOW
    last = sum(loss[-LEARN_WINDOW:]) / LEARN_WINDOW
    print(f"learning: faster_rcnn layers 1-1-1-1, 128 px, 3 classes, bs8, "
          f"lr 5e-3, {len(loss)} steps in {time.perf_counter() - t0:.1f} s "
          f"on {smi}: mean loss of the first {LEARN_WINDOW} steps "
          f"{first:.4f}, of the last {last:.4f} (ratio {last / first:.4f}, "
          f"tol {LEARN_RATIO_TOL}); AP50 {lines[-1]['AP50']:.4f}, mAP "
          f"{lines[-1]['mAP']:.4f}")
    if not last / first <= LEARN_RATIO_TOL:
        raise AssertionError(f"the loss fell only to {last / first:.3f} of "
                             f"its start")


def train_detect(smi: str):
    """The detection training phase; returns (RoIAlign backward rows,
    launches, launches per step by shape) of the main training path."""
    torch.cuda.empty_cache()
    rows = check_roi_align_grad()
    check_roi_align_autograd()
    check_insitu()
    torch.cuda.empty_cache()
    launches, per_step, _ = train_path(DET_PRESET, smi)
    train_path(MASK_PRESET, smi)
    train_path(DET_PRESET, smi, ("--bf16",))
    check_learning(smi)
    return rows, launches, per_step


def cls_step(model, batch, device, fault=None, fused=False, optimizer=None):
    """One SGD (``optimizer(params)`` when given) + label-smoothing step of
    a copy of ``model`` on ``device``, with ``fault`` injected; (loss,
    parameters, running statistics) after it, on the CPU."""
    import copy

    from torch import nn as tnn

    from mrla_tpu_torch.models.common import BatchNorm2d
    from mrla_tpu_torch.nn.layers import MRLALightModule
    from mrla_tpu_torch.train import (
        create_train_state,
        cross_entropy,
        label_smoothing_ce,
        train_step,
    )
    from mrla_tpu_torch.train.optim import sgd_torch

    m = copy.deepcopy(model).to(device)
    for blk in m.modules():
        if hasattr(blk, "fused_epilogue"):
            blk.fused_epilogue = fused
    opt = (optimizer(m.parameters()) if optimizer else
           sgd_torch(m.parameters(), CLS_LR, 0.9,
                     0.0 if fault == "no_weight_decay" else 1e-4))
    loss_fn = (cross_entropy if fault == "no_label_smoothing"
               else lambda lo, la: label_smoothing_ce(lo, la, 0.1))
    patched = {"no_lambda_identity": (
                   MRLALightModule, "forward",
                   lambda self, xt, ot_1: self.mrla(xt)),
               "unbiased_running_var": (
                   BatchNorm2d, "forward", tnn.BatchNorm2d.forward)}.get(
        fault)
    if patched:
        real = getattr(patched[0], patched[1])
        setattr(patched[0], patched[1], patched[2])
    try:
        lr = opt.param_groups[0]["lr"]
        state = create_train_state(m, opt, lambda step: lr)
        loss = train_step(state, {k: v.to(device) for k, v in batch.items()},
                          loss_fn)["loss"].item()
    finally:
        if patched:
            setattr(patched[0], patched[1], real)
    return (loss, {k: p.detach().cpu() for k, p in m.named_parameters()},
            {k: b.cpu() for k, b in m.named_buffers() if "running" in k})


def cls_step_errors(got, ref, init) -> dict:
    """The loss's relative error, and the largest error of any parameter's
    (running statistic's) update relative to that update (norms; the
    update at least CLS_UPDATE_FLOOR in RMS)."""
    def worst(g, r, i):
        return max(
            ((g[k] - v).norm().item()
             / max((v - i[k]).norm().item(),
                   CLS_UPDATE_FLOOR * v.numel() ** 0.5)
             for k, v in r.items()), default=0.0)
    return {"loss": abs(got[0] - ref[0]) / abs(ref[0]),
            "param": worst(got[1], ref[1], init[0]),
            "stat": worst(got[2], ref[2], init[1])}


def cls_step_readings() -> dict:
    """(a)'s readings, printed: "card" (card against CPU), each fault's
    (the faulty card step against the CPU) and "fused" (fused_epilogue=True
    against the unfused step, both on the card)."""
    from mrla_tpu_torch.testing import images, serving_model

    t0 = time.perf_counter()
    model = serving_model(0).train()
    gen = torch.Generator().manual_seed(5)
    batch = {"image": images(gen, CLS_STEP_BATCH, CLS_PX),
             "label": torch.randint(0, 1000, (CLS_STEP_BATCH,),
                                    generator=gen)}
    init = ({k: p.detach().clone() for k, p in model.named_parameters()},
            {k: b.clone() for k, b in model.named_buffers()
             if "running" in k})
    ref = cls_step(model, batch, "cpu")
    print(f"classification step: resnet50_mrlal full depth, {CLS_PX} px, "
          f"bs{CLS_STEP_BATCH}, 1000 classes, SGD lr {CLS_LR} momentum 0.9 "
          f"wd 1e-4, label smoothing 0.1; CPU step in "
          f"{time.perf_counter() - t0:.1f} s, loss {ref[0]:.6f}")
    card = cls_step(model, batch, "cuda")
    out = {"card": cls_step_errors(card, ref, init)}
    for fault in CLS_FAULTS:
        out[fault] = cls_step_errors(cls_step(model, batch, "cuda", fault),
                                     ref, init)
    out["fused"] = cls_step_errors(
        cls_step(model, batch, "cuda", fused=True), card, init)
    for name, e in out.items():
        print(f"classification step, {name}: " + ", ".join(
            f"{k} {v:.4g} (tol {CLS_STEP_TOLS[k]})" for k, v in e.items()))
    return out


def check_cls_step():
    """(a): one full-depth step on the card against the CPU, the four
    faults, and the fused epilogue against the unfused step on the
    card."""
    out = cls_step_readings()
    for name, e in out.items():
        within = all(v <= CLS_STEP_TOLS[k] for k, v in e.items())
        if name in CLS_FAULTS and within:
            raise AssertionError(f"the step check misses the fault {name}")
        if name not in CLS_FAULTS and not within:
            raise AssertionError(f"{name} step beyond tolerance: {e}")


def cls_recipe(name: str, smi: str, extra=()) -> dict:
    """(b): train/cli.py main for CLS_WARMUP + CLS_TIMED steps of a recipe,
    the kernel counts set to 0 just before and read just after."""
    from mrla_tpu_torch.train import cli

    counters = all_counters()
    with tempfile.TemporaryDirectory() as out:
        argv = CLS_RECIPES[name] + [
            "--data", "synthetic", "--num-classes", "1000", "--bf16",
            "--epochs", "1", "--synthetic-steps",
            str(CLS_WARMUP + CLS_TIMED), "--print-freq", "1000",
            "--device", "cuda", "--output-dir", out, *extra]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        res = cli.main(argv)
        torch.cuda.synchronize()
        launches = {k: c.calls for k, c in counters.items()}
        log_lines = len(open(os.path.join(out, "log.txt")).readlines())
    batch = int(argv[argv.index("-b") + 1])
    step_ms = sum(res["step_s"][CLS_WARMUP:]) / CLS_TIMED * 1e3
    data_ms = sum(res["data_s"][CLS_WARMUP:]) / CLS_TIMED * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    desc = f"{name} recipe{' ' + ' '.join(extra) if extra else ''}"
    print(f"training {desc} ({argv[1]}, {CLS_PX} px, bs{batch}, bf16): "
          f"{step_ms:.2f} ms/step, {batch / step_ms * 1e3:.2f} img/s over "
          f"{CLS_TIMED} steps after {CLS_WARMUP} (data "
          f"{data_ms:.1f} ms/step beside it), peak memory {peak:.2f} GiB, "
          f"on {smi}; losses {[round(v, 4) for v in res['loss']]}; kernel "
          f"launches {launches}")
    if not all(math.isfinite(v) for v in res["loss"]):
        raise AssertionError(f"{desc}: non-finite losses {res['loss']}")
    if any(launches.values()):
        raise AssertionError(f"{desc}: the port's kernels launched "
                             f"{launches}")
    if log_lines != 1:  # one epoch, rank 0's line
        raise AssertionError(f"{desc}: {log_lines} lines in log.txt")
    return {"ms": step_ms, "img_s": batch / step_ms * 1e3, "peak": peak}


def check_cls_learning(smi: str):
    """(c): a small resnet_mrlal learns the synthetic templates."""
    from mrla_tpu_torch.train import cli

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        argv = CLS_LEARN_ARGV + ["--print-freq", "1000", "--device", "cuda",
                                 "--output-dir", out]
        loss = cli.main(argv)["loss"]
        acc1 = cli.main(argv + ["-e", "--resume", out])["acc1"]
    first = sum(loss[:LEARN_WINDOW]) / LEARN_WINDOW
    last = sum(loss[-LEARN_WINDOW:]) / LEARN_WINDOW
    print(f"classification learning: resnet_mrlal layers 1-1-1-1, 64 px, "
          f"10 classes, bs32, {len(loss)} steps in "
          f"{time.perf_counter() - t0:.1f} s on {smi}: mean loss of the "
          f"first {LEARN_WINDOW} steps {first:.4f}, of the last {last:.4f} "
          f"(ratio {last / first:.4f}, tol {CLS_LEARN_RATIO_TOL}); top-1 of "
          f"-e on the last checkpoint {acc1:.2f}% (tol {CLS_LEARN_ACC1})")
    if not last / first <= CLS_LEARN_RATIO_TOL:
        raise AssertionError(f"the loss fell only to {last / first:.3f} of "
                             f"its start")
    if not acc1 > CLS_LEARN_ACC1:
        raise AssertionError(f"top-1 {acc1:.2f}% after learning")


def train_classify(smi: str) -> None:
    """Phase 8b, classification training."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    check_cls_step()
    runs = {}
    for extra in ((), ("--fused-epilogue",), ("--fused-epilogue",), ()):
        runs.setdefault(extra, []).append(cls_recipe("resnet", smi, extra))
    for extra, rs in runs.items():
        print(f"resnet recipe{' ' + extra[0] if extra else ''}: img/s "
              f"{[round(r['img_s'], 2) for r in rs]}")
    cls_recipe("deit", smi)
    check_cls_learning(smi)
    print(f"classification training phase: {time.perf_counter() - t0:.1f} s")


def zoo_fault(model, kind: str):
    """Inject the wiring fault ``kind`` (ZOO_FAULTS) into the served
    ``model``; returns the function that takes it out again."""
    from mrla_tpu_torch.models.common import BatchNorm2d
    from mrla_tpu_torch.nn.layers import MRLALightModule

    undo = []

    def set_attr(obj, name, value):
        old = obj.__dict__.get(name, None)
        undo.append(lambda: (setattr(obj, name, old) if old is not None
                             else obj.__dict__.pop(name, None)))
        setattr(obj, name, value)

    def swap_data(a, b):
        da, db = a.data, b.data
        a.data, b.data = db, da
        undo.append(lambda: (setattr(a, "data", da), setattr(b, "data", db)))

    mods = list(model.modules())
    if kind == "bn_eps_1e-5":
        for m in mods:
            if isinstance(m, BatchNorm2d):
                set_attr(m, "eps", 1e-5)
    elif kind == "no_lambda_identity":
        for m in mods:
            if isinstance(m, MRLALightModule):
                set_attr(m, "forward", lambda xt, ot_1, m=m: m.mrla(xt))
    elif kind == "mrla_ot_is_h":
        for m in mods:
            if isinstance(m, MRLALightModule):
                plain = type(m).forward
                set_attr(m, "forward",
                         lambda xt, ot_1, m=m, f=plain: f(m, xt, xt))
    elif kind in ("no_se", "no_se_stage3_1"):
        blocks = ([model.stage3_1] if kind == "no_se_stage3_1"
                  else [m for m in mods if getattr(m, "se", None) is not None])
        for blk in blocks:
            set_attr(blk.se, "forward", lambda x: x)
    elif kind == "eca_taps_reversed":
        for m in mods:
            if getattr(m, "eca", None) is not None:
                w = m.eca.conv.weight
                swap_data(w, w.data.flip(-1).clone())
    elif kind == "no_dw_branch":
        for m in mods:
            if getattr(m, "dwconv", None) is not None:
                set_attr(m.bn_dw, "forward", torch.zeros_like)
    elif kind == "gammas_swapped":
        for blk in model.blocks:
            swap_data(blk.gamma_1, blk.gamma_2)
    elif kind == "cls_not_in_kv":  # the cls token's query over the patches
        set_attr(model.blocks_token_only[0].attn, "num_cls", 1)
    else:
        raise ValueError(kind)
    return lambda: [f() for f in reversed(undo)]


def serve_zoo(smi: str):
    """Phase 8c (a): each ZOO_ARCHS arch through the precast engine, its
    logit check with its faults, then img/s twice in turns.  None may launch
    a kernel of the port.  Returns (launches, launches per forward by
    shape) keyed by path, as serve()'s."""
    from mrla_tpu_torch.serving import (
        precast_forward,
        prepare_precast_inference_params,
    )
    from mrla_tpu_torch.testing import images, zoo_serving_model

    gen = torch.Generator().manual_seed(7)
    host_batches = [images(gen, BATCH, PX) for _ in range(ZOO_REQUESTS)]
    batches = [xb.cuda() for xb in host_batches]
    x16 = batches[0][:ZOO_REF_IMAGES]
    launches, per_forward, served = {}, {}, {}
    for arch in ZOO_ARCHS:
        t0 = time.perf_counter()
        model = zoo_serving_model(arch, 0)
        with torch.no_grad():  # the port's fp32 CPU forward
            ref = model(host_batches[0][:ZOO_REF_IMAGES])
        card = prepare_precast_inference_params(model, device="cuda")
        del model
        fwd = lambda xb, m=card: precast_forward(m, xb)
        path = f"{arch} precast"
        out, launches[path], per_forward[path] = counted(
            fwd, batches, path, no_kernels())
        tol = ZOO_LOGIT_ERROR_TOL[arch]
        check_logits(ref, out[0][:ZOO_REF_IMAGES].cpu(), path, tol)
        del out
        errs = {}
        for kind in ZOO_FAULTS[arch]:
            undo = zoo_fault(card, kind)
            try:
                errs[kind] = logit_error(fwd(x16).cpu(), ref)
            finally:
                undo()
        print(f"logit error with {path}, injected faults (sound reading "
              f"above, tol {tol}): "
              + ", ".join(f"{k} {v:.4g}" for k, v in errs.items())
              + f"; {time.perf_counter() - t0:.1f} s with the CPU reference")
        missed = [k for k, v in errs.items() if not v > tol]
        if missed:
            raise AssertionError(f"{arch}: the logit check misses {missed}")
        served[arch] = fwd
    for arch in ZOO_ARCHS + ZOO_ARCHS[::-1]:  # twice, in turns
        throughput(served[arch], batches, f"{arch} precast", smi)
    return launches, per_forward


def check_zoo_step():
    """Phase 8c (b): one fp32 RMSpropTF step of the seeded full-depth
    efficientnet_mrlal_b0 on the card against the CPU, and its fault."""
    from mrla_tpu_torch.testing import images, zoo_serving_model
    from mrla_tpu_torch.train.optim import rmsprop_tf

    t0 = time.perf_counter()
    model = zoo_serving_model(ZOO_STEP_ARCH, 0).train()
    gen = torch.Generator().manual_seed(9)
    # Right after the calibration pass a BN that follows a bias-free conv
    # of another BN's output holds exactly the mean the step's batch gives
    # (W·β, whatever the images): its update is rounding alone.  A trained
    # model's statistics lag its weights; so are these, moved off by 0.1
    # std and scaled by U(0.8, 1.25), as tests/test_torch_train.py does.
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.running_mean.numel()
                m.running_mean.add_(0.1 * m.running_var.sqrt()
                                    * torch.randn(c, generator=gen))
                m.running_var.mul_(torch.empty(c).uniform_(
                    0.8, 1.25, generator=gen))
    batch = {"image": images(gen, CLS_STEP_BATCH, CLS_PX),
             "label": torch.randint(0, 1000, (CLS_STEP_BATCH,),
                                    generator=gen)}
    init = ({k: p.detach().clone() for k, p in model.named_parameters()},
            {k: b.clone() for k, b in model.named_buffers()
             if "running" in k})
    opt = lambda params: rmsprop_tf(params, ZOO_STEP_LR, weight_decay=1e-5)
    ref = cls_step(model, batch, "cpu", optimizer=opt)
    out = {"card": cls_step_errors(cls_step(model, batch, "cuda",
                                            optimizer=opt), ref, init),
           ZOO_STEP_FAULT: cls_step_errors(cls_step(
               model, batch, "cuda", ZOO_STEP_FAULT, optimizer=opt), ref,
               init)}
    print(f"zoo step: {ZOO_STEP_ARCH} full depth, {CLS_PX} px, "
          f"bs{CLS_STEP_BATCH}, RMSpropTF lr {ZOO_STEP_LR} wd 1e-5, label "
          f"smoothing 0.1, loss {ref[0]:.6f}; "
          f"{time.perf_counter() - t0:.1f} s")
    for name, e in out.items():
        print(f"zoo step, {name}: " + ", ".join(
            f"{k} {v:.4g} (tol {CLS_STEP_TOLS[k]})" for k, v in e.items()))
    if not all(v <= CLS_STEP_TOLS[k] for k, v in out["card"].items()):
        raise AssertionError(f"zoo step beyond tolerance: {out['card']}")
    if all(v <= CLS_STEP_TOLS[k] for k, v in out[ZOO_STEP_FAULT].items()):
        raise AssertionError(f"the zoo step check misses {ZOO_STEP_FAULT}")


def model_zoo(smi: str):
    """Phase 8c, the model zoo; returns serve_zoo()'s counts."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    counts = serve_zoo(smi)
    check_zoo_step()
    print(f"efficientnet recipe: reduced: {ZOO_REDUCED}")
    cls_recipe("efficientnet", smi)
    print(f"model zoo phase: {time.perf_counter() - t0:.1f} s")
    return counts


def decoders_text() -> dict:
    """(a) What decodes on this machine: Pillow's version, the native
    loader's build (or its error), nvJPEG's header; printed, returned."""
    from mrla_tpu_torch.data import native

    try:
        import PIL
        pil = PIL.__version__
    except ImportError:
        pil = None
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    nvjpeg = os.path.join(os.path.dirname(os.path.dirname(nvcc)), "include",
                          "nvjpeg.h")
    found = {"pil": pil, "native": native.available(),
             "native_error": native.build_error(),
             "nvjpeg_h": os.path.exists(nvjpeg)}
    print(f"decoders: Pillow {pil or 'absent'}; native loader "
          + ("built" if found["native"] else
             "unavailable: " + " | ".join(
                 (found["native_error"] or "").splitlines()[:3]))
          + f"; nvjpeg.h {'present' if found['nvjpeg_h'] else 'absent'} "
            f"(not used: "
          + ("Pillow decodes here)" if pil else "no decoder is built)"))
    if pil is None:
        raise AssertionError("no JPEG decoder on this machine: Pillow is "
                             "absent, and the port has no other build for it")
    return found


def _write_image(path: str, seed: int, c: int, hw) -> None:
    """A smooth seeded image: a coarse random grid resampled bicubically,
    tinted by its class."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (6, 8, 3)).astype(np.float64)
    coarse[..., c % 3] = 0.5 * coarse[..., c % 3] + 12.0 * c
    img = Image.fromarray(coarse.clip(0, 255).astype(np.uint8)).resize(
        (hw[1], hw[0]), Image.BICUBIC)
    img.save(path, quality=90)


def write_jpeg_tree(root: str) -> None:
    """(b) root/{train,val}/class_<c>/*.jpg, seeded, in threads."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = []
    for split, per_class in (("train", [REAL_PER_CLASS] * REAL_CLASSES),
                             ("val", [REAL_VAL // REAL_CLASSES + (
                                 c < REAL_VAL % REAL_CLASSES)
                                 for c in range(REAL_CLASSES)])):
        for c, n in enumerate(per_class):
            d = os.path.join(root, split, f"class_{c}")
            os.makedirs(d)
            for i in range(n):
                seed = len(jobs)
                jobs.append((os.path.join(d, f"{i:04d}.jpg"), seed, c,
                             REAL_SIZES[seed % len(REAL_SIZES)]))
    with ThreadPoolExecutor(REAL_WORKERS) as pool:
        list(pool.map(lambda j: _write_image(*j), jobs))


def check_decoders(root: str, found: dict, smi: str) -> None:
    """(c) The card's decoder (through the threaded loader, as the trainer
    runs it) against the same decoder image by image, train and eval,
    bilinear and bicubic; the card's normalisation against the host's; the
    loader's rate over the train set with REAL_WORKERS threads (one batch
    a thread) beside one batch's."""
    import numpy as np

    from mrla_tpu_torch.data import (
        ImageFolder,
        choose_decoder,
        iterate_batches,
        native,
        normalize,
    )

    ds = ImageFolder(os.path.join(root, "train"))
    idx = np.random.default_rng(0).permutation(len(ds))[:REAL_BATCH]
    seed = 17
    for interp in ("bilinear", "bicubic"):
        want_decoder = ("native" if interp == "bilinear" and found["native"]
                        else "pil")
        for train in (True, False):
            t0 = time.perf_counter()
            (b,) = iterate_batches(ds, idx, REAL_BATCH, REAL_PX, train=train,
                                   seed=seed, num_threads=REAL_WORKERS,
                                   interpolation=interp)
            loader_s = time.perf_counter() - t0
            if b["decoder"] != want_decoder:
                raise AssertionError(f"{interp} batch decoded by "
                                     f"{b['decoder']}, not {want_decoder}")
            t0 = time.perf_counter()
            if want_decoder == "native":
                ref = native.decode_batch([ds.samples[i][0] for i in idx],
                                          REAL_PX, train=train,
                                          seed=seed * 1_000_003,
                                          num_threads=1)
            else:
                rng = np.random.default_rng((seed, 0))
                ref = np.stack([ds.load_train(i, REAL_PX, rng, interp)
                                if train else
                                ds.load_eval(i, REAL_PX, interp)
                                for i in idx])
            one_s = time.perf_counter() - t0
            err = int(np.abs(b["image"].astype(np.int32) - ref).max())
            x = torch.from_numpy(b["image"])
            norm_err = (normalize(x.to(CARD)).cpu()
                        - normalize(x)).abs().max().item()
            print(f"decoder check {interp} {'train' if train else 'eval'} "
                  f"(bs{REAL_BATCH}, {REAL_PX} px): {b['decoder']}, the "
                  f"loader's batch vs image by image max abs err {err} (tol "
                  f"0); the card's normalize vs the host's {norm_err:.3g} "
                  f"(tol {REAL_NORM_TOL}); one batch "
                  f"{REAL_BATCH / loader_s:.1f} img/s in the loader, "
                  f"{REAL_BATCH / one_s:.1f} image by image, on {smi}")
            if err != 0 or not norm_err <= REAL_NORM_TOL:
                raise AssertionError(f"decoder check {interp} train={train}")
        t0 = time.perf_counter()
        n = sum(len(b["label"]) for b in iterate_batches(
            ds, np.arange(len(ds)), REAL_BATCH, REAL_PX, seed=seed,
            num_threads=REAL_WORKERS, interpolation=interp))
        print(f"loader rate {interp} train: {n} images in "
              f"{n // REAL_BATCH} batches, {REAL_WORKERS} threads: "
              f"{n / (time.perf_counter() - t0):.1f} img/s")
    if choose_decoder(ds, "bilinear") != ("native" if found["native"]
                                          else "pil"):
        raise AssertionError("choose_decoder disagrees with the build")


def trace_kernels(path: str) -> int:
    """CUDA kernel events of a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events if e.get("cat") == "kernel")


def real_recipe(name: str, root: str, found: dict, smi: str,
                profile_dir=None, run_dir=None) -> dict:
    """(d), (e): train/cli.py main for one epoch of the real tree, then
    validation; the kernel counts set to 0 just before and read just
    after.  The run directory is ``run_dir`` (kept), else a temporary
    one."""
    from mrla_tpu_torch.train import cli

    counters = all_counters()
    with (contextlib.nullcontext(run_dir) if run_dir
          else tempfile.TemporaryDirectory()) as out:
        argv = REAL_RECIPES[name] + [
            "--data", root, "--num-classes", str(REAL_CLASSES),
            "--workers", str(REAL_WORKERS), "--print-freq", "1000",
            "--device", CARD, "--output-dir", out]
        if profile_dir:
            argv += ["--profile-dir", profile_dir]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        res = cli.main(argv)
        torch.cuda.synchronize()
        launches = {k: c.calls for k, c in counters.items()}
    batch = int(argv[argv.index("-b") + 1])
    lo, hi = REAL_TIMED
    step_ms = sum(res["step_s"][lo:hi]) / (hi - lo) * 1e3
    wait_ms = sum(res["data_s"][lo:hi]) / (hi - lo) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    interp = "bicubic" if argv[1].startswith(cli.TIMM_STYLE) else "bilinear"
    want = "native" if interp == "bilinear" and found["native"] else "pil"
    desc = f"real-data {name} recipe ({argv[1]}, {REAL_PX} px, bs{batch})"
    print(f"{desc}: {step_ms:.2f} ms/step, {batch / step_ms * 1e3:.2f} img/s "
          f"over steps {lo}-{hi - 1} (data {wait_ms:.1f} ms/step beside "
          f"it: the loader's wait, the copy, the augmentation's launches; "
          f"every step's data {[round(v * 1e3, 1) for v in res['data_s']]} "
          f"ms, step "
          f"{[round(v * 1e3, 1) for v in res['step_s']]} ms), peak memory "
          f"{peak:.2f} GiB, on {smi}; losses "
          f"{[round(v, 4) for v in res['loss']]}; decoders "
          f"{res['decoders']}; val count {res['val_count']}; kernel "
          f"launches {launches}")
    n_images = REAL_CLASSES * REAL_PER_CLASS
    if "--repeated-aug" in argv:  # RASampler's cut to a multiple of 256
        n_images = n_images // 256 * 256
    n_steps = n_images // batch
    if len(res["loss"]) != n_steps or not all(
            math.isfinite(v) for v in res["loss"]):
        raise AssertionError(f"{desc}: losses {res['loss']}")
    if set(res["decoders"]["train"] + res["decoders"]["val"]) != {want} or (
            len(res["decoders"]["train"]) != n_steps):
        raise AssertionError(f"{desc}: decoders {res['decoders']}, not "
                             f"{want}")
    if res["val_count"] != REAL_VAL:
        raise AssertionError(f"{desc}: val count {res['val_count']}")
    if any(launches.values()):
        raise AssertionError(f"{desc}: the port's kernels launched "
                             f"{launches}")
    return {"ms": step_ms, "wait_ms": wait_ms, "peak": peak}


def _subset_tree(root: str, dst: str, per_class: int, n_val: int) -> None:
    """A tree of symlinks to the first images of each class of root."""
    for split, n in (("train", per_class),
                     ("val", -(-n_val // REAL_CLASSES))):
        for c in range(REAL_CLASSES):
            src = os.path.join(root, split, f"class_{c}")
            os.makedirs(os.path.join(dst, split, f"class_{c}"))
            for fn in sorted(os.listdir(src))[:n]:
                os.symlink(os.path.join(src, fn),
                           os.path.join(dst, split, f"class_{c}", fn))


def check_finetune(root: str, work: str) -> None:
    """(f) A deit_mrlal_tiny checkpoint at 224 px fine-tuned at 384 px with
    10 classes and the EMA: the restored state before its first step
    (--epochs 0), then 2 steps on the real tree."""
    from mrla_tpu_torch.ckpt import read_model_state_dict
    from mrla_tpu_torch.train import cli
    from mrla_tpu_torch.utils import interpolate_pos_embed

    arch = "deit_mrlal_tiny_patch16_224"
    common = ["-a", arch, "--opt", "adamw", "--lr", "5e-4", "--bf16",
              "--print-freq", "1000", "--device", CARD]
    pre = os.path.join(work, "pre")
    cli.main(common + ["--data", "synthetic", "--image-size", "224",
                       "--num-classes", "1000", "-b", str(REAL_AUX_BATCH),
                       "--synthetic-steps", "2", "--epochs", "1",
                       "--output-dir", pre])
    saved = read_model_state_dict(pre)  # on the host, as --finetune reads
    sub = os.path.join(work, "ft_tree")
    _subset_tree(root, sub, -(-2 * REAL_FT_BATCH // REAL_CLASSES),
                 REAL_FT_BATCH)
    ft = common + ["--data", sub, "--image-size", str(REAL_FT_PX),
                   "--num-classes", str(REAL_CLASSES), "-b",
                   str(REAL_FT_BATCH), "--ema-decay", "0.99996",
                   "--finetune", pre, "--output-dir",
                   os.path.join(work, "ft")]
    state = cli.main(ft + ["--epochs", "0"])["state"]
    got = {k: v.cpu() for k, v in state.model.state_dict().items()}
    grid = (REAL_FT_PX // 16) ** 2
    errs = {"pos_embed": (got["pos_embed"] - interpolate_pos_embed(
        saved["pos_embed"], grid, 1)).abs().max().item()}
    errs["others"] = max((got[k] - saved[k]).abs().max().item()
                         for k in got if k != "pos_embed"
                         and not k.startswith("head"))
    errs["ema"] = max((v.cpu() - got[k]).abs().max().item()
                      for k, v in state.ema.state_dict().items()
                      if v.is_floating_point())
    head = (tuple(got["head.weight"].shape), got["head.bias"].abs().max(
        ).item(), got["head.weight"].std().item())
    res = cli.main(ft + ["--epochs", "1"])
    print(f"finetune {arch} 224 -> {REAL_FT_PX} px, 1000 -> {REAL_CLASSES} "
          f"classes, EMA 0.99996: before the first step, max abs err of "
          f"pos_embed vs interpolate_pos_embed {errs['pos_embed']:.3g}, of "
          f"the other weights vs the saved {errs['others']:.3g}, of the EMA "
          f"vs the model {errs['ema']:.3g} (tol 0); head {head[0]}, |bias| "
          f"{head[1]:.3g}, weight std {head[2]:.4f}; then "
          f"{len(res['loss'])} steps on the real tree at bs{REAL_FT_BATCH}, "
          f"losses {[round(v, 4) for v in res['loss']]}, decoders "
          f"{sorted(set(res['decoders']['train']))}")
    if any(errs.values()) or head[0] != (REAL_CLASSES, 192) or head[1]:
        raise AssertionError(f"finetune: {errs}, head {head}")
    if len(res["loss"]) != 2 or not all(math.isfinite(v)
                                        for v in res["loss"]):
        raise AssertionError(f"finetune steps: {res['loss']}")


def check_teacher_resume(work: str) -> None:
    """(g) A resnet50 checkpoint as the distillation teacher of
    deit_tiny_distilled: the teacher's logits against the reloaded
    checkpoint's, and the random-init teacher (the injected fault)
    beyond the limit."""
    from mrla_tpu_torch.ckpt import read_model_state_dict
    from mrla_tpu_torch.models import create_model
    from mrla_tpu_torch.train import cli

    common = ["--data", "synthetic", "--image-size", str(REAL_PX),
              "--num-classes", str(REAL_CLASSES), "-b", str(REAL_AUX_BATCH),
              "--synthetic-steps", "2", "--epochs", "1", "--print-freq",
              "1000", "--device", CARD]
    t_dir = os.path.join(work, "teacher")
    cli.main(["-a", "resnet50", "--output-dir", t_dir, *common])
    student = ["-a", "deit_tiny_distilled_patch16_224", "--opt", "adamw",
               "--lr", "5e-4", "--distillation-type", "hard", *common]
    res = cli.main(student + ["--teacher-resume", t_dir, "--output-dir",
                              os.path.join(work, "student")])
    fault = cli.main(student + ["--output-dir",
                                os.path.join(work, "student_random")])
    saved = create_model("resnet50", device=CARD,
                         num_classes=REAL_CLASSES)
    saved.load_state_dict(read_model_state_dict(t_dir,
                                                map_location=CARD))
    x = torch.randn(REAL_AUX_BATCH, REAL_PX, REAL_PX, 3, device=CARD,
                    generator=torch.Generator(CARD).manual_seed(5))
    with torch.no_grad():
        want = saved.eval()(x)
        err = (res["teacher"](x) - want).abs().max().item()
        fault_err = (fault["teacher"](x) - want).abs().max().item()
    print(f"teacher-resume: resnet50 -> deit_tiny_distilled, hard, "
          f"{len(res['loss'])} steps, losses "
          f"{[round(v, 4) for v in res['loss']]}; teacher logits vs the "
          f"reloaded checkpoint max abs err {err:.3g} (tol "
          f"{REAL_TEACHER_TOL}); the random-init teacher {fault_err:.3g}")
    if not err <= REAL_TEACHER_TOL:
        raise AssertionError(f"teacher-resume: logits off by {err}")
    if fault_err <= REAL_TEACHER_TOL:
        raise AssertionError("the teacher check misses a random teacher")
    if not all(math.isfinite(v) for v in res["loss"]):
        raise AssertionError(f"teacher-resume losses {res['loss']}")


def train_real_data(smi: str, work: str) -> None:
    """Phase 8d, classification training on real data, in ``work``; the
    JPEG tree (``work/tree``) and the ResNet recipe's run directory
    (``work/run_resnet``) stay there for phase 8h."""
    t0 = time.perf_counter()
    counters = all_counters()
    for c in counters.values():
        c.reset()
    found = decoders_text()
    root = os.path.join(work, "tree")
    t1 = time.perf_counter()
    write_jpeg_tree(root)
    print(f"jpeg tree: {REAL_CLASSES} x {REAL_PER_CLASS} train, "
          f"{REAL_VAL} val images of {REAL_SIZES} (h, w) in "
          f"{time.perf_counter() - t1:.1f} s")
    check_decoders(root, found, smi)
    prof = os.path.join(work, "profile")
    real_recipe("resnet", root, found, smi, profile_dir=prof,
                run_dir=os.path.join(work, "run_resnet"))
    from mrla_tpu_torch.train import cli

    trace = os.path.join(prof, cli.TRACE_NAME)
    n_kernels = trace_kernels(trace)
    print(f"profile of steps {cli.PROFILE_STEPS[0]}-"
          f"{REAL_CLASSES * REAL_PER_CLASS // REAL_BATCH - 1}: "
          f"{os.path.getsize(trace) / 2 ** 20:.1f} MiB, {n_kernels} CUDA "
          f"kernel events")
    if not n_kernels:
        raise AssertionError("the profile holds no CUDA kernel event")
    real_recipe("deit", root, found, smi)
    check_finetune(root, work)
    check_teacher_resume(work)
    launches = {k: c.calls for k, c in counters.items()}
    wall = time.perf_counter() - t0
    print(f"real-data training phase: {wall:.1f} s (limit {REAL_WALL_S}); "
          f"kernel launches across it {launches}")
    if any(launches.values()):
        raise AssertionError(f"phase 8d launched the port's kernels "
                             f"{launches}")
    if wall > REAL_WALL_S:
        raise AssertionError(f"phase 8d took {wall:.1f} s")


# Phase 8e: RetinaNet, the COCO loader and the detection trainer's options.
# All at full depth, published widths and 80 classes.  (a) RetinaNet served
# through the module under bf16 autocast (800 x 1344, batch 8) against the
# port's fp32 forward on the CPU for 2 images: each level's (cls, reg) maps
# relative to their norm ("maps"), and get_bboxes on the card, fed the CPU's
# maps, against get_bboxes on the CPU ("boxes": the share of the CPU's
# detections that no card detection of the same class meets at IoU >=
# RETINA_MATCH_IOU); the same share of the card's end-to-end bf16
# detections is printed beside it (bf16 reorders near-equal scores, so it
# is no check); then the pyramid of detect_forward with RetinaNet's neck
# against the module's P3..P7 (DET_TOLS["pyramid"]).
RETINA_PRESET = "retinanet_r50mrlal_fpn_1x_coco"
RETINA_PATH = "retinanet_r50mrlal"
RETINA_PYRAMID_PATH = "retinanet_r50mrlal detect_forward"
RETINA_MATCH_IOU = 0.7
# limits between the sound reading and the least injected fault (both
# printed by this script; readings in PERF.md)
RETINA_TOLS = {"maps": 0.25, "boxes": 0.05}
# extra_on_p5: the first extra conv fed P5 where C5 is wanted ("on_output",
# the conv's first 256 input channels);
# scale_major: the anchors scale-major where mmdet's are ratio-major;
# unshared: levels P4..P7 through a second head at the mmdet init
RETINA_FAULTS = {"extra_on_p5": "maps", "scale_major": "boxes",
                 "unshared": "maps"}
# (b) one training step at 800 x 800, batch 2, fp32 (TF32 off), card against
# CPU: the loss terms relative, num_pos exactly, the gradients of the head's
# parameters and of P3..P7 relative to their norms
RETINA_STEP_PX, RETINA_STEP_BATCH = 800, 2
RETINA_STEP_TOLS = {"loss": 1e-3, "grad": 0.02}
# alpha: α and 1 - α swapped; avg_per_image: each image's loss over its own
# positives; neg_iou: neg_iou_thr 0.5 where mmdet's is 0.4
RETINA_STEP_FAULTS = ("alpha", "avg_per_image", "neg_iou")
# (c) the trainer on a seeded COCO-format tree: COCO_TRAIN train and COCO_VAL
# val JPEGs at COCO-like sizes (h, w), COCO's 80 sparse category ids
COCO_TRAIN, COCO_VAL = 64, 20
COCO_SIZES = [(480, 640), (640, 480), (375, 500)]
COCO_HW, COCO_BATCH = (800, 1344), 8
COCO_WARMUP = 2  # steps before the timed ones, of the epoch's 8
COCO_ROI = {(COCO_BATCH, 512, 7, 256): "box head"}
COCO_MASK_ROI = {(COCO_BATCH, 128, 14, 256): "mask head",
                 (COCO_BATCH, 128, 28, TRAIN_MAX_GT): "gt mask crop"}
# (d) one --bf16 step against the fp32 step on the card (same weights and
# batch; the faster preset on the fp32 step's sampled rois): each loss term
# relative (BF16_STEP_TOL, above the bf16 forward's own rounding), which the
# ground-truth boxes cast to bf16 with the images must fail.  The
# second fault, the logits fed to the focal / softmax loss in bf16, moves a
# term by less than that rounding (the step compares sums over 10^5 to 10^7
# elements), so the bf16 step's terms are also held to the same loss calls
# recomputed on the CPU in fp32 from the step's own head outputs
# (BF16_LOSS_TOL: the card's fp32 sums in another order), which that fault
# must fail.
BF16_STEP_TOL = 1.5e-3
BF16_LOSS_TOL = 5e-6
RETINA_WALL_S = 150.0  # the phase's target wall time, printed beside it


def retina_maps_error(got, ref) -> float:
    """Largest relative error (norm) of any level's cls or reg map."""
    return max(rel_err(g, r) for gl, rl in zip(got, ref)
               for g, r in zip(gl, rl))


def boxes_miss(got, ref) -> float:
    """The share of the reference's detections (CPU, fp32) that no card
    detection of the same class meets at IoU >= RETINA_MATCH_IOU (or, for
    a box clipped to zero area, within a pixel at every corner)."""
    from mrla_tpu_torch.detect.bbox import bbox_overlaps

    missed = total = 0
    for b in range(ref[0].shape[0]):
        rv, gv = ref[3][b], got[3][b].cpu()
        rb, gb = ref[0][b][rv], got[0][b].cpu().float()[gv]
        same = ref[2][b][rv][:, None] == got[2][b].cpu()[gv][None, :]
        iou = bbox_overlaps(rb, gb) * same
        # a box clipped to zero area at the border matches by its corners
        near = ((rb[:, None] - gb[None]).abs().amax(-1) <= 1.0) & same
        hit = ((iou >= RETINA_MATCH_IOU) | near).any(1)
        missed += int((~hit).sum())
        total += len(rb)
    return missed / max(total, 1)


def retina_forward(model, x):
    """The module's bf16 forward and get_bboxes on the card."""
    from mrla_tpu_torch.detect.retinanet import get_bboxes

    with torch.inference_mode(), torch.autocast(x.device.type,
                                                torch.bfloat16):
        outs = model(x)
        return outs, get_bboxes(outs, (x.shape[1], x.shape[2]))


def retina_errors(model, x2, ref) -> dict:
    """maps: the card's bf16 maps; boxes: get_bboxes on the card of the
    CPU's maps; end_to_end: the card's bf16 detections (printed only)."""
    from mrla_tpu_torch.detect.retinanet import get_bboxes

    outs, dets = retina_forward(model, x2)
    dev = [(c.to(x2.device), r.to(x2.device)) for c, r in ref["outs"]]
    return {"maps": retina_maps_error(outs, ref["outs"]),
            "boxes": boxes_miss(get_bboxes(dev, tuple(x2.shape[1:3])),
                                ref["dets"]),
            "end_to_end": boxes_miss(dets, ref["dets"])}


def faulty_retina_errors(model, x2, ref, kind: str) -> dict:
    """retina_errors with one wiring fault (RETINA_FAULTS)."""
    import types

    import mrla_tpu_torch.detect.fpn as fpn_mod
    import mrla_tpu_torch.detect.retinanet as rn

    anchors, forward = rn.level_anchors, model.forward
    fpn_forward = fpn_mod.fpn_forward
    if kind == "extra_on_p5":
        def on_p5(neck, inputs, num_outs=5, start_level=0,
                  add_extra_convs=None):  # P5 has the weight's first C ins
            (w, b), *rest = neck["extra"]
            neck = {**neck, "extra": [(w[:, :w.shape[0]], b), *rest]}
            return fpn_forward(neck, inputs, num_outs, start_level,
                               "on_output")
        fpn_mod.fpn_forward = on_p5
    elif kind == "scale_major":
        def scale_major(level_outputs, *a, **kw):
            out = []
            for anc in anchors(level_outputs, *a, **kw):  # [HW * 9, 4]
                out.append(anc.reshape(-1, 3, 3, 4).transpose(1, 2)
                           .reshape(-1, 4))
            return out
        rn.level_anchors = scale_major
    else:
        fresh = rn.RetinaHead(generator=torch.Generator().manual_seed(9)).to(
            CARD)
        model.forward = types.MethodType(lambda self, x: tuple(
            (self.bbox_head if i == 0 else fresh)(f)
            for i, f in enumerate(self.neck(self.backbone(x)))), model)
    try:
        return retina_errors(model, x2, ref)
    finally:
        fpn_mod.fpn_forward = fpn_forward
        rn.level_anchors = anchors
        model.forward = forward


def check_retina_dets(out) -> None:
    boxes, scores, labels, valid = out[1]
    if boxes.shape != (DET_BATCH, 100, 4) or not (
            torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
        raise AssertionError("RetinaNet detections not finite or of the "
                             "wrong shape")
    if valid.sum(1).min() < 1:
        raise AssertionError(f"an image without detections: "
                             f"{valid.sum(1).tolist()}")


def finite_pyramid(out) -> None:
    if len(out) != 5 or not all(torch.isfinite(p).all() for p in out):
        raise AssertionError("pyramid not finite or not 5 levels")


def serve_retinanet(smi: str) -> None:
    """(a) RetinaNet inference through the module, the check against the
    CPU with its three faults, throughput; the detect_forward pyramid with
    RetinaNet's neck and its launches."""
    import copy

    from mrla_tpu_torch.detect.retinanet import get_bboxes
    from mrla_tpu_torch.serving import detect as det
    from mrla_tpu_torch.testing import images, retinanet_serving_model

    t0 = time.perf_counter()
    host_model = seeded("retinanet", lambda: retinanet_serving_model(0))
    gen = torch.Generator().manual_seed(4)
    host = [images(gen, DET_BATCH, DET_HW) for _ in range(DET_REQUESTS)]
    t1 = time.perf_counter()
    x2h = host[0][:2]
    with torch.no_grad():
        pyr = host_model.neck(host_model.backbone(x2h))
        outs = tuple(host_model.bbox_head(f) for f in pyr)
        ref = {"outs": outs, "dets": get_bboxes(outs, DET_HW), "pyr": pyr}
    print(f"retinanet: seeded and spread in {t1 - t0:.1f} s; fp32 CPU "
          f"forward of 2 images in {time.perf_counter() - t1:.1f} s; CPU "
          f"detections per image {ref['dets'][3].sum(1).tolist()}")
    model = copy.deepcopy(host_model).to(CARD).eval()
    batches = [xb.to(CARD) for xb in host]
    desc = f"{DET_HW[0]}x{DET_HW[1]} bs{DET_BATCH} bf16"
    want = {k: {} for k in all_counters()}
    outs_c, _, _ = counted(lambda xb: retina_forward(model, xb), batches,
                           RETINA_PATH, want, check_retina_dets, desc)
    print(f"{RETINA_PATH}: detections per image "
          f"{outs_c[0][1][3].sum(1).tolist()}, labels of image 0 "
          f"{outs_c[0][1][2][0, :8].tolist()}")
    del outs_c
    x2 = x2h.to(CARD)
    errs = retina_errors(model, x2, ref)
    print(f"{RETINA_PATH} against the fp32 CPU forward (2 images): "
          + ", ".join(f"{k} {v:.4g} (tol {RETINA_TOLS.get(k)})"
                      for k, v in errs.items()))
    over = [k for k, v in RETINA_TOLS.items() if not errs[k] <= v]
    if over:
        raise AssertionError(f"{RETINA_PATH}: {over} beyond tolerance")
    for kind, metric in RETINA_FAULTS.items():
        fe = faulty_retina_errors(model, x2, ref, kind)
        print(f"{RETINA_PATH} with the fault {kind}: "
              + ", ".join(f"{k} {v:.4g}" for k, v in fe.items()))
        if not fe[metric] > RETINA_TOLS[metric]:
            raise AssertionError(f"the {metric} check misses the fault "
                                 f"{kind}")
    throughput(lambda xb: retina_forward(model, xb), batches, RETINA_PATH,
               smi, consume=lambda out: out[1][1].sum(), batch=DET_BATCH,
               desc=desc)

    params = det.prepare_detect_params(host_model, dtype=torch.bfloat16,
                                       device=CARD)
    want = {k: {} for k in all_counters()}
    want["megatail"] = {s: n for s, (_, n) in DET_MEGATAIL_SHAPES.items()}
    want["epilogue"] = {s: n for s, (_, n) in DET_EPILOGUE_SHAPES.items()}
    fwd = lambda xb: det.detect_forward(params, xb, start_level=1,
                                        add_extra_convs="on_input")
    counted(fwd, batches, RETINA_PYRAMID_PATH, want, finite_pyramid, desc)
    got = fwd(x2)
    err = max(rel_err(g, r) for g, r in zip(got, ref["pyr"]))
    print(f"{RETINA_PYRAMID_PATH} (start_level=1, on_input) P3..P7 against "
          f"the module's fp32 CPU pyramid: {err:.4g} (tol "
          f"{DET_TOLS['pyramid']}); shapes "
          f"{[tuple(p.shape[1:3]) for p in got]}")
    if not err <= DET_TOLS["pyramid"]:
        raise AssertionError(f"{RETINA_PYRAMID_PATH}: pyramid error {err}")
    del model, params, batches
    torch.cuda.empty_cache()


def retina_step(model, batch, loss_fn=None):
    """One RetinaNet loss + backward of ``model`` on ``batch`` (tensors on
    its device): (loss terms, head parameter gradients, P3..P7
    gradients)."""
    from mrla_tpu_torch.detect import losses

    loss_fn = loss_fn or losses.retinanet_loss
    model.zero_grad(set_to_none=True)
    pyr = [p.detach().requires_grad_() for p in
           model.neck(model.backbone(batch["image"]))]
    out = loss_fn(tuple(model.bbox_head(p) for p in pyr), batch["gt_boxes"],
                  batch["gt_labels"], batch["gt_valid"], num_classes=80)
    out["loss"].backward()
    grads = {k: p.grad.detach().cpu() for k, p in
             model.bbox_head.named_parameters()}
    return ({k: v.detach().cpu() for k, v in out.items()}, grads,
            [p.grad.detach().cpu() for p in pyr])


def retina_step_errors(got, ref) -> dict:
    if int(got[0]["num_pos"]) != int(ref[0]["num_pos"]):
        return {"loss": math.inf, "grad": math.inf}
    loss = max(abs(got[0][k].item() - ref[0][k].item()) / abs(ref[0][k].item())
               for k in ("loss_cls", "loss_bbox"))
    grad = max([rel_err(got[1][k], ref[1][k]) for k in ref[1]]
               + [rel_err(g, r) for g, r in zip(got[2], ref[2])])
    return {"loss": loss, "grad": grad}


def faulty_loss(kind: str):
    """retinanet_loss with one fault (RETINA_STEP_FAULTS)."""
    import functools

    from mrla_tpu_torch.detect import losses

    if kind == "alpha":
        focal = losses.sigmoid_focal_loss

        def loss(*a, **kw):
            losses.sigmoid_focal_loss = lambda l, t, alpha, gamma: focal(
                l, t, 1.0 - alpha, gamma)
            try:
                return losses.retinanet_loss(*a, **kw)
            finally:
                losses.sigmoid_focal_loss = focal
        return loss
    if kind == "neg_iou":
        return functools.partial(losses.retinanet_loss, neg_iou_thr=0.5)

    def per_image(outs, boxes, labels, valid, **kw):
        parts = [losses.retinanet_loss(
            tuple((c[i:i + 1], r[i:i + 1]) for c, r in outs),
            boxes[i:i + 1], labels[i:i + 1], valid[i:i + 1], **kw)
            for i in range(boxes.shape[0])]
        return {k: sum(p[k] for p in parts) for k in parts[0]}
    return per_image


def check_retina_step() -> None:
    """(b) One full-depth RetinaNet step on the card against the CPU, and
    three loss faults."""
    import copy

    from mrla_tpu_torch.testing import detection_batch, training_retinanet

    t0 = time.perf_counter()
    model = training_retinanet(0, num_classes=80, px=(256, 256))
    batch = detection_batch(5, RETINA_STEP_BATCH, RETINA_STEP_PX, 80,
                            TRAIN_MAX_GT, False)
    ref = retina_step(model, batch)
    print(f"retinanet step: full depth {RETINA_STEP_PX}x{RETINA_STEP_PX} bs"
          f"{RETINA_STEP_BATCH} fp32, CPU step in "
          f"{time.perf_counter() - t0:.1f} s; num_pos "
          f"{int(ref[0]['num_pos'])}, losses "
          f"{ {k: round(v.item(), 6) for k, v in ref[0].items()} }")
    card = copy.deepcopy(model).to(CARD)
    cb = {k: v.to(CARD) for k, v in batch.items()}
    errs = retina_step_errors(retina_step(card, cb), ref)
    print("retinanet step against the CPU: " + ", ".join(
        f"{k} {v:.4g} (tol {RETINA_STEP_TOLS[k]})" for k, v in errs.items()))
    if any(not v <= RETINA_STEP_TOLS[k] for k, v in errs.items()):
        raise AssertionError(f"retinanet step beyond tolerance: {errs}")
    for kind in RETINA_STEP_FAULTS:
        fe = retina_step_errors(retina_step(card, cb, faulty_loss(kind)), ref)
        print(f"retinanet step with the fault {kind}: "
              + ", ".join(f"{k} {v:.4g}" for k, v in fe.items()))
        if not fe["loss"] > RETINA_STEP_TOLS["loss"]:
            raise AssertionError(f"the step check misses the fault {kind}")
    del card
    torch.cuda.empty_cache()


def coco_argv(root: str, preset: str, out: str, extra=()):
    return ["--preset", preset, "--data", "coco",
            "--train-ann", os.path.join(root, "instances_train.json"),
            "--train-imgs", os.path.join(root, "train"),
            "--val-ann", os.path.join(root, "instances_val.json"),
            "--val-imgs", os.path.join(root, "val"),
            "--img-size", *map(str, COCO_HW), "--batch-size",
            str(COCO_BATCH), "--num-classes", "80", "--max-gt",
            str(TRAIN_MAX_GT), "--epochs", "1", "--device", CARD,
            "--output-dir", out, *extra]


def coco_run(root: str, preset: str, out: str, smi: str, extra=()):
    """train_cli.main on the tree for one epoch (8 steps) with the counts
    set to 0 just before and read just after: ms / step over the steps
    after COCO_WARMUP, img/s, the peak memory, the loader's wait, finite
    losses, the RoIAlign launches per step by shape (none for RetinaNet)."""
    from mrla_tpu_torch.detect import train_cli
    from mrla_tpu_torch.kernels import roi_align_patch

    counters = all_counters()
    steps = COCO_TRAIN // COCO_BATCH
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    res = train_cli.main(coco_argv(root, preset, out, extra))
    torch.cuda.synchronize()
    launches, per_step = split_roi_counts(roi_align_patch.counter, steps)
    others = {k: c.launches for k, c in counters.items()
              if k != "roi_align"}
    line = json.loads(open(os.path.join(out, "log.jsonl")).readline())
    timed = steps - COCO_WARMUP
    step_ms = sum(res["step_s"][COCO_WARMUP:]) / timed * 1e3
    wait_ms = sum(res["data_s"][COCO_WARMUP:]) / timed * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = {k: v for k, v in line.items() if k.startswith("loss")}
    desc = (f"coco {preset}{' ' + ' '.join(extra) if extra else ''}, "
            f"{COCO_HW[0]}x{COCO_HW[1]} bs{COCO_BATCH}")
    print(f"training {desc}: {step_ms:.2f} ms/step, "
          f"{COCO_BATCH / step_ms * 1e3:.2f} img/s over {timed} steps after "
          f"{COCO_WARMUP} (the loader's wait {wait_ms:.1f} ms/step beside "
          f"it; every step's {[round(v * 1e3, 1) for v in res['data_s']]} "
          f"ms), peak memory {peak:.2f} GiB, on {smi}; losses {losses}; "
          f"RoIAlign launches per step {per_step['roi_align']} forward, "
          f"{per_step['roi_align_bwd']} backward; mAP {line.get('mAP')}, "
          f"val count {line.get('val_count')}")
    if len(res["loss"]) != steps or not all(
            math.isfinite(v) for v in res["loss"] + list(losses.values())):
        raise AssertionError(f"{desc}: losses {res['loss']}, {losses}")
    want = {}
    if not preset.startswith("retinanet"):
        want = dict(COCO_ROI)
        if preset == MASK_PRESET:
            want.update(COCO_MASK_ROI)
    want_fwd = {s: 1.0 for s in want}
    want_bwd = {("bwd", *s): 1.0 for s in want if s[2] != 28}
    if (per_step["roi_align"] != want_fwd
            or per_step["roi_align_bwd"] != want_bwd or any(others.values())):
        raise AssertionError(f"{desc}: launches per step {per_step}, "
                             f"others {others}; want {want_fwd}, {want_bwd}")
    return res, line


def train_coco(work: str, smi: str) -> None:
    """(c) The trainer on a seeded COCO-format tree: the four runs, then
    --eval-only --resume, --torch and --resume."""
    from mrla_tpu_torch.detect import train_cli
    from mrla_tpu_torch.testing import COCO_CATEGORY_IDS, write_coco_split

    root = os.path.join(work, "coco")
    t0 = time.perf_counter()
    for split, n, seed in (("train", COCO_TRAIN, 0), ("val", COCO_VAL, 1)):
        write_coco_split(root, split, n, COCO_SIZES, COCO_CATEGORY_IDS, seed,
                         extent=(0.3, 0.8))
    print(f"coco tree: {COCO_TRAIN} train, {COCO_VAL} val JPEGs of "
          f"{COCO_SIZES} (h, w), {len(COCO_CATEGORY_IDS)} sparse category "
          f"ids, in {time.perf_counter() - t0:.1f} s")
    run_dir = os.path.join(work, "retina")
    # from the mmdet init (the spread head's logits diverge in training);
    # scored with no threshold, so that its detections reach the mAP
    # that --eval-only and --torch must give again
    evals = ("--score-thr", "0.0")
    res, line = coco_run(root, RETINA_PRESET, run_dir, smi, evals)
    coco_run(root, RETINA_PRESET, os.path.join(work, "retina_bf16"), smi,
             ("--bf16", "--eval-every", "0"))
    coco_run(root, DET_PRESET, os.path.join(work, "faster"), smi,
             ("--eval-every", "0"))
    coco_run(root, MASK_PRESET, os.path.join(work, "mask"), smi,
             ("--remat", "--eval-every", "0"))

    keys = ("mAP", "AP50", "AR@100", "val_count")
    base = coco_argv(root, RETINA_PRESET, os.path.join(work, "eval"),
                     evals)
    trained = res["model"].state_dict()
    ev = train_cli.main(base + ["--eval-only", "--resume", run_dir])
    pth = os.path.join(work, "trained.pth")
    torch.save(trained, pth)
    tv = train_cli.main(base + ["--eval-only", "--torch", pth])
    init = train_cli.build_model(train_cli.parse_args(base),
                                 torch.device(CARD)).state_dict()
    # the weights each evaluated, bit for bit the run's (the mAP of a
    # model trained 8 steps from its init may read 0 either way); the
    # init, which a resume that restored nothing would keep, differs
    differ = lambda sd: [k for k, v in sd.items()
                         if not torch.equal(v, trained[k])]
    differs = {"--resume": differ(ev["model"].state_dict()),
               "--torch": differ(tv["model"].state_dict()),
               "init": differ(init)}
    n_keys = len(trained)
    del res, ev["model"], tv["model"], init, trained
    resumed = train_cli.main(coco_argv(
        root, RETINA_PRESET, run_dir, ("--epochs", "2", "--resume", run_dir,
                                       "--eval-every", "0")))
    lines = [json.loads(s) for s in open(os.path.join(run_dir, "log.jsonl"))]
    print(f"coco eval: the run's {[line[k] for k in keys]}; --eval-only "
          f"--resume {[ev[k] for k in keys]}; --eval-only --torch of the "
          f"trained weights {[tv[k] for k in keys]}; --resume ran epoch "
          f"{lines[-1]['epoch']} ({len(resumed['loss'])} steps, losses "
          f"{[round(v, 4) for v in resumed['loss']]}); state_dict entries "
          f"that differ from the run's: " + ", ".join(
              f"{k} {len(v)} of {n_keys}" for k, v in differs.items()))
    if ev["val_count"] != COCO_VAL or any(
            ev[k] != line[k] or tv[k] != line[k] for k in keys):
        raise AssertionError("coco eval: --eval-only or --torch disagrees "
                             "with the run, or the val count is off")
    if differs["--resume"] or differs["--torch"] or not differs["init"]:
        raise AssertionError(f"coco eval: the weights evaluated are not "
                             f"the run's ({differs['--resume'][:3]}, "
                             f"{differs['--torch'][:3]}), or the run left "
                             f"its init as it was")
    if lines[-1]["epoch"] != 1 or len(resumed["loss"]) != COCO_TRAIN // \
            COCO_BATCH:
        raise AssertionError("--resume did not continue at epoch 1")


def to_host(tree):
    """Tensors of a nest of tuples, lists and dicts, copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def loss_terms(out) -> dict:
    return {k: v.item() for k, v in out.items()
            if k.startswith("loss") and k != "loss"}


def bf16_step_errors(preset: str) -> dict:
    """(d) One --bf16 step (autocast) against the fp32 step on the card, the
    same weights and batch (the faster preset on the fp32 step's sampled
    rois): each loss term relative ("step").  And the bf16 step's loss
    terms against the same loss calls recomputed on the CPU in fp32 from
    the step's own (bf16) head outputs ("loss"), sound and with the fault:
    the focal / softmax loss taking its logits in bf16.  And the step with
    its ground-truth boxes cast to bf16 against the fp32 step
    ("fault_boxes")."""
    import types

    import torch.nn.functional as F

    from mrla_tpu_torch.detect import losses as rl
    from mrla_tpu_torch.detect import two_stage_train as tst
    from mrla_tpu_torch.testing import (
        detection_batch,
        train_uniforms,
        training_detector,
        training_retinanet,
    )

    batch = {k: v.to(CARD) for k, v in detection_batch(
        7, COCO_BATCH, TRAIN_PX, 80, TRAIN_MAX_GT, False).items()}
    retina = preset == RETINA_PRESET
    if retina:
        model = training_retinanet(0, num_classes=80, px=(256, 256))
    else:
        model = training_detector(0, num_classes=80, px=(256, 256))
    model = model.to(CARD)
    rand = None
    if not retina:
        side = [-(-TRAIN_PX // 4)]
        for _ in range(4):
            side.append(-(-side[-1] // 2))
        rand = train_uniforms(3, COCO_BATCH, 3 * sum(h * h for h in side),
                              TRAIN_MAX_GT + model.num_proposals)
    kept = {}

    def run(bf16: bool, record=None, gt_boxes=batch["gt_boxes"]):
        """The step's loss terms; ``record`` gets each loss call (function,
        arguments, keywords)."""
        def hook(name, fn, *args, **kw):
            if name == "R-CNN targets" and "t" in kept:
                return kept["t"]
            out = fn(*args, **kw)
            if name == "R-CNN targets":
                kept["t"] = out
            if record is not None and name in ("RPN targets + loss",
                                               "R-CNN loss"):
                record.append((fn, args, kw))
            return out

        with torch.no_grad(), torch.autocast(CARD, torch.bfloat16,
                                             enabled=bf16):
            if retina:
                args = (model(batch["image"]), gt_boxes,
                        batch["gt_labels"], batch["gt_valid"])
                if record is not None:
                    record.append((rl.retinanet_loss, args,
                                   {"num_classes": 80}))
                out = rl.retinanet_loss(*args, num_classes=80)
            else:
                _, out, _ = tst.faster_rcnn_train_loss(
                    model, batch["image"], gt_boxes,
                    batch["gt_labels"], batch["gt_valid"], rand, stage=hook)
        return loss_terms(out)

    def on_host(record) -> dict:
        terms = {}
        for fn, args, kw in record:
            terms.update(loss_terms(fn(*to_host(args), **kw)))
        return terms

    rel = lambda got, ref: {k: abs(got[k] - ref[k]) / abs(ref[k])
                            for k in ref}
    fp32 = run(False)
    rec = []
    bf16 = run(True, rec)
    focal, tf = rl.sigmoid_focal_loss, tst.F
    # autocast would widen exp, log1p and log_softmax to fp32 again
    plain = lambda: torch.autocast(CARD, enabled=False)

    def focal_bf16(l, t, a=0.25, g=2.0):
        with plain():
            return focal(l.bfloat16(), t.bfloat16(), a, g).float()

    def log_softmax_bf16(x, d):
        with plain():
            return F.log_softmax(x.bfloat16(), d).float()

    rl.sigmoid_focal_loss = focal_bf16
    tst.F = types.SimpleNamespace(**{k: getattr(F, k) for k in dir(F)
                                     if not k.startswith("__")})
    tst.F.log_softmax = log_softmax_bf16
    bad_rec = []
    try:
        bad = run(True, bad_rec)
    finally:
        rl.sigmoid_focal_loss, tst.F = focal, tf
    host, bad_host = on_host(rec), on_host(bad_rec)
    bad_boxes = run(True, gt_boxes=batch["gt_boxes"].bfloat16().float())
    del model, rec, bad_rec
    torch.cuda.empty_cache()
    return {"step": rel(bf16, fp32), "loss": rel(bf16, host),
            "fault_step": rel(bad, fp32), "fault_loss": rel(bad, bad_host),
            "fault_boxes": rel(bad_boxes, fp32),
            "bf16": bf16, "fp32": fp32}


def check_bf16_steps() -> None:
    fmt = lambda d: "{" + ", ".join(f"{k} {v:.3g}" for k, v in d.items()) \
        + "}"
    for preset in (RETINA_PRESET, DET_PRESET):
        e = bf16_step_errors(preset)
        print(f"--bf16 step of {preset} ({TRAIN_PX}x{TRAIN_PX} bs"
              f"{COCO_BATCH}) against the fp32 step on the card: "
              f"{fmt(e['step'])} (tol {BF16_STEP_TOL}; bf16 {e['bf16']}, "
              f"fp32 {e['fp32']}); its loss terms against the same losses "
              f"on the CPU in fp32 from its own head outputs: "
              f"{fmt(e['loss'])} (tol {BF16_LOSS_TOL}); with the logits fed "
              f"to the loss in bf16: step {fmt(e['fault_step'])}, loss "
              f"{fmt(e['fault_loss'])}; with the gt boxes in bf16: step "
              f"{fmt(e['fault_boxes'])}")
        if max(e["step"].values()) > BF16_STEP_TOL:
            raise AssertionError(f"--bf16 {preset}: loss terms {e['step']}")
        if not max(e["fault_boxes"].values()) > BF16_STEP_TOL:
            raise AssertionError(f"the --bf16 step check misses the bf16 "
                                 f"gt boxes on {preset}")
        if max(e["loss"].values()) > BF16_LOSS_TOL:
            raise AssertionError(f"--bf16 {preset}: the loss on the card "
                                 f"{e['loss']}")
        if not max(e["fault_loss"].values()) > BF16_LOSS_TOL:
            raise AssertionError(f"the --bf16 check misses the bf16-loss "
                                 f"fault on {preset}")


def detection_rest(smi: str) -> None:
    """Phase 8e: RetinaNet, the COCO loader and the trainer's options."""
    t0 = time.perf_counter()
    serve_retinanet(smi)
    check_retina_step()
    with tempfile.TemporaryDirectory() as work:
        train_coco(work, smi)
    check_bf16_steps()
    print(f"detection phase 8e: {time.perf_counter() - t0:.1f} s (target "
          f"{RETINA_WALL_S})")


# Phase 8f, data parallelism.  (a) NCCL at world 1: the launch environment
# of one rank set in-process (a free localhost port), and the trainers' ms
# a step in turns with the same runs without a process group.  (b) Two gloo
# ranks sharing the card (parallel/spawn.py; NCCL takes one card a rank):
# one fp32 step at 2 ranks against the same step at world 1 on the global
# batch on the card, read as phase 8b's classification step and phase 8's
# in-situ step are (CLS_STEP_TOLS, DP_DET_TOLS: the loss terms relative,
# each parameter's gradient relative to its norm, floored at 1e-3 of the
# whole gradient's), while per-replica BN and per-rank normalisers, the
# injected faults, must each fail; after each sound step the two ranks'
# weights bitwise equal.
DP_PATH = "faster_rcnn_r50mrlal training, DDP"
DP_CLS_BATCH, DP_DET_BATCH, DP_WORLD = 16, 4, 2
DP_DET_TOLS = {"loss": 1e-3, "grad": 0.02}
DP_GRAD_FLOOR = 1e-3
DP_CLS_FAULT, DP_DET_FAULT = "replica_bn", "replica_norm"
DP_WALL_S = 120.0  # the phase's target wall time, printed beside it


class launch_env:
    """The launch environment of rank 0 of a world of 1 (a free localhost
    port), set on entry and taken away on exit."""

    def __enter__(self):
        import socket

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        self.env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                        RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k in self.env:
            os.environ.pop(k, None)


def dp_world1(smi: str) -> dict:
    """(a): the ResNet recipe of 8b(b) and the faster preset's trainer with
    --dp 1 (800 x 800, bs8, 2 + 8 steps), each with and without NCCL at
    world 1, in turns; returns the RoIAlign launches of a DDP run."""
    from mrla_tpu_torch.parallel import initialized

    ms = {}
    for ddp in (False, True, True, False):
        with launch_env() if ddp else contextlib.nullcontext():
            ms.setdefault(("cls", ddp), []).append(
                cls_recipe("resnet", smi)["ms"])
        if initialized():
            raise AssertionError("the trainer left its process group")
    launches = None
    for ddp in (True, False):
        with launch_env() if ddp else contextlib.nullcontext():
            got, _, step = train_path(DET_PRESET, smi, ("--dp", "1"))
        ms.setdefault(("det", ddp), []).append(step)
        if ddp:
            launches = got
    for (kind, ddp), v in ms.items():
        print(f"data parallelism (a), {kind} trainer "
              f"{'DDP on NCCL at world 1' if ddp else 'no process group'}: "
              f"ms/step {[round(t, 2) for t in v]} on {smi}")
    return launches


def _split_state(sd: dict):
    """(parameters, running statistics) of a classifier's state_dict."""
    return ({k: v for k, v in sd.items() if "running" not in k
             and not k.endswith("num_batches_tracked")},
            {k: v for k, v in sd.items() if "running" in k})


def _grad_error(got: dict, ref: dict) -> float:
    whole = torch.cat([w.flatten() for w in ref.values()]).norm()
    return max(((got[k] - w).norm() / max(w.norm(), DP_GRAD_FLOOR * whole))
               .item() for k, w in ref.items())


def dp_two_ranks(smi: str) -> None:
    """(b): two gloo ranks sharing the card against world 1 on the card."""
    from mrla_tpu_torch.parallel import checks
    from mrla_tpu_torch.parallel.spawn import start_ranks
    from mrla_tpu_torch.testing import (
        detection_batch,
        images,
        serving_model,
        train_uniforms,
        training_detector,
    )

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(5)
    model = serving_model(0)
    cls = {"model": {"layers": list(model.layers), "num_classes": 1000},
           "state_dict": model.state_dict(),
           "batch": {"image": images(gen, DP_CLS_BATCH, CLS_PX),
                     "label": torch.randint(0, 1000, (DP_CLS_BATCH,),
                                            generator=gen)},
           "lr": CLS_LR, "momentum": 0.9, "weight_decay": 1e-4,
           "label_smooth": 0.1}
    det_model = training_detector(0, num_classes=80, px=(256, 256))
    side = [-(-TRAIN_PX // 4)]
    for _ in range(4):
        side.append(-(-side[-1] // 2))
    det = {"kind": "faster", "model": {"layers": (3, 4, 6, 3),
                                       "num_classes": 80},
           "state_dict": det_model.state_dict(), "lr": 0.01,
           "batch": detection_batch(2, DP_DET_BATCH, TRAIN_PX, 80,
                                    TRAIN_MAX_GT, False),
           "uniforms": train_uniforms(3, DP_DET_BATCH, 3 * sum(
               h * h for h in side), TRAIN_MAX_GT + det_model.num_proposals)}
    print(f"data parallelism (b): seeded models in "
          f"{time.perf_counter() - t0:.1f} s")
    card = torch.device(CARD)
    shared = f"{card.type}:0" if card.type == "cuda" else card.type
    with tempfile.TemporaryDirectory() as w_cls, \
            tempfile.TemporaryDirectory() as w_det:
        ranks_cls = start_ranks(checks.variants, DP_WORLD, w_cls, args=(
            checks.classification_step, cls,
            ("global", DP_CLS_FAULT, "fused"), shared), timeout=600)
        ranks_det = start_ranks(checks.variants, DP_WORLD, w_det, args=(
            checks.detection_step, det, ("global", DP_DET_FAULT), shared),
            timeout=600)
        ref = {v: checks.classification_step(cls, v, CARD)
               for v in ("global", "fused")}
        ref_det = checks.detection_step(det, "global", CARD)
        got_cls, got_det = ranks_cls.join(), ranks_det.join()
    init = _split_state(cls["state_dict"])
    as_step = lambda r: (r["loss"], *_split_state(r["state"]))
    readings = {
        "classification 2 ranks": (as_step(got_cls[0]["global"]),
                                   as_step(ref["global"])),
        f"classification {DP_CLS_FAULT} (fault)": (
            as_step(got_cls[0][DP_CLS_FAULT]), as_step(ref["global"])),
        "classification fused epilogue 2 ranks": (
            as_step(got_cls[0]["fused"]), as_step(ref["fused"])),
    }
    for name, (got, want) in readings.items():
        e = cls_step_errors(got, want, init)
        print(f"data parallelism (b), {name} against world 1 on the card: "
              + ", ".join(f"{k} {v:.4g} (tol {CLS_STEP_TOLS[k]})"
                          for k, v in e.items()))
        within = all(v <= CLS_STEP_TOLS[k] for k, v in e.items())
        if within == name.endswith("(fault)"):
            raise AssertionError(f"data parallelism (b), {name}: {e}")
    terms = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox")
    for v in ("global", DP_DET_FAULT):
        got = got_det[0][v]
        e = {"loss": max(abs(got["terms"][k] - ref_det["terms"][k])
                         / abs(ref_det["terms"][k]) for k in terms),
             "grad": _grad_error(got["grads"], ref_det["grads"])}
        print(f"data parallelism (b), faster {v} 2 ranks against world 1 "
              f"on the card: " + ", ".join(
                  f"{k} {x:.4g} (tol {DP_DET_TOLS[k]})" for k, x in e.items())
              + f"; RoIAlign launches by rank "
              f"{[r[v]['launches'] for r in got_det]}")
        within = all(x <= DP_DET_TOLS[k] for k, x in e.items())
        if within == (v == DP_DET_FAULT):
            raise AssertionError(f"data parallelism (b), faster {v}: {e}")
    want = {(DP_DET_BATCH // DP_WORLD, 512, 7, 256): 1,
            ("bwd", DP_DET_BATCH // DP_WORLD, 512, 7, 256): 1}
    if any(r["global"]["launches"] != want for r in got_det):
        raise AssertionError(f"RoIAlign launches by rank "
                             f"{[r['global']['launches'] for r in got_det]}"
                             f", want {want} in each")
    same = {"classification": [got_cls[1][v]["same"]
                               for v in ("global", "fused")],
            "faster": [got_det[1][v]["same"]
                       for v in ("global", DP_DET_FAULT)]}
    print(f"data parallelism (b): rank 1's weights bitwise rank 0's after "
          f"each step {same}; {time.perf_counter() - t0:.1f} s")
    if not all(all(v) for v in same.values()):
        raise AssertionError(f"the ranks' weights differ: {same}")


def data_parallelism(smi: str) -> dict:
    """Phase 8f; returns the RoIAlign launches of the DDP training run."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    launches = dp_world1(smi)
    torch.cuda.empty_cache()
    dp_two_ranks(smi)
    print(f"data parallelism phase 8f: {time.perf_counter() - t0:.1f} s "
          f"(target {DP_WALL_S})")
    return launches


# Phase 8g, model and pipeline parallelism.  (a) Sharded serving: NCCL at
# world 1 (a one-rank mesh, bitwise the engine), then two gloo ranks sharing
# the card, each its 64 rows (parallel/checks.py: sharded_serving), held to
# the single-card engine on the whole batch.  (b) TP on a data 1 x model 2
# mesh and (c) the GPipe schedule on a pipe 2 mesh, each one fp32 step
# against world 1 on the card, with an injected fault that must fail.  (d)
# dryrun_multichip(4) over gloo on the card.
MP_WORLD, MP_ROWS = 2, BATCH // 2
MP_PATHS = {"resnet": "resnet50_mrlal sharded serving, 2 ranks",
            "deit": "deit_mrlal_small sharded serving, 2 ranks"}
MP_REQUESTS, MP_TIMED = 4, 10
MP_TP_BATCH, MP_PIPE_BATCH, MP_PIPE_MICRO, MP_PIPE_LR = 8, 32, 4, 0.01
MP_TP_FAULT, MP_PIPE_FAULT = "tp_sum_grad", "pipe_sum_out"
# the pipelined forward's largest |Δlogit| over the module's largest
# |logit| (fp32, TF32 off: only the microbatches' reduction order differs)
MP_PIPE_FWD_TOL = 1e-4
MP_WALL_S = 180.0  # the phase's target wall time, printed beside it


def _rows_table(shapes: dict, requests: int) -> dict:
    """A main path's launches per forward by shape at 128 rows -> the
    launches of ``requests`` forwards at MP_ROWS rows."""
    return {(MP_ROWS,) + s[1:]: n * requests for s, (_, n) in shapes.items()}


def _timed_s(forward, x, n: int) -> float:
    with torch.no_grad():
        forward(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            forward(x)
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def mp_serving(smi: str, model, deit) -> tuple:
    """(a); returns (launches by path and kernel, the same by shape)."""
    import torch.distributed as dist

    from mrla_tpu_torch.parallel import checks, init_distributed, make_mesh
    from mrla_tpu_torch.parallel.spawn import run_ranks
    from mrla_tpu_torch.serving import (
        deit_forward,
        make_sharded_forward,
        prepare_deit_inference_params,
        prepare_inference_params,
        resnet_mrlal_forward,
    )
    from mrla_tpu_torch.testing import images

    x = images(torch.Generator().manual_seed(7), BATCH, PX)
    xc = x.cuda()
    params = prepare_inference_params(model, device="cuda",
                                      dtype=torch.bfloat16)
    deit_params = prepare_deit_inference_params(deit, device="cuda",
                                                 dtype=torch.bfloat16)
    with launch_env():
        init_distributed(device="cuda")
        try:
            backend = dist.get_backend()
            with torch.no_grad():
                got = make_sharded_forward(make_mesh(("data",), (1,)))(
                    params, xc)
                want = resnet_mrlal_forward(params, xc)
        finally:
            dist.destroy_process_group()
    print(f"model parallelism (a), make_sharded_forward over a one-rank "
          f"mesh ({backend} at world 1): bitwise the engine "
          f"{torch.equal(got, want)}")
    if not torch.equal(got, want):
        raise AssertionError("a one-rank sharded forward differs from the "
                             "engine")
    engines = {"resnet": lambda xb: resnet_mrlal_forward(params, xb),
               "deit": lambda xb: deit_forward(deit_params, xb)}
    with torch.no_grad():
        full = {k: f(xc).float().cpu() for k, f in engines.items()}
    single = {k: BATCH * MP_TIMED / _timed_s(f, xc, MP_TIMED)
              for k, f in engines.items()}
    del params, deit_params
    torch.cuda.empty_cache()
    spec = {"cases": {
        "resnet": ("resnet_mrlal", ((3, 4, 6, 3), model.state_dict()), {},
                   x),
        "deit": ("deit", (DEIT_ARCH, deit.state_dict()), {}, x)},
        "dtype": torch.bfloat16, "requests": MP_REQUESTS,
        "timed": MP_TIMED}
    with tempfile.TemporaryDirectory() as work:
        ranks = run_ranks(checks.sharded_serving, MP_WORLD, work,
                          args=(spec, "cuda:0"), timeout=600)
    want = {"resnet": {"epilogue": _rows_table(EPILOGUE_SHAPES, MP_REQUESTS),
                       "megatail": _rows_table(MEGATAIL_SHAPES,
                                               MP_REQUESTS)},
            "deit": {"deit_tail": _rows_table(DEIT_TAIL_SHAPES,
                                              MP_REQUESTS)}}
    tol = {"resnet": LOGIT_ERROR_TOL, "deit": DEIT_LOGIT_ERROR_TOL}
    launches, by_shape = {}, {}
    for case, path in MP_PATHS.items():
        wall = max(r[case]["s"] for r in ranks)
        for r, res in enumerate(ranks):
            got = res[case]
            rows = slice(r * MP_ROWS, (r + 1) * MP_ROWS)
            err = logit_error(got["out"].float(), full[case][rows])
            print(f"model parallelism (a), {path}, rank {r}: logit error "
                  f"against the single-card engine {err:.4g} (tol "
                  f"{tol[case]}); launches by shape {got['launches']} "
                  f"(want {want[case]}); "
                  f"{MP_ROWS * MP_TIMED / got['s']:.1f} img/s on {smi}")
            if not err <= tol[case]:
                raise AssertionError(f"{path} rank {r}: logit error {err}")
            if got["launches"] != want[case]:
                raise AssertionError(f"{path} rank {r}: launches "
                                     f"{got['launches']} != {want[case]}")
        print(f"model parallelism (a), {path}: "
              f"{BATCH * MP_TIMED / wall:.1f} img/s by both ranks together "
              f"(the global batch over the slower rank's time; the timed "
              f"runs start together), the single-card engine "
              f"{single[case]:.1f} img/s on the whole batch, on {smi}")
        launches[path] = {k: sum(sum(r[case]["launches"].get(k, {}).values())
                                 for r in ranks) for k in all_counters()}
        by_shape[path] = {k: {str(list(sh)): sum(
            r[case]["launches"].get(k, {}).get(sh, 0) for r in ranks)
            for sh in want[case][k]} for k in want[case]}
    return launches, by_shape


def _stepped_state(ranks: list, job: int) -> dict:
    """The whole DeiT weights after a pipelined step: the pipe ranks' spans
    in order and rank 0's rest."""
    from mrla_tpu_torch.parallel import unstack_block_params

    spans = [r[job]["span"] for r in ranks]
    return unstack_block_params(
        {k: torch.cat([s[k] for s in spans]) for k in spans[0]},
        ranks[0][job]["rest"])


def mp_training(smi: str, model, deit) -> None:
    """(b) and (c): world-1 references on the card, then both ranks'
    jobs in one launch."""
    from mrla_tpu_torch.parallel import checks
    from mrla_tpu_torch.parallel.spawn import run_ranks
    from mrla_tpu_torch.testing import images

    gen = torch.Generator().manual_seed(5)
    cls = {"model": {"layers": [3, 4, 6, 3], "num_classes": 1000},
           "state_dict": model.state_dict(),
           "batch": {"image": images(gen, MP_TP_BATCH, CLS_PX),
                     "label": torch.randint(0, 1000, (MP_TP_BATCH,),
                                            generator=gen)},
           "lr": CLS_LR, "momentum": 0.9, "weight_decay": 1e-4,
           "label_smooth": 0.1}
    pipe = {"model": ("light", {"embed_dim": 384, "depth": 12,
                                "num_heads": 6}),
            "state_dict": deit.state_dict(),
            "x": images(gen, MP_PIPE_BATCH, PX),
            "labels": torch.randint(0, 1000, (MP_PIPE_BATCH,),
                                    generator=gen),
            "microbatches": MP_PIPE_MICRO, "lr": MP_PIPE_LR, "step": True}
    ref_tp = checks.classification_step(cls, "global", CARD)
    ref_pipe = checks.pipeline_step(pipe, "global", CARD)
    tp = dict(cls, mesh=(1, MP_WORLD))
    pp = dict(pipe, mesh=(("pipe",), (MP_WORLD,)))
    jobs = [(checks.classification_step, tp, "global"),
            (checks.classification_step, tp, MP_TP_FAULT),
            (checks.pipeline_step, pp, "global"),
            (checks.pipeline_step, pp, MP_PIPE_FAULT)]
    torch.cuda.empty_cache()
    card = torch.device(CARD)
    shared = f"{card.type}:0" if card.type == "cuda" else card.type
    with tempfile.TemporaryDirectory() as work:
        ranks = run_ranks(checks.calls, MP_WORLD, work,
                          args=(jobs, shared), timeout=900)
    init = _split_state(cls["state_dict"])
    as_step = lambda r: (r["loss"], *_split_state(r["state"]))  # noqa
    for i, name in ((0, "tp"), (1, f"tp {MP_TP_FAULT} (fault)")):
        e = cls_step_errors(as_step(ranks[0][i]), as_step(ref_tp), init)
        print(f"model parallelism (b), {name} data 1 x model 2 against "
              "world 1 on the card: " + ", ".join(
                  f"{k} {v:.4g} (tol {CLS_STEP_TOLS[k]})"
                  for k, v in e.items()))
        within = all(v <= CLS_STEP_TOLS[k] for k, v in e.items())
        if within == name.endswith("(fault)"):
            raise AssertionError(f"model parallelism (b), {name}: {e}")
    for r, res in enumerate(ranks):
        print(f"model parallelism (b), rank {r}: parameter + momentum "
              f"bytes {res[0]['bytes']} against the replicated model's "
              f"{ref_tp['bytes']} ({res[0]['bytes'] / ref_tp['bytes']:.3f});"
              f" {len(res[0]['sharded'])} leaves sharded")
    if not all(r[0]["same"] for r in ranks):
        raise AssertionError("the TP step's data replicas differ")
    want = ref_pipe["logits"]
    for r, res in enumerate(ranks):
        fwd = ((res[2]["logits"] - want).abs().max()
               / want.abs().max()).item()
        print(f"model parallelism (c), rank {r}: the pipelined forward's "
              f"largest |dlogit| over the module's largest |logit| "
              f"{fwd:.3g} (tol {MP_PIPE_FWD_TOL})")
        if not fwd <= MP_PIPE_FWD_TOL:
            raise AssertionError(f"pipelined forward on rank {r}: {fwd}")
    init = {k: v for k, v in pipe["state_dict"].items()}
    for job, name in ((2, "pipe 2"), (3, f"pipe 2 {MP_PIPE_FAULT} (fault)")):
        got = (ranks[0][job]["loss"], _stepped_state(ranks, job), {})
        e = cls_step_errors(got, (ref_pipe["loss"], ref_pipe["state"], {}),
                            (init, {}))
        e.pop("stat")
        print(f"model parallelism (c), {name} against the module's step on "
              f"the card: " + ", ".join(f"{k} {v:.4g} (tol "
                                        f"{CLS_STEP_TOLS[k]})"
                                        for k, v in e.items()))
        within = all(v <= CLS_STEP_TOLS[k] for k, v in e.items())
        if within == name.endswith("(fault)"):
            raise AssertionError(f"model parallelism (c), {name}: {e}")
    ms = [round(r[2]["ms"], 2) for r in ranks]
    print(f"model parallelism (c): ms a step {ms} by rank (pipe 2, "
          f"{MP_PIPE_MICRO} microbatches of "
          f"{MP_PIPE_BATCH // MP_PIPE_MICRO}) against {ref_pipe['ms']:.2f} at "
          f"world 1, fp32, on {smi}")


def model_parallelism(smi: str) -> tuple:
    """Phase 8g; returns the sharded-serving launches (by path and kernel,
    and by shape)."""
    from mrla_tpu_torch import dryrun_multichip
    from mrla_tpu_torch.testing import deit_serving_model, serving_model

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    model, deit = serving_model(0), deit_serving_model(DEIT_ARCH, 0)
    print(f"model parallelism: seeded models in "
          f"{time.perf_counter() - t0:.1f} s")
    launches = mp_serving(smi, model, deit)
    torch.cuda.empty_cache()
    mp_training(smi, model, deit)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ran = dryrun_multichip(4, backend="gloo")
    print(f"model parallelism (d): dryrun_multichip(4) over gloo on the "
          f"card, tp {ran['tp']}, {len(ran['lines'])} steps in "
          f"{time.perf_counter() - t1:.1f} s")
    print(f"model parallelism phase 8g: {time.perf_counter() - t0:.1f} s "
          f"(target {MP_WALL_S})")
    return launches


# Phase 8h: the serving surface (serving/server.py, serving/quant.py,
# serving/cli.py, hub.py, utils/).  (a) the batching daemon on
# resnet50_mrlal (224 px, batch 128, bf16) under SURF_REQUESTS single-image
# requests from SURF_CLIENTS threads, one JSON request of 3 images and one
# ?topk=5, every response held to the engine's own forward of the image;
# the responders given the batch's rows shifted by one (the injected fault)
# must fail that; (b) the int8 engine (chains of 64: row 1 at the four
# QUANT_EPILOGUE_SHAPES), both forms, against the fp32 fake-quant
# reference on the card within QUANT_LOGIT_TOL of the logit scale, two
# injected faults failing it, top-1 against the bf16 engine; (c) the
# detections daemons (RetinaNet, faster, mask with ?masks=1) and the
# pyramid daemon at 800 x 1344, batch 8, one batch each, against the
# direct calls; (d) the eval CLI on phase 8d's JPEG tree; (e) hub.load,
# profile_model and the log tools.
SURF_PATHS = {
    "daemon": "serving daemon resnet50_mrlal",
    "int8": "int8 engine resnet50_mrlal",
    "int8-fast": "int8-fast engine resnet50_mrlal",
    "retinanet": "detections daemon retinanet_r50mrlal",
    "faster": "detections daemon faster_rcnn_r50mrlal",
    "mask": "detections daemon mask_rcnn_r50mrlal",
    "pyramid": "pyramid daemon faster_rcnn_r50mrlal",
}
SURF_CLIENTS, SURF_REQUESTS, SURF_FAULT_REQUESTS = 16, 256, 32
# row 1's launches per int8 forward at bs128 in chains of 64, by shape
QUANT_EPILOGUE_SHAPES = {
    **QUANT_NEW_SHAPES,
    (QUANT_MICROBATCH, 14, 14, 1024): ("int8 stage3", 12),
    (QUANT_MICROBATCH, 7, 7, 2048): ("int8 stage4", 6),
}
# the int8 logits against the fp32 fake-quant reference, max |Δ| over the
# reference's max |logit| (tests/test_serving_quant.py's bar)
QUANT_LOGIT_TOL = 0.02
QUANT_FAULTS = ("scale", "requant")
# the eval CLI's runs: arch, extra argv, the engine JAX's _pick_engine names
CLI_RUNS = [("resnet50_mrlal", [], "mrlal"),
            ("resnet50_mrlab", [], "mrlab"),
            ("resnet50_se", [], "precast"),
            ("resnet50_la_eq4", [], "precast"),
            (DEIT_ARCH, [], "precast"),
            ("resnet50_mrlal", ["--quant", "int8"], "mrlal")]
CLI_LIMIT, CLI_CLASSES = 256, 10
SURF_WALL_S = 150.0  # the phase's target wall time, printed beside it
SEEDED: dict = {}  # seeded CPU models shared between phases


def seeded(name: str, build):
    """A seeded CPU model built once (``build()``) and shared."""
    if name not in SEEDED:
        SEEDED[name] = build()
    return SEEDED[name]


def _npy(a) -> bytes:
    import io

    import numpy as np

    buf = io.BytesIO()
    np.save(buf, np.asarray(a))
    return buf.getvalue()


def _post(url: str, body: bytes, ctype: str = "application/x-npy",
          timeout: float = 300.0) -> bytes:
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


@contextlib.contextmanager
def running(httpd, beng):
    """Serve in a thread; shut the daemon and its engine down after."""
    import threading

    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        beng.close()
        thread.join(timeout=10)


def warm(beng, shape) -> None:
    from mrla_tpu_torch.serving.server import _to_host

    with torch.inference_mode():
        _to_host(beng.fwd(torch.zeros(shape, dtype=beng.input_dtype,
                                      device=beng.device)))


def client_traffic(base: str, x, clients: int):
    """len(x) single-image npy requests from ``clients`` threads; returns
    (logits [n, C] fp32, each request's seconds, the wall seconds)."""
    import threading

    import numpy as np

    n = len(x)
    out, lat, errors = [None] * n, [0.0] * n, []

    def client(k):
        try:
            for i in range(k, n, clients):
                t = time.perf_counter()
                body = _post(base + "/predict", _npy(x[i]))
                lat[i] = time.perf_counter() - t
                out[i] = json.loads(body)["predictions"][0]
        except Exception as e:  # raised below, in the phase
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return torch.tensor(np.asarray(out, np.float32)), lat, wall


def engine_rows(fwd, x, batch: int) -> torch.Tensor:
    """The engine's forward of every image of ``x`` (host fp32), in
    batches padded with their first row, as the daemon pads."""
    outs = []
    with torch.inference_mode():
        for i in range(0, len(x), batch):
            part = x[i:i + batch]
            xb = torch.cat([part, part[:1].expand(batch - len(part),
                                                  *part.shape[1:])])
            outs.append(fwd(xb.to("cuda", torch.bfloat16)).float().cpu()
                        [:len(part)])
    return torch.cat(outs)


def surf_daemon(smi: str, model) -> tuple:
    """(a); returns (launches by kernel, launches by shape)."""
    import numpy as np

    import mrla_tpu_torch.serving.server as server
    from mrla_tpu_torch.testing import images

    httpd, beng = server.build_server("resnet50_mrlal", None,
                                      batch_size=BATCH, image_size=PX,
                                      port=0, device="cuda", model=model)
    x = images(torch.Generator().manual_seed(21), SURF_REQUESTS + 4, PX)
    xn = x.numpy()
    counters = all_counters()
    with running(httpd, beng) as base:
        warm(beng, (BATCH, PX, PX, 3))
        for c in counters.values():
            c.reset()
        got, lat, wall = client_traffic(base, xn[:SURF_REQUESTS],
                                        SURF_CLIENTS)
        body = json.dumps({"instances": xn[SURF_REQUESTS:SURF_REQUESTS + 3]
                           .tolist()}).encode()
        got_json = torch.tensor(json.loads(_post(
            base + "/predict", body, "application/json"))["predictions"])
        topk = json.loads(_post(base + "/predict?topk=5",
                                _npy(xn[-1:])))["topk"][0]
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        by_shape = {k: dict(c.by_shape) for k, c in counters.items()}
        stats = json.loads(_urlread(base + "/stats"))
        ref = engine_rows(beng.fwd, x, BATCH)
        # the injected fault: the responders given the rows shifted by one
        real = server._to_host
        server._to_host = lambda out: np.roll(real(out), 1, axis=0)
        try:
            bad, _, _ = client_traffic(base, xn[:SURF_FAULT_REQUESTS],
                                       SURF_CLIENTS)
        finally:
            server._to_host = real
    n_req = SURF_REQUESTS + 3 + 1
    batches = stats["batches"]
    print(f"serving surface (a), daemon resnet50_mrlal {PX}px bs{BATCH} "
          f"bf16, {SURF_CLIENTS} clients: {SURF_REQUESTS} requests in "
          f"{wall:.3f} s = {SURF_REQUESTS / wall:.1f} requests/s, latency "
          f"p50 {np.percentile(lat, 50) * 1e3:.2f} ms p99 "
          f"{np.percentile(lat, 99) * 1e3:.2f} ms; /stats {stats}: padded "
          f"share {stats['padded_rows'] / (batches * BATCH):.4f}; launches "
          f"{launches}, on {smi}")
    if stats["requests"] != n_req or (
            stats["padded_rows"] != batches * BATCH - n_req):
        raise AssertionError(f"daemon /stats {stats}: {n_req} requests sent")
    want = {k: {} for k in counters}
    want["megatail"] = {s: n * batches for s, (_, n) in
                        MEGATAIL_SHAPES.items()}
    want["epilogue"] = {s: n * batches for s, (_, n) in
                        EPILOGUE_SHAPES.items()}
    if by_shape != want:
        raise AssertionError(f"daemon launches by shape {by_shape} != "
                             f"{want} ({batches} batches)")
    rows = torch.cat([got, got_json])
    want_rows = ref[:SURF_REQUESTS + 3]
    same = torch.equal(rows, want_rows)
    err = logit_error(rows, want_rows)
    bad_err = logit_error(bad, ref[:SURF_FAULT_REQUESTS])
    top = ref[-1].topk(5).indices.tolist()
    print(f"serving surface (a): every response against the engine's own "
          f"forward of its image (batched {BATCH} with row-0 padding): "
          f"{'bitwise' if same else 'not bitwise'}; logit error {err:.4g} "
          f"(tol {LOGIT_ERROR_TOL}); the JSON request's 3 rows included; "
          f"?topk=5 {topk['classes']} against {top}; injected fault "
          f"(rows shifted by one) logit error {bad_err:.4g}")
    if not err <= LOGIT_ERROR_TOL:
        raise AssertionError(f"daemon responses: logit error {err}")
    if topk["classes"][0] != top[0] or len(topk["classes"]) != 5:
        raise AssertionError(f"daemon ?topk=5 {topk} against {top}")
    if bad_err <= LOGIT_ERROR_TOL:
        raise AssertionError("the row-shift fault passed the daemon check")
    return launches, {k: {str(list(s)): n for s, n in v.items()}
                      for k, v in by_shape.items() if v}


def _urlread(url: str) -> bytes:
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read()


def _fq(v, inv):
    """Quantise to the int8 grid, kept in fp32."""
    return (v.float() * inv).round().clamp(-127.0, 127.0)


def _fq_conv(t, kq, sw, b, stride=1):
    """fp32 conv of ``t`` with the int8 kernel dequantised (kq · sw),
    laid out back to OIHW."""
    from mrla_tpu_torch.ops.common import conv2d_nhwc

    co, kk = kq.shape
    cin = t.shape[-1]
    k = math.isqrt(kk // cin)
    w = (kq.float() * sw[:, None]).reshape(co, k, k, cin)
    return conv2d_nhwc(t, w.permute(0, 3, 1, 2).contiguous(), b,
                       stride=stride)


def kernel_scales(model) -> list:
    """Each block's per-output-channel kernel scales sw = absmax / 127 of
    its BN-folded bf16 kernels (``prepare_inference_params``), taken apart
    from the int8 tree so that the reference does not read its m."""
    from mrla_tpu_torch.serving import prepare_inference_params

    sp = prepare_inference_params(model, device="cuda")
    return [{ci: p[f"k{ci}"].float().abs().amax(dim=(1, 2, 3))
             .clamp_min(1e-12) / 127.0 for ci in "123d" if f"k{ci}" in p}
            for p in sp["blocks"]]


def fake_quant_block(p: dict, sw: dict, yin: torch.Tensor, stride: int,
                     quant_residual: bool, last: bool) -> torch.Tensor:
    """One block of the fp32 fake-quant reference
    (tests/test_serving_quant.py:_fake_quant_reference's construction, in
    both residual forms) on the block's input as the engine carries it:
    int8 values under ``quant_residual`` (returns the next block's int8
    values, or fp32 y after the last block), else the bf16 stream (returns
    bf16 y).  fp32 convolutions on the dequantised int8 tensors and
    kernels (kq · sw, ``kernel_scales``: the tree's dequantisation
    multipliers m are not read), the plain epilogue."""
    from mrla_tpu_torch.kernels import mrla_light_epilogue_reference

    heads = p["lam"].shape[0] // 32
    a_in, a1, a2 = p["a_in"], 1.0 / p["inv_a1"], 1.0 / p["inv_a2"]
    xin = (yin.float() * a_in if quant_residual
           else _fq(yin, 1.0 / a_in) * a_in)
    out1 = _fq_conv(xin, p["k1q"], sw["1"], p["b1"]).relu()
    out2 = _fq_conv(_fq(out1, p["inv_a1"]) * a1, p["k2q"], sw["2"],
                    p["b2"], stride).relu()
    z = _fq_conv(_fq(out2, p["inv_a2"]) * a2, p["k3q"], sw["3"], p["b3"])
    if "kdq" in p:
        identity = _fq_conv(xin, p["kdq"], sw["d"], p["bd"], stride)
    else:
        identity = xin if quant_residual else yin.float()
    idb = identity.to(torch.bfloat16)
    out = ((z + identity).relu().to(torch.bfloat16) if quant_residual
           else (z.to(torch.bfloat16) + idb).relu())
    y = mrla_light_epilogue_reference(
        out.contiguous(), idb.contiguous(), p["wq"], p["wk"], p["wv"],
        p["lam"], p["bn_scale"], p["bn_bias"], heads)
    if not quant_residual:
        return y.to(torch.bfloat16)
    return y.float() if last else _fq(y, p["inv_ay"])


def fake_quant_reference(qp: dict, sws: list, x: torch.Tensor,
                         quant_residual: bool,
                         layers=(3, 4, 6, 3)) -> torch.Tensor:
    """The fake-quant reference end to end (fp32 stem, each block on the
    reference's own previous output): logits fp32."""
    import mrla_tpu_torch.serving.quant as q

    strides, _ = q._strides_for(layers)
    with torch.inference_mode():
        stem = {k: v.float() for k, v in qp["stem"].items()}
        y = q._stem(x.float(), stem)
        y = _fq(y, qp["inv_a_stem"]) if quant_residual else y
        blocks = qp["blocks"]
        for i, (p, sw, stride) in enumerate(zip(blocks, sws, strides)):
            y = fake_quant_block(p, sw, y, stride, quant_residual,
                                 i == len(blocks) - 1)
        return q._head(qp, y)


def quant_blockwise(qp: dict, sws: list, x: torch.Tensor,
                    quant_residual: bool, layers=(3, 4, 6, 3)) -> list:
    """The int8 engine's blocks (the module's own functions, so a patched
    block is the one checked) against ``fake_quant_block`` fed the same
    input, the engine's own: each block's max |Δ| over the reference's max
    |out|, then the logits' (the head on both final maps).  Fed the
    engine's input, a block's knife-edge flips (a value on a rounding
    boundary landing one step apart) do not compound over the blocks."""
    import mrla_tpu_torch.serving.quant as q

    strides, _ = q._strides_for(layers)
    errs = []
    rel = lambda got, ref: ((got.float() - ref.float()).abs().max()
                            / ref.float().abs().max()).item()
    with torch.inference_mode():
        y = q._stem(x.to(qp["stem"]["k"].dtype), qp["stem"])
        yin = q._quant(y, qp["inv_a_stem"]) if quant_residual else y
        blocks = qp["blocks"]
        for i, (p, sw, stride) in enumerate(zip(blocks, sws, strides)):
            heads, last = p["lam"].shape[0] // 32, i == len(blocks) - 1
            got = (q._qblock(yin, p, stride, heads, last, False)
                   if quant_residual else
                   q._qblock_bf16res(yin, p, stride, heads))
            ref = fake_quant_block(p, sw, yin, stride, quant_residual, last)
            errs.append(rel(got, ref))
            yin = got
        errs.append(rel(q._head(qp, got), q._head(qp, ref)))
    return errs


def faulty_blockwise(qp: dict, sws: list, x: torch.Tensor,
                     kind: str) -> list:
    """``quant_blockwise`` of the int8 engine (the default form) with one
    injected fault: ``scale``, block 0's conv2 dequantised with inv_a1 in
    place of a1; ``requant``, every block's conv3 input requantised from
    out2 before its ReLU."""
    import mrla_tpu_torch.serving.quant as q

    if kind == "scale":
        b0 = dict(qp["blocks"][0])
        b0["m2"] = b0["m2"] * b0["inv_a1"] ** 2  # (a1 · sw) -> inv_a1 · sw
        return quant_blockwise({**qp, "blocks": [b0] + qp["blocks"][1:]},
                               sws, x, False)
    qconv = q._qconv

    def block(y, p, stride, heads):  # the engine's block, one line moved
        yq = q._quant(y, 1.0 / p["a_in"])
        out1 = qconv(yq, p["k1q"], p["m1"], p["b1"]).relu_()
        q1 = q._quant(out1, p["inv_a1"])
        pre2 = qconv(q1, p["k2q"], p["m2"], p["b2"], stride=stride)
        q2 = q._quant(pre2, p["inv_a2"])  # the fault: before the ReLU
        z = qconv(q2, p["k3q"], p["m3"], p["b3"])
        if "kdq" in p:
            identity = qconv(yq, p["kdq"], p["md"], p["bd"],
                             stride=stride).to(torch.bfloat16)
        else:
            identity = y.to(torch.bfloat16)
        out = (z.to(torch.bfloat16) + identity).relu_()
        return q._epilogue(out, identity, p, heads).to(torch.bfloat16)

    saved = q._qblock_bf16res
    q._qblock_bf16res = block
    try:
        return quant_blockwise(qp, sws, x, False)
    finally:
        q._qblock_bf16res = saved


def surf_int8(smi: str, model) -> tuple:
    """(b); returns (launches by path, launches by path and shape)."""
    from mrla_tpu_torch.serving import (
        prepare_inference_params,
        resnet_mrlal_forward,
    )
    from mrla_tpu_torch.serving.quant import (
        prepare_quant_params,
        resnet_mrlal_quant_forward,
    )
    from mrla_tpu_torch.testing import images

    gen = torch.Generator().manual_seed(22)
    t0 = time.perf_counter()
    qp = prepare_quant_params(model, images(gen, BATCH, PX).cuda(),
                              device="cuda")
    torch.cuda.synchronize()
    print(f"serving surface (b): prepare_quant_params on {BATCH} seeded "
          f"images in {time.perf_counter() - t0:.2f} s")
    batches = [images(gen, BATCH, PX).cuda() for _ in range(2)]
    sws = kernel_scales(model)
    params = prepare_inference_params(model, device="cuda")
    bf16 = lambda xb: resnet_mrlal_forward(params, xb)
    with torch.inference_mode():
        ref_bf16 = bf16(batches[0]).float().cpu()
    want = {k: {} for k in all_counters()}
    want["epilogue"] = {s: n for s, (_, n) in QUANT_EPILOGUE_SHAPES.items()}
    launches, by_shape, forwards = {}, {}, {}
    for form, qres in (("int8", False), ("int8-fast", True)):
        path = SURF_PATHS[form]
        fwd = (lambda r: lambda xb: resnet_mrlal_quant_forward(
            qp, xb, quant_residual=r))(qres)
        forwards[form] = fwd
        outs, launches[path], per_forward = counted(
            fwd, batches, path, want, desc=f"{PX}px bs{BATCH} int8")
        by_shape[path] = {"epilogue": {
            str(list(s)): int(n * len(batches))
            for s, n in per_forward["epilogue"].items()}}
        got = outs[0].float().cpu()
        errs = quant_blockwise(qp, sws, batches[0], qres)
        e2e = fake_quant_reference(qp, sws, batches[0], qres).cpu()
        e2e_err = (got - e2e).abs().max().item() / e2e.abs().max().item()
        top2 = ref_bf16.topk(2, dim=-1).values
        pick = (top2[:, 0] - top2[:, 1]).argsort(descending=True)[:8]
        agree = torch.equal(got[pick].argmax(-1), ref_bf16[pick].argmax(-1))
        print(f"serving surface (b), {path} {PX}px bs{BATCH} (chains of "
              f"{QUANT_MICROBATCH}): against the fp32 fake-quant reference "
              f"on the card fed each block's own input, max|Δ|/max|out| by "
              f"block {[round(e, 5) for e in errs[:-1]]}, the logits' "
              f"{errs[-1]:.4g} (tol {QUANT_LOGIT_TOL} each); end to end "
              f"(the reference on its own outputs, flips compounding over "
              f"16 blocks) {e2e_err:.4g}; against the bf16 engine top-1 on "
              f"its 8 clearest images {got[pick].argmax(-1).tolist()} vs "
              f"{ref_bf16[pick].argmax(-1).tolist()}, top-1 agrees on "
              f"{(got.argmax(-1) == ref_bf16.argmax(-1)).sum().item()}/"
              f"{BATCH}, logit error {logit_error(got, ref_bf16):.4g}")
        if not max(errs) <= QUANT_LOGIT_TOL:
            raise AssertionError(f"{path}: {errs} against the fake-quant "
                                 "reference")
        # int8-fast carries the residual stream int8: lossy by design
        # (serving/quant.py), its top-1 is printed and not held
        if not agree and not qres:
            raise AssertionError(f"{path}: top-1 differs from the bf16 "
                                 "engine on its clearest images")
    for kind in QUANT_FAULTS:
        errs = faulty_blockwise(qp, sws, batches[0], kind)
        print(f"serving surface (b), injected fault {kind}: max|Δ|/max|out|"
              f" {max(errs):.4g} at block {errs.index(max(errs))} (must "
              f"exceed {QUANT_LOGIT_TOL})")
        if max(errs) <= QUANT_LOGIT_TOL:
            raise AssertionError(f"int8 fault {kind} passed the check")
    for form in ("int8", "int8-fast", "bf16", "bf16", "int8-fast", "int8"):
        throughput(forwards.get(form, bf16), batches,
                   SURF_PATHS.get(form, "resnet50_mrlal bf16 engine"), smi,
                   desc=f"{PX}px bs{BATCH} {form}")
    return launches, by_shape


def surf_detections(smi: str) -> dict:
    """(c); returns the launches by path."""
    import copy
    import io

    import numpy as np

    import mrla_tpu_torch.serving.server as server
    from mrla_tpu_torch.serving import detect_forward, prepare_detect_params
    from mrla_tpu_torch.testing import (
        detector_serving_model,
        images,
        retinanet_serving_model,
    )

    t0 = time.perf_counter()
    det = seeded("mask_rcnn", lambda: detector_serving_model(0, MASK_PRESET))
    retina = copy.deepcopy(seeded("retinanet",
                                  lambda: retinanet_serving_model(0)))
    x = images(torch.Generator().manual_seed(23), DET_BATCH, DET_HW)
    print(f"serving surface (c): seeded detectors in "
          f"{time.perf_counter() - t0:.1f} s")
    body, shape = _npy(x.numpy()), (DET_BATCH, *DET_HW, 3)
    counters = all_counters()
    roi = {"faster": {ROI: 1 for ROI in ROI_SHAPES},
           "mask": {**{s: 1 for s in ROI_SHAPES},
                    **{s: 1 for s in MASK_ROI_SHAPES}}}
    trunk = {"megatail": {s: n for s, (_, n) in DET_MEGATAIL_SHAPES.items()},
             "epilogue": {s: n for s, (_, n) in DET_EPILOGUE_SHAPES.items()}}
    launches = {}
    for kind, preset, model in (("retinanet", RETINA_PRESET, retina),
                                ("faster", DET_PRESET, det),
                                ("mask", MASK_PRESET, det)):
        path = SURF_PATHS[kind]
        httpd, beng = server.build_detections_server(
            preset, model, batch_size=DET_BATCH, image_hw=DET_HW, port=0,
            device="cuda")
        with running(httpd, beng) as base:
            warm(beng, shape)
            for c in counters.values():
                c.reset()
            got = json.loads(_post(base + "/predict?masks=1", body))[
                "detections"]
            torch.cuda.synchronize()
            launches[path] = {k: c.launches for k, c in counters.items()}
            by = {k: dict(c.by_shape) for k, c in counters.items()}
            with torch.inference_mode():
                direct = server._to_host(beng.fwd(
                    x.to("cuda", torch.bfloat16)))
        want = [server.detections_json(tuple(o[i] for o in direct), True)
                for i in range(DET_BATCH)]
        n_det = [len(d["boxes"]) for d in got]
        masks = [np.asarray(d.get("masks", [])).shape for d in got]
        print(f"serving surface (c), {path} {DET_HW[0]}x{DET_HW[1]} "
              f"bs{DET_BATCH} bf16, one batch: JSON equal to the direct "
              f"call {got == want}; detections per image {n_det}; masks "
              f"{masks[:2]}..; launches {launches[path]}")
        if got != want:
            raise AssertionError(f"{path}: JSON differs from the direct call")
        if min(n_det) == 0:
            raise AssertionError(f"{path}: an image without a detection")
        want_by = ({k: {} for k in counters} if kind == "retinanet" else
                   {**{k: {} for k in counters}, **trunk,
                    "roi_align": roi[kind]})
        if by != want_by:
            raise AssertionError(f"{path}: launches {by} != {want_by}")
        if kind == "mask":
            if any(m != (n, 28, 28) for m, n in zip(masks, n_det)):
                raise AssertionError(f"{path}: masks {masks}")
        elif any("masks" in d for d in got):
            raise AssertionError(f"{path}: masks without a mask head")
        del beng, httpd
    path = SURF_PATHS["pyramid"]
    httpd, beng = server.build_detect_server(
        DET_PRESET, det, batch_size=DET_BATCH, image_hw=DET_HW, port=0,
        device="cuda")
    with running(httpd, beng) as base:
        warm(beng, shape)
        for c in counters.values():
            c.reset()
        got = np.load(io.BytesIO(_post(base + "/predict", body)))
        torch.cuda.synchronize()
        launches[path] = {k: c.launches for k, c in counters.items()}
        by = {k: dict(c.by_shape) for k, c in counters.items()}
    sp = prepare_detect_params(det, device="cuda")
    want = detect_forward(sp, x.to("cuda", torch.bfloat16))
    same = [np.array_equal(got[f"level{i}"], w.float().cpu().numpy())
            for i, w in enumerate(want)]
    print(f"serving surface (c), {path}: npz levels "
          f"{[got[f].shape for f in got.files]} bitwise detect_forward's "
          f"{same}; launches {launches[path]}")
    if len(got.files) != len(want) or not all(same):
        raise AssertionError(f"{path}: levels differ from detect_forward")
    if by != {**{k: {} for k in counters}, **trunk}:
        raise AssertionError(f"{path}: launches {by}")
    return launches


def surf_cli(work: str, smi: str) -> dict:
    """(d); returns the launches by path."""
    import numpy as np

    from mrla_tpu_torch.data.imagefolder import ImageFolder, iterate_batches
    from mrla_tpu_torch.models import create_model
    from mrla_tpu_torch.serving import cli

    root = os.path.join(work, "tree")
    ds = ImageFolder(os.path.join(root, "val"))
    counters = all_counters()
    launches = {}
    for arch, extra, engine in CLI_RUNS:
        path = f"eval CLI {arch} {' '.join(extra)}".strip()
        ckpt = os.path.join(work, f"cli_{arch}.pth")
        if not os.path.exists(ckpt):
            torch.save({"state_dict": create_model(
                arch, device="cpu", num_classes=CLI_CLASSES,
                generator=torch.Generator().manual_seed(5)).state_dict()},
                ckpt)
        made = []
        real = cli.make_engine_forward

        def capture(*a, **kw):
            fwd = real(*a, **kw)
            made.append(fwd)
            return lambda xb: (made.append(None), fwd(xb))[1]

        for c in counters.values():
            c.reset()
        cli.make_engine_forward = capture
        try:
            t0 = time.perf_counter()
            res = cli.main(["-a", arch, "--data", root, "--torch", ckpt,
                            "--limit", str(CLI_LIMIT), "-b", str(BATCH),
                            "--image-size", str(PX),
                            "--num-classes", str(CLI_CLASSES),
                            "--workers", "8", *extra])
            wall = time.perf_counter() - t0
        finally:
            cli.make_engine_forward = real
        torch.cuda.synchronize()
        fwd, n_fwd = made[0], len(made) - 1
        launches[path] = {k: c.launches for k, c in counters.items()}
        per_forward = {k: {s: n / n_fwd for s, n in c.by_shape.items()}
                       for k, c in counters.items() if c.launches}
        top1 = top5 = seen = 0
        with torch.inference_mode():
            for b in iterate_batches(ds, np.arange(CLI_LIMIT), BATCH, PX,
                                     train=False, num_threads=8,
                                     drop_last=False):
                logits = fwd(cli._normalized(b["image"], torch.device(
                    "cuda")).to(torch.bfloat16)).cpu().numpy()
                order = np.argsort(-logits, axis=-1)[:, :5]
                top1 += int((order[:, 0] == b["label"]).sum())
                top5 += int(np.any(order == b["label"][:, None], 1).sum())
                seen += len(b["label"])
        direct = (round(100.0 * top1 / seen, 3), round(100.0 * top5 / seen, 3))
        print(f"serving surface (d), {path}: {json.dumps(res)} in "
              f"{wall:.1f} s; a direct loop over the same engine: acc1 "
              f"{direct[0]} acc5 {direct[1]}; {n_fwd} forwards, launches per "
              f"forward by shape {per_forward}, on {smi}")
        if (res["engine"], res["images"]) != (engine, CLI_LIMIT):
            raise AssertionError(f"{path}: {res}")
        if (res["acc1"], res["acc5"]) != direct:
            raise AssertionError(f"{path}: accuracies {res} != {direct}")
        want = {}
        if extra:
            want = {"epilogue": {s: n for s, (_, n)
                                 in QUANT_EPILOGUE_SHAPES.items()}}
        elif engine == "mrlal":
            want = {"megatail": {s: n for s, (_, n)
                                 in MEGATAIL_SHAPES.items()},
                    "epilogue": {s: n for s, (_, n)
                                 in EPILOGUE_SHAPES.items()}}
        elif arch == DEIT_ARCH:
            want = {"deit_tail": {s: n for s, (_, n)
                                  in DEIT_TAIL_SHAPES.items()}}
        want = {k: v for k, v in want.items() if v}
        if per_forward != want:
            raise AssertionError(f"{path}: launches per forward "
                                 f"{per_forward} != {want}")
    return launches


def surf_tools(work: str, smi: str) -> None:
    """(e)."""
    from mrla_tpu_torch import hub
    from mrla_tpu_torch.testing import images
    from mrla_tpu_torch.utils import logtools, profile_model

    model, sd = hub.load("resnet50_mrlal", device="cuda")
    with torch.inference_mode():
        out = model(images(torch.Generator().manual_seed(24), 8, PX).cuda())
    print(f"serving surface (e), hub.load('resnet50_mrlal') on the card: "
          f"logits {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}"
          f", {len(sd)} state_dict entries")
    if out.shape != (8, 1000) or not torch.isfinite(out).all():
        raise AssertionError("hub.load: logits not finite")
    del model, sd
    for arch in ("resnet50_mrlal", DEIT_ARCH):
        prof = profile_model(arch, (1, PX, PX, 3), device="cuda")
        print(f"serving surface (e), profile_model: {json.dumps(prof)} "
              f"(FlopCounterMode, two FLOPs a multiply-add; "
              f"utils/flops.py states its band against XLA's count), on "
              f"{smi}")
        if not prof["params"] > 0 or not prof["gflops"]:
            raise AssertionError(f"profile_model {arch}: {prof}")
    run = os.path.join(work, "run_resnet")
    best = logtools.best_from_txt(os.path.join(run, "val_acc1.txt"))
    best_json = logtools.best_from_jsonl(os.path.join(run, "log.txt"))
    rows = logtools.txt_to_csv(run, os.path.join(work, "run_resnet.csv"))
    print(f"serving surface (e), logtools on phase 8d's ResNet run: best "
          f"val_acc1 {best}, best log.txt record {best_json}, {rows} csv "
          f"rows")
    if best is None or best_json is None or rows != 1:
        raise AssertionError("logtools: the run directory did not read")


def serving_surface(smi: str, work: str) -> tuple:
    """Phase 8h; returns (launches by path and kernel, launches by path,
    kernel and shape)."""
    from mrla_tpu_torch.testing import serving_model

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    model = seeded("resnet50_mrlal", lambda: serving_model(0))
    daemon, daemon_by_shape = surf_daemon(smi, model)
    launches = {SURF_PATHS["daemon"]: daemon}
    by_shape = {SURF_PATHS["daemon"]: daemon_by_shape}
    torch.cuda.empty_cache()
    got, got_by_shape = surf_int8(smi, model)
    launches.update(got)
    by_shape.update(got_by_shape)
    torch.cuda.empty_cache()
    launches.update(surf_detections(smi))
    torch.cuda.empty_cache()
    launches.update(surf_cli(work, smi))
    torch.cuda.empty_cache()
    surf_tools(work, smi)
    print(f"serving surface phase 8h: {time.perf_counter() - t0:.1f} s "
          f"(target {SURF_WALL_S})")
    return launches, by_shape


def kernels_line(rows, launches, per_forward, by_shape=None):
    """One entry per kernel; ms, plain_ms and bound_ms are per forward: each
    shape's time weighted by its launches per forward on the kernel's main
    path (the DeiT path for the token tail, use_stage4=True for the stage
    kernel, use_stage4=False for the epilogue and mega-tail, the detection
    paths for RoIAlign, the tail routes for the block tails, row tail and
    copy); the launches counted on the other paths are listed beside."""
    meta = {
        "epilogue": ("mrla_light_epilogue", "mrla_tpu_torch/csrc/mrla_epilogue.cu",
                     "mrla_tpu/kernels/mrla_epilogue.py:128",
                     RESNET_PATHS[False]),
        "megatail": ("mrla_block_tail_fused_next",
                     "mrla_tpu_torch/csrc/mrla_megatail.cu",
                     "mrla_tpu/kernels/mrla_megatail.py:289",
                     RESNET_PATHS[False]),
        "stage4": ("stage4_resident", "mrla_tpu_torch/csrc/mrla_stage4.cu",
                   "mrla_tpu/kernels/mrla_stage4.py:312", RESNET_PATHS[True]),
        "deit_tail": ("deit_token_tail",
                      "mrla_tpu_torch/csrc/deit_token_tail.cu",
                      "mrla_tpu/kernels/deit_token_tail.py:227", DEIT_PATH),
        "roi_align": ("roi_align_patch", "mrla_tpu_torch/csrc/roi_align.cu",
                      "mrla_tpu/kernels/roialign_patch.py:306", DET_PATH),
        "roi_align_bwd": ("roi_align_bwd", "mrla_tpu_torch/csrc/roi_align.cu",
                          "mrla_tpu/kernels/roialign_patch.py:438",
                          TRAIN_PATH),
        "block_tail": ("mrla_block_tail",
                       "mrla_tpu_torch/csrc/mrla_block_tail.cu",
                       "mrla_tpu/kernels/mrla_epilogue.py:214",
                       TAIL_PATHS["block_tail"]),
        "rowtail": ("mrla_rowtail", "mrla_tpu_torch/csrc/mrla_rowtail.cu",
                    "mrla_tpu/kernels/mrla_rowtail.py:173",
                    TAIL_PATHS["rowtail"]),
        "block_tail_hwbc": ("mrla_block_tail_hwbc",
                            "mrla_tpu_torch/csrc/mrla_block_tail.cu",
                            "mrla_tpu/kernels/mrla_epilogue_hwbc.py:222",
                            TAIL_PATHS["block_tail"]),
        "copy": ("hwbc_copy", "mrla_tpu_torch/csrc/hwbc_copy.cu",
                 "scripts/exp_boundary.py:45", TAIL_PATHS["copy"]),
    }
    out = []
    for key, (name, source, replaces, path) in meta.items():
        counts = per_forward[path][key]
        shapes = [dict(rows[key][s], per_forward=n) for s, n in counts.items()]
        weighted = lambda f: sum(r[f] * r["per_forward"] for r in shapes)
        # what bounds the shape that holds most of the forward's bound
        by = max(shapes, key=lambda r: r["bound_ms"] * r["per_forward"])
        lib = [r.get("library_ms") for r in shapes]
        out.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[path][key],
            "launches_per_forward": sum(counts.values()),
            "main_path": path,
            "launches_on_other_paths": {
                other: n.get(key, 0) for other, n in launches.items()
                if other != path},
            "launches_by_shape_on_other_paths": {
                other: n[key] for other, n in (by_shape or {}).items()
                if key in n},
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            "ms": weighted("ms"),
            "plain_ms": weighted("plain_ms"),
            "bound_ms": weighted("bound_ms"),
            "bound_by": by["bound_by"],
            # a PyTorch call computing the same function, where there is one
            "library_ms": (None if None in lib else weighted("library_ms")),
            "per_shape": shapes,
            # rows held and timed at shapes that only other paths give it
            "per_shape_on_other_paths": [
                r for s, r in rows[key].items() if s not in counts],
        })
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from mrla_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)

    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"device: {name}, count {count}, nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"Python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib = _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {_build.build()}")
    for line in _build.ptxas_log().splitlines():
        if any(s in line for s in ("==", "Compiling entry", "registers",
                                   "spill")):
            print("  " + line.strip())

    rows = check_kernels(lib)
    launches, per_forward = serve(smi)
    launches[DEIT_PATH], per_forward[DEIT_PATH] = serve_deit(smi)
    for key, got in zip((launches, per_forward), serve_mrlab(smi)):
        key.update(got)
    check_microbatch(smi)
    rows["roi_align"], det_launches, det_per_forward = serve_detect(smi)
    launches.update(det_launches)
    per_forward.update(det_per_forward)
    rows["roi_align_bwd"], launches[TRAIN_PATH], per_forward[TRAIN_PATH] = \
        train_detect(smi)
    train_classify(smi)
    for key, got in zip((launches, per_forward), model_zoo(smi)):
        key.update(got)
    with tempfile.TemporaryDirectory() as work:
        train_real_data(smi, work)
        detection_rest(smi)
        launches[DP_PATH] = data_parallelism(smi)
        mp_launches, mp_by_shape = model_parallelism(smi)
        launches.update(mp_launches)
        surf_launches, surf_by_shape = serving_surface(smi, work)
        launches.update(surf_launches)
    print(json.dumps(kernels_line(rows, launches, per_forward,
                                  {**mp_by_shape, **surf_by_shape})))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
