#!/usr/bin/env python3
"""Where the device time of the port's resnet50_mrlal forward goes.

    python3 -m mrla_tpu_torch.profile_serving

Serves resnet50_mrlal (224 px, bf16, the BN-folded engine, seeded weights
and images from ``mrla_tpu_torch/testing.py``) on one CUDA card, traces
``FORWARDS`` forwards of batch ``BATCH`` with torch.profiler after a
warm-up, and prints the device time by kernel group and for the busiest
kernels, the wall time of the window and the device's idle share.  Needs
a CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
import time
from collections import defaultdict

import torch

GROUPS = (  # first match wins, on the lower-cased kernel name
    ("mrla mega-tail kernel", ("mrla_megatail_kernel",)),
    ("mrla epilogue kernel", ("mrla_epilogue_kernel",)),
    ("convolution", ("conv", "xmma", "gemm", "cutlass", "cudnn", "implicit",
                     "sm90_", "nhwc", "winograd", "fprop")),
    ("reduction (GAP, head)", ("reduce",)),
    ("pooling", ("pool",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "copy")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


FORWARDS, BATCH = 3, 128


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from mrla_tpu_torch.serving import (
        prepare_inference_params,
        resnet_mrlal_forward,
    )
    from mrla_tpu_torch.testing import images, serving_model

    model = serving_model(0)
    params = prepare_inference_params(model, dtype=torch.bfloat16,
                                      device="cuda")
    gen = torch.Generator().manual_seed(1)
    batches = [images(gen, BATCH).cuda()
               for _ in range(FORWARDS)]
    for xb in batches:  # warm-up: build, cuDNN autotune, allocator
        resnet_mrlal_forward(params, xb)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        for xb in batches:
            resnet_mrlal_forward(params, xb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    per_kernel = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        per_kernel[evt.key][0] += evt.self_device_time_total / 1e3  # ms
        per_kernel[evt.key][1] += evt.count
    busy = sum(t for t, _ in per_kernel.values())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    print(f"window: {FORWARDS} forwards, bs{BATCH}, wall "
          f"{wall_ms:.3f} ms ({wall_ms / FORWARDS:.3f} ms/forward), "
          f"device busy {busy:.3f} ms, idle share "
          f"{max(0.0, 1 - busy / wall_ms):.3f}")
    if busy == 0:
        print("the profiler recorded no device time")
        return 1
    groups = defaultdict(lambda: [0.0, 0])
    for name, (t, n) in per_kernel.items():
        g = groups[group_of(name)]
        g[0] += t
        g[1] += n
    print("device time by group (ms per forward, share, launches per forward):")
    for g, (t, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g:24s} {t / FORWARDS:9.4f} {t / busy:7.3f} "
              f"{n / FORWARDS:7.1f}")
    print("busiest kernels (ms per forward, launches per forward):")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (t, n) in top:
        print(f"  {t / FORWARDS:9.4f} {n / FORWARDS:6.1f}  "
              f"{name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
