"""Time the DeiT token tail's cluster design (``tune_deit_tail.cu``, a
design measured and not taken) at every cluster size it can take, beside
the library's kernel (``csrc/deit_token_tail.cu``), on the card, at the
published widths.

    python -m mrla_tpu_torch.tune_deit_tail [--phases]

At [128, 197, C] for C = 192, 384, 768 (and [128, 577, 768], the 384 px
base model) it prints one JSON line per shape: the library kernel's time
(CUDA events, 20 launches after 3, warm L2); for each cluster size cs
whose C / cs channels fit a block, the cluster design's time, the block's
shared memory, blocks an SM and clusters the card holds at once
(``tune_deit_tail_cluster_describe``), waves, the error against the plain
version in bf16 ulps and whether two launches are bitwise equal; and the
cluster size the design's rule picks.  With ``--phases`` it builds a copy
of the cluster source with clock64 marks at the kernel's phase boundaries
and prints, at each shape and the rule's cluster size, the cycles a block
spends in each phase (thread 0's clock, mean over blocks): staging x and
ot's first pass, waiting for x, the row statistics, the GAP and gate, the
finish.  Both builds go into ``_build/tune/`` with the library's nvcc
flags; nothing of this module is on a serving path.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import torch

from mrla_tpu_torch.kernels import _build, deit_token_tail_reference
from mrla_tpu_torch.testing import deit_tail_case

SOURCE = Path(__file__).with_suffix(".cu")
SHAPES = [(128, 197, 192), (128, 197, 384), (128, 197, 768),
          (128, 577, 768)]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def describe(lib, b: int, n: int, c: int, ktap: int, cs: int) -> list:
    """[cluster size, shared memory, blocks an SM, clusters at once]."""
    out = (ctypes.c_int * 4)()
    _build.check(lib.tune_deit_tail_cluster_describe(b, n, c, 16, ktap, cs,
                                                     ctypes.addressof(out)),
                 "tune_deit_tail_cluster_describe")
    return list(out)


PHASES = ("stage x, ot's first pass", "wait for x",
          "row statistics (two cluster barriers)",
          "GAP, q, k and the gate (two cluster barriers)", "finish")
# anchors in the kernel source a mark goes before: mark k adds the cycles
# since the last mark to phase k of thread 0's block
_MARKS = ['  asm volatile(\n      "{\\n.reg .pred p;\\nWAIT_%=:\\n"',
          "  for (int r = tid; r < N; r += kThreads) {\n    float sx, so;\n"
          "    row_sums(r, false, sx, so);",
          "  // 3. GAP of this block's channels",
          "  // 4. finish.  Items:",
          '  asm volatile("barrier.cluster.wait.acquire;\\n" ::: "memory");\n}']
_START = "  cg::cluster_group cluster = cg::this_cluster();\n"


def cluster_library(marks: bool = False) -> ctypes.CDLL:
    """The cluster design, with clock64 marks at its phases if ``marks``,
    built once per source digest."""
    src = SOURCE.read_text()
    if marks:
        src = _marked(src)
    digest = hashlib.sha256((src + " ".join(_build.NVCC_FLAGS)).encode())
    for f in sorted(_build.CSRC.iterdir()):
        digest.update(f.read_bytes())
    out = _build.BUILD_ROOT / "tune" / digest.hexdigest()[:16]
    lib = out / "libtune_deit_tail.so"
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        (out / "tune_deit_tail.cu").write_text(src)
        run = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-I",
             str(_build.CSRC), "-o", str(lib), str(out / "tune_deit_tail.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if run.returncode:
            raise RuntimeError(f"nvcc failed:\n{run.stdout}")
    cdll = ctypes.CDLL(str(lib))
    cdll.tune_deit_tail_cluster_bf16.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    cdll.tune_deit_tail_cluster_describe.argtypes = [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    if marks:
        cdll.tune_deit_tail_clocks.argtypes = [ctypes.c_void_p]
    return cdll


def _marked(src: str) -> str:
    """The cluster source with clock64 marks at its phases."""
    for anchor in [_START] + _MARKS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"phase mark anchor not found once: {anchor!r}")
    src = src.replace(_START, _START +
                      "  unsigned long long tune_t = clock64();\n"
                      "  auto mark = [&](int k) {\n"
                      "    if (threadIdx.x == 0) {\n"
                      "      const unsigned long long now = clock64();\n"
                      "      atomicAdd(&tune_clocks[k], now - tune_t);\n"
                      "      tune_t = now;\n"
                      "    }\n"
                      "  };\n", 1)
    for k, anchor in enumerate(_MARKS):
        count = ("  if (threadIdx.x == 0) atomicAdd(&tune_clocks[5], 1ull);\n"
                 if k == len(_MARKS) - 1 else "")
        src = src.replace(anchor, f"  __syncthreads();\n  mark({k});\n"
                          + count + anchor, 1)
    src = src.replace("namespace cg = cooperative_groups;",
                      "namespace cg = cooperative_groups;\n"
                      "__device__ unsigned long long tune_clocks[8];", 1)
    src += ('\nextern "C" int tune_deit_tail_clocks(unsigned long long* out) '
            '{\n  cudaDeviceSynchronize();\n'
            '  cudaMemcpyFromSymbol(out, tune_clocks, sizeof(tune_clocks));\n'
            '  static const unsigned long long zero[8] = {};\n'
            '  return (int)cudaMemcpyToSymbol(tune_clocks, zero, '
            'sizeof(zero));\n}\n')
    return src


def phases(gen, stream) -> None:
    lib = cluster_library(marks=True)
    clocks = (ctypes.c_ulonglong * 8)()
    for b, n, c in SHAPES[:3]:
        x, ot, packed = deit_tail_case(gen, b, n, c)
        out = torch.empty_like(x)
        launch = lambda: lib.tune_deit_tail_cluster_bf16(
            x.data_ptr(), ot.data_ptr(), packed.vec.data_ptr(),
            packed.taps.data_ptr(), out.data_ptr(), b, n, c, 16,
            packed.taps.shape[1], 0, stream)
        ms = cuda_ms(launch)
        lib.tune_deit_tail_clocks(ctypes.addressof(clocks))
        _build.check(launch(), "phases")
        lib.tune_deit_tail_clocks(ctypes.addressof(clocks))
        blocks = clocks[5]
        print(json.dumps({"shape": [b, n, c], "ms": ms, "blocks": blocks,
                          "cycles a block": {
                              k: clocks[i] / blocks
                              for i, k in enumerate(PHASES)}}), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", action="store_true",
                        help="cycles a block spends in each phase")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_deit_tail: no CUDA device is available")
    if args.phases:
        print(f"device: {torch.cuda.get_device_name(0)}")
        phases(torch.Generator(device="cuda").manual_seed(0),
               torch.cuda.current_stream().cuda_stream)
        return 0
    lib, tune = _build.library(), cluster_library()
    print(f"device: {torch.cuda.get_device_name(0)}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    for b, n, c in SHAPES:
        x, ot, packed = deit_tail_case(gen, b, n, c)
        ktap = packed.taps.shape[1]
        ref = deit_token_tail_reference(x, ot, packed).float()
        unit = 2.0 ** -7 * ref.abs().max().item()
        out = torch.empty_like(x)
        per_image = lib.deit_token_tail_scratch_per_image(n, c, 16, ktap)
        scratch = torch.empty(b * per_image, device="cuda")
        row = {"shape": [b, n, c], "library_ms": cuda_ms(
            lambda: lib.deit_token_tail_bf16(
                x.data_ptr(), ot.data_ptr(), packed.vec.data_ptr(),
                packed.taps.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                b, n, c, 16, ktap, stream)),
               "rule": describe(tune, b, n, c, ktap, 0)[0]}
        for cs in (1, 2, 4, 8, 16):
            d = describe(tune, b, n, c, ktap, cs)
            if d[0] == 0:
                continue
            out = torch.full_like(x, float("nan"))
            launch = lambda: tune.tune_deit_tail_cluster_bf16(
                x.data_ptr(), ot.data_ptr(), packed.vec.data_ptr(),
                packed.taps.data_ptr(), out.data_ptr(), b, n, c, 16, ktap, cs,
                stream)
            _build.check(launch(), f"cs {cs}")
            torch.cuda.synchronize()
            first = out.clone()
            ms = cuda_ms(launch)
            err = (out.float() - ref).abs().max().item() / unit
            row[f"cs {cs}"] = dict(
                ms=ms, smem_bytes=d[1], blocks_per_sm=d[2],
                clusters_at_once=d[3], waves=b / max(d[3], 1), ulps=err,
                rerun_bitwise=bool(torch.equal(out, first)))
            ok &= err <= 1 and row[f"cs {cs}"]["rerun_bitwise"]
        print(json.dumps(row), flush=True)
    if not ok:
        raise AssertionError("a cluster size is off the plain version or its "
                             "reruns differ")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
