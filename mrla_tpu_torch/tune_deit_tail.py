"""Time designs of the DeiT token tail side by side on the card, at the
published widths: the library's two passes (``csrc/deit_token_tail.cu``)
and variants of them (``tune_deit_tail_passes.cu``), the three launches
they replaced (``tune_deit_tail_launches.cu``) and the cluster design
measured before (``tune_deit_tail.cu``); the last three are on no path.

    python -m mrla_tpu_torch.tune_deit_tail [--phases | --library]

At [128, 197, C] for C = 192, 384, 768 and [128, 577, 768] (the 384 px
base model) it prints one JSON line per shape.  Times are CUDA events, 20
launches after 3, warm L2; errors are in bf16 ulps of the plain version.

- By default: the library kernel's time, and for each cluster size cs
  whose C / cs channels fit a block the cluster design's time, shared
  memory, blocks an SM, clusters the card holds at once
  (``tune_deit_tail_cluster_describe``), waves, error and whether two
  launches are bitwise equal; and the cluster size its rule picks.
- ``--phases``: first the loops of every build's kernels as ``cuobjdump
  -sass`` lists them (instructions a trip and their opcodes), then at each
  shape the three launches whole and each alone (stats, gate, main), each
  kernel's registers, spilled bytes, shared memory and blocks an SM; the
  library's kernel whole with its launch (``deit_token_tail_describe``);
  its two passes whole and each alone from ``tune_deit_tail_passes.cu``,
  built with the library's launch choices and with one of them overridden
  (``PASS_VARIANTS``: ot's row statistics in pass 2, no dependent launch,
  pass 2's threads, its ring, pass 1's rings), each with its launch, error
  and rerun; and the cluster design's cycles a block by phase from a
  clock64-marked copy.
- ``--library``: the library's kernel alone (three readings a shape, the
  four shapes above and the small batches of ``SMALL_SHAPES``) and
  deit_mrlal_small_patch16_224 served at 224 px, batch 128, bf16 (img/s,
  twice).  It uses only the package's public entry points, so it reads
  another checkout of the package in the same call when that checkout is
  first on the path (``python -c "import runpy, sys; sys.argv = ['x',
  '--library']; runpy.run_path('<this file>', run_name='__main__')"`` from
  the other checkout's root).

Every build goes into ``_build/tune/`` with the library's nvcc flags;
nothing of this module is on a serving path.
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
# batches a latency-bound server sends: a single image, a few
SMALL_SHAPES = [(1, 197, 384), (3, 197, 384), (8, 197, 384), (1, 577, 768)]


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


LAUNCHES = Path(__file__).with_name("tune_deit_tail_launches.cu")
LAUNCH_NAMES = ("stats", "gate", "main")


def launches_library() -> ctypes.CDLL:
    """The three-launch design (``tune_deit_tail_launches.cu``)."""
    cdll = _build.build_tune(LAUNCHES)
    cdll.tune_deit_tail_launches_phase.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    cdll.tune_deit_tail_launches_scratch_per_image.argtypes = [
        ctypes.c_int] * 4
    cdll.tune_deit_tail_launches_describe.argtypes = [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    return cdll


def _kernel_rows(flat, names) -> dict:
    """{name: registers, spilled bytes, static / dynamic shared memory,
    blocks an SM} from a describe entry's five ints a kernel."""
    keys = ("registers", "local_bytes", "static_smem", "dynamic_smem",
            "blocks_per_sm")
    return {name: dict(zip(keys, flat[5 * k:5 * k + 5]))
            for k, name in enumerate(names)}


def three_launches(lib, x, ot, packed, stream) -> dict:
    """The three-launch design whole and each launch alone (each reads what
    the launches before it left in scratch), with each kernel's build."""
    b, n, c = x.shape
    ktap = packed.taps.shape[1]
    scratch = torch.empty(
        b * lib.tune_deit_tail_launches_scratch_per_image(n, c, 16, ktap),
        device="cuda")
    out = torch.empty_like(x)
    run = lambda phase: lib.tune_deit_tail_launches_phase(
        x.data_ptr(), ot.data_ptr(), packed.vec.data_ptr(),
        packed.taps.data_ptr(), scratch.data_ptr(), out.data_ptr(), b, n, c,
        16, ktap, phase, stream)
    _build.check(run(-1), "three launches")
    row = {"ms": cuda_ms(lambda: run(-1))}
    for k, name in enumerate(LAUNCH_NAMES):
        row[f"{name} ms"] = cuda_ms(lambda: run(k))
    desc = (ctypes.c_int * 15)()
    _build.check(lib.tune_deit_tail_launches_describe(
        n, c, ctypes.addressof(desc)), "tune_deit_tail_launches_describe")
    row["kernels"] = _kernel_rows(list(desc), LAUNCH_NAMES)
    torch.cuda.synchronize()
    row["ulps"] = _ulps(out, deit_token_tail_reference(x, ot, packed))
    return row


def _ulps(out, ref) -> float:
    ref = ref.float()
    return ((out.float() - ref).abs().max().item()
            / (2.0 ** -7 * ref.abs().max().item()))


def cluster_clocks(lib, x, ot, packed, stream) -> dict:
    """The cluster design at the rule's size: ms and the cycles a block
    spends in each phase (thread 0's clock, mean over blocks)."""
    b, n, c = x.shape
    clocks = (ctypes.c_ulonglong * 8)()
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
    return {"ms": ms, "blocks": blocks, "cycles a block": {
        k: clocks[i] / blocks for i, k in enumerate(PHASES)}}


PASSES = Path(__file__).with_name("tune_deit_tail_passes.cu")
# the two passes with the library's launch choices, and with one of them
# overridden (the macros at the top of tune_deit_tail_passes.cu)
PASS_VARIANTS = {
    "library's choices": {},
    "ot statistics in pass 2": {"DEIT_TAIL_OT_STATS_IN_PASS1": 0},
    "no dependent launch": {"DEIT_TAIL_PDL": 0},
    "192 threads": {"DEIT_TAIL_PASS2_THREADS": 192},
    "pass 1 rings of 160 KB": {"DEIT_TAIL_PASS1_RING_KB": 160},
    "pass 1 rings of 48 KB": {"DEIT_TAIL_PASS1_RING_KB": 48},
    "ring of 3": {"DEIT_TAIL_STAGES": 3},
    "ring of 6": {"DEIT_TAIL_STAGES": 6},
}
PASS_NAMES = ("pass 1", "pass 2")


def pass_libraries() -> dict:
    """Every variant of PASS_VARIANTS built from tune_deit_tail_passes.cu
    (one nvcc each, all started together) into ``_build/tune/``."""
    src = PASSES.read_text()
    todo, libs = [], {}
    for name, defines in PASS_VARIANTS.items():
        flags = [f"-D{k}={v}" for k, v in defines.items()]
        digest = hashlib.sha256((src + " ".join(_build.NVCC_FLAGS + flags))
                                .encode())
        for f in sorted(_build.CSRC.iterdir()):
            digest.update(f.read_bytes())
        out = _build.BUILD_ROOT / "tune" / digest.hexdigest()[:16]
        lib = out / "libtune_deit_tail_passes.so"
        libs[name] = lib
        if not lib.exists():
            out.mkdir(parents=True, exist_ok=True)
            todo.append((name, out, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-shared",
                 "-I", str(_build.CSRC), "-o", str(lib), str(PASSES)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, out, proc in todo:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{text}")
        (out / "ptxas.log").write_text(text)
    for name, lib in libs.items():
        cdll = ctypes.CDLL(str(lib))
        cdll.tune_deit_tail_passes_pass.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        cdll.tune_deit_tail_passes_scratch_per_image.argtypes = [
            ctypes.c_int] * 4
        cdll.tune_deit_tail_passes_describe.argtypes = [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        libs[name] = cdll
    return libs


def two_passes(lib, x, ot, packed, stream) -> dict:
    """A variant of the two passes whole and each pass alone (pass 2 reads
    what pass 1 left in scratch), its launch, its error against the plain
    version and whether two launches are bitwise equal."""
    b, n, c = x.shape
    ktap = packed.taps.shape[1]
    scratch = torch.empty(
        b * lib.tune_deit_tail_passes_scratch_per_image(n, c, 16, ktap),
        device="cuda")
    out = torch.full_like(x, float("nan"))
    run = lambda p: lib.tune_deit_tail_passes_pass(
        x.data_ptr(), ot.data_ptr(), packed.vec.data_ptr(),
        packed.taps.data_ptr(), scratch.data_ptr(), out.data_ptr(), b, n, c,
        16, ktap, p, stream)
    _build.check(run(-1), "two passes")
    torch.cuda.synchronize()
    first = out.clone()
    row = {"ms": cuda_ms(lambda: run(-1))}
    for p, name in enumerate(PASS_NAMES, start=1):
        row[f"{name} ms"] = cuda_ms(lambda: run(p))
    desc = (ctypes.c_int * 16)()
    _build.check(lib.tune_deit_tail_passes_describe(b, n, c,
                                                    ctypes.addressof(desc)),
                 "tune_deit_tail_passes_describe")
    d = list(desc)
    row["kernels"] = _kernel_rows(d, PASS_NAMES)
    row.update(pass2_threads=d[10], pass2_rows=d[11], pass2_blocks=d[12],
               ring=d[13], ot_statistics_in_pass1=d[14],
               dependent_launch=d[15])
    torch.cuda.synchronize()
    row["ulps"] = _ulps(out, deit_token_tail_reference(x, ot, packed))
    row["rerun_bitwise"] = bool(torch.equal(out, first))
    return row


def library_row(lib, x, ot, packed, stream) -> dict:
    """The library's kernel whole through its C entry point, its launch
    (``deit_token_tail_describe``), error and rerun."""
    b, n, c = x.shape
    ktap = packed.taps.shape[1]
    scratch = torch.empty(
        b * lib.deit_token_tail_scratch_per_image(n, c, 16, ktap),
        device="cuda")
    out = torch.full_like(x, float("nan"))
    run = lambda: lib.deit_token_tail_bf16(
        x.data_ptr(), ot.data_ptr(), packed.vec.data_ptr(),
        packed.taps.data_ptr(), scratch.data_ptr(), out.data_ptr(), b, n, c,
        16, ktap, stream)
    _build.check(run(), "deit_token_tail_bf16")
    torch.cuda.synchronize()
    first = out.clone()
    row = {"ms": cuda_ms(run)}
    desc = (ctypes.c_int * 15)()
    _build.check(lib.deit_token_tail_describe(b, n, c,
                                              ctypes.addressof(desc)),
                 "deit_token_tail_describe")
    d = list(desc)
    row["kernels"] = _kernel_rows(d, PASS_NAMES)
    row.update(pass2_threads=d[10], pass2_rows=d[11], pass2_blocks=d[12],
               ring=d[13], pass1_threads=d[14])
    torch.cuda.synchronize()
    row["ulps"] = _ulps(out, deit_token_tail_reference(x, ot, packed))
    row["rerun_bitwise"] = bool(torch.equal(out, first))
    return row


def phases(gen, stream) -> None:
    """At every shape, one JSON line: the three-launch design whole and a
    launch at a time, the library's kernel whole, each variant of the two
    passes whole and a pass at a time, and the cluster design's cycles by
    phase."""
    three, cluster = launches_library(), cluster_library(marks=True)
    library = _build.library()
    ok = True
    try:
        passes = pass_libraries()
    except RuntimeError as err:  # the other designs are timed all the same
        print(f"the two passes did not build: {err}", flush=True)
        passes, ok = {}, False
    # the loops a thread runs, per kernel of each build
    print(json.dumps({"sass loops": {
        name: sass_loops(Path(lib._name)) for name, lib in
        [("three launches", three), ("library", library),
         *passes.items()]}}), flush=True)
    for b, n, c in SHAPES:
        x, ot, packed = deit_tail_case(gen, b, n, c)
        row = {"shape": [b, n, c],
               "three launches": three_launches(three, x, ot, packed,
                                                stream),
               "library": library_row(library, x, ot, packed, stream)}
        ok &= row["library"]["ulps"] <= 1 and row["library"]["rerun_bitwise"]
        for name, lib in passes.items():
            row[name] = two_passes(lib, x, ot, packed, stream)
            ok &= row[name]["ulps"] <= 1 and row[name]["rerun_bitwise"]
        if describe(cluster, b, n, c, packed.taps.shape[1], 0)[0]:
            row["cluster"] = cluster_clocks(cluster, x, ot, packed, stream)
        print(json.dumps(row), flush=True)
        del x, ot, packed
    if not ok:
        raise AssertionError("the two passes or a variant of them are off "
                             "the plain version or their reruns differ")


def sass_loops(lib: Path, min_size: int = 40) -> dict:
    """{kernel: [loop, ...]} of a built library: every backward branch of
    ``cuobjdump -sass``'s listing that spans at least ``min_size``
    instructions, as its instruction count and the count of each opcode
    (the body a thread runs once a trip)."""
    import collections
    import re

    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          stdout=subprocess.PIPE, text=True).stdout
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        ins = [(int(m.group(1), 16), m.group(2).strip()) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", chunk)]
        loops = []
        for at, op in ins:
            m = re.search(r"BRA\s+(?:\S+\s+)?0x([0-9a-f]+)", op)
            if not m or int(m.group(1), 16) >= at:
                continue
            body = [o for a, o in ins if int(m.group(1), 16) <= a <= at]
            if len(body) < min_size:
                continue
            mix = collections.Counter(
                re.sub(r"^@!?U?P\w+\s+", "", o).split()[0].split(".")[0]
                for o in body)
            loops.append({"instructions": len(body),
                          "opcodes": dict(mix.most_common())})
        if loops:  # the kernel's name (a length-prefixed identifier)
            key = name
            for m in re.finditer(r"(\d+)(?=[A-Za-z_])", name):
                ident = name[m.end():m.end() + int(m.group(1))]
                if ident.endswith("kernel"):
                    args = re.match(r"I(.*?)E", name[m.end() + len(ident):])
                    key = ident + (f"<{args.group(1)}>" if args else "")
                    break
            out[key] = loops
    return out


SERVE_ARCH = "deit_mrlal_small_patch16_224"


def library_and_serving(gen, stream, rounds: int = 3) -> None:
    """The library's token tail through its C entry point at every shape
    (``rounds`` readings each, CUDA events, 20 launches after 3), its error
    against the plain version, and SERVE_ARCH served through
    ``prepare_deit_inference_params`` / ``deit_forward`` at 224 px, batch
    128, bf16 (img/s: host clock around 20 forwards after 2, ending in a
    synchronize, twice).  Only the library's entry point, the plain version
    and the serving entry points are used, so the same lines can be read
    off an older checkout of the package in the same call: run this file
    with that checkout first on the path."""
    import time

    from mrla_tpu_torch.serving import (
        deit_forward,
        prepare_deit_inference_params,
    )
    from mrla_tpu_torch.testing import deit_serving_model, images

    lib = _build.library()
    for b, n, c in SHAPES + SMALL_SHAPES:
        x, ot, packed = deit_tail_case(gen, b, n, c)
        ktap = packed.taps.shape[1]
        out = torch.empty_like(x)
        scratch = torch.empty(
            b * lib.deit_token_tail_scratch_per_image(n, c, 16, ktap),
            device="cuda")
        launch = lambda: lib.deit_token_tail_bf16(
            x.data_ptr(), ot.data_ptr(), packed.vec.data_ptr(),
            packed.taps.data_ptr(), scratch.data_ptr(), out.data_ptr(), b, n,
            c, 16, ktap, stream)
        _build.check(launch(), "deit_token_tail_bf16")
        ms = [cuda_ms(launch) for _ in range(rounds)]
        torch.cuda.synchronize()
        print(json.dumps({
            "shape": [b, n, c], "ms": ms,
            "ulps": _ulps(out, deit_token_tail_reference(x, ot, packed))}),
            flush=True)
        del x, ot, packed, out, scratch
    params = prepare_deit_inference_params(
        deit_serving_model(SERVE_ARCH, 0), device="cuda",
        dtype=torch.bfloat16)
    host = torch.Generator().manual_seed(2)
    batches = [images(host, 128).cuda() for _ in range(4)]
    for _ in range(2):
        total = torch.zeros((), device="cuda")
        with torch.no_grad():
            for xb in batches[:2]:
                total += deit_forward(params, xb).float().sum()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(20):
                total += deit_forward(params, batches[i % 4]).float().sum()
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not torch.isfinite(total):
            raise AssertionError("non-finite logits")
        print(json.dumps({"arch": SERVE_ARCH, "img_per_s": 20 * 128 / dt,
                          "ms_per_forward": dt / 20 * 1e3}), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", action="store_true",
                        help="each design whole and a launch at a time")
    parser.add_argument("--library", action="store_true",
                        help="the library's kernel alone and the DeiT "
                             "forward's img/s")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_deit_tail: no CUDA device is available")
    if args.library:
        print(f"device: {torch.cuda.get_device_name(0)}")
        library_and_serving(torch.Generator(device="cuda").manual_seed(0),
                            torch.cuda.current_stream().cuda_stream)
        return 0
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
