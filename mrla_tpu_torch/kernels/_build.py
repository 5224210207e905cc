"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one ``nvcc``
process per source, all started together) and linked into one shared
library with a plain C interface, which is loaded with ``ctypes``.  The
build runs at first use, never at import, and lands in
``mrla_tpu_torch/_build/<digest>/`` (listed in ``.gitignore``), where the
digest covers the sources and the flags, so an edited source is rebuilt.
A build failure raises with nvcc's output.

Each C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise when it is not 0.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry point -> argtypes (pointers and the stream as void*, sizes as int,
# strides as long long); each returns an int (a cudaError) unless RESTYPES
# names it
SIGNATURES = {
    # out, id, gate, wv, lam, scale, bias, y, B, H, W, C, stream
    "mrla_epilogue_bf16": [_P] * 8 + [_I] * 4 + [_P],
    # B, H, W, C, int[6] out: segment length, threads a block, blocks an
    # SM, blocks, columns in a thread's ring, 1 for a packed bf16 window
    "mrla_epilogue_describe": [_I] * 4 + [_P],
    # out, id, gate, wv, lam, scale, bias, w1, b1, y, x1, B, H, W, C, C1, stream
    "mrla_megatail_bf16": [_P] * 11 + [_I] * 5 + [_P],
    # C, C1, int[6] out: blocks an SM, pixels a block, x1 columns a chunk,
    # ring stages, K chunk depth, shared memory bytes (the row tail's too)
    "mrla_megatail_describe": [_I] * 2 + [_P],
    # ob, xs, xs strides (image, row, column), kd, k3_0, k1, k2, k3, bd, b3_0,
    # b1, b2, b3, wq, wk, wv, lam, scale, bias, f32, yb, x1o, y, B, CIN, C1, C,
    # heads, ktap, stream
    "mrla_stage4_bf16": [_P] * 2 + [_L] * 3 + [_P] * 20 + [_I] * 6 + [_P],
    # B, CIN, C1, C, int[8 * 6] out: each step's tiles, blocks, tile rows,
    # tile columns, ring stages, shared memory bytes
    "mrla_stage4_describe": [_I] * 4 + [_P],
    # N, C, d, ktap -> fp32 values of scratch per image (-1: not supported)
    "deit_token_tail_scratch_per_image": [_I] * 4,
    # x, ot, vec, taps, scratch, out, B, N, C, d, ktap, stream
    "deit_token_tail_bf16": [_P] * 6 + [_I] * 5 + [_P],
    # f0..f3, (H, W) of 4 levels, L, geom, out, B, P, C, O, smax, bf16,
    # stream
    "roi_align_fwd": [_P] * 4 + [_I] * 9 + [_P] * 2 + [_I] * 6 + [_P],
    # grad0..grad3, (H, W) of 4 levels, L, geom, g, scratch, B, P, C, O,
    # smax, stream
    "roi_align_bwd": [_P] * 4 + [_I] * 9 + [_P] * 3 + [_I] * 5 + [_P],
    # B, P, C, O, (H, W) of 4 levels, L -> bytes (long long; -1: refused)
    "roi_align_bwd_scratch_bytes": [_I] * 13,
    # z, id, gate, wv, lam, scale, bias, y, B, H, W, C, stream
    "mrla_block_tail_bf16": [_P] * 8 + [_I] * 4 + [_P],
    # B, H, W, C, int[5] out: segment length, threads a block, blocks an SM,
    # blocks, columns in a thread's ring
    "mrla_block_tail_describe": [_I] * 4 + [_P],
    # out, id, gs, wv, ls, bias, w1, b1, y, x1, B, H, W, C, C1, stream
    # (C1 = 0: y alone, w1 / b1 / x1 null)
    "mrla_rowtail_bf16": [_P] * 10 + [_I] * 5 + [_P],
    "mrla_rowtail_describe": [_I] * 2 + [_P],
    # x, y, B, H, W, C, stream
    "hwbc_copy_bf16": [_P] * 2 + [_I] * 4 + [_P],
}


RESTYPES = {"roi_align_bwd_scratch_bytes": ctypes.c_longlong}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (if not built already) and return the library's
    path.  The ptxas report (registers, shared memory, spills of every
    kernel) is kept beside it as ``ptxas.log``."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "libmrla_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, objs, failed = [], [], []
        for src, obj, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            objs.append(str(obj))
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log)
            )
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (out_dir / "ptxas.log").write_text("\n".join(log))
        os.replace(tmp_lib, lib)  # atomic: concurrent builders agree
    return lib


def build_tune(source: Path) -> ctypes.CDLL:
    """Compile a side-by-side design source (``tune_*.cu``, which includes
    sources of ``csrc/``) with the library's flags into
    ``_build/tune/<digest>/`` (once per digest of it, ``csrc/`` and the
    flags) and load it; its ptxas report lands beside it."""
    digest = hashlib.sha256(source.read_bytes() + _digest().encode())
    out = BUILD_ROOT / "tune" / digest.hexdigest()[:16]
    lib = out / f"lib{source.stem}.so"
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        run = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-shared", "-I", str(CSRC), "-o",
             str(lib), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if run.returncode:
            raise RuntimeError(f"nvcc failed on {source.name}:\n{run.stdout}")
        (out / "ptxas.log").write_text(run.stdout)
    return ctypes.CDLL(str(lib))


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's argtypes set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    return lib


def ptxas_log() -> str:
    """nvcc's ``-Xptxas -v`` report of the current build."""
    return (build().parent / "ptxas.log").read_text()


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


class LaunchCounter:
    """Per-wrapper counts: ``calls`` counts every call (the CPU's plain path
    included), ``launches`` only the calls that launched the CUDA kernel, and
    ``by_shape`` those launches by the shape key the wrapper passes."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.launches = 0
        self.by_shape: collections.Counter = collections.Counter()

    def launch(self, shape: tuple) -> None:
        """Record one kernel launch at ``shape``."""
        self.launches += 1
        self.by_shape[shape] += 1
