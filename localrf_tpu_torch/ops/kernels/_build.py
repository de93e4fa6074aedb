"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `.cu` file under `localrf_tpu_torch/csrc/` is compiled by hand into
ONE shared library with a plain C interface (no PyTorch headers, so the
build takes seconds), for `sm_90a` (Hopper). The library lands in
`build/kernels/` at the repository root, named by a hash of the sources and
flags, so an edit rebuilds and an unchanged tree reuses the file. Nothing is
built or loaded at import time: the first kernel launch builds.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `launch` raises if that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"

# no --use_fast_math: __expf and flushed denormals would change 1 - exp(-x)
# for small x in the compositing kernel
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# C entry points: name -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    # sigma, dists, w, R, S, dist_row_stride, scale, stream
    "lrf_composite_fwd": (_P, _P, _P, _I, _I, _I, _F, _P),
    # sigma, dists, g, dsigma, R, S, dist_row_stride, scale, stream
    "lrf_composite_bwd": (_P, _P, _P, _P, _I, _I, _I, _F, _P),
    # idx (int64), P, n_rows, tile_rows, n_tiles, chunk, counts (zeroed),
    # starts, cursor, slot_base, items, empty, totals, bin (int32), stream
    "lrf_segment_sum_bin": (_P, _L, _L, _I, _I, _I) + (_P,) * 9,
    # g, g_is_bf16, vec, bin, starts, slot_base, items, empty, totals, done
    # (zeroed), partials (f32), out, out_is_bf16, C, n_rows, tile_rows,
    # n_tiles, chunk, n_items_max, stream
    "lrf_segment_sum_reduce": (_P, _I, _I) + (_P,) * 9 + (_I, _I, _L, _I, _I, _I, _L, _P),
    # idx, idx_is_i64, g, g_is_bf16, vec, out, out_is_bf16, P, C, n_rows, shift,
    # n_tiles, range_len, n_ranges, workspace, workspace_len, tile_start, bins,
    # scratch, seg_cap, stream
    "lrf_segment_sum_merged": (_P, _I, _P, _I, _I, _P, _I, _L, _I, _L, _I, _I, _L, _I, _P, _L)
    + (_P,) * 3 + (_I, _P),
    # n_tiles, n_ranges -> ints of K5's workspace (int64), -1 past its limits
    "lrf_segment_sum_merged_workspace": (_I, _I),
    # idx (int64), g, g_is_bf16, partials (f32), out (f32), P, C, n_rows,
    # tile_rows, n_ranges, range_len, stream
    "lrf_segsum_small": (_P, _P, _I, _P, _P, _L, _I, _L, _I, _I, _L, _P),
    # rows0, rows1, rows2, wxy, w1l, x0, vd, lines, basis, w1, b1, w2, b2, w3,
    # b3, out, P, G, t_bf16, m_bf16, SM count, stream
    "lrf_march_fwd": (_P,) * 16 + (_L, _I, _I, _I, _I, _P),
    # the 15 inputs above, gout, drows0, drows1, drows2, d_wxy, d_w1l,
    # dlines (f32), d_feat (scratch [P, 72], table dtype), partials (scratch, f32
    # [n_blocks, n_params]), dparams, P, G, t_bf16, m_bf16, n_blocks, stream
    "lrf_march_bwd": (_P,) * 25 + (_L, _I, _I, _I, _I, _P),
    # -> length of the march backward's packed parameter gradient
    "lrf_march_n_params": (),
}

# entry points that return a value, not an error code
RESTYPES = {"lrf_segment_sum_merged_workspace": ctypes.c_int64}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}  # path, seconds, log of the build this process loaded


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH):"
            " the CUDA kernels are built from csrc/ at first use"
        )
    return found


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    """Hash of every kernel source and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into build/kernels/liblocalrf_kernels_<hash>.so unless
    that file already exists; raises with nvcc's output if the build fails.
    Each source compiles to an object in its own nvcc process, all started
    together, then one nvcc links the library."""
    out = BUILD_DIR / f"liblocalrf_kernels_{source_hash()}.so"
    if out.is_file():
        build_info.update(path=str(out), seconds=0.0, log="(cached)")
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    cu = [p for p in sources() if p.suffix == ".cu"]
    compile_flags = tuple(f for f in NVCC_FLAGS if f != "-shared")
    t0 = time.perf_counter()
    procs = [
        (src, subprocess.Popen(
            [nvcc, *compile_flags, "-c", "-o", str(work / f"{src.stem}.o"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
        for src in cu
    ]
    logs, failed = [], []
    for src, proc in procs:
        text = proc.communicate()[0]
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    tmp = work / "lib.so"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(work / f"{s.stem}.o") for s in cu)]
    if not failed:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append("link")
    seconds = time.perf_counter() - t0
    log = "\n".join(logs)
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    shutil.rmtree(work, ignore_errors=True)
    (BUILD_DIR / f"{out.stem}.log").write_text(log)
    build_info.update(path=str(out), seconds=seconds, log=log)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = RESTYPES.get(name, ctypes.c_int)
            lib.lrf_error_string.argtypes = [ctypes.c_int]
            lib.lrf_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, *args) -> None:
    """Call C entry `name`; raise if it reports a CUDA error."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.lrf_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
