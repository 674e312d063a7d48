"""Build the CUDA kernels in csrc/ with nvcc and bind them with ctypes.

The kernels have a plain C interface (no PyTorch headers), so nvcc builds
each source in seconds; all sources are compiled at once, one nvcc process
each, into one shared library per source.  The libraries are built at
first use into build/ beside this file, each named by a hash of its
source, the shared headers and the flags, so a stale build is never
loaded.  There is no fallback: without nvcc the build raises, and a CUDA
tensor never reaches a plain torch version.

    python -c "from tpu_smatcher_torch import _build; _build.load()"
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import types

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: source -> {C function: argument types}; every function returns a
#: cudaError_t as int (0 = launched)
SOURCES = {
    "exact_count.cu": {
        # (text, n, m, bits, sigma, guard, bitmap, nwords, out, device,
        #  stream)
        "tsm_exact_count": [_vp, _i64, _i32, _i32, _i32, _i32, _vp, _i32,
                            _vp, _i32, _vp],
        # (text, n, m, bits, sigma, bitmap, nwords, mask, rows, device,
        #  stream)
        "tsm_exact_mask": [_vp, _i64, _i32, _i32, _i32, _vp, _i32, _vp, _i64,
                           _i32, _vp]},
    # (text, n, m, bitmaps, kt, stage_bits, k1, cd, slots, rows, ovf,
    #  device, stream)
    "cascade.cu": {"tsm_cascade": [_vp, _i64, _i32, _vp, _i32, _i32, _i32,
                                   _vp, _vp, _i64, _vp, _i32, _vp]},
    "filter.cu": {
        # (text, n, m, bitmaps, k, stage_bits, cd, mask, rows, device,
        #  stream)
        "tsm_filter_mask": [_vp, _i64, _i32, _vp, _i32, _i32, _vp, _vp,
                            _i64, _i32, _vp],
        # (text, n, m, bitmaps, k, stage_bits, cd, pos, counts, n_sub,
        #  device, stream)
        "tsm_filter_slots": [_vp, _i64, _i32, _vp, _i32, _i32, _vp, _vp,
                             _vp, _i64, _i32, _vp]},
    # (text, n, out, nw, device, stream)
    "words.cu": {"tsm_words_view": [_vp, _i64, _vp, _i64, _i32, _vp]},
    # (slots, rows, ovf, counts, n_tiles, idxs, cap, n_cand, overflow,
    #  device, stream)
    "compact.cu": {"tsm_compact_rows": [_vp, _i64, _vp, _vp, _i64, _vp,
                                        _i64, _vp, _vp, _i32, _vp]},
    # (text, n, m, idxs, cap, n_cand, bucket_ids, bucket_fp2, lmax, eb,
    #  slot_ok, packed, words, count, device, stream)
    "verify.cu": {"tsm_verify_live": [_vp, _i64, _i32, _vp, _i64, _vp, _vp,
                                      _vp, _i32, _i32, _i32, _vp, _i32, _vp,
                                      _i32, _vp]},
    # (text, n, m, sigma, guard, mode, desc, tables, n_stages, cd, out0,
    #  out1, n_out, device, stream)
    "stages.cu": {"tsm_stages": [_vp, _i64, _i32, _i32, _i32, _i32, _vp, _vp,
                                 _i32, _vp, _vp, _vp, _i64, _i32, _vp]},
}

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    """nvcc on PATH, else $CUDA_HOME/bin/nvcc (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = (os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
            or "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.access(cand, os.X_OK):
        return cand
    raise RuntimeError(
        "nvcc not found (not on PATH, nor at $CUDA_HOME/bin/nvcc): the "
        "CUDA kernels of tpu_smatcher_torch cannot be built")


def _lib_path(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, source),
                 *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"libtsm_{stem}_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> dict:
    """Compile every csrc/*.cu not yet built, all nvcc processes at once;
    returns {source: library path}.  verbose adds -Xptxas -v and prints
    nvcc's output."""
    paths = {s: _lib_path(s) for s in SOURCES}
    todo = [s for s, p in paths.items() if verbose or not os.path.exists(p)]
    if not todo:
        return paths
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for s in todo:
        tmp = f"{paths[s]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, os.path.join(CSRC, s)]
        procs.append((s, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for s, tmp, cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
            continue
        if verbose:
            print(f"{s}:\n{out}", flush=True)
        os.replace(tmp, paths[s])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load():
    """The bound kernel functions (one attribute per C function), built at
    first use."""
    global _lib
    with _lock:
        if _lib is None:
            fns = {}
            for source, path in build().items():
                lib = ctypes.CDLL(path)
                for name, argtypes in SOURCES[source].items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = _i32
                    fns[name] = fn
            _lib = types.SimpleNamespace(**fns)
        return _lib
