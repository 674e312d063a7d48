"""ctypes bindings for the port's native host code (builders.cpp): the
table builders of the named engines, the threaded CPU ground-truth count
and match enumerator, and the FASTA encoder.

The library is compiled at first use with the host C++ compiler ($CXX, else
g++) into build/ beside the package, named by a hash of the source and the
flags.  Each build writes a temporary file of its own in that directory and
renames it into place, so processes that load at once (test workers, ranks)
never load a half-written library.  No CUDA toolkit is needed.

`load()` returns None when the library is unavailable (no compiler, a
failed build, or TPU_SMATCHER_NO_NATIVE set); every wrapper then returns
None and its caller takes its numpy path.  `build()` raises instead, with
the compiler's output.

    python -c "from tpu_smatcher_torch import native; print(native.build())"
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "builders.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
#: the reference Makefile's flags
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib = None
_tried = False

_i8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64


def _configure(lib):
    lib.tpu_build_ac.restype = _i64
    lib.tpu_build_ac.argtypes = [_i8p] + [_i64] * 3 + [_i32p, _i32p, _i8p,
                                                       _i32p, _i32p]
    lib.tpu_build_sh.restype = _i64
    lib.tpu_build_sh.argtypes = [_i8p] + [_i64] * 3 + [_i32p, _i8p, _i32p]
    lib.tpu_build_sbom.restype = _i64
    lib.tpu_build_sbom.argtypes = [_i8p] + [_i64] * 3 + [_i32p] * 4
    lib.tpu_encode_fasta.restype = _i64
    lib.tpu_encode_fasta.argtypes = [_i8p, _i64, _i8p, _i8p]
    lib.tpu_count_cpu.restype = _i64
    lib.tpu_count_cpu.argtypes = [_i8p, _i64, _i8p, _i64, _i64]
    lib.tpu_build_wm_shift.restype = _i64
    lib.tpu_build_wm_shift.argtypes = [_i8p] + [_i64] * 4 + [_i32p] * 3
    lib.tpu_fill_wm_prefix.restype = _i64
    lib.tpu_fill_wm_prefix.argtypes = ([_i8p] + [_i64] * 2 + [_i32p]
                                       + [_i64] * 2 + [_i32p, _i32p])
    lib.tpu_build_sog.restype = _i64
    lib.tpu_build_sog.argtypes = [_i8p] + [_i64] * 4 + [_u32p]
    lib.tpu_match_enum.restype = _i64
    lib.tpu_match_enum.argtypes = [_i8p, _i64, _i8p, _i64, _i64, _i64p,
                                   _i32p, _i64]
    return lib


def _lib_path() -> str:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtsm_native_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile builders.cpp unless its library exists; returns the
    library's path.  Raises RuntimeError with the compiler's output when
    the build fails, OSError when there is no compiler."""
    path = _lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [os.environ.get("CXX") or "g++", *CXX_FLAGS, "-o", tmp, SOURCE]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, path)      # atomic: a reader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load():
    """The configured ctypes library, built at first use; None if
    unavailable (no compiler, a failed build, or TPU_SMATCHER_NO_NATIVE
    set).  The outcome is kept for the life of the process."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            if not os.environ.get("TPU_SMATCHER_NO_NATIVE"):
                try:
                    _lib = _configure(ctypes.CDLL(build()))
                except (OSError, RuntimeError, subprocess.SubprocessError):
                    _lib = None
        return _lib


def build_ac_native(patterns: np.ndarray, sigma: int):
    """(transition, supply, final, delta, depth, n_states) trimmed to the
    used state count, or None if the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    patterns = np.ascontiguousarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    s_max = m * p + 1
    transition = np.empty((s_max, sigma), np.int32)
    supply = np.empty(s_max, np.int32)
    final = np.empty(s_max, np.uint8)
    delta = np.empty((s_max, sigma + 1), np.int32)
    depth = np.empty(s_max, np.int32)
    n = lib.tpu_build_ac(patterns, p, m, sigma, transition, supply, final,
                         delta, depth)
    if n < 0:
        raise ValueError("pattern byte out of range for alphabet")
    n = int(n)
    return (transition[:n].copy(), supply[:n].copy(), final[:n].copy(),
            delta[:n].copy(), depth[:n].copy(), n)


def build_sh_native(patterns: np.ndarray, sigma: int):
    """(transition, final, bmBc, n_states), or None."""
    lib = load()
    if lib is None:
        return None
    patterns = np.ascontiguousarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    s_max = m * p + 1
    transition = np.empty((s_max, sigma), np.int32)
    final = np.empty(s_max, np.uint8)
    bmBc = np.empty(sigma, np.int32)
    n = lib.tpu_build_sh(patterns, p, m, sigma, transition, final, bmBc)
    if n < 0:
        raise ValueError("pattern byte out of range for alphabet")
    n = int(n)
    return transition[:n].copy(), final[:n].copy(), bmBc, n


def build_sbom_native(patterns: np.ndarray, sigma: int):
    """(transition, {state: pattern ids in insertion order}, n_states), or
    None."""
    lib = load()
    if lib is None:
        return None
    patterns = np.ascontiguousarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    s_max = m * p + 1
    transition = np.empty((s_max, sigma), np.int32)
    f_head = np.empty(s_max, np.int32)
    f_pid = np.empty(max(p, 1), np.int32)
    f_next = np.empty(max(p, 1), np.int32)
    n = lib.tpu_build_sbom(patterns, p, m, sigma, transition, f_head, f_pid,
                           f_next)
    if n < 0:
        raise ValueError("pattern byte out of range for alphabet")
    n = int(n)
    F = {}
    heads = f_head[:n]
    for s in np.nonzero(heads >= 0)[0]:
        ids = []
        e = int(heads[s])
        while e >= 0:
            ids.append(int(f_pid[e]))
            e = int(f_next[e])
        F[int(s)] = ids[::-1]           # linked newest first
    return transition[:n].copy(), F, n


def build_wm_native(patterns: np.ndarray, sigma: int, H: int):
    """Wu-Manber tables (shift, prefix_value, prefix_index, prefix_size,
    lmax) in the reference's semantics, or None.  H =
    automata.wu.wm_shiftsize(sigma)."""
    lib = load()
    if lib is None:
        return None
    patterns = np.ascontiguousarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    shift = np.empty(H, np.int32)
    h_last = np.empty(max(p, 1), np.int32)
    prefix_size = np.empty(H, np.int32)
    if lib.tpu_build_wm_shift(patterns, p, m, sigma, H, shift, h_last,
                              prefix_size) < 0:
        raise ValueError("pattern byte out of range (or m < 3)")
    lmax = max(1, int(prefix_size.max(initial=0)))
    prefix_value = np.empty((H, lmax), np.int32)
    prefix_index = np.empty((H, lmax), np.int32)
    if lib.tpu_fill_wm_prefix(patterns, p, m, h_last, H, lmax,
                              prefix_value, prefix_index) < 0:
        raise RuntimeError("WM prefix fill overflow (inconsistent sizes)")
    return shift, prefix_value, prefix_index, prefix_size, lmax


def build_sog_native(patterns: np.ndarray, sigma: int, width: int):
    """SOG's T table ((sigma^3,) uint32), or None."""
    lib = load()
    if lib is None:
        return None
    patterns = np.ascontiguousarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    T = np.empty(sigma ** 3, np.uint32)
    if lib.tpu_build_sog(patterns, p, m, sigma, width, T) < 0:
        raise ValueError("SOG requires m == width in {8,16,32} and in-range "
                         "pattern bytes")
    return T


def encode_fasta_native(raw: np.ndarray, lut: np.ndarray):
    """A FASTA byte stream encoded ('>' header lines skipped, lut[b] == 255
    dropped): raw (n,) uint8, lut (256,) uint8 -> (n_out,) uint8, or
    None."""
    lib = load()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    lut = np.ascontiguousarray(lut, dtype=np.uint8)
    out = np.empty(max(raw.size, 1), np.uint8)
    n = lib.tpu_encode_fasta(raw, raw.size, lut, out)
    return out[:int(n)].copy()


def count_cpu_native(text: np.ndarray, patterns: np.ndarray):
    """The ground-truth count (windows equal to >= 1 pattern), threaded
    over the host's cores (builders.cpp:tpu_count_cpu, the reference's
    multiwm2 CPU path analogue), or None."""
    lib = load()
    if lib is None:
        return None
    text = np.ascontiguousarray(text, dtype=np.uint8)
    patterns = np.ascontiguousarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    return int(lib.tpu_count_cpu(text, text.size, patterns, p, m))


def match_enum_native(text: np.ndarray, patterns: np.ndarray):
    """(positions int64 ascending, pattern ids int64) of every window equal
    to >= 1 pattern, the smallest id where duplicates share a window (the
    attribution of a scanner's matches()), or None.  A threaded bucket +
    memcmp scan (builders.cpp:tpu_match_enum) in place of the O(matches x
    m) numpy datagen.match_ids."""
    lib = load()
    if lib is None:
        return None
    text = np.ascontiguousarray(text, dtype=np.uint8)
    patterns = np.ascontiguousarray(patterns, dtype=np.uint8)
    p, m = patterns.shape
    total = int(lib.tpu_count_cpu(text, text.size, patterns, p, m))
    pos = np.empty(total, np.int64)
    ids = np.empty(total, np.int32)
    got = int(lib.tpu_match_enum(text, text.size, patterns, p, m,
                                 pos, ids, total))
    if got != total:            # cannot happen: the same match predicate
        raise AssertionError(f"native enum {got} != count {total}")
    return pos, ids.astype(np.int64)
