"""Engine facade of the PyTorch port (port of tpu_smatcher/engines.py):
one constructor per algorithm of the reference (smatcher.h:89-133), the
shared fast backend, and the mixed-length scanner over either.

Every entry point runs on its tables' device, device="cuda" unless the
caller asks for the CPU; there is no implicit fallback.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpu_smatcher_torch.automata import (build_ac, build_sbom, build_sh,
                                         build_sog, build_verify, build_wm)
from tpu_smatcher_torch.core.patterns import PatternSet
from tpu_smatcher_torch.ops.filters import DEFAULT_TILE

ENGINE_NAMES = ("ac", "sh", "sbom", "wm", "sog8", "sog16", "sog32")


def _codes(patterns) -> tuple[np.ndarray, int]:
    if isinstance(patterns, PatternSet):
        return patterns.codes, patterns.sigma
    raise TypeError("make_engine / make_fast expect a PatternSet")


def _device(device) -> torch.device:
    """The device, with its index: tensors report cuda:0, not cuda."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but CUDA is not available; "
                               "pass device='cpu' for the plain torch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _unknown(name):
    return ValueError(f"unknown engine {name!r}; expected one of "
                      f"{ENGINE_NAMES}")


def build_tables(name: str, patterns: PatternSet, *, device="cuda") -> dict:
    """Preprocessing only: the named engine's table dataclasses (numpy), as
    a dict with key 'main' and, for the verifying engines, 'verify'.  name
    may also be 'fast', whose tables (build_fast) go to `device`."""
    codes, sigma = _codes(patterns)
    if name == "ac":
        return {"main": build_ac(codes, sigma)}
    if name == "sh":
        return {"main": build_sh(codes, sigma)}
    if name == "sbom":
        return {"main": build_sbom(codes, sigma),
                "verify": build_verify(codes, sigma)}
    if name == "wm":
        return {"main": build_wm(codes, sigma),
                "verify": build_verify(codes, sigma)}
    if name in ("sog8", "sog16", "sog32"):
        return {"main": build_sog(codes, sigma, int(name[3:])),
                "verify": build_verify(codes, sigma)}
    if name == "fast":
        from tpu_smatcher_torch.ops.fast import build_fast
        return {"main": build_fast(codes, sigma, device=_device(device))}
    raise _unknown(name)


def make_engine_from_tables(name: str, tables: dict, *, device="cuda",
                            lanes: int = 8192, q: int = 1,
                            tile: int = DEFAULT_TILE, **opts):
    """The named engine over prebuilt tables (build_tables, or
    core.checkpoint.load_tables), on `device`.  lanes/q apply to ac, tile
    to the filter engines and 'fast'; opts (cap) to 'fast' only, whose
    tables must already lie on `device` (they are never moved)."""
    from tpu_smatcher_torch.ops.ac import ACScanner
    from tpu_smatcher_torch.ops.filters import (SBOMScanner, SHScanner,
                                                SOGScanner, WMScanner)
    dev = _device(device)
    main = tables["main"]
    if opts and name != "fast":
        raise TypeError(f"options {sorted(opts)} apply to 'fast' only")
    if name == "ac":
        return ACScanner(main, lanes=lanes, q=q, device=dev)
    if name == "sh":
        return SHScanner(main, tile=tile, device=dev)
    if name == "sbom":
        return SBOMScanner(main, tables["verify"], tile=tile, device=dev)
    if name == "wm":
        return WMScanner(main, tables["verify"], tile=tile, device=dev)
    if name in ("sog8", "sog16", "sog32"):
        return SOGScanner(main, tables["verify"], tile=tile, device=dev)
    if name == "fast":
        from tpu_smatcher_torch.ops.fast import FastScanner
        if main.device != dev:
            raise ValueError(f"fast tables on {main.device}, engine asked "
                             f"for {dev}: load them with device={dev}")
        return FastScanner(main, tile=tile, **opts)
    raise _unknown(name)


def attach_fastpath(scanner, name: str, patterns: np.ndarray, sigma: int):
    """Attach the engine's production path (ops/cuda_engines.py) on the
    scanner's device; the portable scan stays the path for patterns longer
    than the kernels take."""
    from tpu_smatcher_torch.ops.cuda_engines import EngineFastPath
    kw = {}
    if name == "wm":
        kw["shift_ext"] = scanner.shift_ext.cpu().numpy()
    elif name.startswith("sog"):
        kw["t_table"] = scanner.t_table.cpu().numpy()
    kind = "sog" if name.startswith("sog") else name
    scanner.fast_path = EngineFastPath(kind, patterns, sigma,
                                       device=scanner.device, **kw)
    return scanner


def make_engine(name: str, patterns: PatternSet, *, device="cuda",
                lanes: int = 8192, q: int = 1, tile: int = DEFAULT_TILE,
                fastpath: bool = True):
    """The named engine over the pattern set, on `device`.

    name: one of ENGINE_NAMES (or 'fast').  lanes/q apply to ac, tile to
    the filter engines.  fastpath attaches the engine's stage-chain path
    (the hand-written kernel on the card, its plain version on the CPU);
    without it every count runs the portable scan."""
    dev = _device(device)
    eng = make_engine_from_tables(name, build_tables(name, patterns,
                                                     device=dev),
                                  device=dev, lanes=lanes, q=q, tile=tile)
    codes, sigma = _codes(patterns)
    if fastpath and name != "fast":
        attach_fastpath(eng, name, codes, sigma)
    # for matches() / count_per_pattern() (ops.common.attr_scanner)
    eng.pattern_codes = np.asarray(codes, np.uint8)
    eng.pattern_sigma = sigma
    return eng


def make_fast(patterns: PatternSet, *, device="cuda", **opts):
    """The shared fast backend on `device` (no implicit fallback to the
    CPU): hand-written CUDA kernels on a CUDA device, their plain torch
    versions on the CPU.  opts: n_stages (table build), tile, cap."""
    from tpu_smatcher_torch.ops.fast import FastScanner, build_fast
    dev = _device(device)
    codes, sigma = _codes(patterns)
    n_stages = opts.pop("n_stages", None)
    return FastScanner(build_fast(codes, sigma, n_stages=n_stages,
                                  device=dev), **opts)


def make_distributed(name: str, patterns: PatternSet, mesh, *,
                     device="cuda", **opts):
    """Distributed engine over the ranks of `mesh` (parallel.make_mesh):
    tables built on every rank, text sharded with a halo exchange, count
    all-reduced (parallel/dist.py).  `device` is the mesh's device type; the
    engine goes to this rank's device (mesh.device).  name: 'fast' (opts:
    make_fast's) or one of ENGINE_NAMES (opts: make_engine's).

    The per-shard scan is the fast path when one is active (FastScanner's
    core, or the engine's EngineFastPath.core), else the engine's portable
    core; a FastScanner over the same tables rides along as the exact
    overflow ladder, so counts are TOTAL at any match density (every engine
    counts the same windows).  The JAX package has no active fast path off
    the TPU and attaches no ladder there; the port's runs on the CPU too,
    through the plain versions, with the same counts."""
    from tpu_smatcher_torch.ops.common import active_fastpath
    from tpu_smatcher_torch.parallel.dist import DistributedCounter
    if torch.device(device).type != mesh.device.type:
        raise ValueError(f"device={device!r} but the mesh's rank runs on "
                         f"{mesh.device}")
    if name == "fast":
        eng = make_fast(patterns, device=mesh.device, **opts)
        core, fast = eng.core, eng
    else:
        eng = make_engine(name, patterns, device=mesh.device, **opts)
        fp = active_fastpath(eng)
        core = eng.core if fp is None else fp.core
        fast = None if fp is None else fp._fallback_scanner()
    return DistributedCounter(core, mesh, m=patterns.m, sigma=patterns.sigma,
                              fast=fast)


# ---------------------------------------------------------------------------
# mixed lengths
# ---------------------------------------------------------------------------

class _MixedFuture:
    """In-flight mixed-length scan: one sub-future per length group; the
    host reads happen only at result(), and the groups' int32 counts are
    summed as a python int, never on the device."""

    def __init__(self, futures):
        self._futures = futures

    def result(self) -> int:
        return sum(f.result() for f in self._futures)


class MixedScanner:
    """Mixed-length matching: one sub-scanner per distinct pattern length,
    all scanning one uint8 tensor on the device, results combined.

    count() is the sum of each length's windows-with-a-match count (one
    run per length would report the same); positions() / matches() merge
    the per-length enumerations, with global pattern ids.  count_async
    enqueues every group before any host read."""

    def __init__(self, patterns, scanners):
        self.patterns = patterns
        self.scanners = list(scanners)
        self.lengths = patterns.lengths
        self.device = self.scanners[0].device

    def _text(self, text) -> torch.Tensor:
        """One uint8 tensor on the device, shared by every group's
        sub-scan: a host array is uploaded once."""
        from tpu_smatcher_torch.ops.fast import device_text
        return device_text(text, self.device)

    def count_async(self, text) -> _MixedFuture:
        text = self._text(text)
        return _MixedFuture([s.count_async(text) for s in self.scanners])

    def count(self, text) -> int:
        return self.count_async(text).result()

    def scan_many(self, texts) -> list:
        futures = [self.count_async(t) for t in texts]
        return [f.result() for f in futures]

    def positions(self, text):
        """(starts, lengths) int64: every match start with the matched
        pattern length, sorted by (start, length).  A start matching two
        lengths appears once per length."""
        text = self._text(text)
        starts, lens = [], []
        for m, s in zip(self.lengths, self.scanners):
            pos = np.asarray(s.positions(text), np.int64)
            starts.append(pos)
            lens.append(np.full(pos.shape, m, np.int64))
        return _by_start(np.concatenate(starts), np.concatenate(lens))

    def matches(self, text):
        """(starts, pattern_ids) int64: global ids into the mixed set,
        sorted by (start, id); a start matching two lengths appears once
        per length."""
        text = self._text(text)
        starts, ids = [], []
        for gids, s in zip(self.patterns.ids, self.scanners):
            pos, local = s.matches(text)
            starts.append(np.asarray(pos, np.int64))
            ids.append(gids[np.asarray(local, np.int64)])
        return _by_start(np.concatenate(starts), np.concatenate(ids))

    def count_per_pattern(self, text) -> np.ndarray:
        """(p_size,) int64 match-start counts per global pattern id
        (duplicates within a group credit the smallest id, as matches()
        does); they sum to count(text)."""
        _, ids = self.matches(text)
        return np.bincount(ids, minlength=self.patterns.p_size).astype(
            np.int64)

    def _file_pieces(self, path: str, chunk: int):
        """(start, [(scanner, piece view)]) over a pre-encoded corpus file,
        read once.  The pieces follow the shortest length's grid (shorter
        groups own starts past the longest group's last piece) and are
        read with the longest length's halo; each piece is uploaded once,
        and group g takes its first chunk + m_g - 1 bytes, so each group's
        starts partition exactly.  A group with no start left in a piece
        skips it."""
        size = os.path.getsize(path)
        m_min, m_max = self.lengths[0], self.lengths[-1]
        mm = np.memmap(path, dtype=np.uint8, mode="r")
        for start in range(0, max(size - m_min + 1, 1), chunk):
            piece = mm[start:min(size, start + chunk + m_max - 1)]
            pdev = self._text(piece)
            yield start, [(s, pdev[:min(pdev.shape[0], chunk + m - 1)])
                          for m, s in zip(self.lengths, self.scanners)
                          if start <= size - m]

    def count_file(self, path: str, *, chunk: int = 1 << 28,
                   depth: int = 3) -> int:
        """Count of a pre-encoded corpus file, streamed in pieces
        (_file_pieces), up to `depth` pieces' scans in flight."""
        total = 0
        inflight = []
        for _, views in self._file_pieces(path, chunk):
            for s, view in views:
                inflight.append(s.count_async(view))
                if len(inflight) >= depth * len(self.scanners):
                    total += inflight.pop(0).result()
        return total + sum(f.result() for f in inflight)

    def positions_file(self, path: str, *, chunk: int = 1 << 28):
        """(starts, lengths) int64 of a pre-encoded corpus file, streamed
        in the pieces of count_file; offsets accumulate in int64, so files
        of 2^31 bytes and more stream too."""
        out_s, out_l = [], []
        for start, views in self._file_pieces(path, chunk):
            for s, view in views:
                pos = np.asarray(s.positions(view), np.int64)
                out_s.append(pos + start)
                out_l.append(np.full(pos.shape, s.m, np.int64))
        if not out_s:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        return _by_start(np.concatenate(out_s), np.concatenate(out_l))


def _by_start(starts: np.ndarray, keys: np.ndarray):
    """(starts, keys) sorted by (start, key)."""
    order = np.lexsort((keys, starts))
    return starts[order], keys[order]


def make_mixed(patterns, engine: str = "fast", *, device="cuda",
               **opts) -> MixedScanner:
    """Scanner over a MixedPatternSet on `device`: `engine` names the
    sub-scanner family ('fast' or one of ENGINE_NAMES), built once per
    distinct pattern length with opts (make_fast's or make_engine's).  An
    engine that cannot take one of the lengths (sog8 takes m = 8 only)
    raises."""
    from tpu_smatcher_torch.core.patterns import MixedPatternSet
    if not isinstance(patterns, MixedPatternSet):
        raise TypeError("make_mixed expects a MixedPatternSet "
                        "(PatternSet sets are uniform: use make_engine)")
    dev = _device(device)
    if engine == "fast":
        scanners = [make_fast(g, device=dev, **opts) for g in patterns.groups]
    else:
        scanners = [make_engine(engine, g, device=dev, **opts)
                    for g in patterns.groups]
    return MixedScanner(patterns, scanners)
