"""Engine facade of the PyTorch port (port of tpu_smatcher/engines.py:19-116):
one constructor per algorithm of the reference (smatcher.h:89-133), and the
shared fast backend.

Every entry point runs on its tables' device, device="cuda" unless the
caller asks for the CPU; there is no implicit fallback.
"""

from __future__ import annotations

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
                            tile: int = DEFAULT_TILE):
    """The named engine over prebuilt tables (build_tables), on `device`.
    lanes/q apply to ac, tile to the filter engines and 'fast'."""
    from tpu_smatcher_torch.ops.ac import ACScanner
    from tpu_smatcher_torch.ops.filters import (SBOMScanner, SHScanner,
                                                SOGScanner, WMScanner)
    dev = _device(device)
    main = tables["main"]
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
        return FastScanner(main, tile=tile)
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
