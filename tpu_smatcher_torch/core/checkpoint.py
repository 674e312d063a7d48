"""Table checkpoints (the port's copy of tpu_smatcher/core/checkpoint.py):
built tables saved to one .npz and loaded back, so a scan skips the build.

The file layout is the JAX package's, so either package reads the other's
files: each table's array fields are npz entries "<name>/<field>", a tuple
of arrays is "<name>/<field>.<i>" (field kind "tuple:k"), and a JSON header
("__header__") holds each table's class name, its fields in dataclass
order with their kinds, and its scalar (and None) fields.  The port's
FastTables holds its stage bitmaps as one (k, stage_bits/32) tensor; it is
written as the JAX package's k arrays of shape (stage_bits/4096, 128) and
read back through FastTables.from_numpy.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

#: checkpointable table classes, by class name
_REGISTRY = {}

#: the lane width of the JAX package's bitmap arrays, (B, 128) int32
_LANES = 128


def _classes() -> dict:
    if not _REGISTRY:
        from tpu_smatcher_torch.automata import (ACTables, SBOMTables,
                                                 SHTables, SOGTables,
                                                 VerifyTables, WMTables)
        from tpu_smatcher_torch.ops.fast import FastTables
        for cls in (ACTables, SHTables, SBOMTables, WMTables, SOGTables,
                    VerifyTables, FastTables):
            _REGISTRY[cls.__name__] = cls
    return _REGISTRY


def _is_array(v) -> bool:
    return hasattr(v, "shape") and hasattr(v, "dtype")


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _json_scalar(v):
    """numpy scalars in a header as python numbers."""
    if isinstance(v, np.generic):
        return v.item()
    raise TypeError(f"not a JSON scalar: {type(v).__name__}")


def _fields(tb) -> list:
    """(name, value) of each field in dataclass order, in the JAX
    package's layout: FastTables' bitmaps as a tuple of (B, 128) arrays."""
    out = []
    for f in dataclasses.fields(tb):
        v = getattr(tb, f.name)
        if f.name == "bitmaps" and isinstance(v, torch.Tensor):
            v = tuple(row.reshape(-1, _LANES) for row in _host(v))
        out.append((f.name, v))
    return out


def save_tables(path, tables) -> None:
    """Serialize one table dataclass (or a dict of name -> dataclass)."""
    if not isinstance(tables, dict):
        tables = {"tables": tables}
    arrays = {}
    header = {}
    for name, tb in tables.items():
        cls = type(tb).__name__
        if cls not in _classes():
            raise TypeError(f"not a checkpointable table class: {cls}")
        scalars = {}
        fields = []
        for fname, v in _fields(tb):
            if _is_array(v):
                arrays[f"{name}/{fname}"] = _host(v)
                fields.append([fname, "array"])
            elif isinstance(v, tuple) and all(_is_array(x) for x in v):
                for i, x in enumerate(v):
                    arrays[f"{name}/{fname}.{i}"] = _host(x)
                fields.append([fname, f"tuple:{len(v)}"])
            else:
                scalars[fname] = v
                fields.append([fname, "scalar"])
        header[name] = {"class": cls, "fields": fields, "scalars": scalars}
    arrays["__header__"] = np.frombuffer(
        json.dumps(header, default=_json_scalar).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_tables(path, *, device="cuda"):
    """Inverse of save_tables: the dataclass (or dict of them).  A
    FastTables is built on `device` (FastTables.from_numpy); the numpy
    table classes stay numpy."""
    from tpu_smatcher_torch.engines import _device
    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        out = {}
        for name, spec in header.items():
            cls = _classes()[spec["class"]]
            kw = dict(spec["scalars"])
            for fname, kind in spec["fields"]:
                if kind == "array":
                    kw[fname] = z[f"{name}/{fname}"]
                elif kind.startswith("tuple:"):
                    k = int(kind.split(":")[1])
                    kw[fname] = tuple(z[f"{name}/{fname}.{i}"]
                                      for i in range(k))
            if cls.__name__ == "FastTables":
                out[name] = cls.from_numpy(kw, _device(device))
            else:
                out[name] = cls(**kw)
    return out["tables"] if list(out) == ["tables"] else out
