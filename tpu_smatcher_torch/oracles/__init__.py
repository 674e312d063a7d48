"""Conformance oracles of the port (the port's copy of
tpu_smatcher/oracles): plain Python scans with the reference's counting
semantics, a truth independent of the engines' tables."""

from tpu_smatcher_torch.oracles.reference import (
    ORACLES,
    oracle_ac,
    oracle_sbom,
    oracle_sh,
    oracle_sog,
    oracle_sog8,
    oracle_sog16,
    oracle_sog32,
    oracle_wm,
)

__all__ = ["oracle_ac", "oracle_sh", "oracle_sbom", "oracle_wm",
           "oracle_sog", "oracle_sog8", "oracle_sog16", "oracle_sog32",
           "ORACLES"]
