"""Host-side table builders of the named engines: the port's copy of
tpu_smatcher/automata/{ac,sh,sbom,wu,sog,verify,bm,kmp}.py.  build_ac,
build_sh, build_sbom, build_wm and build_sog build with the native library
(tpu_smatcher_torch/native) where it loads and with numpy otherwise, to
equal tables.  Each dataclass holds numpy arrays, so a table the JAX
package built converts field for field."""

from tpu_smatcher_torch.automata.ac import ACTables, build_ac, multi_step_tables
from tpu_smatcher_torch.automata.bm import pre_bm_bc
from tpu_smatcher_torch.automata.kmp import kmp_count, pre_kmp
from tpu_smatcher_torch.automata.sbom import SBOMTables, build_sbom
from tpu_smatcher_torch.automata.sh import SHTables, build_sh
from tpu_smatcher_torch.automata.sog import SOG_B, SOGTables, build_sog
from tpu_smatcher_torch.automata.verify import VerifyTables, build_verify
from tpu_smatcher_torch.automata.wu import WMTables, build_wm

__all__ = [
    "pre_kmp", "kmp_count", "pre_bm_bc",
    "ACTables", "build_ac", "multi_step_tables",
    "SHTables", "build_sh",
    "SBOMTables", "build_sbom",
    "WMTables", "build_wm",
    "SOG_B", "SOGTables", "build_sog",
    "VerifyTables", "build_verify",
]
