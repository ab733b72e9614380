"""chip_smoke.py's kernel names for phase 15a's per-kernel split
(``kernel_key``): a profiler trace names a kernel demangled or mangled,
and both must give the same key (the function without namespaces,
parameters or template arguments; ``gemm_sm90`` with its epilogue, which
tells K2f's two products and K2b's dxn from the split-K weight products).
"""

import importlib.util
from pathlib import Path

import pytest

_PATH = Path(__file__).resolve().parent.parent / "chip_smoke.py"


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_names", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name, key", [
    ("void sm90::gemm_sm90<true, true, sm90::EpiSlot, swin::K2b, 128, "
     "false>(CUtensorMap_st, CUtensorMap_st, sm90::GemmDims, sm90::EpiSlot)",
     "gemm_sm90[EpiSlot]"),
    ("_ZN4sm909gemm_sm90ILb0ELb1ENS_9EpiOutF32EN4swin3K2bELi128ELb1EEEv14"
     "CUtensorMap_stS4_NS_8GemmDimsET1_", "gemm_sm90[EpiOutF32]"),
    ("_ZN4sm909gemm_sm90ILb0ELb0EN4swin15EpiResidualBf16ENS1_3K2fELi96ELb1"
     "EEEv14CUtensorMap_stS4_NS_8GemmDimsET1_", "gemm_sm90[EpiResidualBf16]"),
    ("swin::mlp_dual_wide_sm90(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, swin::DualArgs, int, int)",
     "mlp_dual_wide_sm90"),
    ("_ZN4swin18mlp_dual_wide_sm90E14CUtensorMap_stS0_S0_S0_NS_8DualArgsEii",
     "mlp_dual_wide_sm90"),
    ("void swin::ln_rows_bf16<swin::K2f, 4>(__nv_bfloat16 const*, float "
     "const*, float const*, __nv_bfloat16*, float*, float*, long long, int)",
     "ln_rows_bf16"),
    ("_ZN4swin12reduce_slotsINS_3K2bEEEvPKfPfix", "reduce_slots"),
])
def test_kernel_key(chip_smoke, name, key):
    assert chip_smoke.kernel_key(name) == key
