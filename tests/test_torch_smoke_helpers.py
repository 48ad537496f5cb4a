"""Helpers of ``chip_smoke.py`` that run without a card: the kernel names
it reads from ``ptxas`` reports, and the bounds it sets beside each
kernel's time."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

H100 = chip_smoke.card_peaks("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("symbol, key", [
    ("_ZN12_GLOBAL__N_114flash_fwd_tf32ILi48ELb1EEEvPKfS2_S2_PKiPfS4_iiiNS_7StridesEf",
     "flash_fwd_lse_d48_f32"),
    ("_ZN12_GLOBAL__N_114flash_fwd_tf32ILi32ELb0EEEvPKfS2_S2_PKiPfS4_iiiNS_7StridesEf",
     "flash_fwd_infer_d32_f32"),
    ("_ZN12_GLOBAL__N_19dkdv_tf32ILi64EEEvPKfS2_S2_PKiS2_S2_S2_PfS4_iiiNS_7StridesEf",
     "flash_bwd_d64 (dkdv)_f32"),
    ("_ZN12_GLOBAL__N_17dq_tf32ILi48EEEvPKfS2_S2_PKiS2_S2_S2_Pfiii", "flash_bwd_d48 (dq)_f32"),
    ("_ZN12_GLOBAL__N_113flash_fwd_mmaILi64ELb0EEEvPK13__nv_bfloat16", "flash_fwd_infer_d64"),
    ("_ZN12_GLOBAL__N_18dkdv_mmaILi32EEEvPK13__nv_bfloat16", "flash_bwd_d32 (dkdv)")])
def test_ptxas_key_names_every_flash_instance(symbol, key):
    assert chip_smoke._ptxas_key(symbol) == key


def test_f32_bound_names_both_rates():
    """f32 work: FMA on the CUDA cores (67 TFLOP/s) and 3xTF32 on the tensor
    cores (3 x FLOP at 495 TFLOP/s), the smaller being the bound; bf16 work
    has one bound and no names."""
    flops, nbytes = 1e12, 1e6
    ms, by, named = chip_smoke.bound(flops, nbytes, H100, torch.float32)
    assert named["bound_fma_ms"] == pytest.approx(1e3 / 67)
    assert named["bound_3xtf32_ms"] == pytest.approx(3e3 / 495)
    assert (ms, by) == (named["bound_3xtf32_ms"], "operations")
    assert chip_smoke.bound(flops, nbytes, H100)[1:] == ("operations", {})
    # few operations on many bytes: the memory rate bounds every name
    ms, by, named = chip_smoke.bound(1e3, 1e12, H100, torch.float32)
    assert by == "bytes" and ms == named["bound_fma_ms"] == named["bound_3xtf32_ms"]
