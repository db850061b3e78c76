"""The benchmark's copies of the program's bound counts reproduce PERF.md's
kernel table (its Bound column) at the table's shapes."""

import pytest

from wtvbench import roofline as r


def ms(s):
    return 1e3 * s


@pytest.mark.parametrize("T,call,want", [
    (3072, "fwd", 0.2736), (3072, "dkv", 0.5472), (3072, "dq", 0.4104),
    (768, "fwd", 0.0171), (768, "dkv", 0.0342), (768, "dq", 0.0256)])
def test_flash_bf16_bounds(T, call, want):
    got = r.flash_bound_s(16, 2, T, 224, 2, *r.FLASH_CALLS[call], r.PEAK_BF16)
    assert ms(got) == pytest.approx(want, abs=5e-5)


@pytest.mark.parametrize("T,B,call,want", [
    (3072, 1, "fwd", 0.1025), (768, 1, "fwd", 0.0064), (3072, 8, "dkv", 1.6399),
    (3072, 8, "dq", 1.2299)])
def test_flash_f32_bounds(T, B, call, want):
    H, D = (2, 224) if call == "fwd" else (1, 448)
    got = r.flash_bound_s(B, H, T, D, 4, *r.FLASH_CALLS[call], r.PEAK_F32_TC)
    assert ms(got) == pytest.approx(want, abs=5e-5)


def test_fused_units_of_a_512_frame_forward():
    units = r.fused_units(512, 512, (5, 4, 4, 2, 2), (3, 7, 11), ((1, 3, 5),) * 3)
    assert len(units) == 30
    ops = sum(r.fused_unit_counts(1, C, T, k)[0] for C, T, k in units)
    assert ops / 1e9 == pytest.approx(52.84, abs=0.01)
    assert ms(ops / r.PEAK_F32_TC) == pytest.approx(0.320, abs=1e-3)


@pytest.mark.parametrize("B,T,want", [(1, 512, 0.0962), (16, 1024, 3.077), (16, 3072, 9.231),
                                      (32, 1024, 6.154)])
def test_gru_operations_at_the_f32_peak(B, T, want):
    n_ops, _, _ = r.gru_counts(B, T, 1024)
    assert ms(n_ops / r.PEAK_F32) == pytest.approx(want, abs=1e-3)
