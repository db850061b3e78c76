"""What the per-layer metric readers (``benchmark/metrics/*.py``) share: a
traced run's view (``trace.reduce`` plus the kind module's counters, the cell's
configuration and mix and the peak of its precision) read by span, by
kernel and by count."""

from __future__ import annotations

import re
from typing import Iterable, Optional

# the program's hand-written kernels, by the function name nvcc gives them
FUSED = ("fused_resblock_kernel",)
GRU = ("gru_persistent_f32_kernel", "gru_step_kernel", "gru_bwd_persistent_kernel",
       "gru_bwd_step_kernel")
FLASH = ("flash_fwd_bf16", "flash_bwd_dkv_bf16", "flash_bwd_dq_bf16", "flash_fwd_f32",
         "flash_fwd_f32_merge", "flash_bwd_dkv_f32", "flash_bwd_dq_f32", "wide_fwd_bf16",
         "wide_dkv_bf16", "wide_dq_bf16", "wide_fwd_f32", "wide_dkv_f32", "wide_dkv_f32_merge",
         "wide_dq_f32", "wide_dq_f32_merge")
OWN = FUSED + GRU + FLASH + ("gru_persistent_kernel", "mas_cluster_kernel", "mas_row_chain_kernel")
CONV_WORDS = ("conv", "dgrad", "wgrad", "fprop", "implicit_gemm", "winograd")


def base_name(kernel: str) -> str:
    """``void (anonymous namespace)::name<...>(args)`` -> ``name``."""
    name = kernel.replace("(anonymous namespace)::", "").split("(", 1)[0]
    name = re.sub(r"<.*", "", name).strip()
    name = name.split(" ")[-1]
    return name.split("::")[-1]


def kernel_seconds(view: dict, names: Iterable[str]) -> float:
    names = set(names)
    return sum(v["s"] for k, v in view["kernels"].items() if base_name(k) in names)


def conv_seconds(view: dict) -> float:
    """Device seconds of library convolution kernels (cuDNN's), by name."""
    total = 0.0
    for k, v in view["kernels"].items():
        if base_name(k) in OWN:
            continue
        if any(w in k.lower() for w in CONV_WORDS):
            total += v["s"]
    return total


def span_ms_per(view: dict, span: str, per: float) -> Optional[float]:
    s = view["spans"].get(span)
    if not s or not per:
        return None
    return 1e3 * s["device_s"] / per


def share(bound_s: float, kernel_s: float) -> Optional[float]:
    """A roofline share in percent, or nothing where no kernel ran."""
    if kernel_s <= 0:
        return None
    return 100.0 * bound_s / kernel_s


def idle_pct(view: dict) -> Optional[float]:
    if view["window_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - view["busy_s"] / view["window_s"])


def mfu_pct(view: dict, flops: float) -> Optional[float]:
    if not flops or view["window_s"] <= 0:
        return None
    return 100.0 * flops / view["window_s"] / view["peak_flops"]
