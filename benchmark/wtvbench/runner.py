"""One run of one cell: the cell's kind module, its end-to-end or per-layer
metrics, the check, and the result line."""

from __future__ import annotations

import json
import math
import subprocess
import sys
from typing import Optional

import torch

from wtvbench import common, compare, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "wavthruvec_pytorch_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (the port's name only begins with the latter)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, fault: Optional[str] = None) -> dict:
    device = torch.device(device)
    # the configurations state f32 (or bf16 with f32 parameters): no TF32 in
    # cuBLAS or cuDNN, PyTorch's default for cuDNN notwithstanding
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = common.RunArgs(cell, seed, seconds, trace, device, t_start, fault)
    out = spec.kind(cell).run(args)
    metrics = {}
    if trace:
        view = out["view"]
        view.update(config=cell.config, traffic=cell.traffic,
                    peak_flops=spec.kind(cell).peak_flops(cell.config))
        for m in cell.per_layer:
            value = spec.reader(cell, m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(out["e2e"][m["name"]]), "unit": m["unit"]}
    checks = compare.checks_line(out["readings"], cell.limits)
    # every reading, compared or not, for setting limits from a series of runs
    print(json.dumps({"readings": out["readings"]}, default=str), file=sys.stderr)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": compare.passed(checks, out["failed"]), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = out["view"]["busy_s"]
        dev["window_s"] = out["view"]["window_s"]
        result["breakdown"] = {"device_ops": out["view"]["device_ops"],
                               "idle_gaps": out["view"]["idle_gaps"]}
    if device.type == "cuda":
        result["card"] = card_line()
    result["checks"] = {n: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                        for n, v, lim in checks}
    return result
