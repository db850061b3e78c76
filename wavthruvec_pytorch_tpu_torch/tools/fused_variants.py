"""Time design variants of the fused ResBlock2 kernel against each other at
the 30 units of one 512-frame Generator forward, on one NVIDIA Hopper GPU:

    python3 -m wavthruvec_pytorch_tpu_torch.tools.fused_variants [--rounds N]

A variant is one instance of ``launch_k<TM, TN, WM, WN, MINB, KT>`` in
``csrc/fused_resblock.cu``: a block tile (TM time rows, TN output channels,
a WM x WN warp tile, MINB blocks an SM) with its taps fixed when compiled
(KT = the unit's k) or taken at run time (KT = 0).  Each variant is a small
source that includes ``csrc/fused_resblock.cu`` and exports that launch;
all are built at once with ``nvcc`` into ``build/variants/``.  Every
variant is held against ``conv_residual_plain`` (``FUSED_ATOL``) at every
unit, then all are timed at every unit in turns, the order reversed each
round, each time the mean of ``REPS`` launches queued behind a spin so the
events see the device alone.  Prints each unit's median times, then each
variant's total, the total of the source's own choice per unit, and the
best variant per width.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

import numpy as np
import torch

from wavthruvec_pytorch_tpu_torch.config import Vec2WavConfig, load_config, repo_path
from wavthruvec_pytorch_tpu_torch.ops import kernel_build
from wavthruvec_pytorch_tpu_torch.ops.fused_resblock import conv_residual_plain, fused_conv_residual
from wavthruvec_pytorch_tpu_torch.tools import finish_builds, queued_ms, start_build

FUSED_ATOL = 1e-4
SLOPE = 0.1
REPS = 20
FRAMES = 512
# name: (TM, TN, WM, WN, MINB): the two tiles csrc/fused_resblock.cu keeps
# (128x32 above 16 channels, 128x16 at 16) and two wider ones
TILES = {
    "128x64": (128, 64, 32, 32, 1),
    "64x64": (64, 64, 32, 16, 1),
    "128x32": (128, 32, 32, 16, 2),
    "128x16": (128, 16, 16, 16, 2),
}
TAPS = ("fixed", "run")
OUT_DIR = os.path.join(kernel_build.BUILD_DIR, "variants")


def variant_source(tile) -> str:
    TM, TN, WM, WN, MINB = tile
    args = ("x, w, b, out, B, T, C, k, dil, slope, 1, static_cast<cudaStream_t>(stream)")
    cases = "\n".join(
        f"    case {k}: return launch_k<{TM}, {TN}, {WM}, {WN}, {MINB}, {k}>({args});"
        for k in (3, 7, 11))
    return f"""#include "fused_resblock.cu"
extern "C" int variant_forward(const float* x, const float* w, const float* b, float* out,
                               int B, int T, int C, int k, int dil, float slope,
                               int fixed, void* stream) {{
  if (fixed) switch (k) {{
{cases}
    default: return -1;
  }}
  return launch_k<{TM}, {TN}, {WM}, {WN}, {MINB}, 0>({args});
}}
"""


def build():
    """One library a tile, all nvcc processes at once."""
    os.makedirs(OUT_DIR, exist_ok=True)
    builds = {}
    for name, tile in TILES.items():
        src = os.path.join(OUT_DIR, f"variant_{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(tile))
        lib = os.path.join(OUT_DIR, f"libvariant_{name}.so")
        builds[name] = (start_build(src, lib), lib)
    fns = {}
    for name, (lib, log) in finish_builds(builds).items():
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill" in line and not line.strip().startswith("0 bytes")})
        print(f"built {name}: spills {spills or 'none'}")
        fn = lib.variant_forward
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def units(cfg: Vec2WavConfig, frames: int):
    """(C, T, k, d) of every ResBlock2 unit of one forward at B = 1 (a
    ResBlock2 takes the first two dilations of its set)."""
    out, T = [], frames
    for i, u in enumerate(cfg.upsample_rates):
        T *= u
        C = cfg.upsample_initial_channel // 2 ** (i + 1)
        for k, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            out += [(C, T, k, d) for d in dils[:2]]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_variants: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    fns = build()
    variants = [(t, m) for t in TILES for m in TAPS]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    g = torch.Generator(device="cuda").manual_seed(0)
    times = {v: [] for v in variants + [("source", "")]}
    print(f"fused ResBlock2 variants, {FRAMES} frames, B=1; median of {args.rounds} rounds "
          f"(order reversed each round) of the mean of {REPS} queued launches, ms:")
    print("  unit" + "".join(f"  {t}/{m}" for t, m in variants) + "  source")
    cases = units(load_config(Vec2WavConfig, repo_path("data/demo/vec2wav.json")), FRAMES)
    for C, T, k, d in cases:
        x = torch.randn((1, T, C), generator=g, device="cuda")
        w = torch.randn((k, C, C), generator=g, device="cuda") / (k * C) ** 0.5
        b = torch.randn((C,), generator=g, device="cuda") * 0.1
        want = conv_residual_plain(x, w, b, d, SLOPE)
        out = torch.empty_like(x)

        def run(v, out=out, x=x, w=w, b=b, d=d, k=k, C=C, T=T):
            err = fns[v[0]](x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), 1, T, C, k,
                            d, SLOPE, int(v[1] == "fixed"), stream())
            if err != 0:
                raise RuntimeError(f"variant {v} failed: cudaError_t {err}")
            return out

        calls = {v: (lambda v=v: run(v)) for v in variants}
        calls[("source", "")] = lambda: fused_conv_residual(x, w, b, d, SLOPE)
        for v, fn in calls.items():
            out.zero_()
            err = (fn() - want).abs().max().item()
            if not err <= FUSED_ATOL:
                raise RuntimeError(f"variant {v} at C={C} T={T} k={k} d={d}: max |err| {err:.3g}")
        rounds = {v: [] for v in calls}
        order = list(calls)
        for r in range(args.rounds):
            for v in (order if r % 2 == 0 else order[::-1]):
                rounds[v].append(queued_ms(calls[v], REPS))
        med = {v: float(np.median(rounds[v])) for v in calls}
        for v in calls:
            times[v].append(med[v])
        print(f"  C={C:3d} T={T:6d} k={k:2d} d={d}" + "".join(f"  {med[v]:.4f}" for v in calls))
    print("totals, 30 units:")
    for v, ts in times.items():
        print(f"  {v[0]}{'/' + v[1] if v[1] else ''}: {sum(ts):.4f} ms")
    best = 0.0
    for C in sorted({c[0] for c in cases}, reverse=True):
        idx = [i for i, c in enumerate(cases) if c[0] == C]
        per = {v: sum(times[v][i] for i in idx) for v in variants}
        v = min(per, key=per.get)
        best += per[v]
        print(f"  C={C:3d}: best {v[0]}/{v[1]} {per[v]:.4f} ms; source "
              f"{sum(times[('source', '')][i] for i in idx):.4f}; "
              + ", ".join(f"{t}/{m} {per[(t, m)]:.4f}" for t, m in variants))
    print(f"  best variant per width, summed: {best:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
