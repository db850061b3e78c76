"""Time design variants of the wide flash kernels on wgmma (``csrc/flash_attn.cu``
``wide_fwd_bf16``, ``wide_dkv_bf16``, ``wide_dq_bf16``) and of the f32
dK/dV and dQ (``wide_dkv_f32``, ``wide_dq_f32``) against the current source
on one NVIDIA Hopper GPU.  From the repo root:

    python3 -m wavthruvec_pytorch_tpu_torch.tools.wide_variants [--rounds N] [--only A,B]

Each variant is a copy of ``csrc/flash_attn.cu`` with text patched in
(``VARIANTS``: each (text, replacement) must occur once), built by nvcc
beside the current source, and loaded in place of the port's library, so
the wrappers ``flash_fwd_wide``, ``flash_bwd_dkv_wide`` and
``flash_bwd_dq_wide`` launch it:

- ``current``: the source as it is;
- ``in_flight``: a ring stage's score products left in flight across the
  next stage's and the stage released one behind (wait_group 1), in the
  forward and in dK/dV (released at once where dK/dV has one stage);
- ``runtime_loops``: dK/dV's loops over the boxes of a ring stage and of
  the chunk's columns bounded at run time, not unrolled;
- ``serial_chains``: the f32 dK/dV's first form: a score step's products
  summed in one chain of tensor-core adds an n-tile (not four: hi-hi and
  cross terms, even and odd k-step pairs), and dV and dK's 8-column tiles
  in a loop bounded at run time, so their chains do not interleave;
- ``steps_of_64``: the f32 dK/dV's ring steps 64 columns wide whatever the
  room (a __syncthreads every 64 columns of the score products);
- ``steps_of_128``: at most 128 columns wide, so more of them fit (two
  steps in flight at D = 448, not one);
- ``block_exchange``: the f32 dK/dV's exchange of partial scores under a
  __syncthreads, not a named barrier for each group of 16 keys;
- ``divided_loads``: the f32 dK/dV's run-time-width loads of Q and dO
  (and K and V) with an integer division a 16-byte copy, not 16 threads a
  row of 64 columns;
- ``dq_chunks_256``: the f32 dQ in chunks of at most 256 columns (448 ->
  256 + 192: S and dP computed twice), not all of D up to 512;
- ``dq_steps_of_128``, ``dq_steps_of_64``: the f32 dQ's ring steps at most
  128 or 64 columns wide (more of them in flight), not 256;
- ``dq_keys_32``: the f32 dQ's key tiles 32 keys, not 16 (at D = 448 its
  K_c buffers leave no room for Q and dO, which then stream).

A variant that changes a tiling the wrappers also know sets it on the
Python side too (``SETTINGS``), while its library is in use.  ``--only``
builds and times the named variants (and ``current``) alone.

Prints ptxas's C75xx diagnostics (wgmma serialised, fences injected) and
the f32 dQ's registers and spills of each build, holds each variant's bf16
forward, dK/dV and dQ and its f32 dK/dV and dQ against autograd of
``flash_attention_plain`` at a small shape (phase 13's tolerances), then
times the bf16 three at [16, 1, 3072, D] (the last item padded from 2000
on) and the f32 dK/dV and dQ at [1, 1, 3072, D] (D in ``DIMS``), and the
f32 dQ at the f32 training shape [8, 1, 3072, 448] (the last item padded
from 2000 on), in turns, the order reversed each round, each the mean of
``REPS`` launches queued behind a spin, and prints each one's median.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import re
import subprocess
import sys

import torch

from wavthruvec_pytorch_tpu_torch.ops import flash_attention as fa
from wavthruvec_pytorch_tpu_torch.ops import kernel_build
from wavthruvec_pytorch_tpu_torch.tools import finish_builds, queued_ms, start_build

REPS = 10
DIMS = (448, 512)
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}  # chip_smoke.FLASH_*_RTOL, of the largest
OUT_DIR = os.path.join(kernel_build.BUILD_DIR, "wide_variants")

_FWD_STAGE = """        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        if (tid == 0) hopper::mbar_arrive(empty_k(s));
      }
"""
_FWD_IN_FLIGHT = """        hopper::wgmma_commit();
        if (d > 0) {
          hopper::wgmma_wait<1>();
          if (tid == 0) hopper::mbar_arrive(empty_k((it - 1) % ST));
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      if (tid == 0) hopper::mbar_arrive(empty_k((it - 1) % ST));
"""
_DKV_STAGE = """ r > 0 || x > 0 || kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        if (tid == 0) hopper::mbar_arrive(empty(s));
      }
"""
_DKV_IN_FLIGHT = """ r > 0 || x > 0 || kk > 0);
        }
        hopper::wgmma_commit();
        if (ST == 1) {
          hopper::wgmma_wait<0>();
          if (tid == 0) hopper::mbar_arrive(empty(s));
        } else if (r > 0) {
          hopper::wgmma_wait<1>();
          if (tid == 0) hopper::mbar_arrive(empty((it - 1) % ST));
        }
      }
"""
_DKV_TAIL = """        hopper::wgmma_commit();
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

"""
_DKV_TAIL_IN_FLIGHT = """        hopper::wgmma_commit();
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      if (ST > 1 && nrs > 0 && tid == 0) hopper::mbar_arrive(empty((it - 1) % ST));

"""
_RING_LOOP = """#pragma unroll
        for (int x = 0; x < WSB; ++x) {
          if (x >= nbx) break;
"""
_CHUNK_LOOP = """#pragma unroll
        for (int x = 0; x < WCH / BOX; ++x) {
          if (x >= ncb) break;
"""
_F32_CHAINS = """        const float* bp = tb + (8 * n + g) * ldb + kk + t;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(bp[0], bh0, bl0);
        split_tf32(bp[4], bh1, bl1);
        hopper::mma_tf32(hl[p][n], al, bh0, bh1);
        hopper::mma_tf32(hl[p][n], ah, bl0, bl1);
        hopper::mma_tf32(hh[p][n], ah, bh0, bh1);
"""
_F32_ONE_CHAIN = """        const float* bp = tb + (8 * n + g) * ldb + kk + t;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(bp[0], bh0, bl0);
        split_tf32(bp[4], bh1, bl1);
        hopper::mma_tf32(hl[0][n], al, bh0, bh1);
        hopper::mma_tf32(hl[0][n], ah, bl0, bl1);
        hopper::mma_tf32(hl[0][n], ah, bh0, bh1);
"""
_F32_TILES = """      if (half_cols == WCH / 2)
        f32_accumulate<WCH / 16>(acc, xh, xl, vb, FLC);
      else
        f32_accumulate<WCH / 32>(acc, xh, xl, vb, FLC);
"""
_F32_TILES_BREAK = """#pragma unroll
      for (int n = 0; n < WCH / 16; ++n) {
        if (8 * n >= half_cols) break;
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(vb[8 * ks * FLC + 8 * n], bh0, bl0);
          split_tf32(vb[(8 * ks + 1) * FLC + 8 * n], bh1, bl1);
          mma_3xtf32(part, xh[ks], xl[ks], bh0, bh1, bl0, bl1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
      }
"""
_F32_LOADS = """  const int r = threadIdx.x / 16, c = (threadIdx.x % 16) * 4;
  for (int r0 = 0; r0 < rows; r0 += 16)
    for (int c0 = 0; c0 < cols; c0 += WK)
      cp_async16(smem_u32(dst + (r0 + r) * ld + c0 + c), src + (r0 + r) * rs + c0 + c, 16u);
"""
_F32_DIVIDED_LOADS = """  const int cpr = cols / 4;
  for (int i = threadIdx.x; i < rows * cpr; i += WT) {
    const int r = i / cpr, c = (i - r * cpr) * 4;
    cp_async16(smem_u32(dst + r * ld + c), src + r * rs + c, 16u);
  }
"""
VARIANTS = {
    "current": (),
    "in_flight": ((_FWD_STAGE, _FWD_IN_FLIGHT), (_DKV_STAGE, _DKV_IN_FLIGHT),
                  (_DKV_TAIL, _DKV_TAIL_IN_FLIGHT)),
    "runtime_loops": ((_RING_LOOP, "        for (int x = 0; x < nbx; ++x) {\n"),
                      (_CHUNK_LOOP, "        for (int x = 0; x < ncb; ++x) {\n")),
    "serial_chains": ((_F32_CHAINS, _F32_ONE_CHAIN), (_F32_TILES, _F32_TILES_BREAK)),
    "steps_of_64": (("for (p.step_cols = WCH; p.step_cols >= WK;",
                     "for (p.step_cols = WK; p.step_cols >= WK;"),),
    "steps_of_128": (("for (p.step_cols = WCH; p.step_cols >= WK;",
                      "for (p.step_cols = 2 * WK; p.step_cols >= WK;"),),
    "block_exchange": (("    hopper::named_sync(1 + kg, 128);\n", "    __syncthreads();\n"),),
    "divided_loads": ((_F32_LOADS, _F32_DIVIDED_LOADS),),
    "dq_chunks_256": (("constexpr int DQ_COLS = 512;", "constexpr int DQ_COLS = 256;"),),
    "dq_steps_of_128": (("for (int sw = WCH; sw >= WK; sw -= WK) {",
                         "for (int sw = 2 * WK; sw >= WK; sw -= WK) {"),),
    "dq_steps_of_64": (("for (int sw = WCH; sw >= WK; sw -= WK) {",
                        "for (int sw = WK; sw >= WK; sw -= WK) {"),),
    "dq_keys_32": (("constexpr int DQ_Q = 32, DQ_N = 16;", "constexpr int DQ_Q = 32, DQ_N = 32;"),),
}
# what a variant changes in ops/flash_attention.py's copy of the kernels' tiling
SETTINGS = {"dq_chunks_256": {"DQ_F32_COLS": 256}, "dq_keys_32": {"_DQ_KEYS": 32}}
F32_TRAIN = (8, 3072, 448)  # the f32 training shape [B, 1, T, D] of the one-head step


def build(names) -> dict:
    """Patch, build and load the variants ``names``; returns {name: (library,
    log)}."""
    with open(os.path.join(kernel_build.SRC_DIR, "flash_attn.cu")) as f:
        text = f.read()
    os.makedirs(OUT_DIR, exist_ok=True)
    builds = {}
    for name in names:
        patches = VARIANTS[name]
        src = text
        for old, new in patches:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {name}: patched text occurs {src.count(old)} times:\n{old}")
            src = src.replace(old, new)
        path = os.path.join(OUT_DIR, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        lib = os.path.join(OUT_DIR, f"lib{name}.so")
        builds[name] = (start_build(path, lib), lib)
    libs = finish_builds(builds)
    for lib, _ in libs.values():
        lib.wtv_error_string.argtypes = [ctypes.c_int]
        lib.wtv_error_string.restype = ctypes.c_char_p
    return libs


_DEFAULTS = {key: getattr(fa, key) for settings in SETTINGS.values() for key in settings}


def use(name: str, lib) -> None:
    """Make the wrappers launch ``lib``'s kernels, the variant ``name``'s
    tiling set on the Python side."""
    kernel_build._loaded["flash_attn"] = lib
    for key, value in {**_DEFAULTS, **SETTINGS.get(name, {})}.items():
        setattr(fa, key, value)


def dq_ptxas(log: str) -> str:
    """ptxas's registers and spills of ``wide_dq_f32`` in a build log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if re.search(r"\d+wide_dq_f32E", line) and "entry function" in line:
            return " ".join(x.strip() for x in lines[i + 1:i + 4] if "registers" in x or "spill" in x)
    return "not found"


def case(B: int, T: int, D: int, lens, seed: int = 0, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, dout = (torch.randn((B, T, 1, D), generator=g, device="cuda")
                     .to(dtype).transpose(1, 2) for _ in range(4))
    seg = (torch.arange(T, device="cuda")[None]
           < torch.tensor(lens, device="cuda")[:, None]).to(torch.int32)
    return q, k, v, dout, seg


def check(name: str) -> None:
    """The variant's bf16 forward, dK/dV and dQ and its f32 dK/dV and dQ
    against autograd of the plain version."""
    for D in DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, dout, seg = case(2, 320, D, (320, 201), dtype=dtype)
            scale = 1.0 / math.sqrt(D)
            out, lse = fa.flash_fwd_wide(q, k, v, seg, scale)
            ins = fa.backward_inputs(q, k, v, seg, out, lse, dout)
            dk, dv = fa.flash_bwd_dkv_wide(ins, scale)
            dq = fa.flash_bwd_dq_wide(ins, scale)
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            want, _ = fa.flash_attention_plain(*qkv, seg, scale)
            wq, wk, wv = torch.autograd.grad(want, qkv, dout)
            errs = [float((a.float() - b.float()).abs().max() / b.float().abs().max())
                    for a, b in ((out, want), (dq, wq), (dk, wk), (dv, wv))]
            if max(errs) > TOL[dtype]:
                raise RuntimeError(f"variant {name} at D = {D} {dtype}: out, dq, dk, dv errors "
                                   f"{errs}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--only", default="", help="comma-separated variants to run beside current")
    a = p.parse_args(argv)
    names = list(VARIANTS)
    if a.only:
        names = ["current"] + [n for n in a.only.split(",") if n != "current"]
        unknown = [n for n in names if n not in VARIANTS]
        if unknown:
            p.error(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    if not torch.cuda.is_available():
        print("wide_variants: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = build(names)
    for name, (lib, log) in libs.items():
        diags = sorted({m.group(1) + " in " + m.group(2) for m in re.finditer(
            r"\((C75\d\d)\)[^\n]*?(wide_\w+?_bf16)", log)})
        print(f"{name}: ptxas {', '.join(diags) if diags else 'no C75xx diagnostic'}; "
              f"wide_dq_f32 {dq_ptxas(log)}")
        use(name, lib)
        check(name)
    B8, T8, D8 = F32_TRAIN
    q8, k8, v8, dout8, seg8 = case(B8, T8, D8, [T8] * (B8 - 1) + [2000], dtype=torch.float32)
    out8, lse8 = fa.flash_fwd_wide(q8, k8, v8, seg8, 1.0 / math.sqrt(D8))
    ins8 = fa.backward_inputs(q8, k8, v8, seg8, out8, lse8, dout8)
    del q8, k8, v8, dout8, out8
    for D in DIMS:
        scale = 1.0 / math.sqrt(D)
        q, k, v, dout, seg = case(16, 3072, D, [3072] * 15 + [2000])
        out, lse = fa.flash_fwd_wide(q, k, v, seg, scale)
        ins = fa.backward_inputs(q, k, v, seg, out, lse, dout)
        q32, k32, v32, dout32, seg32 = case(1, 3072, D, [3072], dtype=torch.float32)
        out32, lse32 = fa.flash_fwd_wide(q32, k32, v32, seg32, scale)
        ins32 = fa.backward_inputs(q32, k32, v32, seg32, out32, lse32, dout32)
        calls = {"fwd": lambda: fa.flash_fwd_wide(q, k, v, seg, scale),
                 "dkv": lambda: fa.flash_bwd_dkv_wide(ins, scale),
                 "dq": lambda: fa.flash_bwd_dq_wide(ins, scale),
                 "f32 dkv": lambda: fa.flash_bwd_dkv_wide(ins32, scale),
                 "f32 dq": lambda: fa.flash_bwd_dq_wide(ins32, scale)}
        if D == D8:
            calls["f32 dq B8"] = lambda: fa.flash_bwd_dq_wide(ins8, scale)
        times = {name: {c: [] for c in calls} for name in libs}
        for r in range(a.rounds):
            for name in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
                use(name, libs[name][0])
                for c, fn in calls.items():
                    times[name][c].append(queued_ms(fn, REPS))
        for name, t in times.items():
            print(f"D = {D}, {name}: " + "; ".join(
                f"{c} median {sorted(x)[len(x) // 2]:.3f} ms {[round(y, 3) for y in x]}"
                for c, x in t.items()) + f" (bf16 at [16, 1, 3072, D], f32 at [1, 1, 3072, D], "
                f"B8 at [{B8}, 1, {T8}, {D8}])")
    use("current", libs["current"][0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
