"""Time design variants of the bf16 wide flash forward and dK/dV
(``csrc/flash_attn.cu`` ``wide_fwd_bf16``, ``wide_dkv_bf16``) against the
current source on one NVIDIA Hopper GPU.  From the repo root:

    python3 -m wavthruvec_pytorch_tpu_torch.tools.wide_variants [--rounds N]

Each variant is a copy of ``csrc/flash_attn.cu`` with text patched in
(``VARIANTS``: each (text, replacement) must occur once), built by nvcc
beside the current source, and loaded in place of the port's library, so
the wrappers ``flash_fwd_wide`` and ``flash_bwd_dkv_wide`` launch it:

- ``current``: the source as it is;
- ``in_flight``: a ring stage's score products left in flight across the
  next stage's and the stage released one behind (wait_group 1), in the
  forward and in dK/dV (released at once where dK/dV has one stage);
- ``runtime_loops``: dK/dV's loops over the boxes of a ring stage and of
  the chunk's columns bounded at run time, not unrolled.

Prints ptxas's C75xx diagnostics (wgmma serialised, fences injected) of
each build, holds each variant's forward and dK/dV against autograd of
``flash_attention_plain`` at a small shape (phase 13's bf16 tolerance),
then times both at [16, 1, 3072, D] (D in ``DIMS``, the last item padded
from 2000 on) in turns, the order reversed each round, each the mean of
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
TOL = 2e-2  # chip_smoke.FLASH_BF16_RTOL, of the largest value
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
_DKV_STAGE = """        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        if (tid == 0) hopper::mbar_arrive(empty(s));
      }
"""
_DKV_IN_FLIGHT = """        hopper::wgmma_commit();
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
VARIANTS = {
    "current": (),
    "in_flight": ((_FWD_STAGE, _FWD_IN_FLIGHT), (_DKV_STAGE, _DKV_IN_FLIGHT),
                  (_DKV_TAIL, _DKV_TAIL_IN_FLIGHT)),
    "runtime_loops": ((_RING_LOOP, "        for (int x = 0; x < nbx; ++x) {\n"),
                      (_CHUNK_LOOP, "        for (int x = 0; x < ncb; ++x) {\n")),
}


def build() -> dict:
    """Patch, build and load every variant; returns {name: (library, log)}."""
    with open(os.path.join(kernel_build.SRC_DIR, "flash_attn.cu")) as f:
        text = f.read()
    os.makedirs(OUT_DIR, exist_ok=True)
    builds = {}
    for name, patches in VARIANTS.items():
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


def use(lib) -> None:
    """Make the wrappers launch ``lib``'s kernels."""
    kernel_build._loaded["flash_attn"] = lib


def case(B: int, T: int, D: int, lens, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, dout = (torch.randn((B, T, 1, D), generator=g, device="cuda")
                     .to(torch.bfloat16).transpose(1, 2) for _ in range(4))
    seg = (torch.arange(T, device="cuda")[None]
           < torch.tensor(lens, device="cuda")[:, None]).to(torch.int32)
    return q, k, v, dout, seg


def check(name: str) -> None:
    """The variant's forward and dK/dV against autograd of the plain version."""
    for D in DIMS:
        q, k, v, dout, seg = case(2, 320, D, (320, 201))
        scale = 1.0 / math.sqrt(D)
        out, lse = fa.flash_fwd_wide(q, k, v, seg, scale)
        dk, dv = fa.flash_bwd_dkv_wide(fa.backward_inputs(q, k, v, seg, out, lse, dout), scale)
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        want, _ = fa.flash_attention_plain(*qkv, seg, scale)
        _, wk, wv = torch.autograd.grad(want, qkv, dout)
        errs = [float((a.float() - b.float()).abs().max() / b.float().abs().max())
                for a, b in ((out, want), (dk, wk), (dv, wv))]
        if max(errs) > TOL:
            raise RuntimeError(f"variant {name} at D = {D}: out, dk, dv errors {errs}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=6)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("wide_variants: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = build()
    for name, (lib, log) in libs.items():
        diags = sorted({m.group(1) + " in " + m.group(2) for m in re.finditer(
            r"\((C75\d\d)\)[^\n]*?(wide_\w+?_bf16)", log)})
        print(f"{name}: ptxas {', '.join(diags) if diags else 'no C75xx diagnostic'}")
        use(lib)
        check(name)
    for D in DIMS:
        q, k, v, dout, seg = case(16, 3072, D, [3072] * 15 + [2000])
        scale = 1.0 / math.sqrt(D)
        out, lse = fa.flash_fwd_wide(q, k, v, seg, scale)
        ins = fa.backward_inputs(q, k, v, seg, out, lse, dout)
        times = {name: {"fwd": [], "dkv": []} for name in libs}
        for r in range(a.rounds):
            for name in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
                use(libs[name][0])
                times[name]["fwd"].append(queued_ms(lambda: fa.flash_fwd_wide(q, k, v, seg, scale),
                                                    REPS))
                times[name]["dkv"].append(queued_ms(lambda: fa.flash_bwd_dkv_wide(ins, scale),
                                                    REPS))
        for name, t in times.items():
            med = {k_: sorted(v_)[len(v_) // 2] for k_, v_ in t.items()}
            print(f"[16, 1, 3072, {D}] bf16 {name}: forward median {med['fwd']:.3f} ms "
                  f"{[round(x, 3) for x in t['fwd']]}, dK/dV median {med['dkv']:.3f} ms "
                  f"{[round(x, 3) for x in t['dkv']]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
