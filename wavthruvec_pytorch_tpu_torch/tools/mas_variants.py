"""Time variants of the width-1 MAS kernel against each other on one NVIDIA
Hopper GPU, at the shapes ``chip_smoke.py`` phase 9 holds.  From the repo
root (the inputs are ``chip_smoke.mas_inputs``):

    python3 -m wavthruvec_pytorch_tpu_torch.tools.mas_variants [--parent DIR] [--rounds N]
        [--designs parent,new]

``--parent DIR`` names an unpacked tree of the previous design (one block
an item, ``git archive`` of the parent commit).  Each design's
``csrc/mas.cu`` ("parent" and "new", the current one) is copied with
switches patched in by text (``PATCHES``) and built as four parts: ``full``,
``no_fill`` (the output is not zero-filled), ``no_backtrack`` (no ones are
written) and ``chain`` (the forward rows alone), which split its time into
the forward chain, the backtrack and the fill.  The current design is also
built as the variants in ``DESIGN_VARIANTS``, each a copy with one
constant changed; ``mas_width1`` (the port's own build, through its
wrapper and plan) and ``spread_full`` (the current kernel with its blocks
kept one an SM) are timed beside them.  Every variant named ``*_full`` and
``mas_width1`` is held equal to ``mas_width1_plain`` first.  All are timed
in turns, the order reversed each round, each time the mean of ``REPS``
launches queued behind a spin so the events see the device alone;
``--rounds 10`` with ``--parent`` gives ten alternating pairs of the
previous design's kernel and ``mas_width1``.  Prints each shape's median
times, both designs' splits and the ratio of the two designs.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from wavthruvec_pytorch_tpu_torch.ops import kernel_build, mas
from wavthruvec_pytorch_tpu_torch.tools import finish_builds, queued_ms, start_build

REPS = 10
SEED = 0
# (B, T, N): the training step's, two of the largest buckets, a width of ten
# warps that is no multiple of 32, the long bucket
SHAPES = ((16, 1024, 64), (16, 3000, 128), (4, 300, 300), (16, 3072, 768))
OUT_DIR = os.path.join(kernel_build.BUILD_DIR, "mas_variants")
PARTS = {"full": (), "no_fill": ("MAS_SKIP_FILL",), "no_backtrack": ("MAS_SKIP_BACKTRACK",),
         "chain": ("MAS_SKIP_FILL", "MAS_SKIP_BACKTRACK")}
# each design's switches, (text, replacement), patched into a copy of its
# source; SWITCHES gives them their default, off
PATCHES = {
    "parent": (
        ("o[k] = 0.f;", "if (!MAS_SKIP_FILL) o[k] = 0.f;"),
        ("if (j == 0 && out_len > 0) {", "if (!MAS_SKIP_BACKTRACK && j == 0 && out_len > 0) {"),
    ),
    "new": (
        ("} else if (warp > 0) {", "} else if (!MAS_SKIP_FILL && warp > 0) {"),
        ("if (rank == 0 && warp == 0 && out_len > 0) {",
         "if (!MAS_SKIP_BACKTRACK && rank == 0 && warp == 0 && out_len > 0) {"),
        ("if (rank == 0) {  // the ones", "if (!MAS_SKIP_BACKTRACK && rank == 0) {  // the ones"),
    ),
}
SWITCHES = "".join(f"#ifndef {m}\n#define {m} 0\n#endif\n"
                   for m in ("MAS_SKIP_FILL", "MAS_SKIP_BACKTRACK"))
# design variants of the current source: 7 producer warps instead of 11, a
# ring of 6 stages instead of 4
DESIGN_VARIANTS = {
    "p7_full": ("constexpr int PRODUCERS = 11;", "constexpr int PRODUCERS = 7;"),
    "s6_full": ("constexpr int STAGES = 4;", "constexpr int STAGES = 6;"),
}


def patched(text: str, patches, path: str) -> str:
    """Write ``text`` with each (old, new) of ``patches`` applied, each old
    found exactly once, to ``path``; returns ``path``."""
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"{path}: the source does not hold {old!r} once")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return path


def build(parent: str | None, designs):
    """{variant name: library}: the parts of each design in ``designs``
    ("new", the current source, and "parent", ``parent``'s) and the current
    one's design variants; all nvcc processes at once."""
    os.makedirs(OUT_DIR, exist_ok=True)
    roots = {"new": kernel_build.SRC_DIR}
    if parent is not None:
        roots["parent"] = os.path.join(parent, "wavthruvec_pytorch_tpu_torch", "csrc")
    builds = {}

    def add(name, source, defines=()):
        lib = os.path.join(OUT_DIR, f"lib{name}.so")
        builds[name] = (start_build(source, lib, defines), lib)

    for d in designs:
        with open(os.path.join(roots[d], "mas.cu")) as f:
            text = f.read()
        source = patched(SWITCHES + text, PATCHES[d], os.path.join(OUT_DIR, f"mas_{d}.cu"))
        for part, defines in PARTS.items():
            add(f"{d}_{part}", source, defines)
        if d == "new":
            for v, patch in DESIGN_VARIANTS.items():
                add(f"new_{v}", patched(text, (patch,), os.path.join(OUT_DIR, f"mas_{v}.cu")))
    return {name: lib for name, (lib, _) in finish_builds(builds).items()}


def parent_call(lib, attn, il, ol):
    """A call of the previous design as its wrapper made it: the take-left
    bits in a global scratch where they exceed the card's shared memory."""
    B, T, N = attn.shape
    lib.mas_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.mas_shared_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.mas_shared_bytes.restype = ctypes.c_size_t
    bits_bytes = lib.mas_shared_bytes(T, N)
    bits = None
    if bits_bytes + 256 > lib.mas_max_shared_bytes(attn.device.index or 0):
        bits = torch.empty(B * bits_bytes // 4, dtype=torch.int32, device=attn.device)
    out = torch.empty_like(attn)

    def run():
        err = lib.mas_forward(attn.data_ptr(), il.data_ptr(), ol.data_ptr(), out.data_ptr(),
                              B, T, N, None if bits is None else bits.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"parent mas_forward: cudaError_t {err}")
        return out
    return run


def new_call(lib, attn, il, ol, smem=0):
    """A call of the current design's variant ``lib`` in the wrapper's plan,
    with the shared memory the variant itself asks for, or ``smem`` where
    that is more."""
    B, T, N = attn.shape
    plan = mas.mas_plan(T, N, mas.shared_limit(attn.device))
    lib.mas_forward.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                                + [ctypes.c_size_t, ctypes.c_void_p])
    lib.mas_shared_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.mas_shared_bytes.restype = ctypes.c_size_t
    smem = max(smem, lib.mas_shared_bytes(T, plan.k))
    out = torch.empty_like(attn)

    def run():
        err = lib.mas_forward(attn.data_ptr(), il.data_ptr(), ol.data_ptr(), out.data_ptr(),
                              B, T, N, plan.cluster, plan.k, smem,
                              torch.cuda.current_stream().cuda_stream)
        kernel_build.check(lib, err, "mas_forward")
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--designs", default="parent,new")
    args = ap.parse_args()
    designs = [d for d in args.designs.split(",") if d != "parent" or args.parent is not None]
    if not torch.cuda.is_available():
        print("mas_variants: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import mas_inputs  # the repo root's script: run from the root
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip().splitlines()[0])
    libs = build(args.parent, designs)
    print(f"MAS variants on {torch.cuda.get_device_name(0)}; median of {args.rounds} rounds "
          f"(order reversed each round) of the mean of {REPS} queued launches, ms:")
    for B, T, N in SHAPES:
        attn, il, ol, zeros = mas_inputs(B, T, N, SEED)
        smem = mas.shared_limit(attn.device)
        want = mas.mas_width1_plain(attn, il, ol)
        calls = {name: (parent_call if name.startswith("parent") else new_call)(lib, attn, il, ol)
                 for name, lib in libs.items()}
        plan = None
        if "new" in designs:
            plan = mas.mas_plan(T, N, smem)
            calls["mas_width1"] = lambda: mas.mas_width1(attn, il, ol)
            # blocks kept one an SM: shared memory asked for past half of an SM's
            calls["spread_full"] = new_call(libs["new_full"], attn, il, ol, smem // 2 + 1)
        for name, fn in calls.items():
            if name.endswith("_full") or name == "mas_width1":
                n_diff = int((fn() != want).sum())
                if n_diff:
                    raise RuntimeError(f"{name} at B={B} T={T} N={N}: {n_diff} cells differ")
        rounds = {v: [] for v in calls}
        order = list(calls)
        for r in range(args.rounds):
            for v in (order if r % 2 == 0 else order[::-1]):
                rounds[v].append(queued_ms(calls[v], REPS))
        med = {v: float(np.median(t)) for v, t in rounds.items()}
        print(f"B={B} T={T} N={N} ({zeros:.0%} exact zeros; plan {plan}):")
        for v in calls:
            print(f"  {v}: {med[v]:.4f} ms (min {min(rounds[v]):.4f}, max {max(rounds[v]):.4f})")
        for d in designs:
            full = med[f"{d}_full"]
            print(f"  {d} split: chain {med[f'{d}_chain']:.4f} ms, backtrack "
                  f"{full - med[f'{d}_no_backtrack']:.4f}, fill {full - med[f'{d}_no_fill']:.4f}"
                  f" (full {full:.4f})")
        if "parent_full" in med and "mas_width1" in med:
            pairs = [a / b for a, b in zip(rounds["parent_full"], rounds["mas_width1"])]
            print(f"  parent_full / mas_width1: median {np.median(pairs):.2f}x over {len(pairs)} "
                  f"pairs (min {min(pairs):.2f}, max {max(pairs):.2f})")
        del attn, want, calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
