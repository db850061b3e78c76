"""Measurements of the f32 BiGRU kernels on the card, beside ``chip_smoke.py``
phases 5 and 10.  From the repository root, on a machine with an NVIDIA GPU:

    python3 -m wavthruvec_pytorch_tpu_torch.tools.gru_f32 [--parent DIR] [--pairs N]
        [--step train|long]...

1. Where a step of the persistent f32 kernel goes: ``csrc/gru_fwd.cu`` is
   copied with ``%globaltimer`` stamps patched in by text at the phase
   boundaries of block 0's thread 0 (the stage loop and, inside it, its
   ``cp.async`` waits; the reduce of the partial sums; the gates; the
   arrival; the barrier), built with nvcc into this tree's build
   directory, run at D = 2, H = 1024 and (B, T) in ``SHAPES``, and held
   against ``gru_fwd_plain``; prints microseconds a step.
2. With ``--parent DIR`` (another commit's tree, e.g. ``git archive <rev> |
   tar -x -C DIR``): a training step of DIR's tree and of this one, in N
   alternating pairs (parent, change, change, parent, ...), each run in a
   fresh process in its own tree with its own kernel build, for each
   ``--step``: ``train`` (the default), ``chip_smoke.py`` phase 8's step (B
   = 16 x 64 x 1024 on the demo config); ``long``, phase 14's long-bucket
   bf16 step (B = 16 x 768 x 3072).  Both run the BiGRU's forward and
   backward kernels.  Prints each run's median step and launches, the
   medians of both sides and the median of the pairs' differences.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch

from wavthruvec_pytorch_tpu_torch.ops import gru, kernel_build
from wavthruvec_pytorch_tpu_torch.tools import finish_builds, start_build

SHAPES = ((1, 512), (2, 512), (8, 1024), (16, 1024), (32, 256))
PHASES = ("stage loop", "of which cp.async waits", "reduce", "gates", "arrival", "barrier")

_NOW = ('if (prof) { unsigned long long x_; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(x_)); '
        'now_ = x_; }')
# (text of csrc/gru_fwd.cu, the same text with a stamp): each must occur once
_STAMPS = (
    ("__device__ __forceinline__ uint32_t lds32(",
     "__device__ unsigned long long gru_prof[6];\n\n__device__ __forceinline__ uint32_t lds32("),
    ("  const size_t bstride = static_cast<size_t>(T) * H;  // between batch rows of y\n"
     "  unsigned* ctr = counter + d;\n",
     "  const size_t bstride = static_cast<size_t>(T) * H;  // between batch rows of y\n"
     "  unsigned* ctr = counter + d;\n"
     "  const bool prof = blockIdx.x == 0 && threadIdx.x == 0;\n"
     "  unsigned long long st[5] = {0, 0, 0, 0, 0}, sum[6] = {0, 0, 0, 0, 0, 0};\n"
     "  unsigned long long now_ = 0, w0_ = 0;\n"),
    ("    __syncthreads();\n    for (int bb0 = 0; bb0 < B; bb0 += BT) {\n",
     "    __syncthreads();\n    " + _NOW
     + " if (prof && t > 1) sum[5] += now_ - st[4]; st[0] = now_;\n"
     "    for (int bb0 = 0; bb0 < B; bb0 += BT) {\n"),
    ("          cp_async_wait<0>();  // stage q has landed ...\n"
     "          __syncthreads();     // ... for every thread, and q - 1's buffer is free\n",
     "          " + _NOW.replace("now_ = x_", "w0_ = x_") + "\n"
     "          cp_async_wait<0>();  // stage q has landed ...\n"
     "          __syncthreads();     // ... for every thread, and q - 1's buffer is free\n"
     "          " + _NOW + " if (prof) sum[1] += now_ - w0_;\n"),
    ("        __syncthreads();  // every warp is past the stages, which lie in red\n",
     "        " + _NOW + " if (prof) { sum[0] += now_ - st[0]; st[1] = now_; }\n"
     "        __syncthreads();  // every warp is past the stages, which lie in red\n"),
    ("        __syncthreads();\n      }\n\n      for (int p = tid; p < BT * U; p += P_THREADS) {",
     "        __syncthreads();\n        " + _NOW
     + " if (prof) { sum[2] += now_ - st[1]; st[2] = now_; }\n"
     "      }\n\n      for (int p = tid; p < BT * U; p += P_THREADS) {"),
    ("      __syncthreads();  // the pass's h is written; red is free again\n",
     "      __syncthreads();  // the pass's h is written; red is free again\n"
     "      " + _NOW + " if (prof && t > 0) sum[3] += now_ - st[2]; st[3] = now_; st[0] = now_;\n"),
    ("      load_gi(t + 1);  // while the other blocks arrive\n      cp_async_commit();\n",
     "      load_gi(t + 1);  // while the other blocks arrive\n      cp_async_commit();\n"
     "      " + _NOW + " if (prof && t > 0) sum[4] += now_ - st[3]; st[4] = now_;\n"),
    ("      barrier_wait(ctr, static_cast<unsigned>(t + 1) * nbd);\n    }\n  }\n}\n\n"
     "template <int U, int BT>\ncudaError_t launch_persistent_f32(",
     "      barrier_wait(ctr, static_cast<unsigned>(t + 1) * nbd);\n    }\n  }\n"
     "  if (prof) for (int i = 0; i < 6; ++i) gru_prof[i] = sum[i];\n}\n\n"
     "template <int U, int BT>\ncudaError_t launch_persistent_f32("),
)


def stamped_source() -> str:
    """``csrc/gru_fwd.cu`` with the stamps and a reader,
    ``gru_prof_read(out)``: the f32 kernel's nanoseconds by phase, summed
    over the steps of its last launch."""
    with open(os.path.join(kernel_build.SRC_DIR, "gru_fwd.cu")) as f:
        src = f.read()
    for old, new in _STAMPS:
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/gru_fwd.cu changed: {old[:60]!r} no longer occurs once")
        src = src.replace(old, new)
    return src + ('\nextern "C" int gru_prof_read(unsigned long long* out) {\n'
                  '  return static_cast<int>(cudaMemcpyFromSymbol(out, gru_prof, 6 * 8));\n}\n')


def profile() -> None:
    os.makedirs(kernel_build.BUILD_DIR, exist_ok=True)
    source = os.path.join(kernel_build.BUILD_DIR, "gru_fwd_profile.cu")
    library = os.path.join(kernel_build.BUILD_DIR, "libgru_fwd_profile.so")
    with open(source, "w") as f:
        f.write(stamped_source())
    lib, _ = finish_builds({"profile": (start_build(source, library), library)})["profile"]
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gru_fwd_persistent_f32.argtypes = [ptr] * 5 + [i32] * 5 + [ctypes.c_longlong, ptr]
    lib.gru_fwd_persistent_f32.restype = ctypes.c_int
    lib.gru_prof_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    n_sm, smem = gru.device_limits(torch.device("cuda"))
    D, H = 2, 1024
    print(f"the f32 kernel's step by phase (block 0, thread 0; microseconds a step), D={D} H={H}:")
    for B, T in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(B)
        gi = torch.randn((D, B, T, 3 * H), generator=g, device="cuda") * 0.5
        w = (torch.rand((D, H, 3 * H), generator=g, device="cuda") * 2 - 1) / H ** 0.5
        b = torch.randn((D, 3 * H), generator=g, device="cuda") * 0.1
        plan = gru.gru_fwd_plan(D, B, H, n_sm, smem, "f32")
        if plan.route != "persistent":
            raise RuntimeError(f"B={B}: the f32 kernel takes the {plan.route} route")
        wt = w.transpose(1, 2).contiguous()
        y = torch.empty(D, B, T, H, device="cuda")
        for _ in range(2):  # the second launch is read
            counter = torch.zeros(D, device="cuda", dtype=torch.int32)
            kernel_build.check(lib, lib.gru_fwd_persistent_f32(
                gi.data_ptr(), wt.data_ptr(), b.data_ptr(), y.data_ptr(), counter.data_ptr(),
                D, B, T, H, plan.units, plan.smem, torch.cuda.current_stream().cuda_stream),
                "gru_fwd_persistent_f32 (stamped)")
            torch.cuda.synchronize()
        ns = (ctypes.c_ulonglong * 6)()
        kernel_build.check(lib, lib.gru_prof_read(ns), "gru_prof_read")
        err = (y - gru.gru_fwd_plain(gi, w, b, "f32")).abs().max().item()
        per = [v / (T - 1) / 1e3 for v in ns]
        total = sum(per) - per[1]  # the waits lie inside the stage loop
        print(f"  B={B:2d} T={T:4d} (err vs plain {err:.2e}): "
              + ", ".join(f"{n} {p:.3f}" for n, p in zip(PHASES, per)) + f"; sum {total:.3f}")


_SETUP = ("import torch, chip_smoke as cs\n"
          "torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False\n"
          "cs.build_kernels()\n")
# each --step: the script run in a tree, the step it times, and the label
# of its launch line in chip_smoke's output
STEPS = {
    "train": (_SETUP + "cs.train(torch.device('cuda'))\n", "training step, B = 16 x 64 x 1024",
              "the training path"),
    "long": (_SETUP + "cs.train_long(torch.device('cuda'))\n",
             "long-bucket bf16 step, B = 16 x 768 x 3072", "the long-bucket training"),
}


def ab(parent: str, pairs: int, step: str) -> None:
    script, label, path = STEPS[step]
    trees = {"parent": os.path.abspath(parent), "change": os.getcwd()}
    runs = {"parent": [], "change": []}
    diffs = []
    for i in range(pairs):
        got = {}
        for name in ("parent", "change") if i % 2 == 0 else ("change", "parent"):
            out = subprocess.run([sys.executable, "-c", script], cwd=trees[name],
                                 capture_output=True, text=True, timeout=900)
            if out.returncode:
                raise RuntimeError(f"{name} run failed:\n{out.stdout[-3000:]}\n"
                                   f"{out.stderr[-3000:]}")
            got[name] = float(re.search(r"step: median ([\d.]+) ms", out.stdout).group(1))
            launches = re.search(f"launches on {path}[^\n]*", out.stdout)
            runs[name].append(got[name])
            print(f"  pair {i}: {name} {got[name]:.2f} ms; {launches.group(0)[:200]}", flush=True)
        diffs.append(got["change"] - got["parent"])
    med = {k: sorted(v)[len(v) // 2] for k, v in runs.items()}
    mdiff = sorted(diffs)[len(diffs) // 2]
    print(f"{label}, {pairs} pairs: parent {runs['parent']} (median {med['parent']:.2f}), change "
          f"{runs['change']} (median {med['change']:.2f}), change / parent "
          f"{med['change'] / med['parent']:.4f}; change - parent by pair "
          f"{[round(d, 2) for d in diffs]}, median {mdiff:.2f} ms", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", default=None, help="another commit's tree: A/B its training step")
    p.add_argument("--pairs", type=int, default=5)
    p.add_argument("--step", choices=sorted(STEPS), action="append",
                   help="the step(s) to A/B (default: train)")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gru_f32: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    profile()
    if a.parent:
        for step in a.step or ["train"]:
            ab(a.parent, a.pairs, step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
