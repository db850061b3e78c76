"""Measurements of the f32 BiGRU kernels on the card, beside ``chip_smoke.py``
phases 5 and 10.  From the repository root, on a machine with an NVIDIA GPU:

    python3 -m wavthruvec_pytorch_tpu_torch.tools.gru_f32 [--bounds] [--parent DIR]
        [--pairs N] [--step train|long|kernels]...

1. Where a step of each persistent f32 kernel goes, the forward
   (``csrc/gru_fwd.cu``) and the backward loop (``csrc/gru_bwd.cu``): both
   sources are built with ``-DGRU_PROFILE`` into this tree's build
   directory, so that thread 0 of block 0 stamps its phases with
   ``%globaltimer`` (``gru::Stamps`` in ``csrc/gru_common.cuh``, whose marks
   the kernels carry): the wait at the per-direction barrier, the stage loop
   and, inside it, its waits for stages, the reduce of the partial sums (in
   the backward with the exchange of the pair's halves), the unit step (the
   gates), and the arrival.  Each runs through ``ops/gru.py``'s own launch
   at D = 2, H = 1024 and (B, T) in ``SHAPES``, is held against its plain
   version and prints microseconds a step.
2. With ``--bounds``: what bounds the backward's loop.  Copies of
   ``csrc/gru_bwd.cu`` with switches patched in by text (``BOUNDS``;
   raises if a patched line changed), built with nvcc beside the profile
   builds and timed in turns at ``BOUNDS_SHAPES``: the kernel, the kernel
   with its dgh stream zero-filled (no L2 reads; the FFMA loop and the
   rest stay), without its FFMA products (the stream and the rest stay),
   and with neither.
3. With ``--parent DIR`` (another commit's tree, e.g. ``git archive <rev> |
   tar -x -C DIR``): DIR's tree and this one in N alternating pairs
   (parent, change, change, parent, ...), each run in a fresh process in its
   own tree with its own kernel build, for each ``--step``: ``train`` (the
   default), ``chip_smoke.py`` phase 8's step (B = 16 x 64 x 1024 on the demo
   config); ``long``, phase 14's long-bucket bf16 step (B = 16 x 768 x
   3072), both of which run the BiGRU's forward and backward kernels;
   ``kernels``, each tree's ``gru_fwd_f32`` and ``gru_bwd_loop`` alone at
   ``KERNEL_SHAPES`` (serving, training and the long steps).  Prints each
   run's times and launches, the medians of both sides and the median of the
   pairs' differences.
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
from wavthruvec_pytorch_tpu_torch.tools import finish_builds, queued_ms, start_build

SHAPES = ((2, 512), (16, 1024), (16, 3072))
# gru::PROF_* in csrc/gru_common.cuh, in order
PHASES = ("barrier", "stage loop", "of which stage waits", "reduce", "unit step", "arrival")


def profile_libs() -> dict:
    """Both sources built with -DGRU_PROFILE: {"fwd" | "bwd": library}."""
    os.makedirs(kernel_build.BUILD_DIR, exist_ok=True)
    builds = {}
    for kind, name in (("fwd", "gru_fwd"), ("bwd", "gru_bwd")):
        library = os.path.join(kernel_build.BUILD_DIR, f"lib{name}_profile.so")
        builds[kind] = (start_build(os.path.join(kernel_build.SRC_DIR, f"{name}.cu"), library,
                                    ("GRU_PROFILE",)), library)
    libs = {}
    for kind, (lib, _) in finish_builds(builds).items():
        lib.wtv_error_string.argtypes = [ctypes.c_int]
        lib.wtv_error_string.restype = ctypes.c_char_p
        lib.gru_prof_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
        libs[kind] = (gru.bind_fwd if kind == "fwd" else gru.bind_bwd)(lib)
    return libs


def read_phases(lib, T: int) -> list:
    ns = (ctypes.c_ulonglong * len(PHASES))()
    kernel_build.check(lib, lib.gru_prof_read(ns), "gru_prof_read")
    return [v / T / 1e3 for v in ns]


def print_phases(label: str, err: float, per: list) -> None:
    total = sum(per) - per[PHASES.index("of which stage waits")]  # the waits lie in the loop
    print(f"  {label} (err vs plain {err:.2e}): "
          + ", ".join(f"{n} {p:.3f}" for n, p in zip(PHASES, per)) + f"; sum {total:.3f}",
          flush=True)


# (name, the text of csrc/gru_bwd.cu it replaces, the replacement under the
# variant's define): each text must occur once
BOUNDS = (
    ("NO_STREAM", "              const bool in = k < KC && b < B;\n",
     "              const bool in = !NO_STREAM && k < KC && b < B;\n"),
    ("NO_FMA", "            if (k < KC) {\n              float4 wv[RL];\n",
     "            if (!NO_FMA && k < KC) {\n              float4 wv[RL];\n"),
)
BOUNDS_VARIANTS = {"kernel": (), "no stream": ("NO_STREAM",), "no FFMA": ("NO_FMA",),
                   "neither": ("NO_STREAM", "NO_FMA")}
BOUNDS_SHAPES = ((16, 1024), (2, 512))


def bounds() -> None:
    src = open(os.path.join(kernel_build.SRC_DIR, "gru_bwd.cu")).read()
    for name, old, new in BOUNDS:
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/gru_bwd.cu changed: {old.strip()!r} no longer occurs once")
        src = src.replace(old, f"#ifndef {name}\n#define {name} 0\n#endif\n" + new)
    os.makedirs(kernel_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(kernel_build.BUILD_DIR, "gru_bwd_bounds.cu")
    with open(path, "w") as f:
        f.write(src)
    builds = {}
    for i, (name, defines) in enumerate(BOUNDS_VARIANTS.items()):
        library = os.path.join(kernel_build.BUILD_DIR, f"libgru_bwd_bounds{i}.so")
        builds[name] = (start_build(path, library, defines), library)
    libs = {}
    for name, (lib, _) in finish_builds(builds).items():
        lib.wtv_error_string.argtypes = [ctypes.c_int]
        lib.wtv_error_string.restype = ctypes.c_char_p
        libs[name] = gru.bind_bwd(lib)
    D, H = 2, 1024
    print(f"the backward loop's bounds (D={D} H={H}, microseconds a step; two rounds in turns):")
    for B, T in BOUNDS_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(B)
        gi = torch.randn((D, B, T, 3 * H), generator=g, device="cuda") * 0.5
        w = (torch.rand((D, H, 3 * H), generator=g, device="cuda") * 2 - 1) / H ** 0.5
        b = torch.randn((D, 3 * H), generator=g, device="cuda") * 0.1
        y = gru.gru_fwd_plain(gi, w, b, "f32")
        hprev = torch.cat([y.new_zeros(D, B, 1, H), y[:, :, :-1]], dim=2)
        gh = torch.matmul(hprev, w[:, None]) + b[:, None, None]
        args = (torch.randn((D, B, T, H), generator=g, device="cuda"), gi, gh, hprev, w)
        plan = gru.bwd_plan(D, B, H, "cuda")
        got = {name: [] for name in libs}
        for _ in range(2):
            for name, lib in libs.items():
                got[name].append(1e3 * queued_ms(lambda: gru._launch_bwd(*args, plan, lib), 3) / T)
        print(f"  B={B:2d} T={T:4d}: " + ", ".join(f"{n} {v[0]:.2f}, {v[1]:.2f}"
                                               for n, v in got.items()), flush=True)


def profile() -> None:
    libs = profile_libs()
    D, H = 2, 1024
    print(f"the f32 kernels' step by phase (block 0, thread 0; microseconds a step), D={D} "
          f"H={H}:")
    for B, T in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(B)
        gi = torch.randn((D, B, T, 3 * H), generator=g, device="cuda") * 0.5
        w = (torch.rand((D, H, 3 * H), generator=g, device="cuda") * 2 - 1) / H ** 0.5
        b = torch.randn((D, 3 * H), generator=g, device="cuda") * 0.1
        plan = gru.gru_fwd_plan(D, B, H, *gru.device_limits(torch.device("cuda")), "f32")
        bplan = gru.bwd_plan(D, B, H, "cuda")
        if plan.route != "persistent" or bplan.route != "persistent":
            raise RuntimeError(f"B={B}: the routes are {plan.route}, {bplan.route}")
        for _ in range(2):  # the second launch is read
            y = gru._launch(gi, w, b, plan, "f32", libs["fwd"])
            torch.cuda.synchronize()
        per = read_phases(libs["fwd"], T)
        err = (y - gru.gru_fwd_plain(gi, w, b, "f32")).abs().max().item()
        print_phases(f"forward  B={B:2d} T={T:4d} {plan}", err, per)
        hprev = torch.cat([y.new_zeros(D, B, 1, H), y[:, :, :-1]], dim=2)
        gh = torch.matmul(hprev, w[:, None]) + b[:, None, None]
        dys = torch.randn((D, B, T, H), generator=g, device="cuda")
        args = (dys, gi, gh, hprev, w)
        for _ in range(2):
            got = gru._launch_bwd(*args, bplan, libs["bwd"])
            torch.cuda.synchronize()
        per = read_phases(libs["bwd"], T)
        err = max(float((a - p).abs().max() / p.abs().max())
                  for a, p in zip(got, gru.gru_bwd_loop_plain(*args)))
        print_phases(f"backward B={B:2d} T={T:4d} {bplan}", err, per)
        del gi, y, hprev, gh, dys, args, got
        torch.cuda.empty_cache()


_SETUP = ("import torch, chip_smoke as cs\n"
          "torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False\n"
          "cs.build_kernels()\n")
# the kernels step: each tree's own f32 forward and backward wrappers at the
# paths' shapes, timed on a filled launch queue
KERNEL_SHAPES = {"fwd": ((1, 512), (1, 3000), (2, 512), (16, 1024), (16, 3072)),
                 "bwd": ((2, 512), (16, 1024), (16, 3072), (8, 3072))}
_KERNELS = (
    "import torch\n"
    "from wavthruvec_pytorch_tpu_torch.ops import gru\n"
    "from wavthruvec_pytorch_tpu_torch.tools import queued_ms\n"
    "torch.backends.cuda.matmul.allow_tf32 = False\n"
    "H = 1024\n"
    f"for kind, shapes in {KERNEL_SHAPES!r}.items():\n"
    "    for B, T in shapes:\n"
    "        g = torch.Generator(device='cuda').manual_seed(B * 131 + T)\n"
    "        gi = torch.randn((2, B, T, 3 * H), generator=g, device='cuda') * 0.5\n"
    "        w = (torch.rand((2, H, 3 * H), generator=g, device='cuda') * 2 - 1) / H ** 0.5\n"
    "        b = torch.randn((2, 3 * H), generator=g, device='cuda') * 0.1\n"
    "        if kind == 'fwd':\n"
    "            fn = lambda: gru.gru_fwd_f32(gi, w, b)\n"
    "        else:\n"
    "            y = gru.gru_fwd_f32(gi, w, b)\n"
    "            hprev = torch.cat([y.new_zeros(2, B, 1, H), y[:, :, :-1]], dim=2)\n"
    "            gh = torch.matmul(hprev, w[:, None]) + b[:, None, None]\n"
    "            dys = torch.randn((2, B, T, H), generator=g, device='cuda')\n"
    "            fn = lambda: gru.gru_bwd_loop(dys, gi, gh, hprev, w)\n"
    "        print(f'kernel {kind} ({B}, {T}): {queued_ms(fn, 5):.4f} ms', flush=True)\n"
    "print('launches on the kernels: gru_fwd_f32', gru.gru_fwd_f32.step_launches, "
    "'gru_bwd', gru.gru_bwd_loop.step_launches)\n")
# each --step: the script run in a tree, what it times, and the label of its
# launch line
STEPS = {
    "train": (_SETUP + "cs.train(torch.device('cuda'))\n", "training step, B = 16 x 64 x 1024",
              "the training path"),
    "long": (_SETUP + "cs.train_long(torch.device('cuda'))\n",
             "long-bucket bf16 step, B = 16 x 768 x 3072", "the long-bucket training"),
    "kernels": (_KERNELS, "the f32 BiGRU kernels (D = 2, H = 1024)", "the kernels"),
}


def times(out: str) -> dict:
    """{what: ms} of one run: the step's median, or each kernel's time."""
    got = {f"{k} {s}": float(ms) for k, s, ms in
           re.findall(r"kernel (\w+) (\(\d+, \d+\)): ([\d.]+) ms", out)}
    step = re.search(r"step: median ([\d.]+) ms", out)
    if step:
        got["step"] = float(step.group(1))
    return got


def ab(parent: str, pairs: int, step: str) -> None:
    script, label, path = STEPS[step]
    trees = {"parent": os.path.abspath(parent), "change": os.getcwd()}
    runs = {"parent": {}, "change": {}}
    diffs = {}
    for i in range(pairs):
        got = {}
        for name in ("parent", "change") if i % 2 == 0 else ("change", "parent"):
            out = subprocess.run([sys.executable, "-c", script], cwd=trees[name],
                                 capture_output=True, text=True, timeout=900)
            if out.returncode:
                raise RuntimeError(f"{name} run failed:\n{out.stdout[-3000:]}\n"
                                   f"{out.stderr[-3000:]}")
            got[name] = times(out.stdout)
            for k, v in got[name].items():
                runs[name].setdefault(k, []).append(v)
            launches = re.search(f"launches on {path}[^\n]*", out.stdout)
            print(f"  pair {i}: {name} " + ", ".join(f"{k} {v:.3f} ms" for k, v in got[name].items())
                  + f"; {launches.group(0)[:200] if launches else ''}", flush=True)
        for k in got["change"]:
            diffs.setdefault(k, []).append(got["change"][k] - got["parent"][k])
    for k in runs["change"]:
        med = {n: sorted(runs[n][k])[len(runs[n][k]) // 2] for n in runs}
        mdiff = sorted(diffs[k])[len(diffs[k]) // 2]
        print(f"{label}, {k}, {pairs} pairs: parent {runs['parent'][k]} (median "
              f"{med['parent']:.3f}), change {runs['change'][k]} (median {med['change']:.3f}), "
              f"change / parent {med['change'] / med['parent']:.4f}; change - parent by pair "
              f"{[round(d, 3) for d in diffs[k]]}, median {mdiff:.3f} ms", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bounds", action="store_true",
                   help="time the backward with its stream or its FFMA patched out")
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
    if a.bounds:
        bounds()
    if a.parent:
        for step in a.step or ["train"]:
            ab(a.parent, a.pairs, step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
