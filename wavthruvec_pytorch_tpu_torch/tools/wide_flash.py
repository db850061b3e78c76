"""A/B of the one-head long-bucket training step, whose flash attention runs
the wide kernels (head dim 448), between another commit's tree and this
one.  From the repository root, on a machine with an NVIDIA GPU:

    python3 -m wavthruvec_pytorch_tpu_torch.tools.wide_flash --parent DIR [--pairs N]
        [--dtype bfloat16|float32]

DIR is the other tree (e.g. ``git archive <rev> | tar -x -C DIR``).  Each
run is a fresh process in its own tree, with its own kernel build, that
trains ``chip_smoke.one_head_config`` with that tree's ``chip_smoke``
(``WARMUP_STEPS`` then ``TIMED_STEPS`` steps and their launch checks) and
reports the median step: in bf16 ``train_long`` (B = 16 x 768 x 3072), in
float32 the config with ``compute_dtype`` float32 at B = ``LONG_F32_B``, as
``train_long_f32`` trains the two-head config (every flash call on the wide
f32 kernels).  Runs go in N alternating pairs (parent, change, change,
parent, ...); prints each run, the medians of both sides and the median of
the pairs' differences.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

import torch

_SETUP = """
import dataclasses, torch, chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
cs.build_kernels()
"""
_STEP = {
    "bfloat16": _SETUP + 'cs.train_long(torch.device("cuda"), cs.one_head_config())\n',
    # train_long_f32's step on the one-head config, from functions both trees have
    "float32": _SETUP + """
cfg = dataclasses.replace(cs.one_head_config(), compute_dtype="float32")
torch.manual_seed(cs.SEED)
trainer = cs.Text2VecTrainer(cfg, device=torch.device("cuda"))
host = cs.synthetic_batch(cfg, cs.LONG_F32_B, cs.LONG_N, cs.LONG_T, cs.SEED)
used, _ = cs.flash_step_kernels(cfg)
per_step = {"mas": 1, cs.GRU_KERNELS[cs.numerics(cfg, cs.LONG_F32_B)][0]: 1, "gru_bwd": 1,
            **{name: 8 for name in used}}
cs.timed_training(trainer, trainer.to_device(host), int(host["output_lengths"].sum()),
                  "one-head f32 long-bucket training", per_step)
""",
}


def step_ms(tree: str, dtype: str) -> float:
    """The median one-head step in ``dtype`` of ``tree``'s own ``chip_smoke``,
    in ms."""
    env = dict(os.environ, PYTHONPATH=tree)
    out = subprocess.run([sys.executable, "-c", _STEP[dtype]], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=900)
    if out.returncode:
        raise RuntimeError(f"run in {tree} failed:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return float(re.search(r"step: median ([\d.]+) ms", out.stdout).group(1))


def ab(parent: str, pairs: int, dtype: str) -> None:
    trees = {"parent": os.path.abspath(parent), "change": os.getcwd()}
    runs = {"parent": [], "change": []}
    diffs = []
    for i in range(pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        got = {}
        for name in order:
            got[name] = step_ms(trees[name], dtype)
            runs[name].append(got[name])
            print(f"  pair {i}: {name} {got[name]:.2f} ms", flush=True)
        diffs.append(got["change"] - got["parent"])
    med = {k: sorted(v)[len(v) // 2] for k, v in runs.items()}
    mdiff = sorted(diffs)[len(diffs) // 2]
    print(f"one-head long-bucket {dtype} step, {pairs} pairs: parent {runs['parent']} (median "
          f"{med['parent']:.2f} ms), change {runs['change']} (median {med['change']:.2f} ms); "
          f"change - parent by pair {[round(d, 2) for d in diffs]}, median {mdiff:.2f} ms "
          f"({100 * mdiff / med['parent']:+.1f}%)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", required=True, help="another commit's tree")
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--dtype", choices=sorted(_STEP), default="bfloat16")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("wide_flash: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    ab(a.parent, a.pairs, a.dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
