"""Whether a training cell's worst-leaf change is rounding: the reference in
f32 read against the reference in f64, by the check's own numbers, at the
cell's own size, and for each named leaf the share of its first gradient's
elements whose sign f32 rounding turns (AdamW's first step moves every
element by the learning rate times that sign, however small the element).

    python3 benchmark/tools/rounding_look.py --workload gan_train_b2 --seeds S1,S2
        [--leaves gen.fcs.]

Prints one JSON line a seed.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import torch  # noqa: E402

from wtvbench import compare, spec, traffic  # noqa: E402


def _f64(tree):
    if torch.is_tensor(tree):
        return tree.double() if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    return tree


def reference(cell, seed, dev, f64: bool):
    """The GAN reference's three steps, and its raw first gradients."""
    from reference import vocoder as ref_voc
    from wtvbench import kind_gan_train as k

    v = cell.config["vec2wav"]
    pool = traffic.gan_pool(cell.traffic, v, seed, dev, ref_voc.log_mel)[:k.CHECK_STEPS]
    grads = {}
    norms, states = compare.leaf_norms, k.initial_states

    def keep(tensors):
        grads.update({n: t.detach().clone() for n, t in tensors.items() if t is not None})
        return norms(tensors)

    compare.leaf_norms = keep
    if f64:
        k.initial_states = lambda *a: _f64(states(*a))
        pool = [_f64(b) for b in pool]
    try:
        out = k.reference_steps(v, cell.traffic, seed, pool, dev, "f32")
    finally:
        compare.leaf_norms, k.initial_states = norms, states
    return out, grads


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--leaves", default="gen.fcs.")
    a = p.parse_args()
    cell = spec.cell(a.workload)
    if cell.traffic["kind"] != "gan_train":
        raise SystemExit("rounding_look reads GAN training cells")
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in (int(s) for s in a.seeds.split(",")):
        r32, g32 = reference(cell, seed, dev, False)
        r64, g64 = reference(cell, seed, dev, True)
        readings = compare.train_numbers(r32, r64)
        med = float(torch.tensor(list(r64["grad"].values())).median())
        leaves = {}
        for n in sorted(g64):
            if not n.startswith(a.leaves):
                continue
            e, x = g64[n].flatten(), g32[n].double().flatten()
            flip = torch.sign(e) != torch.sign(x)
            leaves[n] = {"elements": e.numel(), "sign_turned": int(flip.sum()),
                         "grad_over_median_leaf": float(e.norm()) / med,
                         "turned_rms_over_leaf_rms": float(e[flip].pow(2).mean().sqrt()
                                                           / e.pow(2).mean().sqrt())
                         if flip.any() else 0.0,
                         "change_gap": abs(r32["change"][n] - r64["change"][n])
                         / max(r64["change"][n], 1e-30)}
        print(json.dumps({"cell": a.workload, "seed": seed, "f32_against_f64": readings,
                          "leaves": leaves}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
