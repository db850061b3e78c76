"""Text2Vec training: the program's ``Text2VecTrainer.step`` over a pool of
batches staged on the device and cycled.

Set-up builds the trainer once, loads the seeded weights, and drives it
through its first steps by the window's own call on batches whose rows all
differ; the losses of steps 1-3, each leaf's first gradient (read back
from LAMB's first moment after step 1: m = (1 - beta1) g) and each leaf's
change after step 3 are kept for the check.  The window then runs the same
trainer on.  Afterwards the reference takes the same three steps from the
same weights on the same batches in f32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from reference import optim as ref_optim
from reference import text2vec as ref_t2v
from reference.ops import Ops, precision_flags
from wtvbench import common, compare, roofline, traffic, weights
from wtvbench import trace as tr

CHECK_STEPS = 3
SPANS = ("forward", "backward", "apply_gradients")


def _plant(fault, trainer) -> None:
    """Tests only: break the timed path underneath the harness."""
    if fault == "state_unchanged":
        trainer.optimizer.step = lambda *a, **k: None
    elif fault == "half_batch":
        fwd = trainer.forward

        def half(batch):
            B = batch["text"].shape[0]
            return fwd({k: v[:B // 2] if torch.is_tensor(v) else v for k, v in batch.items()})
        trainer.forward = half
    elif fault is not None:
        raise ValueError(f"Text2Vec training has no fault {fault!r}")


def initial_state(tcfg: dict, seed: int, dev) -> Dict[str, torch.Tensor]:
    return weights.make_state(ref_t2v.param_shapes(tcfg), seed, dev,
                              frozen=ref_t2v.frozen_tables(tcfg))


def peak_flops(config: dict) -> float:
    bf16 = config["text2vec"].get("compute_dtype") == "bfloat16"
    return roofline.PEAK_BF16 if bf16 else roofline.PEAK_F32_TC


def run(a: common.RunArgs) -> dict:
    mix, conf, dev = a.cell.traffic, a.cell.config, a.device
    tcfg = conf["text2vec"]
    pool = traffic.t2v_pool(mix, tcfg, a.seed, dev)

    from wavthruvec_pytorch_tpu_torch.train.text2vec_train import Text2VecTrainer

    T2V, _ = common.program_configs(conf)
    trainer = Text2VecTrainer(T2V, device=dev)
    trainer.model.load_state_dict(initial_state(tcfg, a.seed, dev), strict=True)
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    hards: List[torch.Tensor] = []  # the program's alignments of the checked steps
    fwd = trainer.forward

    def forward(batch):
        out = fwd(batch)
        if len(hards) < CHECK_STEPS:
            hards.append(out[2]["attn"].detach().clone())
        return out

    trainer.forward = forward
    spans = tr.Spans(dev)
    for name in SPANS:
        setattr(trainer, name, spans.wrap(name, getattr(trainer, name)))
    _plant(a.fault, trainer)

    prog = {"losses": [], "grad": {}, "change": {}}
    for s in range(max(CHECK_STEPS, mix["warm_steps"])):
        metrics = trainer.step(pool[s % len(pool)])
        if s < CHECK_STEPS:
            prog["losses"].append([float(metrics["total_loss"])])
        if s == 0:
            b1 = T2V.beta1
            prog["grad"] = {names[id(p)]: float(torch.linalg.vector_norm(st["exp_avg"])) / (1 - b1)
                            for p, st in trainer.optimizer.state.items() if st}
        if s == CHECK_STEPS - 1:
            start = initial_state(tcfg, a.seed, dev)
            prog["change"] = {n: float(torch.linalg.vector_norm(p.detach() - start[n]))
                              for n, p in trainer.model.named_parameters() if p.requires_grad}
            del start
    common.sync(dev)
    setup_s = common.since(a.t_start)

    out: Dict[str, object] = {}
    steps, frames = 0, 0
    if a.trace:
        with tr.Window(dev, spans) as w:
            for s in range(mix["trace_steps"]):
                batch = pool[s % len(pool)]
                last = trainer.step(batch)
                frames += batch["frames"]
                steps += 1
        view = tr.reduce(w)
        view["counters"] = {"steps": steps, "frames": frames}
        out["view"] = view
        t_window = w.window_s
    else:
        common.sync(dev)
        t0 = common.now()
        while True:
            batch = pool[(steps + mix["warm_steps"]) % len(pool)]
            last = trainer.step(batch)
            frames += batch["frames"]
            steps += 1
            if common.now() - t0 >= a.seconds:
                break
        common.sync(dev)
        t_window = common.now() - t0
    final_loss = float(last["total_loss"])
    peak = common.peak_bytes(dev)
    del trainer, last
    common.free(dev)

    batches = pool[:CHECK_STEPS]
    whole = all(h.shape == b["attn_prior"].shape for h, b in zip(hards, batches))
    ref = reference_steps(tcfg, a.seed, batches, dev, "f32", hards if whole else None)
    readings = compare.train_numbers(prog, ref)
    if not whole:
        readings["mas_gap"] = math.inf
    out.update({
        "attempted": steps, "failed": 0 if math.isfinite(final_loss) else 1,
        "memory_peak_bytes": peak,
        "e2e": {"setup_s": setup_s, "t2v_train_frames_per_s": frames / t_window},
        "readings": readings, "notes": {"final_loss": final_loss},
    })
    return out


def reference_steps(tcfg: dict, seed: int, batches: List[dict], dev, mode: str,
                    hards: Optional[List[torch.Tensor]] = None, fault: Optional[str] = None
                    ) -> dict:
    """The reference's losses of three steps from the seeded weights, its
    first gradients and its change after the three, in precision ``mode``.
    ``hards`` gives each step's alignment (the program's search, judged by
    ``mas_gap``); without it the reference searches its own, returned as
    ``hards``.  ``fault`` plants one of the harness's faults in the
    reference, to read it as a control reads the lower precision."""
    ops = Ops(mode)
    P = initial_state(tcfg, seed, dev)
    trained = [k for k in P if ref_t2v.is_trained(k)]
    start = {k: P[k].clone() for k in trained}
    for k in trained:
        P[k].requires_grad_(True)
    state: dict = {}
    out = {"losses": [], "grad": {}, "change": {}, "hards": []}
    gaps = []
    with precision_flags(mode):
        for s, batch in enumerate(batches):
            if fault == "half_batch":
                half = batch["text"].shape[0] // 2
                batch = {k: v[:half] if torch.is_tensor(v) else v for k, v in batch.items()}
            losses = ref_t2v.train_losses(P, batch, tcfg, ops, None if hards is None else hards[s])
            grads = torch.autograd.grad(losses["total_loss"], [P[k] for k in trained],
                                        allow_unused=True)
            grads = dict(zip(trained, grads))
            out["losses"].append([float(losses["total_loss"].detach())])
            out["hards"].append(losses["hard"])
            if "mas_gap" in losses:
                gaps.append(float(losses["mas_gap"]))
            del losses
            if (s + 1) % tcfg["grad_clip_every"] == 0:
                ref_optim.clip_by_global_norm(grads, tcfg["grad_clip_thresh"])
            if s == 0:
                out["grad"] = compare.leaf_norms(grads)
            if fault != "state_unchanged":
                ref_optim.lamb_step(P, grads, state, tcfg["learning_rate"], tcfg["beta1"],
                                    tcfg["beta2"], tcfg["epsilon"], tcfg["weight_decay"])
            del grads
    out["change"] = {k: float(torch.linalg.vector_norm(P[k].detach() - start[k])) for k in trained}
    if gaps:
        out["mas_gap"] = max(gaps)
    return out
