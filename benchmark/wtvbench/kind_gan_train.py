"""Vec2Wav GAN training: the program's ``GANTrainer.step`` (the Generator in
train mode, the D step on MPD + MSD, the G step against the updated
discriminators) over a pool of whole-utterance batches staged on the device
and cycled, each with its own noise.

Set-up builds the trainer once, loads the seeded weights and drives it
through its first steps by the window's own call on batches whose rows all
differ; the D and G losses of steps 1-3, each leaf's first gradient (read
back from AdamW's first moment after step 1: m = (1 - beta1) g) and each
leaf's change after step 3 are kept for the check.  Afterwards the
reference takes the same three steps in f32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from reference import optim as ref_optim
from reference import vocoder as ref_voc
from reference.ops import Ops, precision_flags
from wtvbench import common, compare, roofline, traffic, weights
from wtvbench import trace as tr

CHECK_STEPS = 3
SPANS = ("generate", "d_step", "g_step")
PARTS = ("gen", "mpd", "msd")


def initial_states(vcfg: dict, mix: dict, seed: int, dev) -> Dict[str, Dict[str, torch.Tensor]]:
    gen = weights.make_state(ref_voc.generator_shapes(vcfg), seed, dev)
    common.set_output_gain(gen, vcfg, mix["wav_std"], True, dev)
    return {"gen": gen,
            "mpd": weights.make_state(ref_voc.mpd_shapes(vcfg), seed + 1, dev),
            "msd": weights.make_state(ref_voc.msd_shapes(vcfg), seed + 2, dev)}


def _plant(fault, trainer) -> None:
    """Tests only: break the timed path underneath the harness."""
    if fault == "state_unchanged":
        trainer.opt_g.step = lambda *a, **k: None
        trainer.opt_d.step = lambda *a, **k: None
    elif fault == "half_batch":
        step = trainer.step

        def half(batch, noise=None):
            B = batch["wv_feat"].shape[0]
            return step({k: v[:B // 2] if torch.is_tensor(v) else v for k, v in batch.items()},
                        None if noise is None else noise[:B // 2])
        trainer.step = half
    elif fault is not None:
        raise ValueError(f"GAN training has no fault {fault!r}")


def peak_flops(config: dict) -> float:
    bf16 = config["vec2wav"].get("compute_dtype") == "bfloat16"
    return roofline.PEAK_BF16 if bf16 else roofline.PEAK_F32_TC


def run(a: common.RunArgs) -> dict:
    mix, conf, dev = a.cell.traffic, a.cell.config, a.device
    vcfg = conf["vec2wav"]
    pool = traffic.gan_pool(mix, vcfg, a.seed, dev, ref_voc.log_mel)

    from wavthruvec_pytorch_tpu_torch.train.vec2wav_train import GANTrainer

    _, V2W = common.program_configs(conf)
    trainer = GANTrainer(V2W, device=dev, seed=a.seed % (2 ** 63))
    states = initial_states(vcfg, mix, a.seed, dev)
    modules = {"gen": trainer.gen, "mpd": trainer.mpd, "msd": trainer.msd}
    for part, m in modules.items():
        m.load_state_dict(states[part], strict=True)
    del states
    names = {id(p): f"{part}.{n}" for part, m in modules.items() for n, p in m.named_parameters()}
    spans = tr.Spans(dev)
    for name in SPANS:
        setattr(trainer, name, spans.wrap(name, getattr(trainer, name)))
    _plant(a.fault, trainer)

    prog = {"losses": [], "grad": {}, "change": {}}
    for s in range(max(CHECK_STEPS, mix["warm_steps"])):
        batch = pool[s % len(pool)]
        m = trainer.step(batch, batch["noise"])
        if s < CHECK_STEPS:
            prog["losses"].append([float(m["disc_loss_total"]), float(m["gen_loss_total"])])
        if s == 0:
            b1 = V2W.adam_b1
            prog["grad"] = {names[id(p)]: float(torch.linalg.vector_norm(st["exp_avg"])) / (1 - b1)
                            for opt in (trainer.opt_g, trainer.opt_d)
                            for p, st in opt.state.items() if st}
        if s == CHECK_STEPS - 1:
            start = initial_states(vcfg, mix, a.seed, dev)
            prog["change"] = {f"{part}.{n}": float(torch.linalg.vector_norm(p.detach() - start[part][n]))
                              for part, mod in modules.items() for n, p in mod.named_parameters()}
            del start
    common.sync(dev)
    setup_s = common.since(a.t_start)

    out: Dict[str, object] = {}
    steps, samples = 0, 0
    if a.trace:
        with tr.Window(dev, spans) as w:
            for s in range(mix["trace_steps"]):
                batch = pool[s % len(pool)]
                last = trainer.step(batch, batch["noise"])
                samples += batch["samples"]
                steps += 1
        view = tr.reduce(w)
        view["counters"] = {"steps": steps, "samples": samples}
        out["view"] = view
        t_window = w.window_s
    else:
        t0 = common.now()
        while True:
            batch = pool[(steps + mix["warm_steps"]) % len(pool)]
            last = trainer.step(batch, batch["noise"])
            samples += batch["samples"]
            steps += 1
            if common.now() - t0 >= a.seconds:
                break
        common.sync(dev)
        t_window = common.now() - t0
    final = float(last["gen_loss_total"]) + float(last["disc_loss_total"])
    peak = common.peak_bytes(dev)
    del trainer, last, modules
    common.free(dev)

    ref = reference_steps(vcfg, mix, a.seed, pool[:CHECK_STEPS], dev, "f32")
    out.update({
        "attempted": steps, "failed": 0 if math.isfinite(final) else 1,
        "memory_peak_bytes": peak,
        "e2e": {"setup_s": setup_s,
                "gan_train_audio_s_per_s": samples / vcfg["sampling_rate"] / t_window},
        "readings": compare.train_numbers(prog, ref),
    })
    return out


def reference_steps(vcfg: dict, mix: dict, seed: int, batches: List[dict], dev, mode: str,
                    fault: Optional[str] = None) -> dict:
    """The reference's D and G losses of three steps from the seeded weights,
    its first gradients and its change after the three, in precision
    ``mode``: the Generator in train mode, the D step on (y, y_hat
    detached), the G step (mel L1 x 45, feature matching, adversarial)
    against the updated discriminators, AdamW on each.  ``fault`` plants
    one of the harness's faults in the reference."""
    ops = Ops(mode)
    S = initial_states(vcfg, mix, seed, dev)
    P = {f"{part}.{k}": v for part, st in S.items() for k, v in st.items()}
    trained = {part: [f"{part}.{k}" for k in st if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))
        and not (k.endswith(("weight_u", "weight_v")) and st[k].dim() == 1)]
        for part, st in S.items()}
    start = {k: P[k].clone() for ks in trained.values() for k in ks}
    for k in start:
        P[k].requires_grad_(True)
    view = {part: _View(P, part + ".") for part in PARTS}
    spectral: Dict[str, torch.Tensor] = {}
    opt_state: dict = {}
    lr, b1, b2 = vcfg["learning_rate"], vcfg["adam_b1"], vcfg["adam_b2"]
    out = {"losses": [], "grad": {}, "change": {}}
    gen_keys, disc_keys = trained["gen"], trained["mpd"] + trained["msd"]
    with precision_flags(mode):
        for s, batch in enumerate(batches):
            if fault == "half_batch":
                half = batch["audio"].shape[0] // 2
                batch = {k: v[:half] if torch.is_tensor(v) else v for k, v in batch.items()}
            step = fault != "state_unchanged"
            y = batch["audio"][..., 0]
            gstate = _Prefixed(spectral, "gen.")
            y_hat = ref_voc.generator(view["gen"], batch["wv_feat"], batch["spk_emb"],
                                      batch["noise"], vcfg, True, ops, gstate)
            dstate = _Prefixed(spectral, "msd.")
            yd = y_hat.detach()
            r1, f1, _, _ = ref_voc.pair(lambda w: ref_voc.mpd(view["mpd"], w, vcfg, ops), y, yd)
            r2, f2, _, _ = ref_voc.pair(lambda w: ref_voc.msd(view["msd"], w, True, ops, dstate),
                                        y, yd)
            d_loss = ref_voc.d_loss(r1, f1) + ref_voc.d_loss(r2, f2)
            d_grads = dict(zip(disc_keys, torch.autograd.grad(d_loss, [P[k] for k in disc_keys],
                                                              allow_unused=True)))
            if step:
                ref_optim.adamw_step(P, d_grads, opt_state, s + 1, lr, b1, b2, 1e-8, 0.01)
            y_g_mel = ref_voc.log_mel(y_hat, vcfg)
            mel_err = torch.mean(torch.abs(batch["mel_loss"][:, :y_g_mel.shape[1]] - y_g_mel))
            _, f1, fr1, fg1 = ref_voc.pair(lambda w: ref_voc.mpd(view["mpd"], w, vcfg, ops),
                                           y, y_hat)
            _, f2, fr2, fg2 = ref_voc.pair(
                lambda w: ref_voc.msd(view["msd"], w, True, ops, dstate), y, y_hat)
            g_loss = (ref_voc.g_adv_loss(f2) + ref_voc.g_adv_loss(f1) + ref_voc.fm_loss(fr2, fg2)
                      + ref_voc.fm_loss(fr1, fg1) + 45.0 * mel_err)
            g_grads = dict(zip(gen_keys, torch.autograd.grad(g_loss, [P[k] for k in gen_keys],
                                                             allow_unused=True)))
            if step:
                ref_optim.adamw_step(P, g_grads, opt_state, s + 1, lr, b1, b2, 1e-8, 0.01)
            out["losses"].append([float(d_loss.detach()), float(g_loss.detach())])
            if s == 0:
                out["grad"] = compare.leaf_norms({**d_grads, **g_grads})
            del y_hat, d_loss, g_loss, d_grads, g_grads
    out["change"] = {k: float(torch.linalg.vector_norm(P[k].detach() - start[k])) for k in start}
    return out


class _View(dict):
    """One module's entries of the prefixed parameter dict."""

    def __init__(self, P, prefix):
        super().__init__()
        self.P, self.prefix = P, prefix

    def __getitem__(self, k):
        return self.P[self.prefix + k]


class _Prefixed(dict):
    """The spectral vectors of one module, kept across calls in a shared dict."""

    def __init__(self, store, prefix):
        super().__init__()
        self.store, self.prefix = store, prefix

    def get(self, k, default=None):
        return self.store.get(self.prefix + k, default)

    def __setitem__(self, k, v):
        self.store[self.prefix + k] = v
