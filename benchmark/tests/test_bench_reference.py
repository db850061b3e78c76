"""The plain reference agrees with the program's CPU path at a tiny size,
on the same seeded weights and inputs: a served answer, a Text2Vec training
step's losses and gradients, and a GAN step's losses."""

import numpy as np
import pytest
import torch

from reference import optim as ref_optim
from reference import text2vec as ref_t2v
from reference import vocoder as ref_voc
from reference.ops import Ops
from tiny import config, mix
from wtvbench import common, compare, traffic, weights

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def conf():
    return config()


def test_served_answer_matches(conf):
    from wavthruvec_pytorch_tpu_torch.infer.synthesize import Synthesizer
    from wavthruvec_pytorch_tpu_torch.text import TextFrontend
    from wtvbench.kind_serve import reference_answers, serve_noise

    m, t, v = mix("serve_closed_c16"), conf["text2vec"], conf["vec2wav"]
    t2v = weights.make_state(ref_t2v.param_shapes(t), 21, CPU, frozen=ref_t2v.frozen_tables(t),
                             frames_per_char=m["frames_per_char"],
                             duration_spread=m["duration_spread"])
    gen = weights.make_state(ref_voc.generator_shapes(v), 22, CPU)
    common.set_output_gain(gen, v, m["wav_std"], False, CPU)
    spk = traffic.speaker_data(m, t["n_feat_dim"], v["spk_dim"], 21, CPU)
    reqs = traffic.serve_requests(m, t["vocab_size"], 21)
    from wtvbench.kind_serve import calibrate
    calibrate(t2v, t, m, reqs, spk, CPU)
    reqs = reqs[:3]
    T2V, V2W = common.program_configs(conf)
    syn = Synthesizer(T2V, V2W, t2v, gen, TextFrontend(traffic.symbols(t["vocab_size"])),
                      device=CPU)
    sp = [r.speaker for r in reqs]
    emb = syn.speaker_embedding(spk["clips"][sp])
    wav, n = syn.synthesize([r.text for r in reqs], None, spk["vocoder"][sp].numpy(),
                            max_frames=m["max_frames"], t2v_spk_emb=emb,
                            noise=serve_noise(v["noise_dim"]).expand(3, -1).numpy())
    longest = max(len(traffic.token_ids(r.text)) for r in reqs)
    N = next(b for b in t["text_buckets"] if b >= longest)
    _, out, ref = reference_answers(reqs, N, t2v, gen, spk, conf, m, CPU, "f32")
    up = int(np.prod(v["upsample_rates"]))
    np.testing.assert_array_equal(n, out["durations"].sum(1).clamp(max=m["max_frames"]).numpy() * up)
    np.testing.assert_allclose(wav, ref.numpy(), atol=1e-5)


def test_text2vec_step_matches(conf):
    from wavthruvec_pytorch_tpu_torch.train.text2vec_train import Text2VecTrainer
    from wtvbench.kind_t2v_train import initial_state

    m, t = mix("t2v_train_b16_n64_t1024"), conf["text2vec"]
    batch = traffic.t2v_pool(m, t, 31, CPU)[0]
    T2V, _ = common.program_configs(conf)
    tr = Text2VecTrainer(T2V, device=CPU)
    tr.model.load_state_dict(initial_state(t, 31, CPU), strict=True)
    total, got, _ = tr.forward(tr.to_device(batch))
    tr.backward(total)
    P = initial_state(t, 31, CPU)
    keys = [k for k in P if ref_t2v.is_trained(k)]
    for k in keys:
        P[k].requires_grad_(True)
    want = ref_t2v.train_losses(P, batch, t, Ops())
    for k in ref_t2v.LOSS_KEYS:
        assert float(got[k]) == pytest.approx(float(want[k].detach()), rel=1e-5)
    grads = torch.autograd.grad(want["total_loss"], [P[k] for k in keys], allow_unused=True)
    params = dict(tr.model.named_parameters())
    ref = compare.leaf_norms(dict(zip(keys, grads)))
    prog = compare.leaf_norms({k: params[k].grad for k in keys})
    med = np.median(list(ref.values()))
    # at 16 channels a rounding that flips one near-tie of the CBHG's max pool
    # moves a bank's gradient, and what lies upstream of it, by up to 1e-2
    assert max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys) < 2e-2


def test_lamb_matches():
    from wavthruvec_pytorch_tpu_torch.train.lamb import Lamb

    g = torch.Generator().manual_seed(4)
    p = [torch.randn(5, 3, generator=g), torch.randn(7, generator=g)]
    grads = [[torch.randn(x.shape, generator=g) for x in p] for _ in range(3)]
    prog = [torch.nn.Parameter(x.clone()) for x in p]
    opt = Lamb(prog, lr=0.1, betas=(0.9, 0.98), eps=1e-9, weight_decay=1e-6)
    ref, state = {i: x.clone() for i, x in enumerate(p)}, {}
    for gs in grads:
        for q, gr in zip(prog, gs):
            q.grad = gr.clone()
        opt.step()
        ref_optim.lamb_step(ref, dict(enumerate(gs)), state, 0.1, 0.9, 0.98, 1e-9, 1e-6)
    for i, q in enumerate(prog):
        torch.testing.assert_close(q.detach(), ref[i], rtol=1e-6, atol=1e-7)


def test_gan_step_matches(conf):
    from wavthruvec_pytorch_tpu_torch.train.vec2wav_train import GANTrainer
    from wtvbench.kind_gan_train import initial_states, reference_steps

    m, v = mix("gan_train_b2_t256"), conf["vec2wav"]
    pool = traffic.gan_pool(m, v, 41, CPU, ref_voc.log_mel)[:2]
    _, V2W = common.program_configs(conf)
    tr = GANTrainer(V2W, device=CPU)
    st = initial_states(v, m, 41, CPU)
    for part, mod in (("gen", tr.gen), ("mpd", tr.mpd), ("msd", tr.msd)):
        mod.load_state_dict(st[part], strict=True)
    got = []
    for b in pool:
        out = tr.step(b, b["noise"])
        got.append([float(out["disc_loss_total"]), float(out["gen_loss_total"])])
    want = reference_steps(v, m, 41, pool, CPU, "f32")["losses"]
    np.testing.assert_allclose(got, want, rtol=1e-5)
