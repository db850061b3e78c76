"""Every traffic mix is made from the seed alone, and every seed asks for the
same set of sizes."""

import numpy as np
import pytest
import torch

from tiny import config, mix
from wtvbench import traffic

CPU = torch.device("cpu")


def test_serve_requests_repeat_and_keep_their_sizes():
    m = mix("serve_closed_c16")
    a = traffic.serve_requests(m, 4285, 2 ** 31 + 11)
    b = traffic.serve_requests(m, 4285, 2 ** 31 + 11)
    c = traffic.serve_requests(m, 4285, 7)
    assert a == b and a != c
    assert sorted(len(r.text) for r in a) == sorted(len(r.text) for r in c)
    assert traffic.serve_checked(m, a, 5) == traffic.serve_checked(m, b, 5)


def test_serve_sizes_span_the_mix_in_whole_rounds():
    m = dict(mix("serve_closed_c16"), text_chars=[4, 64], pool=8192, round=64)
    sizes = traffic.serve_sizes(m)
    assert sizes.min() == 4 and sizes.max() == 64 and len(sizes) == 64
    assert 14 <= np.median(sizes) <= 18  # log-uniform: the geometric mean of the range
    reqs = traffic.serve_requests(m, 4285, 99)
    for k in (0, 64, 640):
        assert sorted(len(r.text) for r in reqs[k:k + 64]) == sorted(sizes)


@pytest.mark.parametrize("name", ["t2v_train_b16_n64_t1024", "gan_train_b2_t256"])
def test_training_pools_repeat_and_keep_their_sizes(name):
    m, c = mix(name), config()
    if name.startswith("t2v"):
        def make(seed):
            return traffic.t2v_pool(m, c["text2vec"], seed, CPU)

        def sizes(pool):
            return sorted(sum((b["output_lengths"].tolist() + b["input_lengths"].tolist()
                               for b in pool), []))
    else:
        from reference import vocoder

        def make(seed):
            return traffic.gan_pool(m, c["vec2wav"], seed, CPU, vocoder.log_mel)

        def sizes(pool):
            return sum(b["samples"] for b in pool)
    a, b, other = make(3 * 2 ** 31), make(3 * 2 ** 31), make(12)
    for x, y in zip(a, b):
        assert all(torch.equal(x[k], y[k]) if torch.is_tensor(x[k]) else x[k] == y[k] for k in x)
    first = next(k for k in a[0] if torch.is_tensor(a[0][k]))
    assert not torch.equal(a[0][first], other[0][first])
    assert sizes(a) == sizes(other)


def test_beta_binomial_prior_matches_scipy():
    from scipy.stats import betabinom

    for n, t in ((5, 17), (33, 100), (1, 4)):
        got = traffic.beta_binomial_prior(n, t, 1.0, CPU).numpy()
        i = np.arange(1, t + 1)[:, None]
        want = betabinom(n - 1, i, t + 1 - i).pmf(np.arange(n)[None])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_token_ids_follow_the_published_front_end():
    from wavthruvec_pytorch_tpu_torch.text import TextFrontend

    fe = TextFrontend(traffic.symbols(50))
    text = "".join(chr(traffic.FIRST_CHAR + i) for i in (0, 5, 46))
    assert traffic.token_ids(text) == fe.text_to_sequence(text)
