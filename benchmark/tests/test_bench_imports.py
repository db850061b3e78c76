"""Nothing the benchmark loads is JAX or the JAX package, by top-level name
compared whole; the reference loads nothing of the program either."""

import os
import subprocess
import sys

from wtvbench import runner

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted("
                          "{m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=ROOT, check=True,
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join([BENCH, ROOT])))
    return set(out.stdout.split())


def test_whole_names_only(monkeypatch):
    before = runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "wavthruvec_pytorch_tpu_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", sys)
    assert runner.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "wavthruvec_pytorch_tpu.probe", sys)
    assert "wavthruvec_pytorch_tpu" in runner.forbidden_modules()


def test_harness_and_program_load_no_jax():
    names = _loaded("import wtvbench.runner, wtvbench.kind_serve, wtvbench.kind_t2v_train, "
                    "wtvbench.kind_gan_train, wtvbench.flops\n"
                    "import wavthruvec_pytorch_tpu_torch.infer.http_serve, "
                    "wavthruvec_pytorch_tpu_torch.train.text2vec_train, "
                    "wavthruvec_pytorch_tpu_torch.train.vec2wav_train")
    assert not names & set(runner.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    names = _loaded("import reference.text2vec, reference.vocoder, reference.optim")
    assert not names & (set(runner.FORBIDDEN) | {"wavthruvec_pytorch_tpu_torch"})
