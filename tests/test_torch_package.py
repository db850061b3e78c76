"""Package rules of the PyTorch port, checked on the CPU:

* no file of the port, and not ``chip_smoke.py``, imports ``jax``, ``flax``
  or the JAX package ``wavthruvec_pytorch_tpu`` (matched by exact module
  name: the port's own name shares that prefix);
* importing the port loads no JAX;
* without a GPU, an entry point called with no ``device`` raises instead of
  falling back to the CPU;
* importing the kernel modules needs no ``nvcc`` and builds nothing;
* a library's name follows its source and every shared header, so an
  edited header is never served by a stale build;
* configuration flags that are not ported yet raise; those a slice ported
  build.
"""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

import wavthruvec_pytorch_tpu_torch as port
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig, check_ported
from wavthruvec_pytorch_tpu_torch.entry import entry
from wavthruvec_pytorch_tpu_torch.infer.synthesize import Synthesizer, make_serving_generator
from wavthruvec_pytorch_tpu_torch.models.layers import PartialConv1d
from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
from wavthruvec_pytorch_tpu_torch.models.vec2wav import Generator
from wavthruvec_pytorch_tpu_torch.ops import kernel_build
from wavthruvec_pytorch_tpu_torch.text import TextFrontend
from wavthruvec_pytorch_tpu_torch.train import text2vec_loop
from wavthruvec_pytorch_tpu_torch.train.text2vec_train import Text2VecTrainer
from wavthruvec_pytorch_tpu_torch.train.vec2wav_train import GANTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.dirname(os.path.abspath(port.__file__))
FORBIDDEN = ("jax", "flax", "wavthruvec_pytorch_tpu")

TINY_T2V = dict(n_feat_dim=16, spk_channel=16, n_speaker_dim=8, vocab_size=20,
                max_seq_len=32, encoder_dim=8, encoder_n_layer=1,
                encoder_conv1d_filter_size=16, decoder_dim=8, decoder_n_layer=1,
                decoder_conv1d_filter_size=16, duration_predictor_filter_size=8)
TINY_V2W = dict(n_feat_dim=16, num_wv_feat=16, spk_dim=4, noise_dim=4,
                upsample_initial_channel=16, upsample_rates=(2,), upsample_kernel_sizes=(4,),
                resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),))


def _python_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imported_modules(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_forbidden_name_match_is_exact():
    assert _forbidden("jax.numpy") and _forbidden("flax") and _forbidden("wavthruvec_pytorch_tpu")
    assert _forbidden("wavthruvec_pytorch_tpu.ops.masking")
    assert not _forbidden("wavthruvec_pytorch_tpu_torch.ops.masking")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", _python_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def _run(code, env_update=None):
    env = dict(os.environ)
    env.update(env_update or {})
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_import_loads_no_jax():
    code = ("import sys, pkgutil, importlib, wavthruvec_pytorch_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'flax', 'wavthruvec_pytorch_tpu'))\n"
            "assert not bad, bad\n"
            "new = {'checkpoint', 'utils.logging', 'utils.plots', 'data.prefetch', 'cli'}\n"
            "missing = {m for m in new if p.__name__ + '.' + m not in sys.modules}\n"
            "assert not missing, missing\n"
            "assert 'matplotlib' not in sys.modules\n"
            "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_kernel_modules_import_without_nvcc(tmp_path):
    """With no CUDA toolkit in reach, the kernel modules import and their CPU
    path runs; nothing is built."""
    code = ("import os, torch\n"
            "from wavthruvec_pytorch_tpu_torch.ops import kernel_build, gru, fused_resblock, mas\n"
            "from wavthruvec_pytorch_tpu_torch.ops import flash_attention as fa\n"
            "before = set(os.listdir(kernel_build.BUILD_DIR)) "
            "if os.path.isdir(kernel_build.BUILD_DIR) else set()\n"
            "x = torch.randn(1, 9, 16)\n"
            "y = fused_resblock.fused_conv_residual(x, torch.randn(3, 16, 16), torch.randn(16))\n"
            "h = gru.gru_fwd(torch.randn(2, 1, 5, 48), torch.randn(2, 16, 48).bfloat16(),"
            " torch.randn(2, 48))\n"
            "a = mas.mas_width1(torch.rand(2, 7, 4), torch.tensor([4, 2]), torch.tensor([7, 5]))\n"
            "q = torch.randn(1, 2, 64, 8, requires_grad=True)\n"
            "seg = torch.ones(1, 64, dtype=torch.int32)\n"
            "fa.flash_attention(q, q, q, seg, 0.5).sum().backward()\n"
            "assert y.shape == x.shape and h.shape == (2, 1, 5, 16) and a.shape == (2, 7, 4)\n"
            "after = set(os.listdir(kernel_build.BUILD_DIR)) "
            "if os.path.isdir(kernel_build.BUILD_DIR) else set()\n"
            "assert after == before, after - before\n"
            "assert fused_resblock.fused_conv_residual.launches == 0 == gru.gru_fwd.launches\n"
            "assert mas.mas_width1.launches == 0 == fa.flash_fwd.launches\n"
            "assert fa.flash_bwd_dkv.launches == 0 == fa.flash_bwd_dq.launches\n"
            "try:\n"
            "    kernel_build._nvcc()\n"
            "except RuntimeError:\n"
            "    print('ok')\n")
    res = _run(code, {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path)})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_library_path_covers_headers(tmp_path, monkeypatch):
    """In a copy of ``csrc/``, an unchanged tree names the same libraries;
    editing a shared header renames every kernel's library (any source may
    include it), and editing one source renames only its own."""
    names = kernel_build.KERNELS
    original = {n: kernel_build.library_path(n) for n in names}
    src = tmp_path / "csrc"
    shutil.copytree(kernel_build.SRC_DIR, src)
    monkeypatch.setattr(kernel_build, "SRC_DIR", str(src))
    headers = sorted(src.glob("*.cuh"))
    assert headers, "no shared header under csrc/"
    before = {n: kernel_build.library_path(n) for n in names}
    assert before == original
    assert len(set(before.values())) == len(names)

    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    edited = {n: kernel_build.library_path(n) for n in names}
    assert all(edited[n] != before[n] for n in names), edited

    (src / "mas.cu").write_text((src / "mas.cu").read_text() + "\n// edited\n")
    again = {n: kernel_build.library_path(n) for n in names}
    assert [n for n in names if again[n] != edited[n]] == ["mas"]


def test_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t2v_cfg, v2w_cfg = Text2VecConfig(**TINY_T2V), Vec2WavConfig(**TINY_V2W)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry(t2v_cfg=t2v_cfg, v2w_cfg=v2w_cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Generator(v2w_cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Text2Vec(t2v_cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Synthesizer(t2v_cfg, v2w_cfg, {}, {}, TextFrontend("PE abc"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Text2VecTrainer(t2v_cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        text2vec_loop.main(text2vec_loop.parse_args(["--max_steps", "1"]), cfg=t2v_cfg)
    # the CPU is taken only when asked for
    assert next(Generator(v2w_cfg, device="cpu").parameters()).device.type == "cpu"


@pytest.mark.parametrize("flag", ["flash_attention", "compute_dtype", "bf16_serving",
                                  "partial_padding", "input_wav"])
def test_unported_flags_raise(flag):
    """An unported flag raises NotImplementedError naming ROADMAP.md.  The
    Text2Vec flags of the long-bucket slice, ``flash_attention`` and
    ``compute_dtype="bfloat16"``, are ported and build, and so do the bf16
    serving Generator and ``attn_use_partial_padding`` (ConvAttention's
    convolutions become ``PartialConv1d``); a bf16 Vec2Wav config (the bf16
    GAN step) no longer raises: the GAN trainer computes in bf16 and a
    served Generator in f32."""
    if flag == "flash_attention":
        model = Text2Vec(Text2VecConfig(**TINY_T2V, flash_attention=True), device="cpu")
        assert model.encoder.layer_stack[0].slf_attn.use_flash
    elif flag == "compute_dtype":
        v2w = Vec2WavConfig(**TINY_V2W, compute_dtype="bfloat16")
        assert Generator(v2w, device="cpu").conv_pre.compute_dtype is None
        gan = GANTrainer(v2w, device="cpu")
        assert gan.gen.conv_pre.compute_dtype == torch.bfloat16
        assert gan.msd.discriminators[0].convs[1].compute_dtype == torch.bfloat16
        trainer = Text2VecTrainer(Text2VecConfig(**TINY_T2V, compute_dtype="bfloat16"),
                                  device="cpu")
        assert trainer.model.WVF_linear.linear_layer.compute_dtype == torch.bfloat16
    elif flag == "partial_padding":
        model = Text2Vec(Text2VecConfig(**TINY_T2V, attn_use_partial_padding=True), device="cpu")
        assert isinstance(model.attention.key_proj[0].conv, PartialConv1d)
    elif flag == "input_wav":
        # ECAPA's raw-wav front end is not ported: the model, the trainer
        # and serving refuse the config on the CPU before computing anything
        cfg = Text2VecConfig(**TINY_T2V, input_wav=True)
        with pytest.raises(NotImplementedError, match="ROADMAP.md, queue 1 item 11"):
            check_ported(cfg)
        with pytest.raises(NotImplementedError, match="input_wav"):
            Text2Vec(cfg, device="cpu")
        with pytest.raises(NotImplementedError, match="input_wav"):
            Text2VecTrainer(cfg, device="cpu")
    else:
        cfg = Vec2WavConfig(**TINY_V2W)
        state = Generator(cfg, device="cpu").state_dict()
        gen, _ = make_serving_generator(cfg, state, "bf16", device="cpu")
        assert next(gen.parameters()).dtype == torch.bfloat16
        gen, _ = make_serving_generator(cfg, state, device="cpu")
        assert isinstance(gen, Generator) and next(gen.parameters()).dtype == torch.float32
