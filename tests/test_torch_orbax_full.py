"""The port's orbax reader on full-size training states of the JAX package
(``tests/orbax_full_size.py``): a ``T2VTrainState`` at
``data/demo/text2vec.json`` written into ``tmp_path`` with the JAX
package, read bit-equal to orbax's own restore; the reader's MB/s of stored
bytes is printed beside orbax's, with the reader's peak memory alone.  The
state then resumes into the port's ``Text2VecTrainer`` on the CPU with
every LAMB moment, ECAPA's included, equal to what the JAX package's
exporter makes of ``mu`` and ``nu``.  Hundreds of MB of writing and
reading on the CPU: ``slow``, outside the tier-1 run."""

import os

import pytest

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from tests import orbax_full_size


@pytest.mark.slow
def test_full_size_text2vec_state_reads_bit_equal(tmp_path):
    import jax
    import numpy as np
    import torch

    from wavthruvec_pytorch_tpu import checkpoint as jckpt
    from wavthruvec_pytorch_tpu.config import Text2VecConfig, load_config
    from wavthruvec_pytorch_tpu_torch import checkpoint as ckpt
    from wavthruvec_pytorch_tpu_torch import config as pconfig
    from wavthruvec_pytorch_tpu_torch.train.text2vec_train import Text2VecTrainer

    json_path = os.path.join(orbax_full_size.REPO, "data", "demo", "text2vec.json")
    cfg = load_config(Text2VecConfig, json_path)
    assert cfg.use_multi_speaker_condition
    path = str(tmp_path / "checkpoint_1")
    state = orbax_full_size.text2vec_state(cfg)
    jckpt.save_checkpoint(path, state)
    row = orbax_full_size.measure(path)
    print(row)
    assert row["stored_bytes"] > 100e6

    # resumed into the port's trainer: every moment, ECAPA's included, as
    # the JAX package's exporter maps the state's mu and nu
    trainer = Text2VecTrainer(pconfig.load_config(pconfig.Text2VecConfig, json_path),
                              device="cpu")
    assert ckpt.load_text2vec(path, trainer) == 0
    lamb = jax.tree_util.tree_map(np.asarray, state.opt_state)
    assert trainer.step_count == int(state.step)
    assert trainer.learning_rate == pytest.approx(float(lamb.hyperparams["learning_rate"]),
                                                  rel=1e-6)
    del state
    n = n_elems = n_ecapa = 0
    for which, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        want = jckpt.export_text2vec({"params": getattr(lamb.inner_state, which)}, cfg)
        for name, p in trainer.model.named_parameters():
            st = trainer.optimizer.state[p]
            if st:
                assert torch.equal(st[key], torch.from_numpy(np.array(want[name]))), \
                    (which, name)
                n, n_elems = n + 1, n_elems + p.numel()
                n_ecapa += name.startswith("encoder.speaker_encoder.")
    assert n_elems == 2 * sum(int(np.size(x)) for x in
                              jax.tree_util.tree_leaves(lamb.inner_state.mu))
    assert n_ecapa > 20
    print(f"resumed: {n // 2} parameters' moments equal to the exporter's, "
          f"{n_ecapa // 2} of ECAPA")
