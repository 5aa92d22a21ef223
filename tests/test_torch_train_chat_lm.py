"""train/chat_lm.py of the port on the CPU: a few tiny steps with the loss
falling, the checkpoint in the JAX module's format (it loads in the JAX
package), the held-out evaluation's metrics written beside it, and
--eval-ckpt evaluating a saved checkpoint alone."""

import json

import numpy as np
import pytest

from game_engine_tpu.policies import chat_lm as J
from game_engine_tpu_torch.train import chat_lm as TR
from tests.test_torch_net import one_torch_thread  # noqa: F401

# small tensors in loops: one intra-op thread, as the other port tests
pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = ["--device", "cpu", "--d-model", "32", "--layers", "2", "--max-len", "576",
        "--seeds", "2", "--max-pairs", "120", "--batch", "8", "--lr", "3e-3"]


def test_tiny_training_run(tmp_path, one_torch_thread, capsys, monkeypatch):
    monkeypatch.setattr(TR, "EVAL_PAIRS", 16)  # the held-out decodes of a CPU run
    out = str(tmp_path / "lm.npz")
    res = TR.main(TINY + ["--steps", "12", "--lr-decay", "--out", out])
    losses = res["losses"]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert res["corpus_pairs"] > 0
    params, cfg = J.load(out)
    assert cfg == J.LMConfig(d_model=32, n_layers=2, max_len=576, grounded=True,
                             personas=True, kinds2=True, sus2=True)
    assert params["w11"].shape == (32, 128)
    with open(str(tmp_path / "lm.metrics.json")) as f:
        metrics = json.load(f)
    assert metrics == res["metrics"] and metrics["eval_pairs"] == 16
    assert metrics["eval_seed_start"] == 2
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith('{"step"')]
    assert [p["step"] for p in printed] == [0, 11]
    again = TR.main(TINY + ["--eval-ckpt", out])
    assert again["metrics"] == metrics
