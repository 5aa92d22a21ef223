"""The port stands on its own and runs on the card by default.

- Importing every module of game_engine_tpu_torch, and running
  chip_smoke.py up to its CUDA check, loads neither jax nor any module of
  the JAX package (game_engine_tpu.*). Checked in a fresh interpreter.
- Every entry point defaults to device "cuda" and, without a card, raises
  instead of falling back to the CPU. These tests never touch a card: they
  read the signatures and hide the card where one is present.
"""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from game_engine_tpu_torch import bench as BN
from game_engine_tpu_torch import device as D
from game_engine_tpu_torch import graft_entry as G
from game_engine_tpu_torch.core import engine as E
from game_engine_tpu_torch.core import state as S
from game_engine_tpu_torch.policies import chat_lm as LM
from game_engine_tpu_torch.policies import net as N
from game_engine_tpu_torch.policies import serve as SV
from game_engine_tpu_torch.server import api as A
from game_engine_tpu_torch.server import manager as MG
from game_engine_tpu_torch.train import chat_lm as TLM
from game_engine_tpu_torch.train import evaluate as EV
from game_engine_tpu_torch.train import ppo as P
from game_engine_tpu_torch.train import run as R
from game_engine_tpu_torch.parallel import mesh as M
from game_engine_tpu_torch.parallel import parity
from game_engine_tpu_torch.parallel.launch import run_ranks
from game_engine_tpu_torch.train.pipeline import run_pipelined, submeshes
from game_engine_tpu_torch.utils import arena as AR
from game_engine_tpu_torch.utils import bench_games as BG
from game_engine_tpu_torch.utils import eval_exploit as EX
from game_engine_tpu_torch.utils import checkpoint as CK
from game_engine_tpu_torch.utils import eval_chat_probes as ECP
from tests.test_torch_state import builtin_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = """
import importlib, pkgutil, sys
import game_engine_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
{extra}
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "game_engine_tpu."))
             or m == "game_engine_tpu")
assert not bad, bad
print(len(mods))
"""


def _run(code: str) -> subprocess.CompletedProcess:
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=env)


def test_importing_the_whole_port_loads_no_jax_package():
    proc = _run(_NO_JAX.format(extra=""))
    assert proc.returncode == 0, proc.stderr
    # every module was imported, the serving slice's and the chat LM's among them
    assert int(proc.stdout.split()[-1]) >= 45
    names = _run(_NO_JAX.format(extra="print(' '.join(mods))")).stdout
    for mod in ("oracle.interp", "policies.scripted", "policies.chat_lm",
                "policies.chat_decode", "train.chat_lm", "utils.eval_chat_probes",
                "parallel.mesh", "parallel.tp", "parallel.launch", "parallel.parity",
                "graft_entry", "utils.eval_heldout", "utils.bench_games", "bench"):
        assert f"game_engine_tpu_torch.{mod}" in names.split(), mod


def test_chip_smoke_up_to_its_cuda_check_loads_no_jax_package():
    extra = ("import chip_smoke\n"
             "assert not __import__('torch').cuda.is_available()\n"
             "rc = chip_smoke.main()\n"
             "assert rc == 2, rc\n")
    proc = _run(_NO_JAX.format(extra=extra))
    assert proc.returncode == 0, proc.stderr
    assert "no CUDA device" in proc.stderr


ENTRY_POINTS = [
    (S.init_state, "device"), (S.state_from_numpy, "device"),
    (E.BatchedEngine.__init__, "device"), (N.init_params, "device"),
    (N.params_from_numpy, "device"), (N.load_policy, "device"),
    (P.init_training, "device"), (CK.load_state, "device"), (CK.load_tree, "device"),
    (CK.replay, "device"), (SV.load_bot_policies, "device"), (MG.GameHost.__init__, "device"),
    (A.AppContext.__init__, "device"), (A.make_server, "device"),
    (EV.matchup_table, "device"), (run_pipelined, "device"), (AR.run_arena, "device"),
    (EX.run_exploit, "device"), (LM.init_params, "device"), (LM.params_from_numpy, "device"),
    (LM.load, "device"), (LM.make_lm_hook, "device"),
    (M.make_mesh, "device"), (M.mesh_over, "device"), (M.initialize_multihost, "device"),
    (M.Mesh.__init__, "device"), (parity.start_of, "device"),
    (run_ranks, "device"), (submeshes, "device"), (G.entry, "device"),
    (G.dryrun_multichip, "device"), (G._scaling_curve, "device"),
]


@pytest.mark.parametrize("fn,arg", ENTRY_POINTS, ids=[f.__qualname__ for f, _ in ENTRY_POINTS])
def test_entry_point_defaults_to_the_card(fn, arg):
    assert inspect.signature(fn).parameters[arg].default == "cuda" == D.DEFAULT


def test_train_run_device_flag_defaults_to_the_card(monkeypatch):
    seen = {}

    def resolve(device):
        seen["device"] = device
        raise RuntimeError("stop here")

    monkeypatch.setattr(D, "resolve", resolve)
    with pytest.raises(RuntimeError, match="stop here"):
        R.main(["--updates", "0", "--eval-batch", "0"])
    assert seen == {"device": "cuda"}


@pytest.mark.parametrize("main,argv", [
    (EV.main, ["--batch", "2"]), (AR.main, ["werewolf", "1", "scripted"]),
    (EX.main, ["werewolf"]), (TLM.main, ["--steps", "1"]), (ECP.main, ["--no-lm"])],
    ids=["evaluate", "arena", "eval_exploit", "train_chat_lm", "eval_chat_probes"])
def test_evaluation_device_flags_default_to_the_card(monkeypatch, main, argv):
    seen = {}

    def resolve(device):
        seen["device"] = device
        raise RuntimeError("stop here")

    monkeypatch.setattr(D, "resolve", resolve)
    with pytest.raises(RuntimeError, match="stop here"):
        main(argv)
    assert seen == {"device": "cuda"}


@pytest.fixture()
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    pw = builtin_pair("werewolf").port
    cfg = N.NetConfig(hidden=64, arch="attn")
    gen = torch.Generator().manual_seed(0)
    ckpt = os.path.join(REPO, "docs", "checkpoints", "attn_werewolf_u120.npz")
    chat = os.path.join(REPO, "docs", "checkpoints", "chat_lm.npz")
    calls = [
        lambda: S.init_state(pw, 2, 6, 0),
        lambda: S.state_from_numpy(S.state_to_numpy(S.init_state(pw, 2, 6, 0, device="cpu"))),
        lambda: E.BatchedEngine(pw),
        lambda: N.init_params(gen, N.obs_dim(pw), N.action_space(pw), cfg, pw),
        lambda: N.params_from_numpy({"w": np.zeros(3, np.float32)}),
        lambda: N.load_policy(os.path.join(REPO, "docs", "checkpoints",
                                           "attn_werewolf_u120.npz")),
        lambda: P.init_training(pw, P.PPOConfig(net=cfg), gen),
        lambda: R.main(["--updates", "0", "--eval-batch", "0"]),
        lambda: MG.GameHost(),
        lambda: A.make_server(port=0),
        lambda: SV.load_bot_policies([os.path.join(REPO, "docs", "checkpoints",
                                                    "attn_werewolf_u120.npz")]),
        lambda: EV.main(["--batch", "2", "--steps", "1"]),
        lambda: EV.main(["--batch", "2", "--steps", "1", "--matchup", ckpt]),
        lambda: run_pipelined(pw, P.PPOConfig(net=cfg), {}, None,
                              S.init_state(pw, 2, 6, 0, device="cpu"), gen, 1),
        lambda: AR.main(["werewolf", "1", "scripted"]),
        lambda: EX.main(["werewolf", ckpt, "1", "2", "8"]),
        lambda: LM.load(chat),
        lambda: LM.make_lm_hook(chat),
        lambda: LM.init_params(gen, LM.LMConfig()),
        lambda: MG.GameHost(chat_lm=chat),
        lambda: TLM.main(["--steps", "1"]),
        lambda: ECP.main(["--no-lm"]),
        lambda: M.make_mesh(),
        lambda: M.Mesh(np.zeros((1, 1)), 0),
        lambda: parity.start_of({"game": "werewolf", "rooms": 2, "seats": 6}),
        lambda: M.initialize_multihost("localhost:29500", 2, 0),
        lambda: run_ranks(parity.engine_rollout, 2, {}),
        lambda: G.entry(),
        lambda: G.dryrun_multichip(2),
        lambda: G._scaling_curve(2),
        lambda: BG.main(["8", "2", "1"]),
        lambda: BG.bench_game("werewolf", 8, 2, 1),
        lambda: BN.policy_rollout_bench(8, 2, 1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert BN.main(["--policy", "8", "2", "1"]) == 2 and BN.main([]) == 2


def test_resolve_refuses_other_devices():
    assert D.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        D.resolve("meta")
