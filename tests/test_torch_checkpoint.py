"""The port's checkpoint, replay and metrics utilities
(game_engine_tpu_torch/utils/) against the JAX package's: tests/test_checkpoint.py's
cases on the port, and a state, a parameter tree and an ActionLog written
by either package load (and replay) bit-identically in the other."""

import numpy as np
import pytest
import torch

from game_engine_tpu.core.engine import BatchedEngine as JaxEngine
from game_engine_tpu.core.engine import scripted_actions as jax_scripted
from game_engine_tpu.core.state import init_state as jax_init_state
from game_engine_tpu.utils import checkpoint as jckpt
from game_engine_tpu.utils import metrics as JM
from game_engine_tpu_torch.core.engine import BatchedEngine
from game_engine_tpu_torch.core.state import init_state, state_to_numpy
from game_engine_tpu_torch.utils import checkpoint as ckpt
from game_engine_tpu_torch.utils import metrics as M
from tests.test_torch_net import one_torch_thread  # noqa: F401
from tests.test_torch_state import builtin_pair


@pytest.fixture(scope="module")
def pair():
    return builtin_pair("werewolf")


def _run(lw, B, n, seeds, steps):
    eng = BatchedEngine(lw, "cpu")
    state = init_state(lw, B, n, np.asarray(seeds, np.uint32), device="cpu")
    for _ in range(steps):
        state = eng.step(state, eng.bot_actions(state))
    return eng, state


def _states_equal(a, b):
    for name, fa, fb in zip(a._fields, a, b):
        assert fa.dtype == fb.dtype, name
        assert torch.equal(fa, fb), name


def _same_as_jax(state, jst):
    got = state_to_numpy(state)
    for name in jst._fields:
        want = np.asarray(getattr(jst, name))
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)


def test_checkpoint_roundtrip(tmp_path, pair):
    eng, state = _run(pair.port, 4, 5, np.arange(4), 20)
    path = ckpt.save_state(str(tmp_path / "state"), state, step=20)
    assert path.endswith("state_step20.npz")
    restored = ckpt.load_state(path, device="cpu")
    _states_equal(state, restored)
    s1, s2 = state, restored
    for _ in range(15):
        s1 = eng.step(s1, eng.bot_actions(s1))
        s2 = eng.step(s2, eng.bot_actions(s2))
    _states_equal(s1, s2)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_checkpoint_crosses_packages(tmp_path, pair, writer):
    jeng = JaxEngine(pair.jax)
    jst = jax_init_state(pair.jax, 3, 6, np.asarray([5, 2**31 + 7, 2**32 - 1], np.uint32))
    for _ in range(12):
        jst = jeng.step(jst, jax_scripted(pair.jax, jst))
    _, pst = _run(pair.port, 3, 6, [5, 2**31 + 7, 2**32 - 1], 12)
    _same_as_jax(pst, jst)
    p = str(tmp_path / "x")
    if writer == "jax":
        path = jckpt.save_state(p, jst)
        _same_as_jax(ckpt.load_state(path, device="cpu"), jst)
    else:
        path = ckpt.save_state(p, pst)
        back = jckpt.load_state(path)
        for name in jst._fields:
            np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                          np.asarray(getattr(jst, name)), err_msg=name)
            assert getattr(back, name).dtype == getattr(jst, name).dtype, name


def test_action_log_replay(pair):
    lw = pair.port
    seeds = [3, 7, 11]
    eng = BatchedEngine(lw, "cpu")
    state = eng.init(3, 5, np.asarray(seeds, np.uint32))
    log = ckpt.ActionLog(game_name="werewolf", batch=3, n_players=[5, 5, 5], seeds=seeds)
    for _ in range(60):
        a = eng.bot_actions(state)
        log.record(a)
        state = eng.step(state, a)
    _states_equal(state, ckpt.replay(lw, log, device="cpu"))
    assert int(ckpt.replay(lw, log, until=30, device="cpu").t[0]) == 30


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_action_log_crosses_packages(tmp_path, pair, writer):
    """An ActionLog recorded by either package replays bit-identically in
    both: the same file, the same final state."""
    seeds = [4, 9]
    p = str(tmp_path / "log.json")
    if writer == "jax":
        jeng = JaxEngine(pair.jax)
        st = jax_init_state(pair.jax, 2, 6, np.asarray(seeds, np.uint32))
        log = jckpt.ActionLog(game_name="werewolf", batch=2, n_players=[6, 6], seeds=seeds)
        for _ in range(40):
            a = jax_scripted(pair.jax, st)
            log.record(np.asarray(a))
            st = jeng.step(st, a)
    else:
        eng = BatchedEngine(pair.port, "cpu")
        st = eng.init(2, 6, np.asarray(seeds, np.uint32))
        log = ckpt.ActionLog(game_name="werewolf", batch=2, n_players=[6, 6], seeds=seeds)
        for _ in range(40):
            a = eng.bot_actions(st)
            log.record(a)
            st = eng.step(st, a)
    log.save(p)
    jrep = jckpt.replay(pair.jax, jckpt.ActionLog.load(p))
    prep = ckpt.replay(pair.port, ckpt.ActionLog.load(p), device="cpu")
    _same_as_jax(prep, jrep)
    assert int(prep.t[0]) == 40


def test_action_log_persistence(tmp_path):
    log = ckpt.ActionLog(game_name="werewolf", batch=1, n_players=[4], seeds=[0])
    log.record(np.array([[0, 3, 0, 1, 0, 0, 0, 0]], np.int32))
    p = str(tmp_path / "log.json")
    log.save(p)
    loaded = ckpt.ActionLog.load(p)
    np.testing.assert_array_equal(loaded.actions_at(0, 8), log.actions_at(0, 8))
    assert jckpt.ActionLog.load(p).steps == loaded.steps


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tree_checkpoint_crosses_packages(tmp_path, writer):
    tree = {"w0": np.arange(6.0, dtype=np.float32).reshape(2, 3),
            "b0": np.ones(3, np.float32), "a": np.float32([7.0])}
    p = str(tmp_path / "tree.npz")
    if writer == "jax":
        jckpt.save_tree(p, tree, meta={"attn_heads": 1})
    else:
        ckpt.save_tree(p, {k: torch.as_tensor(v) for k, v in tree.items()},
                       meta={"attn_heads": 1})
    out = ckpt.load_tree(p, tree, device="cpu")
    jout = jckpt.load_tree(p, tree)
    for k, v in tree.items():
        np.testing.assert_array_equal(out[k].numpy(), v)
        np.testing.assert_array_equal(np.asarray(jout[k]), v)
    with pytest.raises(ValueError):
        ckpt.load_tree(p, {"other": 1}, device="cpu")


def test_metrics_match_jax(pair):
    jeng = JaxEngine(pair.jax)
    jst = jax_init_state(pair.jax, 8, 5, np.arange(8, dtype=np.uint32))
    for _ in range(120):
        jst = jeng.step(jst, jax_scripted(pair.jax, jst))
    _, pst = _run(pair.port, 8, 5, np.arange(8), 120)
    summary = M.summarize(pair.port, pst)
    assert summary == JM.summarize(pair.jax, jst)
    assert summary["rooms"] == 8 and summary["done_rooms"] >= 1
    assert summary["wins_1"] + summary["wins_2"] == summary["done_rooms"]
    assert M.phase_names(pair.port) == JM.phase_names(pair.jax)


def test_profile_trace_writes_a_trace(tmp_path, pair):
    with M.profile_trace(str(tmp_path / "tr")):
        _run(pair.port, 2, 5, [1, 2], 2)
    assert list((tmp_path / "tr").iterdir())
    with M.profile_trace(None):
        pass
