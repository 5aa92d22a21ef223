"""The port's spans (utils/metrics.span) and its record of the CUDA
libraries made ready (_build.libs_ready), on the CPU.

A span is a torch.profiler range while a profiler records, and one shared
no-op context otherwise. The train step carries ge.train_step over
ge.unroll and ge.update; each hand-written entry wrapper on the
benchmark's paths carries ge.entry.<entry>, from its first check on, so a
call that its checks refuse still shows the span.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from game_engine_tpu_torch import _build
from game_engine_tpu_torch.core import step_kernel as SK
from game_engine_tpu_torch.core.rollout_kernel import kernel_rollout
from game_engine_tpu_torch.core.state import init_state
from game_engine_tpu_torch.gamespec.compile import compile_game
from game_engine_tpu_torch.gamespec.parser import load_builtin
from game_engine_tpu_torch.gamespec.tables import lower
from game_engine_tpu_torch.policies import fused as FZ
from game_engine_tpu_torch.policies import net as N
from game_engine_tpu_torch.policies import obs_kernel as OK
from game_engine_tpu_torch.train import ppo as P
from game_engine_tpu_torch.utils import metrics as M


@pytest.fixture(scope="module")
def ww():
    return lower(compile_game(load_builtin("werewolf")))


def _state(lowered, rooms=4, seats=6):
    return init_state(lowered, rooms, seats, np.arange(rooms, dtype=np.uint32), device="cpu")


def _ranges(prof, prefix="ge.") -> list:
    """(name, start us, end us) of the profiler's ranges named prefix..."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith(prefix)]


def test_span_off_is_one_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    a, b = M.span("ge.a"), M.span("ge.b")
    assert a is b
    with a:
        with b:
            pass


def test_span_on_is_a_profiler_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s = M.span("ge.test")
        assert s is not M.span("ge.other")
        with s:
            torch.ones(3).sum()
    assert [name for name, _, _ in _ranges(prof)] == ["ge.test"]


def test_train_step_spans_nest(ww):
    cfg = P.PPOConfig(horizon=2, epochs=1, net=N.NetConfig(hidden=32, arch="mlp"))
    gen = torch.Generator().manual_seed(0)
    params, opt = P.init_training(ww, cfg, gen, device="cpu")
    step = P.make_train_step(ww, cfg)
    state = _state(ww)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, metrics = step(params, opt, state, gen)
    got = {}
    for name, a, b in _ranges(prof):
        got.setdefault(name, []).append((a, b))
    assert sorted(got) == ["ge.train_step", "ge.unroll", "ge.update"]
    assert all(len(v) == 1 for v in got.values())
    (lo, hi), (ua, ub), (pa, pb) = (got[k][0] for k in ("ge.train_step", "ge.unroll",
                                                         "ge.update"))
    assert lo <= ua <= ub <= pa <= pb <= hi
    assert metrics["unroll_ms"] > 0 and metrics["update_ms"] > 0


def _rows(ww):
    """The attn net's dims and two CPU rows (the wrappers take CUDA rows)."""
    d = FZ.dims_for(ww, N.NetConfig(hidden=32, arch="attn"))
    return d, torch.zeros((2, d.F), dtype=torch.bfloat16)


def _k4(ww):
    d, rows = _rows(ww)
    return FZ.kernel_loss_grads(d, rows, torch.zeros((2, 2 * d.A + 5)), {}, 0.2, 0.01)


ENTRIES = {
    "rollout": ("K1", lambda ww: kernel_rollout(ww, _state(ww), 4)),
    "policy_forward": ("K2", lambda ww: FZ.kernel_forward(*_rows(ww), {})),
    "ppo_loss_grad": ("K4", _k4),
    "observe": ("OB", lambda ww: OK.kernel_observe(ww, _state(ww))),
    "rewards": ("OB", lambda ww: OK.kernel_rewards(ww, _state(ww),
                                                   torch.zeros(4, dtype=torch.bool))),
    "sample": ("SA", lambda ww: OK.kernel_sample(torch.zeros((4, 3)),
                                                 torch.ones((4, 3), dtype=torch.bool))),
    "step": ("ST", lambda ww: SK.kernel_step(ww, _state(ww),
                                             torch.zeros((4, 6), dtype=torch.int32))),
    "step_reset": ("ST", lambda ww: SK.kernel_step_reset(
        ww, _state(ww), torch.zeros((4, 6), dtype=torch.int32))),
    "reset_done": ("ST", lambda ww: SK.kernel_reset_done(ww, _state(ww))),
    "bot_actions": ("ST", lambda ww: SK.kernel_bot_actions(ww, _state(ww))),
}


@pytest.mark.parametrize("counter", sorted(ENTRIES))
def test_entry_wrapper_carries_its_span(ww, counter):
    """Each wrapper whose launches parallel/parity.launches counts (K3
    aside: no cell runs it) runs inside ge.entry.<entry>; on CPU tensors
    its checks refuse the call inside the span."""
    from game_engine_tpu_torch.parallel import parity

    assert counter in parity.launches()
    entry, call = ENTRIES[counter]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            call(ww)
    assert f"ge.entry.{entry}" in [name for name, _, _ in _ranges(prof, "ge.entry.")]


def test_entry_wrappers_cover_the_counters():
    from game_engine_tpu_torch.parallel import parity

    counted = set(parity.launches()) - {"policy_backward", "engine_step"}
    assert counted == set(ENTRIES)


def test_build_record_lists_a_library_once(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(_build, "libs_ready", [])
    src = tmp_path / "tiny.cpp"
    src.write_text('extern "C" int tiny() { return 7; }\n')
    job = (str(src), "libtiny", _build._GXX_CMD)
    assert _build._load(job).tiny() == 7
    _build._load(job)
    (rec,) = _build.libs_ready
    assert rec["stem"] == "libtiny" and rec["built"] is True and rec["seconds"] > 0
    monkeypatch.setattr(_build, "libs_ready", [])  # a later process finds it built
    _build._load(job)
    assert [(r["stem"], r["built"]) for r in _build.libs_ready] == [("libtiny", False)]
    assert _build.libs_ready[0]["seconds"] > 0
    # two built in one call run at once: their spans overlap, and each
    # library's seconds are the sum of its own spans
    monkeypatch.setattr(_build, "libs_ready", [])
    jobs = []
    for stem in ("libone", "libtwo"):
        (tmp_path / f"{stem}.cpp").write_text(f'extern "C" int {stem}() {{ return 1; }}\n')
        jobs.append((str(tmp_path / f"{stem}.cpp"), stem, _build._GXX_CMD))
    _build._compile_all(jobs)
    one, two = _build.libs_ready
    assert [(r["stem"], r["built"], len(r["spans"])) for r in (one, two)] == [
        ("libone", True, 1), ("libtwo", True, 1)]
    (a0, a1), (b0, b1) = one["spans"][0], two["spans"][0]
    assert a0 < b1 and b0 < a1
    assert one["seconds"] == pytest.approx(a1 - a0)
