"""`correct` has to fail a broken timed path and the controls. Each test
skips the harness's look for a card and drives the rest of a run on the
CPU at a small size, with the program's plain paths, under the cell's own
limits: a sound run passes, and each fault that the cell can have (a step
that returns its state unchanged, half of the batch left out with the mean
over the rest, an answer altered where it is produced) fails it. One card
has no exchange between chips to leave out. The controls (the reference
in the program's place, in a lower precision or without the auto-reset
the configuration guarantees) fail it too; portbench/control.py reads
them at the cells' own sizes on the card."""

import copy

import pytest
import torch

from portbench import control, harness, spec

SEED = 2 ** 33 + 17


def _small(name):
    cell = spec.cell(name)
    cell.config = copy.deepcopy(cell.config)
    if cell.traffic == "rollout":
        cell.workload = dict(cell.workload, rooms=48, steps_per_call=48)
    else:
        cell.workload = dict(cell.workload, rooms=6, checked_steps=2)
        cell.config["ppo"].update(horizon=6, epochs=2)
    return cell


def _correct(cell) -> bool:
    driver = spec.load_module("drivers", cell.traffic)
    run = driver.run(cell, SEED, 0.3, False, harness.now(), device="cpu")
    return all(c.ok for c in run.checks)


# --- the rollout cells -------------------------------------------------------

def _unchanged(real):
    return lambda lowered, state, steps, auto_reset=True: (
        state, torch.zeros((), dtype=torch.int64))


def _half(real):
    def rollout(lowered, state, steps, auto_reset=True):
        half = state.present.shape[0] // 2
        top, eps = real(lowered, type(state)(*(x[:half] for x in state)), steps, auto_reset)
        return type(state)(*(torch.cat([a, b[half:]]) for a, b in zip(top, state))), eps * 2
    return rollout


def _altered(real):
    def rollout(lowered, state, steps, auto_reset=True):
        out, eps = real(lowered, state, steps, auto_reset)
        out.t[0] += 1
        return out, eps
    return rollout


@pytest.mark.parametrize("name", ["werewolf8.rollout", "two-truths8.rollout"])
def test_a_sound_rollout_run_is_correct(name):
    assert _correct(_small(name))


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("name", ["werewolf8.rollout", "two-truths8.rollout"])
def test_a_broken_rollout_is_not_correct(monkeypatch, name, fault):
    from game_engine_tpu_torch.core import engine

    monkeypatch.setattr(engine, "rollout", fault(engine.rollout))
    assert not _correct(_small(name))


@pytest.mark.parametrize("name", ["werewolf8.rollout", "two-truths8.rollout"])
def test_the_rollout_control_is_not_correct(name):
    checks = control.rollout_control(_small(name), SEED, "no_reset", "cpu")
    assert not all(c.ok for c in checks)


# --- the train cell ----------------------------------------------------------

def test_a_sound_train_run_is_correct():
    assert _correct(_small("werewolf8.train"))


def _train_unchanged(monkeypatch):
    from game_engine_tpu_torch.train import ppo

    real = ppo.make_update

    def make_update(*a, **k):
        grad_fn = ppo.make_grad_fn(*a, **k)

        def update(params, opt, traj, adv, ret):  # the gradient, and no step
            loss, metrics, _ = grad_fn(params, traj, adv, ret)
            return loss, metrics
        return update

    assert real is not None
    monkeypatch.setattr(ppo, "make_update", make_update)


def _train_half(monkeypatch):
    from game_engine_tpu_torch.policies import fused

    real = fused.make_loss_vg

    def make_loss_vg(*a, **k):
        loss_vg = real(*a, **k)

        def half(params, *xs):  # rooms are axis 1 of (T, B, P, ...)
            return loss_vg(params, *(x[:, :x.shape[1] // 2] for x in xs))
        return half

    monkeypatch.setattr(fused, "make_loss_vg", make_loss_vg)


def _train_altered(monkeypatch):
    from game_engine_tpu_torch.policies import net

    real = net.sample_actions

    def sample_actions(*a, **k):  # room 0's actors' choices moved to another legal one
        actions, logp, value, legal = real(*a, **k)
        actor = k.get("actor")
        if actor is not None and bool(actor[0].any()):
            actions = actions.clone()
            for p in actor[0].nonzero()[:, 0].tolist():
                ok = [c + 1 for c in legal[0, p].nonzero()[:, 0].tolist()]
                if len(ok) > 1:
                    actions[0, p] = ok[(ok.index(int(actions[0, p])) + 1) % len(ok)]
        return actions, logp, value, legal

    monkeypatch.setattr(net, "sample_actions", sample_actions)


@pytest.mark.parametrize("fault", [_train_unchanged, _train_half, _train_altered])
def test_a_broken_train_step_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not _correct(_small("werewolf8.train"))


@pytest.mark.parametrize("mode", ["fp8", "half", "altered"])
def test_the_train_control_is_not_correct(mode):
    checks = control.train_control(_small("werewolf8.train"), SEED, mode, "cpu")
    assert not all(c.ok for c in checks)
