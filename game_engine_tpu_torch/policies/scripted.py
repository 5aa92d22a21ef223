"""Deterministic scripted bot policy, identical in Python, torch and CUDA.

Counterpart of game_engine_tpu/policies/scripted.py, over the port's own
gamespec.

Replaces the reference's BotBehaviorNode LLM (reference:
agent/game_agent_v2.py:468-617; legality rules in
agent/prompt/bot_behavior_system_prompt.txt: only targeted players act, one
action per phase, targets must be alive). Choices are uniform over the legal
set, driven by a counter-based splitmix32 stream keyed on
(seed, step, player) so the plain-Python oracle and the jitted engine draw
bit-identical actions — this is what makes golden-parity tests exact.
"""

from __future__ import annotations

from game_engine_tpu_torch.gamespec.mechanics import ChoiceKind, splitmix32

_GOLDEN = 0x9E3779B9
_MIX = 0x85EBCA6B


def action_hash(seed: int, step: int, pid: int) -> int:
    """32-bit decision stream shared by oracle and engine."""
    h = splitmix32((seed * _MIX + step) & 0xFFFFFFFF)
    return splitmix32((h ^ (pid * _GOLDEN)) & 0xFFFFFFFF)


def pick_from_mask(h: int, mask: list[bool]) -> int:
    """k-th legal index (1-based id) with k = h % count; 0 if none legal."""
    count = sum(mask)
    if count == 0:
        return 0
    k = h % count
    seen = 0
    for i, ok in enumerate(mask):
        if ok:
            if seen == k:
                return i + 1
            seen += 1
    return 0


def oracle_policy(room, step_idx: int, seed: int) -> dict[int, int]:
    """Actions for every targeted-but-unacted player of an OracleRoom."""
    from game_engine_tpu_torch.gamespec.schema import CompletionType

    phase = room.phase
    if room.done or phase.completion is not CompletionType.PLAYER_ACTION:
        return {}
    rp = phase.program.record
    out: dict[int, int] = {}
    for pid in room._targets(phase):
        if pid in room.acted:
            continue
        h = action_hash(seed, step_idx, pid)
        if rp.choice_kind is ChoiceKind.TARGET:
            alive = [bool(room.players[p].get("is_alive", True)) for p in range(1, room.n + 1)]
            out[pid] = pick_from_mask(h, alive)
        elif rp.choice_kind is ChoiceKind.OPTION:
            hi = rp.choice_max if rp.choice_max > 0 else room.n
            out[pid] = 1 + (h % hi)
        else:  # SUBMIT
            out[pid] = 1
    return out


# The vectorized torch twin of oracle_policy lives in
# game_engine_tpu_torch.core.engine.scripted_actions (same splitmix32 stream);
# the in-kernel twin is room_policy in csrc/room_step.cuh.
