"""Random effect-IR programs (tests/test_fuzz_ir.py's typed generator)
through the PyTorch port: the plain-torch step against the oracle step for
step, and the CUDA kernel's per-room body (g++ host harness) against the
plain-torch rollout. Covers deal-with-salt, vocab string writes, dict entry
writes, kill/reset interleavings, `over` mid-game, multi-block snapshot
chains and int32 wraparound. All comparisons are exact."""

import numpy as np
import pytest
import torch

from game_engine_tpu.oracle.interp import OracleRoom
from game_engine_tpu.policies.scripted import oracle_policy
from game_engine_tpu_torch.core.engine import scripted_actions
from game_engine_tpu_torch.core.state import init_state
from game_engine_tpu_torch.core.step import make_step
from tests.test_fuzz_ir import _compiled, _fuzz_doc
from tests.test_parity import assert_state_matches
from tests.test_torch_kernel_host import assert_host_matches_plain
from tests.test_torch_net import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_state import port_lowered_doc


def compiled_pair(fuzz_seed):
    """test_fuzz_ir's accepted random program for `fuzz_seed`, lowered by
    the JAX package and by the port from the same document."""
    lowered, lines, _ = _compiled(fuzz_seed)
    return lowered, port_lowered_doc(_fuzz_doc(lines), f"ir-fuzz-{fuzz_seed}"), lines

SEEDS = range(16)


@pytest.mark.parametrize("fuzz_seed", SEEDS)
def test_random_ir_program_torch_step_vs_oracle(fuzz_seed):
    lowered, port, lines = compiled_pair(fuzz_seed)
    n = 5
    room = OracleRoom(lowered.game, n_players=n, seed=fuzz_seed)
    step = make_step(port)
    state = init_state(port, 1, n, fuzz_seed, device="cpu")
    for t in range(300):
        room.step(oracle_policy(room, t, fuzz_seed))
        state = step(state, scripted_actions(port, state))
        assert_state_matches(lowered, room, state, 0, t)
        if room.done:
            break
    assert room.done, f"episode did not terminate; program: {lines}"


@pytest.mark.parametrize("fuzz_seed", SEEDS)
def test_random_ir_program_kernel_body_vs_plain(fuzz_seed):
    _, port, lines = compiled_pair(fuzz_seed)
    n = torch.tensor([4, 5, 6, 5, 4, 8, 7, 5])
    seeds = np.arange(8, dtype=np.uint32) + 100 * fuzz_seed
    assert assert_host_matches_plain(port, 8, n, 60, seeds) > 0, lines
