"""The CUDA rollout kernel's own logic on the CPU: csrc/room_step.cuh built
with g++ through the host harness (csrc/rollout_host.cpp) against the
plain-torch rollout, exactly, plus the kernel wrapper's layout, packing and
argument checks. The kernel itself runs only on a GPU (chip_smoke.py)."""

import numpy as np
import pytest
import torch

from game_engine_tpu.gamespec.compile import compile_game
from game_engine_tpu.gamespec.parser import load_builtin
from game_engine_tpu.gamespec.tables import lower
from game_engine_tpu.native.pack import pack
from game_engine_tpu_torch.core.engine import make_rollout
from game_engine_tpu_torch.core.rollout_kernel import (
    check_game,
    check_state,
    from_minor,
    game_array,
    host_rollout,
    kernel_rollout,
    to_minor,
)
from game_engine_tpu_torch.core.state import GameState, init_state
from tests.test_int32_semantics import _wrap_lowered
from tests.test_torch_engine import born_done_game
from tests.test_torch_state import catalog_games, lowered_game


def assert_host_matches_plain(lw, B, n, steps, seeds=None):
    seeds = np.arange(B, dtype=np.uint32) if seeds is None else seeds
    got, eps = host_rollout(lw, init_state(lw, B, n, seeds), steps)
    ref, ref_eps = make_rollout(lw, steps)(init_state(lw, B, n, seeds))
    bad = [f for f, x, y in zip(GameState._fields, got, ref) if not torch.equal(x, y)]
    assert not bad, f"fields differ: {bad}"
    assert int(eps) == int(ref_eps)
    return int(eps)


@pytest.mark.parametrize("name,n,steps", [
    ("werewolf", 6, 130), ("werewolf", 8, 200), ("two-truths-and-a-lie", 4, 90),
    ("assassins", 5, 80),
])
def test_kernel_body_matches_plain(name, n, steps):
    assert assert_host_matches_plain(lowered_game(name), 8, n, steps) > 0


def test_kernel_body_overflow_program():
    lw = _wrap_lowered()
    assert_host_matches_plain(lw, 8, 4, 16)
    got, _ = host_rollout(lw, init_state(lw, 8, 4, np.arange(8)), 16)
    nslot = lw.game.layout.num_index("gifts_received")
    assert int(got.nums[0, 0, nslot]) == 46341 * 46341 - 2 ** 32


def test_kernel_body_born_done_rooms():
    n = torch.tensor([4, 5, 4, 6, 5, 4, 6, 5])
    assert assert_host_matches_plain(born_done_game(), 8, n, 60) > 0


def test_kernel_body_twelve_seats():
    from game_engine_tpu.gamespec.compile import GameConfig

    lw = lower(compile_game(load_builtin("werewolf"), GameConfig(max_players=12)))
    assert lw.P == 12
    assert assert_host_matches_plain(lw, 4, torch.tensor([10, 12, 11, 12]), 150) > 0


def test_kernel_body_mixed_sizes_and_seeds():
    lw = lowered_game("werewolf")
    n = torch.tensor([4, 8, 5, 7, 6, 8, 4, 5])
    seeds = torch.tensor([0, 0xFFFFFFFF, 0x7FFFFFFF, 0x80000000, 1, 2, 3, 0xDECAF000])
    assert_host_matches_plain(lw, 8, n, 150, seeds)


@pytest.mark.parametrize("game", catalog_games())
def test_every_catalog_game_kernel_body(game):
    spec = load_builtin(game)
    lw = lower(compile_game(spec))
    n = min(max(spec.declaration.min_players or 4, 4), lw.P)
    assert_host_matches_plain(lw, 4, n, 40)


def test_minor_layout_round_trip():
    lw = lowered_game("werewolf")
    st, _ = make_rollout(lw, 17, auto_reset=False)(
        init_state(lw, 5, 6, np.array([0, 1, 0xFFFFFFFF, 0x80000000, 9])))
    arrs = to_minor(st)
    assert [tuple(a.shape) for a in arrs] == [
        (6, 8, 5), (1, 8, 5), (3, 8, 5), (1, 8, 8, 5), (1, 8, 5), (8, 5), (3, 8, 5), (6, 5)]
    assert all(a.dtype == torch.int32 and a.is_contiguous() for a in arrs)
    assert arrs[7][5].tolist() == [int(np.int32(np.uint32(s))) for s in st.seed.tolist()]
    back = from_minor(arrs)
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(back, st))


def test_game_array_directory():
    lw = lowered_game("werewolf")
    gm = game_array(lw)
    blob = pack(lw)
    assert len(gm) == 32 + len(blob) and gm.dtype == np.int32
    i = 1
    while i + 2 <= len(blob):
        sid, n = int(blob[i]), int(blob[i + 1])
        assert gm[16 + sid] == n
        np.testing.assert_array_equal(gm[gm[sid]:gm[sid] + n], blob[i + 2:i + 2 + n])
        i += 2 + n


def test_wrapper_checks_raise():
    lw = lowered_game("werewolf")
    st = init_state(lw, 2, 6, 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel_rollout(lw, st, 4)  # no silent CPU fallback
    with pytest.raises(ValueError, match="P=8"):
        check_game(lw, np.array([4, 16, 16, 8, 4, 4, 128, 16]))
    check_game(lw, np.array([16, 16, 16, 8, 4, 4, 128, 16]))
    with pytest.raises(ValueError, match="field nums"):
        check_state(lw, st._replace(nums=st.nums.to(torch.int64)))
    with pytest.raises(ValueError, match="field strs has shape"):
        check_state(lw, st._replace(strs=st.strs[:, :, :1]))
    other = lower(compile_game(load_builtin("potlatch")))
    with pytest.raises(ValueError):
        host_rollout(other, st, 4)
