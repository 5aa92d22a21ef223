"""The native per-room simulator (lib.py over csrc/gamesim.cpp) and the port's
copy of native/pack.py: a Lowered game as the flat int32 blob that it and the
rollout kernel (csrc/room_step.cuh) interpret."""

from game_engine_tpu_torch.native.lib import CppGame, CppRoom, available  # noqa: F401
