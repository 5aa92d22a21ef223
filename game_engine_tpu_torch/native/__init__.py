"""The port's copy of native/pack.py: a Lowered game as the flat int32 blob
that the rollout kernel (csrc/room_step.cuh) interprets."""
