"""game_engine_tpu_torch — the batched game engine in PyTorch, with CUDA kernels.

A port of ``game_engine_tpu`` (JAX) to PyTorch on an NVIDIA GPU. Module
names mirror the JAX package so each counterpart is easy to find; the
numpy-only layers (``gamespec``, ``oracle``, ``native.pack``,
``policies.scripted``, ``dslgen``) are shared by import, and nothing here
imports ``jax``.

Layers:
  core/state.py         GameState NamedTuple of tensors + init_state
  core/effects_exec.py  effect-IR walker (P20)
  core/step.py          the plain-torch engine step
  core/engine.py        scripted bots, rollouts, BatchedEngine
  core/rollout_kernel.py  host side of the CUDA rollout kernel (csrc/)
  bench.py              env-steps/s on the GPU rollout
"""

__version__ = "0.1.0"
