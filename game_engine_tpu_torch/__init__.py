"""game_engine_tpu_torch — the batched game engine in PyTorch, with CUDA kernels.

A port of ``game_engine_tpu`` (JAX) to PyTorch on an NVIDIA GPU. Module
names mirror the JAX package so each counterpart is easy to find. The port
stands on its own: it keeps its own copy of the game compiler
(``gamespec``), of ``native/pack.py`` and of the C++ simulator, and
imports neither ``jax`` nor anything of the JAX package. Every entry point runs on the card
(``device="cuda"``) unless the caller asks for the CPU (``device.py``).

Layers:
  gamespec/             the DSL compiler: YAML -> GameSpec -> IR -> Lowered
  native/pack.py        a Lowered game as the rollout kernel's int32 blob
  native/lib.py         the C++ per-room simulator (csrc/gamesim.cpp): CppGame, CppRoom
  core/state.py         GameState NamedTuple of tensors + init_state
  core/effects_exec.py  effect-IR walker (P20)
  core/step.py          the plain-torch engine step
  core/engine.py        scripted bots, rollouts, BatchedEngine
  core/rollout_kernel.py  host side of the CUDA rollout kernel (csrc/)
  core/search_kernel.py   host side of the CUDA search kernel (csrc/search.cu)
  policies/net.py       observe, legal masks, mlp/deepsets/attn nets, checkpoints
  policies/fused.py     host side of the policy-net kernels K2-K4 (csrc/)
  policies/serve.py     greedy policy bots; policies/search.py lookahead search bots
  server/               the HTTP game host (torch and native backends)
  train/ppo.py, run.py  PPO self-play
  bench.py              env-steps/s on the GPU rollout
  utils/eval_search.py  search bots against scripted play
"""

__version__ = "0.1.0"
