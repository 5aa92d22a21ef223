"""Engine core: state, step, effect interpreter, rollouts and the CUDA rollout kernel."""
