// rollout_host.cpp — the CUDA rollout kernel's per-room body (room_step.cuh),
// compiled with g++ and looped over rooms on the host. The same signature
// as ge_rollout in rollout.cu, minus the launch arguments; the CPU tests use
// it to run the kernel's own logic without a GPU.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC rollout_host.cpp -o librollout_host.so

#include "room_step.cuh"

extern "C" {

void ge_limits(int32_t* out) { ge::limits(out); }

int ge_rollout_host(const int32_t* game, int game_len, int32_t* bools,
                    int32_t* nums, int32_t* strs, int32_t* pdict, int32_t* odict,
                    int32_t* present, int32_t* regs, int32_t* scal, int32_t* eps,
                    int64_t B, int num_steps, int auto_reset) {
  if (B <= 0 || game_len <= 0) return 1;
  const ge::Game g = ge::game_view(game);
  const ge::MinorState ms{bools, nums, strs, pdict, odict, present, regs, scal};
  for (int64_t room = 0; room < B; ++room) {
    ge::Room r;
    ge::room_load(g, r, ms, room, B);
    eps[room] = ge::room_rollout(g, r, num_steps, auto_reset);
    ge::room_store(g, r, ms, room, B);
  }
  return 0;
}

}  // extern "C"
