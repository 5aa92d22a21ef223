// observe.cuh — the per-room bodies of OB, the observation entry, and SA, the
// sampling entry (csrc/observe.cu; host harness csrc/observe_host.cpp).
//
// They are the port's counterparts of what the JAX package fuses around its
// policy-forward pallas_call inside the learner's jitted unroll
// (game_engine_tpu/train/ppo.py make_unroll): the observation
// (policies/net.py observe), the legal-action mask (legal_action_mask), the
// actor mask and the terminal rewards (train/ppo.py actor_mask,
// terminal_rewards), and the categorical draw and log-softmax of
// sample_actions. Each reads GameState's own tensors in their own dtypes
// (room_step.cuh BatchState) and is bit-identical to the port's plain
// functions (game_engine_tpu_torch/policies/net.py observe_plain,
// legal_action_mask_plain, actor_mask_plain; train/ppo.py
// terminal_rewards_plain), logp within float rounding of log_softmax.
//
// OB is bound by writing the observation, (B, P, F) bf16, which is most of
// its bytes. A block takes R whole rooms (rooms_per_block): it stages
// each room's per-seat facts (team, flags) and each target's F0 unmasked
// feature values (bf16 bits) in shared memory, writes the small legal and
// actor masks, and then writes its rooms' stretch of the observation in
// aligned runs of 8 elements (16-byte stores), each element being a lookup
// of the staged values and a visibility test of viewer against target.
// The game's own facts (the field list with each field's visibility, the
// team and reveal slots, the per-phase action tables) come from a small
// int32 table built on the host (policies/obs_kernel.py ob_table); the
// phase's target predicate is room_step.cuh's pred_eval over the game blob,
// as the engine step's acceptance evaluates it.
//
// SA takes a row (room, seat) a thread: the legal-masked logits plus the
// Gumbel noise -log(-log(max(u, FLT_MIN))) of the caller's uniforms (or the
// caller's noise as it is, or none), the first index of the maximum, and
// the log-softmax of the masked logits at it. logf is the library's
// correctly rounded one: the build passes no --use_fast_math.
#pragma once

#include <float.h>
#include <math.h>
#include <string.h>

#include "room_step.cuh"

namespace ob {

using ge::BatchState;
using ge::Game;

// table header ints (ob_table in policies/obs_kernel.py writes them)
enum {
  T_P, T_NP, T_F0, T_F, T_A, T_TEAM_SLOT, T_MINORITY, T_HAS_MINORITY, T_REVEAL_SLOT,
  T_ALIVE_BOOL, T_NB, T_NN, T_NS, T_RW_MODE, T_RW_TEAM_SLOT, T_N_CODES, T_COLS, T_PHASES,
  T_CODES, T_LEN, HDR = 20
};
// a column of a target's features: {source, slot, one-hot code, visibility, reveal}
constexpr int COL = 5;
enum { SRC_BOOL, SRC_NUM, SRC_STR, SRC_ACTED, SRC_ALIVE };
enum { VIS_PUBLIC, VIS_SELF, VIS_TEAM, VIS_ACTED };
// a phase: {who-acted is public, choice kind, choice max, is an action, target predicate}
constexpr int PH = 5;
enum { RW_NONE, RW_TEAM, RW_SCORE };
// sampling modes: the noise is uniforms (Gumbel made here), Gumbel noise as
// it is, or absent (greedy)
enum { SA_UNIFORM, SA_GUMBEL, SA_GREEDY };

constexpr uint16_t BF16_ONE = 0x3F80;
constexpr int CHUNK = 8;                // observation elements a 16-byte store
constexpr int64_t TARGET_ELEMS = 16384; // observation elements a block aims at
constexpr int MAX_ROOMS = 64;           // rooms a block at most

struct Table {
  int P, NP, F0, F, A, team_slot, minority, has_minority, reveal_slot, alive_bool, NB, NN, NS,
      rw_mode, rw_team_slot, n_codes;
  const int32_t *cols, *phases, *codes;
};

GE_HD Table table_view(const int32_t* t) {
  Table x;
  x.P = t[T_P]; x.NP = t[T_NP]; x.F0 = t[T_F0]; x.F = t[T_F]; x.A = t[T_A];
  x.team_slot = t[T_TEAM_SLOT]; x.minority = t[T_MINORITY]; x.has_minority = t[T_HAS_MINORITY];
  x.reveal_slot = t[T_REVEAL_SLOT]; x.alive_bool = t[T_ALIVE_BOOL];
  x.NB = t[T_NB]; x.NN = t[T_NN]; x.NS = t[T_NS];
  x.rw_mode = t[T_RW_MODE]; x.rw_team_slot = t[T_RW_TEAM_SLOT]; x.n_codes = t[T_N_CODES];
  x.cols = t + t[T_COLS]; x.phases = t + t[T_PHASES]; x.codes = t + t[T_CODES];
  return x;
}

// Whether a table is whole and agrees with the game blob's header.
inline bool table_ok(const int32_t* t, int len, const Game& g) {
  if (len < HDR || t[T_LEN] != len) return false;
  const Table x = table_view(t);
  return x.P == g.P && x.NP == g.NP && x.NB == g.NB && x.NN == g.NN && x.NS == g.NS &&
         x.P >= 1 && x.P <= ge::MAX_SEATS && x.F0 >= 2 && x.A >= 1 &&
         x.F == x.P * x.F0 + x.P + x.NP + 1 && t[T_COLS] + x.F0 * COL <= len &&
         t[T_PHASES] + x.NP * PH <= len && t[T_CODES] + x.n_codes <= len;
}

// float <-> bf16 bits, rounding to nearest even (c10::BFloat16's rule)
GE_HD uint32_t float_bits(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(f);
#else
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
#endif
}

GE_HD float bits_float(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, 4);
  return f;
#endif
}

GE_HD uint16_t bf16_bits(float f) {
  const uint32_t u = float_bits(f);
  return (uint16_t)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

GE_HD float bf16_float(uint16_t b) { return bits_float((uint32_t)b << 16); }

// x / P as the plain path rounds it: x cast to bf16 first, the quotient of
// the two bf16 values taken in f32 and rounded to bf16
GE_HD uint16_t per_seat(int32_t x, int P) {
  return bf16_bits(bf16_float(bf16_bits((float)x)) / (float)P);
}

// Room i's banks read in place as room_step.cuh's words (a flag 0/1, an
// int8 sign-extended): what pred_eval's atoms read.
struct BankView {
  const Game* g;
  const BatchState* s;
  int64_t i;
  GE_HD int32_t at(int slot, int p) const {
    const ge::Layout& L = g->L;
    const int64_t row = i * g->P + p;
    if (slot < L.nums) return s->bools[row * g->NB + (slot - L.bools)] != 0;
    if (slot < L.strs) return s->nums[row * g->NN + (slot - L.nums)];
    return s->strs[row * g->NS + (slot - L.strs)];
  }
};

// A block's shared words for R rooms of P seats and F0 features a target.
struct Stage {
  int32_t* team;   // R * P: the seat's team code (0 without a team slot)
  int32_t* flags;  // R * P: FLAG_*
  int32_t* scal;   // R * 3: phase, seats alive, seats present
  uint16_t* raw;   // R * P * F0: target t's feature j, unmasked, bf16 bits
};
enum { FLAG_ALIVE = 1, FLAG_REVEALED = 2, FLAG_PRESENT = 4, FLAG_ACTED = 8 };

GE_HD int64_t stage_words(const Table& x, int R) {
  return (int64_t)R * x.P * 2 + (int64_t)R * 3 + ((int64_t)R * x.P * x.F0 + 1) / 2;
}

GE_HD Stage stage_of(int32_t* w, const Table& x, int R) {
  Stage st;
  st.team = w;
  st.flags = w + R * x.P;
  st.scal = w + 2 * R * x.P;
  st.raw = (uint16_t*)(w + 2 * R * x.P + 3 * R);
  return st;
}

// Rooms a block of OB: enough for about TARGET_ELEMS observation elements.
GE_HD int rooms_per_block(const Table& x) {
  const int64_t per_room = (int64_t)x.P * x.F;
  int64_t R = (TARGET_ELEMS + per_room - 1) / per_room;
  return (int)(R < 1 ? 1 : R > MAX_ROOMS ? MAX_ROOMS : R);
}

// How a launch of OB over the game's table (host arrays) is sized: *R rooms
// a block and *bytes of shared memory a block; false for a bad table.
inline bool plan_of(const int32_t* game, const int32_t* table, int table_len, int* R,
                    int64_t* bytes) {
  if (!table_ok(table, table_len, ge::game_view(game))) return false;
  const Table x = table_view(table);
  *R = rooms_per_block(x);
  *bytes = stage_words(x, *R) * (int64_t)sizeof(int32_t);
  return true;
}

// Stage 1 (worker tid of n): each seat's team and flags, each room's phase.
GE_HD void stage_seats(const Table& x, const BatchState& s, const Stage& st, int R,
                       int64_t room0, int64_t B, int tid, int n) {
  const int P = x.P;
  for (int k = tid; k < R * P; k += n) {
    const int64_t i = room0 + k / P;
    if (i >= B) continue;
    const int64_t row = i * P + k % P;
    const bool present = s.present[row] != 0;
    const uint8_t* b = s.bools + row * x.NB;
    const bool alive = present && (x.alive_bool < 0 || b[x.alive_bool] != 0);
    int f = alive ? FLAG_ALIVE : 0;
    if (x.reveal_slot >= 0 && b[x.reveal_slot]) f |= FLAG_REVEALED;
    if (present) f |= FLAG_PRESENT;
    if (s.acted[row]) f |= FLAG_ACTED;
    st.flags[k] = f;
    st.team[k] = x.team_slot >= 0 ? (int32_t)s.strs[row * x.NS + x.team_slot] : 0;
  }
  for (int r = tid; r < R; r += n)
    if (room0 + r < B) st.scal[3 * r] = s.phase[room0 + r];
}

// Stage 2: each room's seats alive and present (a room a worker).
GE_HD void stage_counts(const Table& x, const Stage& st, int R, int64_t room0, int64_t B,
                        int tid, int n) {
  for (int r = tid; r < R; r += n) {
    if (room0 + r >= B) continue;
    int alive = 0, present = 0;
    for (int p = 0; p < x.P; ++p) {
      alive += (st.flags[r * x.P + p] & FLAG_ALIVE) != 0;
      present += (st.flags[r * x.P + p] & FLAG_PRESENT) != 0;
    }
    st.scal[3 * r + 1] = alive;
    st.scal[3 * r + 2] = present;
  }
}

// the phase's row of the table, or null for a phase out of range
GE_HD const int32_t* phase_row(const Table& x, int32_t phase) {
  return phase >= 0 && phase < x.NP ? x.phases + phase * PH : nullptr;
}

// Stage 3: the targets' unmasked features; the legal mask (B, P, A) and the
// actor mask (B, P) of the block's rooms (either may be null).
GE_HD void stage_features(const Table& x, const Game& g, const BatchState& s, const Stage& st,
                          uint8_t* legal, uint8_t* actor, int R, int64_t room0, int64_t B,
                          int tid, int n) {
  const int P = x.P, F0 = x.F0, A = x.A;
  for (int k = tid; k < R * P * F0; k += n) {
    const int r = k / (P * F0), t = (k / F0) % P, j = k % F0;
    const int64_t i = room0 + r;
    if (i >= B) continue;
    const int64_t row = i * P + t;
    const int32_t* c = x.cols + j * COL;
    uint16_t v = 0;
    switch (c[0]) {
      case SRC_BOOL: v = s.bools[row * x.NB + c[1]] ? BF16_ONE : 0; break;
      case SRC_NUM: v = per_seat(s.nums[row * x.NN + c[1]], P); break;
      case SRC_STR: v = (int32_t)s.strs[row * x.NS + c[1]] == c[2] ? BF16_ONE : 0; break;
      case SRC_ACTED: v = (st.flags[r * P + t] & FLAG_ACTED) ? BF16_ONE : 0; break;
      default: v = (st.flags[r * P + t] & FLAG_ALIVE) ? BF16_ONE : 0; break;
    }
    st.raw[k] = v;
  }
  if (legal) {
    for (int k = tid; k < R * P * A; k += n) {
      const int r = k / (P * A), c = k % A + 1;  // the 1-based choice
      const int64_t i = room0 + r;
      if (i >= B) continue;
      const int32_t* ph = phase_row(x, st.scal[3 * r]);
      const int kind = ph ? ph[1] : ge::K_NONE, kmax = ph ? ph[2] : 0;
      bool ok;
      if (kind == ge::K_TARGET) ok = c <= P && (st.flags[r * P + c - 1] & FLAG_ALIVE);
      else if (kind == ge::K_OPTION) ok = c <= (kmax > 0 ? kmax : st.scal[3 * r + 2]);
      else ok = c == 1;
      legal[i * P * A + (k - r * P * A)] = ok;
    }
  }
  if (actor) {
    for (int k = tid; k < R * P; k += n) {
      const int r = k / P, p = k % P;
      const int64_t i = room0 + r;
      if (i >= B) continue;
      const int32_t* ph = phase_row(x, st.scal[3 * r]);
      const int f = st.flags[k];
      bool a = ph && ph[3] && (f & FLAG_PRESENT) && !(f & FLAG_ACTED) && !s.done[i];
      if (a) {
        const BankView view{&g, &s, i};
        a = ge::pred_eval(g, view, ph[4], p);
      }
      actor[i * P + p] = a;
    }
  }
}

// Whether viewer v sees column j of target t in room r (masked view).
GE_HD bool visible(const Table& x, const Stage& st, int r, int v, int t, const int32_t* c,
                   bool pub) {
  const int vis = c[3];
  if (vis == VIS_PUBLIC || v == t) return true;
  if (vis == VIS_ACTED) return pub;
  if (c[4] && (st.flags[r * x.P + t] & FLAG_REVEALED)) return true;
  if (vis == VIS_SELF) return false;
  // VIS_TEAM: a teammate, and only the coordinating team sees its own
  const int32_t tv = st.team[r * x.P + v];
  return x.team_slot >= 0 && tv != 0 && tv == st.team[r * x.P + t] &&
         (!x.has_minority || tv == x.minority);
}

// A position in a block's stretch of the observation: room r, viewer v,
// feature f (of target t, column j while f < P * F0).
struct Cursor {
  int r, v, f, t, j;
};

GE_HD Cursor cursor_at(const Table& x, int64_t e) {  // e: from the block's first room
  const int64_t PF = (int64_t)x.P * x.F;
  Cursor q;
  q.r = (int)(e / PF);
  const int k = (int)(e - q.r * PF);
  q.v = k / x.F;
  q.f = k % x.F;
  q.t = q.f / x.F0;
  q.j = q.f % x.F0;
  return q;
}

GE_HD void advance(const Table& x, Cursor& q) {
  ++q.f;
  if (++q.j == x.F0) { q.j = 0; ++q.t; }
  if (q.f == x.F) {
    q.f = q.t = q.j = 0;
    if (++q.v == x.P) { q.v = 0; ++q.r; }
  }
}

// the observation element at q (bf16 bits)
GE_HD uint16_t element(const Table& x, const Stage& st, const Cursor& q, bool masked) {
  const int P = x.P, room_w = P * x.F0;
  const int32_t phase = st.scal[3 * q.r];
  if (q.f < room_w) {
    const uint16_t v = st.raw[(q.r * P + q.t) * x.F0 + q.j];
    if (!masked || v == 0) return v;
    const int32_t* ph = phase_row(x, phase);
    return visible(x, st, q.r, q.v, q.t, x.cols + q.j * COL, ph && ph[0]) ? v : 0;
  }
  if (q.f < room_w + P) return q.f - room_w == q.v ? BF16_ONE : 0;
  if (q.f < room_w + P + x.NP) return q.f - room_w - P == phase ? BF16_ONE : 0;
  return per_seat(st.scal[3 * q.r + 1], P);
}

GE_HD void store_chunk(uint16_t* at, const uint16_t* v) {
#ifdef __CUDA_ARCH__
  uint4 u;
  u.x = v[0] | ((uint32_t)v[1] << 16);
  u.y = v[2] | ((uint32_t)v[3] << 16);
  u.z = v[4] | ((uint32_t)v[5] << 16);
  u.w = v[6] | ((uint32_t)v[7] << 16);
  *(uint4*)at = u;
#else
  memcpy(at, v, CHUNK * sizeof(uint16_t));
#endif
}

// Stage 4: the block's rooms' stretch [E0, E1) of the flat observation, in
// runs of CHUNK elements aligned in the whole tensor (obs is 16-byte
// aligned): a run inside the stretch is one 16-byte store, a run across its
// ends is written element by element, each block its own part.
GE_HD void stage_obs(const Table& x, const Stage& st, uint16_t* obs, int R, int64_t room0,
                     int64_t B, bool masked, int tid, int n) {
  const int64_t PF = (int64_t)x.P * x.F;
  const int64_t rooms = (room0 + R < B ? room0 + R : B) - room0;
  if (rooms <= 0) return;
  const int64_t E0 = room0 * PF, E1 = E0 + rooms * PF;
  const int64_t c0 = E0 / CHUNK, c1 = (E1 + CHUNK - 1) / CHUNK;
  for (int64_t c = c0 + tid; c < c1; c += n) {
    const int64_t a = c * CHUNK > E0 ? c * CHUNK : E0;
    const int64_t b = c * CHUNK + CHUNK < E1 ? c * CHUNK + CHUNK : E1;
    Cursor q = cursor_at(x, a - E0);
    if (a == c * CHUNK && b == a + CHUNK) {
      uint16_t v[CHUNK];
      for (int k = 0; k < CHUNK; ++k) {
        v[k] = element(x, st, q, masked);
        advance(x, q);
      }
      store_chunk(obs + a, v);
    } else {
      for (int64_t e = a; e < b; ++e) {
        obs[e] = element(x, st, q, masked);
        advance(x, q);
      }
    }
  }
}

// Terminal rewards of seat (room i, seat p): paid where the step ended the
// room's episode and the seat is present; team mode +1 when the seat's
// team is the winner's team code, else -1; score mode +1 to the winning
// seat, -1 / max(n - 1, 1) to the others of the n present.
GE_HD float reward_of(const Table& x, const BatchState& s, const uint8_t* ended, int64_t i,
                      int p, int n_present) {
  const int64_t row = i * x.P + p;
  if (!ended[i] || !s.present[row]) return 0.0f;
  if (x.rw_mode == RW_TEAM) {
    int w = s.winner[i] - 1;
    w = w < 0 ? 0 : w > x.n_codes - 1 ? x.n_codes - 1 : w;
    return (int32_t)s.strs[row * x.NS + x.rw_team_slot] == x.codes[w] ? 1.0f : -1.0f;
  }
  if (x.rw_mode == RW_SCORE) {
    const float m = (float)(n_present - 1);
    return s.winner[i] == p + 1 ? 1.0f : -1.0f / (m > 1.0f ? m : 1.0f);
  }
  return 0.0f;
}

GE_HD int count_present(const Table& x, const BatchState& s, int64_t i) {
  int n = 0;
  for (int p = 0; p < x.P; ++p) n += s.present[i * x.P + p] != 0;
  return n;
}

// -- SA ------------------------------------------------------------------------

// -log(-log(max(u, FLT_MIN))): torch.rand's uniform as sample_actions turns it
GE_HD float gumbel_of(float u) { return -logf(-logf(u > FLT_MIN ? u : FLT_MIN)); }

// Row `row` of A choices: the first index of the largest masked logit plus
// noise (none when greedy), its 1-based action, the actor-masked action
// (greedy: also 0 where no choice is legal) and the log-softmax of the
// masked logits at it.
GE_HD void sample_row(const float* logits, const uint8_t* legal, const float* noise,
                      const uint8_t* actor, int32_t* actions, int32_t* masked, float* logp,
                      int64_t row, int A, int mode) {
  const float* l = logits + row * A;
  const uint8_t* ok = legal + row * A;
  const float* z = noise ? noise + row * A : nullptr;
  int best = 0;
  float best_x = 0.0f, mx = 0.0f;
  bool any_legal = false;
  for (int c = 0; c < A; ++c) {
    const float m = ok[c] ? l[c] : -1e9f;
    any_legal |= ok[c] != 0;
    float xv = m;
    if (mode == SA_UNIFORM) xv = m + gumbel_of(z[c]);
    else if (mode == SA_GUMBEL) xv = m + z[c];
    if (c == 0 || xv > best_x) { best = c; best_x = xv; }  // NaN-free: first max kept
    if (c == 0 || m > mx) mx = m;
  }
  if (logp) {
    float sum = 0.0f;
    for (int c = 0; c < A; ++c) sum += expf((ok[c] ? l[c] : -1e9f) - mx);
    logp[row] = ((ok[best] ? l[best] : -1e9f) - mx) - logf(sum);
  }
  const int32_t a = best + 1;
  if (actions) actions[row] = a;
  if (masked) {
    bool keep = actor == nullptr || actor[row] != 0;
    if (mode == SA_GREEDY) keep = keep && any_legal;
    masked[row] = keep ? a : 0;
  }
}

}  // namespace ob
