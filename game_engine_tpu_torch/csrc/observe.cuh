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
// its bytes; what kept it from that bound was latency: dependent reads of
// the state, the table and the predicate's atoms in global memory, and a
// division and a branchy visibility test for every element. So a block
// takes R whole rooms (ob_plan: the fewest that let one wave of blocks,
// filling the card's warp slots, hold the launch; at most 16) and copies in
// what it reads, the game's table, the blob's predicate sections and its
// rooms' fields, as runs of elements with every load in flight together
// (room_step.cuh copy_start: cp.async). Stage 1 then reads shared memory
// only: the actor mask (pred_eval over a view of the
// staged banks), each target's F0 unmasked feature values (bf16 bits), each
// (viewer, target)'s visibility as a few bits, one a class of column
// (public, self, team, who acted, revealed), each room's alive count and
// seats present. Stage 2 writes the legal mask and the rooms' stretch of
// the observation in pairs of elements, consecutive threads on consecutive
// pairs (a warp stores 128 contiguous bytes and reads consecutive codes of
// a per-game table of what each feature of a row is, without bank
// conflicts), each element a lookup, a mask of its visibility bit and a
// select, the position advanced with 32-bit carries. The game's own facts
// (the field list with each field's visibility, the team and reveal slots,
// the per-phase action tables, each row feature's code) come from a small
// int32 table built on the host (policies/obs_kernel.py ob_table); the
// phase's target predicate is room_step.cuh's pred_eval, as the engine
// step's acceptance evaluates it.
//
// SA draws a row (room, seat): the legal-masked logits plus the Gumbel
// noise -log(-log(max(u, FLT_MIN))) of the caller's uniforms (or the
// caller's noise as it is, or none), the first index of the maximum, and
// the log-softmax of the masked logits at it. Latency, not its bytes,
// sets its time: a row's loads go out together and its choices' steps
// interleave (see "SA" below). logf and expf are the library's, not the
// fast intrinsics: the build passes no --use_fast_math, which keeps the
// Gumbel transform bit for bit torch's.
#pragma once

#include <float.h>
#include <math.h>
#include <string.h>

#include <type_traits>

#include "room_step.cuh"

namespace ob {

using ge::BatchState;
using ge::Game;

// table header ints (ob_table in policies/obs_kernel.py writes them)
enum {
  T_P, T_NP, T_F0, T_F, T_A, T_TEAM_SLOT, T_MINORITY, T_HAS_MINORITY, T_REVEAL_SLOT,
  T_ALIVE_BOOL, T_NB, T_NN, T_NS, T_RW_MODE, T_RW_TEAM_SLOT, T_N_CODES, T_COLS, T_PHASES,
  T_CODES, T_LEN, T_FTAB, HDR = 21
};
// a column of a target's features: {source, slot, one-hot code, visibility, reveal}
constexpr int COL = 5;
enum { SRC_BOOL, SRC_NUM, SRC_STR, SRC_ACTED, SRC_ALIVE };
enum { VIS_PUBLIC, VIS_SELF, VIS_TEAM, VIS_ACTED };
// A feature f of a viewer's row, one uint32 of the table (ob_table writes
// them): below P * F0, target t's column j, FT_INDEX bits t * F0 + j (its
// raw value in the room), then 8 bits t, then 3 bits the column's
// visibility bit (VB_*), bit 31 clear; else bit 31 set, FT_KIND the one-hot
// of the viewer or the phase, or the alive count, and FT_INDEX its index.
constexpr uint32_t FT_INDEX = 0xFFFFF, FT_OTHER = 0x80000000u;
enum { FT_VIEWER, FT_PHASE, FT_ALIVE };
// a phase: {who-acted is public, choice kind, choice max, is an action, target predicate}
constexpr int PH = 5;
// sampling modes: the noise is uniforms (Gumbel made here), Gumbel noise as
// it is, or absent (greedy)
enum { SA_UNIFORM, SA_GUMBEL, SA_GREEDY };

constexpr uint16_t BF16_ONE = 0x3F80;
// sections of OB's -DGE_PROFILE block clock sums (ob_observe_sections)
enum { OBS_ISSUE, OBS_COPY, OBS_ROOMS, OBS_WRITE, N_OBS };

struct Table {
  int P, NP, F0, F, A, team_slot, minority, has_minority, reveal_slot, alive_bool, NB, NN, NS,
      rw_mode, rw_team_slot, n_codes;
  const int32_t *cols, *phases, *codes;
  const uint32_t* ftab;  // F: what feature f of a viewer's row is (FT_*)
};

GE_HD Table table_view(const int32_t* t) {
  Table x;
  x.P = t[T_P]; x.NP = t[T_NP]; x.F0 = t[T_F0]; x.F = t[T_F]; x.A = t[T_A];
  x.team_slot = t[T_TEAM_SLOT]; x.minority = t[T_MINORITY]; x.has_minority = t[T_HAS_MINORITY];
  x.reveal_slot = t[T_REVEAL_SLOT]; x.alive_bool = t[T_ALIVE_BOOL];
  x.NB = t[T_NB]; x.NN = t[T_NN]; x.NS = t[T_NS];
  x.rw_mode = t[T_RW_MODE]; x.rw_team_slot = t[T_RW_TEAM_SLOT]; x.n_codes = t[T_N_CODES];
  x.cols = t + t[T_COLS]; x.phases = t + t[T_PHASES]; x.codes = t + t[T_CODES];
  x.ftab = (const uint32_t*)(t + t[T_FTAB]);
  return x;
}

// Whether a table is whole and agrees with the game blob's header.
inline bool table_ok(const int32_t* t, int len, const Game& g) {
  if (len < HDR || t[T_LEN] != len) return false;
  const Table x = table_view(t);
  return x.P == g.P && x.NP == g.NP && x.NB == g.NB && x.NN == g.NN && x.NS == g.NS &&
         x.P >= 1 && x.P <= ge::MAX_SEATS && x.F0 >= 2 && x.A >= 1 &&
         x.F == x.P * x.F0 + x.P + x.NP + 1 && t[T_COLS] + x.F0 * COL <= len &&
         t[T_PHASES] + x.NP * PH <= len && t[T_CODES] + x.n_codes <= len &&
         t[T_FTAB] + x.F <= len && x.P * x.F0 <= FT_INDEX;
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

// -- OB: a block of rooms staged in shared memory --------------------------------

// A block of OB takes R rooms (ob_plan sizes R so that a launch fills the
// card) on OB_THREADS threads. Its shared memory, each region 16-byte
// aligned: the game's table and the blob's predicate sections, the fields
// OB reads of its rooms as their tensors hold them, then
// what the stages derive: each target's F0 unmasked values (bf16 bits), each
// (viewer, target)'s visibility bits, each column's visibility class, each
// room's alive-count feature and seats present.
constexpr int OB_RUNS = 12;        // the copy's: the table, 4 predicate sections, 7 fields
constexpr int MAX_ROOMS = 16;      // rooms a block at most: a launch of many waves
enum { VB_PUBLIC, VB_SELF, VB_SELF_RV, VB_TEAM, VB_TEAM_RV, VB_ACTED };  // visibility bits

enum { OB_TABLE, OB_PRED, OB_BOOLS, OB_NUMS, OB_STRS, OB_PRESENT, OB_ACTED, OB_PHASE,
       OB_DONE, OB_RAW, OB_VIS, OB_ALIVE, OB_N_PRESENT, OB_REGIONS };

// What a block of an OB launch takes from the host (ob_launch): its rooms,
// the game's widths, where the blob's predicate sections lie (atoms,
// pred_off, term_off, lits) and the byte offsets of its shared memory's
// regions, so that a block reckons its copy from its launch's arguments,
// not from the blob and the table in global memory.
struct ObLaunch {
  int table_len, R, P, NB, NN, NS;
  int sec_at[4], sec_len[4];
  int at[OB_REGIONS];
  int bytes;
};

struct ObShared {
  int32_t* table;
  int32_t* pred;      // atoms, pred_off, term_off, lits, one after another
  uint8_t* bools;     // R * P * NB
  int32_t* nums;      // R * P * NN
  int8_t* strs;       // R * P * NS
  uint8_t* present;   // R * P
  uint8_t* acted;     // R * P
  int32_t* phase;     // R
  uint8_t* done;      // R
  uint16_t* raw;      // R * P * F0: target t's column j, unmasked
  uint8_t* vis;       // R * P * P: VB_* bits of (viewer, target)
  uint16_t* alive;    // R: the alive count's feature, bf16 bits
  int32_t* n_present; // R
};

GE_HD int64_t align16(int64_t n) { return (n + 15) & ~(int64_t)15; }

// A launch's sizes for R rooms a block, from the game array and the table
// (host arrays, table_ok).
GE_HD ObLaunch ob_launch(const int32_t* game, const int32_t* table, int table_len, int R) {
  const Table x = table_view(table);
  ObLaunch l{};
  l.table_len = table_len;
  l.R = R;
  l.P = x.P; l.NB = x.NB; l.NN = x.NN; l.NS = x.NS;
  int pred = 0;
  for (int k = 0; k < 4; ++k) {
    l.sec_at[k] = game[ge::SEC_ATOMS + k];
    l.sec_len[k] = game[ge::DIR_LEN + ge::SEC_ATOMS + k];
    pred += l.sec_len[k];
  }
  const int64_t P = x.P, seats = (int64_t)R * P;
  const int64_t bytes[OB_REGIONS] = {
      4 * (int64_t)table_len, 4 * (int64_t)pred,
      seats * x.NB, 4 * seats * x.NN, seats * x.NS, seats, seats, 4 * (int64_t)R, R,
      2 * seats * x.F0, seats * P, 2 * (int64_t)R, 4 * (int64_t)R};
  int64_t o = 0;
  for (int k = 0; k < OB_REGIONS; ++k) {
    l.at[k] = (int)o;
    o = align16(o + bytes[k]);
  }
  l.bytes = (int)o;
  return l;
}

GE_HD ObShared ob_shared(const ObLaunch& l, void* base) {
  uint8_t* b = (uint8_t*)base;
  ObShared sh;
  sh.table = (int32_t*)(b + l.at[OB_TABLE]);
  sh.pred = (int32_t*)(b + l.at[OB_PRED]);
  sh.bools = b + l.at[OB_BOOLS];
  sh.nums = (int32_t*)(b + l.at[OB_NUMS]);
  sh.strs = (int8_t*)(b + l.at[OB_STRS]);
  sh.present = b + l.at[OB_PRESENT];
  sh.acted = b + l.at[OB_ACTED];
  sh.phase = (int32_t*)(b + l.at[OB_PHASE]);
  sh.done = b + l.at[OB_DONE];
  sh.raw = (uint16_t*)(b + l.at[OB_RAW]);
  sh.vis = b + l.at[OB_VIS];
  sh.alive = (uint16_t*)(b + l.at[OB_ALIVE]);
  sh.n_present = (int32_t*)(b + l.at[OB_N_PRESENT]);
  return sh;
}

// Run k of a block's copy of rooms [room0, room0 + R) (R existing): the
// table, the predicate sections (atoms, pred_off, term_off, lits), then the
// fields OB reads.
GE_HD ge::Run ob_run(const ObLaunch& l, const int32_t* game, const int32_t* table,
                     const BatchState& s, const ObShared& sh, int R, int64_t room0, int k) {
  const int64_t seat0 = room0 * l.P, seats = (int64_t)R * l.P;
  switch (k) {
    case 0: return ge::byte_run(table, sh.table, 4 * (int64_t)l.table_len);
    case 1: case 2: case 3: case 4: {
      int before = 0;
      for (int q = 0; q < k - 1; ++q) before += l.sec_len[q];
      return ge::byte_run(game + l.sec_at[k - 1], sh.pred + before, 4 * (int64_t)l.sec_len[k - 1]);
    }
    case 5: return ge::byte_run(s.bools + seat0 * l.NB, sh.bools, seats * l.NB);
    case 6: return ge::byte_run(s.nums + seat0 * l.NN, sh.nums, 4 * seats * l.NN);
    case 7: return ge::byte_run(s.strs + seat0 * l.NS, sh.strs, seats * l.NS);
    case 8: return ge::byte_run(s.present + seat0, sh.present, seats);
    case 9: return ge::byte_run(s.acted + seat0, sh.acted, seats);
    case 10: return ge::byte_run(s.phase + room0, sh.phase, 4 * (int64_t)R);
    default: return ge::byte_run(s.done + room0, sh.done, R);
  }
}

// The blob's predicate sections as copied to sh.pred: a Game whose section
// offsets point there (pred_eval reads atoms, pred_off, term_off and lits,
// atom_eval the banks' slots).
GE_HD ge::Game pred_game(const ObLaunch& l, const int32_t* pred) {
  ge::Game gp{};
  gp.gm = pred;
  gp.P = l.P; gp.NB = l.NB; gp.NN = l.NN; gp.NS = l.NS;
  gp.atoms = 0;
  gp.pred_off = l.sec_len[0];
  gp.term_off = gp.pred_off + l.sec_len[1];
  gp.lits = gp.term_off + l.sec_len[2];
  gp.L.bools = 0;
  gp.L.nums = l.NB;
  gp.L.strs = l.NB + l.NN;
  return gp;
}

// A room's staged banks as room_step.cuh's words (a flag 0/1, an int8
// sign-extended): what pred_eval's atoms read.
struct StagedBanks {
  const ge::Game* g;
  const ObShared* sh;
  int seat0;  // the room's first seat in the block
  GE_HD int32_t at(int slot, int p) const {
    const ge::Layout& L = g->L;
    const int row = seat0 + p;
    if (slot < L.nums) return sh->bools[row * g->NB + (slot - L.bools)] != 0;
    if (slot < L.strs) return sh->nums[row * g->NN + (slot - L.nums)];
    return sh->strs[row * g->NS + (slot - L.strs)];
  }
};

// the phase's row of the table, or null for a phase out of range
GE_HD const int32_t* phase_row(const Table& x, int32_t phase) {
  return phase >= 0 && phase < x.NP ? x.phases + phase * PH : nullptr;
}

GE_HD bool seat_alive(const Table& x, const ObShared& sh, int seat) {
  return sh.present[seat] && (x.alive_bool < 0 || sh.bools[seat * x.NB + x.alive_bool]);
}

// Stage 1 (worker tid of n, after the copy): the actor mask (B, P) of the
// block's rooms, written out; each target's F0 unmasked values; with
// `masked` each (viewer, target)'s visibility bits; each column's bit; each
// room's alive-count feature and seats present. Reads only shared memory.
GE_HD void stage_rooms(const Table& x, const ge::Game& gp, const ObShared& sh, uint8_t* actor,
                       int R, int64_t room0, bool masked, bool obs, int tid, int n) {
  const int P = x.P, F0 = x.F0;
  if (actor) {
    for (int k = tid; k < R * P; k += n) {
      const int rr = k / P, p = k - rr * P;
      const int32_t* ph = phase_row(x, sh.phase[rr]);
      bool a = ph && ph[3] && sh.present[k] && !sh.acted[k] && !sh.done[rr];
      if (a) {
        const StagedBanks view{&gp, &sh, rr * P};
        a = ge::pred_eval(gp, view, ph[4], p);
      }
      actor[room0 * P + k] = a;
    }
  }
  if (!obs) return;
  for (int k = tid; k < R * P * F0; k += n) {
    const int seat = k / F0, j = k - seat * F0;
    const int32_t* c = x.cols + j * COL;
    uint16_t v;
    switch (c[0]) {
      case SRC_BOOL: v = sh.bools[seat * x.NB + c[1]] ? BF16_ONE : 0; break;
      case SRC_NUM: v = per_seat(sh.nums[seat * x.NN + c[1]], P); break;
      case SRC_STR: v = (int32_t)sh.strs[seat * x.NS + c[1]] == c[2] ? BF16_ONE : 0; break;
      case SRC_ACTED: v = sh.acted[seat] ? BF16_ONE : 0; break;
      default: v = seat_alive(x, sh, seat) ? BF16_ONE : 0; break;
    }
    sh.raw[k] = v;
  }
  if (masked) {
    for (int k = tid; k < R * P * P; k += n) {
      const int vt = k / P, t = k - vt * P, rr = vt / P, v = vt - rr * P;
      const int tgt = rr * P + t;
      const int32_t* ph = phase_row(x, sh.phase[rr]);
      const bool self = v == t, pub = ph && ph[0];
      const bool rev = x.reveal_slot >= 0 && sh.bools[tgt * x.NB + x.reveal_slot];
      bool team = false;
      if (x.team_slot >= 0) {
        const int32_t tv = sh.strs[vt * x.NS + x.team_slot];
        team = tv != 0 && tv == sh.strs[tgt * x.NS + x.team_slot] &&
               (!x.has_minority || tv == x.minority);
      }
      sh.vis[k] = (uint8_t)(1u << VB_PUBLIC | (uint32_t)self << VB_SELF |
                            (uint32_t)(self || rev) << VB_SELF_RV |
                            (uint32_t)(self || team) << VB_TEAM |
                            (uint32_t)(self || team || rev) << VB_TEAM_RV |
                            (uint32_t)(self || pub) << VB_ACTED);
    }
  }
  for (int rr = tid; rr < R; rr += n) {
    int alive = 0;
    for (int p = 0; p < P; ++p) alive += seat_alive(x, sh, rr * P + p);
    sh.alive[rr] = per_seat(alive, P);
  }
}

// Stage 1 for the legal mask: each room's seats present.
GE_HD void stage_counts(const Table& x, const ObShared& sh, int R, int tid, int n) {
  for (int rr = tid; rr < R; rr += n) {
    int present = 0;
    for (int p = 0; p < x.P; ++p) present += sh.present[rr * x.P + p] != 0;
    sh.n_present[rr] = present;
  }
}

// Stage 2: the legal mask (B, P, A) of the block's rooms, written out.
GE_HD void stage_legal(const Table& x, const ObShared& sh, uint8_t* legal, int R, int64_t room0,
                       int tid, int n) {
  const int P = x.P, A = x.A;
  for (int k = tid; k < R * P * A; k += n) {
    const int rr = k / (P * A), c = k % A + 1;  // the 1-based choice
    const int32_t* ph = phase_row(x, sh.phase[rr]);
    const int kind = ph ? ph[1] : ge::K_NONE, kmax = ph ? ph[2] : 0;
    bool ok;
    if (kind == ge::K_TARGET) ok = c <= P && seat_alive(x, sh, rr * P + c - 1);
    else if (kind == ge::K_OPTION) ok = c <= (kmax > 0 ? kmax : sh.n_present[rr]);
    else ok = c == 1;
    legal[room0 * P * A + k] = ok;
  }
}

// Element f of viewer v's row of a room (bf16 bits) by its code of the
// table's ftab: a feature is the staged raw value, masked by the viewer's
// visibility bits of its target and the bit its column asks for; else a
// one-hot of the viewer or the phase, or the room's alive count.
GE_HD uint32_t element_of(uint32_t code, const uint16_t* raw, const uint8_t* vis, int v,
                          int32_t phase, uint32_t alive, bool masked) {
  const uint32_t i = code & FT_INDEX;
  if (!(code & FT_OTHER)) {
    const uint32_t val = raw[i];
    return masked && !((vis[(code >> 20) & 0xFF] >> ((code >> 28) & 7)) & 1u) ? 0u : val;
  }
  switch ((code >> 29) & 3) {
    case FT_VIEWER: return (int)i == v ? BF16_ONE : 0u;
    case FT_PHASE: return (int32_t)i == phase ? BF16_ONE : 0u;
    default: return alive;
  }
}

// A position in a block's stretch of the observation: room r, viewer v,
// feature f.
struct Cursor {
  int r, v, f;
};

GE_HD uint32_t element_at(const Table& x, const ObShared& sh, bool masked, const Cursor& q) {
  return element_of(x.ftab[q.f], sh.raw + q.r * x.P * x.F0, sh.vis + (q.r * x.P + q.v) * x.P,
                    q.v, sh.phase[q.r], sh.alive[q.r], masked);
}

GE_HD void advance(const Table& x, Cursor& q) {
  if (++q.f == x.F) {
    q.f = 0;
    if (++q.v == x.P) {
      q.v = 0;
      ++q.r;
    }
  }
}

// Stage 2: the block's rooms' stretch of the flat observation, in pairs of
// elements (4-byte stores; obs is 16-byte aligned, and a stretch that starts
// at an odd element writes that one alone, as one that ends at an odd
// element writes its last), consecutive workers on consecutive pairs so a
// warp stores 128 contiguous bytes and reads consecutive codes and values
// of the staging. A worker's next pair is 2 * n elements on: its cursor
// moves by that step's (rooms, viewers, features) with carries, all 32-bit;
// an element is a lookup of its code, a lookup of its value, a mask of its
// visibility bit and a select.
GE_HD void stage_obs(const Table& x, const ObShared& sh, uint16_t* obs, int R, int64_t room0,
                     bool masked, int tid, int n) {
  const int per_room = x.P * x.F, total = R * per_room;
  uint16_t* out = obs + room0 * (int64_t)per_room;  // the stretch, from its first element
  const int head = (int)((room0 * (int64_t)per_room) & 1);  // an odd start, alone
  const int pairs = (total - head) / 2;
  if (tid == 0) {
    Cursor q{0, 0, 0};
    if (head) out[0] = (uint16_t)element_at(x, sh, masked, q);
    if ((total - head) & 1) {  // an odd end, alone
      const int e = total - 1;
      q.r = e / per_room;
      q.v = (e - q.r * per_room) / x.F;
      q.f = e - q.r * per_room - q.v * x.F;
      out[e] = (uint16_t)element_at(x, sh, masked, q);
    }
  }
  if (tid >= pairs) return;
  const int e_first = head + 2 * tid;  // this worker's first pair
  Cursor q;
  q.r = e_first / per_room;
  q.v = (e_first - q.r * per_room) / x.F;
  q.f = e_first - q.r * per_room - q.v * x.F;
  const int step = 2 * n, dr = step / per_room, dv = (step - dr * per_room) / x.F,
            df = step - dr * per_room - dv * x.F;
  uint32_t* out2 = (uint32_t*)(out + head);
  for (int p = tid; p < pairs; p += n) {
    uint32_t lo, hi;
    if (q.f + 1 < x.F) {  // both in one viewer's row
      const uint16_t* raw = sh.raw + q.r * x.P * x.F0;
      const uint8_t* vis = sh.vis + (q.r * x.P + q.v) * x.P;
      const int32_t phase = sh.phase[q.r];
      const uint32_t alive = sh.alive[q.r];
      lo = element_of(x.ftab[q.f], raw, vis, q.v, phase, alive, masked);
      hi = element_of(x.ftab[q.f + 1], raw, vis, q.v, phase, alive, masked);
    } else {
      Cursor w = q;
      lo = element_at(x, sh, masked, w);
      advance(x, w);
      hi = element_at(x, sh, masked, w);
    }
    out2[p] = lo | hi << 16;
    q.f += df;  // the next pair: 2 * n elements on
    q.v += dv;
    q.r += dr;
    if (q.f >= x.F) {
      q.f -= x.F;
      ++q.v;
    }
    if (q.v >= x.P) {
      q.v -= x.P;
      ++q.r;
    }
  }
}

// The block body of OB (observe.cu ob_observe_kernel; observe_host.cpp runs
// it on the host a block at a time): rooms [room0, room0 + R) that exist,
// worker tid of n, in `smem` as ob_shared lays it out. The copy brings in
// the table, the predicate sections and the rooms' fields with cp.async,
// their loads in flight together, each warp its runs reckoned from the
// launch's arguments (no set-up to wait for); stage 1 derives from them
// alone; stage 2 writes the legal mask and the observation.
GE_HD void ob_block(const ObLaunch& l, const int32_t* game, const int32_t* table,
                    const BatchState& s, uint16_t* obs, uint8_t* legal, uint8_t* actor,
                    int64_t B, int64_t room0, bool masked, void* smem, int tid, int n,
                    long long* prof) {
  GE_MARK_START(prof);
  const int Rb = (int)(B - room0 < l.R ? B - room0 : l.R);
  const ObShared sh = ob_shared(l, smem);
  const ge::Crew crew = ge::crew_of(tid, n);
  GE_UNROLL
  for (int k = 0; k < OB_RUNS; ++k)  // each warp its runs, reckoned from the launch's arguments
    if (k % crew.warps == crew.warp)
      ge::copy_start(ob_run(l, game, table, s, sh, Rb, room0, k), crew.lane, crew.width);
  GE_MARK(prof, OBS_ISSUE);
  ge::copy_wait();
  GE_BLOCK_SYNC();
  GE_MARK(prof, OBS_COPY);
  const Table x = table_view(sh.table);
  const ge::Game gp = pred_game(l, sh.pred);
  stage_rooms(x, gp, sh, actor, Rb, room0, masked, obs != nullptr, tid, n);
  if (legal) stage_counts(x, sh, Rb, tid, n);
  GE_BLOCK_SYNC();
  GE_MARK(prof, OBS_ROOMS);
  if (legal) stage_legal(x, sh, legal, Rb, room0, tid, n);
  if (obs) stage_obs(x, sh, obs, Rb, room0, masked, tid, n);
  GE_MARK_SYNC();
  GE_MARK(prof, OBS_WRITE);
}

// Terminal rewards of seat (room i, seat p) by room_step.cuh's rule
// (terminal_reward, which ST's step_reset pays too): paid where the step
// ended the room's episode and the seat is present.
GE_HD float reward_of(const Table& x, const BatchState& s, const uint8_t* ended, int64_t i,
                      int p, int n_present) {
  const int64_t row = i * x.P + p;
  if (!ended[i] || !s.present[row]) return 0.0f;
  const ge::RewardRule rw{x.rw_mode, x.rw_team_slot, x.n_codes, x.codes};
  const int32_t team = x.rw_mode == ge::RW_TEAM ? s.strs[row * x.NS + x.rw_team_slot] : 0;
  return ge::terminal_reward(rw, team, s.winner[i], p, n_present);
}

GE_HD int count_present(const Table& x, const BatchState& s, int64_t i) {
  int n = 0;
  for (int p = 0; p < x.P; ++p) n += s.present[i * x.P + p] != 0;
  return n;
}

// -- SA ------------------------------------------------------------------------
//
// A row (room, seat) of A choices is a group of G lanes of a warp, lane l
// holding the SA_SPAN contiguous choices from SA_SPAN * l, G the smallest
// power of two that covers the row, at most 32: one lane at werewolf's 8
// choices, 16 at 72 seats; past 256 choices a warp takes a row in passes
// of 256 (sa_widths). A lane issues all its loads before it uses one: two
// 16-byte loads of each f32 input and two 4-byte loads of legal where the
// row's inputs are aligned to them (sa_vec), else one a choice; each
// choice is read once and its masked logit stays in a register. The lane
// takes its own choices in order; a group then combines its lanes by
// butterflies, offsets G/2 ... 1, each lane taking op(its own, the other
// lane's): the max of the masked logits, the sum of expf(m - max), the
// max of the draw's values; the draw is the first lane holding that max
// (its choices precede the others'), and that lane's own first. Every op
// is commutative, so every lane ends with the same result and lane 0
// writes it. observe.cu's kernel exchanges by __shfl_xor_sync and
// __ballot_sync; observe_host.cpp runs a group's lanes in a loop, the same
// steps in the same order.

constexpr int SA_SPAN = 8;           // contiguous choices a lane holds a pass
constexpr int SA_NONE = 0x7fffffff;  // the index of a draw that holds no choice yet

// -log(-log(max(u, FLT_MIN))): torch.rand's uniform as sample_actions turns it
GE_HD float gumbel_of(float u) { return -logf(-logf(u > FLT_MIN ? u : FLT_MIN)); }

// A draw so far: the masked logit plus the noise, the masked logit, its
// index and whether any choice met was legal.
struct SaBest {
  float x, m;
  int i, any;
};

GE_HD SaBest sa_none() { return SaBest{-INFINITY, -INFINITY, SA_NONE, 0}; }

// The draw keeps the larger value and, on a tie, the lower index: the
// first maximum, as torch.argmax keeps it.
GE_HD SaBest sa_pick(const SaBest& a, const SaBest& b) {
  SaBest r = b.x > a.x || (b.x == a.x && b.i < a.i) ? b : a;
  r.any = a.any | b.any;
  return r;
}

struct SaMax {
  GE_HD float operator()(float a, float b) const { return b > a ? b : a; }
};
struct SaAdd {
  GE_HD float operator()(float a, float b) const { return a + b; }
};

// Calls f(G, MODE) for A choices a row in `mode`, each an
// std::integral_constant: lanes a row and the mode, so that a build holds
// neither as a branch.
template <class F>
void sa_widths(int A, int mode, F&& f) {
  using std::integral_constant;
  auto at = [&](auto g) {
    if (mode == SA_UNIFORM) return f(g, integral_constant<int, SA_UNIFORM>());
    if (mode == SA_GUMBEL) return f(g, integral_constant<int, SA_GUMBEL>());
    return f(g, integral_constant<int, SA_GREEDY>());
  };
  if (A > 16 * SA_SPAN) return at(integral_constant<int, 32>());
  if (A > 8 * SA_SPAN) return at(integral_constant<int, 16>());
  if (A > 4 * SA_SPAN) return at(integral_constant<int, 8>());
  if (A > 2 * SA_SPAN) return at(integral_constant<int, 4>());
  if (A > SA_SPAN) return at(integral_constant<int, 2>());
  return at(integral_constant<int, 1>());
}

// Whether a lane's choices come in aligned loads of 4: A a multiple of 4,
// the f32 inputs 16-byte and legal 4-byte aligned.
inline bool sa_vec(int A, const float* logits, const uint8_t* legal, const float* noise) {
  return A % 4 == 0 && (uintptr_t)logits % 16 == 0 && (uintptr_t)legal % 4 == 0 &&
         (uintptr_t)noise % 16 == 0;
}

// 4 contiguous inputs from p: one 16-byte (f32) or 4-byte (legal) load on
// the card
GE_HD void sa_read4(const float* __restrict__ p, float* v) {
#ifdef __CUDA_ARCH__
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
#else
  memcpy(v, p, 4 * sizeof *v);
#endif
}

GE_HD void sa_read4(const uint8_t* __restrict__ p, uint8_t* v) {
#ifdef __CUDA_ARCH__
  const uint32_t q = *reinterpret_cast<const uint32_t*>(p);
  v[0] = q & 0xff; v[1] = (q >> 8) & 0xff; v[2] = (q >> 16) & 0xff; v[3] = q >> 24;
#else
  memcpy(v, p, 4);
#endif
}

// Lane `lane`'s pass from choice c0 in MODE: reads its choices
// c0 + SA_SPAN * lane + j below A once, every load issued before any is
// used (aligned loads of 4 where `vec`), keeps their masked logits in m
// (-inf past A) and their max in mx, and returns its draw over them.
template <int MODE>
GE_HD SaBest sa_load(const float* __restrict__ l, const uint8_t* __restrict__ ok,
                     const float* __restrict__ z, int A, int c0, int lane, bool vec,
                     float (&m)[SA_SPAN], float& mx) {
  const int c = c0 + SA_SPAN * lane;
  float lv[SA_SPAN] = {}, zv[SA_SPAN] = {};
  uint8_t okv[SA_SPAN] = {};
  GE_UNROLL
  for (int q = 0; q < SA_SPAN; q += 4) {
    if (vec && c + q < A) {
      sa_read4(l + c + q, lv + q);
      sa_read4(ok + c + q, okv + q);
      if (MODE != SA_GREEDY) sa_read4(z + c + q, zv + q);
    } else {
      GE_UNROLL
      for (int j = q; j < q + 4; ++j)
        if (c + j < A) {
          lv[j] = l[c + j];
          okv[j] = ok[c + j];
          if (MODE != SA_GREEDY) zv[j] = z[c + j];
        }
    }
  }
  // every choice's step is straight-line code, a choice past A masked by
  // selects (its inputs zero), so that the choices' logf chains interleave
  SaBest best = sa_none();
  mx = -INFINITY;
  GE_UNROLL
  for (int j = 0; j < SA_SPAN; ++j) {
    const bool in = c + j < A;
    const int legal = in && okv[j] != 0;
    const float mj = legal ? lv[j] : -1e9f;
    float xv = mj;
    if (MODE == SA_UNIFORM) xv = mj + gumbel_of(zv[j]);
    else if (MODE == SA_GUMBEL) xv = mj + zv[j];
    const SaBest picked = sa_pick(best, SaBest{xv, mj, c + j, legal});
    best = in ? picked : best;
    mx = in ? SaMax()(mx, mj) : mx;
    m[j] = in ? mj : -INFINITY;
  }
  return best;
}

// A lane's part of a pass's sum: expf(m - mx) over its choices in order
// (those past A add expf(-inf), 0).
GE_HD float sa_exp_sum(const float (&m)[SA_SPAN], float mx) {
  float s = 0.0f;
  GE_UNROLL
  for (int j = 0; j < SA_SPAN; ++j) s += expf(m[j] - mx);
  return s;
}

// The softmax's running max M and sum S of expf(m - M) after a pass of
// max cm and sum cs: the pass's own after the first (every row of at most
// 32 * SA_SPAN choices), else both rescaled to the larger max.
GE_HD void sa_fold(float& M, float& S, float cm, float cs, bool first) {
  if (first) {
    M = cm;
    S = cs;
    return;
  }
  const float n = SaMax()(M, cm);
  S = S * expf(M - n) + cs * expf(cm - n);
  M = n;
}

// What lane 0 of row `row` writes: the 1-based action, the actor-masked
// action (`acting`: the row's actor byte, read before the draw so that its
// load is not the last in the chain; greedy: also 0 where no choice is
// legal) and the log-softmax of the masked logits at it; each output may
// be null.
template <int MODE>
GE_HD void sa_write(const SaBest& best, float M, float S, bool acting, int32_t* actions,
                    int32_t* masked, float* logp, int64_t row) {
  const int32_t a = best.i + 1;
  if (actions) actions[row] = a;
  if (masked) masked[row] = acting && (MODE != SA_GREEDY || best.any) ? a : 0;
  if (logp) logp[row] = (best.m - M) - logf(S);
}

}  // namespace ob
