// room_step.cuh — one room of the batched engine, run by a group of lanes with
// one seat each: scripted bots, the engine step (P1..P5), the on-enter
// effect-IR interpreter (P20) and auto-reset. It is the body of the CUDA
// rollout kernel (csrc/rollout.cu), which replaces the TPU kernel
// game_engine_tpu/core/pallas_rollout.py::make_pallas_rollout, and of the g++
// host harness (csrc/rollout_host.cpp) that the CPU tests run, and of the
// engine step entry ST (rollout.cu's ge_step, ge_reset_done, ge_bots and
// ge_step_reset on GameState's own tensors: st_block, room_entry). Its search
// rollout (room_search_rollout) and the full-information decisions around it
// (seat_candidates, decide_room, decide_rollout, decide_argmax) are the body
// of the search kernel (csrc/search.cu, host harness csrc/search_host.cpp).
//
// The game is interpreted from the packed table blob of
// game_engine_tpu_torch/native/pack.py behind a directory of section offsets
// (core/rollout_kernel.game_array builds it), so one build serves every game.
// The semantics are the batched engine's (game_engine_tpu_torch/core/step.py
// and core/engine.make_rollout), and the result is bit-identical to it.
// Integer rules (SEMANTICS.md P20): effect-IR arithmetic wraps as int32
// (computed in uint32, cast back); hashing is uint32 splitmix32; int8 banks
// keep the low byte of what is written, sign-extended.
//
// What bounds the interpreter on an H100 is the serial latency of one room's
// step (table reads, data-dependent branches, per-seat loops), not memory
// traffic or arithmetic. So the step is laid out across seats, not rooms:
//
// - A room is run by G lanes of one warp, G a power of two: the fewest
//   lanes >= P up to 32 (the launch may widen it), and 32 for a room of more
//   seats. Seat p lives on lane p mod G: every "for each seat" loop of the
//   engine is the lane's own work (GE_EACH_SEAT), one trip for P <= G, and
//   lanes past P idle. The room's scalars (phase, prev, done, winner, t,
//   seed, the present set) are registers, the same in every lane.
// - A set of seats (present, alive, waiting) is Seats<NW>: NW 32-bit words,
//   seat p bit p mod 32 of word p / 32. The kernels are built twice: NW = 1
//   for rooms of up to 32 seats (one word, as a room a warp always was) and
//   NW = MAX_SEAT_WORDS for wider rooms, so a narrow room pays nothing for
//   the wide ones.
// - Everything per seat is a word w[slot * stride + seat] of shared memory:
//   the state banks, the action, a scratch word and the effect-IR node
//   values. A room has G * SW columns (SW = ceil(P / 32), at least P), so
//   consecutive seats hold consecutive words, a slot index known only at
//   run time costs no bank conflict and no local memory, and the number of
//   slots is the game's own (layout_of), not a compiled maximum. So is the
//   branch condition's stack: slots of its own, each lane using its own
//   column, as deep as the game's largest condition tree.
// - What one seat needs of the others goes through a ballot over the group
//   (seats_where: counts, the alive set, completion), one a 32 seats, or
//   through the others' words after a group barrier (GE_SYNC: the effect
//   IR's cross-seat nodes, the deal's keys, a target's string). Groups of
//   one warp in different phases only ever wait for their own lanes.
//
// On the host the same source runs a room as a loop over its seats:
// GE_EACH_SEAT iterates, seats_where loops, GE_SYNC is nothing, and the
// words are indexed the same way. GE_HD marks functions compiled for both.
//
// -DGE_PROFILE (device) sums clock64() by section of the step into
// Room::prof; -DGE_COUNT (host) counts the interpreter's operations in
// ge::counts. Neither is in the libraries the engine loads.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define GE_HD __host__ __device__ inline
#define GE_HDM __host__ __device__
#else
#define GE_HD inline
#define GE_HDM
#endif

#ifdef __CUDA_ARCH__
// the body runs for this lane's seats: seat lane, then (wide rooms, on 32
// lanes) lane + 32, ...; not at all on a padding lane
#define GE_EACH_SEAT(g, r, p)                             \
  for (int p = (r).lane, ge_more = 1; ge_more && p < (g).P; \
       p += MAX_GROUP, ge_more = (r).NW > 1)
// group barrier: the seats' earlier writes are visible to each other
#define GE_SYNC(r) __syncwarp((r).mask)
#else
#define GE_EACH_SEAT(g, r, p) for (int p = 0; p < (g).P; ++p)
#define GE_SYNC(r) ((void)0)
#endif

// a loop over a seat set's words, unrolled so that the words stay in registers
#ifdef __CUDA_ARCH__
#define GE_UNROLL _Pragma("unroll")
#else
#define GE_UNROLL
#endif

#if defined(GE_PROFILE) && defined(__CUDA_ARCH__)
#define GE_TIC(r) const long long ge_t0 = clock64()
#define GE_TOC(r, sec) (r).prof[sec] += clock64() - ge_t0
// a block's sections (the step and observation entries): after a barrier,
// thread 0 adds the cycles since the last mark to prof[sec]
#define GE_MARK_START(prof) long long ge_mark = clock64()
#define GE_MARK(prof, sec)                                                   \
  do {                                                                       \
    if ((prof) && threadIdx.x == 0) {                                        \
      const long long ge_now = clock64();                                    \
      atomicAdd((unsigned long long*)(prof) + (sec),                         \
                (unsigned long long)(ge_now - ge_mark));                     \
      ge_mark = ge_now;                                                      \
    }                                                                        \
  } while (0)
#define GE_MARK_SYNC() __syncthreads()
#else
#define GE_TIC(r) ((void)0)
#define GE_TOC(r, sec) ((void)0)
#define GE_MARK_START(prof) ((void)(prof))
#define GE_MARK(prof, sec) ((void)0)
#define GE_MARK_SYNC() ((void)0)
#endif

namespace ge {

constexpr int MAX_GROUP = 32;   // a room's lanes are lanes of one warp
constexpr int MAX_SEAT_WORDS = 8;  // words of a seat set in a wide room's registers
constexpr int MAX_SEATS = 32 * MAX_SEAT_WORDS;  // seats a room can have (host-checked)
constexpr int MIN_THREADS = 32;       // the smallest block: one warp
constexpr int64_t MAX_SHARED = 232448;  // bytes of dynamic shared memory an H100 block can ask for

// sections of the -DGE_PROFILE clock sums; effect programs follow, one
// section a mechanic (the last collects the rest)
enum { PROF_POLICY, PROF_ACCEPT, PROF_BRANCH, PROF_RESET, PROF_EFFECTS };
constexpr int N_PROF = 32;
// operations the -DGE_COUNT host build counts
enum { CNT_ATOMS, CNT_NODES, CNT_WRITES, CNT_HASHES, N_COUNTS };
#ifdef GE_COUNT
inline int64_t counts[N_COUNTS];
#define GE_ADD(which, n) (ge::counts[which] += (n))
#else
#define GE_ADD(which, n) ((void)0)
#endif

// directory prepended to the blob: dir[sid] = offset of section sid's data
// in the game array, dir[DIR_LEN + sid] = its length; dir[0] = the effect-IR
// nodes of the game's largest block, dir[DIR_LEN] = the nodes of its largest
// branch-condition tree
constexpr int DIR_LEN = 16;
constexpr int DIR_INTS = 2 * DIR_LEN;

// pack.py section ids
enum { SEC_HEADER = 1, SEC_ATOMS, SEC_PRED_OFF, SEC_TERM_OFF, SEC_LITS,
       SEC_PHASE, SEC_RECTRUE, SEC_RECFALSE, SEC_PDTRANS, SEC_CONDS,
       SEC_BRANCH_OFF, SEC_BRANCHES, SEC_MECHS, SEC_POOL, SEC_DEFAULTS };
enum { COND_ALWAYS, COND_COUNTCMP, COND_ALLPRESENT, COND_PREVIN, COND_AND };
constexpr int MECH_EFFECTS = 9;
constexpr int MECH_ROW = 18;   // type, phase, 16 params
constexpr int PHASE_ROW = 11;  // is_action, target_pred, terminal, static_next,
                               // kind, kmax, rec_num, rec_pdict, rec_pdict_src,
                               // rec_odict, dsl_id
// effect-IR codes (gamespec/effects.py); NK_AT and later read other seats
enum { NK_CONST, NK_FIELD, NK_SEAT, NK_NPLAYERS, NK_CHOICE, NK_CHOSEIN,
       NK_ALIVE, NK_PRESENT, NK_PRED, NK_BIN, NK_CMP, NK_NOT, NK_AND, NK_OR,
       NK_WHERE, NK_AT, NK_INCOMING, NK_EQCOUNT, NK_RANK, NK_REDUCE,
       NK_ARGBEST };
enum { BIN_ADD, BIN_SUB, BIN_MUL, BIN_MIN, BIN_MAX };
enum { RED_SUM, RED_MAX, RED_MIN, RED_COUNT };
enum { ARG_MAX, ARG_MIN };
enum { ST_SET, ST_ADD, ST_KILL, ST_RESET, ST_SETD, ST_OVER, ST_DEAL };
enum { FXB_BOOL, FXB_NUM, FXB_STR, FXB_ODICT, FXB_PDICT };
enum { AB_BOOL, AB_NUM, AB_STR, AB_CONST };
enum { OP_EQ, OP_NE, OP_GE, OP_LE, OP_GT, OP_LT };
enum { K_NONE, K_TARGET, K_OPTION, K_SUBMIT };

#ifdef GE_COUNT
// Integer operations effect-IR node `kind` needs at seat p of P at the least:
// none for a constant, the seat's number or the room's size; one for a node
// of the seat's own values; a read of each seat it looks at for a cross-seat
// node (RANK: the earlier ones). A room-level node (REDUCE, ARGBEST) is one
// pass over the seats for the whole room, booked at seat 0.
inline int node_ops(int kind, int p, int P) {
  switch (kind) {
    case NK_CONST: case NK_SEAT: case NK_NPLAYERS: return 0;
    case NK_INCOMING: case NK_EQCOUNT: return P;
    case NK_RANK: return p;
    case NK_REDUCE: case NK_ARGBEST: return p == 0 ? P : 0;
    default: return 1;
  }
}
#endif

constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr uint32_t MIX = 0x85EBCA6Bu;

GE_HD uint32_t splitmix32(uint32_t x) {
  GE_ADD(CNT_HASHES, 1);
  x += GOLDEN;
  uint32_t z = x;
  z = (z ^ (z >> 16)) * 0x85EBCA6Bu;
  z = (z ^ (z >> 13)) * 0xC2B2AE35u;
  return z ^ (z >> 16);
}

GE_HD int32_t wrap_add(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }
GE_HD int32_t wrap_sub(int32_t a, int32_t b) { return (int32_t)((uint32_t)a - (uint32_t)b); }
GE_HD int32_t wrap_mul(int32_t a, int32_t b) { return (int32_t)((uint32_t)a * (uint32_t)b); }
GE_HD int32_t low_byte(int32_t v) { return (int32_t)(int8_t)v; }  // an int8 bank's store

GE_HD bool compare(int op, int32_t x, int32_t y) {
  switch (op) {
    case OP_EQ: return x == y;
    case OP_NE: return x != y;
    case OP_GE: return x >= y;
    case OP_LE: return x <= y;
    case OP_GT: return x > y;
    default: return x < y;
  }
}

GE_HD int popc(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

GE_HD bool has_bit(uint32_t m, int i) { return (m >> i) & 1u; }

// index of the k-th (from 0) set bit of m; m has more than k bits set
GE_HD int nth_set_bit(uint32_t m, int k) {
  for (; k > 0; --k) m &= m - 1;
#ifdef __CUDA_ARCH__
  return __ffs((int)m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// A set of seats: seat p is bit p % 32 of word p / 32. Every operation runs
// over the NW words in ascending order with constant indices, so the words
// stay in registers; for NW = 1 each is the one word's.
template <int NW>
struct Seats {
  uint32_t w[NW];
};

template <int NW>
GE_HD int popc(const Seats<NW>& s) {
  int n = 0;
  GE_UNROLL
  for (int j = 0; j < NW; ++j) n += popc(s.w[j]);
  return n;
}

template <int NW>
GE_HD bool has_bit(const Seats<NW>& s, int i) {
  if (NW == 1) return has_bit(s.w[0], i);
  uint32_t x = 0;
  GE_UNROLL
  for (int j = 0; j < NW; ++j)
    if (i >> 5 == j) x = s.w[j];
  return has_bit(x, i & 31);
}

template <int NW>
GE_HD bool any(const Seats<NW>& s) {
  uint32_t x = 0;
  GE_UNROLL
  for (int j = 0; j < NW; ++j) x |= s.w[j];
  return x != 0;
}

// the k-th (from 0) seat of s in ascending order; s has more than k seats
template <int NW>
GE_HD int nth_set_bit(const Seats<NW>& s, int k) {
  if (NW == 1) return nth_set_bit(s.w[0], k);
  int at = -1;
  GE_UNROLL
  for (int j = 0; j < NW; ++j) {
    const int c = popc(s.w[j]);
    if (at < 0 && k < c) at = 32 * j + nth_set_bit(s.w[j], k);
    k -= c;
  }
  return at;
}

// the first n seats
template <int NW>
GE_HD Seats<NW> first_seats(int n) {
  Seats<NW> s;
  if (NW == 1) {
    s.w[0] = n >= 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
    return s;
  }
  GE_UNROLL
  for (int j = 0; j < NW; ++j) {
    const int m = n - 32 * j;
    s.w[j] = m >= 32 ? 0xFFFFFFFFu : m <= 0 ? 0u : (1u << m) - 1u;
  }
  return s;
}

// the first SW words of a set kept in memory (the rest empty)
template <int NW>
GE_HD Seats<NW> load_seats(const int32_t* words, int SW) {
  Seats<NW> s;
  GE_UNROLL
  for (int j = 0; j < NW; ++j) s.w[j] = j < SW ? (uint32_t)words[j] : 0u;
  return s;
}

// words of a set of P seats
GE_HD int seat_words(int P) { return (P + 31) / 32; }

// the fewest lanes that run one room: the smallest power of two >= P, at
// most a warp
GE_HD int group_lanes(int P) {
  int G = 1;
  while (G < P && G < MAX_GROUP) G *= 2;
  return G;
}

// bit idx_plus1 of the 64-bit phase mask (lo, hi): phase-set membership of a
// dense phase index, -1 included (the effect IR's chose(): the lowering
// refuses phases past 63)
GE_HD bool mask64_has(int32_t lo, int32_t hi, int idx_plus1) {
  uint64_t bits = (uint64_t)(uint32_t)lo | ((uint64_t)(uint32_t)hi << 32);
  return idx_plus1 >= 0 && idx_plus1 < 64 && ((bits >> idx_plus1) & 1);
}

// bit idx of a phase mask of n 32-bit words
GE_HD bool mask_has(const int32_t* words, int n, int idx) {
  return idx >= 0 && idx < 32 * n && (((uint32_t)words[idx >> 5] >> (idx & 31)) & 1u);
}

// The per-seat word slots of a room, sized to the game. [0, state) mirror
// the global state and are loaded and stored; the rest is working room.
struct Layout {
  int bools, nums, strs, pdict, odict;        // NB, NN, NS, NPD * P, NOD slots
  int present, acted, choice, choice_phase;   // one slot each
  int state;                                  // slots before this are state
  int act;    // the seat's action of this step
  int tmp;    // scratch of one stage
  int vals;   // effect-IR node values of the running block
  int stack;  // a branch condition's pending nodes, in each lane's own column
  int words;  // slots in all
};

// A view of the game array (directory + pack.py blob): sections as offsets
// into gm.
struct Game {
  const int32_t* gm;
  int P, NP, NB, NN, NS, NPD, NOD;  // NPD/NOD: the state's (>= 1) widths
  int SW;                           // words of a seat set: columns a lane holds
  int alive_slot, start_index, maxv, n_mechs, max_nodes, max_cond;
  int atoms, pred_off, term_off, lits, phase, rec_true, rec_false, pdtrans,
      conds, branch_off, branches, mechs, pool, defaults;
  Layout L;
};

GE_HD Layout layout_of(const Game& g) {
  Layout L;
  int o = 0;
  L.bools = o; o += g.NB;
  L.nums = o; o += g.NN;
  L.strs = o; o += g.NS;
  L.pdict = o; o += g.NPD * g.P;
  L.odict = o; o += g.NOD;
  L.present = o++;
  L.acted = o++;
  L.choice = o++;
  L.choice_phase = o++;
  L.state = o;
  L.act = o++;
  L.tmp = o++;
  L.vals = o; o += g.max_nodes;
  L.stack = o; o += g.max_cond > 1 ? g.max_cond - 1 : 0;  // the root is never pushed
  L.words = o;
  return L;
}

GE_HD Game game_view(const int32_t* gm) {
  Game g;
  g.gm = gm;
  const int32_t* h = gm + gm[SEC_HEADER];
  g.P = h[0]; g.NP = h[1]; g.NB = h[2]; g.NN = h[3]; g.NS = h[4];
  g.NPD = h[5] > 1 ? h[5] : 1;
  g.NOD = h[6] > 1 ? h[6] : 1;
  g.SW = seat_words(g.P);
  g.alive_slot = h[7]; g.start_index = h[8]; g.maxv = h[12];
  g.max_nodes = gm[0];
  g.max_cond = gm[DIR_LEN];
  g.atoms = gm[SEC_ATOMS];
  g.pred_off = gm[SEC_PRED_OFF];
  g.term_off = gm[SEC_TERM_OFF];
  g.lits = gm[SEC_LITS];
  g.phase = gm[SEC_PHASE];
  g.rec_true = gm[SEC_RECTRUE];
  g.rec_false = gm[SEC_RECFALSE];
  g.pdtrans = gm[SEC_PDTRANS];
  g.conds = gm[SEC_CONDS];
  g.branch_off = gm[SEC_BRANCH_OFF];
  g.branches = gm[SEC_BRANCHES];
  g.mechs = gm[SEC_MECHS];
  g.n_mechs = gm[DIR_LEN + SEC_MECHS] / MECH_ROW;
  g.pool = gm[SEC_POOL];
  g.defaults = gm[SEC_DEFAULTS];
  g.L = layout_of(g);
  return g;
}

// bytes of dynamic shared memory of a block of `threads` lanes: the game's
// tables and every lane's words (SW columns a lane)
GE_HD int64_t shared_bytes(const Game& g, int game_len, int threads) {
  return ((int64_t)game_len + (int64_t)g.L.words * threads * g.SW) * (int64_t)sizeof(int32_t);
}

GE_HD int64_t st_shared_bytes(const Game& g, int game_len, int threads, int G);

// bytes of a block of `threads` lanes: K1's and S's (shared_bytes), or with
// `staged` ST's (st_shared_bytes: its rooms' staging too, for the most rooms
// a block can have, a room on group_lanes(P) lanes)
GE_HD int64_t block_bytes(const Game& g, int game_len, int threads, bool staged) {
  return staged ? st_shared_bytes(g, game_len, threads, group_lanes(g.P))
                : shared_bytes(g, game_len, threads);
}

// the largest of threads, threads / 2, ... (in whole warps) down to one warp
// whose block fits in shared memory; 0 when not even one warp's does
GE_HD int fit_threads(const Game& g, int game_len, int threads, bool staged = false) {
  while (threads > MIN_THREADS && block_bytes(g, game_len, threads, staged) > MAX_SHARED)
    threads = threads / 64 * 32;
  return block_bytes(g, game_len, threads, staged) <= MAX_SHARED ? threads : 0;
}

// How a block of the game (a host array) is sized when `threads` lanes are
// asked for: out = {words a lane holds, lanes of the block that fits (0 =
// none), its bytes of shared memory (of one warp's block when none fits),
// the most bytes a block can have, and the same two for ST's block, which
// also stages its rooms}. The one place the sizing is computed.
inline void size_report(const int32_t* game, int game_len, int threads, int64_t* out) {
  const Game g = game_view(game);
  const int fit = fit_threads(g, game_len, threads);
  const int st_fit = fit_threads(g, game_len, threads, true);
  out[0] = (int64_t)g.L.words * g.SW;
  out[1] = fit;
  out[2] = shared_bytes(g, game_len, fit ? fit : MIN_THREADS);
  out[3] = MAX_SHARED;
  out[4] = st_fit;
  out[5] = block_bytes(g, game_len, st_fit ? st_fit : MIN_THREADS, true);
}

// One room: its seats' words and its scalars, its seat sets NW words. On
// the device every lane of the group holds a copy with its own `lane`; the
// scalars agree across them.
template <int NW_>
struct Room {
  static constexpr int NW = NW_;
  int32_t* w;     // the room's words: w[slot * stride + seat]
  int stride;     // words between slots: the block's columns (host: the room's)
  int lane;       // device: this thread's lane (seats lane, lane + 32, ...)
  uint32_t mask;  // device: the group's lanes within the warp
  int shift;      // device: the group's first lane within the warp
  int32_t phase, prev, done, winner, t;
  uint32_t seed;
  Seats<NW> present;  // the occupied seats (constant over a rollout)
#ifdef GE_PROFILE
  long long prof[N_PROF];
#endif
  GE_HDM int32_t& at(int slot, int p) const { return w[slot * stride + p]; }
};

// The seats p < P where f(p): a ballot over the group a word (a word of a
// wide room is its 32 lanes' seats 32 j + lane).
template <class R, class F>
GE_HD Seats<R::NW> seats_where(const Game& g, const R& r, F f) {
  Seats<R::NW> m;
#ifdef __CUDA_ARCH__
  GE_UNROLL
  for (int j = 0; j < R::NW; ++j) {
    m.w[j] = 0u;
    if (j == 0 || 32 * j < g.P) {  // the same in every lane of the group
      const int p = 32 * j + r.lane;
      const bool v = p < g.P && f(p);
      m.w[j] = (__ballot_sync(r.mask, v) & r.mask) >> r.shift;
    }
  }
#else
  for (int j = 0; j < R::NW; ++j) m.w[j] = 0u;
  for (int p = 0; p < g.P; ++p)
    if (f(p)) m.w[p >> 5] |= 1u << (p & 31);
#endif
  return m;
}

// Global state in the (bank, P, rooms) int32 layout of
// core/rollout_kernel.to_minor: one field of consecutive rooms is contiguous.
struct MinorState {
  int32_t *bools, *nums, *strs, *pdict, *odict, *present, *regs, *scal;
};

// the global word behind state slot `slot` of seat p of room i
GE_HD int32_t* state_word(const Game& g, const MinorState& m, int slot, int p,
                          int64_t i, int64_t B) {
  const Layout& L = g.L;
  const int64_t P = g.P;
  if (slot < L.nums) return m.bools + ((slot - L.bools) * P + p) * B + i;
  if (slot < L.strs) return m.nums + ((slot - L.nums) * P + p) * B + i;
  if (slot < L.pdict) return m.strs + ((slot - L.strs) * P + p) * B + i;
  if (slot < L.odict) {  // slot = f * P + q holds pdict[f][p][q]
    const int f = (slot - L.pdict) / g.P, q = (slot - L.pdict) % g.P;
    return m.pdict + ((f * P + p) * P + q) * B + i;
  }
  if (slot < L.present) return m.odict + ((slot - L.odict) * P + p) * B + i;
  if (slot == L.present) return m.present + p * B + i;
  return m.regs + ((slot - L.acted) * P + p) * B + i;
}

// what a state slot holds of a global word: flags as 0/1, int8 banks as
// their low byte
GE_HD int32_t state_value(const Game& g, int slot, int32_t v) {
  const Layout& L = g.L;
  if (slot < L.nums || slot == L.present || slot == L.acted) return v != 0;
  if (slot >= L.strs && slot < L.present) return low_byte(v);
  return v;
}

// Loads (store = false) or stores the state words of rooms [room0, room0 + R)
// that exist, R rooms of `cols` columns each in w; worker `tid` of `n` takes
// every n-th word in (slot, seat, room) order, so neighbouring workers touch
// neighbouring rooms of one field: contiguous global words.
GE_HD void rooms_copy(const Game& g, const MinorState& m, int32_t* w, int stride,
                      int cols, int R, int64_t room0, int64_t B, int tid, int n,
                      bool store) {
  const int total = g.L.state * g.P * R;
  for (int x = tid; x < total; x += n) {
    const int rr = x % R, p = (x / R) % g.P, slot = x / (R * g.P);
    if (room0 + rr >= B) continue;
    int32_t* gw = state_word(g, m, slot, p, room0 + rr, B);
    int32_t& sw = w[slot * stride + rr * cols + p];
    if (store) *gw = sw;
    else sw = state_value(g, slot, *gw);
  }
}

// The room's scalars from global memory and the present set from its words
// (after rooms_copy and a barrier); w points at the room's first column.
template <int NW>
GE_HD Room<NW> room_open(const Game& g, const MinorState& m, int32_t* w, int stride,
                         int lane, uint32_t mask, int shift, int64_t i, int64_t B) {
  Room<NW> r;
  r.w = w; r.stride = stride; r.lane = lane; r.mask = mask; r.shift = shift;
  r.phase = m.scal[i];
  r.prev = m.scal[B + i];
  r.done = m.scal[2 * B + i] != 0;
  r.winner = m.scal[3 * B + i];
  r.t = m.scal[4 * B + i];
  r.seed = (uint32_t)m.scal[5 * B + i];
  r.present = seats_where(g, r, [&](int p) { return r.at(g.L.present, p) != 0; });
#ifdef GE_PROFILE
  for (int k = 0; k < N_PROF; ++k) r.prof[k] = 0;
#endif
  return r;
}

// The scalars back to global memory (one lane of the group calls it).
template <class R>
GE_HD void room_close(const R& r, const MinorState& m, int64_t i, int64_t B) {
  m.scal[i] = r.phase;
  m.scal[B + i] = r.prev;
  m.scal[2 * B + i] = r.done;
  m.scal[3 * B + i] = r.winner;
  m.scal[4 * B + i] = r.t;
  m.scal[5 * B + i] = (int32_t)r.seed;
}

// -- predicates -------------------------------------------------------------

// atom `field <op> const` for seat p
template <class R>
GE_HD bool atom_eval(const Game& g, const R& r, int ai, int p) {
  GE_ADD(CNT_ATOMS, 1);
  const int32_t* a = g.gm + g.atoms + ai * 5;
  if (a[0] == AB_CONST) return a[4] == 1;
  const int slot = (a[0] == AB_BOOL ? g.L.bools : a[0] == AB_NUM ? g.L.nums : g.L.strs) + a[1];
  return compare(a[2], r.at(slot, p), a[3]);
}

// DNF predicate: no terms = false; an empty term = true
template <class R>
GE_HD bool pred_eval(const Game& g, const R& r, int pi, int p) {
  const int32_t* pred_off = g.gm + g.pred_off;
  const int32_t* term_off = g.gm + g.term_off;
  const int32_t* lits = g.gm + g.lits;
  for (int t = pred_off[pi]; t < pred_off[pi + 1]; ++t) {
    bool ok = true;
    for (int l = term_off[t]; l < term_off[t + 1] && ok; ++l)
      ok = atom_eval(g, r, lits[l], p);
    if (ok) return true;
  }
  return false;
}

// is_alive if declared, else present, for the seat itself
template <class R>
GE_HD bool alive_self(const Game& g, const R& r, int p) {
  return has_bit(r.present, p) && (g.alive_slot < 0 || r.at(g.L.bools + g.alive_slot, p));
}

// the alive seats
template <class R>
GE_HD Seats<R::NW> alive_mask(const Game& g, const R& r) {
  return seats_where(g, r, [&](int p) { return alive_self(g, r, p); });
}

// present players satisfying predicate pi
template <class R>
GE_HD int count_pred(const Game& g, const R& r, int pi) {
  return popc(seats_where(g, r, [&](int p) {
    return has_bit(r.present, p) && pred_eval(g, r, pi, p);
  }));
}

// Room-level branch condition, the same in every lane. An AND is the
// conjunction of its children, so the tree is walked with an explicit stack
// (no device recursion): its children wait in the room's stack slots, each
// lane in its own column, which the host sizes to the game's largest tree
// (layout_of). A phase mask is the row's two words, or past 63 phases
// words in the pool (pack.py).
template <class R>
GE_HD bool cond_eval(const Game& g, const R& r, int root) {
  int sp = 0, node = root;
  for (;;) {
    const int32_t* c = g.gm + g.conds + node * 5;
    switch (c[0]) {
      case COND_ALWAYS: break;
      case COND_COUNTCMP: {
        int lhs = count_pred(g, r, c[1]);
        int rhs = c[3] >= 0 ? count_pred(g, r, c[3]) : c[4];
        if (!compare(c[2], lhs, rhs)) return false;
        break;
      }
      case COND_ALLPRESENT:
        if (count_pred(g, r, c[1]) != popc(r.present)) return false;
        break;
      case COND_PREVIN:
        if (!(g.NP + 1 <= 64 ? mask64_has(c[1], c[2], r.prev + 1)
                             : mask_has(g.gm + g.pool + c[1], c[2], r.prev + 1)))
          return false;
        break;
      case COND_AND:
        for (int k = 0; k < c[2]; ++k) r.at(g.L.stack + sp++, r.lane) = g.gm[g.pool + c[1] + k];
        break;
      default: return false;
    }
    if (sp == 0) return true;
    node = r.at(g.L.stack + --sp, r.lane);
  }
}

// -- on-enter effect programs (P20) ------------------------------------------

// One MECH_EFFECTS program. Per block, every node is evaluated before any
// statement, so the nodes read the block-entry state from the live words;
// statements then write the seat's own words in declared order.
template <class R>
GE_HD void run_effects(const Game& g, R& r, const int32_t* q) {
  const int P = g.P;
  const Layout& L = g.L;
  const int32_t* pool = g.gm + g.pool;
  int off = q[0];
  const int n_blocks = q[1], rv_off = q[2], rv_n = q[3];
  const int np = popc(r.present);
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int n_nodes = pool[off], n_stmts = pool[off + 1];
    const int32_t* nodes = pool + off + 2;
    const int32_t* stmts = nodes + n_nodes * 4;
    off += 2 + n_nodes * 4 + n_stmts * 6;
    GE_SYNC(r);  // the last block's readers are done with the node values

    for (int k = 0; k < n_nodes; ++k) {
      const int32_t* nd = nodes + k * 4;
      const int kind = nd[0], a = nd[1], b = nd[2], c = nd[3];
      // operand values, formed only where a/b/c name nodes
      auto va = [&](int s) { return r.at(L.vals + a, s); };
      auto vb = [&](int s) { return r.at(L.vals + b, s); };
      auto vc = [&](int s) { return r.at(L.vals + c, s); };
      if (kind >= NK_AT) GE_SYNC(r);  // reads the other seats' operands
      GE_EACH_SEAT(g, r, p) {
        int32_t out = 0;
        GE_ADD(CNT_NODES, node_ops(kind, p, P));
        switch (kind) {
          case NK_CONST: out = a; break;
          case NK_FIELD:
            out = r.at((a == FXB_BOOL ? L.bools : a == FXB_NUM ? L.nums : L.strs) + b, p);
            break;
          case NK_SEAT: out = p + 1; break;
          case NK_NPLAYERS: out = np; break;
          case NK_CHOICE: out = r.at(L.choice, p); break;
          case NK_CHOSEIN: out = mask64_has(a, b, r.at(L.choice_phase, p) + 1); break;
          case NK_ALIVE: out = alive_self(g, r, p); break;
          case NK_PRESENT: out = has_bit(r.present, p); break;
          case NK_PRED: out = pred_eval(g, r, a, p); break;
          case NK_BIN: {
            const int32_t x = vb(p), y = vc(p);
            out = a == BIN_ADD ? wrap_add(x, y) : a == BIN_SUB ? wrap_sub(x, y)
                : a == BIN_MUL ? wrap_mul(x, y) : a == BIN_MIN ? (x < y ? x : y)
                : (x > y ? x : y);
            break;
          }
          case NK_CMP: out = compare(a, vb(p), vc(p)); break;
          case NK_NOT: out = va(p) == 0; break;
          case NK_AND: out = va(p) != 0 && vb(p) != 0; break;
          case NK_OR: out = va(p) != 0 || vb(p) != 0; break;
          case NK_WHERE: out = va(p) != 0 ? vb(p) : vc(p); break;
          case NK_AT: {  // val[idx-1] if idx names a present seat, else 0
            const int32_t i = vb(p);
            out = (i >= 1 && i <= P && has_bit(r.present, i - 1)) ? va(i - 1) : 0;
            break;
          }
          case NK_INCOMING: {  // sum of val over masked seats whose key names p
            uint32_t s = 0;
            for (int j = 0; j < P; ++j)
              if (vc(j) != 0 && has_bit(r.present, j) && vb(j) == p + 1) s += (uint32_t)va(j);
            out = (int32_t)s;
            break;
          }
          case NK_EQCOUNT:
          case NK_RANK: {  // masked seats (all / earlier) with an equal key
            const int hi = kind == NK_RANK ? p : P;
            for (int j = 0; j < hi; ++j)
              out += vb(j) != 0 && has_bit(r.present, j) && va(j) == va(p);
            break;
          }
          case NK_REDUCE: {  // room-level; empty max/min is 0
            bool any = false;
            for (int j = 0; j < P; ++j) {
              if (vc(j) == 0 || !has_bit(r.present, j)) continue;
              const int32_t v = vb(j);
              if (a == RED_COUNT) out += 1;
              else if (a == RED_SUM) out = wrap_add(out, v);
              else if (!any) out = v;
              else if (a == RED_MAX) out = v > out ? v : out;
              else out = v < out ? v : out;
              any = true;
            }
            break;
          }
          case NK_ARGBEST: {  // ties resolve to the lowest seat; empty is 0
            int32_t best = 0;
            for (int j = 0; j < P; ++j) {
              if (vc(j) == 0 || !has_bit(r.present, j)) continue;
              const int32_t v = vb(j);
              if (out == 0 || (a == ARG_MAX ? v > best : v < best)) { best = v; out = j + 1; }
            }
            break;
          }
          default: break;
        }
        r.at(L.vals + k, p) = out;
      }
    }

    GE_SYNC(r);  // statements read seat 1's and the deal's node values
    for (int si = 0; si < n_stmts; ++si) {
      const int32_t* st = stmts + si * 6;
      const int skind = st[0], bank = st[1], slot = st[2];
      auto vv = [&](int s) { return r.at(L.vals + st[3], s); };
      auto vw = [&](int s) { return r.at(L.vals + st[4], s); };
      auto vk = [&](int s) { return r.at(L.vals + st[5], s); };
      if (skind == ST_OVER) {  // P11/P17: trigger and winner from seat 1
        if (vw(0) != 0 && has_bit(r.present, 0)) { r.done = 1; r.winner = vv(0); }
        continue;
      }
      if (skind == ST_DEAL) {
        // P10: rank every seat by splitmix32 key (absent seats last); st[3]
        // is the pool offset of the (P+1, P) multiset table, st[5] the salt
        GE_EACH_SEAT(g, r, p)
          r.at(L.tmp, p) = (int32_t)(has_bit(r.present, p)
              ? splitmix32(r.seed * 0x100u + (uint32_t)p + (uint32_t)vk(p) * GOLDEN)
              : 0xFFFFFFFFu);
        GE_SYNC(r);
        GE_EACH_SEAT(g, r, p) {
          if (vw(p) == 0 || !has_bit(r.present, p)) continue;
          const uint32_t mine = (uint32_t)r.at(L.tmp, p);
          int rank = 0;
          for (int j = 0; j < P; ++j) {
            const uint32_t key = (uint32_t)r.at(L.tmp, j);
            rank += key < mine || (key == mine && j < p);
          }
          GE_ADD(CNT_WRITES, 1);
          r.at(L.strs + slot, p) = low_byte(pool[st[3] + np * P + rank]);
        }
        GE_SYNC(r);  // the keys are read; tmp is free again
        continue;
      }
      GE_EACH_SEAT(g, r, p) {
        if (vw(p) == 0 || !has_bit(r.present, p)) continue;
        GE_ADD(CNT_WRITES, 1);
        switch (skind) {
          case ST_KILL:  // P15: clear is_alive, then set the reveal flags
            if (g.alive_slot >= 0) r.at(L.bools + g.alive_slot, p) = 0;
            for (int k = 0; k < rv_n; ++k) r.at(L.bools + pool[rv_off + k], p) = 1;
            break;
          case ST_SET:
            if (bank == FXB_BOOL) r.at(L.bools + slot, p) = vv(p) != 0;
            else if (bank == FXB_STR) r.at(L.strs + slot, p) = low_byte(vv(p));
            else r.at(L.nums + slot, p) = vv(p);
            break;
          case ST_ADD:
            r.at(L.nums + slot, p) = wrap_add(r.at(L.nums + slot, p), vv(p));
            break;
          case ST_RESET:  // dict banks clear to empty
            if (bank == FXB_ODICT) r.at(L.odict + slot, p) = 0;
            else for (int j = 0; j < P; ++j) r.at(L.pdict + slot * P + j, p) = 0;
            break;
          case ST_SETD: {  // pdict[key] = val; a key naming no present seat is a no-op
            const int32_t k = vk(p);
            if (k >= 1 && k <= P && has_bit(r.present, k - 1))
              r.at(L.pdict + slot * P + (k - 1), p) = low_byte(vv(p));
            break;
          }
          default: break;
        }
      }
    }
  }
}

// Every mechanic of the room's (just entered) phase, in declared order.
template <class R>
GE_HD void apply_on_enter(const Game& g, R& r) {
  for (int mi = 0; mi < g.n_mechs; ++mi) {
    const int32_t* m = g.gm + g.mechs + mi * MECH_ROW;
    if (m[0] == MECH_EFFECTS && m[1] == r.phase) {
      GE_TIC(r);
      run_effects(g, r, m + 2);
      GE_TOC(r, PROF_EFFECTS + mi < N_PROF ? PROF_EFFECTS + mi : N_PROF - 1);
    }
  }
}

// -- bots, step, reset --------------------------------------------------------

// Scripted bots (engine.scripted_actions): one splitmix32 stream per
// (seed, t, seat); every present seat emits into its action word,
// acceptance filters.
template <class R>
GE_HD void room_policy(const Game& g, R& r) {
  GE_TIC(r);
  const int32_t* ph = g.gm + g.phase + r.phase * PHASE_ROW;
  const int kind = ph[4], kmax = ph[5];
  const uint32_t h0 = splitmix32(r.seed * MIX + (uint32_t)r.t);
  const auto alive = alive_mask(g, r);
  const int n_alive = popc(alive), np = popc(r.present);
  GE_EACH_SEAT(g, r, p) {
    const uint32_t h = splitmix32(h0 ^ ((uint32_t)(p + 1) * GOLDEN));
    int32_t c = 0;
    if (kind == K_TARGET) {  // the k-th alive seat, k = h % n_alive
      if (n_alive > 0) c = nth_set_bit(alive, (int)(h % (uint32_t)n_alive)) + 1;
    } else if (kind == K_OPTION) {
      const uint32_t hi = (uint32_t)(kmax > 0 ? kmax : np);
      c = 1 + (int32_t)(h % (hi > 0 ? hi : 1u));
    } else if (kind == K_SUBMIT) {
      c = 1;
    }
    r.at(g.L.act, p) = has_bit(r.present, p) ? c : 0;
  }
  GE_TOC(r, PROF_POLICY);
}

// One engine step (core/step.py make_step) on the seats' action words: P1/P2
// acceptance against the pre-step state, record writes, P3 completion, P4/P5
// first-match branch, transition and on-enter mechanics. t counts every
// step, done or not.
template <class R>
GE_HD void room_step(const Game& g, R& r) {
  const int P = g.P;
  const Layout& L = g.L;
  const int i = r.phase;
  const int32_t* ph = g.gm + g.phase + i * PHASE_ROW;
  const bool is_action = ph[0] != 0;
  const int tpred = ph[1], kind = ph[4], kmax = ph[5];
  const int rec_num = ph[6], rec_pd = ph[7], pd_src = ph[8], rec_od = ph[9];
  const int np = popc(r.present);
  {
    GE_TIC(r);
    GE_SYNC(r);  // the strings the last step's effects or reset wrote
    const auto alive = alive_mask(g, r);
    // a seat's records touch only its own words, and never a string or the
    // alive set another seat's acceptance reads
    GE_EACH_SEAT(g, r, p) {
      const int32_t c = r.at(L.act, p);
      const bool targeted = has_bit(r.present, p) && pred_eval(g, r, tpred, p);
      const bool in_players = c >= 1 && c <= P;
      bool legal;
      if (kind == K_TARGET) legal = in_players && has_bit(alive, c - 1);
      else if (kind == K_OPTION) legal = c >= 1 && c <= (kmax > 0 ? kmax : np);
      else legal = kind == K_SUBMIT;
      const bool accept = is_action && !r.done && targeted && !r.at(L.acted, p) && c != 0 && legal;
      if (accept) {
        const int32_t c_norm = kind == K_SUBMIT ? 1 : c;
        GE_ADD(CNT_WRITES, 1);
        for (int b = 0; b < g.NB; ++b) {
          if (g.gm[g.rec_true + i * g.NB + b]) r.at(L.bools + b, p) = 1;
          if (g.gm[g.rec_false + i * g.NB + b]) r.at(L.bools + b, p) = 0;
        }
        if (rec_num >= 0 && rec_num < g.NN) r.at(L.nums + rec_num, p) = c_norm;
        if (rec_pd >= 0 && rec_pd < g.NPD && in_players) {
          // pdict record: the target's source-string code, translated
          const int32_t src = (pd_src >= 0 && pd_src < g.NS) ? r.at(L.strs + pd_src, c - 1) : 0;
          const int32_t tr = (src >= 0 && src < g.maxv) ? g.gm[g.pdtrans + i * g.maxv + src] : 0;
          r.at(L.pdict + rec_pd * P + (c - 1), p) = low_byte(pd_src >= 0 ? tr : 0);
        }
        if (rec_od >= 0 && rec_od < g.NOD) r.at(L.odict + rec_od, p) = 1;
        r.at(L.acted, p) = 1;
        r.at(L.choice, p) = c_norm;
        r.at(L.choice_phase, p) = i;
      }
      r.at(L.tmp, p) = targeted && !r.at(L.acted, p);  // still owed an action
    }
    GE_SYNC(r);  // every seat has read its target's string
    GE_TOC(r, PROF_ACCEPT);
  }

  GE_TIC(r);
  bool complete = !r.done;
  if (is_action && any(seats_where(g, r, [&](int p) { return r.at(L.tmp, p) != 0; })))
    complete = false;
  int next = ph[3];
  if (complete) {  // the branch matters only to a room that moves on
    const int32_t* branch_off = g.gm + g.branch_off;
    const int32_t* branches = g.gm + g.branches;
    const int b0 = branch_off[i], b1 = branch_off[i + 1];
    if (b1 > b0) {
      next = branches[(b1 - 1) * 2 + 1];  // P5 fallback: the last branch
      for (int b = b0; b < b1; ++b)
        if (cond_eval(g, r, branches[b * 2])) { next = branches[b * 2 + 1]; break; }
    }
  }
  GE_TOC(r, PROF_BRANCH);
  r.t += 1;
  if (complete && next != i) {
    r.prev = i;
    r.phase = next;
    GE_EACH_SEAT(g, r, p) r.at(L.acted, p) = 0;
    apply_on_enter(g, r);
  }
}

// A fresh room of n seats (init_state): defaults, start phase, on-enter.
template <class R>
GE_HD void room_init(const Game& g, R& r, int n, uint32_t seed) {
  const Layout& L = g.L;
  const int32_t* defaults = g.gm + g.defaults;
  {
    GE_TIC(r);
    GE_EACH_SEAT(g, r, p) {
      for (int b = 0; b < g.NB; ++b) r.at(L.bools + b, p) = defaults[b] != 0;
      for (int b = 0; b < g.NN; ++b) r.at(L.nums + b, p) = defaults[g.NB + b];
      for (int b = 0; b < g.NS; ++b) r.at(L.strs + b, p) = low_byte(defaults[g.NB + g.NN + b]);
      for (int x = 0; x < g.NPD * g.P; ++x) r.at(L.pdict + x, p) = 0;
      for (int s = 0; s < g.NOD; ++s) r.at(L.odict + s, p) = 0;
      r.at(L.present, p) = p < n;
      r.at(L.acted, p) = 0;
      r.at(L.choice, p) = 0;
      r.at(L.choice_phase, p) = -1;
    }
    r.present = first_seats<R::NW>(n);
    r.phase = g.start_index;
    r.prev = -1;
    r.done = 0;
    r.winner = 0;
    r.t = 0;
    r.seed = seed;
    GE_TOC(r, PROF_RESET);
  }
  apply_on_enter(g, r);
}

// num_steps of bots -> step -> fresh-completion count -> auto-reset
// (engine.make_rollout). Returns the episodes completed.
template <class R>
GE_HD int32_t room_rollout(const Game& g, R& r, int num_steps, int auto_reset) {
  int32_t episodes = 0;
  for (int s = 0; s < num_steps; ++s) {
    room_policy(g, r);
    const int32_t done_in = r.done;
    room_step(g, r);
    episodes += r.done && !done_in;  // a room born done is not recounted
    if (auto_reset && r.done) room_init(g, r, popc(r.present), splitmix32(r.seed ^ 0xDECAF000u));
  }
  return episodes;
}

// -- the engine step entry on GameState's own tensors (ST) --------------------

// GameState's fields (core/state.py) as they lie in memory, row-major with
// the rooms leading and each in its own dtype: a torch bool is a byte of 0
// or 1, and the seed an int64 holding a uint32. In the field order of
// GameState, which is the order of the host's pointer array (batch_state).
struct BatchState {
  uint8_t* bools;        // (B, P, NB)
  int32_t* nums;         // (B, P, NN)
  int8_t* strs;          // (B, P, NS)
  int8_t* pdict;         // (B, P, NPD, P)
  int8_t* odict;         // (B, P, NOD)
  uint8_t* present;      // (B, P)
  int32_t* phase;        // (B,)
  int32_t* prev;         // (B,)
  uint8_t* acted;        // (B, P)
  int32_t* choice;       // (B, P)
  int32_t* choice_phase; // (B, P)
  uint8_t* done;         // (B,)
  int32_t* winner;       // (B,)
  int32_t* t;            // (B,)
  int64_t* seed;         // (B,)
};
constexpr int BATCH_FIELDS = 15;

inline BatchState batch_state(const int64_t* f) {
  return {(uint8_t*)f[0], (int32_t*)f[1], (int8_t*)f[2], (int8_t*)f[3], (int8_t*)f[4],
          (uint8_t*)f[5], (int32_t*)f[6], (int32_t*)f[7], (uint8_t*)f[8], (int32_t*)f[9],
          (int32_t*)f[10], (uint8_t*)f[11], (int32_t*)f[12], (int32_t*)f[13], (int64_t*)f[14]};
}

// A word from its tensor's element and back, as core/rollout_kernel.to_minor
// and from_minor convert: a flag as 0/1, an int8 sign-extended in and its
// low byte out, an int32 as it is.
GE_HD int32_t word_of(uint8_t v) { return v != 0; }
GE_HD int32_t word_of(int8_t v) { return v; }
GE_HD int32_t word_of(int32_t v) { return v; }
GE_HD void put_word(uint8_t& d, int32_t v) { d = v != 0; }
GE_HD void put_word(int8_t& d, int32_t v) { d = (int8_t)v; }
GE_HD void put_word(int32_t& d, int32_t v) { d = v; }

// -- a block's copy: runs of elements, its loads in flight together ----------

// A run of a block's copy: `count` elements of `size` bytes (1 or 4) from
// src to dst.
struct Run {
  const void* src;
  void* dst;
  int count, size;
};

// A run of `bytes` bytes: 4-byte words where both ends and the length allow
// (a GameState field's stretch of a block's rooms mostly does), else bytes.
GE_HD Run byte_run(const void* src, void* dst, int64_t bytes) {
  const uintptr_t ends = (uintptr_t)src | (uintptr_t)dst | (uintptr_t)bytes;
  const int size = (ends & 15) == 0 ? 16 : (ends & 3) == 0 ? 4 : 1;
  return Run{src, dst, (int)(bytes / size), size};
}

GE_HD uint32_t run_load(const Run& r, int x) {
  return r.size == 4 ? ((const uint32_t*)r.src)[x] : ((const uint8_t*)r.src)[x];
}

GE_HD void run_store(const Run& r, int x, uint32_t v) {
  if (r.size == 4) ((uint32_t*)r.dst)[x] = v;
  else ((uint8_t*)r.dst)[x] = (uint8_t)v;
}

// element x of a run of any size, loaded and stored
GE_HD void run_move(const Run& r, int x) {
  if (r.size == 16) {
#ifdef __CUDA_ARCH__
    ((uint4*)r.dst)[x] = ((const uint4*)r.src)[x];
#else
    for (int b = 0; b < 4; ++b) ((uint32_t*)r.dst)[4 * x + b] = ((const uint32_t*)r.src)[4 * x + b];
#endif
  } else {
    run_store(r, x, run_load(r, x));
  }
}

// Worker tid of n starts copying run r from global to shared memory:
// elements tid, tid + n, ... On the device a run of 4- or 16-byte elements
// is cp.async (the copy engine moves it while the worker goes on: a block's
// many small runs, GameState's fields, wait for memory together, in
// copy_wait, and hold no registers); a byte run is loaded and stored here.
// Consecutive workers take consecutive elements (coalesced).
GE_HD void copy_start(const Run& r, int tid, int n) {
#ifdef __CUDA_ARCH__
  if (r.size == 4 || r.size == 16) {
    const char* s = (const char*)r.src;
    char* d = (char*)r.dst;
    for (int x = tid; x < r.count; x += n) {
      const unsigned at = (unsigned)__cvta_generic_to_shared(d + (size_t)x * r.size);
      if (r.size == 4)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(at),
                     "l"(s + (size_t)x * 4));
      else
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(at),
                     "l"(s + (size_t)x * 16));
    }
    return;
  }
#endif
  for (int x = tid; x < r.count; x += n) run_move(r, x);
}

// Waits for this worker's copy_start copies (a barrier then makes every
// worker's visible to the block).
GE_HD void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Worker tid of n copies run r from shared memory (or global) to global:
// each element loaded and stored, the stores not waited for.
GE_HD void copy_out(const Run& r, int tid, int n) {
  for (int x = tid; x < r.count; x += n) run_move(r, x);
}

// The game array (int32) to shared memory: 16-byte runs where the whole
// array allows (its start and the shared copy are 16-byte aligned), the
// tail in 4-byte ones.
GE_HD void blob_start(const int32_t* src, int32_t* dst, int len, int tid, int n) {
  const int vecs = ((uintptr_t)src & 15) ? 0 : len / 4;
  copy_start(Run{src, dst, vecs, 16}, tid, n);
  copy_start(Run{src + 4 * vecs, dst + 4 * vecs, len - 4 * vecs, 4}, tid, n);
}

// A block's workers as crews for a copy: warp w takes runs w, w + warps,
// ..., its lanes a run's elements (the host: one crew of one).
struct Crew {
  int warp, warps, lane, width;
};

GE_HD Crew crew_of(int tid, int n) {
#ifdef __CUDA_ARCH__
  return Crew{tid >> 5, (n + 31) >> 5, tid & 31, 32};
#else
  (void)tid;
  (void)n;
  return Crew{0, 1, 0, 1};
#endif
}

// -- ST: a block's rooms staged through shared memory --------------------------

// GameState's fields in BatchState order, then the (B, P) int32 actions
enum { F_BOOLS, F_NUMS, F_STRS, F_PDICT, F_ODICT, F_PRESENT, F_PHASE, F_PREV, F_ACTED,
       F_CHOICE, F_CHOICE_PHASE, F_DONE, F_WINNER, F_T, F_SEED, F_ACT, ST_FIELDS };

// bytes an element of field f
GE_HD int field_size(int f) {
  switch (f) {
    case F_BOOLS: case F_STRS: case F_PDICT: case F_ODICT: case F_PRESENT: case F_ACTED:
    case F_DONE: return 1;
    case F_SEED: return 8;
    default: return 4;
  }
}

GE_HD void* field_ptr(const BatchState& s, int32_t* act, int f) {
  switch (f) {
    case F_BOOLS: return s.bools;
    case F_NUMS: return s.nums;
    case F_STRS: return s.strs;
    case F_PDICT: return s.pdict;
    case F_ODICT: return s.odict;
    case F_PRESENT: return s.present;
    case F_PHASE: return s.phase;
    case F_PREV: return s.prev;
    case F_ACTED: return s.acted;
    case F_CHOICE: return s.choice;
    case F_CHOICE_PHASE: return s.choice_phase;
    case F_DONE: return s.done;
    case F_WINNER: return s.winner;
    case F_T: return s.t;
    case F_SEED: return s.seed;
    default: return act;
  }
}

// The game's widths that size a block's staging (dims_per_room's), set by
// the host (st_fill) so that a block reckons its runs from its launch's
// arguments, not from the blob in global memory.
struct StDims {
  int P, NB, NN, NS, NPD, NOD;
};

GE_HD int dims_per_room(const StDims& d, int f) {
  switch (f) {
    case F_BOOLS: return d.P * d.NB;
    case F_NUMS: return d.P * d.NN;
    case F_STRS: return d.P * d.NS;
    case F_PDICT: return d.P * d.NPD * d.P;
    case F_ODICT: return d.P * d.NOD;
    case F_PRESENT: case F_ACTED: case F_CHOICE: case F_CHOICE_PHASE: case F_ACT: return d.P;
    default: return 1;
  }
}

// The terminal rewards' rule (train/ppo.py terminal_rewards_plain): paid on
// the step that ends the room's episode, to its present seats; team mode +1
// when the seat's team string is the winner's team code (codes[winner - 1],
// the index clamped), else -1; score mode +1 to the winning seat and
// -1 / max(n - 1, 1) to the others of the n present.
enum { RW_NONE, RW_TEAM, RW_SCORE };
struct RewardRule {
  int mode, team_slot, n_codes;
  const int32_t* codes;
};

GE_HD float terminal_reward(const RewardRule& rw, int32_t team, int32_t winner, int p,
                            int n_present) {
  if (rw.mode == RW_TEAM) {
    int w = winner - 1;
    w = w < 0 ? 0 : w > rw.n_codes - 1 ? rw.n_codes - 1 : w;
    return team == rw.codes[w] ? 1.0f : -1.0f;
  }
  if (rw.mode == RW_SCORE) {
    const float m = (float)(n_present - 1);
    return winner == p + 1 ? 1.0f : -1.0f / (m > 1.0f ? m : 1.0f);
  }
  return 0.0f;
}

// Whether a rule names a team string of the game and some codes.
GE_HD bool reward_rule_ok(const Game& g, const RewardRule& rw) {
  if (rw.mode == RW_TEAM)
    return rw.team_slot >= 0 && rw.team_slot < g.NS && rw.n_codes > 0 && rw.codes != nullptr;
  return rw.mode == RW_NONE || rw.mode == RW_SCORE;
}

// What an ST launch does to each room: the scripted bots' actions into its
// action words (engine.scripted_actions), one engine step on the caller's
// action words (core/step.py make_step) where `keep`, a fresh room where
// done (train/ppo.py reset_done: init_state_like, as room_rollout resets),
// or the unroll's step, terminal rewards and restart in one (step_reset).
enum { ENTRY_BOTS, ENTRY_STEP, ENTRY_RESET, ENTRY_STEP_RESET };

// One room of an ST launch; returns whether the step ended an episode.
// ENTRY_STEP_RESET also gives what the unroll reads of the stepped room, its
// winner (*winner, the same in every lane) and with `reward` its P seats'
// terminal rewards, before the restart where done. Each of room_policy,
// room_step and room_init has one call site, so the kernel holds each once.
template <class R>
GE_HD bool room_entry(const Game& g, R& r, int mode, bool keep, const RewardRule& rw,
                      float* reward, int32_t* winner) {
  if (mode == ENTRY_BOTS) {
    room_policy(g, r);
    return false;
  }
  const int32_t done_in = r.done;
  const bool step = (mode == ENTRY_STEP || mode == ENTRY_STEP_RESET) && keep;
  if (step) room_step(g, r);
  const bool ended = step && r.done && !done_in;
  if (mode == ENTRY_STEP_RESET) {
    *winner = r.winner;
    if (reward) {
      const int np = popc(r.present);
      GE_EACH_SEAT(g, r, p)
        reward[p] = ended && has_bit(r.present, p)
            ? terminal_reward(rw, rw.mode == RW_TEAM ? r.at(g.L.strs + rw.team_slot, p) : 0,
                              r.winner, p, np)
            : 0.0f;
    }
  }
  if (mode != ENTRY_STEP && r.done)
    room_init(g, r, popc(r.present), splitmix32(r.seed ^ 0xDECAF000u));
  return ended;
}

// Byte offset of field f's run in a block's staging of R rooms: the fields
// one after another, each 16-byte aligned (a copy of 16-byte elements where
// the tensor's stretch allows); f = ST_FIELDS gives its bytes.
GE_HD int stage_offset(const StDims& d, int R, int f) {
  int o = 0;
  for (int k = 0; k < f; ++k) o += (R * dims_per_room(d, k) * field_size(k) + 15) & ~15;
  return o;
}

// A block's staging: its base and each field's offset (in shared memory,
// written once a block by the worker of that field).
struct Stage {
  uint8_t* base;
  const int* offs;
  template <class T>
  GE_HD T* at(int f) const { return (T*)(base + offs[f]); }
};

// An ST block of `threads` lanes in shared memory: the blob, the words (as
// K1's block: shared_bytes), then from a 16-byte boundary the staging of its
// threads / G rooms (G lanes a room), then the copies' runs (ST_FIELDS in,
// ST_FIELDS out) and the staging's ST_FIELDS + 1 offsets.
GE_HD int st_stage_at(const Game& g, int game_len, int threads) {
  return (int)((shared_bytes(g, game_len, threads) + 15) & ~(int64_t)15);
}

GE_HD StDims dims_of(const Game& g) { return StDims{g.P, g.NB, g.NN, g.NS, g.NPD, g.NOD}; }

GE_HD int st_runs_at(const Game& g, int game_len, int threads, int G) {
  const int R = threads / G > 0 ? threads / G : 1;
  return st_stage_at(g, game_len, threads) + stage_offset(dims_of(g), R, ST_FIELDS);
}

GE_HD int64_t st_shared_bytes(const Game& g, int game_len, int threads, int G) {
  return st_runs_at(g, game_len, threads, G) + 2 * ST_FIELDS * (int64_t)sizeof(Run) +
         (ST_FIELDS + 1) * (int64_t)sizeof(int);
}

struct StShared {
  int32_t* blob;
  int32_t* words;
  uint8_t* stage;
  Run* runs_in;
  Run* runs_out;
  int* offs;
};

GE_HD StShared st_shared(int game_len, int stage_at, int runs_at, void* smem) {
  StShared sh;
  sh.blob = (int32_t*)smem;
  sh.words = sh.blob + game_len;
  sh.stage = (uint8_t*)smem + stage_at;
  sh.runs_in = (Run*)((uint8_t*)smem + runs_at);
  sh.runs_out = sh.runs_in + ST_FIELDS;
  sh.offs = (int*)(sh.runs_out + ST_FIELDS);
  return sh;
}

// Field f's run of a block's copy of rooms [room0, room0 + R) (R existing)
// between its tensor (`s`, or `act` for F_ACT) and `staged`: `in` from the
// tensor, else back; empty unless `used`.
GE_HD Run st_run(const StDims& d, const BatchState& s, int32_t* act, uint8_t* staged, int R,
                 int64_t room0, bool in, bool used, int f) {
  if (!used) return Run{nullptr, nullptr, 0, 1};
  const int64_t bytes = (int64_t)dims_per_room(d, f) * field_size(f);
  uint8_t* t = (uint8_t*)field_ptr(s, act, f) + room0 * bytes;
  return in ? byte_run(t, staged, R * bytes) : byte_run(staged, t, R * bytes);
}

template <class T>
GE_HD void seat_words(T* raw, int width, int32_t* word, int stride, bool to_words) {
  for (int j = 0; j < width; ++j) {
    if (to_words) word[j * stride] = word_of(raw[j]);
    else put_word(raw[j], word[j * stride]);
  }
}

// The staged rooms' per-seat fields to their words (to_words) or back, and
// with `act` the action words: a seat (room rr, seat p) a worker, its words
// in column rr * cols + p. The rooms' scalars stay in the staging
// (room_open_staged).
GE_HD void st_words(const Game& g, const Stage& st, int R, int32_t* w, int stride, int cols,
                    bool state, bool act, bool to_words, int tid, int n) {
  const Layout& L = g.L;
  const int P = g.P;
  for (int x = tid; x < R * P; x += n) {
    const int rr = x / P, p = x - rr * P;
    int32_t* col = w + rr * cols + p;
    if (state) {
      seat_words(st.at<uint8_t>(F_BOOLS) + x * g.NB, g.NB, col + L.bools * stride, stride,
                 to_words);
      seat_words(st.at<int32_t>(F_NUMS) + x * g.NN, g.NN, col + L.nums * stride, stride,
                 to_words);
      seat_words(st.at<int8_t>(F_STRS) + x * g.NS, g.NS, col + L.strs * stride, stride,
                 to_words);
      seat_words(st.at<int8_t>(F_PDICT) + x * g.NPD * P, g.NPD * P, col + L.pdict * stride,
                 stride, to_words);
      seat_words(st.at<int8_t>(F_ODICT) + x * g.NOD, g.NOD, col + L.odict * stride, stride,
                 to_words);
      seat_words(st.at<uint8_t>(F_PRESENT) + x, 1, col + L.present * stride, stride, to_words);
      seat_words(st.at<uint8_t>(F_ACTED) + x, 1, col + L.acted * stride, stride, to_words);
      seat_words(st.at<int32_t>(F_CHOICE) + x, 1, col + L.choice * stride, stride, to_words);
      seat_words(st.at<int32_t>(F_CHOICE_PHASE) + x, 1, col + L.choice_phase * stride, stride,
                 to_words);
    }
    if (act) seat_words(st.at<int32_t>(F_ACT) + x, 1, col + L.act * stride, stride, to_words);
  }
}

// Room rr of the staging opened on its words (after st_words and a
// barrier): its scalars from the staging, the present set from its words.
template <int NW>
GE_HD Room<NW> room_open_staged(const Game& g, const Stage& st, int rr, int32_t* w, int stride,
                                int lane, uint32_t mask, int shift) {
  Room<NW> r;
  r.w = w; r.stride = stride; r.lane = lane; r.mask = mask; r.shift = shift;
  r.phase = st.at<int32_t>(F_PHASE)[rr];
  r.prev = st.at<int32_t>(F_PREV)[rr];
  r.done = st.at<uint8_t>(F_DONE)[rr] != 0;
  r.winner = st.at<int32_t>(F_WINNER)[rr];
  r.t = st.at<int32_t>(F_T)[rr];
  r.seed = (uint32_t)st.at<int64_t>(F_SEED)[rr];
  r.present = seats_where(g, r, [&](int p) { return r.at(g.L.present, p) != 0; });
#ifdef GE_PROFILE
  for (int k = 0; k < N_PROF; ++k) r.prof[k] = 0;
#endif
  return r;
}

// The room's scalars back to the staging (one lane of the group calls it);
// the seed as its uint32.
template <class R>
GE_HD void room_close_staged(const R& r, const Stage& st, int rr) {
  st.at<int32_t>(F_PHASE)[rr] = r.phase;
  st.at<int32_t>(F_PREV)[rr] = r.prev;
  st.at<uint8_t>(F_DONE)[rr] = r.done != 0;
  st.at<int32_t>(F_WINNER)[rr] = r.winner;
  st.at<int32_t>(F_T)[rr] = r.t;
  st.at<int64_t>(F_SEED)[rr] = (int64_t)r.seed;
}

// An ST launch's arguments: the game array on the device (the host's own
// in the g++ build), the state in and the state out (GameState's tensors),
// the (B, P) int32 actions (in for a step, out for the bots), the step's
// keep mask, and what each room's step gives the caller: ended (B,) bool,
// with step_reset also the stepped winner (B,) int32 and, unless null, the
// (B, P) f32 terminal rewards by `rw`. The game's widths and where a block's
// staging and runs lie in its shared memory come from the host (st_fill).
struct StArgs {
  const int32_t* game;
  int game_len;
  BatchState in, out;
  int32_t* actions;
  const uint8_t* keep;
  uint8_t* ended;
  int32_t* winner;
  float* reward;
  RewardRule rw;
  int64_t B;
  int mode;
  StDims d;
  int stage_at, runs_at;
};

// An ST launch's sizes from the game (a host view), its lanes a block and
// its lanes a room.
GE_HD void st_fill(StArgs& a, const Game& g, int lanes, int G) {
  a.d = dims_of(g);
  a.stage_at = st_stage_at(g, a.game_len, lanes);
  a.runs_at = st_runs_at(g, a.game_len, lanes, G);
}

// sections of ST's -DGE_PROFILE block clock sums (ge_step_sections)
enum { STS_SETUP, STS_ISSUE, STS_COPY_IN, STS_WORDS_IN, STS_ROOMS, STS_WORDS_OUT, STS_COPY_OUT,
       N_STS };

#ifdef __CUDA_ARCH__
#define GE_BLOCK_SYNC() __syncthreads()
#else
#define GE_BLOCK_SYNC() ((void)0)
#endif

// Field f's share of a block's set-up (the worker of that field, once a
// block): its staging offset (f = ST_FIELDS: the staging's bytes) and its
// runs in and out.
GE_HD void st_setup(const StArgs& a, const StShared& sh, int R, int64_t room0, int f) {
  const int off = stage_offset(a.d, R, f);
  sh.offs[f] = off;
  if (f == ST_FIELDS) return;
  const bool bots = a.mode == ENTRY_BOTS;
  const bool step = a.mode == ENTRY_STEP || a.mode == ENTRY_STEP_RESET;
  const bool state = f != F_ACT;
  sh.runs_in[f] = st_run(a.d, a.in, a.actions, sh.stage + off, R, room0, true, state || step,
                         f);
  sh.runs_out[f] = st_run(a.d, a.out, a.actions, sh.stage + off, R, room0, false,
                          state ? !bots : bots, f);
}

// One block of an ST launch: rooms [room0, room0 + R) that exist, a room on
// G lanes of a block of `lanes` (R = lanes / G), in `smem` as st_shared lays
// it out (the host: a block's buffer of st_shared_bytes), by worker tid of n
// (the device: a lane each; the host: one worker, the block's rooms one after
// another). A field's worker writes its runs (a block's set-up reckoned
// once, from the launch's arguments); the blob and the rooms' fields are
// copied in with cp.async (copy_start), their loads in flight together,
// turned into words (st_words), stepped (room_entry) with their scalars in
// the staging, turned back and copied out: the state's memory is read once
// and written once.
template <int NW>
GE_HD void st_block(const StArgs& a, void* smem, int64_t room0, int lanes, int G, int tid,
                    int n, long long* prof) {
  GE_MARK_START(prof);
  const int K = NW == 1 ? 1 : (a.d.P + 31) / 32;  // columns a lane
  const int Rb = (int)(a.B - room0 < lanes / G ? a.B - room0 : lanes / G);
  const StShared sh = st_shared(a.game_len, a.stage_at, a.runs_at, smem);
  const Stage st{sh.stage, sh.offs};
  blob_start(a.game, sh.blob, a.game_len, tid, n);
#ifdef __CUDA_ARCH__
  if (tid <= ST_FIELDS) st_setup(a, sh, Rb, room0, tid);
#else
  for (int f = 0; f <= ST_FIELDS; ++f) st_setup(a, sh, Rb, room0, f);
#endif
  GE_BLOCK_SYNC();
  GE_MARK(prof, STS_SETUP);
  for (int f = 0; f < ST_FIELDS; ++f) copy_start(sh.runs_in[f], tid, n);
  GE_MARK(prof, STS_ISSUE);
  copy_wait();
  GE_BLOCK_SYNC();
  GE_MARK(prof, STS_COPY_IN);
  const bool bots = a.mode == ENTRY_BOTS;
  const bool step = a.mode == ENTRY_STEP || a.mode == ENTRY_STEP_RESET;
  const Game g = game_view(sh.blob);
  st_words(g, st, Rb, sh.words, lanes * K, G * K, true, step, true, tid, n);
  GE_BLOCK_SYNC();
  GE_MARK(prof, STS_WORDS_IN);
#ifdef __CUDA_ARCH__
  {
    const int rr = tid / G, lane = tid & (G - 1), first = (tid & 31) & ~(G - 1);
    const uint32_t mask = (G == 32 ? 0xFFFFFFFFu : (1u << G) - 1u) << first;
    if (rr < Rb) {  // whole groups take or leave this branch
#else
  for (int rr = 0; rr < Rb; ++rr) {
    const int lane = 0, first = 0;
    const uint32_t mask = 0;
    {
#endif
      const int64_t room = room0 + rr;
      Room<NW> r = room_open_staged<NW>(g, st, rr, sh.words + rr * G * K, lanes * K, lane, mask,
                                        first);
      int32_t w = 0;
      const bool e = room_entry(g, r, a.mode, a.keep == nullptr || a.keep[room], a.rw,
                                a.reward ? a.reward + room * g.P : nullptr, &w);
      if (lane == 0 && !bots) {
        room_close_staged(r, st, rr);
        if (step) a.ended[room] = e;
        if (a.mode == ENTRY_STEP_RESET) a.winner[room] = w;
      }
    }
  }
  GE_BLOCK_SYNC();
  GE_MARK(prof, STS_ROOMS);
  st_words(g, st, Rb, sh.words, lanes * K, G * K, !bots, bots, false, tid, n);
  GE_BLOCK_SYNC();
  GE_MARK(prof, STS_WORDS_OUT);
  for (int f = 0; f < ST_FIELDS; ++f) copy_out(sh.runs_out[f], tid, n);
  GE_MARK_SYNC();
  GE_MARK(prof, STS_COPY_OUT);
}

// -- lookahead search (native/gamesim.cpp search_scores_core) -----------------

// A search request: a row of REQ_INTS int32, {source room, deciding seat
// (0-based), candidate choice, salt (uint32 bits)}; its total is the sum of
// `rollouts` rollout scores.
constexpr int REQ_INTS = 4;
enum { SEARCH_TEAM = 1, SEARCH_SCORE = 2 };

// What a rollout is scored by (train/ppo.py terminal_rewards): team mode by
// the seat's final team string against the winner's team code, score mode by
// the winning seat.
struct SearchSpec {
  int rollouts, horizon, mode, team_slot, n_codes;
  const int32_t* team_codes;
};

// The seed of rollout k of a request: the same stream for every candidate of
// a decision (common random numbers), as search_scores_core reseeds its copy.
GE_HD uint32_t search_seed(uint32_t salt, int32_t t, int k) {
  return splitmix32(salt ^ ((uint32_t)t * MIX) ^ (GOLDEN * (uint32_t)(k + 1)));
}

// Whether a request names a source room and a seat of the game.
GE_HD bool search_request_ok(const Game& g, const int32_t* q, int64_t B) {
  return q[0] >= 0 && q[0] < B && q[1] >= 0 && q[1] < g.P;
}

// One rollout of a search decision on a room opened from its source: up to
// `horizon` steps of the scripted bots and the engine step, seat p's action
// word set to c after the bots' first emission (only p's own lane writes it,
// before room_step's barrier), no reset, stopping once the room is done (the
// group's scalars agree, so its lanes leave together). Returns the rollout's
// score for seat p: 0 unless done; team mode +1 when p's final team is the
// winner's, else -1; score mode n - 1 when p won, else -1.
template <class R>
GE_HD int32_t room_search_rollout(const Game& g, R& r, int p, int32_t c, const SearchSpec& s) {
  for (int step = 0; step < s.horizon && !r.done; ++step) {
    room_policy(g, r);
    if (step == 0) GE_EACH_SEAT(g, r, q) if (q == p) r.at(g.L.act, q) = c;
    room_step(g, r);
  }
  if (!r.done) return 0;
  if (s.mode == SEARCH_TEAM) {
    int wi = r.winner - 1;
    wi = wi < 0 ? 0 : (wi >= s.n_codes ? s.n_codes - 1 : wi);
    GE_SYNC(r);  // seat p's team word, as the last effects left it
    return r.at(g.L.strs + s.team_slot, p) == s.team_codes[wi] ? 1 : -1;
  }
  return r.winner == p + 1 ? popc(r.present) - 1 : -1;
}

// Whether the search can score rollouts by this spec (a game with neither
// terminal rule is refused by the host).
GE_HD bool search_spec_ok(const Game& g, const SearchSpec& s) {
  return s.rollouts >= 1 && s.horizon >= 0 &&
         (s.mode == SEARCH_SCORE ||
          (s.mode == SEARCH_TEAM && s.team_slot >= 0 && s.team_slot < g.NS && s.n_codes > 0));
}


// -- the search's rooms, pulled one at a time ----------------------------------

// The group's own copy of room i: each lane loads its seats' state words
// into their columns of w, then the group barrier and room_open. A group
// loads its rollout's source room itself, so groups of one block (and of
// one warp) may run unrelated rollouts and take new ones at any time.
template <int NW>
GE_HD Room<NW> room_fetch(const Game& g, const MinorState& m, int32_t* w, int stride, int lane,
                          uint32_t mask, int shift, int64_t i, int64_t B) {
  Room<NW> r;
  r.w = w; r.stride = stride; r.lane = lane; r.mask = mask; r.shift = shift;
  GE_SYNC(r);  // the group is done with the words of its last rollout
  GE_EACH_SEAT(g, r, p)
    for (int slot = 0; slot < g.L.state; ++slot)
      r.at(slot, p) = state_value(g, slot, *state_word(g, m, slot, p, i, B));
  GE_SYNC(r);
  return room_open<NW>(g, m, w, stride, lane, mask, shift, i, B);
}

// Lanes a rollout's room: a lane a seat (a warp for more than 32 seats),
// doubled while n rollouts would all still hold a warp slot of `warp_slots`
// at twice the lanes (the rollout kernel's widening rule, launch_plan.cuh).
GE_HD int widen_lanes(int P, int64_t n, int64_t warp_slots) {
  int G = group_lanes(P);
  while (G < MAX_GROUP && n * (2 * G) / 32 <= warp_slots) G *= 2;
  return G;
}

// -- full-information decisions (native/gamesim.cpp gs_room_search) -----------

// The base salt of a room's decisions: policies/search.py _mix(seed, salt)
// in 32-bit arithmetic.
GE_HD uint32_t search_base(uint32_t seed, uint32_t salt) { return seed * GOLDEN + salt * MIX; }

// What the C++ search decides for seat p of an opened room whose alive seats
// are `alive` (search_scores_core before its rollouts): -1 when the seat is
// not waiting (room done, seat absent, no action phase, acted, or not
// targeted by the phase's predicate: room_step's acceptance test), else its
// number of candidates: the alive seats for a target phase, 1..(choice max
// or the seats present) for an option phase, one (the answer 1) for a
// submit phase, none for another kind.
template <class R>
GE_HD int seat_candidates(const Game& g, const R& r, int p, const Seats<R::NW>& alive) {
  const int32_t* ph = g.gm + g.phase + r.phase * PHASE_ROW;
  if (r.done || !has_bit(r.present, p) || !ph[0] || r.at(g.L.acted, p) ||
      !pred_eval(g, r, ph[1], p))
    return -1;
  switch (ph[4]) {
    case K_TARGET: return popc(alive);
    case K_OPTION: return ph[5] > 0 ? ph[5] : popc(r.present);
    case K_SUBMIT: return 1;
    default: return 0;
  }
}

// Candidate j (from 0, in ascending order) of a decision in `phase`.
template <int NW>
GE_HD int32_t candidate(const Game& g, int32_t phase, const Seats<NW>& alive, int j) {
  const int kind = g.gm[g.phase + phase * PHASE_ROW + 4];
  if (kind == K_TARGET) return nth_set_bit(alive, j) + 1;
  return kind == K_SUBMIT ? 1 : j + 1;
}

// The first strictly greatest of n totals (ascending candidates: ties go to
// the lowest choice, the C++ argmax).
GE_HD int first_best(const int64_t* totals, int n) {
  int best = 0;
  for (int j = 1; j < n; ++j)
    if (totals[j] > totals[best]) best = j;
  return best;
}

// *at += v, returning the old value: one atomic add on the device.
GE_HD unsigned long long fetch_add(unsigned long long* at, unsigned long long v) {
#ifdef __CUDA_ARCH__
  return atomicAdd(at, v);
#else
  const unsigned long long old = *at;
  *at += v;
  return old;
#endif
}

// The decisions of a call over B rooms, decision d = room * P + seat: its
// candidates cnt[d] (seat_candidates), the room's alive seats (SW words a
// room), and
// totals[d * C + j] for candidate j (C: the most candidates a seat of the
// game can have). A decision with rollouts claims a run of the flat rollout
// index and an entry: entry e's run starts at starts[e], for decision
// decision[e]; *claim counts the entries (above CLAIM_SHIFT) and the
// rollouts claimed. One add to *claim takes both, so the runs follow in
// entry order whatever the order of the claims, and no pass over the
// decisions is needed to sum them. stats: {waiting seats, candidates
// searched, rollouts}.
constexpr int CLAIM_SHIFT = 40;
constexpr unsigned long long CLAIM_ROLLOUTS = (1ull << CLAIM_SHIFT) - 1;

struct DecideTable {
  int32_t* cnt;
  int32_t* alive;
  int64_t* totals;
  int64_t* starts;
  int64_t* decision;
  unsigned long long* claim;
  unsigned long long* stats;
  int C;
};

// Stage 1 for room i on a group: every seat's candidates, its action when it
// needs no rollout (1 for a submit, the one candidate, 0 for none), the
// room's alive seats, and a claim for each decision with a choice.
template <int NW>
GE_HD void decide_room(const Game& g, const MinorState& m, int64_t B, const DecideTable& tab,
                       int rollouts, int32_t* actions, int32_t* w, int stride, int lane,
                       uint32_t mask, int shift, int64_t i) {
  const Room<NW> r = room_fetch<NW>(g, m, w, stride, lane, mask, shift, i, B);
  const auto alive = alive_mask(g, r);
  GE_EACH_SEAT(g, r, p) {
    const int64_t d = i * g.P + p;
    const int n = seat_candidates(g, r, p, alive);
    tab.cnt[d] = n;
    actions[d] = n == 1 ? candidate(g, r.phase, alive, 0) : 0;
    if (n >= 2) {
      fetch_add(tab.stats + 1, (unsigned long long)n);
      const unsigned long long old =
          fetch_add(tab.claim, (1ull << CLAIM_SHIFT) + (unsigned long long)n * rollouts);
      tab.starts[old >> CLAIM_SHIFT] = (int64_t)(old & CLAIM_ROLLOUTS);
      tab.decision[old >> CLAIM_SHIFT] = d;
    }
  }
  const auto waiting = seats_where(g, r, [&](int p) { return tab.cnt[i * g.P + p] >= 0; });
  if (lane == 0) {
    GE_UNROLL
    for (int j = 0; j < NW; ++j)
      if (j < g.SW) tab.alive[i * g.SW + j] = (int32_t)alive.w[j];
    if (any(waiting)) fetch_add(tab.stats, (unsigned long long)popc(waiting));
  }
}

// The entry of flat rollout x among n entries: the last e with starts[e] <= x.
GE_HD int64_t entry_of(const int64_t* starts, int64_t n, int64_t x) {
  int64_t lo = 0, hi = n;  // the first e with starts[e] > x
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (starts[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo - 1;
}

// Stage 2, flat rollout x of n_entries claims on a group: rollout k of
// candidate j of the entry's decision d, in that order (the k of one
// candidate are consecutive, as in a request table). Returns its score;
// *slot receives its total's index.
template <int NW>
GE_HD int32_t decide_rollout(const Game& g, const MinorState& m, int64_t B,
                             const DecideTable& tab, int64_t n_entries, const SearchSpec& s,
                             uint32_t salt, int64_t x, int32_t* w, int stride, int lane,
                             uint32_t mask, int shift, int64_t* slot) {
  const int64_t e = entry_of(tab.starts, n_entries, x), d = tab.decision[e];
  const int64_t i = d / g.P, off = x - tab.starts[e];
  const int j = (int)(off / s.rollouts), k = (int)(off % s.rollouts), p = (int)(d % g.P);
  Room<NW> r = room_fetch<NW>(g, m, w, stride, lane, mask, shift, i, B);
  r.seed = search_seed(search_base(r.seed, salt), r.t, k);
  *slot = d * tab.C + j;
  return room_search_rollout(
      g, r, p, candidate(g, r.phase, load_seats<NW>(tab.alive + i * g.SW, g.SW), j), s);
}

// Stage 3 for decision d of room i: the candidate of the first strictly
// greatest total, where rollouts decided.
template <int NW>
GE_HD void decide_argmax(const Game& g, const MinorState& m, const DecideTable& tab,
                         int32_t* actions, int64_t d) {
  const int32_t n = tab.cnt[d];
  if (n < 2) return;
  const int64_t i = d / g.P;
  const int j = first_best(tab.totals + d * tab.C, n);
  actions[d] = candidate(g, m.scal[i], load_seats<NW>(tab.alive + i * g.SW, g.SW), j);
}

}  // namespace ge
