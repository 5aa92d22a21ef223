// room_step.cuh — one room of the batched engine, for one CUDA thread (or one
// iteration of the host harness's loop): scripted bots, the engine step
// (P1..P5), the on-enter effect-IR interpreter (P20) and auto-reset.
//
// The game is interpreted from the packed table blob of
// game_engine_tpu/native/pack.py, preceded by a directory of section offsets
// (core/rollout_kernel.py builds it), so one build serves every game. The
// semantics are the batched engine's (game_engine_tpu/core/step.py and
// engine.make_rollout): every per-player quantity runs over all P seats with
// the `present` mask, exactly as the plain-torch step does, and the result
// is bit-identical to it. Integer rules (SEMANTICS.md P20): effect-IR
// arithmetic wraps as int32 (computed in uint32, cast back); hashing is
// uint32 splitmix32; int8 banks store the low byte of what is written.
//
// GE_HD marks functions compiled for both the device (nvcc) and the host
// harness (g++, csrc/rollout_host.cpp).
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define GE_HD __host__ __device__ inline
#else
#define GE_HD inline
#endif

namespace ge {

// compile-time bounds of the per-thread arrays; core/rollout_kernel.py reads
// them through ge_limits() and refuses games beyond them
constexpr int MAX_P = 16;
constexpr int MAX_NB = 16;
constexpr int MAX_NN = 16;
constexpr int MAX_NS = 8;
constexpr int MAX_NPD = 4;
constexpr int MAX_NOD = 4;
constexpr int MAX_NODES = 128;   // effect-IR nodes in one block
constexpr int COND_STACK = 16;   // nodes in one branch-condition tree
constexpr int N_LIMITS = 8;

// directory prepended to the blob: dir[sid] = offset of section sid's data
// in the game array, dir[DIR_LEN + sid] = its length
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
// effect-IR codes (gamespec/effects.py)
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

constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr uint32_t MIX = 0x85EBCA6Bu;

GE_HD void limits(int32_t* out) {
  out[0] = MAX_P; out[1] = MAX_NB; out[2] = MAX_NN; out[3] = MAX_NS;
  out[4] = MAX_NPD; out[5] = MAX_NOD; out[6] = MAX_NODES; out[7] = COND_STACK;
}

GE_HD uint32_t splitmix32(uint32_t x) {
  x += GOLDEN;
  uint32_t z = x;
  z = (z ^ (z >> 16)) * 0x85EBCA6Bu;
  z = (z ^ (z >> 13)) * 0xC2B2AE35u;
  return z ^ (z >> 16);
}

GE_HD int32_t wrap_add(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }
GE_HD int32_t wrap_sub(int32_t a, int32_t b) { return (int32_t)((uint32_t)a - (uint32_t)b); }
GE_HD int32_t wrap_mul(int32_t a, int32_t b) { return (int32_t)((uint32_t)a * (uint32_t)b); }

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

// bit idx_plus1 of the 64-bit phase mask (lo, hi): phase-set membership of a
// dense phase index, -1 included
GE_HD bool mask64_has(int32_t lo, int32_t hi, int idx_plus1) {
  uint64_t bits = (uint64_t)(uint32_t)lo | ((uint64_t)(uint32_t)hi << 32);
  return idx_plus1 >= 0 && idx_plus1 < 64 && ((bits >> idx_plus1) & 1);
}

// A view of the game array (directory + pack.py blob).
struct Game {
  int P, NP, NB, NN, NS, NPD, NOD;  // NPD/NOD: the state's (>= 1) widths
  int alive_slot, start_index, maxv, n_mechs;
  const int32_t *atoms, *pred_off, *term_off, *lits, *phase, *rec_true,
      *rec_false, *pdtrans, *conds, *branch_off, *branches, *mechs, *pool,
      *defaults;
};

GE_HD Game game_view(const int32_t* gm) {
  Game g;
  const int32_t* h = gm + gm[SEC_HEADER];
  g.P = h[0]; g.NP = h[1]; g.NB = h[2]; g.NN = h[3]; g.NS = h[4];
  g.NPD = h[5] > 1 ? h[5] : 1;
  g.NOD = h[6] > 1 ? h[6] : 1;
  g.alive_slot = h[7]; g.start_index = h[8]; g.maxv = h[12];
  g.atoms = gm + gm[SEC_ATOMS];
  g.pred_off = gm + gm[SEC_PRED_OFF];
  g.term_off = gm + gm[SEC_TERM_OFF];
  g.lits = gm + gm[SEC_LITS];
  g.phase = gm + gm[SEC_PHASE];
  g.rec_true = gm + gm[SEC_RECTRUE];
  g.rec_false = gm + gm[SEC_RECFALSE];
  g.pdtrans = gm + gm[SEC_PDTRANS];
  g.conds = gm + gm[SEC_CONDS];
  g.branch_off = gm + gm[SEC_BRANCH_OFF];
  g.branches = gm + gm[SEC_BRANCHES];
  g.mechs = gm + gm[SEC_MECHS];
  g.n_mechs = gm[DIR_LEN + SEC_MECHS] / MECH_ROW;
  g.pool = gm + gm[SEC_POOL];
  g.defaults = gm + gm[SEC_DEFAULTS];
  return g;
}

// One room's state, in per-thread arrays (player-major within each bank).
struct Room {
  int8_t bools[MAX_P * MAX_NB];          // [p * NB + b], 0/1
  int32_t nums[MAX_P * MAX_NN];          // [p * NN + b]
  int8_t strs[MAX_P * MAX_NS];           // [p * NS + b]
  int8_t pdict[MAX_P * MAX_NPD * MAX_P]; // [(p * NPD + f) * P + q]
  int8_t odict[MAX_P * MAX_NOD];         // [p * NOD + s]
  int8_t present[MAX_P], acted[MAX_P];
  int32_t choice[MAX_P], choice_phase[MAX_P];
  int32_t phase, prev, done, winner, t;
  uint32_t seed;
};

// Global state in the (bank, P, rooms) int32 layout of
// core/rollout_kernel.to_minor: one field of consecutive rooms is contiguous.
struct MinorState {
  int32_t *bools, *nums, *strs, *pdict, *odict, *present, *regs, *scal;
};

GE_HD void room_load(const Game& g, Room& r, const MinorState& m, int64_t i, int64_t B) {
  const int P = g.P;
  for (int b = 0; b < g.NB; ++b)
    for (int p = 0; p < P; ++p) r.bools[p * g.NB + b] = (int8_t)(m.bools[((int64_t)b * P + p) * B + i] != 0);
  for (int b = 0; b < g.NN; ++b)
    for (int p = 0; p < P; ++p) r.nums[p * g.NN + b] = m.nums[((int64_t)b * P + p) * B + i];
  for (int b = 0; b < g.NS; ++b)
    for (int p = 0; p < P; ++p) r.strs[p * g.NS + b] = (int8_t)m.strs[((int64_t)b * P + p) * B + i];
  for (int f = 0; f < g.NPD; ++f)
    for (int p = 0; p < P; ++p)
      for (int q = 0; q < P; ++q)
        r.pdict[(p * g.NPD + f) * P + q] = (int8_t)m.pdict[(((int64_t)f * P + p) * P + q) * B + i];
  for (int s = 0; s < g.NOD; ++s)
    for (int p = 0; p < P; ++p) r.odict[p * g.NOD + s] = (int8_t)m.odict[((int64_t)s * P + p) * B + i];
  for (int p = 0; p < P; ++p) {
    r.present[p] = (int8_t)(m.present[(int64_t)p * B + i] != 0);
    r.acted[p] = (int8_t)(m.regs[(int64_t)p * B + i] != 0);
    r.choice[p] = m.regs[((int64_t)P + p) * B + i];
    r.choice_phase[p] = m.regs[((int64_t)2 * P + p) * B + i];
  }
  r.phase = m.scal[i];
  r.prev = m.scal[B + i];
  r.done = m.scal[2 * B + i] != 0;
  r.winner = m.scal[3 * B + i];
  r.t = m.scal[4 * B + i];
  r.seed = (uint32_t)m.scal[5 * B + i];
}

GE_HD void room_store(const Game& g, const Room& r, const MinorState& m, int64_t i, int64_t B) {
  const int P = g.P;
  for (int b = 0; b < g.NB; ++b)
    for (int p = 0; p < P; ++p) m.bools[((int64_t)b * P + p) * B + i] = r.bools[p * g.NB + b];
  for (int b = 0; b < g.NN; ++b)
    for (int p = 0; p < P; ++p) m.nums[((int64_t)b * P + p) * B + i] = r.nums[p * g.NN + b];
  for (int b = 0; b < g.NS; ++b)
    for (int p = 0; p < P; ++p) m.strs[((int64_t)b * P + p) * B + i] = r.strs[p * g.NS + b];
  for (int f = 0; f < g.NPD; ++f)
    for (int p = 0; p < P; ++p)
      for (int q = 0; q < P; ++q)
        m.pdict[(((int64_t)f * P + p) * P + q) * B + i] = r.pdict[(p * g.NPD + f) * P + q];
  for (int s = 0; s < g.NOD; ++s)
    for (int p = 0; p < P; ++p) m.odict[((int64_t)s * P + p) * B + i] = r.odict[p * g.NOD + s];
  for (int p = 0; p < P; ++p) {
    m.present[(int64_t)p * B + i] = r.present[p];
    m.regs[(int64_t)p * B + i] = r.acted[p];
    m.regs[((int64_t)P + p) * B + i] = r.choice[p];
    m.regs[((int64_t)2 * P + p) * B + i] = r.choice_phase[p];
  }
  m.scal[i] = r.phase;
  m.scal[B + i] = r.prev;
  m.scal[2 * B + i] = r.done;
  m.scal[3 * B + i] = r.winner;
  m.scal[4 * B + i] = r.t;
  m.scal[5 * B + i] = (int32_t)r.seed;
}

// -- predicates -------------------------------------------------------------

// atom `field <op> const` for seat p over the given banks
GE_HD bool atom_eval(const Game& g, const int8_t* sb, const int32_t* sn,
                     const int8_t* ss, int ai, int p) {
  const int32_t* a = g.atoms + ai * 5;
  if (a[0] == AB_CONST) return a[4] == 1;
  int32_t x = a[0] == AB_BOOL ? (int32_t)sb[p * g.NB + a[1]]
            : a[0] == AB_NUM ? sn[p * g.NN + a[1]]
                             : (int32_t)ss[p * g.NS + a[1]];
  return compare(a[2], x, a[3]);
}

// DNF predicate: no terms = false; an empty term = true
GE_HD bool pred_eval(const Game& g, const int8_t* sb, const int32_t* sn,
                     const int8_t* ss, int pi, int p) {
  for (int t = g.pred_off[pi]; t < g.pred_off[pi + 1]; ++t) {
    bool ok = true;
    for (int l = g.term_off[t]; l < g.term_off[t + 1] && ok; ++l)
      ok = atom_eval(g, sb, sn, ss, g.lits[l], p);
    if (ok) return true;
  }
  return false;
}

GE_HD int n_present(const Game& g, const Room& r) {
  int n = 0;
  for (int p = 0; p < g.P; ++p) n += r.present[p];
  return n;
}

// is_alive if declared, else present (live banks)
GE_HD bool alive_at(const Game& g, const Room& r, int q) {
  return r.present[q] && (g.alive_slot < 0 || r.bools[q * g.NB + g.alive_slot]);
}

// present players satisfying predicate pi (live banks)
GE_HD int count_pred(const Game& g, const Room& r, int pi) {
  int c = 0;
  for (int p = 0; p < g.P; ++p)
    c += r.present[p] && pred_eval(g, r.bools, r.nums, r.strs, pi, p);
  return c;
}

// Room-level branch condition. An AND is the conjunction of its children,
// so the tree is walked with an explicit stack (no device recursion); the
// host checks that every tree fits in COND_STACK.
GE_HD bool cond_eval(const Game& g, const Room& r, int root) {
  int stack[COND_STACK];
  int sp = 0;
  stack[sp++] = root;
  while (sp > 0) {
    const int32_t* c = g.conds + stack[--sp] * 5;
    switch (c[0]) {
      case COND_ALWAYS: break;
      case COND_COUNTCMP: {
        int lhs = count_pred(g, r, c[1]);
        int rhs = c[3] >= 0 ? count_pred(g, r, c[3]) : c[4];
        if (!compare(c[2], lhs, rhs)) return false;
        break;
      }
      case COND_ALLPRESENT:
        if (count_pred(g, r, c[1]) != n_present(g, r)) return false;
        break;
      case COND_PREVIN:
        if (!mask64_has(c[1], c[2], r.prev + 1)) return false;
        break;
      case COND_AND:
        for (int k = 0; k < c[2] && sp < COND_STACK; ++k) stack[sp++] = g.pool[c[1] + k];
        break;
      default: return false;
    }
  }
  return true;
}

// -- on-enter effect programs (P20) ------------------------------------------

// One MECH_EFFECTS program: per block, every node reads the block-entry
// snapshot; statements write the live room in declared order.
GE_HD void run_effects(const Game& g, Room& r, const int32_t* q) {
  const int P = g.P;
  int off = q[0];
  const int n_blocks = q[1], rv_off = q[2], rv_n = q[3];
  int8_t sb[MAX_P * MAX_NB], ss[MAX_P * MAX_NS];
  int32_t sn[MAX_P * MAX_NN];
  int32_t vals[MAX_NODES * MAX_P];  // vals[k * P + p]: node k at seat p
  const int np = n_present(g, r);
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int n_nodes = g.pool[off], n_stmts = g.pool[off + 1];
    const int32_t* nodes = g.pool + off + 2;
    const int32_t* stmts = nodes + n_nodes * 4;
    off += 2 + n_nodes * 4 + n_stmts * 6;
    for (int x = 0; x < P * g.NB; ++x) sb[x] = r.bools[x];
    for (int x = 0; x < P * g.NN; ++x) sn[x] = r.nums[x];
    for (int x = 0; x < P * g.NS; ++x) ss[x] = r.strs[x];

    for (int k = 0; k < n_nodes; ++k) {
      const int32_t* nd = nodes + k * 4;
      const int kind = nd[0], a = nd[1], b = nd[2], c = nd[3];
      int32_t* out = vals + k * P;
      // operand rows, formed only where a/b/c name nodes
      auto va = [&](int p) { return vals[a * P + p]; };
      auto vb = [&](int p) { return vals[b * P + p]; };
      auto vc = [&](int p) { return vals[c * P + p]; };
      switch (kind) {
        case NK_CONST: for (int p = 0; p < P; ++p) out[p] = a; break;
        case NK_FIELD:
          for (int p = 0; p < P; ++p)
            out[p] = a == FXB_BOOL ? (int32_t)sb[p * g.NB + b]
                   : a == FXB_NUM ? sn[p * g.NN + b] : (int32_t)ss[p * g.NS + b];
          break;
        case NK_SEAT: for (int p = 0; p < P; ++p) out[p] = p + 1; break;
        case NK_NPLAYERS: for (int p = 0; p < P; ++p) out[p] = np; break;
        case NK_CHOICE: for (int p = 0; p < P; ++p) out[p] = r.choice[p]; break;
        case NK_CHOSEIN:
          for (int p = 0; p < P; ++p) out[p] = mask64_has(a, b, r.choice_phase[p] + 1);
          break;
        case NK_ALIVE:
          for (int p = 0; p < P; ++p)
            out[p] = r.present[p] && (g.alive_slot < 0 || sb[p * g.NB + g.alive_slot]);
          break;
        case NK_PRESENT: for (int p = 0; p < P; ++p) out[p] = r.present[p]; break;
        case NK_PRED:
          for (int p = 0; p < P; ++p) out[p] = pred_eval(g, sb, sn, ss, a, p);
          break;
        case NK_BIN:
          for (int p = 0; p < P; ++p) {
            int32_t x = vb(p), y = vc(p);
            out[p] = a == BIN_ADD ? wrap_add(x, y) : a == BIN_SUB ? wrap_sub(x, y)
                   : a == BIN_MUL ? wrap_mul(x, y) : a == BIN_MIN ? (x < y ? x : y)
                   : (x > y ? x : y);
          }
          break;
        case NK_CMP: for (int p = 0; p < P; ++p) out[p] = compare(a, vb(p), vc(p)); break;
        case NK_NOT: for (int p = 0; p < P; ++p) out[p] = va(p) == 0; break;
        case NK_AND: for (int p = 0; p < P; ++p) out[p] = va(p) != 0 && vb(p) != 0; break;
        case NK_OR: for (int p = 0; p < P; ++p) out[p] = va(p) != 0 || vb(p) != 0; break;
        case NK_WHERE: for (int p = 0; p < P; ++p) out[p] = va(p) != 0 ? vb(p) : vc(p); break;
        case NK_AT:  // val[idx-1] if idx names a present seat, else 0
          for (int p = 0; p < P; ++p) {
            int32_t i = vb(p);
            out[p] = (i >= 1 && i <= P && r.present[i - 1]) ? va(i - 1) : 0;
          }
          break;
        case NK_INCOMING:  // sum of val over masked seats whose key names p
          for (int p = 0; p < P; ++p) {
            uint32_t s = 0;
            for (int j = 0; j < P; ++j)
              if (vc(j) != 0 && r.present[j] && vb(j) == p + 1) s += (uint32_t)va(j);
            out[p] = (int32_t)s;
          }
          break;
        case NK_EQCOUNT:
        case NK_RANK:  // masked seats (all / earlier) with an equal key
          for (int p = 0; p < P; ++p) {
            int32_t s = 0;
            const int hi = kind == NK_RANK ? p : P;
            for (int j = 0; j < hi; ++j)
              s += vb(j) != 0 && r.present[j] && va(j) == va(p);
            out[p] = s;
          }
          break;
        case NK_REDUCE: {  // room-level; empty max/min is 0
          int32_t acc = 0;
          bool any = false;
          for (int j = 0; j < P; ++j) {
            if (vc(j) == 0 || !r.present[j]) continue;
            int32_t v = vb(j);
            if (a == RED_COUNT) acc += 1;
            else if (a == RED_SUM) acc = wrap_add(acc, v);
            else if (!any) acc = v;
            else if (a == RED_MAX) acc = v > acc ? v : acc;
            else acc = v < acc ? v : acc;
            any = true;
          }
          for (int p = 0; p < P; ++p) out[p] = acc;
          break;
        }
        case NK_ARGBEST: {  // ties resolve to the lowest seat; empty is 0
          int32_t best = 0, win = 0;
          for (int j = 0; j < P; ++j) {
            if (vc(j) == 0 || !r.present[j]) continue;
            int32_t v = vb(j);
            if (win == 0 || (a == ARG_MAX ? v > best : v < best)) { best = v; win = j + 1; }
          }
          for (int p = 0; p < P; ++p) out[p] = win;
          break;
        }
        default: break;
      }
    }

    for (int si = 0; si < n_stmts; ++si) {
      const int32_t* st = stmts + si * 6;
      const int skind = st[0], bank = st[1], slot = st[2];
      auto vv = [&](int p) { return vals[st[3] * P + p]; };
      auto vw = [&](int p) { return vals[st[4] * P + p]; };
      auto vk = [&](int p) { return vals[st[5] * P + p]; };
      if (skind == ST_OVER) {  // P11/P17: trigger and winner from seat 1
        if (vw(0) != 0 && r.present[0]) { r.done = 1; r.winner = vv(0); }
        continue;
      }
      if (skind == ST_DEAL) {
        // P10: rank every seat by splitmix32 key (absent seats last); st[3]
        // is the pool offset of the (P+1, P) multiset table, st[5] the salt
        uint32_t keys[MAX_P];
        for (int p = 0; p < P; ++p)
          keys[p] = r.present[p] ? splitmix32(r.seed * 0x100u + (uint32_t)p
                                              + (uint32_t)vk(p) * GOLDEN)
                                 : 0xFFFFFFFFu;
        for (int p = 0; p < P; ++p) {
          if (vw(p) == 0 || !r.present[p]) continue;
          int rank = 0;
          for (int j = 0; j < P; ++j)
            rank += keys[j] < keys[p] || (keys[j] == keys[p] && j < p);
          r.strs[p * g.NS + slot] = (int8_t)g.pool[st[3] + np * P + rank];
        }
        continue;
      }
      for (int p = 0; p < P; ++p) {
        if (vw(p) == 0 || !r.present[p]) continue;
        switch (skind) {
          case ST_KILL:  // P15: clear is_alive, then set the reveal flags
            if (g.alive_slot >= 0) r.bools[p * g.NB + g.alive_slot] = 0;
            for (int k = 0; k < rv_n; ++k) r.bools[p * g.NB + g.pool[rv_off + k]] = 1;
            break;
          case ST_SET:
            if (bank == FXB_BOOL) r.bools[p * g.NB + slot] = vv(p) != 0;
            else if (bank == FXB_STR) r.strs[p * g.NS + slot] = (int8_t)vv(p);
            else r.nums[p * g.NN + slot] = vv(p);
            break;
          case ST_ADD:
            r.nums[p * g.NN + slot] = wrap_add(r.nums[p * g.NN + slot], vv(p));
            break;
          case ST_RESET:  // dict banks clear to empty
            if (bank == FXB_ODICT) r.odict[p * g.NOD + slot] = 0;
            else for (int j = 0; j < P; ++j) r.pdict[(p * g.NPD + slot) * P + j] = 0;
            break;
          case ST_SETD: {  // pdict[key] = val; a key naming no present seat is a no-op
            int32_t k = vk(p);
            if (k >= 1 && k <= P && r.present[k - 1])
              r.pdict[(p * g.NPD + slot) * P + (k - 1)] = (int8_t)vv(p);
            break;
          }
          default: break;
        }
      }
    }
  }
}

// Every mechanic of the room's (just entered) phase, in declared order.
GE_HD void apply_on_enter(const Game& g, Room& r) {
  for (int mi = 0; mi < g.n_mechs; ++mi) {
    const int32_t* m = g.mechs + mi * MECH_ROW;
    if (m[0] == MECH_EFFECTS && m[1] == r.phase) run_effects(g, r, m + 2);
  }
}

// -- bots, step, reset --------------------------------------------------------

// Scripted bots (engine.scripted_actions): one splitmix32 stream per
// (seed, t, seat); every present seat emits, acceptance filters.
GE_HD void room_policy(const Game& g, const Room& r, int32_t* out) {
  const int P = g.P;
  const int32_t* ph = g.phase + r.phase * PHASE_ROW;
  const int kind = ph[4], kmax = ph[5];
  const uint32_t h0 = splitmix32(r.seed * MIX + (uint32_t)r.t);
  int n_alive = 0;
  for (int q = 0; q < P; ++q) n_alive += alive_at(g, r, q);
  const int np = n_present(g, r);
  for (int p = 0; p < P; ++p) {
    const uint32_t h = splitmix32(h0 ^ ((uint32_t)(p + 1) * GOLDEN));
    int32_t c = 0;
    if (kind == K_TARGET) {  // the k-th alive seat, k = h % n_alive
      if (n_alive > 0) {
        const int k = (int)(h % (uint32_t)n_alive);
        for (int q = 0, seen = 0; q < P; ++q) {
          if (!alive_at(g, r, q)) continue;
          if (seen++ == k) { c = q + 1; break; }
        }
      }
    } else if (kind == K_OPTION) {
      const uint32_t hi = (uint32_t)(kmax > 0 ? kmax : np);
      c = 1 + (int32_t)(h % (hi > 0 ? hi : 1u));
    } else if (kind == K_SUBMIT) {
      c = 1;
    }
    out[p] = r.present[p] ? c : 0;
  }
}

// One engine step (core/step.py make_step): P1/P2 acceptance against the
// pre-step state, record writes, P3 completion, P4/P5 first-match branch,
// transition and on-enter mechanics. t counts every step, done or not.
GE_HD void room_step(const Game& g, Room& r, const int32_t* act) {
  const int P = g.P;
  const int i = r.phase;
  const int32_t* ph = g.phase + i * PHASE_ROW;
  const bool is_action = ph[0] != 0;
  const int tpred = ph[1], kind = ph[4], kmax = ph[5];
  const int rec_num = ph[6], rec_pd = ph[7], pd_src = ph[8], rec_od = ph[9];
  const int np = n_present(g, r);

  bool targeted[MAX_P], accept[MAX_P];
  int32_t c_norm[MAX_P], pd_val[MAX_P];
  for (int p = 0; p < P; ++p) {
    const int32_t c = act[p];
    targeted[p] = r.present[p] && pred_eval(g, r.bools, r.nums, r.strs, tpred, p);
    const bool in_players = c >= 1 && c <= P;
    bool legal;
    if (kind == K_TARGET) legal = in_players && alive_at(g, r, c - 1);
    else if (kind == K_OPTION) legal = c >= 1 && c <= (kmax > 0 ? kmax : np);
    else legal = kind == K_SUBMIT;
    accept[p] = is_action && !r.done && targeted[p] && !r.acted[p] && c != 0 && legal;
    c_norm[p] = kind == K_SUBMIT ? 1 : c;
    // pdict record: the target's source-string code, translated
    int32_t src = (in_players && pd_src >= 0 && pd_src < g.NS)
                      ? (int32_t)r.strs[(c - 1) * g.NS + pd_src] : 0;
    int32_t tr = (src >= 0 && src < g.maxv) ? g.pdtrans[i * g.maxv + src] : 0;
    pd_val[p] = pd_src >= 0 ? tr : 0;
  }
  for (int p = 0; p < P; ++p) {
    if (!accept[p]) continue;
    const int32_t c = act[p];
    for (int b = 0; b < g.NB; ++b) {
      if (g.rec_true[i * g.NB + b]) r.bools[p * g.NB + b] = 1;
      if (g.rec_false[i * g.NB + b]) r.bools[p * g.NB + b] = 0;
    }
    if (rec_num >= 0 && rec_num < g.NN) r.nums[p * g.NN + rec_num] = c_norm[p];
    if (rec_pd >= 0 && rec_pd < g.NPD && c >= 1 && c <= P)
      r.pdict[(p * g.NPD + rec_pd) * P + (c - 1)] = (int8_t)pd_val[p];
    if (rec_od >= 0 && rec_od < g.NOD) r.odict[p * g.NOD + rec_od] = 1;
    r.acted[p] = 1;
    r.choice[p] = c_norm[p];
    r.choice_phase[p] = i;
  }

  bool complete = !r.done;
  if (is_action)
    for (int p = 0; p < P; ++p)
      if (targeted[p] && !r.acted[p]) complete = false;
  int next = ph[3];
  const int b0 = g.branch_off[i], b1 = g.branch_off[i + 1];
  if (b1 > b0) {
    next = g.branches[(b1 - 1) * 2 + 1];  // P5 fallback: the last branch
    for (int b = b0; b < b1; ++b)
      if (cond_eval(g, r, g.branches[b * 2])) { next = g.branches[b * 2 + 1]; break; }
  }
  r.t += 1;
  if (complete && next != i) {
    r.prev = i;
    r.phase = next;
    for (int p = 0; p < P; ++p) r.acted[p] = 0;
    apply_on_enter(g, r);
  }
}

// A fresh room of n seats (init_state): defaults, start phase, on-enter.
GE_HD void room_init(const Game& g, Room& r, int n, uint32_t seed) {
  const int P = g.P;
  for (int p = 0; p < P; ++p) {
    for (int b = 0; b < g.NB; ++b) r.bools[p * g.NB + b] = g.defaults[b] != 0;
    for (int b = 0; b < g.NN; ++b) r.nums[p * g.NN + b] = g.defaults[g.NB + b];
    for (int b = 0; b < g.NS; ++b) r.strs[p * g.NS + b] = (int8_t)g.defaults[g.NB + g.NN + b];
    for (int x = 0; x < g.NPD * P; ++x) r.pdict[p * g.NPD * P + x] = 0;
    for (int s = 0; s < g.NOD; ++s) r.odict[p * g.NOD + s] = 0;
    r.present[p] = p < n;
    r.acted[p] = 0;
    r.choice[p] = 0;
    r.choice_phase[p] = -1;
  }
  r.phase = g.start_index;
  r.prev = -1;
  r.done = 0;
  r.winner = 0;
  r.t = 0;
  r.seed = seed;
  apply_on_enter(g, r);
}

// num_steps of bots -> step -> fresh-completion count -> auto-reset
// (engine.make_rollout). Returns the episodes completed.
GE_HD int32_t room_rollout(const Game& g, Room& r, int num_steps, int auto_reset) {
  int32_t episodes = 0;
  int32_t act[MAX_P];
  for (int s = 0; s < num_steps; ++s) {
    room_policy(g, r, act);
    const int32_t done_in = r.done;
    room_step(g, r, act);
    episodes += r.done && !done_in;  // a room born done is not recounted
    if (auto_reset && r.done) room_init(g, r, n_present(g, r), splitmix32(r.seed ^ 0xDECAF000u));
  }
  return episodes;
}

}  // namespace ge
