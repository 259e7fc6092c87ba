// K9's body: the pseudo-legal moves of one lane, ordered, as a warp-
// cooperative device function (ops/movegen.py generate_moves_plain).
//
// The plain version fills ~4,962 fixed candidate slots and sorts them all:
// the TPU's answer to fixed shapes. Here the warp enumerates the moves
// themselves into a list in shared memory and sorts only those, in three
// passes. Each move is packed as (key << 16) | move with the plain
// version's key; the packed values of a position are distinct (the one
// tie, a castling right without its rook that a king step repeats, gives
// equal words), so their ascending order is the plain version's stable
// sort, bit for bit.
//
// (a) Enumerate, with the static keys and no load of the history. The
// side's pieces are cut into work units, one kind at a time so a round's
// threads run the same code: a knight's or king's targets one a unit, a
// pawn's double push, push and two captures (with their promotions), a
// slider's rays. Units go a thread each, so no thread walks more than one
// ray; a thread loads its ray's squares and targets at once and tests
// them, and a ballot or a prefix count over the warp places every
// thread's moves (no atomics). The noisy prefix is counted here: the keys
// below NOISY_BELOW are the static capture keys, and the history and
// killer keys never fall below it. (b) Set the keys: a slot a thread,
// each slot's history word loaded with the others in flight, the plain
// version's history and killer rules applied. (c) Sort the packed values: up to 64
// moves a bitonic sort in registers, one or two values a thread, by
// shuffles; longer lists (crazyhouse's drops) sort each 64 in registers,
// then merge with the all-ascending bitonic network in the list's own
// shared array at its length n, skipping each comparator whose partner is
// >= n (every comparator puts the smaller value at the lower index, so the
// virtual +inf tail never moves).
//
// The variant is a template parameter V, as in board.cuh: horde's pawns
// on white's first rank also push two squares, an atomic king never
// captures (its candidate is dropped before it is counted, so the count,
// the noisy prefix and the order are the plain version's), antichess adds
// a fifth promotion (to a king) and makes a capture compulsory — its
// captures (en passant included) are exactly its moves with keys below
// NOISY_BELOW, which sort first, so when any exists the list keeps only
// the first `noisy`. Crazyhouse adds a drop of each type its pocket
// holds on each empty square (a pawn not on the first or last rank),
// keyed DROP_KEY, and keeps MAX_MOVES_ZH moves (max_moves<V>): drops that
// share a key sort by their packed values, as the plain version's sort
// gives.
#pragma once
#include "board.cuh"

namespace rules {

// Room for every move of any board: at most 64 * 64 / 4 = 1,024 moves
// from an own piece to a square that is empty or the opponent's (k own
// pieces reach at most 64 - k squares each), the 72 promotion variants
// beyond the first of 24 pawn moves (96 in antichess, which promotes to
// five pieces), 2 castling moves and 2 en-passant captures onto an own
// piece that the plain version's en-passant test also admits: 1,024 + 96
// + 2 + 2 = 1,124 at most.
constexpr int MOVE_LIST_CAP = 1152;
// Crazyhouse's drops add at most 5 types x 64 squares = 320: 1,124 + 320 =
// 1,444 at most. The board's geometry alone does not keep them inside
// MOVE_LIST_CAP (k own pieces and e empty squares allow k (64 - k) board
// moves and 5e drops: 1,185 with k = 29 and e = 34, before promotions), so
// crazyhouse's list is wider, in its instantiations only.
constexpr int MOVE_LIST_CAP_ZH = 1472;

template <int V>
__host__ __device__ constexpr int move_list_cap() {
    return V == VARIANT_CRAZYHOUSE ? MOVE_LIST_CAP_ZH : MOVE_LIST_CAP;
}
// The width of a variant's ordered move list (ops/movegen.py max_moves_for).
template <int V>
__host__ __device__ constexpr int max_moves() {
    return V == VARIANT_CRAZYHOUSE ? MAX_MOVES_ZH : MAX_MOVES;
}
static_assert(MAX_MOVES_ZH <= MOVE_LIST_CAP_ZH && MAX_MOVES <= MOVE_LIST_CAP, "move lists");

template <int Size>
struct MoveListOf {
    static constexpr int kCap = Size;
    int packed[Size];
};
template <int V>
using MoveList = MoveListOf<move_list_cap<V>()>;

// Only the static capture keys are noisy: the history, killer and drop
// keys a pass (b) sets never fall below NOISY_BELOW, so pass (a) counts
// the noisy prefix before the keys are set.
static_assert(HIST_BASE - HIST_MAX_BONUS >= NOISY_BELOW && KILLER_KEY >= NOISY_BELOW
                  && DROP_HIST_BASE - HIST_MAX_BONUS >= NOISY_BELOW && DROP_KEY >= NOISY_BELOW
                  && QUIET_KEY >= NOISY_BELOW && CASTLE_KEY >= NOISY_BELOW,
              "K9: the noisy prefix is the static capture keys");

// The quiet-ordering state of a lane: history counters (4096, nullptr for
// none) and two killer moves (-1 for none: no move encodes as -1). The
// counters are lane state that the segment kernel (K11) updates in the
// same launch, so they are read with plain loads, never through the
// read-only cache (__ldg): only the generated tables go through it.
struct Ordering {
    const int32_t* hist;
    int killer0, killer1;
};

// A move's history bonus: its from|to counter, scaled and clamped.
__device__ __forceinline__ int hist_bonus(const Ordering& o, int move) {
    return min(max(o.hist[move & 4095] >> HIST_SHIFT, 0), HIST_MAX_BONUS);
}

// Pass (b) on one packed value: a quiet key (exactly QUIET_KEY) becomes
// HIST_BASE less its history bonus, and a killer among the keys >=
// NOISY_BELOW KILLER_KEY; a crazyhouse drop DROP_KEY, or DROP_HIST_BASE
// less its bonus (its counter is to << 6 | to's), or KILLER_KEY for a
// killer (the plain version's order of the rules).
template <int V>
__device__ __forceinline__ int ordered(const Ordering& o, int v) {
    const int move = v & 0xFFFF;
    int key = v >> 16;
    const bool killer = move == o.killer0 || move == o.killer1;
    if constexpr (V == VARIANT_CRAZYHOUSE) {
        if (move & DROP_FLAG) {
            key = o.hist != nullptr ? DROP_HIST_BASE - hist_bonus(o, move) : DROP_KEY;
            return ((killer ? KILLER_KEY : key) << 16) | move;
        }
    }
    if (o.hist != nullptr && key == QUIET_KEY) key = HIST_BASE - hist_bonus(o, move);
    if (key >= NOISY_BELOW && killer) key = KILLER_KEY;
    return (key << 16) | move;
}

// The warp's moves so far: n (all appended, also past the list's room)
// and noisy, the same in every thread. Each call appends the threads'
// candidates with ok set, in thread order.
template <class List>
__device__ __forceinline__ void append(List& list, int& n, int& noisy, bool ok, int key, int move,
                                       int t) {
    const unsigned m = __ballot_sync(FULL_MASK, ok);
    if (ok) {
        const int slot = n + __popc(m & ((1u << t) - 1u));
        if (slot < List::kCap) list.packed[slot] = (key << 16) | move;
    }
    noisy += __popc(__ballot_sync(FULL_MASK, ok && key < NOISY_BELOW));
    n += __popc(m);
}

// A thread's batch of candidates: up to N packed values, with a bit set
// in `ok` for each that is a move and in `noisy` for each that is also
// noisy.
template <int N>
struct Batch {
    int packed[N];
    unsigned ok = 0, noisy = 0;
    __device__ __forceinline__ void put(int i, bool valid, int key, int move) {
        packed[i] = (key << 16) | move;
        if (valid) {
            ok |= 1u << i;
            if (key < NOISY_BELOW) noisy |= 1u << i;
        }
    }
};

// Appends every thread's batch, in thread order: one prefix count over the
// warp places each thread's moves.
template <int N, class List>
__device__ __forceinline__ void append_batch(List& list, int& n, int& noisy, const Batch<N>& b,
                                             int t) {
    const int c = __popc(b.ok);
    int incl = c;
    for (int m = 1; m < WARP; m <<= 1) {
        const int y = __shfl_up_sync(FULL_MASK, incl, m);
        if (t >= m) incl += y;
    }
    int slot = n + incl - c;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        if ((b.ok >> i) & 1u) {
            if (slot < List::kCap) list.packed[slot] = b.packed[i];
            ++slot;
        }
    }
    n += __shfl_sync(FULL_MASK, incl, WARP - 1);
    noisy += __reduce_add_sync(FULL_MASK, __popc(b.noisy));
}

__device__ __forceinline__ int pair_key(int mover, int target) {
    return __ldg(&PAIR_KEY[mover * 13 + target]);
}
__device__ __forceinline__ bool pair_take(int mover, int target) {
    return __ldg(&PAIR_TAKE[mover * 13 + target]);
}

// The n-th (from 0) square of a board mask, squares 0-31 in lo and 32-63
// in hi (as two ballots over the warp give it).
__device__ __forceinline__ int nth_square(unsigned lo, unsigned hi, int n) {
    const int below = __popc(lo);
    return n < below ? __fns(lo, 0, n + 1) : WARP + __fns(hi, 0, n - below + 1);
}

// Each work unit of the three kinds below runs on a thread of its own,
// one kind at a time, so the threads of a round run the same code. A
// knight's or king's unit is one of its eight targets.
template <int V, class List>
__device__ void leaper_moves(const int* sb, int us, int t, List& list, int& n, int& noisy) {
    const int knight = W_KNIGHT + 6 * us, king = W_KING + 6 * us;
    const int c0 = sb[t], c1 = sb[t + WARP];
    const unsigned lo = __ballot_sync(FULL_MASK, c0 == knight || c0 == king);
    const unsigned hi = __ballot_sync(FULL_MASK, c1 == knight || c1 == king);
    const int units = 8 * (__popc(lo) + __popc(hi));
    for (int u0 = 0; u0 < units; u0 += WARP) {
        const int u = u0 + t;
        bool ok = false;
        int key = 0, move = 0;
        if (u < units) {
            const int sq = nth_square(lo, hi, u >> 3);
            const int code = sb[sq];
            const int8_t* targets = code == knight ? KNIGHT_TARGETS : KING_TARGETS;
            const int to = __ldg(&targets[sq * 8 + (u & 7)]);
            if (to >= 0) {
                const int target = sb[to];
                ok = pair_take(code, target);
                if constexpr (V == VARIANT_ATOMIC) {  // a king's capture would blow it up
                    ok = ok && !(code == king && target != 0);
                }
                key = pair_key(code, target);
                move = sq | (to << 6);
            }
        }
        append(list, n, noisy, ok, key, move, t);
    }
}

// A pawn's units: its double push, its push, its two captures (en passant
// onto an empty square), each as many times as it promotes.
template <int V, class List>
__device__ void pawn_moves(const int* sb, int us, int ep, int t, List& list, int& n, int& noisy) {
    constexpr int n_promos = V == VARIANT_ANTICHESS ? 5 : 4;
    const int pawn = W_PAWN + 6 * us;
    const unsigned lo = __ballot_sync(FULL_MASK, sb[t] == pawn);
    const unsigned hi = __ballot_sync(FULL_MASK, sb[t + WARP] == pawn);
    const int units = 4 * (__popc(lo) + __popc(hi));
    for (int u0 = 0; u0 < units; u0 += WARP) {
        const int u = u0 + t;
        Batch<n_promos> b;
        if (u < units) {
            const int sq = nth_square(lo, hi, u >> 2), kind = u & 3;
            const int to1 = __ldg(&PAWN_PUSH[(us * 2) * 64 + sq]);
            const bool to1_ok = sb[to1] == 0;
            if (kind == 0) {
                const int to2 = __ldg(&PAWN_PUSH[(us * 2 + 1) * 64 + sq]);
                bool start = __ldg(&PAWN_START[us * 64 + sq]);
                if constexpr (V == VARIANT_HORDE) start = start || (us == 0 && sq < 8);
                b.put(0, to1_ok && start && sb[to2] == 0, QUIET_KEY, sq | (to2 << 6));
            } else {
                int to = to1, key = QUIET_KEY;
                bool ok = to1_ok;
                if (kind > 1) {
                    to = pawn_cap_sq(us, sq, kind - 2);
                    const int target = to >= 0 ? sb[to] : 0;
                    ok = (to >= 0 && pcolor(target) == 1 - us) || (to >= 0 ? to : 64) == ep;
                    key = __ldg(&PAWN_CAP_KEY[target]);
                }
                const int base = sq | (max(to, 0) << 6);
                if (!__ldg(&PAWN_PRE_PROMO[us * 64 + sq])) {
                    b.put(0, ok, key, base);
                } else {
#pragma unroll
                    for (int p = 0; p < n_promos; ++p) {
                        const int promo = p < 4 ? __ldg(&PROMOS[p]) : PROMO_K;
                        b.put(p, ok, key - (promo == PROMO_Q ? QUEEN_PROMO_BONUS : 0),
                              base | (promo << 12));
                    }
                }
            }
        }
        append_batch(list, n, noisy, b, t);
    }
}

// The directions a slider slides along, as a bit mask (0: not the side to
// move's slider).
__device__ __forceinline__ unsigned slider_dirs(int code, int us) {
    unsigned dirs = 0;
    if (code != 0 && pcolor(code) == us) {
#pragma unroll
        for (int d = 0; d < 8; ++d) dirs |= (unsigned)slides(code, d) << d;
    }
    return dirs;
}

// A slider's units: its rays, each up to and including its first piece,
// every square and target loaded before any is tested. A prefix count
// over the warp numbers the rays, and each round a thread takes the ray
// of its index, found by a binary search over the threads' first rays.
template <class List>
__device__ void slider_moves(const int* sb, int us, int t, List& list, int& n, int& noisy) {
    const unsigned d0 = slider_dirs(sb[t], us), d1 = slider_dirs(sb[t + WARP], us);
    const int n0 = __popc(d0), n1 = __popc(d1);
    int incl = n0 + n1;
    for (int m = 1; m < WARP; m <<= 1) {
        const int y = __shfl_up_sync(FULL_MASK, incl, m);
        if (t >= m) incl += y;
    }
    const int first = incl - n0 - n1;
    const int total = __shfl_sync(FULL_MASK, incl, WARP - 1);
    for (int u0 = 0; u0 < total; u0 += WARP) {
        const int u = u0 + t;
        int owner = 0;  // the last thread whose first ray is at or before u
        for (int step = WARP / 2; step; step >>= 1) {
            const int f = __shfl_sync(FULL_MASK, first, owner + step);
            if (f <= u) owner += step;
        }
        const int k = u - __shfl_sync(FULL_MASK, first, owner);
        const int low = __shfl_sync(FULL_MASK, n0, owner);
        const unsigned dirs0 = __shfl_sync(FULL_MASK, d0, owner);
        const unsigned dirs1 = __shfl_sync(FULL_MASK, d1, owner);
        Batch<7> b;
        if (u < total) {
            const int sq = k < low ? owner : owner + WARP;
            const int dir = k < low ? __fns(dirs0, 0, k + 1) : __fns(dirs1, 0, k - low + 1);
            const int code = sb[sq];
            int tos[7], tg[7];
#pragma unroll
            for (int i = 0; i < 7; ++i) tos[i] = ray_sq(sq, dir, i);
#pragma unroll
            for (int i = 0; i < 7; ++i) tg[i] = tos[i] >= 0 ? sb[tos[i]] : 0;
            bool open = true;
#pragma unroll
            for (int i = 0; i < 7; ++i) {
                open = open && tos[i] >= 0;
                b.put(i, open && pair_take(code, tg[i]), pair_key(code, tg[i]),
                      sq | (max(tos[i], 0) << 6));
                open = open && tg[i] == 0;  // the ray ends at the first piece
            }
        }
        append_batch(list, n, noisy, b, t);
    }
}

// Castling, encoded king-takes-rook (ops/movegen.py _castling): for each
// of the side to move's castling rooks, the squares between king and rook
// and their destinations must be empty but for the two, and no square of
// the king's path attacked with both lifted off the board.
template <class List>
__device__ void castling_moves(const int* sb, int us, const int32_t* castling, int t,
                               List& list, int& n, int& noisy) {
    const int king_code = W_KING + 6 * us;
    const unsigned lo = __ballot_sync(FULL_MASK, sb[t] == king_code);
    const unsigned hi = __ballot_sync(FULL_MASK, sb[t + WARP] == king_code);
    const int ksq = lo ? __ffs(lo) - 1 : (hi ? WARP + __ffs(hi) - 1 : -1);  // the first king
    bool blocked[2], unsafe[2], has[2];
    int rsq[2], lo_k[2], hi_k[2];
    for (int side = 0; side < 2; ++side) {
        const int slot = 2 * us + side;
        const int raw = castling[slot];
        has[side] = raw >= 0 && ksq >= 0;
        rsq[side] = min(max(raw, 0), 63);
        const int kq = max(ksq, 0);
        const int k_dest = __ldg(&CASTLE_KING_TO[slot]), r_dest = __ldg(&CASTLE_ROOK_TO[slot]);
        lo_k[side] = min(kq, k_dest);
        hi_k[side] = max(kq, k_dest);
        const int lo_r = min(rsq[side], r_dest), hi_r = max(rsq[side], r_dest);
        bool occupied = false;
        for (int sq = t; sq < 64; sq += WARP) {
            const bool span = (sq >= lo_k[side] && sq <= hi_k[side]) || (sq >= lo_r && sq <= hi_r);
            occupied |= span && sq != kq && sq != rsq[side] && sb[sq] != 0;
        }
        blocked[side] = __any_sync(FULL_MASK, occupied);
    }
    // threads 0-7 walk the kingside path, 8-15 the queenside one
    const int side = (t >> 3) & 1;
    bool hit = false;
    if (t < 16 && has[side] && !blocked[side]) {
        for (int sq = lo_k[side] + (t & 7); sq <= hi_k[side]; sq += 8) {
            hit |= attacked(sb, sq, 1 - us, max(ksq, 0), rsq[side]);
        }
    }
    const unsigned hits = __ballot_sync(FULL_MASK, hit);
    unsafe[0] = (hits & 0x00ffu) != 0;
    unsafe[1] = (hits & 0xff00u) != 0;
    const int mine = t & 1;
    const bool ok = t < 2 && has[mine] && !blocked[mine] && !unsafe[mine];
    append(list, n, noisy, ok, CASTLE_KEY, max(ksq, 0) | (rsq[mine] << 6), t);
}

// Crazyhouse's drops: one per type the side to move's pocket (extra's
// EXTRA_POCKET words) holds onto each empty square, two squares a thread.
__device__ __forceinline__ void drop_moves(const int* sb, int us, const int32_t* extra, int t,
                                           MoveList<VARIANT_CRAZYHOUSE>& list, int& n,
                                           int& noisy) {
    Batch<2 * POCKET_TYPES> b;
#pragma unroll
    for (int pt = 0; pt < POCKET_TYPES; ++pt) {
        const bool held = extra[EXTRA_POCKET + us * POCKET_TYPES + pt] > 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int sq = t + h * WARP;
            b.put(2 * pt + h, held && sb[sq] == 0 && __ldg(&DROP_OK[pt * 64 + sq]), DROP_KEY,
                  DROP_FLAG | (pt << 12) | (sq << 6) | sq);
        }
    }
    append_batch(list, n, noisy, b, t);
}

// The sort's padding, above every packed value.
constexpr int kPad = 0x7fffffff;

// One compare-exchange step of a bitonic network over 64 values, two a
// thread (element t in a, t + 32 in b): partners at distance j; the pair
// is ascending where the element's bit k is clear (k 128: every pair).
__device__ __forceinline__ void bitonic_step(int& a, int& b, int j, int k, int t) {
    if (j == WARP) {  // the thread's own two elements
        const bool up = (t & k) == 0;
        const int lo = min(a, b), hi = max(a, b);
        a = up ? lo : hi;
        b = up ? hi : lo;
        return;
    }
    const bool lower = (t & j) == 0;
    const int xa = __shfl_xor_sync(FULL_MASK, a, j), xb = __shfl_xor_sync(FULL_MASK, b, j);
    const bool up_a = (t & k) == 0, up_b = ((t + WARP) & k) == 0;
    a = lower == up_a ? min(a, xa) : max(a, xa);
    b = lower == up_b ? min(b, xb) : max(b, xb);
}

// 32 values ascending, one a thread (element t).
__device__ __forceinline__ int sort32(int a, int t) {
#pragma unroll
    for (int k = 2; k <= WARP; k <<= 1) {
#pragma unroll
        for (int j = k >> 1; j; j >>= 1) {
            const int x = __shfl_xor_sync(FULL_MASK, a, j);
            a = ((t & j) == 0) == ((t & k) == 0) ? min(a, x) : max(a, x);
        }
    }
    return a;
}

// 64 values ascending, two a thread (element t in a, t + 32 in b).
__device__ __forceinline__ void sort64(int& a, int& b, int t) {
#pragma unroll
    for (int k = 2; k <= 2 * WARP; k <<= 1) {
#pragma unroll
        for (int j = k >> 1; j; j >>= 1) bitonic_step(a, b, j, k, t);
    }
}

// The all-ascending merge steps at distances 32 ... 1 of the 64 values
// from `at` (a bitonic merge: every pair ascending).
__device__ __forceinline__ void merge64(int& a, int& b, int t) {
#pragma unroll
    for (int j = WARP; j; j >>= 1) bitonic_step(a, b, j, 4 * WARP, t);
}

// The list's first n values ascending in place (n > 64): each 64 sorted
// in registers, then the all-ascending bitonic merges of 128, 256, ...
// values, comparators whose partner is >= n skipped; steps at distance
// 64 or more run in shared memory, the last six of each merge in
// registers again.
__device__ __forceinline__ void sort_shared(int* v, int n, int t) {
    auto load = [&](int at, int& a, int& b) {
        a = at + t < n ? v[at + t] : kPad;
        b = at + WARP + t < n ? v[at + WARP + t] : kPad;
    };
    auto store = [&](int at, int a, int b) {
        if (at + t < n) v[at + t] = a;
        if (at + WARP + t < n) v[at + WARP + t] = b;
    };
    for (int at = 0; at < n; at += 2 * WARP) {
        int a, b;
        load(at, a, b);
        sort64(a, b, t);
        store(at, a, b);
    }
    __syncwarp();
    for (int k = 4 * WARP; k < 2 * n; k <<= 1) {
        for (int j = k >> 1; j >= 2 * WARP; j >>= 1) {
            // pair q: e in the lower half of its 2j block; the first step of
            // a merge pairs e with its mirror e ^ (k - 1), the rest with e + j
            // (e >= q, and p > e: the pairs with p < n have q < n)
            for (int q = t; q < n; q += WARP) {
                const int e = (q / j) * 2 * j + q % j;
                const int p = j == k >> 1 ? e ^ (k - 1) : e + j;
                if (p < n) {
                    const int x = v[e], y = v[p];
                    v[e] = min(x, y);
                    v[p] = max(x, y);
                }
            }
            __syncwarp();
        }
        for (int at = 0; at < n; at += 2 * WARP) {
            int a, b;
            load(at, a, b);
            merge64(a, b, t);
            store(at, a, b);
        }
        __syncwarp();
    }
}

// The lane's ordered move list: moves (max_moves<V>() words, -1 padded),
// and the count and the noisy prefix's length, each clamped to that
// width. list is the warp's shared scratch; sb the lane's board in shared
// memory; extra its variant words (read in crazyhouse only).
template <int V>
__device__ void generate_moves_warp(const int* sb, int stm, int ep, const int32_t* castling,
                                    const int32_t* extra, const Ordering& o, int t,
                                    MoveList<V>& list, int32_t* moves, int* count, int* noisy) {
    constexpr int MM = max_moves<V>();
    static_assert(MM >= 2 * WARP, "K9: the short list's 64 values fit the output");
    // (a) enumerate with the static keys
    int n = 0, n_noisy = 0;
    leaper_moves<V>(sb, stm, t, list, n, n_noisy);
    pawn_moves<V>(sb, stm, ep, t, list, n, n_noisy);
    slider_moves(sb, stm, t, list, n, n_noisy);
    castling_moves(sb, stm, castling, t, list, n, n_noisy);
    if constexpr (V == VARIANT_CRAZYHOUSE) drop_moves(sb, stm, extra, t, list, n, n_noisy);
    __syncwarp();
    const int len = min(n, MoveList<V>::kCap);
    // the moves kept: all, or in antichess the captures when there are any
    int keep = n;
    if constexpr (V == VARIANT_ANTICHESS) keep = n_noisy > 0 ? n_noisy : n;
    const int out = min(min(keep, MM), len);
    const bool order = o.hist != nullptr || o.killer0 >= 0 || o.killer1 >= 0;
    if (len <= WARP) {  // (b) and (c) in registers, a value a thread
        int a = t < len ? list.packed[t] : kPad;
        if (order && t < len) a = ordered<V>(o, a);
        a = sort32(a, t);
        if (t < out) moves[t] = a & 0xFFFF;
    } else if (len <= 2 * WARP) {  // two values a thread
        int a = t < len ? list.packed[t] : kPad, b = t + WARP < len ? list.packed[t + WARP] : kPad;
        if (order) {
            if (t < len) a = ordered<V>(o, a);
            if (t + WARP < len) b = ordered<V>(o, b);
        }
        sort64(a, b, t);
        if (t < out) moves[t] = a & 0xFFFF;
        if (t + WARP < out) moves[t + WARP] = b & 0xFFFF;
    } else {
        if (order) {  // (b) four slots a thread at once, their loads in flight
            for (int j0 = 0; j0 < len; j0 += 4 * WARP) {
                int v[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int j = j0 + i * WARP + t;
                    v[i] = j < len ? ordered<V>(o, list.packed[j]) : 0;
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int j = j0 + i * WARP + t;
                    if (j < len) list.packed[j] = v[i];
                }
            }
            __syncwarp();
        }
        sort_shared(list.packed, len, t);  // (c)
        for (int j = t; j < out; j += WARP) moves[j] = list.packed[j] & 0xFFFF;
    }
    for (int j = min(keep, MM) + t; j < MM; j += WARP) moves[j] = -1;
    *count = min(keep, MM);
    *noisy = min(n_noisy, MM);
    __syncwarp();  // the list may be reused by the warp's next lane
}

}  // namespace rules
