// K9's body: the pseudo-legal moves of one lane, ordered, as a warp-
// cooperative device function (ops/movegen.py generate_moves_plain).
//
// The plain version fills ~4,962 fixed candidate slots and sorts them all:
// the TPU's answer to fixed shapes. Here the warp enumerates the moves
// themselves (each thread the pieces on two squares; two threads the two
// castling rooks, sixteen the squares of their king paths) into a list in
// shared memory, then ranks the list. Each move is packed as
// (key << 16) | move with the plain version's key; the packed values of a
// position are distinct, so a value's rank (how many values are smaller)
// is its place in the plain version's sorted list, and the list is that
// list bit for bit. (Equal values, which only a castling right without
// its rook could make, are ranked by list position: a stable sort.) The
// rank sort costs n^2 / 32 shared-memory reads per thread for n moves
// (~40 in a middlegame), and no thread waits on another's order.
//
// The variant is a template parameter V, as in board.cuh: horde's pawns
// on white's first rank also push two squares, an atomic king never
// captures (its candidate is dropped before it is counted, so the count,
// the noisy prefix and the ranks are the plain version's), antichess adds a fifth
// promotion (to a king) and makes a capture compulsory — its captures
// (en passant included) are exactly its moves with keys below
// NOISY_BELOW, which rank first, so when any exists the list keeps only
// the first `noisy` ranks. Crazyhouse adds a drop of each type its pocket
// holds on each empty square (a pawn not on the first or last rank),
// keyed DROP_KEY, and keeps MAX_MOVES_ZH moves (max_moves<V>): the ranks
// of drops that share a key are their packed values', as the plain
// version's sort gives.
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
    int n;
    int noisy;
};
template <int V>
using MoveList = MoveListOf<move_list_cap<V>()>;

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

template <class List>
__device__ __forceinline__ void push(List& list, int key, int move) {
    if (key < NOISY_BELOW) atomicAdd(&list.noisy, 1);
    const int slot = atomicAdd(&list.n, 1);
    if (slot < List::kCap) list.packed[slot] = (key << 16) | move;
}

template <class List>
__device__ __forceinline__ void emit(List& list, const Ordering& o, int key, int move) {
    if (o.hist != nullptr && key == QUIET_KEY) key = HIST_BASE - hist_bonus(o, move);
    if (key >= NOISY_BELOW && (move == o.killer0 || move == o.killer1)) {
        key = KILLER_KEY;
    }
    push(list, key, move);
}

// A crazyhouse drop: DROP_KEY, or DROP_HIST_BASE less its history bonus
// (its counter is to << 6 | to's), or KILLER_KEY for a killer.
template <class List>
__device__ __forceinline__ void emit_drop(List& list, const Ordering& o, int move) {
    int key = o.hist != nullptr ? DROP_HIST_BASE - hist_bonus(o, move) : DROP_KEY;
    if (move == o.killer0 || move == o.killer1) key = KILLER_KEY;
    push(list, key, move);
}

__device__ __forceinline__ int pair_key(int mover, int target) {
    return __ldg(&PAIR_KEY[mover * 13 + target]);
}
__device__ __forceinline__ bool pair_take(int mover, int target) {
    return __ldg(&PAIR_TAKE[mover * 13 + target]);
}

// The moves of the piece on sq, if it is the side to move's.
template <int V, class List>
__device__ void piece_moves(const int* sb, int us, int ep, int sq, List& list,
                            const Ordering& o) {
    const int code = sb[sq];
    if (code == 0 || pcolor(code) != us) return;
    const int pt = ptype(code);
    if (code == W_PAWN + 6 * us) {
        const int to1 = __ldg(&PAWN_PUSH[(us * 2) * 64 + sq]);
        const int to2 = __ldg(&PAWN_PUSH[(us * 2 + 1) * 64 + sq]);
        const bool to1_ok = sb[to1] == 0;
        const bool pre_promo = __ldg(&PAWN_PRE_PROMO[us * 64 + sq]);
        bool start = __ldg(&PAWN_START[us * 64 + sq]);
        if constexpr (V == VARIANT_HORDE) start = start || (us == 0 && sq < 8);
        if (to1_ok && start && sb[to2] == 0) {
            emit(list, o, QUIET_KEY, sq | (to2 << 6));
        }
        for (int i = -1; i < 2; ++i) {  // the push, then the two captures
            int to = to1, key = QUIET_KEY;
            bool ok = to1_ok;
            if (i >= 0) {
                to = pawn_cap_sq(us, sq, i);
                const int target = to >= 0 ? sb[to] : 0;
                ok = (to >= 0 && pcolor(target) == 1 - us) || (to >= 0 ? to : 64) == ep;
                key = __ldg(&PAWN_CAP_KEY[target]);
            }
            if (!ok) continue;
            const int base = sq | (max(to, 0) << 6);
            if (!pre_promo) {
                emit(list, o, key, base);
                continue;
            }
            constexpr int n_promos = V == VARIANT_ANTICHESS ? 5 : 4;
            for (int p = 0; p < n_promos; ++p) {
                const int promo = p < 4 ? __ldg(&PROMOS[p]) : PROMO_K;
                emit(list, o, key - (promo == PROMO_Q ? QUEEN_PROMO_BONUS : 0), base | (promo << 12));
            }
        }
    } else if (pt == 1 || pt == 5) {
        const int8_t* targets = pt == 1 ? KNIGHT_TARGETS : KING_TARGETS;
        for (int i = 0; i < 8; ++i) {
            const int to = __ldg(&targets[sq * 8 + i]);
            if (to < 0 || !pair_take(code, sb[to])) continue;
            if constexpr (V == VARIANT_ATOMIC) {  // a king's capture would blow it up
                if (pt == 5 && sb[to] != 0) continue;
            }
            emit(list, o, pair_key(code, sb[to]), sq | (to << 6));
        }
    } else {
        for (int d = 0; d < 8; ++d) {
            if (!slides(code, d)) continue;
            for (int i = 0; i < 7; ++i) {
                const int to = ray_sq(sq, d, i);
                if (to < 0) break;
                const int target = sb[to];
                if (pair_take(code, target)) emit(list, o, pair_key(code, target), sq | (to << 6));
                if (target != 0) break;
            }
        }
    }
}

// Castling, encoded king-takes-rook (ops/movegen.py _castling): for each
// of the side to move's castling rooks, the squares between king and rook
// and their destinations must be empty but for the two, and no square of
// the king's path attacked with both lifted off the board.
template <class List>
__device__ void castling_moves(const int* sb, int us, const int32_t* castling, int t,
                               List& list, const Ordering& o) {
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
    if (t < 2 && has[t] && !blocked[t] && !unsafe[t]) {
        emit(list, o, CASTLE_KEY, max(ksq, 0) | (rsq[t] << 6));
    }
}

// Crazyhouse's drops onto sq, if it is empty: one per type the side to
// move's pocket (extra's EXTRA_POCKET words) holds.
__device__ __forceinline__ void drop_moves(const int* sb, int us, const int32_t* extra, int sq,
                                           MoveList<VARIANT_CRAZYHOUSE>& list,
                                           const Ordering& o) {
    if (sb[sq] != 0) return;
    for (int pt = 0; pt < POCKET_TYPES; ++pt) {
        if (extra[EXTRA_POCKET + us * POCKET_TYPES + pt] > 0 && __ldg(&DROP_OK[pt * 64 + sq])) {
            emit_drop(list, o, DROP_FLAG | (pt << 12) | (sq << 6) | sq);
        }
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
    if (t == 0) {
        list.n = 0;
        list.noisy = 0;
    }
    __syncwarp();
    piece_moves<V>(sb, stm, ep, t, list, o);
    piece_moves<V>(sb, stm, ep, t + WARP, list, o);
    castling_moves(sb, stm, castling, t, list, o);
    if constexpr (V == VARIANT_CRAZYHOUSE) {
        drop_moves(sb, stm, extra, t, list, o);
        drop_moves(sb, stm, extra, t + WARP, list, o);
    }
    __syncwarp();
    const int n = min(list.n, move_list_cap<V>());
    // the moves kept: all, or in antichess the captures when there are any
    int keep = list.n;
    if constexpr (V == VARIANT_ANTICHESS) keep = list.noisy > 0 ? list.noisy : list.n;
    for (int j = t; j < n; j += WARP) {
        const int v = list.packed[j];
        int rank = 0;
        for (int k = 0; k < n; ++k) {
            const int w = list.packed[k];
            rank += w < v || (w == v && k < j);  // equal values (none in play) stay apart
        }
        if (rank < MM && rank < keep) moves[rank] = v & 0xFFFF;
    }
    for (int j = min(keep, MM) + t; j < MM; j += WARP) moves[j] = -1;
    *count = min(keep, MM);
    *noisy = min(list.noisy, MM);
    __syncwarp();  // the list may be reused by the warp's next lane
}

}  // namespace rules
