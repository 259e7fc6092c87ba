// The board rules of one lane as warp-cooperative device functions: the
// attack query, node_rules (K8) and make_move with its piece changes
// (K10). One warp serves one lane; `t` is the thread's index in the warp,
// and every thread of the warp calls each function (they use __any_sync
// and __ballot_sync over the full warp). K9 (movegen.cuh) and the segment
// kernel build on the same functions.
//
// The variant is a template parameter V (a VARIANT_* id), as the
// reference compiles one program per static variant flag: the standard
// instantiation runs standard chess's rules (and chess960's), the others
// add their branches (threeCheck, kingOfTheHill, racingKings, horde,
// atomic, antichess; ops/board.py node_rules_plain and _apply). Crazyhouse
// has standard chess's node rules (its K8 instantiation is standard's) and
// adds drops, pockets and promoted bits to make-move. Atomic's captures
// explode (make_move_warp) and its kings may stand side by side
// (node_rules_warp).
//
// The static tables and constants come from rules_tables.cuh, which
// kernels.build() generates from the plain versions' own tables
// (ops/tables.py, ops/board.py, ops/movegen.py).
//
// Boards are the search's packed codes (0 empty, 1-6 white PNBRQK, 7-12
// black), a lane's 64 codes staged in shared memory by load_board.
#pragma once
#include "common.cuh"
#include "rules_tables.cuh"

namespace rules {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int WARP = 32;
// make_move_warp writes the board words and then one word per thread
static_assert(BT_BOARD == 0 && BT_STM == 64 && BT_W == BT_STM + WARP, "board row layout");
static_assert(BT_EXTRA + EXTRA_W <= BT_W, "board row layout");

__device__ __forceinline__ int ray_sq(int sq, int dir, int step) {
    return __ldg(&RAYS[(sq * 8 + dir) * 7 + step]);
}
__device__ __forceinline__ int knight_sq(int sq, int i) { return __ldg(&KNIGHT_TARGETS[sq * 8 + i]); }
__device__ __forceinline__ int king_sq(int sq, int i) { return __ldg(&KING_TARGETS[sq * 8 + i]); }
// the squares a pawn of `color` on sq attacks
__device__ __forceinline__ int pawn_cap_sq(int color, int sq, int i) {
    return __ldg(&PAWN_CAPTURES[(color * 64 + sq) * 2 + i]);
}
__device__ __forceinline__ int ptype(int code) { return __ldg(&PIECE_TYPE[code]); }
__device__ __forceinline__ int pcolor(int code) { return __ldg(&PIECE_COLOR[code]); }
__device__ __forceinline__ bool slides(int code, int dir) { return __ldg(&SLIDER_MASK[dir * 13 + code]); }

// The lane's 64 codes (a row of `src`, element stride 1) into shared sb.
__device__ __forceinline__ void load_board(int* sb, const int32_t* src, int t) {
    sb[t] = src[t];
    sb[t + WARP] = src[t + WARP];
    __syncwarp();
}

// Is sq attacked by color `by`? One thread's scalar query (board.py
// attack_parts at one square): a knight, king or pawn of `by` on a square
// that attacks sq, or a slider of `by` first on one of sq's rays that
// moves along that ray. The sliders' rays read lift_a and lift_b (-1:
// none) as empty: K9's castling check lifts the king and its rook.
__device__ bool attacked(const int* sb, int sq, int by, int lift_a, int lift_b) {
    const int knight = W_KNIGHT + 6 * by, king = W_KING + 6 * by, pawn = W_PAWN + 6 * by;
    for (int i = 0; i < 8; ++i) {
        int s = knight_sq(sq, i);
        if (s >= 0 && sb[s] == knight) return true;
        s = king_sq(sq, i);
        if (s >= 0 && sb[s] == king) return true;
    }
    for (int i = 0; i < 2; ++i) {  // `by`'s pawns attack sq from where the other color's would
        int s = pawn_cap_sq(1 - by, sq, i);
        if (s >= 0 && sb[s] == pawn) return true;
    }
    for (int d = 0; d < 8; ++d) {
        for (int i = 0; i < 7; ++i) {
            int s = ray_sq(sq, d, i);
            if (s < 0) break;
            if (s == lift_a || s == lift_b) continue;
            int code = sb[s];
            if (code == 0) continue;
            if (pcolor(code) == by && slides(code, d)) return true;
            break;
        }
    }
    return false;
}

// The first square holding `code` on the lane's board, or -1 (board.py
// king_square).
__device__ __forceinline__ int first_square(const int* sb, int code, int t) {
    const unsigned lo = __ballot_sync(FULL_MASK, sb[t] == code);
    const unsigned hi = __ballot_sync(FULL_MASK, sb[t + WARP] == code);
    return lo ? __ffs(lo) - 1 : (hi ? WARP + __ffs(hi) - 1 : -1);
}

// K8's body (board.py node_rules_plain). parent_illegal: the side that
// just moved broke its duty — left its king attacked or has none (in
// racingKings also: gave check; in horde only black has the duty, in
// antichess nobody); checked: the side to move is in check (never in
// racingKings or antichess, and only black in horde); term: the
// variant's game end at this node, TERM_*, from the side to move's view.
// Every square holding a king is tested, as the plain version's maps do.
// In atomic the mover's duty is to keep its king, and to keep it safe
// unless the kings stand a king step apart (a capture would explode
// both, so neither is in check); the side to move without a king has
// lost, whatever befell the mover's. extra: the lane's variant words
// (read in threeCheck only).
template <int V>
__device__ void node_rules_warp(const int* sb, int stm, const int32_t* extra, int t,
                                bool* parent_illegal, bool* checked, int* term) {
    *term = TERM_NONE;
    if constexpr (V == VARIANT_ANTICHESS) {  // kings are ordinary pieces
        *parent_illegal = false;
        *checked = false;
        return;
    }
    const int us = stm == 0 ? 0 : 1;
    const int our_king = W_KING + 6 * stm, their_king = B_KING - 6 * stm;
    bool seen = false, their_hit = false, our_hit = false, white_piece = false;
    for (int sq = t; sq < 64; sq += WARP) {
        int code = sb[sq];
        if (code == their_king) {
            seen = true;
            their_hit |= attacked(sb, sq, us, -1, -1);
        }
        if (code == our_king) our_hit |= attacked(sb, sq, 1 - us, -1, -1);
        if constexpr (V == VARIANT_HORDE) white_piece |= pcolor(code) == 0;
    }
    const bool their_attacked = __any_sync(FULL_MASK, their_hit);
    const bool self_check = !__any_sync(FULL_MASK, seen) || their_attacked;
    const bool check = __any_sync(FULL_MASK, our_hit);
    *parent_illegal = self_check;
    *checked = check;
    if constexpr (V == VARIANT_HORDE) {  // white is the kingless horde
        const bool white_dead = !__any_sync(FULL_MASK, white_piece);
        *parent_illegal = self_check && us == 0;
        *checked = check && us == 1;
        if (us == 0 && white_dead) *term = TERM_LOSS;
    } else if constexpr (V == VARIANT_KINGOFTHEHILL) {  // the mover's king on the hill
        const int their_k = first_square(sb, their_king, t);
        for (int i = 0; i < 4; ++i) {
            if (their_k == __ldg(&HILL[i])) *term = TERM_LOSS;
        }
    } else if constexpr (V == VARIANT_RACINGKINGS) {
        // giving check is illegal; black gets one rejoinder to white's
        // arrival on the goal rank
        const bool our8 = first_square(sb, our_king, t) >= GOAL_RANK_FROM;
        const bool their8 = first_square(sb, their_king, t) >= GOAL_RANK_FROM;
        *parent_illegal = self_check || check;
        *checked = false;
        *term = (our8 && their8) ? TERM_DRAW
                : (their8 && us == 0) ? TERM_LOSS : ((our8 && us == 0) ? TERM_WIN : TERM_NONE);
    } else if constexpr (V == VARIANT_ATOMIC) {
        const int our_k = first_square(sb, our_king, t);
        const int their_k = first_square(sb, their_king, t);
        bool adj = false;  // KING_TARGETS' -1 pads never equal a square
        for (int i = 0; i < 8 && our_k >= 0 && their_k >= 0; ++i) adj |= king_sq(their_k, i) == our_k;
        const bool lost = our_k < 0;
        *parent_illegal = !lost && (their_k < 0 || (their_attacked && !adj));
        *checked = check && !adj;
        if (lost) *term = TERM_LOSS;
    } else if constexpr (V == VARIANT_THREECHECK) {  // the mover's third check
        const int them_checks = extra[EXTRA_CHECKS + (us == 0 ? 1 : 0)];
        if (them_checks >= THREE_CHECKS) *term = TERM_LOSS;
    }
}

// A move decoded against its board (board.py _move_parts). In crazyhouse
// a drop (DROP_FLAG | type << 12 | to << 6 | to) moves no piece of the
// board: no pawn or king move, no castling, no capture; it places its
// type (promo: 0-4, P..Q) of the mover's color on `to`.
struct MoveParts {
    int frm, to, piece, target, placed, rook, promo;
    bool is_pawn, is_king, is_castle, is_ep, capture, drop;
    int ep_victim, king_to, r_dest, cleared;
};

template <int V>
__device__ __forceinline__ MoveParts decode_move(const int* sb, int stm, int ep, int move) {
    MoveParts m;
    m.frm = move & 63;
    m.to = (move >> 6) & 63;
    constexpr bool zh = V == VARIANT_CRAZYHOUSE;
    m.drop = zh && (move & DROP_FLAG) != 0;
    m.promo = zh ? (move >> 12) & 7 : move >> 12;  // the other variants carry no drop bit
    m.piece = sb[m.frm];
    m.target = sb[m.to];
    const int us6 = 6 * stm;
    const int pt = ptype(m.piece);
    m.is_pawn = pt == 0 && !m.drop;
    m.is_king = pt == 5 && !m.drop;
    m.rook = W_ROOK + us6;
    m.is_castle = m.is_king && m.target == m.rook;  // king takes own rook
    m.capture = pcolor(m.target) == 1 - stm;
    m.is_ep = m.is_pawn && m.to == ep && m.target == 0 && (m.to & 7) != (m.frm & 7);
    m.ep_victim = min(max(m.to - 8 + 16 * stm, 0), 63);
    m.placed = m.promo > 0 ? __ldg(&PROMO_TO_PIECE[min(m.promo, 5)]) + us6 : m.piece;
    if (m.drop) m.placed = W_PAWN + min(m.promo, POCKET_TYPES - 1) + us6;
    const int slot = 2 * stm + (m.to > m.frm ? 0 : 1);  // kingside, queenside
    m.r_dest = __ldg(&CASTLE_ROOK_TO[slot]);
    m.king_to = m.is_castle ? __ldg(&CASTLE_KING_TO[slot]) : m.to;
    m.cleared = m.is_castle ? m.to : (m.is_ep ? m.ep_victim : m.frm);
    return m;
}

// The child's code on sq: the origin and the capture (or castling rook)
// square cleared, then the mover placed (board.py _apply's scatters; the
// two placements never share a square unless they place the same code).
__device__ __forceinline__ int child_code(const int* sb, const MoveParts& m, int sq) {
    int code = (sq == m.frm || sq == m.cleared) ? 0 : sb[sq];
    if (sq == m.king_to) code = m.is_castle ? m.piece : m.placed;
    if (sq == (m.is_castle ? m.r_dest : m.to)) code = m.is_castle ? m.rook : m.placed;
    return code;
}

// Atomic's blast zone: the landing square `to` and its king targets (the
// -1 pads of KING_TARGETS never equal a square, so none stands for a1).
__device__ __forceinline__ bool in_blast(int sq, int to) {
    bool in = sq == to;
    for (int i = 0; i < 8; ++i) in |= king_sq(to, i) == sq;
    return in;
}

// Atomic's child code on sq after a capture's blast (board.py _explode):
// the capturer on `to` and every non-pawn in the zone are gone.
__device__ __forceinline__ int blast_code(int code, int sq, int to) {
    return (in_blast(sq, to) && (sq == to || ptype(code) != 0)) ? 0 : code;
}

// Crazyhouse's child word i of the variant words (board.py
// _crazyhouse_extra): the mover's pocket gains the piece it captured (a
// promoted one as a pawn) and pays for a drop; the promoted bits (a 64-bit
// board in words EXTRA_PROMOTED, EXTRA_PROMOTED + 1) leave the origin and
// the captured piece's square, and the destination takes one for a fresh
// promotion or a promoted piece moving on.
__device__ __forceinline__ int crazyhouse_word(const int* sb, const MoveParts& m, int stm,
                                               const int32_t* extra, int i) {
    uint64_t promoted = (uint32_t)extra[EXTRA_PROMOTED]
                        | ((uint64_t)(uint32_t)extra[EXTRA_PROMOTED + 1] << 32);
    const int cap_sq = m.is_ep ? m.ep_victim : m.to;
    const bool real_capture = (m.capture || m.is_ep) && !(m.is_castle || m.drop);
    if (i >= EXTRA_POCKET && i < EXTRA_POCKET + 2 * POCKET_TYPES) {
        const int slot = EXTRA_POCKET + stm * POCKET_TYPES;
        const int cap_type = ((promoted >> cap_sq) & 1) ? 0 : max(ptype(sb[cap_sq]), 0);
        return extra[i] + (real_capture && i == slot + min(cap_type, POCKET_TYPES - 1))
               - (m.drop && i == slot + min(m.promo, POCKET_TYPES - 1));
    }
    if (i < EXTRA_PROMOTED || i >= EXTRA_PROMOTED + 2) return extra[i];
    const bool dest = !m.drop && (m.promo > 0 || ((promoted >> m.frm) & 1));
    promoted &= ~(1ull << m.frm);
    if (real_capture) promoted &= ~(1ull << cap_sq);
    promoted = (promoted & ~(1ull << m.to)) | ((uint64_t)dest << m.to);
    return (int)(uint32_t)(promoted >> (32 * (i - EXTRA_PROMOTED)));
}

// K10's body: the child of `move` as a packed board row (BT_W words: the
// board, side to move, ep square, castling rooks, halfmove clock, the
// parent's variant words — threeCheck's mover's counter raised when the
// move gives check, crazyhouse's pockets and promoted bits moved with the
// pieces — then zeros, as board.py rows_from_board writes them) and the
// four piece-change slots [mover out, capture out, mover in, rook in]
// (codes, sqs, signs; board.py _changes; a drop fills only the third;
// atomic's slots leave its blast out, and the search never applies them).
// An atomic capture blows up the child's board squares first, and each
// castling word then also reads whether the blast reached its rook and
// whether each king survived it (warp votes over the blown squares).
// Each thread writes its own words; the child's board is read back
// (threeCheck) after a warp barrier, so `child` may be shared or global
// memory.
template <int V>
__device__ void make_move_warp(const int* sb, int stm, int ep, const int32_t* castling,
                               int halfmove, const int32_t* extra, int move, int t,
                               int32_t* child, int32_t* codes, int32_t* sqs, int32_t* signs) {
    const MoveParts m = decode_move<V>(sb, stm, ep, move);
    int c0 = child_code(sb, m, t), c1 = child_code(sb, m, t + WARP);
    const bool blast = V == VARIANT_ATOMIC && (m.capture || m.is_ep);
    bool alive[2] = {true, true};  // after a blast: does each color keep its king?
    if constexpr (V == VARIANT_ATOMIC) {
        if (blast) {
            c0 = blast_code(c0, t, m.to);
            c1 = blast_code(c1, t + WARP, m.to);
        }
        alive[0] = __any_sync(FULL_MASK, c0 == W_KING || c1 == W_KING);
        alive[1] = __any_sync(FULL_MASK, c0 == B_KING || c1 == B_KING);
    }
    child[BT_BOARD + t] = c0;
    child[BT_BOARD + t + WARP] = c1;
    bool gave_check = false;
    if constexpr (V == VARIANT_THREECHECK) {  // the mover attacks the enemy king
        __syncwarp();
        const int ek = first_square(child, W_KING + 6 * (1 - stm), t);
        const bool hit = t == 0 && ek >= 0 && attacked(child, ek, stm, -1, -1);
        gave_check = __shfl_sync(FULL_MASK, hit, 0);
    }
    const int w = BT_STM + t;  // one word of the rest of the row a thread
    int v = 0;
    if (w == BT_STM) {
        v = 1 - stm;
    } else if (w == BT_EP) {
        bool dbl = m.is_pawn && abs(m.to - m.frm) == 16;
        if constexpr (V == VARIANT_HORDE) {  // the horde's back-rank doubles set no ep square
            dbl = dbl && !(stm == 0 && (m.frm >> 3) == 0);
        }
        v = dbl ? (m.frm + m.to) >> 1 : -1;
    } else if (w >= BT_CAST && w < BT_CAST + 4) {
        const int i = w - BT_CAST;
        const int rook_sq = castling[i];
        const int color = __ldg(&CASTLE_SLOT_COLOR[i]);
        bool gone = (m.is_king && color == stm)
                    || ((rook_sq == m.frm || rook_sq == m.to) && !m.drop);
        if (blast) gone = gone || (rook_sq >= 0 && in_blast(rook_sq, m.to)) || !alive[color];
        v = gone ? -1 : rook_sq;
    } else if (w == BT_HM) {  // a pawn drop is a pawn move
        v = (m.is_pawn || m.capture || m.is_ep || (m.drop && m.promo == 0)) ? 0 : halfmove + 1;
    } else if (w >= BT_EXTRA && w < BT_EXTRA + EXTRA_W) {
        if constexpr (V == VARIANT_CRAZYHOUSE) {
            v = crazyhouse_word(sb, m, stm, extra, w - BT_EXTRA);
        } else {
            v = extra[w - BT_EXTRA] + (gave_check && w == BT_EXTRA + EXTRA_CHECKS + stm);
        }
    }
    child[w] = v;
    if (t < 4) {
        int code, sq;
        switch (t) {
            case 0: code = m.drop ? 0 : m.piece; sq = m.frm; break;
            case 1:
                code = m.is_ep ? sb[m.ep_victim] : ((m.is_castle || m.capture) ? m.target : 0);
                sq = m.is_ep ? m.ep_victim : m.to;
                break;
            case 2: code = m.placed; sq = m.king_to; break;
            default: code = m.is_castle ? m.rook : 0; sq = m.r_dest; break;
        }
        codes[t] = code;
        sqs[t] = sq;
        signs[t] = __ldg(&CHANGE_SIGNS[t]);
    }
}

}  // namespace rules
