// The transposition table's per-lane bodies as device functions: the
// Zobrist keys of a position (K4), a probe of one row (K5) and the store
// (K6): its row, its keep-old rule and its claim and commit halves. K4-K6's
// kernels wrap them; the segment kernel (K11) calls the same functions.
// The table is (n, 4) int32 rows
// [check, meta, move, generation] with meta = (score + 32768) << 10 |
// depth << 2 | flag; a row is valid when check ^ meta ^ move == h2 and
// meta != 0 (ops/tt.py).
//
// The constants (the key tables' layout: piece-square | ep | castling |
// stm | the variants' keys; the meta packing, the flags, the largest
// storable score) come from search_consts.cuh, which kernels.build()
// writes from ops/tt.py and ops/board.py. The keys take the variant as a
// template parameter V: every variant but standard chess XORs in its salt,
// threeCheck also its check counters, crazyhouse its ten pocket counts and
// a key per square of its promoted-piece bits (ops/tt.py hash_board_plain;
// plain indexing where the reference picks its keys by one-hot selects).
#pragma once
#include "common.cuh"
#include "search_consts.cuh"

namespace tt {

using consts::CASTLE_OFF;
using consts::CHECKS_OFF;
using consts::DEPTH_MASK;
using consts::EP_OFF;
using consts::FLAG_EXACT;
using consts::FLAG_LOWER;
using consts::MAX_STORE;
using consts::POCKET_OFF;
using consts::PROMOTED_OFF;
using consts::SCORE_BIAS;
using consts::STM_OFF;
using consts::VARIANT_OFF;

// The keys of the squares, ep square, castling rooks and side to move
// outside the pieces: XORed into every position's pair.
__device__ __forceinline__ void side_keys(int stm, int ep, const int32_t* castling,
                                          const uint32_t* z1, const uint32_t* z2,
                                          uint32_t& h1, uint32_t& h2) {
    int e = ep + 1;
    if (e >= 0 && e < 65) {
        h1 ^= z1[EP_OFF + e];
        h2 ^= z2[EP_OFF + e];
    }
    for (int i = 0; i < 4; ++i) {
        int c = castling[i] + 1;
        if (c >= 0 && c < 65) {
            h1 ^= z1[CASTLE_OFF + i * 65 + c];
            h2 ^= z2[CASTLE_OFF + i * 65 + c];
        }
    }
    int s = stm == 0 ? 0 : 1;
    h1 ^= z1[STM_OFF + s];
    h2 ^= z2[STM_OFF + s];
}

// The variant's keys: its salt, and threeCheck's counters (extra's
// EXTRA_CHECKS words, each clipped to 0..THREE_CHECKS).
template <int V>
__device__ __forceinline__ void variant_keys(const int32_t* extra, const uint32_t* z1,
                                             const uint32_t* z2, uint32_t& h1, uint32_t& h2) {
    if constexpr (V != consts::VARIANT_STANDARD) {
        h1 ^= z1[VARIANT_OFF + V];
        h2 ^= z2[VARIANT_OFF + V];
    }
    if constexpr (V == consts::VARIANT_THREECHECK) {
        for (int c = 0; c < 2; ++c) {
            const int k = CHECKS_OFF + c * (consts::THREE_CHECKS + 1)
                          + min(max(extra[consts::EXTRA_CHECKS + c], 0), consts::THREE_CHECKS);
            h1 ^= z1[k];
            h2 ^= z2[k];
        }
    }
}

__device__ __forceinline__ void piece_key(int code, int sq, const uint32_t* z1,
                                          const uint32_t* z2, uint32_t& h1, uint32_t& h2) {
    if (code > 0 && code <= 12) {
        h1 ^= z1[code * 64 + sq];
        h2 ^= z2[code * 64 + sq];
    }
}

// Crazyhouse's key of square sq's promoted bit (extra's EXTRA_PROMOTED
// words: bit sq % 32 of word sq / 32), if it is set.
__device__ __forceinline__ void promoted_key(const int32_t* extra, int sq, const uint32_t* z1,
                                             const uint32_t* z2, uint32_t& h1, uint32_t& h2) {
    if (((uint32_t)extra[consts::EXTRA_PROMOTED + (sq >> 5)] >> (sq & 31)) & 1u) {
        h1 ^= z1[PROMOTED_OFF + sq];
        h2 ^= z2[PROMOTED_OFF + sq];
    }
}

// Crazyhouse's key of pocket word `slot` (color * POCKET_TYPES + type):
// one of POCKET_MAX + 1 keys, by the count clipped to 0..POCKET_MAX.
__device__ __forceinline__ void pocket_key(const int32_t* extra, int slot, const uint32_t* z1,
                                           const uint32_t* z2, uint32_t& h1, uint32_t& h2) {
    const int k = POCKET_OFF + slot * (consts::POCKET_MAX + 1)
                  + min(max(extra[consts::EXTRA_POCKET + slot], 0), consts::POCKET_MAX);
    h1 ^= z1[k];
    h2 ^= z2[k];
}

// K4's body: one thread hashes one position (board: 64 codes; extra its
// variant words, read in threeCheck and crazyhouse only).
template <int V>
__device__ __forceinline__ void zobrist_keys(const int32_t* board, int stm, int ep,
                                             const int32_t* castling, const int32_t* extra,
                                             const uint32_t* z1, const uint32_t* z2,
                                             uint32_t& h1, uint32_t& h2) {
    h1 = 0;
    h2 = 0;
    for (int sq = 0; sq < 64; ++sq) piece_key(board[sq], sq, z1, z2, h1, h2);
    if constexpr (V == consts::VARIANT_CRAZYHOUSE) {
        for (int slot = 0; slot < 2 * consts::POCKET_TYPES; ++slot) {
            pocket_key(extra, slot, z1, z2, h1, h2);
        }
        for (int sq = 0; sq < 64; ++sq) promoted_key(extra, sq, z1, z2, h1, h2);
    }
    side_keys(stm, ep, castling, z1, z2, h1, h2);
    variant_keys<V>(extra, z1, z2, h1, h2);
}

// The same keys from a warp: each thread XORs two squares (in crazyhouse
// also their promoted bits, and threads below 2 * POCKET_TYPES a pocket
// word each), the warp folds them (XOR is order free, so the keys equal
// zobrist_keys' bit for bit); every thread returns the pair.
template <int V>
__device__ __forceinline__ void zobrist_keys_warp(const int* board, int stm, int ep,
                                                  const int* castling, const int* extra,
                                                  const uint32_t* z1, const uint32_t* z2, int t,
                                                  uint32_t& h1, uint32_t& h2) {
    h1 = 0;
    h2 = 0;
    piece_key(board[t], t, z1, z2, h1, h2);
    piece_key(board[t + 32], t + 32, z1, z2, h1, h2);
    if constexpr (V == consts::VARIANT_CRAZYHOUSE) {
        const int32_t* e = (const int32_t*)extra;
        promoted_key(e, t, z1, z2, h1, h2);
        promoted_key(e, t + 32, z1, z2, h1, h2);
        if (t < 2 * consts::POCKET_TYPES) pocket_key(e, t, z1, z2, h1, h2);
    }
    for (int off = 16; off > 0; off >>= 1) {
        h1 ^= __shfl_xor_sync(0xffffffffu, h1, off);
        h2 ^= __shfl_xor_sync(0xffffffffu, h2, off);
    }
    side_keys(stm, ep, (const int32_t*)castling, z1, z2, h1, h2);
    variant_keys<V>((const int32_t*)extra, z1, z2, h1, h2);
}

// K5's body on the row in the lane's slot: usable (a valid row of the
// exact depth — deep_bounds: at least that deep — whose bound cuts
// (alpha, beta), for an entering lane), its unpacked score, and the
// valid row's move for ordering (-1 otherwise).
__device__ __forceinline__ void probe_row(int4 row, int32_t h2, int32_t depth_left,
                                          int32_t alpha, int32_t beta, bool enter,
                                          bool deep_bounds, bool& usable, int32_t& score,
                                          int32_t& order_move) {
    int32_t meta = row.y;
    int32_t move = row.z;
    bool valid = (row.x ^ meta ^ move) == h2 && meta != 0;
    int32_t sc = (meta >> 10) - SCORE_BIAS;
    int32_t depth = (meta >> 2) & DEPTH_MASK;
    int32_t flag = meta & 3;
    int32_t dl = max(depth_left, 0);
    bool deep_enough = deep_bounds ? depth >= dl : depth == dl;
    bool cuts = flag == FLAG_EXACT ? true : flag == FLAG_LOWER ? sc >= beta : sc <= alpha;
    usable = valid && deep_enough && cuts && enter;
    score = sc;
    order_move = (valid && enter) ? move : -1;
}

// K6's rules for one masked lane: a score in the mate range stores
// nothing; with prefer_deep a non-empty pre-store row of the lane's
// generation that is strictly deeper is kept.
__device__ __forceinline__ bool storable(int32_t score) {
    // |score| with int32 wraparound, as jnp.abs and torch.abs give
    int32_t mag = (int32_t)(score < 0 ? 0u - (uint32_t)score : (uint32_t)score);
    return mag <= MAX_STORE;
}

__device__ __forceinline__ bool keep_old(int4 old, int32_t gen, int32_t depth) {
    return old.y != 0 && old.w == gen && ((old.y >> 2) & DEPTH_MASK) > depth;
}

__device__ __forceinline__ int4 store_row(int32_t h2, int32_t score, int32_t depth,
                                          int32_t flag, int32_t move, int32_t gen) {
    uint32_t meta = ((uint32_t)(score + SCORE_BIAS) << 10) | ((uint32_t)depth << 2)
                    | (uint32_t)flag;
    return make_int4(h2 ^ (int32_t)meta ^ move, (int32_t)meta, move, gen);
}

// K6's store in two halves, the body its kernel and K11 run. The claim
// half decides a lane's store (storable, and with prefer_deep not kept
// out by a deeper row of its generation), stages its row and slot and
// claims the slot: atomicMax of the lane into the slot's claim word, so
// the highest storable lane of a slot wins, as the reference's scatter
// gives on XLA:CPU. The commit half, after every claim of the store,
// lets each slot's winner write its row whole, then frees the word.
// Between the halves a reader of a slot goes through the claim words
// (read_row): a claimed slot reads as its winner's staged row, which is
// what it holds once the store lands, so a store's commits may run beside
// the next store's claims and a step's probes.
struct Pending {
    int* claims;  // (n,): -1, or the highest lane claiming the slot
    int4* staged;  // lane l's row at staged[l * stride], its slot at staged[l * stride + 1].x
    int stride;  // int4s a lane
};

// The claim word, with acquire order: a commit writes its row, fences and
// only then frees the word, so a reader that finds it free reads the row.
__device__ __forceinline__ int load_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

// Slot s's row as it stands once `pending`'s store has landed, from the
// slot's claim word w read earlier in the same phase (a staged row stays
// until the next barrier; a slot found free keeps its row).
__device__ __forceinline__ int4 row_after(const int4* table, const Pending& pending, uint32_t s,
                                          int w) {
    return __ldcg(w >= 0 ? pending.staged + (int64_t)w * pending.stride : table + s);
}

// The same from the claim word read now; `through` says whether it came
// from a winner's staged row.
__device__ __forceinline__ int4 read_row(const int4* table, const Pending& pending, uint32_t s,
                                         bool& through) {
    const int w = load_acquire(pending.claims + s);
    through = w >= 0;
    return row_after(table, pending, s, w);
}

// The claim half for one lane, from one thread. keep() is the keep-old
// decision on the slot's row as the store must see it (read through the
// store whose commits may not have landed yet); it runs only for a
// storable lane under prefer_deep.
template <class Keep>
__device__ __forceinline__ void store_claim(const Pending& mine, uint32_t nmask, int lane,
                                            bool mask, uint32_t h1, int32_t h2, int32_t score,
                                            int32_t depth, int32_t flag, int32_t move,
                                            int32_t gen, bool prefer_deep, Keep keep) {
    int slot = -1;
    if (mask && storable(score) && !(prefer_deep && keep())) slot = (int)(h1 & nmask);
    int4* st = mine.staged + (int64_t)lane * mine.stride;
    if (slot >= 0) {
        __stcg(st, store_row(h2, score, depth, flag, move, gen));
        atomicMax(mine.claims + slot, lane);
    }
    __stcg(&st[1].x, slot);
}

// The commit half for one lane, from one thread, once every claim of its
// store is in.
__device__ __forceinline__ void store_commit(int4* table, const Pending& mine, int lane) {
    const int4* st = mine.staged + (int64_t)lane * mine.stride;
    const int slot = __ldcg(&st[1].x);
    if (slot < 0 || __ldcg(mine.claims + slot) != lane) return;
    __stcg(table + slot, __ldcg(st));
    __threadfence();
    atomicExch(mine.claims + slot, -1);
}

}  // namespace tt
