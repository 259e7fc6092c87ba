// One lane's search step and its table stores as warp-cooperative device
// functions: the reference's _step_lane (fishnet_tpu/ops/search.py:343)
// and the claim halves of its TT runner's stores (:903-980; K6's body,
// tt.cuh), for the segment kernel K11 (search_segment.cu).
//
// The step follows the port's batched `_step` (ops/search.py) line for
// line: ENTER (the board rules, the keys, the repetition scan over the
// path and the game history, the leaf eval, futility, stand-pat, the TT
// cutoff, move ordering with the TT move, null-move eligibility, the
// entered row), RETURN (the fold into the parent, the null-move and LMR
// re-search handling, the PV row) and TRYMOVE (killers and history,
// mate/stalemate, LMR, the null child, make-move, the child's row,
// accumulators and depth). One warp serves one lane: every thread computes
// the lane's scalars (the same values, read from the warp's shared copies
// of the rows), the board rules, move generator, make-move and the eval run
// as K8-K10's and K2's warp bodies (K2 on the lane's accumulator pair,
// staged in shared memory), the child accumulators (K3) as its body. The
// net is a template parameter (its `Net` traits): a board768 net carries
// accumulators down the stack (K3) and evaluates a leaf from them (K2); a
// king-bucketed or an imported Stockfish net
// evaluates every leaf from its board (K12's warp body, or K13's units
// spread over the launch's warps: sf_post, sf_own, sf_help) and leaves
// the state's accumulator table as it is, as the reference does.
// The variant is a second template parameter V (a VARIANT_* id): the
// board rules, keys, move generator and make-move take their variant
// instantiations, a node at the variant's game end (node_rules' term) is
// a leaf worth a mate score or a draw and is never stored in the table,
// antichess turns the null move off and scores a node without a move as a
// win, and crazyhouse's move lists (the state's `moves` rows and the
// warp's staged list) are MAX_MOVES_ZH wide where the others' are
// MAX_MOVES (rules::max_moves<V>; the reference's _step_lane under its
// static variant flag, its tables at max_moves_for(variant)). In atomic a
// capture's blast outruns K3's four change slots, so there, as in the
// reference, a board768 leaf is a full eval: the warp refreshes the lane's
// pair from its board in K1's order (nnue.cuh features_768_warp and
// refresh_column, four columns a thread) into shared memory, K2's body
// reads it, and no accumulator of the state is read or written.
// The rows the step reads are staged in shared memory before any write,
// and the writes land in the reference's order, each under its
// mask: the entered row (ply0), the folded parent (parent0), the PV row,
// the TRYMOVE row (ply1), the child's depth word (nply), then the child's
// board row and accumulators.
//
// Lane state (rows, history counters, accumulators) is read with plain
// loads: a lane's warp writes it in the same launch. The table, the staged
// rows and the cross-block words (claims, flags) go through L2 (ld/st.cg,
// an acquire load of a claim word, and atomics).
// Constants come from search_consts.cuh and rules_tables.cuh, which
// kernels.build() writes from the plain versions' modules.
#pragma once
#include "movegen.cuh"
#include "nnue.cuh"
#include "search_consts.cuh"
#include "tt.cuh"

namespace search {

using namespace consts;
using rules::FULL_MASK;
using rules::WARP;

using rules::BT_CAST;
using rules::BT_EP;
using rules::BT_EXTRA;
using rules::BT_HM;
using rules::BT_PH1;
using rules::BT_PH2;
using rules::BT_STM;
using rules::BT_W;
constexpr int L1 = nnue::L1;  // a board768 net's accumulator width
// a PV row is staged in two words a thread; a lane's scratch holds its
// two stores' staged rows and slots (four int4s: the interior store's row
// and slot, then the leaf store's); a board768 accumulator pair is four
// columns a thread
static_assert(SEGMENT_MAX_PLY <= 2 * WARP && SEGMENT_SCRATCH == 16, "K11 layout");
static_assert(2 * L1 == 4 * WARP, "K3's body: four columns a thread");

// the body calls and live lane-steps a launch counts (kernels.py K11_COUNTERS)
// and the table reads that went through a store's pending row
enum Body { B_FORWARD, B_ACC_UPDATE, B_HASH, B_PROBE, B_STORE, B_NODE_RULES, B_MOVEGEN,
            B_MAKE_MOVE, B_EVALUATE, B_EVALUATE_SF, B_REFRESH, B_LIVE, B_PENDING, N_BODY };

// the nets K11 takes
constexpr int BOARD768 = 0;  // incremental accumulators: K2's and K3's bodies
constexpr int KING = 1;  // a king-bucketed NnueParams net: K12's body
constexpr int STOCKFISH = 2;  // an imported Stockfish net: K13's body
struct NetF32 {
    using Acc = float;
    using Weights = nnue::Net<float, float, float>;
    static constexpr int KIND = BOARD768;
};
struct NetI8 {
    using Acc = int32_t;
    using Weights = nnue::Net<int16_t, int8_t, int32_t>;
    static constexpr int KIND = BOARD768;
};
struct NetKbF32 {
    using Acc = float;
    using Weights = nnue::Net<float, float, float>;
    static constexpr int KIND = KING;
};
struct NetKbI8 {
    using Acc = int32_t;
    using Weights = nnue::Net<int16_t, int8_t, int32_t>;
    static constexpr int KIND = KING;
};
struct NetSf {
    using Acc = float;
    using Weights = nnue::SfNet;
    static constexpr int KIND = STOCKFISH;
};
// bf16 weights (models/nnue.py cast_params), f32 accumulators and
// arithmetic: the bodies widen each weight at its load
struct NetBf16 {
    using Acc = float;
    using Weights = nnue::Net<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>;
    static constexpr int KIND = BOARD768;
};
struct NetKbBf16 {
    using Acc = float;
    using Weights = nnue::Net<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>;
    static constexpr int KIND = KING;
};

// A segment's arguments: the state's nine tables ((B, ...) contiguous,
// ops/search.py SearchState), the net, the key tables, the table (null
// for none) with its two stores' claim words and staged rows, and the
// launch's scratch and outputs.
template <class Net>
struct Segment {
    int32_t* bt;  // (B, P+1, BT_W)
    int32_t* nt;  // (B, P+1, NT_W)
    int32_t* lane;  // (B, LN_W)
    const int32_t* hist_hash;  // (B, H, 2)
    const int32_t* hist_halfmove;  // (B, H)
    int32_t* moves;  // (B, P, max_moves<V>()) for the variant V of the launch
    int32_t* hist;  // (B, HIST_SIZE)
    int32_t* pv;  // (B, P, P)
    typename Net::Acc* acc;  // (B, P+1, 2, L1): read and written on board768 only
    typename Net::Weights net;
    const uint32_t* z1;
    const uint32_t* z2;
    int4* table;  // (n, 4) or null
    uint32_t nmask;  // n - 1
    tt::Pending interior, leaf;  // claim words (n,) each; rows in the scratch
    const int32_t* gen_lanes;  // (B,) or null: every lane stores generation `gen`
    int gen;
    int* scratch;  // (B, SEGMENT_SCRATCH): the stores' staged rows; then three live flags
    // an imported Stockfish net's evals spread over the warps (sf_post,
    // sf_own, sf_help): SF_CTL_W control words (three job counts, then
    // three counts of the warps still stepping, each in rotation by step),
    // then B job records of SF_JOB_W words, then B eval buffers
    // (nnue::sf_buffer_floats); null on the other nets
    int* sf_ctl;
    int* sf_jobs;
    float* sf_buf;
    unsigned long long* body_calls;  // (N_BODY,)
    int32_t* summary;  // (B+1, 4)
    int B, P, H, steps;
    bool pruning, deep_tt, prefer_deep;
    bool one_cluster;  // the grid is one cluster: its barrier is the cluster's
};

// A board768 leaf's accumulator pair, staged for K2's body (in atomic
// refreshed from the board by K1's body): it shares its room with K9's
// scratch, which the step fills only after the eval.
struct LeafPair {
    union {
        float f32[2 * L1];
        int32_t i32[2 * L1];
    };
};
__device__ __forceinline__ float* pair_of(LeafPair& p, float) { return p.f32; }
__device__ __forceinline__ int32_t* pair_of(LeafPair& p, int32_t) { return p.i32; }

// The rows a lane's step reads, staged by its warp (the move lists as
// wide as the variant's).
template <int V>
struct WarpRows {
    int btr[BT_W];  // the ply row; after ENTER, with its path hash (btE)
    int btp[BT_W];  // the parent's row
    int child[BT_W];  // the child's row
    int ntr[NT_W];  // the ply's node row; after ENTER, the entered row (ntE)
    int ntp[NT_W];  // the parent's node row; after RETURN, the folded row (ntP)
    int gen[rules::max_moves<V>()];  // the ordered move list ENTER generates
    int chg[12];  // the child's piece changes: codes, squares, signs
    union {
        rules::MoveList<V> list;  // K9's scratch
        LeafPair pair;  // K2's input, staged before K9 runs
    };
    nnue::Features feat;  // K12's and K13's feature lists (atomic's board768 leaf: K1's)
};

// Non-capture, non-promotion move (a crazyhouse drop is quiet; en passant
// reads as quiet, which only costs ordering).
template <int V>
__device__ __forceinline__ bool is_quiet(int move, const int* board) {
    if constexpr (V == VARIANT_CRAZYHOUSE) {
        if (move & rules::DROP_FLAG) return true;
    }
    return board[(move >> 6) & 63] == 0 && ((move >> 12) & 7) == 0;
}

// the generation a lane's stores write (and prefer_deep keeps)
template <class Net>
__device__ __forceinline__ int lane_gen(const Segment<Net>& a, int lane) {
    return a.gen_lanes ? a.gen_lanes[lane] : a.gen;
}

// The runner's first store: a lane parked in RETURN whose interior node
// finished (not illegal, not a TT-sourced value of depth -1, within its
// budget) stores the node's value with its bound flag and best move. Its
// claim half: the keep-old decision reads through the last step's leaf
// store, whose commits may still be landing.
template <class Net, int V>
__device__ void interior_store_claim(const Segment<Net>& a, int lane, WarpRows<V>& s, int t,
                                     unsigned* calls) {
    const int32_t* L = a.lane + (int64_t)lane * LN_W;
    const int ret = L[LN_RET], retd = L[LN_RETD];
    const bool mask = L[LN_MODE] == MODE_RETURN && ret != ILLEGAL && retd >= 1
                      && L[LN_NODES] < L[LN_BUDGET];
    uint32_t h1 = 0, h2 = 0;
    int flag = 0, move = 0;
    if (mask) {
        const int ply = L[LN_PLY];
        const int64_t row = (int64_t)lane * (a.P + 1) + ply;
        const int32_t* ntrow = a.nt + row * NT_W;
        for (int j = t; j < BT_W; j += WARP) s.btr[j] = a.bt[row * BT_W + j];
        __syncwarp();
        tt::zobrist_keys_warp<V>(s.btr, s.btr[BT_STM], s.btr[BT_EP], &s.btr[BT_CAST],
                                 &s.btr[BT_EXTRA], a.z1, a.z2, t, h1, h2);
        flag = ret >= ntrow[NT_BETA] ? FLAG_LOWER
                                     : (ret <= ntrow[NT_ALPHA0] ? FLAG_UPPER : FLAG_EXACT);
        move = ntrow[NT_BMOVE];
        __syncwarp();  // the rows are free for the warp's next lane
        if (t == 0) calls[B_HASH] += 1;
    }
    if (t == 0) {
        const int gen = lane_gen(a, lane), depth = max(retd, 0);
        bool through = false;
        tt::store_claim(a.interior, a.nmask, lane, mask, h1, (int32_t)h2, ret, depth, flag, move,
                        gen, a.prefer_deep, [&] {
                            return tt::keep_old(tt::read_row(a.table, a.leaf, h1 & a.nmask,
                                                             through), gen, depth);
                        });
        calls[B_STORE] += mask;
        calls[B_PENDING] += through;
    }
}

// The runner's leaf store's claim half (depth-0 EXACT, no move), from
// thread 0 of the lane's warp; keep: the keep-old decision, made on the
// row the probe read (the same slot, through the interior store).
template <class Net>
__device__ __forceinline__ void leaf_store_claim(const Segment<Net>& a, int lane, bool mask,
                                                 uint32_t h1, uint32_t h2, int score, bool keep,
                                                 unsigned* calls) {
    tt::store_claim(a.leaf, a.nmask, lane, mask, h1, (int32_t)h2, score, 0, FLAG_EXACT, -1,
                    lane_gen(a, lane), a.prefer_deep, [&] { return keep; });
    calls[B_STORE] += mask;
}

// ---------------------------------- K13's units over K11's warps (Stockfish)
//
// A lane that enters a node on a Stockfish net posts its eval as a job
// (sf_post: its feature lists, stm and bucket, in job record k, k counted
// out of the step's job count), runs the rest of its ENTER up to and with
// K9, then works on its own job's units and waits for the rest (sf_own).
// Every warp that has stepped all its lanes claims units of any posted job
// (sf_help) until no warp is still stepping; only then does it enter the
// step's barrier. A unit is claimed by an atomic add to its job's counter
// and never waits; the fc0 units are claimed only once every
// feature-transform unit is done, and the owner waits for its job with
// acquire loads. Every block of the launch is resident (one cluster, or
// the cooperative grid), so a claimed unit always runs to
// its end and an owner's wait ends: the owner itself claims whatever
// nobody else has. A unit's writes go through L2 (st.cg), are fenced, and
// only then counted; readers load through L2 (ld.cg) after an acquire
// load, or after a relaxed load and a fence. A helper reads a job's
// stamp with acquire order before its counters, so it never decides on
// counters left from the record's use in an earlier step.
constexpr int SF_JOB_READY = 0;  // the step (+1) whose job the record holds
constexpr int SF_JOB_STM = 1;
constexpr int SF_JOB_BUCKET = 2;
constexpr int SF_JOB_FT_NEXT = 4;  // feature-transform units claimed
constexpr int SF_JOB_FT_DONE = 5;  // and done
constexpr int SF_JOB_FC_NEXT = 6;  // fc0 units claimed
constexpr int SF_JOB_FC_DONE = 7;  // and done
constexpr int SF_JOB_LO = 8;
constexpr int SF_JOB_N = 9;
constexpr int SF_JOB_IDX = 16;  // the two perspectives' feature rows, 64 each
static_assert(SF_JOB_IDX + 128 == SF_JOB_W && SF_CTL_W >= 6, "K11's job layout");
// cycles after which a wait is a broken invariant: trap rather than hang
constexpr int64_t SF_WAIT_LIMIT = 20'000'000'000LL;

template <class Net>
__device__ __forceinline__ int* sf_job(const Segment<Net>& a, int k) {
    return a.sf_jobs + (int64_t)k * SF_JOB_W;
}
template <class Net>
__device__ __forceinline__ float* sf_buffer(const Segment<Net>& a, int k) {
    return a.sf_buf + (int64_t)k * nnue::sf_buffer_floats(a.net.l1);
}

// Thread 0: wait until *p reaches `want`, with acquire order.
__device__ __forceinline__ void sf_wait(const int* p, int want) {
    const long long t0 = clock64();
    while (tt::load_acquire(p) < want) {
        __nanosleep(32);
        if (clock64() - t0 > SF_WAIT_LIMIT) __trap();
    }
}

// A unit's end: its writes fenced, then counted (the warp).
__device__ __forceinline__ void sf_unit_done(int* counter, int t) {
    __threadfence();
    __syncwarp();
    if (t == 0) atomicAdd(counter, 1);
}

// Thread 0 claims the next unit of a counter; the warp gets its index.
__device__ __forceinline__ int sf_claim(int* next, int t) {
    int u = 0;
    if (t == 0) u = atomicAdd(next, 1);
    return __shfl_sync(FULL_MASK, u, 0);
}

// Post the eval of the board whose lists are f (the warp) as a job of
// step `step` → its record's index.
template <class Net>
__device__ int sf_post(const Segment<Net>& a, int step, const nnue::Features& f, int stm,
                       int bucket, int t) {
    int k = 0;
    if (t == 0) k = atomicAdd(a.sf_ctl + step % 3, 1);
    k = __shfl_sync(FULL_MASK, k, 0);
    int* job = sf_job(a, k);
    const int n = f.n[0];
    for (int j = t; j < n; j += WARP) {
        __stcg(job + SF_JOB_IDX + j, f.idx[0][j]);
        __stcg(job + SF_JOB_IDX + 64 + j, f.idx[1][j]);
    }
    if (t < 4) __stcg(job + SF_JOB_FT_NEXT + t, 0);
    if (t == 0) {
        __stcg(job + SF_JOB_STM, stm);
        __stcg(job + SF_JOB_BUCKET, bucket);
        __stcg(job + SF_JOB_LO, f.lo[0]);
        __stcg(job + SF_JOB_N, n);
    }
    __threadfence();
    __syncwarp();
    if (t == 0) atomicExch(job + SF_JOB_READY, step + 1);
    return k;
}

// The owner's part of its job k (the warp, with the board's lists f):
// its own claims of the feature-transform units, the wait for the rest,
// the same for the fc0 units, then the close. Returns the eval in every
// thread.
template <class Net>
__device__ float sf_own(const Segment<Net>& a, int k, const nnue::Features& f, int stm,
                        int bucket, int t) {
    int* job = sf_job(a, k);
    float* x = sf_buffer(a, k);
    float* chains = x + nnue::sf_x_stride(a.net.l1);
    const int units = nnue::sf_ft_units(a.net);
    for (int u; (u = sf_claim(job + SF_JOB_FT_NEXT, t)) < units;) {
        nnue::sf_ft_unit(f, stm, u, a.net, x, t);
        sf_unit_done(job + SF_JOB_FT_DONE, t);
    }
    if (t == 0) sf_wait(job + SF_JOB_FT_DONE, units);
    __syncwarp();
    for (int i; (i = sf_claim(job + SF_JOB_FC_NEXT, t)) < nnue::SF_FC0_UNITS;) {
        nnue::sf_fc0_unit(bucket, i, a.net, x, chains, t);
        sf_unit_done(job + SF_JOB_FC_DONE, t);
    }
    if (t == 0) sf_wait(job + SF_JOB_FC_DONE, nnue::SF_FC0_UNITS);
    __syncwarp();
    return nnue::sf_finish(f, stm, bucket, a.net, chains, t);
}

// A job's control word read without ordering (coherent at the card's
// scope); a reader that acts on it fences before it reads the job's data.
__device__ __forceinline__ int load_relaxed(const int* p) {
    int v;
    asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

// A warp that has stepped all its lanes in step `step`: claim units of
// the step's posted jobs until no warp is still stepping (every job is
// then done). The warp reads 32 jobs' control words at once, a job a
// thread, and tries the claimable ones from a point that differs from
// warp to warp, so the helpers spread over the jobs; s.feat holds a
// claimed job's lists.
template <class Net, int V>
__device__ void sf_help(const Segment<Net>& a, int step, WarpRows<V>& s, int t) {
    int* const posted = a.sf_ctl + step % 3;
    int* const stepping = a.sf_ctl + 3 + step % 3;
    const int stamp = step + 1, units = nnue::sf_ft_units(a.net);
    const int spread = (int)((blockIdx.x * blockDim.x + threadIdx.x) / WARP) % WARP;
    if (t == 0) atomicSub(stepping, 1);
    int first = 0;  // the jobs before it have every unit claimed
    const long long t0 = clock64();
    for (;;) {
        const int n_jobs = load_relaxed(posted);
        int k = -1, kind = 0, u = 0;  // kind 1: a feature-transform unit, 2: an fc0 unit
        for (int j0 = first; j0 < n_jobs && !kind; j0 += WARP) {
            const int j = j0 + t;
            bool ft = false, fc = false, spent = false;
            if (j < n_jobs) {
                const int* job = sf_job(a, j);
                // acquire: the counters read next are at least the post's resets
                const int ready = tt::load_acquire(job + SF_JOB_READY);
                const int ft_next = load_relaxed(job + SF_JOB_FT_NEXT);
                const int ft_done = load_relaxed(job + SF_JOB_FT_DONE);
                const int fc_next = load_relaxed(job + SF_JOB_FC_NEXT);
                if (ready == stamp) {
                    ft = ft_next < units;
                    fc = ft_done == units && fc_next < nnue::SF_FC0_UNITS;
                    spent = fc_next >= nnue::SF_FC0_UNITS;
                }
            }
            if (j0 == first) {  // every unit of a leading run of jobs is claimed
                const unsigned open = ~__ballot_sync(FULL_MASK, spent);
                first += open ? __ffs(open) - 1 : WARP;
            }
            for (unsigned ok = __ballot_sync(FULL_MASK, ft || fc); ok && !kind;) {
                const unsigned r = spread ? (ok >> spread) | (ok << (WARP - spread)) : ok;
                const int pick = (__ffs(r) - 1 + spread) & (WARP - 1);
                int c = -1;
                if (t == pick) {
                    int* job = sf_job(a, j);
                    c = atomicAdd(job + (ft ? SF_JOB_FT_NEXT : SF_JOB_FC_NEXT), 1);
                    if (c >= (ft ? units : nnue::SF_FC0_UNITS)) c = -1;
                    if (c >= 0 && fc) c += units;
                }
                c = __shfl_sync(FULL_MASK, c, pick);
                if (c >= 0) k = j0 + pick, kind = c < units ? 1 : 2, u = c < units ? c : c - units;
                ok &= ~(1u << pick);
            }
        }
        if (kind) {
            __threadfence();  // the job's lists, or its products, were written before its counts
            int* job = sf_job(a, k);
            float* x = sf_buffer(a, k);
            if (kind == 1) {
                const int stm = __ldcg(job + SF_JOB_STM), n = __ldcg(job + SF_JOB_N);
                const int p = (u & 1) ? 1 - stm : stm;
                for (int j = t; j < n; j += WARP) {
                    s.feat.idx[p][j] = __ldcg(job + SF_JOB_IDX + 64 * p + j);
                }
                if (t == 0) {
                    s.feat.lo[p] = __ldcg(job + SF_JOB_LO);
                    s.feat.n[p] = n;
                }
                __syncwarp();
                nnue::sf_ft_unit(s.feat, stm, u, a.net, x, t);
                sf_unit_done(job + SF_JOB_FT_DONE, t);
            } else {
                nnue::sf_fc0_unit(__ldcg(job + SF_JOB_BUCKET), u, a.net, x,
                                  x + nnue::sf_x_stride(a.net.l1), t);
                sf_unit_done(job + SF_JOB_FC_DONE, t);
            }
            continue;
        }
        if (load_relaxed(stepping) == 0) return;
        __nanosleep(64);
        if (clock64() - t0 > SF_WAIT_LIMIT) __trap();
    }
}

// One step of one lane (the port's `_step`, its TT-runner arguments from
// the probe made here, with the window ENTER gives the node), written into
// the state in place; with a table, then the claim half of the leaf store
// (depth-0 EXACT under the pre-step keys). The probe reads through the
// interior store, whose commits may still be landing (the slot's claim
// word right after the hash, its row at the probe), and the leaf store's
// keep-old decision is made on the probed row. Returns whether the lane
// is still live. Every thread of the warp calls it; branches are
// warp-uniform.
template <class Net, int V>
__device__ bool step_lane(const Segment<Net>& a, int lane, WarpRows<V>& s, int t,
                          unsigned* calls, int step) {
    using Acc = typename Net::Acc;
    constexpr int MM = rules::max_moves<V>();  // the variant's move-list width
    static_assert(MM % WARP == 0, "the TT move's search reads the list a warp at a time");
    int32_t* L = a.lane + (int64_t)lane * LN_W;
    const int P = a.P, P1 = P + 1;
    const int mode0 = L[LN_MODE];
    if (mode0 == MODE_DONE) {
        // a parked lane: the step only clears its leaf mark
        const int research = L[LN_RESEARCH] != 0;
        __syncwarp();
        if (t == 0) {
            L[LN_SMARK] = 0;
            L[LN_SVAL] = 0;
            L[LN_RESEARCH] = research;
        }
        if (a.table && t == 0) leaf_store_claim(a, lane, false, 0, 0, 0, false, calls);
        return false;
    }
    if (t == 0) calls[B_LIVE] += 1;
    const int ply0 = L[LN_PLY];
    int nodes = L[LN_NODES];
    const int p0 = ply0, pp = max(p0 - 1, 0);
    int32_t* nt = a.nt + (int64_t)lane * P1 * NT_W;
    int32_t* bt = a.bt + (int64_t)lane * P1 * BT_W;
    int32_t* mv = a.moves + (int64_t)lane * P * MM;
    int32_t* pv = a.pv + (int64_t)lane * P * P;
    Acc* acc = a.acc + (int64_t)lane * P1 * 2 * L1;  // board768 only
    if (t < NT_W) {
        s.ntr[t] = nt[p0 * NT_W + t];
        s.ntp[t] = nt[pp * NT_W + t];
    }
    for (int j = t; j < BT_W; j += WARP) {
        s.btr[j] = bt[p0 * BT_W + j];
        s.btp[j] = bt[pp * BT_W + j];
    }
    // the move a fold credits to the parent, read before any write
    const int tried = mv[pp * MM
                         + min(max(nt[pp * NT_W + NT_MIDX] - 1, 0), MM - 1)];
    const int budget = L[LN_BUDGET];
    int ret = L[LN_RET], ret_depth = L[LN_RETD];
    const int root_alpha = L[LN_RALPHA], root_beta = L[LN_RBETA];
    int root_score = L[LN_RSCORE], root_move = L[LN_RMOVE];
    bool research = L[LN_RESEARCH] != 0;
    __syncwarp();
    const int ntp0_bmove = s.ntp[NT_BMOVE];

    // ---------------------------------------------------------- ENTER
    const bool enter = mode0 == MODE_ENTER;
    const bool root = ply0 == 0;
    bool expand = false, leaf_store = false, leaf_keep = false;
    int store_val = 0, mode = mode0;
    uint32_t h1 = 0, h2 = 0;
    if (enter) {
        const int stm = s.btr[BT_STM];
        // a Stockfish net's eval goes out as a job first: other warps may
        // run its units while this one runs K8-K9 (sf_own waits for it below)
        int sf_k = 0, sf_bucket = 0;
        if constexpr (Net::KIND == STOCKFISH) {
            nnue::features_warp(s.btr, t, s.feat);
            sf_bucket = nnue::output_bucket(s.feat);
            sf_k = sf_post(a, step, s.feat, stm, sf_bucket, t);
        }
        bool illegal_raw, checked;
        int term;
        rules::node_rules_warp<V>(s.btr, stm, &s.btr[BT_EXTRA], t, &illegal_raw, &checked,
                                  &term);  // K8
        const bool parent_illegal = illegal_raw && !root;
        const int depth_left = s.ntr[NT_DL];
        const bool parent_null = s.ntp[NT_NULL] == 2 && !root;
        const bool over_budget = nodes >= budget;
        const int hm = s.btr[BT_HM];
        const bool fifty = hm >= FIFTY_PLIES;

        // twofold repetition along the search path and against the
        // pre-root game history, through unbroken reversible-move chains
        tt::zobrist_keys_warp<V>(s.btr, stm, s.btr[BT_EP], &s.btr[BT_CAST], &s.btr[BT_EXTRA],
                                 a.z1, a.z2, t, h1, h2);  // K4
        // the probe's slot's interior claim word, early (its row is read at the probe)
        const int claim = a.table ? tt::load_acquire(a.interior.claims + (h1 & a.nmask)) : -1;
        bool rep = false;
        for (int k = t; k < ply0; k += WARP) {
            const int32_t* r = bt + k * BT_W;
            rep |= r[BT_PH1] == (int32_t)h1 && r[BT_PH2] == (int32_t)h2
                   && hm - r[BT_HM] == ply0 - k;
        }
        const int32_t* hh = a.hist_hash + (int64_t)lane * a.H * 2;
        const int32_t* hhm = a.hist_halfmove + (int64_t)lane * a.H;
        for (int j = t; j < a.H; j += WARP) {
            rep |= hh[2 * j] == (int32_t)h1 && hh[2 * j + 1] == (int32_t)h2
                   && hm - hhm[j] == ply0 + a.H - j;
        }
        const bool draw = fifty || __any_sync(FULL_MASK, rep);
        const int entry_alpha = root ? root_alpha : -s.ntp[NT_BETA];
        const int entry_beta = root ? root_beta
                                    : (parent_null ? 1 - s.ntp[NT_BETA] : -s.ntp[NT_ALPHA]);
        const bool in_qs = depth_left <= 0;

        // leaf value: on board768 K2's body (the warp) on the lane's
        // accumulator pair staged in shared memory, in atomic on the pair
        // K1's body refreshes there (four columns a thread); on a
        // king-bucketed net K12's full eval (the warp); on a Stockfish net
        // K13's units, after K9 (sf_own)
        float ev = 0.0f;
        if constexpr (Net::KIND == BOARD768) {
            const int pieces = __popc(__ballot_sync(FULL_MASK, s.btr[t] > 0))
                               + __popc(__ballot_sync(FULL_MASK, s.btr[t + WARP] > 0));
            const int bucket = min(max((pieces - 1) / 4, 0), 7);
            Acc* pair = pair_of(s.pair, Acc{});
            if constexpr (V == VARIANT_ATOMIC) {
                nnue::features_768_warp(s.btr, t, s.feat);
                for (int i = 0; i < 4; ++i) {
                    const int col = t + WARP * i;
                    const int persp = col / L1, c = col % L1;
                    pair[col] = (Acc)nnue::wide(a.net.ft_b[c])
                                + nnue::refresh_column<typename Net::Weights::Ft, Acc>(
                                      s.feat, persp, a.net.ft_w, L1, c);
                }
            } else {
                const Acc* src = acc + p0 * 2 * L1;
                for (int i = 0; i < 4; ++i) pair[t + WARP * i] = src[t + WARP * i];
            }
            __syncwarp();
            ev = nnue::forward_warp(pair + stm * L1, pair + (1 - stm) * L1, bucket, a.net.head,
                                    t);
            __syncwarp();  // the pair's room is K9's scratch next
        } else if constexpr (Net::KIND == KING) {
            nnue::features_warp(s.btr, t, s.feat);
            ev = nnue::evaluate_warp(s.feat, stm, nnue::output_bucket(s.feat), a.net, t);
        }

        rules::Ordering o;
        o.hist = a.hist + (int64_t)lane * HIST_SIZE;
        o.killer0 = s.ntr[NT_K0];
        o.killer1 = s.ntr[NT_K1];
        int count, noisy;
        rules::generate_moves_warp<V>(s.btr, stm, s.btr[BT_EP], &s.btr[BT_CAST],
                                      &s.btr[BT_EXTRA], o, t, s.list, s.gen, &count,
                                      &noisy);  // K9
        if constexpr (Net::KIND == STOCKFISH) ev = sf_own(a, sf_k, s.feat, stm, sf_bucket, t);
        ev = __shfl_sync(FULL_MASK, ev, 0);
        const int static_val = min(max((int)ev, -MATE_BOUND), MATE_BOUND);
        // a variant's game end ends the node at once, over the draws
        const bool vterm = term != rules::TERM_NONE;
        const bool ends = draw || vterm;
        const int leaf_val = vterm ? (term == rules::TERM_LOSS ? ply0 - MATE
                                      : (term == rules::TERM_WIN ? MATE - ply0 : DRAW))
                                   : (draw ? DRAW : static_val);
        const bool quiet_node = noisy == 0;
        const bool window_ok_a = entry_alpha > -MATE_BOUND && entry_alpha < MATE_BOUND;
        bool qs_like = in_qs;
        if (a.pruning) {  // futility at frontier nodes
            const int f_margin = depth_left == 1 ? FUTILITY_MARGIN_1 : FUTILITY_MARGIN_2;
            qs_like = qs_like
                      || (depth_left <= FUTILITY_DEPTH && !(in_qs || checked || root)
                          && static_val + f_margin <= entry_alpha && window_ok_a);
        }
        const bool is_leaf = ends || over_budget || ply0 >= P || (qs_like && quiet_node)
                             || (in_qs && leaf_val >= entry_beta);  // stand-pat cut
        // TT cutoff: a leaf return with the stored score; never at the
        // root, never on a fifty-move or repetition draw or a variant's end
        bool use_tt = false, to_return, no_store;
        int tt_score = 0, tt_move = -1;
        if (a.table) {
            bool usable;
            const int4 row = tt::row_after(a.table, a.interior, h1 & a.nmask, claim);
            tt::probe_row(row, (int32_t)h2, depth_left, entry_alpha, entry_beta, true, a.deep_tt,
                          usable, tt_score, tt_move);  // K5
            leaf_keep = tt::keep_old(row, lane_gen(a, lane), 0);
            if (t == 0) calls[B_PENDING] += claim >= 0;
            use_tt = usable && !(root || ends);
            to_return = parent_illegal || is_leaf || use_tt;
            no_store = parent_illegal || ends || use_tt;
        } else {
            to_return = parent_illegal || is_leaf;
            no_store = parent_illegal || ends;
        }
        expand = !to_return;
        // quiet static leaves, for the runner's depth-0 EXACT store
        leaf_store = is_leaf && !no_store && quiet_node;
        store_val = leaf_store ? leaf_val : 0;

        // the stored move to the front of the list (not in quiescence)
        if (tt_move >= 0 && !qs_like) {
            int at = -1;
            for (int j0 = 0; j0 < MM && at < 0; j0 += WARP) {
                const unsigned hit = __ballot_sync(FULL_MASK, s.gen[j0 + t] == tt_move);
                if (hit) at = j0 + __ffs(hit) - 1;
            }
            if (at >= 0) {
                __syncwarp();
                if (t == 0) {
                    s.gen[at] = s.gen[0];
                    s.gen[0] = tt_move;
                }
                __syncwarp();
            }
        }

        int null_v = 0;
        // null-move eligibility (never in antichess, whose captures are forced)
        if (a.pruning && V != VARIANT_ANTICHESS) {
            const int lo = stm * 6 + 2, hi = stm * 6 + 5;
            const int c0 = s.btr[t], c1 = s.btr[t + WARP];
            const bool nonpawn = __any_sync(FULL_MASK, (c0 >= lo && c0 <= hi)
                                                       || (c1 >= lo && c1 <= hi));
            null_v = depth_left >= NULL_MIN_DEPTH && !(checked || parent_null || root)
                     && static_val >= entry_beta && entry_beta < MATE_BOUND
                     && entry_beta > -MATE_BOUND && nonpawn;
        }

        // the entered row: every field on expansion, pv_len and the check
        // flag on every entry (ops/search.py _FM_EXPAND, _FM_ENTER)
        __syncwarp();
        if (t == 0) {
            if (expand) {
                s.ntr[NT_COUNT] = qs_like ? noisy : count;
                s.ntr[NT_MIDX] = 0;
                s.ntr[NT_SEARCHED] = 0;
                s.ntr[NT_ALPHA] = qs_like ? max(entry_alpha, leaf_val) : entry_alpha;
                s.ntr[NT_ALPHA0] = entry_alpha;
                s.ntr[NT_BETA] = entry_beta;
                s.ntr[NT_BEST] = qs_like ? leaf_val : -INF;
                s.ntr[NT_BMOVE] = -1;
                s.ntr[NT_NULL] = null_v;
                s.ntr[NT_LASTRED] = 0;
            }
            s.ntr[NT_PVLEN] = 0;
            s.ntr[NT_INCHECK] = checked;
            s.btr[BT_PH1] = (int32_t)h1;
            s.btr[BT_PH2] = (int32_t)h2;
        }
        __syncwarp();
        if (t < NT_W) nt[p0 * NT_W + t] = s.ntr[t];
        if (t == 0) {
            bt[p0 * BT_W + BT_PH1] = (int32_t)h1;
            bt[p0 * BT_W + BT_PH2] = (int32_t)h2;
        }
        if (expand) {
            for (int j = t; j < MM; j += WARP) mv[min(p0, P - 1) * MM + j] = s.gen[j];
        }
        __syncwarp();

        if (to_return) {  // a TT-sourced value is already stored: depth -1
            ret = parent_illegal ? ILLEGAL : (use_tt ? tt_score : leaf_val);
            ret_depth = use_tt ? -1 : 0;
        }
        nodes += !parent_illegal;
        mode = to_return ? MODE_RETURN : MODE_TRYMOVE;
        if (t == 0) {
            calls[B_NODE_RULES] += 1;
            calls[B_HASH] += 1;
            calls[Net::KIND == BOARD768 ? B_FORWARD
                  : (Net::KIND == KING ? B_EVALUATE : B_EVALUATE_SF)] += 1;
            calls[B_REFRESH] += Net::KIND == BOARD768 && V == VARIANT_ATOMIC;
            calls[B_MOVEGEN] += 1;
            calls[B_PROBE] += a.table != nullptr;
        }
    }

    // --------------------------------------------------------- RETURN
    const bool ret_m = mode == MODE_RETURN;
    const bool fold = ret_m && !root;
    bool better = false;
    if (fold) {
        const int v = -ret;
        const bool is_null_ret = s.ntp[NT_NULL] == 2;
        const bool legal_fold = ret != ILLEGAL;
        const bool null_cut = is_null_ret && legal_fold && v >= s.ntp[NT_BETA] && v < MATE_BOUND;
        const bool real_fold = legal_fold && !is_null_ret;
        const bool need_rs = real_fold && s.ntp[NT_LASTRED] > 0 && v > s.ntp[NT_ALPHA];
        const bool counted = real_fold && !need_rs;
        better = counted && v > s.ntp[NT_BEST];
        const int best_p = (better || null_cut) ? v : s.ntp[NT_BEST];
        const int alpha_p = max(s.ntp[NT_ALPHA], best_p);
        const int searched = s.ntp[NT_SEARCHED] + 1;
        const int pv_len = min(s.ntr[NT_PVLEN] + 1, P);  // the child's post-ENTER pv_len
        research = need_rs;
        __syncwarp();
        if (t == 0) {
            s.ntp[NT_BEST] = best_p;
            if (better) {
                s.ntp[NT_BMOVE] = tried;
                s.ntp[NT_PVLEN] = pv_len;
            }
            s.ntp[NT_ALPHA] = alpha_p;
            if (counted) s.ntp[NT_SEARCHED] = searched;
            if (is_null_ret) s.ntp[NT_NULL] = 0;
        }
        __syncwarp();
        if (t < NT_W) nt[pp * NT_W + t] = s.ntp[t];
        __syncwarp();
    } else if (ret_m) {
        research = false;
    }
    if (better) {
        // pv[parent] = tried + pv[ply]; a ply past the PV table's last row
        // reads the last row
        const int32_t* child_pv = pv + min(p0, P - 1) * P;
        int v0 = 0, v1 = 0;
        if (t < P) v0 = t == 0 ? tried : child_pv[t - 1];
        if (t + WARP < P) v1 = child_pv[t + WARP - 1];
        __syncwarp();
        if (t < P) pv[pp * P + t] = v0;
        if (t + WARP < P) pv[pp * P + t + WARP] = v1;
        __syncwarp();
    }
    const bool root_ret = ret_m && root;
    if (root_ret) {
        root_score = ret;
        root_move = ntp0_bmove;
    }
    const int ply1 = fold ? ply0 - 1 : ply0;
    mode = root_ret ? MODE_DONE : (fold ? MODE_TRYMOVE : mode);

    // -------------------------------------------------------- TRYMOVE
    int ply_f = ply1;
    if (mode == MODE_TRYMOVE) {
        const int* nt1 = expand ? s.ntr : s.ntp;
        const int* bt1 = expand ? s.btr : s.btp;
        const int midx = nt1[NT_MIDX];
        const bool exhausted = midx >= nt1[NT_COUNT];
        const bool cutoff = nt1[NT_ALPHA] >= nt1[NT_BETA];
        const bool re_push = research;
        const bool do_null = !(re_push || cutoff) && nt1[NT_NULL] == 1;
        const bool finish = !(do_null || re_push) && (exhausted || cutoff);
        const bool advance = !finish;
        const bool normal_adv = advance && !(re_push || do_null);
        const int dl_node = nt1[NT_DL];

        // killer/history credit on fail-high by a quiet move
        const int cause = nt1[NT_BMOVE];
        const bool k_upd = cutoff && cause >= 0 && is_quiet<V>(max(cause, 0), bt1);
        const bool k_new = k_upd && cause != nt1[NT_K0];
        if (k_upd && t == 0) {
            int32_t* h = a.hist + (int64_t)lane * HIST_SIZE + (cause & (HIST_SIZE - 1));
            const int dl = max(dl_node, 0);
            *h = min(*h + min(dl * dl + 1, HIST_BONUS_MAX), HIST_MAX);
        }

        // finished node value: best, or mate/stalemate when no legal child
        const bool no_legal = (nt1[NT_SEARCHED] == 0 && dl_node > 0) && nt1[NT_BEST] == -INF;
        // (in antichess the side left without a move wins)
        const int mate_val = V == VARIANT_ANTICHESS ? MATE - ply1
                             : (nt1[NT_INCHECK] != 0 ? ply1 - MATE : DRAW);
        const int fin_val = (no_legal && exhausted) ? mate_val : nt1[NT_BEST];

        const int m_ix = min(max(re_push ? midx - 1 : midx, 0), MM - 1);
        const int move = max(expand ? s.gen[m_ix] : mv[pp * MM + m_ix], 0);
        int red = 0, child_dl;
        if (a.pruning) {
            // late-move reduction; the null child is the same position
            // with the opponent to move, no ep square and a reset clock
            const bool lmr_ok = dl_node >= LMR_MIN_DEPTH && midx >= LMR_MIN_MOVE
                                && nt1[NT_INCHECK] == 0 && is_quiet<V>(move, bt1);
            red = (lmr_ok && !(re_push || do_null)) ? (midx >= LMR_DEEP_MOVE ? 2 : 1) : 0;
            const int null_r = NULL_R + (dl_node >= NULL_DEEP_DEPTH);
            child_dl = max(dl_node - 1 - (do_null ? null_r : red), 0);
        } else {
            child_dl = max(dl_node - 1, 0);
        }
        const int nply = min(ply1 + 1, P);

        // own-row fields [MIDX, NULL, LASTRED, K0, K1]
        __syncwarp();  // the history word above lands before the warp's next read
        if (t < NT_W) {
            int x = nt1[t];
            if (t == NT_MIDX && normal_adv) x = midx + 1;
            if (t == NT_NULL && do_null) x = 2;
            if (t == NT_LASTRED && advance) x = red;
            if (t == NT_K0 && k_new) x = cause;
            if (t == NT_K1 && k_new) x = nt1[NT_K0];
            nt[ply1 * NT_W + t] = x;
        }
        __syncwarp();
        if (advance) {
            if (t == 0) nt[nply * NT_W + NT_DL] = child_dl;
            rules::make_move_warp<V>(bt1, bt1[BT_STM], bt1[BT_EP], &bt1[BT_CAST], bt1[BT_HM],
                                     &bt1[BT_EXTRA], move, t, s.child, s.chg, s.chg + 4,
                                     s.chg + 8);  // K10
            __syncwarp();
            if (a.pruning && do_null) {  // a null move changes no pieces
                for (int j = t; j < BT_W; j += WARP) {
                    s.child[j] = bt1[j] * NULL_MUL[j] + NULL_ADD[j];
                }
                if (t < 4) {
                    s.chg[t] = 0;
                    s.chg[8 + t] = 0;
                }
                __syncwarp();
            }
            for (int j = t; j < BT_W; j += WARP) bt[nply * BT_W + j] = s.child[j];
            if constexpr (Net::KIND == BOARD768 && V != VARIANT_ATOMIC) {
                // the child's accumulators: K3's body, four columns a thread
                const Acc* src = acc + ply1 * 2 * L1;
                Acc out[4];
                for (int i = 0; i < 4; ++i) {
                    const int col = t + WARP * i;
                    const int persp = col / L1, c = col % L1;
                    out[i] = src[col] + nnue::acc_delta<typename Net::Weights::Ft, Acc>(
                                                 s.chg, s.chg + 4, s.chg + 8, persp, c,
                                                 a.net.ft_w, L1);
                }
                __syncwarp();
                Acc* dst = acc + nply * 2 * L1;
                for (int i = 0; i < 4; ++i) dst[t + WARP * i] = out[i];
                __syncwarp();
                if (t == 0) calls[B_ACC_UPDATE] += 1;
            }
            if (t == 0) calls[B_MAKE_MOVE] += 1;
        }
        research = false;
        if (finish) {
            ret = fin_val;
            ret_depth = dl_node;
        }
        mode = finish ? MODE_RETURN : MODE_ENTER;
        ply_f = advance ? nply : ply1;
    }

    __syncwarp();
    if (t == 0) {
        L[LN_PLY] = ply_f;
        L[LN_MODE] = mode;
        L[LN_RET] = ret;
        L[LN_RETD] = ret_depth;
        L[LN_SMARK] = leaf_store;
        L[LN_SVAL] = store_val;
        L[LN_NODES] = nodes;
        L[LN_RSCORE] = root_score;
        L[LN_RMOVE] = root_move;
        L[LN_RESEARCH] = research;
    }
    // the leaves the step evaluated: their position is the pre-step one
    if (a.table && t == 0) {
        leaf_store_claim(a, lane, leaf_store, h1, h2, store_val, leaf_keep, calls);
    }
    return mode != MODE_DONE;
}

}  // namespace search
