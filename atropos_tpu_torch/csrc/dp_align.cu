// Banded semi-global adapter-alignment DP for Hopper (sm_90a): one thread a
// read, or for dp_locate_wide's long adapters one warp a read.
//
// Two exported kernels, one for each Pallas kernel of
// atropos_tpu/align/pallas_kernel.py:
//
//   dp_locate_word32  replaces  _dp_kernel_fused   (one 32-bit word a cell)
//   dp_locate_wide    replaces  _dp_kernel         (one 64-bit word a cell,
//                                                   for (m, k, L) whose
//                                                   fields need > 32 bits)
//
// Both compute, for every read of a [L, B] column-major uint8 batch, the
// result of oracle.Aligner.locate for one adapter of m bases: the 7 rows
// found, start1, stop1, start2, stop2, matches, cost (+ a zero row) of an
// [8, B] int32 output. m, k, the flags, the costs, the adapter bytes and
// the threshold table are run-time arguments, so one build serves every
// adapter.
//
// Four device functions compute that result; the wrapper
// (align/cuda_kernel.py::_DpKernel.instantiation) picks one from the shape
// alone, and each gives the same result:
//
//   dp_body_reg<R>         dp_locate_word32 for adapters of m + 1 <= R
//                          rows, R = 16, 32, 48 or 64, whose word leaves
//                          three bits to spare above the fields: the cell
//                          column in registers. The main path's kernel
//                          (TruSeq, 34 rows: R = 48).
//   dp_body_warp<R>        dp_locate_wide with one warp a read, the column
//                          in register strips of R = 28 rows a lane, for
//                          adapters of up to 32 R = 896 bases whose cell a
//                          32-bit word cannot hold: the long path's kernel
//                          (880 bases).
//   dp_body<Word, false>   the column in shared memory: dp_locate_wide on
//                          the other shapes, and dp_locate_word32 for
//                          longer adapters.
//   dp_body<Word, true>    the column in global memory, for adapters whose
//                          column does not fit shared memory even for one
//                          warp (m above about 1,800 in the 32-bit word,
//                          890 in the 64-bit one).
//
// What is common to the three bodies of one thread a read:
//   * The TPU kernels update all m + 1 rows of a column as one vector and
//     mask the write-back to the Ukkonen band; they resolve the insertion
//     chain by d_max relaxation passes and ties by a sub-key field. A CUDA
//     thread walks the rows in order instead, so it computes only the rows
//     inside the band (rows <= last, for most reads k + 2 of the m + 1),
//     takes the insertion from the row it has just written, and resolves
//     ties by the order of its compares. The sub-key field and the
//     relaxation blocker are not needed; the results are the same.
//   * The cell keeps the packed word of _fused_layout (cost | origin + m |
//     matches, costs saturated at k + 1, which no observable result can
//     tell from the true cost). Cells above the band keep their stale
//     values, which the oracle can observe later.
//   * Reads arrive [L, B] uint8: in column j a warp loads 32 neighbouring
//     bytes. A warp leaves the column loop as soon as all its reads are
//     past their last column or have found an exact match (__all_sync), so
//     B is a multiple of 32.
//   * Thresholds floor(err * len) come in as an int32 table computed on the
//     host in float64; the kernels look it up and never multiply a float.
//
// What bounds dp_body_reg on this card: integer instructions, issued by
// too few warps. The bytes (L * B in, 32 * B out) are three orders of
// magnitude below what the memory moves in the kernel's time. A row of the
// column loop takes about 11 instructions of the cell rule and its
// bookkeeping, and ptxas adds about 5 register moves (both counted in the
// built SASS by cuda_tools/sass_rows.py, which chip_smoke.py runs). At
// B = 32,768 there are 1,024 warps for 528 schedulers, so a warp's own
// dependences set the pace: a variant without the moves ran no faster,
// and one with an insertion chain one operation shorter but one
// instruction more a row ran slower (PERF.md). A warp runs each column
// down to the deepest band of its 32 reads: on the main path 3.3x the
// band's own cells (the warp-level row slots that chip_smoke.py reports
// beside the cell updates). The design answers the
// shared-memory kernel's costs:
//   * The column lives in R registers, the row loop fully unrolled. A row
//     above a read's band (or above m) keeps its stale value through a
//     select. No cell goes through shared memory, so a cell needs no
//     address arithmetic, and row i no longer waits for row i - 1's store
//     before its load.
//   * The cell rule as one minimum of keyed words (derived at dp_body_reg):
//     the diagonal and deletion candidates and the clamp are two fused
//     add-min instructions off the insertion chain, and the chain is left
//     with a fused add-min and the clearing of the tie key.
//   * A block builds a 256-entry table of match masks (bit i - 1 of entry
//     v: adapter byte i - 1 matches v), so a column costs one shared load
//     and a row one bit test, not a byte load and a compare.
//   * The read byte is loaded two columns ahead and its mask one column
//     ahead, so no global load waits on a column's critical path.
//   * Rows go in groups (RowGroup); once a column the warp finds the
//     deepest band of its reads (__reduce_max_sync) and skips the groups
//     below it.
// What is left: the warp's rows below a read's own band (the 3.3x above),
// four instructions a row of bookkeeping (the select that keeps a stale
// row, the band's test and select), and two warps a scheduler.
//
// dp_body_warp replaces dp_body<unsigned long long, false> for the shapes
// only the 64-bit word holds, where one thread a read starves the card:
// above about 220 bases its shared column leaves at most two warps an SM.
// The long path has 1,024 reads of 7,328 bases against an 880-base
// adapter: a 64-bit column of 881 rows takes 7 KB, so
// a block of one thread a read holds one warp (229,940 bytes of shared
// memory) and the launch runs 32 warps on 32 of the 132 SMs, each column
// down to the deepest band of its 32 reads (607 rows a column against 293
// of one read's band), one shared-memory load, a 24-operation chain and a
// store a row, with no other warp to hide the latency: 203 ms, 142x the
// bound of its band cells at 24 operations. Parallelism inside a read is
// the only lever at that batch width. What bounds dp_body_warp: integer
// instructions again, now issued by 1,024 warps, about two a scheduler. A
// column costs a warp R rows of the cell rule in two 32-bit planes (the
// best of diagonal, deletion and clamp off the chain; the chain an add, a
// compare and two selects; the stale row's select and the band's test),
// two shuffles of the row above each lane, a vote for the fix-up's one
// round, the band's reduction: on the long path's batch about 9.6 ms on an
// H100 against 203 ms (PERF.md). Its bound counts the 14 operations a band
// cell of the two-plane rule needs (STRIP_OPS_PER_CELL in
// align/cuda_kernel.py); the SASS takes about 23.5 a strip row, the stale
// row's select and the band's test included. What is left: the lanes whose rows lie below
// the band (some 2/3 of a column at k = 264), which a warp cannot skip, and
// the rows a fix-up walks again. How it works, and why it is exact, is at
// dp_body_warp.
//
// dp_body (shared or global column) is bound the same way, with a longer
// chain a cell: OPS_PER_CELL there, one iteration of its row loop:
// shared-memory address (1), load old cell, load adapter byte, compare
// (2), three cost extracts (3), three candidate costs (3), two compares
// and the and (3), three selects of the cost and three of the payload (6),
// clamp (1), repack (2), band test and select (2), loop counter (1) = 24.
// Its column lives [row][thread] in shared memory so that a warp's 32
// threads hit 32 different banks, or [row][read] in a global scratch
// buffer that the wrapper allocates, so that a warp's 32 accesses to one
// row are one coalesced transaction.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shared_limit.h"

namespace {

constexpr int START_WITHIN_SEQ1 = 1;
constexpr int START_WITHIN_SEQ2 = 2;
constexpr int STOP_WITHIN_SEQ1 = 4;
constexpr int STOP_WITHIN_SEQ2 = 8;

struct DpParams {
    int L;             // rows of reads: columns of the DP
    int B;             // reads in the batch (a multiple of 32)
    int m;             // adapter length
    int k;             // int(max_error_rate * m)
    int flags;
    int min_overlap;
    int ins_cost;
    int del_cost;
    int compare_ascii; // 1: byte equality, 0: IUPAC bit-and
    int mat_bits;      // width of the matches field
    int org_bits;      // width of the origin + m field
};

// GLOBAL_COL false: the column, thresholds and adapter bytes in dynamic
// shared memory; true: all three in global memory, the column in the
// caller's [m + 1, B] scratch buffer col_g.
template <typename Word, bool GLOBAL_COL>
__device__ __forceinline__ void dp_body(
    const uint8_t* __restrict__ reads,     // [L, B]
    const int32_t* __restrict__ lengths,   // [B]
    int32_t* __restrict__ out,             // [8, B]
    const uint8_t* __restrict__ ref_g,     // [m]
    const int32_t* __restrict__ thr_g,     // [m + 1]
    Word* __restrict__ col_g,              // [m + 1, B] when GLOBAL_COL
    const DpParams p)
{
    const int T = blockDim.x;
    const int tid = threadIdx.x;
    const int m = p.m;
    const int k = p.k;
    const int M1 = m + 1;
    const int b = blockIdx.x * T + tid;

    // cell of row i of this thread's read: cells[i * cstride]
    Word* cells;
    size_t cstride;
    const int32_t* thr;
    const uint8_t* ref;
    if constexpr (GLOBAL_COL) {
        cells = col_g + b;
        cstride = (size_t)p.B;
        thr = thr_g;
        ref = ref_g;
    } else {
        extern __shared__ __align__(16) unsigned char smem_raw[];
        Word* col_s = reinterpret_cast<Word*>(smem_raw);            // [M1][T]
        int32_t* thr_s = reinterpret_cast<int32_t*>(col_s + (size_t)M1 * T);
        uint8_t* ref_s = reinterpret_cast<uint8_t*>(thr_s + M1);
        for (int i = tid; i < M1; i += T) thr_s[i] = thr_g[i];
        for (int i = tid; i < m; i += T) ref_s[i] = ref_g[i];
        __syncthreads();
        cells = col_s + tid;
        cstride = (size_t)T;
        thr = thr_s;
        ref = ref_s;
    }

    if (b >= p.B) return;  // B is a multiple of 32: whole warps leave

    const bool start_in_ref = p.flags & START_WITHIN_SEQ1;
    const bool start_in_query = p.flags & START_WITHIN_SEQ2;
    const bool stop_in_ref = p.flags & STOP_WITHIN_SEQ1;
    const bool stop_in_query = p.flags & STOP_WITHIN_SEQ2;

    const int org_shift = p.mat_bits;
    const int cost_shift = p.mat_bits + p.org_bits;
    const Word mat_mask = ((Word)1 << p.mat_bits) - 1;
    const Word org_mask = ((Word)1 << p.org_bits) - 1;
    const Word low_mask = ((Word)1 << cost_shift) - 1;  // origin + matches
    const Word org_field = org_mask << org_shift;

    const int clamp = k + 1;
    const int ins_unit = min(p.ins_cost, clamp);
    const int del_unit = min(p.del_cost, clamp);

    const int n = lengths[b];
    const int max_n = start_in_query ? n : min(n, m + k);
    const int min_n = stop_in_query ? 0 : max(0, n - m - k);

    // initial column min_n, by which ends are free
    for (int i = 0; i < M1; ++i) {
        long long c;
        int o;
        if (!start_in_ref && !start_in_query) {
            c = (long long)max(i, min_n) * p.ins_cost;
            o = 0;
        } else if (start_in_ref && !start_in_query) {
            c = (long long)min_n * p.ins_cost;
            o = min(0, min_n - i);
        } else if (!start_in_ref && start_in_query) {
            c = (long long)i * p.ins_cost;
            o = max(0, min_n - i);
        } else {
            c = (long long)min(i, min_n) * p.ins_cost;
            o = min_n - i;
        }
        const int cc = (int)min(c, (long long)clamp);
        cells[(size_t)i * cstride] =
            ((Word)cc << cost_shift) | ((Word)(o + m) << org_shift);
    }

    int best_ref_stop = m;
    int best_query_stop = n;
    int best_cost = m + n;
    int best_origin = 0;
    int best_matches = 0;
    int last = start_in_ref ? m : min(m, k + 1);
    bool done = false;

    for (int j = 1; j <= p.L; ++j) {
        const bool over = done || j > max_n;
        if (__all_sync(0xffffffffu, over)) break;
        if (over || j <= min_n) continue;

        const int qc = reads[(size_t)(j - 1) * p.B + b];

        // row 0; its old value is the diagonal source of row 1
        Word diag = cells[0];
        Word prev;
        if (start_in_query) {
            prev = (diag & ~org_field) | ((Word)(j + m) << org_shift);
        } else {
            prev = (diag & low_mask) |
                   ((Word)min(j * ins_unit, clamp) << cost_shift);
        }
        cells[0] = prev;
        int band = ((int)(prev >> cost_shift) <= k) ? 0 : -1;

        for (int i = 1; i <= last; ++i) {
            const Word old = cells[(size_t)i * cstride];
            const int rc = ref[i - 1];
            const bool eq = p.compare_ascii ? (rc == qc) : ((rc & qc) != 0);
            // a match is the forced diagonal: cost kept, matches + 1;
            // else diagonal, then insertion, then deletion win ties
            const int c_diag = (int)(diag >> cost_shift) + 1;
            const int c_del = (int)(old >> cost_shift) + del_unit;
            const int c_ins = (int)(prev >> cost_shift) + ins_unit;
            const bool take_diag = (c_diag <= c_del) & (c_diag <= c_ins);
            const bool take_ins = c_ins <= c_del;
            int c = take_diag ? c_diag : (take_ins ? c_ins : c_del);
            const Word pay = take_diag ? diag : (take_ins ? prev : old);
            c = min(c, clamp);
            const Word cur = eq ? diag + 1
                                : (((Word)c << cost_shift) | (pay & low_mask));
            cells[(size_t)i * cstride] = cur;
            band = ((int)(cur >> cost_shift) <= k) ? i : band;
            diag = old;
            prev = cur;
        }

        // band update: deepest row <= last with cost <= k, plus one
        if (band < m) {
            last = band + 1;
        } else if (stop_in_query) {
            // the band reaches row m: a full-adapter alignment ends here
            const int ccost = (int)(prev >> cost_shift);
            const int corg = (int)((prev >> org_shift) & org_mask) - m;
            const int cmat = (int)(prev & mat_mask);
            const int length = m + min(corg, 0);
            if (length >= p.min_overlap && ccost <= thr[length] &&
                (cmat > best_matches ||
                 (cmat == best_matches && ccost < best_cost))) {
                best_matches = cmat;
                best_cost = ccost;
                best_origin = corg;
                best_ref_stop = m;
                best_query_stop = j;
                done = (ccost == 0 && cmat == m);  // exact match: stop
            }
        }
    }

    // final-column scan: alignments that end at the end of the read
    if (max_n == n) {
        const int first_i = stop_in_ref ? 0 : m;
        for (int i = first_i; i <= m; ++i) {
            const Word w = cells[(size_t)i * cstride];
            const int ccost = (int)(w >> cost_shift);
            const int corg = (int)((w >> org_shift) & org_mask) - m;
            const int cmat = (int)(w & mat_mask);
            const int length = i + min(corg, 0);
            if (length >= p.min_overlap &&
                ccost <= thr[min(max(length, 0), m)] &&
                (cmat > best_matches ||
                 (cmat == best_matches && ccost < best_cost))) {
                best_matches = cmat;
                best_cost = ccost;
                best_origin = corg;
                best_ref_stop = i;
                best_query_stop = n;
            }
        }
    }

    const size_t B = p.B;
    out[0 * B + b] = best_cost != m + n;
    out[1 * B + b] = best_origin >= 0 ? 0 : -best_origin;
    out[2 * B + b] = best_ref_stop;
    out[3 * B + b] = best_origin >= 0 ? best_origin : 0;
    out[4 * B + b] = best_query_stop;
    out[5 * B + b] = best_matches;
    out[6 * B + b] = best_cost;
    out[7 * B + b] = 0;
}

// Rows a group of dp_body_reg's column: the warp skips a group whose first
// row lies below every one of its reads' bands. Chosen by measurement for
// each row cap (a smaller group skips more rows and adds more branches).
template <int R> struct RowGroup { static constexpr int value = R <= 32 ? 2 : 3; };

// Match masks of up to 32 rows fit a 32-bit word.
template <int R> struct MatchMask { using type = unsigned long long; };
template <> struct MatchMask<16> { using type = uint32_t; };
template <> struct MatchMask<32> { using type = uint32_t; };

__device__ __forceinline__ uint32_t high_word(uint32_t) { return 0; }
__device__ __forceinline__ uint32_t high_word(unsigned long long mask)
{
    return (uint32_t)(mask >> 32);
}

// Row i of a column held in registers, i a run-time index: an unrolled
// select, so that the column never moves to local memory.
template <int R>
__device__ __forceinline__ uint32_t row_of(const uint32_t (&cell)[R], int i)
{
    uint32_t w = cell[0];
#pragma unroll
    for (int r = 1; r < R; ++r) w = (r == i) ? cell[r] : w;
    return w;
}

// dp_locate_word32 for adapters of m + 1 <= R rows, with the column in
// registers: the same result as dp_body<uint32_t, false>.
//
// The cell rule as one minimum of keyed words. dp_body takes, for a
// mismatch, the cheapest of the diagonal (cost(diag) + 1), the insertion
// (cost(prev) + ins_unit) and the deletion (cost(old) + del_unit), ties won
// by the diagonal, then by the insertion; it clamps the cost at k + 1 and
// keeps the winner's payload (origin, matches). For a match it takes
// diag + 1 (one match more) whatever the others cost. Here a candidate word
// carries a 2-bit tie key between its cost and its payload, 0 for the
// diagonal, 1 for the insertion, 2 for the deletion, so the unsigned
// minimum of the three words and of clamp_w (cost k + 1, key and payload 0)
// is dp_body's winner, payload and all, whenever that costs k or less. A
// cell that costs more is dead for good: no result reads its payload
// (every threshold is at most k) and no cell of cost k or less descends
// from it, so the clamp word's payload there changes nothing that can be
// observed. Off the chain: the diagonal and deletion words, their minimum
// with clamp_w, and the match word diag + 1. On the chain: add the
// insertion's cost and key to the row just written, take the minimum and
// clear its key (a match keeps diag + 1); no stored cell has a key. Words
// hold costs up to 2k + 2 before the minimum, so the wrapper sends here only
// layouts with three bits to spare above the fields: the key and one bit
// of overflow.
template <int R>
__device__ __forceinline__ void dp_body_reg(
    const uint8_t* __restrict__ reads,     // [L, B]
    const int32_t* __restrict__ lengths,   // [B]
    int32_t* __restrict__ out,             // [8, B]
    const uint8_t* __restrict__ ref_g,     // [m]
    const int32_t* __restrict__ thr_g,     // [m + 1]
    const DpParams p)
{
    using Mask = typename MatchMask<R>::type;
    __shared__ Mask match_s[256];
    __shared__ int32_t thr_s[R];
    __shared__ uint8_t ref_s[R];

    const int T = blockDim.x;
    const int tid = threadIdx.x;
    const int m = p.m;
    const int k = p.k;
    const int b = blockIdx.x * T + tid;

    for (int i = tid; i <= m; i += T) thr_s[i] = thr_g[i];
    for (int i = tid; i < m; i += T) ref_s[i] = ref_g[i];
    __syncthreads();
    // bit i - 1 of match_s[v]: adapter byte i - 1 matches read byte v
    for (int v = tid; v < 256; v += T) {
        Mask bits = 0;
        for (int i = 0; i < m; ++i) {
            const int rc = ref_s[i];
            const bool eq = p.compare_ascii ? (rc == v) : ((rc & v) != 0);
            bits |= (Mask)eq << i;
        }
        match_s[v] = bits;
    }
    __syncthreads();

    if (b >= p.B) return;  // B is a multiple of 32: whole warps leave

    const bool start_in_ref = p.flags & START_WITHIN_SEQ1;
    const bool start_in_query = p.flags & START_WITHIN_SEQ2;
    const bool stop_in_ref = p.flags & STOP_WITHIN_SEQ1;
    const bool stop_in_query = p.flags & STOP_WITHIN_SEQ2;

    // cell = cost | tie key (2 bits) | origin + m | matches
    const int org_shift = p.mat_bits;
    const int key_shift = p.mat_bits + p.org_bits;
    const int cost_shift = key_shift + 2;
    const uint32_t mat_mask = (1u << p.mat_bits) - 1;
    const uint32_t org_mask = (1u << p.org_bits) - 1;
    const uint32_t low_mask = (1u << key_shift) - 1;  // origin + matches
    const uint32_t org_field = org_mask << org_shift;
    const uint32_t no_key = ~(3u << key_shift);

    const int clamp = k + 1;
    const int ins_unit = min(p.ins_cost, clamp);
    const int del_unit = min(p.del_cost, clamp);
    // what a candidate adds to its source word: cost and tie key
    const uint32_t diag_w = 1u << cost_shift;
    const uint32_t ins_w =
        ((uint32_t)ins_unit << cost_shift) | (1u << key_shift);
    const uint32_t del_w =
        ((uint32_t)del_unit << cost_shift) | (2u << key_shift);
    const uint32_t clamp_w = (uint32_t)clamp << cost_shift;
    // a word costs k or less iff it is below live_w
    const uint32_t live_w = (uint32_t)(k + 1) << cost_shift;

    const int n = lengths[b];
    const int max_n = start_in_query ? n : min(n, m + k);
    const int min_n = stop_in_query ? 0 : max(0, n - m - k);

    // initial column min_n, by which ends are free; rows above m start at
    // 0 and are never written, and what the rows compute from them is
    // dropped
    uint32_t cell[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        long long c;
        int o;
        if (!start_in_ref && !start_in_query) {
            c = (long long)max(i, min_n) * p.ins_cost;
            o = 0;
        } else if (start_in_ref && !start_in_query) {
            c = (long long)min_n * p.ins_cost;
            o = min(0, min_n - i);
        } else if (!start_in_ref && start_in_query) {
            c = (long long)i * p.ins_cost;
            o = max(0, min_n - i);
        } else {
            c = (long long)min(i, min_n) * p.ins_cost;
            o = min_n - i;
        }
        const int cc = (int)min(c, (long long)clamp);
        cell[i] = i <= m ? ((uint32_t)cc << cost_shift) |
                               ((uint32_t)(o + m) << org_shift)
                         : 0u;
    }

    int best_ref_stop = m;
    int best_query_stop = n;
    int best_cost = m + n;
    int best_origin = 0;
    int best_matches = 0;
    int last = start_in_ref ? m : min(m, k + 1);
    bool done = false;

    // read bytes two columns ahead, match masks one column ahead
    const size_t B = p.B;
    int q_ahead = p.L > 1 ? reads[B + b] : 0;
    Mask mask_ahead = match_s[p.L > 0 ? reads[b] : 0];
    const uint8_t* read_ahead = reads + 2 * B + b;  // column j + 2's byte

    for (int j = 1; j <= p.L; ++j, read_ahead += B) {
        const uint32_t mask_lo = (uint32_t)mask_ahead;
        const uint32_t mask_hi = high_word(mask_ahead);
        mask_ahead = match_s[q_ahead];
        if (j + 1 < p.L) q_ahead = *read_ahead;

        const bool over = done || j > max_n;
        const bool active = !over && j > min_n;
        const int lim = active ? last : -1;  // rows this read updates
        const int warp_lim = __reduce_max_sync(0xffffffffu, lim);
        if (warp_lim < 0) {
            // no read of the warp updates this column; leave the loop
            // once none ever will
            if (__all_sync(0xffffffffu, over)) break;
            continue;
        }

        // row 0; its old value is the diagonal source of row 1
        uint32_t diag = cell[0];
        uint32_t prev;
        if (start_in_query) {
            prev = (diag & ~org_field) | ((uint32_t)(j + m) << org_shift);
        } else {
            prev = (diag & low_mask) |
                   ((uint32_t)min(j * ins_unit, clamp) << cost_shift);
        }
        cell[0] = active ? prev : diag;
        int band = (prev < live_w) ? 0 : -1;

        constexpr int G = RowGroup<R>::value;
#pragma unroll
        for (int g = 0; g * G + 1 < R; ++g) {
            if (g * G + 1 > warp_lim) break;  // the same in every lane
#pragma unroll
            for (int r = 1; r <= G; ++r) {
                const int i = g * G + r;
                if (i >= R) break;
                const uint32_t old = cell[i];
                // off the chain: clamp, diagonal and deletion words, in an
                // order that makes two fused add-min instructions
                const uint32_t best =
                    min(old + del_w, min(diag + diag_w, clamp_w));
                // a constant bit of one 32-bit word: one LOP3 to a predicate
                const uint32_t mask_word = (i - 1 < 32) ? mask_lo : mask_hi;
                const bool eq = (mask_word >> ((i - 1) & 31)) & 1u;
                // the chain: the insertion from the row just written, the
                // minimum, the key cleared
                const uint32_t cur =
                    eq ? diag + 1u : (min(prev + ins_w, best) & no_key);
                const bool write = i <= lim;
                cell[i] = write ? cur : old;
                band = (write && cur < live_w) ? i : band;
                diag = old;
                prev = cur;
            }
        }
        if (!active) continue;

        // band update: deepest row <= last with cost <= k, plus one
        if (band < m) {
            last = band + 1;
        } else if (stop_in_query) {
            // the band reaches row m: a full-adapter alignment ends here
            const uint32_t w = row_of(cell, m);
            const int ccost = (int)(w >> cost_shift);
            const int corg = (int)((w >> org_shift) & org_mask) - m;
            const int cmat = (int)(w & mat_mask);
            const int length = m + min(corg, 0);
            if (length >= p.min_overlap && ccost <= thr_s[length] &&
                (cmat > best_matches ||
                 (cmat == best_matches && ccost < best_cost))) {
                best_matches = cmat;
                best_cost = ccost;
                best_origin = corg;
                best_ref_stop = m;
                best_query_stop = j;
                done = (ccost == 0 && cmat == m);  // exact match: stop
            }
        }
    }

    // final-column scan: alignments that end at the end of the read
    if (max_n == n) {
        const int first_i = stop_in_ref ? 0 : m;
#pragma unroll
        for (int i = 0; i < R; ++i) {
            const uint32_t w = cell[i];
            const int ccost = (int)(w >> cost_shift);
            const int corg = (int)((w >> org_shift) & org_mask) - m;
            const int cmat = (int)(w & mat_mask);
            const int length = i + min(corg, 0);
            if (i >= first_i && i <= m && length >= p.min_overlap &&
                ccost <= thr_s[min(max(length, 0), m)] &&
                (cmat > best_matches ||
                 (cmat == best_matches && ccost < best_cost))) {
                best_matches = cmat;
                best_cost = ccost;
                best_origin = corg;
                best_ref_stop = i;
                best_query_stop = n;
            }
        }
    }

    out[0 * B + b] = best_cost != m + n;
    out[1 * B + b] = best_origin >= 0 ? 0 : -best_origin;
    out[2 * B + b] = best_ref_stop;
    out[3 * B + b] = best_origin >= 0 ? best_origin : 0;
    out[4 * B + b] = best_query_stop;
    out[5 * B + b] = best_matches;
    out[6 * B + b] = best_cost;
    out[7 * B + b] = 0;
}

constexpr unsigned FULL_WARP = 0xffffffffu;

// dp_locate_wide with one warp a read: the same result as
// dp_body<unsigned long long, false>. STATS (the instrumented launch only)
// counts the columns, fix-up rounds and fix-up row steps into stats.
//
// Lane l holds rows 1 + l R .. (l + 1) R of the read's column in registers,
// R rows a lane, so adapters of m <= 32 R bases; row 0 is held by every
// lane alike. A cell is two 32-bit planes: hi = cost << 2 | tie key, lo =
// (origin + m) << mat_bits | matches, the 64-bit word hi:lo. Stored cells
// carry no key. The cell rule is dp_body_reg's keyed minimum on that word:
// the diagonal (key 0), deletion (key 2) and clamp (cost k + 1, key 0)
// candidates differ in hi wherever they tie in cost, so one compare of hi
// picks the winner and its payload (a dead winner's payload, as there, is
// never observed). A match takes diag + 1 and is immune to the insertion.
// The insertion (key 1) from prev, the cell just written in the row above,
// wins iff its keyed hi is below the winner's.
//
// Column j runs in three steps, and the warp finishes each before the next:
//   1. Each lane computes, off the insertion chain, each of its rows' best
//      of diagonal, deletion and clamp (bk, bl); the diagonal source of its
//      first row is the previous lane's last row before this column writes
//      it (one shuffle). Then it walks its strip with the chain: lane 0
//      enters with row 0, every other lane with a dead word (cost k + 1),
//      as if no insertion came from above. Rows deeper than last keep their
//      stale value through a select, as dp_body leaves them.
//   2. The fix-up, in warp-voted rounds: each lane takes the previous
//      lane's last row (one shuffle); where that differs from the value it
//      walked with, it walks again from its first row, until a row comes
//      out as already stored (from there nothing below can change: a cell
//      depends on its own column only through the row above). A round in
//      which no lane's last row changed ends the column. Lane 0 is right
//      after step 1, so after r rounds lanes 0..r are; at most 32 rounds.
//      Costs only fall from round to round (a dead word entered first), so
//      a row once inside the band stays there.
//   3. The band, as dp_body takes it: the deepest row <= last whose cost is
//      k or less, a __reduce_max_sync over the lanes; then row m, if the
//      band reaches it, broadcast from its lane to the whole warp.
// This is exact where a wavefront is not (the band trap): column j may
// write row i only if i <= last(j - 1), and the rows below last keep stale
// values that come back as sources when the band grows and in the final
// scan. A lane that ran ahead into column j would need last(j - 1) before
// the deep lanes computed it. Here every lane finishes column j - 1, band
// included, before any lane starts column j.
template <int R, bool STATS>
__device__ __forceinline__ void dp_body_warp(
    const uint8_t* __restrict__ reads,     // [L, B]
    const int32_t* __restrict__ lengths,   // [B]
    int32_t* __restrict__ out,             // [8, B]
    const uint8_t* __restrict__ ref_g,     // [m]
    const int32_t* __restrict__ thr_g,     // [m + 1]
    unsigned long long* __restrict__ stats,  // the [3] counts if STATS
    const DpParams p)
{
    static_assert(R >= 1 && R <= 32, "a lane's match mask is one 32-bit word");
    // bit r of match_s[v * 32 + l]: adapter byte l R + r matches read byte v
    __shared__ uint32_t match_s[256 * 32];
    __shared__ uint8_t ref_s[32 * R];
    extern __shared__ int32_t thr_s[];  // [m + 1]

    const int T = blockDim.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int m = p.m;
    const int k = p.k;

    for (int i = tid; i <= m; i += T) thr_s[i] = thr_g[i];
    for (int i = tid; i < 32 * R; i += T) ref_s[i] = i < m ? ref_g[i] : 0;
    __syncthreads();
    for (int e = tid; e < 256 * 32; e += T) {
        const int v = e >> 5;
        const int l = e & 31;
        uint32_t bits = 0;
        for (int r = 0; r < R; ++r) {
            const int a = l * R + r;
            const int rc = ref_s[a];
            const bool eq = p.compare_ascii ? (rc == v) : ((rc & v) != 0);
            bits |= (uint32_t)(eq && a < m) << r;
        }
        match_s[e] = bits;
    }
    __syncthreads();

    const int b = blockIdx.x * (T >> 5) + (tid >> 5);
    if (b >= p.B) return;  // whole warps leave

    const bool start_in_ref = p.flags & START_WITHIN_SEQ1;
    const bool start_in_query = p.flags & START_WITHIN_SEQ2;
    const bool stop_in_ref = p.flags & STOP_WITHIN_SEQ1;
    const bool stop_in_query = p.flags & STOP_WITHIN_SEQ2;

    const int org_shift = p.mat_bits;
    const uint32_t mat_mask = (1u << p.mat_bits) - 1;
    const uint32_t org_mask = (uint32_t)((1ull << p.org_bits) - 1);
    const uint32_t org_field = org_mask << org_shift;

    const int clamp = k + 1;
    const int ins_unit = min(p.ins_cost, clamp);
    const int del_unit = min(p.del_cost, clamp);
    // what a candidate adds to its source's hi word: cost and tie key
    const uint32_t del_w = ((uint32_t)del_unit << 2) | 2u;
    const uint32_t ins_w = ((uint32_t)ins_unit << 2) | 1u;
    const uint32_t ins_c = (uint32_t)ins_unit << 2;  // the same, no key
    const uint32_t clamp_h = (uint32_t)clamp << 2;   // also: hi < clamp_h iff live
    const uint32_t dead_h = clamp_h;

    const int n = lengths[b];
    const int max_n = start_in_query ? n : min(n, m + k);
    const int min_n = stop_in_query ? 0 : max(0, n - m - k);
    const int row0 = 1 + lane * R;  // this lane's first row

    // initial column min_n, by which ends are free; rows above m start at
    // 0 and are never written
    auto initial = [&](int i, uint32_t& h, uint32_t& l) {
        long long c;
        int o;
        if (!start_in_ref && !start_in_query) {
            c = (long long)max(i, min_n) * p.ins_cost;
            o = 0;
        } else if (start_in_ref && !start_in_query) {
            c = (long long)min_n * p.ins_cost;
            o = min(0, min_n - i);
        } else if (!start_in_ref && start_in_query) {
            c = (long long)i * p.ins_cost;
            o = max(0, min_n - i);
        } else {
            c = (long long)min(i, min_n) * p.ins_cost;
            o = min_n - i;
        }
        h = (uint32_t)min(c, (long long)clamp) << 2;
        l = (uint32_t)(o + m) << org_shift;
    };
    uint32_t cell_h[R], cell_l[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        initial(row0 + r, cell_h[r], cell_l[r]);
        if (row0 + r > m) cell_h[r] = cell_l[r] = 0;
    }
    uint32_t r0_h, r0_l;  // row 0
    initial(0, r0_h, r0_l);

    int best_ref_stop = m;
    int best_query_stop = n;
    int best_cost = m + n;
    int best_origin = 0;
    int best_matches = 0;
    int last = start_in_ref ? m : min(m, k + 1);
    unsigned long long columns = 0, rounds = 0, fix_rows = 0;

    // read bytes (the same address in every lane) two columns ahead,
    // match masks one column ahead
    const int j_end = min(max_n, p.L);
    const size_t B = p.B;
    const uint8_t* read_col = reads + b;
    int j = min_n + 1;
    int q_ahead = j + 1 <= j_end ? read_col[(size_t)j * B] : 0;
    uint32_t mask_ahead =
        match_s[(j <= j_end ? read_col[(size_t)(j - 1) * B] : 0) * 32 + lane];

    for (; j <= j_end; ++j) {
        const uint32_t mask = mask_ahead;
        mask_ahead = match_s[q_ahead * 32 + lane];
        if (j + 2 <= j_end) q_ahead = read_col[(size_t)(j + 1) * B];
        if (STATS) ++columns;

        // row 0; its old value is the diagonal source of lane 0's first row
        const uint32_t d0_h = r0_h, d0_l = r0_l;
        if (start_in_query) {
            r0_l = (r0_l & ~org_field) | ((uint32_t)(j + m) << org_shift);
        } else {
            r0_h = (uint32_t)min(j * ins_unit, clamp) << 2;
        }
        const int band0 = r0_h < clamp_h ? 0 : -1;

        // the previous lane's last row, before this column writes it
        uint32_t dh = __shfl_up_sync(FULL_WARP, cell_h[R - 1], 1);
        uint32_t dl = __shfl_up_sync(FULL_WARP, cell_l[R - 1], 1);
        if (lane == 0) {
            dh = d0_h;
            dl = d0_l;
        }
        const int lim = last - row0;  // this lane writes its rows r <= lim

        // step 1: the best off the chain, then the walk
        uint32_t bk[R], bl[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const uint32_t oh = cell_h[r], ol = cell_l[r];
            const uint32_t c_diag = dh + 4u;
            const uint32_t c_del = oh + del_w;
            const bool take_diag = c_diag < c_del;
            const uint32_t wh = min(take_diag ? c_diag : c_del, clamp_h);
            const bool eq = (mask & (1u << r)) != 0u;
            bk[r] = eq ? dh : wh;
            bl[r] = eq ? dl + 1u : (take_diag ? dl : ol);
            dh = oh;
            dl = ol;
        }
        uint32_t in_h = lane == 0 ? r0_h : dead_h;  // what the walk took in
        uint32_t in_l = lane == 0 ? r0_l : 0u;
        int band_r = -1;  // deepest row r of this lane inside the band
        {
            uint32_t ph = in_h, pl = in_l;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const bool eq = (mask & (1u << r)) != 0u;
                const bool win = (ph + ins_w) < (eq ? 0u : bk[r]);
                const uint32_t ch = win ? ph + ins_c : (bk[r] & ~3u);
                const uint32_t cl = win ? pl : bl[r];
                const bool write = r <= lim;
                cell_h[r] = write ? ch : cell_h[r];
                cell_l[r] = write ? cl : cell_l[r];
                band_r = (write && ch < clamp_h) ? r : band_r;
                ph = ch;
                pl = cl;
            }
        }

        // step 2: the fix-up rounds
        for (;;) {
            if (STATS) ++rounds;
            const uint32_t gh = __shfl_up_sync(FULL_WARP, cell_h[R - 1], 1);
            const uint32_t gl = __shfl_up_sync(FULL_WARP, cell_l[R - 1], 1);
            bool walking = lane > 0 && lim >= 0 && (gh != in_h || gl != in_l);
            if (walking) {
                in_h = gh;
                in_l = gl;
            }
            uint32_t ph = gh, pl = gl;
            bool changed_last = false;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                if (!__any_sync(FULL_WARP, walking)) break;
                if (STATS) ++fix_rows;
                const bool eq = (mask & (1u << r)) != 0u;
                const bool win = (ph + ins_w) < (eq ? 0u : bk[r]);
                const uint32_t ch = win ? ph + ins_c : (bk[r] & ~3u);
                const uint32_t cl = win ? pl : bl[r];
                walking = walking && r <= lim &&
                          (ch != cell_h[r] || cl != cell_l[r]);
                if (walking) {
                    cell_h[r] = ch;
                    cell_l[r] = cl;
                    if (ch < clamp_h) band_r = max(band_r, r);
                    if (r == R - 1) changed_last = true;
                }
                ph = ch;
                pl = cl;
            }
            if (!__any_sync(FULL_WARP, changed_last)) break;
        }

        // step 3: the band, deepest row <= last with cost <= k, plus one
        const int band = max(
            band0, __reduce_max_sync(FULL_WARP, band_r >= 0 ? row0 + band_r : -1));
        if (band < m) {
            last = band + 1;
        } else if (stop_in_query) {
            // the band reaches row m: a full-adapter alignment ends here
            const int owner = (m - 1) / R;
            const int rm = m - 1 - owner * R;
            uint32_t wh = cell_h[0], wl = cell_l[0];
#pragma unroll
            for (int r = 1; r < R; ++r) {
                wh = r == rm ? cell_h[r] : wh;
                wl = r == rm ? cell_l[r] : wl;
            }
            wh = __shfl_sync(FULL_WARP, wh, owner);
            wl = __shfl_sync(FULL_WARP, wl, owner);
            const int ccost = (int)(wh >> 2);
            const int corg = (int)((wl >> org_shift) & org_mask) - m;
            const int cmat = (int)(wl & mat_mask);
            const int length = m + min(corg, 0);
            if (length >= p.min_overlap && ccost <= thr_s[length] &&
                (cmat > best_matches ||
                 (cmat == best_matches && ccost < best_cost))) {
                best_matches = cmat;
                best_cost = ccost;
                best_origin = corg;
                best_ref_stop = m;
                best_query_stop = j;
                if (ccost == 0 && cmat == m) break;  // exact match: stop
            }
        }
    }

    // final-column scan: alignments that end at the end of the read. Each
    // lane keeps its first row with the most matches, then the least cost;
    // the warp keeps the first such row of all, which replaces the best so
    // far only if strictly better: the sequential scan's answer.
    if (max_n == n) {
        const int first_i = stop_in_ref ? 0 : m;
        int key = -1, key_i = 0, key_org = 0;  // key: matches | k - cost
        auto consider = [&](int i, uint32_t h, uint32_t l) {
            const int ccost = (int)(h >> 2);
            const int corg = (int)((l >> org_shift) & org_mask) - m;
            const int cmat = (int)(l & mat_mask);
            const int length = i + min(corg, 0);
            const int c = (cmat << 16) | (0xffff - min(ccost, 0xffff));
            if (i >= first_i && i <= m && length >= p.min_overlap &&
                ccost <= thr_s[min(max(length, 0), m)] && c > key) {
                key = c;
                key_i = i;
                key_org = corg;
            }
        };
        if (lane == 0) consider(0, r0_h, r0_l);
#pragma unroll
        for (int r = 0; r < R; ++r) consider(row0 + r, cell_h[r], cell_l[r]);
        const int top = __reduce_max_sync(FULL_WARP, key);
        if (top >= 0) {
            const int i = (int)__reduce_min_sync(
                FULL_WARP, key == top ? (unsigned)key_i : 0xffffffffu);
            const int org = __shfl_sync(FULL_WARP, key_org, i == 0 ? 0 : (i - 1) / R);
            const int cmat = top >> 16;
            const int ccost = 0xffff - (top & 0xffff);
            if (cmat > best_matches ||
                (cmat == best_matches && ccost < best_cost)) {
                best_matches = cmat;
                best_cost = ccost;
                best_origin = org;
                best_ref_stop = i;
                best_query_stop = n;
            }
        }
    }

    if (lane == 0) {
        out[0 * B + b] = best_cost != m + n;
        out[1 * B + b] = best_origin >= 0 ? 0 : -best_origin;
        out[2 * B + b] = best_ref_stop;
        out[3 * B + b] = best_origin >= 0 ? best_origin : 0;
        out[4 * B + b] = best_query_stop;
        out[5 * B + b] = best_matches;
        out[6 * B + b] = best_cost;
        out[7 * B + b] = 0;
        if (STATS) {
            atomicAdd(stats + 0, columns);
            atomicAdd(stats + 1, rounds);
            atomicAdd(stats + 2, fix_rows);
        }
    }
}

// Replaces pallas_kernel.py::_dp_kernel_fused: the whole cell in one 32-bit
// word, the column in registers (dp_body_reg) for adapters of up to 63
// bases.
template <int R>
__global__ void dp_locate_word32_reg_kernel(
    const uint8_t* __restrict__ reads, const int32_t* __restrict__ lengths,
    int32_t* __restrict__ out, const uint8_t* __restrict__ ref,
    const int32_t* __restrict__ thr, const DpParams p)
{
    dp_body_reg<R>(reads, lengths, out, ref, thr, p);
}

// The same kernel for longer adapters, the column in shared or global
// memory (dp_body); the narrow word halves the memory a column takes, so
// twice as many reads of a long adapter fit a block as with the 64-bit
// word.
template <bool GLOBAL_COL>
__global__ void dp_locate_word32_kernel(
    const uint8_t* __restrict__ reads, const int32_t* __restrict__ lengths,
    int32_t* __restrict__ out, const uint8_t* __restrict__ ref,
    const int32_t* __restrict__ thr, uint32_t* __restrict__ col,
    const DpParams p)
{
    dp_body<uint32_t, GLOBAL_COL>(reads, lengths, out, ref, thr, col, p);
}

// Replaces pallas_kernel.py::_dp_kernel, the TPU's two-plane kernel for
// shapes its one-word layout refuses: here one 64-bit word a cell, for
// (m, k, L) whose fields need more than 32 bits. Bound by integer operations
// as above; 64-bit shifts and selects cost two 32-bit operations each, and a
// column takes twice the memory, which the wrapper answers with narrower
// blocks, then with the column in global memory.
template <bool GLOBAL_COL>
__global__ void dp_locate_wide_kernel(
    const uint8_t* __restrict__ reads, const int32_t* __restrict__ lengths,
    int32_t* __restrict__ out, const uint8_t* __restrict__ ref,
    const int32_t* __restrict__ thr, unsigned long long* __restrict__ col,
    const DpParams p)
{
    dp_body<unsigned long long, GLOBAL_COL>(reads, lengths, out, ref, thr, col, p);
}

// The same kernel with one warp a read (dp_body_warp), STRIP_ROWS rows a
// lane, for adapters of up to 32 STRIP_ROWS bases whose cell a 32-bit word
// cannot hold: at such adapters one read a thread holds one or two warps an
// SM (see the note at the top). The one size built and measured.
constexpr int STRIP_ROWS = 28;

template <bool STATS>
__global__ void dp_locate_wide_warp_kernel(
    const uint8_t* __restrict__ reads, const int32_t* __restrict__ lengths,
    int32_t* __restrict__ out, const uint8_t* __restrict__ ref,
    const int32_t* __restrict__ thr, unsigned long long* __restrict__ stats,
    const DpParams p)
{
    dp_body_warp<STRIP_ROWS, STATS>(reads, lengths, out, ref, thr, stats, p);
}

// col == nullptr: the shared-memory instantiation of dp_body; else the
// global-column one, with col the [m + 1, B] scratch buffer.
template <typename Word>
int launch(void (*shared_kernel)(const uint8_t*, const int32_t*, int32_t*,
                                 const uint8_t*, const int32_t*, Word*,
                                 DpParams),
           void (*global_kernel)(const uint8_t*, const int32_t*, int32_t*,
                                 const uint8_t*, const int32_t*, Word*,
                                 DpParams),
           const void* reads, const void* lengths, void* out, const void* ref,
           const void* thr, void* col, const DpParams& p, int threads,
           void* stream)
{
    const int blocks = (p.B + threads - 1) / threads;
    if (col != nullptr) {
        global_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)reads, (const int32_t*)lengths, (int32_t*)out,
            (const uint8_t*)ref, (const int32_t*)thr, (Word*)col, p);
        return (int)cudaGetLastError();
    }
    const size_t smem = sizeof(Word) * (size_t)(p.m + 1) * threads +
                        sizeof(int32_t) * (size_t)(p.m + 1) + (size_t)p.m;
    cudaError_t err = allow_shared_bytes((const void*)shared_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    shared_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)reads, (const int32_t*)lengths, (int32_t*)out,
        (const uint8_t*)ref, (const int32_t*)thr, nullptr, p);
    return (int)cudaGetLastError();
}

int launch_reg(int row_cap, const void* reads, const void* lengths,
               void* out, const void* ref, const void* thr, const DpParams& p,
               int threads, void* stream)
{
    void (*kernel)(const uint8_t*, const int32_t*, int32_t*, const uint8_t*,
                   const int32_t*, DpParams);
    switch (row_cap) {
        case 16: kernel = dp_locate_word32_reg_kernel<16>; break;
        case 32: kernel = dp_locate_word32_reg_kernel<32>; break;
        case 48: kernel = dp_locate_word32_reg_kernel<48>; break;
        case 64: kernel = dp_locate_word32_reg_kernel<64>; break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (p.m + 1 > row_cap) return (int)cudaErrorInvalidValue;
    const int blocks = (p.B + threads - 1) / threads;
    kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)reads, (const int32_t*)lengths, (int32_t*)out,
        (const uint8_t*)ref, (const int32_t*)thr, p);
    return (int)cudaGetLastError();
}

int launch_warp(const void* reads, const void* lengths, void* out,
                const void* ref, const void* thr, void* stats,
                const DpParams& p, int threads, void* stream)
{
    if (p.m > 32 * STRIP_ROWS || threads % 32 != 0) return (int)cudaErrorInvalidValue;
    const auto kernel = stats != nullptr ? dp_locate_wide_warp_kernel<true>
                                         : dp_locate_wide_warp_kernel<false>;
    const int warps = threads / 32;
    const int blocks = (p.B + warps - 1) / warps;
    const size_t smem = sizeof(int32_t) * (size_t)(p.m + 1);
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)reads, (const int32_t*)lengths, (int32_t*)out,
        (const uint8_t*)ref, (const int32_t*)thr, (unsigned long long*)stats,
        p);
    return (int)cudaGetLastError();
}

DpParams make_params(int L, int B, int m, int k, int flags, int min_overlap,
                     int ins_cost, int del_cost, int compare_ascii,
                     int mat_bits, int org_bits)
{
    DpParams p;
    p.L = L; p.B = B; p.m = m; p.k = k; p.flags = flags;
    p.min_overlap = min_overlap; p.ins_cost = ins_cost; p.del_cost = del_cost;
    p.compare_ascii = compare_ascii; p.mat_bits = mat_bits;
    p.org_bits = org_bits;
    return p;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on the given
// stream without synchronizing and returns cudaGetLastError(); col is
// nullptr, or the global-memory column for adapters whose column does not
// fit shared memory.
extern "C" {

// row_cap 16, 32, 48 or 64: dp_body_reg with that many rows (col must be
// nullptr); 0: dp_body, in shared memory or, given col, in global memory.
int dp_locate_word32(const void* reads, const void* lengths, void* out,
                     const void* ref, const void* thr, void* col, int L, int B,
                     int m, int k, int flags, int min_overlap, int ins_cost,
                     int del_cost, int compare_ascii, int mat_bits,
                     int org_bits, int row_cap, int threads, void* stream)
{
    const DpParams p = make_params(L, B, m, k, flags, min_overlap, ins_cost,
                                   del_cost, compare_ascii, mat_bits, org_bits);
    if (row_cap != 0) {
        if (col != nullptr) return (int)cudaErrorInvalidValue;
        return launch_reg(row_cap, reads, lengths, out, ref, thr, p, threads,
                          stream);
    }
    return launch<uint32_t>(
        dp_locate_word32_kernel<false>, dp_locate_word32_kernel<true>, reads,
        lengths, out, ref, thr, col, p, threads, stream);
}

// row_cap STRIP_ROWS: dp_body_warp (col must be nullptr; given stats, the
// instrumented launch, whose [3] counts gain its columns, fix-up rounds and
// fix-up row steps, summed over warps); 0: dp_body, in shared memory or,
// given col, in global memory (stats unused).
int dp_locate_wide(const void* reads, const void* lengths, void* out,
                   const void* ref, const void* thr, void* col, int L, int B,
                   int m, int k, int flags, int min_overlap, int ins_cost,
                   int del_cost, int compare_ascii, int mat_bits,
                   int org_bits, int row_cap, int threads, void* stream,
                   void* stats)
{
    const DpParams p = make_params(L, B, m, k, flags, min_overlap, ins_cost,
                                   del_cost, compare_ascii, mat_bits, org_bits);
    if (row_cap != 0) {
        if (row_cap != STRIP_ROWS || col != nullptr) return (int)cudaErrorInvalidValue;
        return launch_warp(reads, lengths, out, ref, thr, stats, p, threads,
                           stream);
    }
    return launch<unsigned long long>(
        dp_locate_wide_kernel<false>, dp_locate_wide_kernel<true>, reads,
        lengths, out, ref, thr, col, p, threads, stream);
}

}  // extern "C"
