// Banded semi-global adapter-alignment DP for Hopper (sm_90a), one thread
// per read.
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
// [8, B] int32 output. They are two instantiations of one device function
// that differ only in the cell word, and each is launched, counted and
// checked on its own.
//
// What bounds them on this card: integer ALU work. A batch needs up to
// B * L * (m + 1) cell updates of OPS_PER_CELL (24, counted below) integer
// operations each, while the bytes - L * B in, 32 * B out - are three
// orders of magnitude below what the memory system moves in that time.
//
// What the design does about it:
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
//     tell from the true cost) because the column lives in shared memory:
//     m + 1 cells a thread, laid out [row][thread] so that a warp's 32
//     threads hit 32 different banks. m, k, the flags, the costs, the
//     adapter bytes and the threshold table are run-time arguments, so one
//     build serves every adapter.
//   * An adapter whose column does not fit shared memory even for one
//     warp (m + 1 words a thread times 32 threads above 232,448 bytes:
//     m > about 1,800 for the 32-bit word, 900 for the 64-bit one) keeps
//     its column in global memory instead, in a scratch buffer of
//     [m + 1, B] words that the wrapper allocates, laid out [row][read] so
//     that a warp's 32 accesses to one row are one coalesced transaction;
//     the adapter bytes and thresholds are then read from global memory
//     too. Each exported kernel so has two instantiations of the same
//     device function, picked by the entry point: the results are the
//     same, only where the column lives differs.
//   * Reads arrive [L, B] uint8: in column j a warp loads 32 neighbouring
//     bytes. A warp leaves the column loop as soon as all its reads are
//     past their last column or have found an exact match.
//
// OPS_PER_CELL, one inner-loop iteration of dp_body: shared-memory address
// (1), load old cell, load adapter byte, compare (2), three cost extracts
// (3), three candidate costs (3), two compares and the and (3), three
// selects of the cost and three of the payload (6), clamp (1), repack (2),
// band test and select (2), loop counter (1) = 24.
//
// Thresholds floor(err * len) come in as an int32 table computed on the
// host in float64; the kernels look it up and never multiply a float.

#include <cuda_runtime.h>
#include <stdint.h>

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

// Replaces pallas_kernel.py::_dp_kernel_fused: the whole cell in one 32-bit
// word. Bound by integer operations (see the note at the top); the narrow
// word halves the memory a column takes, so twice as many reads of a long
// adapter fit a block as with the 64-bit word.
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

// col == nullptr: the shared-memory instantiation; else the global-column
// one, with col the [m + 1, B] scratch buffer.
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
    cudaError_t err = cudaFuncSetAttribute(
        shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    shared_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)reads, (const int32_t*)lengths, (int32_t*)out,
        (const uint8_t*)ref, (const int32_t*)thr, nullptr, p);
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

int dp_locate_word32(const void* reads, const void* lengths, void* out,
                     const void* ref, const void* thr, void* col, int L, int B,
                     int m, int k, int flags, int min_overlap, int ins_cost,
                     int del_cost, int compare_ascii, int mat_bits,
                     int org_bits, int threads, void* stream)
{
    return launch<uint32_t>(
        dp_locate_word32_kernel<false>, dp_locate_word32_kernel<true>, reads,
        lengths, out, ref, thr, col,
        make_params(L, B, m, k, flags, min_overlap, ins_cost, del_cost,
                    compare_ascii, mat_bits, org_bits),
        threads, stream);
}

int dp_locate_wide(const void* reads, const void* lengths, void* out,
                   const void* ref, const void* thr, void* col, int L, int B,
                   int m, int k, int flags, int min_overlap, int ins_cost,
                   int del_cost, int compare_ascii, int mat_bits,
                   int org_bits, int threads, void* stream)
{
    return launch<unsigned long long>(
        dp_locate_wide_kernel<false>, dp_locate_wide_kernel<true>, reads,
        lengths, out, ref, thr, col,
        make_params(L, B, m, k, flags, min_overlap, ins_cost, del_cost,
                    compare_ascii, mat_bits, org_bits),
        threads, stream);
}

}  // extern "C"
