// The dtype probe of the DP column body for Hopper (sm_90a): the same
// column function with 32-bit cells and with two reads' 16-bit cells
// packed in one 32-bit register.
//
// Two exported kernels replace the one Pallas kernel of
// tools/perf_dtype_probe.py:25 (body_full), which the TPU tool runs with
// int32 and with int16 state:
//
//   dtype_probe_i32    one thread a read, int32 cells
//   dtype_probe_i16x2  two reads' 16-bit cells in each 32-bit register,
//                      the pair's rows split over PAIR_LANES lanes; every
//                      per-halfword step is a plain 32-bit add or multiply
//                      that cannot carry across halfwords, a Hopper DPX
//                      minimum (__viaddmin_u16x2, __vminu2) or a select
//                      by a halfword mask
//
// The function, for a batch of N reads given as a [L, N] uint8 plane (the
// bytes of one position of all reads side by side), with M1 = 34 state
// rows (m = 33, TruSeq's length) of pack and pay per read, both starting
// at 0, and for every column j in 1..L:
//
//   q     = read byte j-1 (dyn) or byte 0 (not dyn)
//   eq[i] = read byte i == q                              for i < m
//   row i+1 of pack = eq[i] ? pack[i] : min(pack[i] + 1, pack[i+1] + 3)
//   row i+1 of pay  = eq[i] ? pay[i] + 1 : pay[i+1]       (row 0 is kept)
//   three relaxation passes, each over all rows at once:
//     take[i] = pack[i] + 2 < pack[i+1] and not eq[i]
//     row i+1 of pack = take ? pack[i] + 2 : pack[i+1]
//     row i+1 of pay  = take ? pay[i] : pay[i+1]
//   pack = min(pack & ~127, 512)
//
// and out[k, n] = pack[k] + pay[k] for k < 8, as int32. Every value is
// non-negative and stays far below 32,768 (pack is clamped to 512 each
// column and grows by at most 3 within one, since a relaxation pass only
// lowers it; pay grows by at most one a column, so stays <= L), so the
// unsigned 16-bit arithmetic of the packed kernel is exact (the range is
// proved below) and both kernels give identical outputs.
//
// The 16-bit kernel computes the rule as addends and minima. Per row and
// column, from ne = min(rd ^ q, 1) per halfword (1 where the bytes differ;
// both bytes are <= 255):
//   pack[i+1] = min(pack[i] + ne, pack[i+1] + (3, or NEVER + 3 where eq))
//               one __viaddmin_u16x2; where eq it is pack[i]
//   pay[i+1]  = ne ? pay[i+1] : pay[i] + 1, a select by ne * 0xffff
//   a pass:   low = min(pack[i] + (2, or NEVER where eq), pack[i+1])
//               one __viaddmin_u16x2: where eq, pack[i] + NEVER > pack[i+1]
//             take = min(pack[i+1] - low, 1) * 0xffff (strict: a tie
//               gives low == pack[i+1], so take 0 and the tail's pay)
//             pack[i+1] = low; pay[i+1] = take ? pay[i] : pay[i+1]
// with NEVER = 0x4000 (16,384). The range, per halfword: pack <= 512
// after each clamp and <= 515 within a column (the cell step adds at most
// 3, a pass only lowers), so every sum stays below 17,000: pack + NEVER +
// 3 <= 16,902, pack + NEVER <= 16,899, pack + ne <= 516; the addends
// 0x4003 - 0x4000 ne and 0x4000 - 0x3ffe ne lie in 2..16,387; ne * 0xffff
// and ne * 0x3ffe are at most 0xffff; pack[i+1] - low lies in 0..515 with
// low <= pack[i+1]; pay + 1 <= L + 1 and pack + pay <= 512 + L, below
// 65,536 for the L < 32,768 that the int16 state of the TPU tool holds.
// So no halfword of a plain 32-bit add, subtract or multiply carries or
// borrows into the other, and no DPX sum wraps (a start above 512 would
// be outside this proof; the wrapper starts the state at 0).
// tests/test_torch_dtype_probe_words.py emulates these steps on 32-bit
// words in numpy and asserts every one of these ranges. From the zero
// start pack stays 0 or 1 and no pass ever takes, so no input the
// wrappers accept shows the take path at work on the card: the emulation
// checks it from random start states and over every pack pair of one step.
//
// The TPU tool's use_concat flag only changes how the TPU builds the
// shifted state vector (a sublane concatenate or a masked select of a
// padded copy); its results are the same. A register file has no such
// choice to make, so it has no counterpart here and no third kernel.
//
// What bounds these kernels on this card: integer operations. A cell
// update (one row of one column) costs 24 of them in the body above: the
// compare for eq; diag, del and their minimum (the TPU body's compare and
// select, one min here); the select of pack; the add and select of pay;
// 5 in each of 3 relaxation passes; the mask and the clamp. The bytes are
// negligible: L * N bytes in and 32 * N out. The packed kernel does the
// same work on two cells a 32-bit lane.
//
// What the design does about it, and what it cannot do:
//   * Both states (2 * 34 registers, or 34 pairs for two reads) and the
//     read's first m bytes live in registers; the row loops over M1 are
//     unrolled (M1 is a template constant), so no state touches memory.
//     The relaxation passes run over the rows in descending order, in
//     place: row i+1 is written after row i+2 was, and before row i is,
//     so every row reads the values of the previous pass, as the vector
//     passes of the TPU kernel do.
//   * Neighbouring threads take neighbouring reads, so the row loads of
//     the [L, N] plane coalesce (a warp's 32 bytes, or 64 for the packed
//     kernel, which loads two adjacent reads' bytes as one 16-bit word).
//   * dyn is a run-time flag: with it each column loads one byte of the
//     plane a read (the packed kernel a column ahead), without it the
//     query is register 0.
//   * Every row stays live. The output reads rows 0-7 only, and a row
//     depends on itself and the row above, so a compiler may drop rows
//     8-33 and with them 26 of the 33 rows' work (nvcc does: the first
//     build of these kernels computed 7 rows). The TPU kernel computes
//     all rows of its vectors; to time the same column body here, each
//     kernel can also store its whole final state ([2, M1, N] int32:
//     pack, then pay), selected by a run-time pointer, so every row is
//     computed whether or not the wrapper asks for it. Likewise the state
//     starts at a run-time value (the wrapper passes 0): with constant
//     zeros the compiler could prove that pack never leaves 0.
//   * The packed kernel's compare is one XOR and one __vminu2 a row and
//     column, and what it feeds is arithmetic (three multiplies by ne),
//     not masks rebuilt in every pass. Its first form emulated the
//     halfword compares and adds (__vcmpeq2, __vcmpltu2 and __vadd2
//     expand into LOP3 and PRMT chains on Hopper): 35.5 instructions a
//     row and word (cuda_tools/sass_rows.py --probe) and 0.275 ms at the
//     main path's shape, where the 32-bit kernel takes 0.186. This form
//     takes 28.4 a row and word (the 32-bit kernel 20.3 a row): each pass
//     is a VIADDMNMX, a subtract, a VIMNMX, an IMAD and a LOP3 select.
//   * Two reads a thread give half as many warps as the 32-bit kernel: at
//     the TPU tool's shape (16,384 reads, 8,192 pairs) one lane a pair is
//     256 warps for the card's 528 schedulers, whatever the block width.
//     PAIR_LANES = 2 lanes split a pair's rows (17 each) and pass one
//     boundary row of pack and pay by shuffle for the cell step and each
//     pass (8 SHFL a column): 0.0445 ms there against 0.0750 for one lane,
//     0.1112 against 0.1146 at the main path's shape. The block width (32,
//     64 or 128 threads) changes nothing measurable; PROBE16_THREADS is 64.
//   * What bounds it now, inferred from the SASS and the times: the
//     integer logic pipe. 268 of a lane's 481 instructions a column are
//     LOP3, VIMNMX, VIADDMNMX or SHFL; at one warp instruction every two
//     cycles a scheduler they fill some 78 % of the measured time, and a
//     form with 3 fewer instructions a row but more of these (a PRMT take
//     mask) ran 4.6 % slower. 112 registers, no spills. (Times: the
//     kernel alone, NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int M1 = 34;  // TruSeq's m + 1 state rows
constexpr int OUT_ROWS = 8;
constexpr int THREADS = 128;
// the 16-bit kernel: lanes that split a read pair's rows, and block width
constexpr int PAIR_LANES = 2;
constexpr int PROBE16_THREADS = 64;
constexpr unsigned FULL_WARP = 0xffffffffu;
// per-halfword constants of the packed rule (see the note at the top)
constexpr uint32_t ONES = 0x00010001u;
constexpr uint32_t NEVER = 0x4000u;  // an addend that never wins a minimum
constexpr uint32_t NEVER2 = NEVER * ONES;
constexpr uint32_t KEEP = 0xff80ff80u, CAP = 0x02000200u;  // the clamp

template <int R>
__device__ __forceinline__ void probe_i32_body(
    const uint8_t* __restrict__ reads,  // [L, N]
    int32_t* __restrict__ out,          // [8, N]
    int32_t* __restrict__ state,        // [2, R, N] or null
    const int L, const int N, const int dyn, const int zero)
{
    constexpr int m = R - 1;
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    const size_t stride = (size_t)N;
    int32_t rd[m];
#pragma unroll
    for (int i = 0; i < m; ++i) rd[i] = reads[(size_t)i * stride + n];
    int32_t pack[R], pay[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        pack[i] = zero;
        pay[i] = zero;
    }
    for (int j = 1; j <= L; ++j) {
        const int32_t q = dyn ? (int32_t)reads[(size_t)(j - 1) * stride + n] : rd[0];
        bool eq[m];
#pragma unroll
        for (int i = m - 1; i >= 0; --i) {
            eq[i] = rd[i] == q;
            const int32_t diag = pack[i] + 1;
            const int32_t del = pack[i + 1] + 3;
            const int32_t loc = diag <= del ? diag : del;
            const int32_t elem = eq[i] ? pack[i] : loc;
            const int32_t pay_e = eq[i] ? pay[i] + 1 : pay[i + 1];
            pack[i + 1] = elem;
            pay[i + 1] = pay_e;
        }
#pragma unroll
        for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
            for (int i = m - 1; i >= 0; --i) {
                const int32_t cand = pack[i] + 2;
                const int32_t tail = pack[i + 1];
                const bool take = (cand < tail) & !eq[i];
                pack[i + 1] = take ? cand : tail;
                pay[i + 1] = take ? pay[i] : pay[i + 1];
            }
        }
#pragma unroll
        for (int i = 0; i < R; ++i) pack[i] = min(pack[i] & ~127, 512);
    }
#pragma unroll
    for (int k = 0; k < OUT_ROWS; ++k) out[(size_t)k * stride + n] = pack[k] + pay[k];
    if (state != nullptr) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
            state[(size_t)i * stride + n] = pack[i];
            state[(size_t)(R + i) * stride + n] = pay[i];
        }
    }
}

// Two reads a word: read 2t in the low halfword, read 2t + 1 in the high
// halfword of every register. The M1 state rows of a read pair are split
// over PAIR_LANES neighbouring lanes, RL rows each: lane part p holds rows
// p * RL .. p * RL + RL - 1 and takes the row above its first from lane
// p - 1 by shuffle, once for the cell step and once a relaxation pass.
// Every per-halfword step is an addend, a DPX minimum or a select by a
// halfword mask; see the note at the top for the rule and its range.
template <int R>
__device__ __forceinline__ void probe_i16x2_body(
    const uint8_t* __restrict__ reads,  // [L, N], N even
    int32_t* __restrict__ out,          // [8, N]
    int32_t* __restrict__ state,        // [2, R, N] or null
    const int L, const int N, const int dyn, const int zero)
{
    constexpr int RL = R / PAIR_LANES;
    static_assert(RL * PAIR_LANES == R && RL >= OUT_ROWS, "rows split evenly, output in part 0");
    const int half = N >> 1;
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    const int part = g % PAIR_LANES;
    const int t = g / PAIR_LANES;
    // the lanes past the last pair stay for the shuffles and store nothing
    const bool live = t < half;
    const int tl = live ? t : half - 1;
    const bool first_part = part == 0;  // holds row 0, which no step writes
    // row i of the plane as 16-bit words: word t holds reads 2t and 2t + 1
    const uint16_t* __restrict__ words = (const uint16_t*)reads;
    const size_t stride = (size_t)half;
    // local row r is row part * RL + r, updated from byte part * RL + r - 1
    uint32_t rd[RL];
#pragma unroll
    for (int r = 0; r < RL; ++r) {
        const int i = max(part * RL + r - 1, 0);
        rd[r] = __byte_perm((uint32_t)words[(size_t)i * stride + tl], 0u, 0x4140);
    }
    const uint32_t first = __byte_perm((uint32_t)words[tl], 0u, 0x4140);
    const uint32_t init = ((uint32_t)zero & 0xffffu) * ONES;
    uint32_t pack[RL], pay[RL];
#pragma unroll
    for (int r = 0; r < RL; ++r) {
        pack[r] = init;
        pay[r] = init;
    }
    uint32_t q_next = dyn ? first : 0u;
    for (int j = 1; j <= L; ++j) {
        const uint32_t q = dyn ? q_next : first;
        // the next column's query word, loaded a column ahead
        if (dyn && j < L)
            q_next = __byte_perm((uint32_t)words[(size_t)j * stride + tl], 0u, 0x4140);
        uint32_t above_pack = pack[RL - 1], above_pay = pay[RL - 1];
        if (PAIR_LANES > 1) {
            above_pack = __shfl_up_sync(FULL_WARP, above_pack, 1);
            above_pay = __shfl_up_sync(FULL_WARP, above_pay, 1);
        }
        const uint32_t keep_pack = pack[0], keep_pay = pay[0];
        uint32_t relax[RL];
#pragma unroll
        for (int r = RL - 1; r >= 0; --r) {
            const uint32_t up_pack = r ? pack[r - 1] : above_pack;
            const uint32_t up_pay = r ? pay[r - 1] : above_pay;
            // 1 in a halfword whose bytes differ, else 0 (both bytes <= 255)
            const uint32_t ne = __vminu2(rd[r] ^ q, ONES);
            const uint32_t ne_mask = ne * 0xffffu;
            relax[r] = NEVER2 - ne * (NEVER - 2u);          // 2, or NEVER where equal
            const uint32_t del = pack[r] + (NEVER2 + 3u * ONES - ne * NEVER);
            // min(pack[i] + 1, pack[i+1] + 3), or pack[i] where equal
            pack[r] = __viaddmin_u16x2(up_pack, ne, del);
            pay[r] = (pay[r] & ne_mask) | ((up_pay + ONES) & ~ne_mask);
        }
        if (first_part) {
            pack[0] = keep_pack;
            pay[0] = keep_pay;
            relax[0] = NEVER2;  // row 0 never takes in a pass
        }
#pragma unroll
        for (int pass = 0; pass < 3; ++pass) {
            above_pack = pack[RL - 1];
            above_pay = pay[RL - 1];
            if (PAIR_LANES > 1) {
                above_pack = __shfl_up_sync(FULL_WARP, above_pack, 1);
                above_pay = __shfl_up_sync(FULL_WARP, above_pay, 1);
            }
#pragma unroll
            for (int r = RL - 1; r >= 0; --r) {
                const uint32_t up_pack = r ? pack[r - 1] : above_pack;
                const uint32_t up_pay = r ? pay[r - 1] : above_pay;
                const uint32_t tail = pack[r];
                const uint32_t low = __viaddmin_u16x2(up_pack, relax[r], tail);
                // take = low < tail: tail - low borrows nowhere (low <= tail)
                const uint32_t take = __vminu2(tail - low, ONES) * 0xffffu;
                pack[r] = low;
                pay[r] = (up_pay & take) | (pay[r] & ~take);
            }
        }
#pragma unroll
        for (int r = 0; r < RL; ++r) pack[r] = __vminu2(pack[r] & KEEP, CAP);
    }
    if (!live) return;
    if (first_part) {
#pragma unroll
        for (int k = 0; k < OUT_ROWS; ++k) {
            const uint32_t sum = pack[k] + pay[k];
            int2 pair;
            pair.x = (int32_t)(sum & 0xffffu);
            pair.y = (int32_t)(sum >> 16);
            *(int2*)(out + (size_t)k * N + 2 * (size_t)t) = pair;
        }
    }
    if (state != nullptr) {
#pragma unroll
        for (int r = 0; r < 2 * RL; ++r) {
            const uint32_t word = r < RL ? pack[r] : pay[r - RL];
            const int row = r < RL ? part * RL + r : R + part * RL + r - RL;
            int2 pair;
            pair.x = (int32_t)(word & 0xffffu);
            pair.y = (int32_t)(word >> 16);
            *(int2*)(state + (size_t)row * N + 2 * (size_t)t) = pair;
        }
    }
}

__global__ void dtype_probe_i32_kernel(
    const uint8_t* __restrict__ reads, int32_t* __restrict__ out,
    int32_t* __restrict__ state,
    const int L, const int N, const int dyn, const int zero)
{
    probe_i32_body<M1>(reads, out, state, L, N, dyn, zero);
}

__global__ void dtype_probe_i16x2_kernel(
    const uint8_t* __restrict__ reads, int32_t* __restrict__ out,
    int32_t* __restrict__ state,
    const int L, const int N, const int dyn, const int zero)
{
    probe_i16x2_body<M1>(reads, out, state, L, N, dyn, zero);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on the given
// stream without synchronizing and returns cudaGetLastError(). L must be
// at least m = 33 (the reads' first m bytes are the rows compared), and N
// even for the packed kernel; the wrapper checks both. state may be
// null; otherwise it receives the final [2, M1, N] state.
extern "C" {

int dtype_probe_m1() { return M1; }

int dtype_probe_i32(const void* reads, void* out, void* state, int L, int N,
                    int dyn, int zero, void* stream)
{
    if (L < M1 - 1 || N <= 0) return (int)cudaErrorInvalidValue;
    const int blocks = (N + THREADS - 1) / THREADS;
    dtype_probe_i32_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)reads, (int32_t*)out, (int32_t*)state, L, N, dyn, zero);
    return (int)cudaGetLastError();
}

int dtype_probe_i16x2(const void* reads, void* out, void* state, int L, int N,
                      int dyn, int zero, void* stream)
{
    if (L < M1 - 1 || N <= 0 || (N & 1)) return (int)cudaErrorInvalidValue;
    const int lanes = N / 2 * PAIR_LANES;
    const int blocks = (lanes + PROBE16_THREADS - 1) / PROBE16_THREADS;
    dtype_probe_i16x2_kernel<<<blocks, PROBE16_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)reads, (int32_t*)out, (int32_t*)state, L, N, dyn, zero);
    return (int)cudaGetLastError();
}

}  // extern "C"
