// The dtype probe of the DP column body for Hopper (sm_90a): the same
// column function with 32-bit cells and with two reads' 16-bit cells
// packed in one 32-bit register.
//
// Two exported kernels replace the one Pallas kernel of
// tools/perf_dtype_probe.py:25 (body_full), which the TPU tool runs with
// int32 and with int16 state:
//
//   dtype_probe_i32    one thread a read, int32 cells
//   dtype_probe_i16x2  one thread two reads; the two reads' 16-bit cells
//                      share each 32-bit register and are computed with
//                      the SIMD-in-word intrinsics (__vadd2, __vcmpeq2,
//                      __vcmpltu2, __vminu2, bitwise selects)
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
// column and grows by at most 3 + 3 * 2 within one; pay grows by at most
// one a column, so stays <= L), so the unsigned 16-bit compares of the
// packed kernel are exact and both kernels give identical outputs.
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
// same 24 operations on two cells a 32-bit lane, if each intrinsic costs
// one instruction; that is the question the probe asks of Hopper.
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
//     plane a read (an L1/L2 hit after the first row), without it the
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
//   * What bounds them in practice (chip_smoke.py on an NVIDIA H100 80GB
//     HBM3 at 700.00 W; PERF.md): the 32-bit kernel ran at 1.8x the issue
//     bound of its 24 operations a cell at the main path's shape (32,768
//     reads, 1,024 warps) and at 2.4x at the TPU tool's (16,384 reads, 512
//     warps for the card's 528 schedulers, so latency shows). The packed
//     kernel is slower at both: its SASS is mostly LOP3 bitwise
//     instructions, because only the halfword minimum (__vminu2) is one
//     Hopper instruction while the halfword compares and adds are built
//     from several, so two cells a word do not halve the instructions;
//     and its half as many warps hide less latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int M1 = 34;  // TruSeq's m + 1 state rows
constexpr int OUT_ROWS = 8;
constexpr int THREADS = 128;

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

// Two reads a thread: read 2t in the low halfword, read 2t + 1 in the
// high halfword of every register.
template <int R>
__device__ __forceinline__ void probe_i16x2_body(
    const uint8_t* __restrict__ reads,  // [L, N], N even
    int32_t* __restrict__ out,          // [8, N]
    int32_t* __restrict__ state,        // [2, R, N] or null
    const int L, const int N, const int dyn, const int zero)
{
    constexpr int m = R - 1;
    const int half = N >> 1;
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= half) return;
    // row i of the plane as 16-bit words: word t holds reads 2t and 2t + 1
    const uint16_t* __restrict__ words = (const uint16_t*)reads;
    const size_t stride = (size_t)half;
    const uint32_t ones = 0x00010001u, twos = 0x00020002u, threes = 0x00030003u;
    const uint32_t keep = 0xff80ff80u, cap = 0x02000200u;
    uint32_t rd[m];
#pragma unroll
    for (int i = 0; i < m; ++i)
        rd[i] = __byte_perm((uint32_t)words[(size_t)i * stride + t], 0u, 0x4140);
    const uint32_t init = ((uint32_t)zero & 0xffffu) * ones;
    uint32_t pack[R], pay[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        pack[i] = init;
        pay[i] = init;
    }
    for (int j = 1; j <= L; ++j) {
        const uint32_t q = dyn
            ? __byte_perm((uint32_t)words[(size_t)(j - 1) * stride + t], 0u, 0x4140)
            : rd[0];
        uint32_t eq[m];
#pragma unroll
        for (int i = m - 1; i >= 0; --i) {
            eq[i] = __vcmpeq2(rd[i], q);
            const uint32_t diag = __vadd2(pack[i], ones);
            const uint32_t del = __vadd2(pack[i + 1], threes);
            const uint32_t loc = __vminu2(diag, del);
            const uint32_t elem = (pack[i] & eq[i]) | (loc & ~eq[i]);
            const uint32_t pay_e =
                (__vadd2(pay[i], ones) & eq[i]) | (pay[i + 1] & ~eq[i]);
            pack[i + 1] = elem;
            pay[i + 1] = pay_e;
        }
#pragma unroll
        for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
            for (int i = m - 1; i >= 0; --i) {
                const uint32_t cand = __vadd2(pack[i], twos);
                const uint32_t tail = pack[i + 1];
                const uint32_t take = __vcmpltu2(cand, tail) & ~eq[i];
                pack[i + 1] = (cand & take) | (tail & ~take);
                pay[i + 1] = (pay[i] & take) | (pay[i + 1] & ~take);
            }
        }
#pragma unroll
        for (int i = 0; i < R; ++i) pack[i] = __vminu2(pack[i] & keep, cap);
    }
#pragma unroll
    for (int k = 0; k < OUT_ROWS; ++k) {
        const uint32_t sum = __vadd2(pack[k], pay[k]);
        int2 pair;
        pair.x = (int32_t)(sum & 0xffffu);
        pair.y = (int32_t)(sum >> 16);
        *(int2*)(out + (size_t)k * N + 2 * (size_t)t) = pair;
    }
    if (state != nullptr) {
#pragma unroll
        for (int i = 0; i < 2 * R; ++i) {
            const uint32_t word = i < R ? pack[i] : pay[i - R];
            int2 pair;
            pair.x = (int32_t)(word & 0xffffu);
            pair.y = (int32_t)(word >> 16);
            *(int2*)(state + (size_t)i * N + 2 * (size_t)t) = pair;
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
    const int blocks = (N / 2 + THREADS - 1) / THREADS;
    dtype_probe_i16x2_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)reads, (int32_t*)out, (int32_t*)state, L, N, dyn, zero);
    return (int)cudaGetLastError();
}

}  // extern "C"
