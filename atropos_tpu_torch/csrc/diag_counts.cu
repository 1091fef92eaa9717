// Diagonal match counts of the paired-end insert matcher for Hopper
// (sm_90a), one thread per (pair, diagonal).
//
// Two exported kernels, one for each Pallas kernel of
// atropos_tpu/align/pallas_kernel.py:
//
//   diag_counts_u8   replaces  _packed_diag_kernel  (counts in 8 bits,
//                                                    W <= 255)
//   diag_counts_i32  replaces  _diag_counts_kernel  (counts in 32 bits,
//                                                    any W)
//
// Both compute, for a batch of B read pairs given as two [W, B] uint8
// byte planes (ref = reverse-complemented read2, query = read1, column
// major: the bytes of one position of all pairs lie side by side) and the
// per-pair lengths m_b:
//
//   counts[s, b] = sum over t < min(W, m_b - s) of
//                  [ref[(s + t) mod W, b] == query[t, b]]
//
// for every diagonal s < W: without indels every path of the insert
// aligner's DP is a diagonal, so the whole DP collapses to these counts.
// (The reference rotates the ref plane, hence the mod W; the turbo step
// never passes m_b > W.) They are two instantiations of one device
// function that differ only in the type of the output, and each is
// launched, counted and checked on its own.
//
// What bounds them on this card: integer operations. A batch needs
// sum_b sum_s (m_b - s), about B * W^2 / 2, byte compares, while the
// bytes - 2 * W * B in, W * B (u8) or 4 * W * B (i32) out - take the
// memory system a fraction of that time; the planes of one batch (about
// 10 MB at W = 160, B = 32768) stay in the 50 MB L2 cache.
//
// What the design does about it:
//   * The TPU kernels are shaped by the vector unit: the query plane stays
//     in VMEM while the ref plane rotates one sublane per diagonal, and
//     the packed kernel encodes 4-bit symbol codes 8 a word with sentinels
//     in place of masks and four 8-bit counts a word out, because the
//     write of a [W, B] int32 plane dominated there. On Hopper byte loads
//     and compares are native, so no codes, sentinels or packing: the
//     8-bit output of diag_counts_u8 is the one thing kept, as it quarters
//     the bytes written.
//   * A thread computes one (pair, diagonal) cell of the output, so a batch
//     of B = 32768 pairs at W = 160 gives 160 * 1024 warps: enough to hide
//     the latency of the L2-resident byte loads without any tiling.
//     Neighbouring threads take neighbouring pairs, so a warp's 32 loads
//     of one plane row fall in one 32-byte sector.
//   * The diagonal s comes from blockIdx.y (grid-strided above 65535), the
//     pair from blockIdx.x; the ragged edge of B is masked here, so any B
//     is taken.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_GRID_Y = 65535;

template <typename Out>
__device__ __forceinline__ void diag_body(
    const uint8_t* __restrict__ ref,       // [W, B]
    const uint8_t* __restrict__ query,     // [W, B]
    const int32_t* __restrict__ lengths,   // [B]
    Out* __restrict__ out,                 // [W, B]
    const int W, const int B)
{
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int m = lengths[b];
    const size_t stride = (size_t)B;
    for (int s = blockIdx.y; s < W; s += gridDim.y) {
        const int stop = min(W, m - s);
        int count = 0;
        int r = s;
#pragma unroll 4
        for (int t = 0; t < stop; ++t) {
            count += ref[(size_t)r * stride + b] == query[(size_t)t * stride + b];
            r = (r + 1 == W) ? 0 : r + 1;
        }
        out[(size_t)s * stride + b] = (Out)count;
    }
}

// Replaces pallas_kernel.py::_packed_diag_kernel: counts of at most 255
// positions, one byte each (the TPU kernel packs four 8-bit counts a
// word). Bound by integer operations (see the note at the top).
__global__ void diag_counts_u8_kernel(
    const uint8_t* __restrict__ ref, const uint8_t* __restrict__ query,
    const int32_t* __restrict__ lengths, uint8_t* __restrict__ out,
    const int W, const int B)
{
    diag_body<uint8_t>(ref, query, lengths, out, W, B);
}

// Replaces pallas_kernel.py::_diag_counts_kernel: the same counts as an
// int32 plane, for any W (windows above 255, or alphabets the packed TPU
// kernel cannot code). Bound by integer operations as above; its output
// is four times the bytes of the 8-bit kernel's.
__global__ void diag_counts_i32_kernel(
    const uint8_t* __restrict__ ref, const uint8_t* __restrict__ query,
    const int32_t* __restrict__ lengths, int32_t* __restrict__ out,
    const int W, const int B)
{
    diag_body<int32_t>(ref, query, lengths, out, W, B);
}

template <typename Kernel, typename Out>
int launch(Kernel kernel, const void* ref, const void* query,
           const void* lengths, void* out, int W, int B, void* stream)
{
    if (W <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
    const dim3 grid((B + THREADS - 1) / THREADS, W < MAX_GRID_Y ? W : MAX_GRID_Y);
    kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)ref, (const uint8_t*)query, (const int32_t*)lengths,
        (Out*)out, W, B);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on the given
// stream without synchronizing and returns cudaGetLastError().
extern "C" {

int diag_counts_u8(const void* ref, const void* query, const void* lengths,
                   void* out, int W, int B, void* stream)
{
    return launch<decltype(&diag_counts_u8_kernel), uint8_t>(
        diag_counts_u8_kernel, ref, query, lengths, out, W, B, stream);
}

int diag_counts_i32(const void* ref, const void* query, const void* lengths,
                    void* out, int W, int B, void* stream)
{
    return launch<decltype(&diag_counts_i32_kernel), int32_t>(
        diag_counts_i32_kernel, ref, query, lengths, out, W, B, stream);
}

}  // extern "C"
