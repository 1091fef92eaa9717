// Diagonal match counts of the paired-end insert matcher for Hopper
// (sm_90a): each pair's windows as bit planes of 32 positions a word, a
// diagonal's count a popcount over a few words.
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
// for every diagonal s < W, for any byte values and any m_b (m_b <= 0
// counts nothing; above W the ref wraps, as in the plain version,
// align/batched.py::_diagonal_match_counts; the turbo step never passes
// m_b > W). Without indels every path of the insert aligner's DP is a
// diagonal, so the whole DP collapses to these counts. They are two
// instantiations of one device function that differ only in the type of
// the output, and each is launched, counted and checked on its own.
//
// What bounds them on this card: integer operations. A batch needs about
// B * W^2 / 2 position compares; the bytes (2 W B in, W B or 4 W B out)
// take the memory system a fraction of that time. One thread a (pair,
// diagonal) comparing bytes spends two loads and several instructions on
// each compare and reads each pair's bytes again for every diagonal.
//
// What the design does about it:
//   * Bit planes. A pair's window becomes eight planes, one for each bit of
//     the byte, of 32 positions a word: exact for every byte value, with no
//     symbol table. The equality of 32 positions of diagonal s is then
//     ~OR_p(query_p ^ ref_p), eight LOP3s once the ref planes are shifted
//     by s (a funnel shift, one SHF a plane), and the count of a word is a
//     popcount; the word's invalid positions (t >= min(W, m_b - s)) are
//     OR-ed in as a mask first. The rule needs the mask on a diagonal's last
//     word only: WORD_OPS in align/insert_kernel.py counts the operations
//     of a word (shifts, LOP3s, popcount, add), DIAGONAL_OPS the mask of a
//     diagonal, and the bound counts the words and diagonals the lengths
//     need. This kernel masks every word (a clamp and a funnel shift), a
//     cost of its design that the bound does not count.
//   * The ref window is staged and packed doubled (2 W positions, position
//     W + i is position i), so the mod-W wrap of m_b > W costs nothing.
//   * Stage. A block takes a tile of P pairs (32, or 16 where W is large)
//     and copies both [W, P] byte slabs (the ref one twice) into shared
//     memory with 4-byte asynchronous copies, all in flight at once (a row
//     of 32 pairs is one 32-byte sector); a batch whose rows are not 4-byte
//     aligned (B not a multiple of 4, or a plane not 4-byte aligned) is
//     staged a byte a thread.
//   * Slabs. Where 16 pairs' windows do not fit the block's shared memory
//     (32-bit counts above about W = 700), the diagonals and the query
//     positions are cut into slabs of S words that do: a step stages and
//     packs one query slab and the ref words its diagonal slab reads, and
//     counts into a tile of the slab's diagonals, which leaves when the
//     last query slab is added. So any W is served at 16 pairs a block.
//     Steps past the block's longest pair are skipped. The slabs are an
//     instantiation of their own (diag_counts_i32_kernel<true>): their
//     loop state costs registers that the one-slab kernels, at the 80 of
//     three blocks an SM, do not have to spare.
//   * Pack. Lane pl packs pair pl, 32 positions at a time: 32 byte reads of
//     the staged rows (neighbouring lanes, neighbouring bytes), four 8 x 8
//     bit transposes of three delta swaps each, and byte permutes that
//     gather each plane's word; some 6 warp instructions a word of a pair.
//     Positions past W (query) and 2 W (ref) are packed from rows that hold
//     no bytes of the pair; the count masks them.
//   * Count. PAIR_LANES lanes share a pair: lane r takes the diagonals
//     s = 32 d + r + PAIR_LANES i, so every lane of a group reads the same
//     words (broadcast) and shifts them by its own s mod 32. QWORDS query
//     words at a time stay in registers while the lane walks its
//     diagonals; the counts add up in a [W, P] tile in shared memory, which
//     aliases the staged bytes where one slab holds the window, and leave
//     it row by row, neighbouring lanes on neighbouring pairs.
//   * The constants were timed against each other on the card
//     (cuda_tools/diag_compare.py --constants): 16 lanes a pair beat 32
//     and 8 over the paths' batches and the grid, and 4 query words in
//     registers with three blocks an SM (80 registers, no spill) beat 8
//     words with two; PERF.md has the times.
//   * The ragged edge of B is masked (missing pairs stage zeros and a
//     length of 0, and are not written), so any B is taken.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "shared_limit.h"

namespace {

constexpr int WARPS = 8;          // warps a block
constexpr int TILE = 32;          // pairs a block where shared memory allows
constexpr int PAIR_LANES = 16;    // lanes that split one pair's diagonals
constexpr int SHIFTS = 32 / PAIR_LANES;  // diagonals a lane takes a word
constexpr int MIN_TILE = WARPS * 32 / PAIR_LANES;  // pairs that keep every lane counting
constexpr int QWORDS = 4;         // query words a lane keeps in registers
constexpr int MIN_BLOCKS = 3;     // blocks an SM holds: at most 80 registers a thread
constexpr size_t SHARED_TARGET = 80 * 1024;  // a block's shared memory, at most
constexpr unsigned FULL = 0xffffffffu;

static_assert(32 % PAIR_LANES == 0, "a warp holds whole pair groups");
static_assert(MIN_TILE % 4 == 0 && MIN_TILE <= TILE, "rows of the tile stage in 4-byte words");

// Words (uint32) between two pairs' planes at a slab of S words: S query
// words and 2 S ref words of 8 planes, and 4 more, so that the lanes of a
// warp storing their pairs' words start on different banks.
__host__ __device__ constexpr int pair_stride(int S) { return 24 * S + 4; }

// Staged rows at a slab of S words: 64 S ref rows (the ref words of a
// step), then 32 S query rows.
__host__ __device__ constexpr int stage_rows(int S) { return 96 * S; }

// Rows of the counts tile: the diagonals of one slab.
__host__ __device__ constexpr int tile_rows(int W, int S) { return W < 32 * S ? W : 32 * S; }

// Bytes of shared memory a block of P pairs takes at window W and a slab
// of S words: each pair's planes, the lengths and their largest, the
// staged bytes and the counts tile, which aliases the staged bytes when
// one slab holds the window (the staged bytes are dead once packed) and
// follows them when it does not (the tile then adds up over several
// stagings).
size_t shared_bytes(int W, int P, int S, int out_size)
{
    const int NW = (W + 31) / 32;
    const size_t planes = (size_t)P * pair_stride(S) * 4;
    const size_t lens = ((size_t)(P + 1) * 4 + 15) / 16 * 16;
    const size_t stage = (size_t)stage_rows(S) * P;
    const size_t tile = (size_t)tile_rows(W, S) * (P + 1) * out_size;
    return planes + lens + (S >= NW ? (stage > tile ? stage : tile) : stage + tile);
}

// 8 x 8 bit transpose: bit i of byte p of the result is bit p of byte i
// of x (three delta swaps).
__device__ __forceinline__ uint64_t transpose8(uint64_t x)
{
    uint64_t t;
    t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
    x ^= t ^ (t << 7);
    t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
    x ^= t ^ (t << 14);
    t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
    x ^= t ^ (t << 28);
    return x;
}

// The eight plane words of 32 positions of one pair: bit u of plane p is
// bit p of the byte at column[u * RS] (32 staged rows, one byte each).
// Four groups of 8 positions are transposed as 8 x 8 bit matrices; plane p
// then gathers byte p of each group. Stored at dst[0..7] (16-byte aligned).
__device__ __forceinline__ void pack_word(const unsigned char* column, int RS, uint32_t* dst)
{
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
        uint32_t w[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const unsigned char* at = column + (8 * g + 4 * h) * RS;
            w[h] = (uint32_t)at[0] | ((uint32_t)at[RS] << 8)
                 | ((uint32_t)at[2 * RS] << 16) | ((uint32_t)at[3 * RS] << 24);
        }
        const uint64_t x = transpose8(((uint64_t)w[1] << 32) | w[0]);
        lo[g] = (uint32_t)x;
        hi[g] = (uint32_t)(x >> 32);
    }
    uint32_t plane[8];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
        // byte p of the four groups, group g at byte g
        const unsigned sel = p | ((p + 4) << 4);
        plane[p] = __byte_perm(__byte_perm(lo[0], lo[1], sel),
                               __byte_perm(lo[2], lo[3], sel), 0x5410);
        plane[p + 4] = __byte_perm(__byte_perm(hi[0], hi[1], sel),
                                   __byte_perm(hi[2], hi[3], sel), 0x5410);
    }
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(plane[0], plane[1], plane[2], plane[3]);
    reinterpret_cast<uint4*>(dst)[1] = make_uint4(plane[4], plane[5], plane[6], plane[7]);
}

__device__ __forceinline__ void load_word(const uint4* base, int w, uint32_t (&v)[8])
{
    const uint4 a = base[2 * w];
    const uint4 b = base[2 * w + 1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// One pair's counts of one step, added into col[sl * OS]: the diagonals
// sl < min(Sl, 32 dn) over the query positions tl < Wl, with sl, tl
// counted from the step's first diagonal and query position (32 d0 and
// 32 j0) and ml the pair's ref positions left from the step's first ref
// word (m_b - 32 (d0 + j0)). q4 holds the step's query words, r4 its ref
// words (8 planes a word, two uint4). A slab that holds the window has
// d0 = j0 = 0, so ml = m_b, Wl = Sl = W. Lane r of the pair's group takes
// the diagonals sl = 32 dd + r + PAIR_LANES i.
template <typename Out>
__device__ __forceinline__ void count_pair(
    const uint4* __restrict__ q4, const uint4* __restrict__ r4,
    Out* __restrict__ col, const int OS, const int ml, const int Wl, const int Sl,
    const int dn, const int r)
{
    const int mw = min(Wl, ml);
    for (int jj = 0; 32 * jj < mw; jj += QWORDS) {
        uint32_t q[QWORDS][8];
#pragma unroll
        for (int j = 0; j < QWORDS; ++j)
            if (32 * (jj + j) < mw) load_word(q4, jj + j, q[j]);
        for (int dd = 0; dd < dn; ++dd) {
            // positions of this chunk on the longest diagonal of word dd
            const int lim = min(Wl, ml - 32 * dd) - 32 * jj;
            if (lim <= 0) break;
            int rem[SHIFTS], acc[SHIFTS];
#pragma unroll
            for (int i = 0; i < SHIFTS; ++i) {
                rem[i] = min(Wl, ml - (32 * dd + r + PAIR_LANES * i)) - 32 * jj;
                acc[i] = 0;
            }
            uint32_t lo[8];
            load_word(r4, dd + jj, lo);
#pragma unroll
            for (int j = 0; j < QWORDS; ++j) {
                if (32 * j >= lim) break;
                uint32_t hi[8];
                load_word(r4, dd + jj + j + 1, hi);
#pragma unroll
                for (int i = 0; i < SHIFTS; ++i) {
                    const unsigned sh = r + PAIR_LANES * i;
                    // ones at the positions past this diagonal's end
                    uint32_t x = __funnelshift_lc(0u, FULL, max(rem[i] - 32 * j, 0));
#pragma unroll
                    for (int p = 0; p < 8; ++p)
                        x |= q[j][p] ^ __funnelshift_r(lo[p], hi[p], sh);
                    acc[i] += __popc(~x);
                }
#pragma unroll
                for (int p = 0; p < 8; ++p) lo[p] = hi[p];
            }
#pragma unroll
            for (int i = 0; i < SHIFTS; ++i) {
                const int sl = 32 * dd + r + PAIR_LANES * i;
                if (sl < Sl) col[sl * OS] = (Out)(col[sl * OS] + acc[i]);
            }
        }
    }
}

// Stage one step's bytes of the block's P pairs: the ref positions u from
// 32 base on at staged row u - 32 base (n_ref rows; position u < 2 W is
// row u mod W, so a ref row goes to one staged row or, W rows apart, two;
// the positions from 2 W on are never counted and are not staged), and the
// query rows from 32 j0 on (n_query rows, those below W) from staged row
// QROW on.
__device__ __forceinline__ void stage_step(
    const uint8_t* __restrict__ ref, const uint8_t* __restrict__ query,
    unsigned char* stage, const int W, const int B, const int P, const int b0,
    const int base, const int n_ref, const int j0, const int n_query, const int QROW,
    const bool words)
{
    const int RS = P;  // staged row stride
    const int n_src = min(n_ref, W);  // ref rows read
    const int n_rows = n_src + n_query;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (words) {
        // 4-byte asynchronous copies, all in flight at once; past the
        // ragged edge they fill zeros
        const int shift = __ffs(P / 4) - 1;  // log2 of the words a row
        for (int f = threadIdx.x; f < n_rows << shift; f += WARPS * 32) {
            const int row = f >> shift;
            const int g = f - (row << shift);
            const int b = b0 + 4 * g;
            const int valid = min(max(B - b, 0), 4);
            if (row < n_src) {
                const int u = 32 * base + row;
                const uint8_t* src = ref + (size_t)(u < W ? u : u - W) * B;
                __pipeline_memcpy_async(stage + row * RS + 4 * g, valid ? src + b : src, 4,
                                        4 - valid);
                if (row + W < n_ref)
                    __pipeline_memcpy_async(stage + (row + W) * RS + 4 * g,
                                            valid ? src + b : src, 4, 4 - valid);
            } else {
                const uint8_t* src = query + (size_t)(32 * j0 + row - n_src) * B;
                __pipeline_memcpy_async(stage + (QROW + row - n_src) * RS + 4 * g,
                                        valid ? src + b : src, 4, 4 - valid);
            }
        }
        __pipeline_commit();
    } else if (lane < P) {
        // a byte a lane, lane = pair, the warps' rows 16 loads deep
        const int b = b0 + lane;
#pragma unroll 16
        for (int row = warp; row < n_rows; row += WARPS) {
            if (row < n_src) {
                const int u = 32 * base + row;
                const uint8_t byte = b < B ? __ldg(ref + (size_t)(u < W ? u : u - W) * B + b) : 0;
                stage[row * RS + lane] = byte;
                if (row + W < n_ref) stage[(row + W) * RS + lane] = byte;
            } else {
                stage[(QROW + row - n_src) * RS + lane] =
                    b < B ? __ldg(query + (size_t)(32 * j0 + row - n_src) * B + b) : 0;
            }
        }
    }
}

// SLABS false: one slab holds the window (S = NW, one step, the counts
// tile over the staged bytes), the loops below fold away; true: slabs of
// S < NW words.
template <typename Out, bool SLABS>
__device__ __forceinline__ void diag_body(
    const uint8_t* __restrict__ ref,       // [W, B]
    const uint8_t* __restrict__ query,     // [W, B]
    const int32_t* __restrict__ lengths,   // [B]
    Out* __restrict__ out,                 // [W, B]
    const int W, const int B, const int P, const int slab)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int NW = (W + 31) >> 5;
    const int S = SLABS ? slab : NW;
    const int stride = pair_stride(S);
    uint32_t* planes = reinterpret_cast<uint32_t*>(smem);  // [P][stride]
    int* lens = reinterpret_cast<int*>(smem + (size_t)P * stride * 4);
    unsigned char* stage = smem + (size_t)P * stride * 4 + ((P + 1) * 4 + 15) / 16 * 16;
    // [tile_rows][P + 1]: over the staged bytes when one slab holds the
    // window, after them when not
    Out* counts = reinterpret_cast<Out*>(SLABS ? stage + (size_t)stage_rows(S) * P : stage);
    const int RS = P;      // staged row stride
    const int QROW = 64 * S;  // the query rows' first staged row
    const int OS = P + 1;  // counts row stride: lanes of one row apart by one bank
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int b0 = blockIdx.x * P;
    const bool words = ((reinterpret_cast<uintptr_t>(ref) | reinterpret_cast<uintptr_t>(query))
                        & 3) == 0 && B % 4 == 0 && P % 4 == 0;


    constexpr int GROUPS = 32 / PAIR_LANES;
    const int group = lane / PAIR_LANES;
    const int r = lane % PAIR_LANES;
    // diagonal slabs of S words; for each, query slabs of S words, a step
    // each: stage, pack, count into the tile; then the slab's rows leave
    for (int d0 = 0; d0 < NW; d0 += S) {
        const int dn = min(S, NW - d0);
        // lens[P], the block's longest pair, skips the steps past it
        const bool live = d0 == 0 || 32 * d0 < lens[P];
        for (int j0 = 0; live && j0 < NW && (j0 == 0 || 32 * (d0 + j0) < lens[P]); j0 += S) {
            const int jn = min(S, NW - j0);
            const int base = d0 + j0;
            // 1. stage; ref positions from 2 W on and query positions from
            // W on are not staged (nothing counts them)
            const int n_ref = max(min(32 * (dn + jn), 2 * W - 32 * base), 0);
            const int n_query = min(32 * jn, W - 32 * j0);
            stage_step(ref, query, stage, W, B, P, b0, base, n_ref, j0, n_query, QROW, words);
            if (base == 0 && warp == 0) {
                // the first step: the lengths, clamped to [0, 2 W], and
                // their largest, while the copies are in flight
                const int m = lane < P && b0 + lane < B ? min(max(lengths[b0 + lane], 0), 2 * W) : 0;
                if (lane < P) lens[lane] = m;
                const int longest = __reduce_max_sync(FULL, m);
                if (lane == 0) lens[P] = longest;
            }
            __pipeline_wait_prior(0);
            __syncthreads();

            // 2. pack: lane pl packs pair pl; the warps share out the
            // dn + jn ref words and the jn query words
            if (lane < P) {
                uint32_t* pw = planes + (size_t)lane * stride;
                for (int item = warp; item < dn + 2 * jn; item += WARPS) {
                    if (item < dn + jn)
                        pack_word(stage + 32 * item * RS + lane, RS, pw + (S + item) * 8);
                    else
                        pack_word(stage + (QROW + 32 * (item - dn - jn)) * RS + lane, RS,
                                  pw + (item - dn - jn) * 8);
                }
            }
            __syncthreads();

            // 3. count: PAIR_LANES lanes a pair, into the counts tile (the
            // step with j0 = 0 sets the slab's counts, the later ones add)
            const int Wl = min(W - 32 * j0, 32 * jn);  // no query position past the step's
            const int Sl = min(W - 32 * d0, 32 * dn);  // no diagonal past the slab's
            for (int pl = warp * GROUPS + group; pl < P; pl += WARPS * GROUPS) {
                const uint4* q4 = reinterpret_cast<const uint4*>(planes + (size_t)pl * stride);
                Out* col = counts + pl;
                if (j0 == 0)
                    for (int sl = r; sl < Sl; sl += PAIR_LANES) col[sl * OS] = 0;
                count_pair<Out>(q4, q4 + 2 * S, col, OS, lens[pl] - 32 * base, Wl, Sl, dn, r);
            }
            __syncthreads();
        }

        // 4. write the slab's rows: row s, neighbouring lanes on
        // neighbouring pairs
        const int b = b0 + lane;
        for (int s = 32 * d0 + warp; s < min(W, 32 * (d0 + dn)); s += WARPS)
            if (lane < P && b < B) out[(size_t)s * B + b] = live ? counts[(s - 32 * d0) * OS + lane] : (Out)0;
    }
}

// Replaces pallas_kernel.py::_packed_diag_kernel: counts of at most 255
// positions, one byte each (the TPU kernel packs four 8-bit counts a
// word). Bound by integer operations (see the note at the top).
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS) diag_counts_u8_kernel(
    const uint8_t* __restrict__ ref, const uint8_t* __restrict__ query,
    const int32_t* __restrict__ lengths, uint8_t* __restrict__ out,
    const int W, const int B, const int P, const int S)
{
    diag_body<uint8_t, false>(ref, query, lengths, out, W, B, P, S);
}

// Replaces pallas_kernel.py::_diag_counts_kernel: the same counts as an
// int32 plane, for any W (windows above 255, or alphabets the packed TPU
// kernel cannot code): one slab, or slabs where 16 pairs do not hold the
// window. Bound by integer operations as above; its output is four times
// the bytes of the 8-bit kernel's.
template <bool SLABS>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS) diag_counts_i32_kernel(
    const uint8_t* __restrict__ ref, const uint8_t* __restrict__ query,
    const int32_t* __restrict__ lengths, int32_t* __restrict__ out,
    const int W, const int B, const int P, const int S)
{
    diag_body<int32_t, SLABS>(ref, query, lengths, out, W, B, P, S);
}

// The tile and the slab: TILE pairs, halved while the block's shared
// memory exceeds SHARED_TARGET, down to MIN_TILE; a window that MIN_TILE
// pairs do not hold in one slab is cut into the largest slabs of S words
// that they do and goes to the slabs kernel, so any W is served (the 8-bit
// counts have none: their W <= 255 always fits one slab).
template <typename Out>
using DiagKernel = void (*)(const uint8_t*, const uint8_t*, const int32_t*, Out*,
                            int, int, int, int);

template <typename Out>
int launch(DiagKernel<Out> one_slab, DiagKernel<Out> slabs,
           const void* ref, const void* query, const void* lengths, void* out,
           int W, int B, void* stream)
{
    if (W <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
    const int NW = (W + 31) / 32;
    int P = TILE, S = NW;
    while (P > MIN_TILE && shared_bytes(W, P, S, sizeof(Out)) > SHARED_TARGET) P /= 2;
    while (S > 1 && shared_bytes(W, P, S, sizeof(Out)) > SHARED_TARGET) --S;
    const size_t bytes = shared_bytes(W, P, S, sizeof(Out));
    const DiagKernel<Out> kernel = S < NW ? slabs : one_slab;
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    if (bytes > 48 * 1024) {
        const cudaError_t err = allow_shared_bytes((const void*)kernel, bytes);
        if (err != cudaSuccess) return (int)err;
    }
    const unsigned blocks = (unsigned)((B + P - 1) / P);
    kernel<<<blocks, WARPS * 32, bytes, (cudaStream_t)stream>>>(
        (const uint8_t*)ref, (const uint8_t*)query, (const int32_t*)lengths,
        (Out*)out, W, B, P, S);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on the given
// stream without synchronizing and returns cudaGetLastError().
extern "C" {

int diag_counts_u8(const void* ref, const void* query, const void* lengths,
                   void* out, int W, int B, void* stream)
{
    return launch<uint8_t>(diag_counts_u8_kernel, nullptr, ref, query, lengths, out, W, B,
                           stream);
}

int diag_counts_i32(const void* ref, const void* query, const void* lengths,
                    void* out, int W, int B, void* stream)
{
    return launch<int32_t>(diag_counts_i32_kernel<false>, diag_counts_i32_kernel<true>, ref,
                           query, lengths, out, W, B, stream);
}

}  // extern "C"
