// K1: batched carry-less (GF(2)[X]) product of bit-packed u32 limb operands,
// as a 4-bit windowed comb (Lopez-Dahab) with the wider operand's multiples
// in shared memory.
//
// Replaces homomorph_tpu/gf2/kernels.py::_clmul_kernel_body (launched by
// _clmul_pallas_T).  That kernel laid the batch on the TPU's 128 lanes and
// swept 32 bit planes with (Lb+1) masked XOR passes at static row offsets.
// The card has no carry-less multiply instruction, and a bit-serial loop
// costs several INT32 instructions per bit.  The comb takes 4 bits at once:
// for each row a block stages the 16 multiples u*g (u = 0..15, Lg+1 limbs
// each) of the wider operand g in shared memory, built from g, 2g, 4g, 8g
// (shifted XORs of g; every shift is below 32, since x >> 32 is undefined in
// CUDA as it is in XLA).  Nibble w of limb i of the smaller operand s then
// adds T[nib] << (32i + 4w) to the product, so output limb m gains
//
//   __funnelshift_l(T[nib][m-i-1], T[nib][m-i], 4w)
//
// per nibble: two shared-memory loads, one funnel shift and one XOR per 4
// bits (one load for w = 0), where the bit-serial loop ran about 24
// instructions.  One thread computes one output limb m; a warp's lanes are
// consecutive m of one row and all step the limbs i in lockstep, so nib is
// warp-uniform and a warp's table reads are 32 consecutive words (no bank
// conflicts).  Each lane walks the i range of its whole warp group; entries
// of T outside 0..Lg read as the zeros the staging wrote there.
//
// Tiling keeps any width in 37 KB of shared memory (no opt-in needed): a
// block of MT = 32..512 threads owns one row and MT output limbs, and walks
// the smaller operand's limbs in chunks of IC <= 64, staging for each chunk
// the window of T that its MT x IC (limb, output limb) pairs touch.  At
// narrow shapes a warp's union of i ranges and its lanes past Ls + Lg do
// loads no output needs: at 9x9 about a third of them are useful.
//
// Bound on the H100: each row reads (Ls + Lg) limbs and writes (Ls + Lg);
// the comb's work is 15 shared-memory loads per (limb of s, limb of T)
// pair at 32 words per SM per clock, and a funnel shift and an XOR per
// window on the INT32 units.  The loads bind the comb at every shape the
// paths use; the square path's own count is below.
// Shapes are any Ls, Lg >= 1; the caller passes the smaller operand first
// (the product is commutative) so each thread loops over at most Ls limbs.
//
// The square path (Ls == Lg == L, from SQUARE_MIN limbs): a second thread
// mapping of the same comb.  Above, a lane of a balanced product walks every
// limb i of its tile, and output limb m only needs i with m - i in
// [0, L + 1]: at 32, 41 and 48 limbs 53%, 45% and 52% of its lane-iterations
// feed an output.  Here a row has P = L + 2 output columns and every lane
// walks i = 0 .. L-1 once, in step with its row.  Column t at step i reads
// window column j = (t - i) mod P, so it adds into output limb t while
// i <= t and into limb t + P after (the two are one register: the lane keeps
// a copy of it at i == t, and the second limb is the XOR of the two).  Every
// (limb m, limb i) pair is walked once: L (L + 2) - 1 of the L (L + 2)
// column-steps are needed (only column L - 2's last step feeds limb 2L,
// which does not exist).  The modulus costs a second copy of the window:
// each multiple is stored as positions 0 .. 2L+1, columns 2 .. L+1 then
// 0 .. L+1 (column L + 1 is zero, and stands for column -1), and column t
// reads position t - i + L, a run that slides down by one a step.
//
// A lane owns k adjacent columns t0 = k l .. t0 + k - 1 of its row, so a row
// takes Q = ceil(P / k) lanes (the last lane's columns past P are computed
// and dropped).  The row's nibble is the same for all its columns, so for
// each nibble a lane decodes it and forms its address once, loads the k + 1
// window words t0 - i + L - 1 .. t0 - i + L + k - 1 once, and funnels words
// c - 1 and c into column t0 + c: 8 k + 8 loads a lane-step (S[i], k for
// nibble 0, k + 1 for each other) where k lanes of one column each took 16.
// k = 1 is the mapping before.  k comes from the width (SQUARE_COLUMNS).
//
// Several rows share a block (`rows`, square_plan: the fewest idle lanes in
// the last warp, a row), so a warp may hold lanes of two or more rows, each
// with its own nibble.  The layout keeps their reads in distinct banks: the
// multiples are [16][rows x row_words] with a multiple's stride a multiple of
// 32 words and row_words = k Q (mod 32), at least k Q + L, so lane (r, l)
// reads bank (r k Q + k l + L - i + c - 1) mod 32 = (k x its thread index +
// L - i + c - 1) mod 32 in its c-th load, whatever the nibbles: with k odd,
// 32 distinct banks, no conflicts (an even k would need vector loads, whose
// alignment flips with i).  The staging stores, a column at a time, fall
// the same way.  A row's limbs of s sit at an odd stride, so the rows of a
// warp read them from distinct banks.  Useful share of column-steps (live
// lanes in whole warps, times the row's columns over its k Q, times
// L (L + 2) - 1 over L (L + 2)): 95.5% at 32 limbs (k = 5, 9 rows, 63 of 64
// threads, 35 columns for 34), 94.0% at 41 (k = 5, 7 rows), 93.7% at 48
// (k = 5, 3 rows, 30 of 32 threads).
//
// Bound, counted from the SASS of one step (chip_smoke.py's
// square_step_sass, NVIDIA H100 80GB HBM3): at k = 1, 16 shared loads and
// 34.5 ALU instructions (8 PRMT, 8 address IMADs, 8 funnel SHFs, 6 LOP3
// XORs, the select, the loop), so 0.50 clock a column-step on the loads
// (32 words a clock an SM) and 0.54 on the ALU (64 a clock): the integer
// issue, not the loads, bound the square path.  At k = 3, 32 loads and 62
// ALU a lane-step: 0.333 and 0.323 clock a column-step; at k = 5, 48 and 88:
// 0.300 and 0.275, so the loads bind again.  Staging adds 32 stores a
// column (two copies), under a tenth of a row's loads from L = 24 up.
// Registers: 63 a thread at k = 3 and 5 (launch bound 1,024), no spills;
// shared memory, not threads, caps a block's rows there, and about a third
// as many warps fit an SM as at k = 1, which the k independent chains and
// k + 1 independent loads a nibble hide.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_MT = 512;  // output limbs (threads) per block
constexpr int MAX_IC = 64;   // limbs of the smaller operand per staged window

// Column j of the 16 multiples u*g from g[j-1] (g0) and g[j] (g1), stored at
// col[u * stride]
__device__ __forceinline__ void store_multiples(uint32_t* col, int stride, uint32_t g0,
                                                uint32_t g1) {
    const uint32_t t1 = g1;
    const uint32_t t2 = __funnelshift_l(g0, g1, 1);
    const uint32_t t4 = __funnelshift_l(g0, g1, 2);
    const uint32_t t8 = __funnelshift_l(g0, g1, 3);
    const uint32_t t3 = t1 ^ t2, t5 = t4 ^ t1, t6 = t4 ^ t2, t7 = t4 ^ t3;
    col[0 * stride] = 0u;
    col[1 * stride] = t1;
    col[2 * stride] = t2;
    col[3 * stride] = t3;
    col[4 * stride] = t4;
    col[5 * stride] = t5;
    col[6 * stride] = t6;
    col[7 * stride] = t7;
    col[8 * stride] = t8;
    col[9 * stride] = t8 ^ t1;
    col[10 * stride] = t8 ^ t2;
    col[11 * stride] = t8 ^ t3;
    col[12 * stride] = t8 ^ t4;
    col[13 * stride] = t8 ^ t5;
    col[14 * stride] = t8 ^ t6;
    col[15 * stride] = t8 ^ t7;
}

__global__ void clmul_comb_kernel(const uint32_t* __restrict__ small,
                                  const uint32_t* __restrict__ big,
                                  uint32_t* __restrict__ out,
                                  int Ls, int Lg, int n_mtiles, int IC) {
    extern __shared__ uint32_t sh[];
    const int MT = blockDim.x;
    const int stride = MT + IC;  // window width: one row of T per multiple
    uint32_t* T = sh;            // [16][stride]
    uint32_t* S = sh + 16 * stride;

    const long long row = blockIdx.x / n_mtiles;
    const int Lo = Ls + Lg;
    const int m_lo = (int)(blockIdx.x - row * n_mtiles) * MT;
    const int m = m_lo + threadIdx.x;
    const int m_hi = min(m_lo + MT, Lo) - 1;
    const uint32_t* s = small + row * Ls;
    const uint32_t* g = big + row * Lg;

    // limbs i of s that reach output limbs m_lo..m_hi: m - i in [0, Lg + 1]
    const int i_lo = max(0, m_lo - Lg - 1);
    const int i_hi = min(Ls - 1, m_hi);
    uint32_t acc = 0u;
    for (int c0 = i_lo; c0 <= i_hi; c0 += IC) {
        const int c1 = min(c0 + IC, i_hi + 1) - 1;
        // window x = 0 .. MT + c1 - c0 holds T[.][jbase + x]
        const int jbase = m_lo - c1 - 1;
        const int win = MT + c1 - c0 + 1;
        if (c0 > i_lo) __syncthreads();  // the previous window is read
        for (int x = threadIdx.x; x < win; x += MT) {
            const int j = jbase + x;
            const uint32_t g1 = (j >= 0 && j < Lg) ? __ldg(g + j) : 0u;
            const uint32_t g0 = (j >= 1 && j <= Lg) ? __ldg(g + j - 1) : 0u;
            store_multiples(T + x, stride, g0, g1);
        }
        for (int t = threadIdx.x; t <= c1 - c0; t += MT) S[t] = __ldg(s + c0 + t);
        __syncthreads();

        int x = m - c0 - jbase;  // the window index of m - i at i = c0
        for (int i = c0; i <= c1; ++i, --x) {
            const uint32_t si = S[i - c0];
            acc ^= T[(si & 15u) * stride + x];
#pragma unroll
            for (int w = 1; w < 8; ++w) {
                const uint32_t* t = T + ((si >> (4 * w)) & 15u) * stride + x;
                acc ^= __funnelshift_l(t[-1], t[0], 4 * w);
            }
        }
    }
    if (m <= m_hi) out[row * Lo + m] = acc;
}

// Square products below SQUARE_MIN limbs would stay on the comb above: the
// least width from which the square path beats it on the card, by
// chip_smoke.py's K1 phase (phase_square_sweep) on an NVIDIA H100 80GB HBM3 at
// 700 W.  It won at every width of the sweep, 1, 2, 5, 9, 16, 24, 32, 41, 48,
// 63, 128 and 1,022 limbs (1.6-5.6 times; 1.88 at 32, 1.97 at 41, 1.87 at 48:
// PERF.md section 6), so every square product up to SQUARE_MAX takes it.
constexpr int SQUARE_MIN = 1;
// one row's P = L + 2 lanes in a block of at most 1,024 threads (k = 1)
constexpr int SQUARE_MAX = 1022;
// a block's shared memory when it takes more than one row: two blocks an SM
constexpr int SQUARE_SMEM_ROWS = 113 * 1024;

// The columns a lane of the square path owns, k, from the width alone: the
// first width of each run of widths and its k, the fastest k at each width
// of chip_smoke.py's scan (phase_square_sweep, SQUARE_SCAN: every width 1-64
// and 13 from 72 to 1,022, k = 1, 3, 5 timed in turns at about 1.3e9
// limb pairs a launch) on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section
// 6).  k = 1 wins to 8 limbs and at 10-12; from 13 up k = 3 or 5, as the
// row's columns and the layout's words round (k = 5 at 32, 41 and 48, the
// u32 product's leaves: 2.0%, 1.5%, 0.4% ahead of k = 3; ties under 0.5%
// go to the neighbouring run).  Above 64 limbs, off the route's leaves, the
// scan's 13 widths split between 3 and 5; 5 is within 2.6% of the best at
// 11 of them (10.5-10.7% behind at 320 and 640).
constexpr int SQUARE_COLUMNS[][2] = {
    {1, 1},  {9, 3},  {10, 1}, {13, 3}, {17, 5}, {19, 3}, {29, 5}, {33, 3}, {35, 5}, {39, 3},
    {41, 5}, {44, 3}, {47, 5}, {49, 3}, {56, 5}, {59, 3}, {62, 5}, {64, 3}, {65, 5}};

int square_columns(int L) {
    int k = 0;
    for (const auto& run : SQUARE_COLUMNS)
        if (L >= run[0]) k = run[1];
    return k;
}

struct Square {
    int k;          // columns a lane: 1, 3 or 5
    int rows;       // rows a block
    int row_words;  // a row's window in one multiple; = k * lanes a row (mod 32)
    int nib_words;  // a multiple's stride: rows x row_words, to a multiple of 32
    int s_words;    // a row's limbs of s: odd
    size_t smem;
};

// The square path's layout at L limbs and k columns a lane: the number of
// rows a block that leaves the fewest idle lanes a row in its last warp
// (ties to fewer rows), within 1,024 threads and SQUARE_SMEM_ROWS bytes.
// False past SQUARE_MAX or for a k the kernel has no instance of.
bool square_plan(int L, int k, Square* q) {
    if (L < 1 || L > SQUARE_MAX || (k != 1 && k != 3 && k != 5)) return false;
    const int Q = (L + 2 + k - 1) / k;  // lanes a row
    q->k = k;
    q->rows = 0;
    q->row_words = k * Q + 32 * ((L + 31) / 32);
    q->s_words = L | 1;
    int idle = 0;
    for (int rows = 1; rows * Q <= 1024; ++rows) {
        const int nib = (rows * q->row_words + 31) / 32 * 32;
        const size_t smem = (size_t)(16 * nib + rows * q->s_words) * sizeof(uint32_t);
        if (rows > 1 && smem > (size_t)SQUARE_SMEM_ROWS) break;
        const int spare = (rows * Q + 31) / 32 * 32 - rows * Q;
        if (q->rows == 0 || spare * q->rows < idle * rows) {
            q->rows = rows;
            q->nib_words = nib;
            q->smem = smem;
            idle = spare;
        }
    }
    return true;
}

template <int K>
__global__ void __launch_bounds__(1024)
clmul_comb_kernel_square(const uint32_t* __restrict__ small, const uint32_t* __restrict__ big,
                         uint32_t* __restrict__ out, long long B, int L, int rows,
                         int row_words, int nib_words, int s_words) {
    extern __shared__ uint32_t sh[];
    const int P = L + 2;
    const int Q = (P + K - 1) / K;  // lanes a row
    const int r = threadIdx.x / Q;  // the block's row (rows and past: idle lanes)
    const int t0 = (threadIdx.x - r * Q) * K;  // the lane's first column
    const long long row = (long long)blockIdx.x * rows + r;
    const bool live = r < rows && row < B;
    uint32_t* T = sh + r * row_words;  // multiple u's window at T[u * nib_words + pos]
    uint32_t* S = sh + 16 * nib_words + r * s_words;

    if (live) {
        // column j = t0 + c: at position L + j, and at j - 2 for j >= 2
        const uint32_t* g = big + row * L;
        uint32_t g0 = (t0 >= 1 && t0 <= L) ? __ldg(g + t0 - 1) : 0u;
#pragma unroll
        for (int c = 0; c < K; ++c) {
            const int j = t0 + c;
            if (j >= P) break;  // the last lane's columns past the row
            const uint32_t g1 = j < L ? __ldg(g + j) : 0u;
            store_multiples(T + L + j, nib_words, g0, g1);
            if (j >= 2) store_multiples(T + j - 2, nib_words, g0, g1);
            if (j < L) S[j] = __ldg(small + row * L + j);
            g0 = g1;
        }
    }
    __syncthreads();
    if (!live) return;

    // position t0 - i + L at step i, as a byte address: a multiple's words
    // are then one multiply-add away (nib_bytes), and each nibble one byte
    // permute; column t0 + c reads words c - 1 and c from there
    const char* col = reinterpret_cast<const char*>(T + L + t0);
    const unsigned nib_bytes = 4u * nib_words;
    uint32_t acc[K], low[K];
#pragma unroll
    for (int c = 0; c < K; ++c) acc[c] = low[c] = 0u;
#pragma unroll 2
    for (int i = 0; i < L; ++i, col -= 4) {
        const uint32_t si = S[i];
        const uint32_t even = si & 0x0F0F0F0Fu, odd = (si >> 4) & 0x0F0F0F0Fu;  // nibbles 0, 2, ..; 1, 3, ..
        {
            const uint32_t* w0 = reinterpret_cast<const uint32_t*>(
                col + __byte_perm(even, 0u, 0x4440u) * nib_bytes);
#pragma unroll
            for (int c = 0; c < K; ++c) acc[c] ^= w0[c];
        }
#pragma unroll
        for (int w = 1; w < 8; ++w) {
            const unsigned nib = __byte_perm(w & 1 ? odd : even, 0u, 0x4440u + (w >> 1));
            const uint32_t* x = reinterpret_cast<const uint32_t*>(col + nib * nib_bytes);
            uint32_t v[K + 1];  // the window's words t0 - i + L - 1 .. t0 - i + L + K - 1
#pragma unroll
            for (int c = 0; c <= K; ++c) v[c] = x[c - 1];
#pragma unroll
            for (int c = 0; c < K; ++c) acc[c] ^= __funnelshift_l(v[c], v[c + 1], 4 * w);
        }
        // limb t0 + c is whole at i == t0 + c; limb t0 + c + P gathers from there on
        const int d = i - t0;
#pragma unroll
        for (int c = 0; c < K; ++c)
            if (d == c) low[c] = acc[c];
    }
    uint32_t* o = out + row * 2 * L;
#pragma unroll
    for (int c = 0; c < K; ++c) {
        const int t = t0 + c;
        if (t < L) {
            o[t] = low[c];
            if (t + P < 2 * L) o[t + P] = acc[c] ^ low[c];
        } else if (t < P && t < 2 * L) {
            o[t] = acc[c];
        }
    }
}

template <int K>
cudaError_t launch_square(const void* small, const void* big, void* out, long long B, int L,
                          const Square& q, long long blocks, cudaStream_t stream) {
    const int threads = (q.rows * ((L + 2 + K - 1) / K) + 31) / 32 * 32;
    const cudaError_t err = cudaFuncSetAttribute(
        clmul_comb_kernel_square<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q.smem);
    if (err != cudaSuccess) return err;
    clmul_comb_kernel_square<K><<<(unsigned int)blocks, threads, q.smem, stream>>>(
        (const uint32_t*)small, (const uint32_t*)big, (uint32_t*)out, B, L, q.rows, q.row_words,
        q.nib_words, q.s_words);
    return cudaGetLastError();
}

// k > 0: the square path with k columns a lane; k == 0: the comb above
int launch(const void* small, const void* big, void* out, long long B, int Ls, int Lg, int k,
           cudaStream_t stream) {
    if (B < 1 || Ls < 1 || Lg < 1) return (int)cudaErrorInvalidValue;
    if (k) {
        Square q;
        if (Ls != Lg || !square_plan(Ls, k, &q)) return (int)cudaErrorInvalidValue;
        const long long blocks = (B + q.rows - 1) / q.rows;
        if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
        switch (k) {
            case 1: return (int)launch_square<1>(small, big, out, B, Ls, q, blocks, stream);
            case 3: return (int)launch_square<3>(small, big, out, B, Ls, q, blocks, stream);
            default: return (int)launch_square<5>(small, big, out, B, Ls, q, blocks, stream);
        }
    }
    const int Lo = Ls + Lg;
    // output tiles of at most MAX_MT limbs, balanced, in whole warps
    const int n_mtiles = (Lo + MAX_MT - 1) / MAX_MT;
    const int per_tile = (Lo + n_mtiles - 1) / n_mtiles;
    const int MT = (per_tile + 31) / 32 * 32;
    const int n_chunks = (Ls + MAX_IC - 1) / MAX_IC;
    const int IC = (Ls + n_chunks - 1) / n_chunks;
    const size_t smem = (size_t)(16 * (MT + IC) + IC) * sizeof(uint32_t);
    const long long blocks = B * n_mtiles;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;  // grid x limit
    clmul_comb_kernel<<<(unsigned int)blocks, MT, smem, stream>>>(
        (const uint32_t*)small, (const uint32_t*)big, (uint32_t*)out, Ls, Lg, n_mtiles, IC);
    return (int)cudaGetLastError();
}

// the columns a lane where hm_clmul takes the square path, else 0
int square_k(int Ls, int Lg) {
    return Ls == Lg && Ls >= SQUARE_MIN && Ls <= SQUARE_MAX ? square_columns(Ls) : 0;
}

}  // namespace

// small [B, Ls], big [B, Lg] -> out [B, Ls + Lg], all contiguous u32, by the
// square path where hm_clmul_square says so, else by the comb above.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hm_clmul(const void* small, const void* big, void* out,
                        long long B, int Ls, int Lg, void* stream) {
    return launch(small, big, out, B, Ls, Lg, square_k(Ls, Lg), (cudaStream_t)stream);
}

// The columns a lane of the square path where hm_clmul takes it at these
// widths (1, 3 or 5, by SQUARE_COLUMNS), else 0 (the comb)
extern "C" int hm_clmul_square(int Ls, int Lg) { return square_k(Ls, Lg); }

// One mapping, named: the square path (square != 0; any Ls == Lg up to
// SQUARE_MAX) with `columns` a lane (1, 3 or 5; 0: SQUARE_COLUMNS' k), or
// the comb above.  For measuring the crossover and k, and for tests.
extern "C" int hm_clmul_mapping(const void* small, const void* big, void* out,
                                long long B, int Ls, int Lg, int square, int columns,
                                void* stream) {
    const int k = !square ? 0 : columns ? columns : square_columns(Ls);
    return launch(small, big, out, B, Ls, Lg, k, (cudaStream_t)stream);
}
