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
// window on the INT32 units.  The loads bind at every shape the paths use.
// Shapes are any Ls, Lg >= 1; the caller passes the smaller operand first
// (the product is commutative) so each thread loops over at most Ls limbs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_MT = 512;  // output limbs (threads) per block
constexpr int MAX_IC = 64;   // limbs of the smaller operand per staged window

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
            const uint32_t t1 = g1;
            const uint32_t t2 = __funnelshift_l(g0, g1, 1);
            const uint32_t t4 = __funnelshift_l(g0, g1, 2);
            const uint32_t t8 = __funnelshift_l(g0, g1, 3);
            const uint32_t t3 = t1 ^ t2, t5 = t4 ^ t1, t6 = t4 ^ t2, t7 = t4 ^ t3;
            uint32_t* col = T + x;
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

}  // namespace

// small [B, Ls], big [B, Lg] -> out [B, Ls + Lg], all contiguous u32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hm_clmul(const void* small, const void* big, void* out,
                        long long B, int Ls, int Lg, void* stream) {
    if (B < 1 || Ls < 1 || Lg < 1) return (int)cudaErrorInvalidValue;
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
    clmul_comb_kernel<<<(unsigned int)blocks, MT, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)small, (const uint32_t*)big, (uint32_t*)out, Ls, Lg, n_mtiles, IC);
    return (int)cudaGetLastError();
}
