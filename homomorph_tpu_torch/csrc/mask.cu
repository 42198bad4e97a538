// M1: the square of a GF(2) polynomial, truncated, on bit-packed limbs.
//
// One step of the decrypt mask's series inverse
// (homomorph_tpu_torch/gf2/mask_kernel.py::series_inverse).  The mask
// w_i = (X^i mod S)(0) is 1 + S(0) X^d (1/S*) mod X^n, with S* the bit
// reversal of S's d+1 coefficients, and Newton's iteration in GF(2) reads
// I' = S* I^2 mod X^k'.  This kernel computes I^2 mod X^k': in GF(2)[X] a
// square has no cross terms, so bit j of the input moves to bit 2j and the
// bits between are 0.  The product by S* is K1 (csrc/clmul.cu).
//
// Replaces the JAX package's device scan of the monic recurrence
// (homomorph_tpu/gf2/poly.py:352-380, decrypt_mask; a lax.scan, not a Pallas
// kernel): 32 * n_limbs dependent steps there, about log2(32 * n_limbs)
// squarings and products here.
//
// Layout: in [B, L] u32 limbs, out [B, Lo] u32 with Lo <= 2L; output limb j
// is the 16 bits of input limb j/2 (its low half for even j, its high half
// for odd j) spread to the even bit positions.  The last output limb keeps
// only the bits under tail_mask (the truncation to k' bits).
//
// Bound on the H100: every output limb costs one 4-byte read of half an
// input limb and one 4-byte write, with five shift-or-and steps between, so
// HBM bytes bind it.  The design: a grid-stride loop over groups of 8
// output limbs, each from 4 input limbs by one 16-byte load and two 16-byte
// stores where both rows' addresses allow it, and limb by limb at a row's
// ragged end; 64-bit indices (a u64 mask's series is 3.1M limbs a row).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// the 16 low bits of x spread to the even positions of a 32-bit word
__device__ __forceinline__ uint32_t spread16(uint32_t x) {
    x &= 0xFFFFu;
    x = (x | (x << 8)) & 0x00FF00FFu;
    x = (x | (x << 4)) & 0x0F0F0F0Fu;
    x = (x | (x << 2)) & 0x33333333u;
    x = (x | (x << 1)) & 0x55555555u;
    return x;
}

__global__ void square_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                              long long B, long long L, long long Lo, uint32_t tail_mask) {
    const long long groups = (Lo + 7) / 8;  // of 8 output limbs, per row
    const long long n = B * groups;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n;
         t += (long long)gridDim.x * blockDim.x) {
        const long long b = t / groups;
        const long long j0 = (t - b * groups) * 8;  // first output limb of the group
        const uint32_t* src = in + b * L + j0 / 2;
        uint32_t* dst = out + b * Lo + j0;
        if (j0 + 8 <= Lo && ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
            const uint4 v = *reinterpret_cast<const uint4*>(src);
            uint4 lo = make_uint4(spread16(v.x), spread16(v.x >> 16), spread16(v.y), spread16(v.y >> 16));
            uint4 hi = make_uint4(spread16(v.z), spread16(v.z >> 16), spread16(v.w), spread16(v.w >> 16));
            if (j0 + 8 == Lo) hi.w &= tail_mask;
            reinterpret_cast<uint4*>(dst)[0] = lo;
            reinterpret_cast<uint4*>(dst)[1] = hi;
        } else {
            const long long m = (Lo - j0 < 8) ? Lo - j0 : 8;
            for (long long i = 0; i < m; ++i) {
                uint32_t w = spread16(src[i / 2] >> (16 * (i & 1)));
                if (j0 + i == Lo - 1) w &= tail_mask;
                dst[i] = w;
            }
        }
    }
}

}  // namespace

// out [B, Lo] <- in [B, L] squared in GF(2)[X], truncated to Lo limbs, the
// last limb ANDed with tail_mask (Lo <= 2L; the wrapper checks shapes).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hm_square(const void* in, void* out, long long B, long long L, long long Lo,
                         unsigned int tail_mask, void* stream) {
    if (B <= 0 || Lo <= 0) return 0;
    const int threads = 256;
    long long blocks = (B * ((Lo + 7) / 8) + threads - 1) / threads;
    if (blocks > 132LL * 16) blocks = 132LL * 16;  // grid-stride beyond 16 blocks/SM
    square_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)in, (uint32_t*)out, B, L, Lo, (uint32_t)tail_mask);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// M2 and M3: the Newton step I' = S* I^2 mod X^k' fused, and the series'
// small steps in one block.
//
// Run as M1 and then K1 through the Karatsuba route, a step costs about 15
// launches with the route's glue (8 to 27 steps a mask), so the mask's wall
// time is host issue.  M2 computes one whole step in one
// launch; M3 runs every step whose output has at most 1,024 limbs, and for
// a class whose series ends there also assembles the mask, in one block.
// Neither the square nor the full product reaches device memory.
//
// The comb (K1's, csrc/clmul.cu): the product S* Q of S*'s Ls limbs by the
// square Q is sum_j sum_w (nib_w(Q[j]) S*) X^(32 j + 4 w), so output limb m
// is the XOR over x = m - j in [0, Ls + 1] and the nibbles w of
// funnel_l(T[nib][x - 1], T[nib][x], 4 w), with T[u] = u S* (u = 0..15,
// Ls + 1 limbs each) in shared memory.  Here the table holds S*'s
// multiples (the same in every block, at most 16 x 424 words at the u64
// key's Ls = 421), and each lane walks its own j = m - x: a warp's lanes
// read consecutive Q[j] (no conflict) and, at one x, rows of T picked by
// their own nibbles; the row stride is odd, so 16 distinct nibbles fall in
// 16 distinct banks and equal ones broadcast.  No lane reads past its own
// range (K1's warp-uniform walk reads Ls + 33 limbs a lane to use Ls + 2).
// Q[j] is spread from I's 16-bit halves into shared memory as M1 does,
// its limb Lo - 1 masked to k' bits, so bits of I's last limb above k
// (left there by a route step) square to positions >= 2k >= k' and drop.
//
// Bound on the H100: 15 shared-memory words a (output limb, S* limb) pair,
// at 32 words per SM a clock; M2 moves Lo / 2 + Lo limbs through HBM, far
// below that.  Parallelism comes from output tiles only (one row): a block
// of 256 threads takes MT = 256 / KS output limbs and splits their x range
// in KS parts, XORed together in shared memory, with KS chosen so that
// narrow steps still spread over the SMs.

namespace {

constexpr int M2_THREADS = 256;
constexpr int M3_THREADS = 1024;  // also M3's widest step, in limbs
constexpr int H100_SMS = 132;

// Row stride of the comb's table: entries e = x + 1 for x = -1 .. Ls + 1,
// rounded up to an odd count.
__host__ __device__ inline int table_stride(int Ls) { return (Ls + 3) | 1; }

// T[u * stride + x + 1] = limb x of u S*, zero at x = -1 and x >= Ls + 1.
__device__ void stage_table(const uint32_t* __restrict__ sstar, int Ls, uint32_t* T,
                            int stride) {
    for (int e = threadIdx.x; e < stride; e += blockDim.x) {
        const int x = e - 1;
        const uint32_t g1 = (x >= 0 && x < Ls) ? __ldg(sstar + x) : 0u;
        const uint32_t g0 = (x >= 1 && x <= Ls) ? __ldg(sstar + x - 1) : 0u;
        const uint32_t t1 = g1;
        const uint32_t t2 = __funnelshift_l(g0, g1, 1);
        const uint32_t t4 = __funnelshift_l(g0, g1, 2);
        const uint32_t t8 = __funnelshift_l(g0, g1, 3);
        const uint32_t t3 = t1 ^ t2, t5 = t4 ^ t1, t6 = t4 ^ t2, t7 = t4 ^ t3;
        uint32_t* col = T + e;
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
}

// Limb j of I^2 (j < Lo <= 2 Li), the last one masked.
__device__ __forceinline__ uint32_t square_limb(const uint32_t* inv, long long j, long long Lo,
                                                uint32_t tail_mask) {
    const uint32_t v = spread16(inv[j >> 1] >> (16 * (j & 1)));
    return j == Lo - 1 ? v & tail_mask : v;
}

// The XOR over x = x0 .. x1 of S* limb x times Q[m - x], shifted into limb
// m; q points at Q[m] (so q[-x] is Q[m - x]).
__device__ __forceinline__ uint32_t comb(const uint32_t* T, int stride, const uint32_t* q,
                                         int x0, int x1) {
    uint32_t acc = 0u;
    for (int x = x0; x <= x1; ++x) {
        const uint32_t v = q[-x];
        const uint32_t* row = T + x + 1;
        acc ^= row[(v & 15u) * stride];
#pragma unroll
        for (int w = 1; w < 8; ++w) {
            const uint32_t* t = row + ((v >> (4 * w)) & 15u) * stride;
            acc ^= __funnelshift_l(t[-1], t[0], 4 * w);
        }
    }
    return acc;
}

// One Newton step: out[0 .. Lo) = S* I^2 mod X^k', the last limb masked.
// Block b owns output limbs m_lo = b MT .. m_lo + MT - 1; its Q window
// holds Q[m_lo - Ls - 1 .. m_lo + MT - 1] (zero below 0 and from Lo up).
__global__ void newton_step_kernel(const uint32_t* __restrict__ inv, const uint32_t* __restrict__ sstar,
                                   int Ls, uint32_t* __restrict__ out, long long Lo,
                                   uint32_t tail_mask, int MT, int KS) {
    extern __shared__ uint32_t sh[];
    const int stride = table_stride(Ls);
    uint32_t* T = sh;
    uint32_t* Q = T + 16 * stride;
    uint32_t* red = Q + MT + Ls + 1;
    const long long m_lo = (long long)blockIdx.x * MT;
    const long long qbase = m_lo - Ls - 1;
    stage_table(sstar, Ls, T, stride);
    for (int e = threadIdx.x; e < MT + Ls + 1; e += blockDim.x) {
        const long long j = qbase + e;
        Q[e] = (j >= 0 && j < Lo) ? square_limb(inv, j, Lo, tail_mask) : 0u;
    }
    __syncthreads();

    const int lane = threadIdx.x % MT, split = threadIdx.x / MT;
    const long long m = m_lo + lane;
    const int XC = (Ls + 2 + KS - 1) / KS;
    const int x0 = split * XC;
    const int x1 = (int)min((long long)min(x0 + XC, Ls + 2) - 1, m);  // j = m - x >= 0
    uint32_t acc = comb(T, stride, Q + lane + Ls + 1, x0, x1);
    if (KS > 1) {
        red[threadIdx.x] = acc;
        __syncthreads();
        if (split) return;
        for (int s = 1; s < KS; ++s) acc ^= red[s * MT + lane];
    }
    if (m < Lo) out[m] = m == Lo - 1 ? acc & tail_mask : acc;
}

// Every Newton step from I = 1 up to n_bits bits (n_bits <= 32 M3_THREADS),
// in one block: I and its square Q in shared memory, __syncthreads()
// between the phases of a step.  A step of Lo limbs gives each of KS =
// 1024 / roundup32(Lo) threads a part of each output limb's x range.  With
// assemble, the block writes the mask 1 ^ S(0) X^d I mod X^(32 n_limbs)
// instead of I (S(0) is bit d of S*).
__global__ void series_small_kernel(const uint32_t* __restrict__ sstar, int Ls, long long n_bits,
                                    uint32_t* __restrict__ out, long long d, long long n_limbs,
                                    int assemble, int cap) {
    extern __shared__ uint32_t sh[];
    __shared__ long long ks[64];
    __shared__ int n_steps;
    const int stride = table_stride(Ls);
    uint32_t* T = sh;
    uint32_t* inv = T + 16 * stride;
    uint32_t* Q = inv + cap;
    uint32_t* red = Q + cap;
    const int tid = threadIdx.x;
    stage_table(sstar, Ls, T, stride);
    if (tid == 0) {
        // the precisions: n_bits halved (rounding up) down to 2, in reverse
        int n = 0;
        for (long long k = n_bits; k > 1; k = (k + 1) / 2) ks[n++] = k;
        n_steps = n;
        inv[0] = 1u;
    }
    __syncthreads();

    long long Lo = 1;
    for (int s = n_steps - 1; s >= 0; --s) {
        const long long k = ks[s];
        Lo = (k + 31) / 32;
        const uint32_t tail = (k % 32) ? (1u << (k % 32)) - 1u : 0xFFFFFFFFu;
        const int Lp = (int)((Lo + 31) / 32 * 32);
        for (int j = tid; j < Lp; j += blockDim.x) Q[j] = j < Lo ? square_limb(inv, j, Lo, tail) : 0u;
        __syncthreads();
        const int KS = M3_THREADS / Lp;
        const int m = tid % Lp, split = tid / Lp;
        uint32_t acc = 0u;
        if (split < KS) {
            const int XC = (Ls + 2 + KS - 1) / KS;
            const int x0 = split * XC;
            const int x1 = min(min(x0 + XC, Ls + 2) - 1, m);
            acc = comb(T, stride, Q + m, x0, x1);
        }
        red[tid] = acc;
        __syncthreads();
        if (tid < Lo) {
            uint32_t v = red[tid];
            for (int p = 1; p < KS; ++p) v ^= red[p * Lp + tid];
            inv[tid] = tid == Lo - 1 ? v & tail : v;
        }
        __syncthreads();
    }
    if (!assemble) {
        for (int l = tid; l < Lo; l += blockDim.x) out[l] = inv[l];
        return;
    }
    const uint32_t s0 = (__ldg(sstar + (d >> 5)) >> (d & 31)) & 1u;
    const long long dq = d >> 5;
    const int dr = (int)(d & 31);
    for (long long l = tid; l < n_limbs; l += blockDim.x) {
        const long long a = l - dq;
        const uint32_t hi = (a >= 0 && a < Lo) ? inv[a] : 0u;
        const uint32_t lo = (a >= 1 && a <= Lo) ? inv[a - 1] : 0u;
        uint32_t w = __funnelshift_l(lo, hi, dr) & (0u - s0);
        out[l] = l == 0 ? w ^ 1u : w;
    }
}

int set_smem(const void* kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
}

}  // namespace

// out [Lo] <- S* I^2 mod X^k' for I [Li] and S* [Ls] (one row each), the
// last limb ANDed with tail_mask (Lo <= 2 Li; the wrapper checks shapes).
// Returns a cudaError (0 on success).
extern "C" int hm_newton_step(const void* inv, const void* sstar, int Ls, void* out, long long Lo,
                              unsigned int tail_mask, void* stream) {
    if (Lo <= 0 || Ls <= 0) return 0;
    // the widest tile that still gives two blocks an SM, else 32 limbs a block
    int KS = 1;
    while (KS < 8 && (Lo + M2_THREADS / KS - 1) / (M2_THREADS / KS) < 2 * H100_SMS &&
           Ls + 2 >= 32 * KS)
        KS *= 2;
    const int MT = M2_THREADS / KS;
    const size_t smem = (size_t)(16 * table_stride(Ls) + MT + Ls + 1 + M2_THREADS) * 4;
    int err = set_smem((const void*)newton_step_kernel, smem);
    if (err) return err;
    const long long blocks = (Lo + MT - 1) / MT;
    newton_step_kernel<<<(unsigned int)blocks, M2_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)inv, (const uint32_t*)sstar, Ls, (uint32_t*)out, Lo, (uint32_t)tail_mask,
        MT, KS);
    return (int)cudaGetLastError();
}

// Every Newton step up to n_bits (ceil(n_bits / 32) <= 1024) in one block:
// out [ceil(n_bits / 32)] <- 1 / S* mod X^n_bits, or with assemble the mask
// [n_limbs] <- 1 ^ S(0) X^d (1 / S*) mod X^(32 n_limbs), n_bits = 32 n_limbs
// - d.  Returns a cudaError (0 on success).
extern "C" int hm_series_small(const void* sstar, int Ls, long long n_bits, void* out, long long d,
                               long long n_limbs, int assemble, void* stream) {
    const long long Lo = (n_bits + 31) / 32;
    if (n_bits < 1 || Lo > M3_THREADS || Ls <= 0) return (int)cudaErrorInvalidValue;
    const int cap = (int)((Lo + 31) / 32 * 32);
    const size_t smem = (size_t)(16 * table_stride(Ls) + 2 * cap + M3_THREADS) * 4;
    int err = set_smem((const void*)series_small_kernel, smem);
    if (err) return err;
    series_small_kernel<<<1, M3_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)sstar, Ls, n_bits, (uint32_t*)out, d, n_limbs, assemble, cap);
    return (int)cudaGetLastError();
}
