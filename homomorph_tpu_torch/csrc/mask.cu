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
