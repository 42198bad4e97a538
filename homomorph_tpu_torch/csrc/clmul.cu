// K1: batched carry-less (GF(2)[X]) product of bit-packed u32 limb operands.
//
// Replaces homomorph_tpu/gf2/kernels.py::_clmul_kernel_body (launched by
// _clmul_pallas_T).  That kernel laid the batch on the TPU's 128 lanes and
// swept 32 bit planes with (Lb+1) masked XOR passes at static row offsets.
// Here one thread computes one output limb m of one row:
//
//   out[m] = XOR_i lo(s_i * g_{m-i}) ^ hi(s_i * g_{m-1-i})
//
// over the limbs i of the smaller operand s, where lo/hi are the two halves
// of a 32x32 carry-less product.  The card has no carry-less multiply
// instruction, so each product is a 32-step shift/AND/XOR loop; the lo part
// of one product and the hi part of its neighbour share the mask of bit k
// of s_i, so one loop computes both (the TPU kernel's merged pass).
//
// Bound on the H100: integer operations, not memory.  Per row the kernel
// reads (Ls+Lg) limbs and writes (Ls+Lg), but does ~32*Ls*(Lg+1) masked
// shift-XOR steps of several INT32 instructions each.  This first version
// is the simple one: no shared-memory staging, no windowed comb; the
// operands of a row are re-read from L1 by the threads of that row.
// Shapes are any Ls, Lg >= 1; the caller passes the smaller operand first
// (the product is commutative) so each thread loops over at most Ls limbs.
//
// The (g >> 1) >> (31 - k) form keeps every shift below 32: x >> 32 is
// undefined in CUDA, as it is in XLA.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void clmul_kernel(const uint32_t* __restrict__ small,
                             const uint32_t* __restrict__ big,
                             uint32_t* __restrict__ out,
                             long long n_out, int Ls, int Lg) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_out) return;
    const int Lo = Ls + Lg;
    const long long row = t / Lo;
    const int m = (int)(t - row * Lo);
    const uint32_t* s = small + row * Ls;
    const uint32_t* g = big + row * Lg;

    // lo(s_i * g_j) lands in limb i+j, hi(s_i * g_j) in limb i+j+1
    const int i0 = max(0, m - Lg);
    const int i1 = min(Ls - 1, m);
    uint32_t acc = 0u;
    for (int i = i0; i <= i1; ++i) {
        const uint32_t si = __ldg(s + i);
        const int jl = m - i;      // lo partner, valid when < Lg
        const int jh = m - 1 - i;  // hi partner, valid when >= 0
        const uint32_t gl = jl < Lg ? __ldg(g + jl) : 0u;
        const uint32_t gh = jh >= 0 ? __ldg(g + jh) : 0u;
#pragma unroll
        for (int k = 0; k < 32; ++k) {
            const uint32_t mask = 0u - ((si >> k) & 1u);
            const uint32_t term = (gl << k) ^ ((gh >> 1) >> (31 - k));
            acc ^= term & mask;
        }
    }
    out[t] = acc;
}

}  // namespace

// small [B, Ls], big [B, Lg] -> out [B, Ls + Lg], all contiguous u32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hm_clmul(const void* small, const void* big, void* out,
                        long long B, int Ls, int Lg, void* stream) {
    const long long n_out = B * (long long)(Ls + Lg);
    const int threads = 256;
    const long long blocks = (n_out + threads - 1) / threads;
    clmul_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)small, (const uint32_t*)big, (uint32_t*)out, n_out, Ls, Lg);
    return (int)cudaGetLastError();
}
