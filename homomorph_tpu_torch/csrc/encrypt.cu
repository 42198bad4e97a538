// K2: fused encryption of a flat bit batch from packed selection words.
//
// Replaces homomorph_tpu/gf2/encrypt_kernel.py::_encrypt_kernel_v2 (launched
// by _encrypt_fused with v2=True).  The TPU kernel unpacked the selection
// words to bf16, ran the counts sel @ pk_bits on the MXU, took each count
// mod 2 and repacked the bit columns with two more matmuls.  Over GF(2) none
// of that is needed: with the public key's bit columns packed along tau
// (pkcol[j, w] holds bits 32w..32w+31 of column j of the [tau, D] bit
// matrix), the parity of sel . T[:, j] is
//
//   popc(XOR_w (selw[b, w] & pkcol[j, w])) & 1,
//
// exact for every tau.  One thread computes one output limb m of one row:
// its 32 bit columns j = 32m..32m+31, ORed into a word, with the plaintext
// bit XORed into limb 0.  Selection bits beyond tau meet zero rows of pkcol,
// so random words need no masking.
//
// Bound on the H100: the function moves selw (B*W words), plain (B) and out
// (B*L words) once; pkcol is at most a few tens of KB and stays in L1/L2.
// The bound is the larger of those bytes' time and the 2*B*tau*D bit
// products at the int8 tensor-core rate; the products bind at tau = 128 and
// 256.  This simple version does them as 32 columns x W words of AND/XOR
// per thread on the INT32 units instead.  The grid's y axis is the limb m, so all threads of a
// block read the same pkcol words (one broadcast load per warp, where a
// row-major thread order made each warp load touch one line per distinct
// limb), and 32 register accumulators load each selection word once.
// Output stores are strided by L (uncoalesced); no shared-memory staging
// and no tensor-core path yet.
//
// Shapes: D % 32 == 0 (columns come from whole limbs); output limbs m with
// 32m >= D are zero apart from the plaintext bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void encrypt_kernel(const uint32_t* __restrict__ selw,
                               const uint32_t* __restrict__ pkcol,
                               const uint32_t* __restrict__ plain,
                               uint32_t* __restrict__ out,
                               long long B, int W, int D, int L) {
    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int m = blockIdx.y;
    const int j0 = 32 * m;
    uint32_t word = 0u;
    if (j0 < D) {
        const uint32_t* sw = selw + b * W;
        const uint32_t* cols = pkcol + (long long)j0 * W;
        uint32_t acc[32];
#pragma unroll
        for (int c = 0; c < 32; ++c) acc[c] = 0u;
        for (int w = 0; w < W; ++w) {
            const uint32_t s = __ldg(sw + w);
#pragma unroll
            for (int c = 0; c < 32; ++c) acc[c] ^= s & __ldg(cols + c * W + w);
        }
#pragma unroll
        for (int c = 0; c < 32; ++c) word |= (uint32_t)(__popc(acc[c]) & 1) << c;
    }
    if (m == 0) word ^= __ldg(plain + b) & 1u;
    out[b * L + m] = word;
}

}  // namespace

// selw [B, W], pkcol [D, W], plain [B] -> out [B, L], all contiguous u32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hm_encrypt(const void* selw, const void* pkcol, const void* plain,
                          void* out, long long B, int W, int D, int L,
                          void* stream) {
    if (L > 65535) return (int)cudaErrorInvalidValue;  // grid y limit
    const int threads = 256;
    const dim3 grid((unsigned int)((B + threads - 1) / threads), (unsigned int)L);
    encrypt_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)selw, (const uint32_t*)pkcol, (const uint32_t*)plain,
        (uint32_t*)out, B, W, D, L);
    return (int)cudaGetLastError();
}
