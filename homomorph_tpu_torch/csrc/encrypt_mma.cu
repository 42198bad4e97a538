// K3 and X1: fused encryption of a flat bit batch as an int8 counts product
// on the tensor cores.
//
// Replaces two TPU kernels that compute K2's function by a counts matmul on
// the MXU:
//   K3  homomorph_tpu/gf2/encrypt_kernel.py::_encrypt_kernel (the pallas_v1
//       variant of _encrypt_fused): per-word unpack of the selection words
//       to 0/1, counts dot against the public key's bit planes, & 1, and a
//       shift-weight lane-sum pack into limbs;
//   X1  experiments/exp_enc.py::make_pallas_v3: the same from a selection
//       already unpacked to int8 [B, tau] (its in_words=True form, "v3w",
//       takes words as K3 does, so hm_encrypt_mma_words is its counterpart
//       too), with the pack as a byte-plane matmul.
// The TPU's pk-row permutation, packw byte-plane matrix and MXU pack were
// workarounds for its lane layout and for bf16 exactness under Mosaic; the
// port needs none of them.
//
// Function: bit j of row b's ciphertext is the parity of the count
// sum_k sel[b, k] * planes[j, k], with planes [D, Kp] int8 0/1, k-contiguous,
// Kp = 32 * ceil(tau / 32) and zero columns k >= tau (PublicKey.planes()).
// Selection bits beyond tau meet those zero columns, so random words need no
// masking.  Counts accumulate in int32 (mma .s32), exact for every tau.  The
// plaintext bit is XORed into limb 0; limbs m with 32m >= D are zero apart
// from it.
//
// Design (simple and right first): a block of 4 warps owns 128 rows, each
// warp 32 of them as two m16 tiles, and walks all L output limbs.  The
// block stages its selection rows in shared memory as 0/1 int8, 256 bytes
// of K at a time (K3 unpacks each word there, the TPU kernel's per-word
// unpack; X1 copies its int8 rows and pads tau to the chunk with zeros);
// each warp then holds its A fragments in registers.  When K fits one chunk
// (tau <= 256) the rows are staged once and the fragments serve every limb;
// beyond that they are re-staged per limb.  For limb m the block stages the
// key's 32 plane rows of the chunk in shared memory too (from L2: the planes
// are small), and each warp runs
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 on them: four n8
// fragments per tile, each B fragment serving both m16 tiles, 32
// accumulator registers.  Shared rows are padded to 272 bytes, so the
// fragment loads of a warp hit 32 distinct banks (a warp's B fragment read
// straight from global memory touches 8 cache lines per load, which made
// that version L1-bound, PERF.md).  The
// epilogue needs no shared memory: lane (g, t) holds columns 8f+2t and
// 8f+2t+1 (f = 0..3) of rows g and g+8 of a tile, so it ORs its 8 parity
// bits into a partial word per row and two XOR-shuffles across the 4 lanes
// of its group complete both limbs.  Limbs are handled as uint32, so bit 31
// needs no care.
//
// Bound on the H100: the 2*B*tau*D products at the int8 tensor-core rate
// (1,979 Tops/s dense) bind over the bytes at tau = 128 and 256 (K3 reads
// B*W words, X1 B*tau bytes; both write B*L words).  This version stays
// off that bound: mma.sync reaches only part of the rate that wgmma does on
// Hopper, each limb costs two barriers, and nothing overlaps the staging
// with the products.  wgmma, TMA and a pipeline are for a later version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;      // 4 warps
constexpr int MT = 2;             // m16 tiles per warp
constexpr int BM = 4 * 16 * MT;   // rows per block
constexpr int KC = 256;           // bytes of K staged at a time
constexpr int KS = KC / 32;       // mma k-steps per staged chunk
constexpr int SROW = KC + 16;     // padded shared row stride in bytes

__device__ __forceinline__ uint32_t spread4(uint32_t x) {
    // bits 0..3 of x -> bytes 0..3 of the result, each 0 or 1
    return (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows row0..row0+BM-1, K bytes k0..k0+kc-1, as 0/1 int8 into As.
template <bool WORDS>
__device__ __forceinline__ void stage_rows(int8_t* As, const void* a_src, long long row0,
                                           long long B, int tau, int W, int k0, int kc) {
    const int tid = threadIdx.x;
    if constexpr (WORDS) {
        const uint32_t* selw = (const uint32_t*)a_src;
        const int wpr = kc / 32;
        for (int e = tid; e < BM * wpr; e += THREADS) {
            const int r = e / wpr, wl = e - r * wpr;
            const long long row = row0 + r;
            const uint32_t s = row < B ? __ldg(selw + row * W + k0 / 32 + wl) : 0u;
            uint32_t* dst = (uint32_t*)(As + r * SROW + 32 * wl);
#pragma unroll
            for (int q = 0; q < 8; ++q) dst[q] = spread4((s >> (4 * q)) & 0xFu);
        }
    } else if ((tau & 15) == 0) {  // rows 16-byte aligned: vector copies
        const int8_t* sel = (const int8_t*)a_src;
        const int vpr = kc / 16;
        for (int e = tid; e < BM * vpr; e += THREADS) {
            const int r = e / vpr, j = e - r * vpr;
            const long long row = row0 + r;
            const int k = k0 + 16 * j;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (row < B && k < tau) v = __ldg((const uint4*)(sel + row * tau + k));
            *(uint4*)(As + r * SROW + 16 * j) = v;
        }
    } else {  // any tau: byte copies, zeros beyond tau
        const int8_t* sel = (const int8_t*)a_src;
        for (int e = tid; e < BM * kc; e += THREADS) {
            const int r = e / kc, k = e - r * kc;
            const long long row = row0 + r;
            As[r * SROW + k] =
                (row < B && k0 + k < tau) ? __ldg(sel + row * tau + k0 + k) : (int8_t)0;
        }
    }
}

// WORDS: a_src is selw [B, W] u32 (K3); otherwise sel [B, tau] s8 (X1).
template <bool WORDS>
__global__ void __launch_bounds__(THREADS) encrypt_mma_kernel(
    const void* __restrict__ a_src, const int8_t* __restrict__ planes,
    const uint32_t* __restrict__ plain, uint32_t* __restrict__ out,
    long long B, int tau, int W, int D, int L) {
    __shared__ __align__(16) int8_t As[BM * SROW];
    __shared__ __align__(16) int8_t Bs[32 * SROW];

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const long long row0 = (long long)blockIdx.x * BM;
    const int Kp = 32 * W;
    const int Lk = D / 32;  // limbs that have key columns
    uint32_t af[MT][KS][4];  // this warp's A fragments of the staged chunk

    for (int m = 0; m < L; ++m) {  // uniform over the block
        int acc[MT][4][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int f = 0; f < 4; ++f)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[i][f][c] = 0;
        if (m < Lk) {
            for (int k0 = 0; k0 < Kp; k0 += KC) {
                const int nks = min(KC, Kp - k0) / 32;
                if (m == 0 || Kp > KC) {  // one chunk: staged for the first limb only
                    __syncthreads();      // earlier readers of As are done
                    stage_rows<WORDS>(As, a_src, row0, B, tau, W, k0, 32 * nks);
                    __syncthreads();
#pragma unroll
                    for (int i = 0; i < MT; ++i)
#pragma unroll
                        for (int ks = 0; ks < KS; ++ks) {
                            if (ks < nks) {
                                const int8_t* A =
                                    As + (32 * warp + 16 * i + g) * SROW + 32 * ks + 4 * t;
                                af[i][ks][0] = *(const uint32_t*)A;
                                af[i][ks][1] = *(const uint32_t*)(A + 8 * SROW);
                                af[i][ks][2] = *(const uint32_t*)(A + 16);
                                af[i][ks][3] = *(const uint32_t*)(A + 8 * SROW + 16);
                            }
                        }
                }
                // the limb's 32 plane rows of this chunk, shared by the 4 warps
                __syncthreads();  // earlier readers of Bs are done
                for (int e = threadIdx.x; e < 32 * 2 * nks; e += THREADS) {
                    const int n = e / (2 * nks), j = e - n * (2 * nks);
                    *(uint4*)(Bs + n * SROW + 16 * j) = __ldg(
                        (const uint4*)(planes + (long long)(32 * m + n) * Kp + k0 + 16 * j));
                }
                __syncthreads();
#pragma unroll
                for (int ks = 0; ks < KS; ++ks) {
                    if (ks < nks) {
#pragma unroll
                        for (int f = 0; f < 4; ++f) {
                            const int8_t* Bn = Bs + (8 * f + g) * SROW + 32 * ks + 4 * t;
                            const uint32_t b0 = *(const uint32_t*)Bn;
                            const uint32_t b1 = *(const uint32_t*)(Bn + 16);
#pragma unroll
                            for (int i = 0; i < MT; ++i) mma_s8(acc[i][f], af[i][ks], b0, b1);
                        }
                    }
                }
            }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
            uint32_t lo = 0u, hi = 0u;
#pragma unroll
            for (int f = 0; f < 4; ++f) {
                const int c = 8 * f + 2 * t;
                lo |= ((uint32_t)(acc[i][f][0] & 1) << c) | ((uint32_t)(acc[i][f][1] & 1) << (c + 1));
                hi |= ((uint32_t)(acc[i][f][2] & 1) << c) | ((uint32_t)(acc[i][f][3] & 1) << (c + 1));
            }
            lo |= __shfl_xor_sync(0xFFFFFFFFu, lo, 1);
            lo |= __shfl_xor_sync(0xFFFFFFFFu, lo, 2);
            hi |= __shfl_xor_sync(0xFFFFFFFFu, hi, 1);
            hi |= __shfl_xor_sync(0xFFFFFFFFu, hi, 2);
            const long long r = row0 + 32 * warp + 16 * i + g + (t == 1 ? 8 : 0);
            if (t < 2 && r < B) {
                uint32_t word = t == 0 ? lo : hi;
                if (m == 0) word ^= __ldg(plain + r) & 1u;
                out[r * L + m] = word;
            }
        }
    }
}

int launch(bool words, const void* a_src, const void* planes, const void* plain, void* out,
           long long B, int tau, int W, int D, int L, void* stream) {
    if (L < 1 || L > 65535 || W < 1 || D < 32 || D % 32) return (int)cudaErrorInvalidValue;
    if (B <= 0) return 0;
    const long long blocks = (B + BM - 1) / BM;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned int)blocks);
    if (words)
        encrypt_mma_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            a_src, (const int8_t*)planes, (const uint32_t*)plain, (uint32_t*)out, B, tau, W, D, L);
    else
        encrypt_mma_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            a_src, (const int8_t*)planes, (const uint32_t*)plain, (uint32_t*)out, B, tau, W, D, L);
    return (int)cudaGetLastError();
}

}  // namespace

// K3: selw [B, W] u32, planes [D, 32W] s8, plain [B] u32 -> out [B, L] u32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hm_encrypt_mma_words(const void* selw, const void* planes, const void* plain,
                                    void* out, long long B, int W, int D, int L,
                                    void* stream) {
    return launch(true, selw, planes, plain, out, B, 32 * W, W, D, L, stream);
}

// X1: sel [B, tau] s8 0/1, planes [D, 32*ceil(tau/32)] s8, plain [B] u32
// -> out [B, L] u32.  Returns cudaGetLastError() after the launch.
extern "C" int hm_encrypt_mma_sel(const void* sel, const void* planes, const void* plain,
                                  void* out, long long B, int tau, int D, int L,
                                  void* stream) {
    return launch(false, sel, planes, plain, out, B, tau, (tau + 31) / 32, D, L, stream);
}
