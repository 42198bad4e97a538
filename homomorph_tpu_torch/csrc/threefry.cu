// T1: the words of jax.random.bits(key, shape, uint32) on the threefry stream.
//
// Replaces the threefry stream that XLA generates for jax.random.bits in the
// JAX package's encryption (homomorph_tpu/cipher.py::Ciphered.cipher and
// _random_selection).  That stream is not a Pallas kernel, but the port's
// encryption must draw the same selection words, so it needs one: word i of
// the row-major flat output is x0 ^ x1 of Threefry-2x32 (20 rounds, the
// Random123 rotations and key schedule) under the key (k0, k1) at the
// counter (i >> 32, i & 0xffffffff), as JAX computes it with
// jax_threefry_partitionable (its default).  Two entries: hm_threefry_bits
// takes the key as scalar arguments; hm_threefry_bits_dkey reads it from
// device memory, so that a CUDA graph's replays draw under the key the host
// wrote last (models/compiled.py::compile_roundtrip).
//
// Bound on the H100: each 4-byte output word costs 41 operations that only
// the INT32 pipe executes (20 rotates, 21 XORs) besides 32 adds, which may
// also issue as IMAD on the FMA pipe.  At 64 INT32 operations per SM per
// clock the 41 take ~2x the time of writing the word to HBM, so the integer
// units, not the bytes, bind it.  The design spends nothing beyond the
// cipher itself: one thread per word in a grid-stride loop with 64-bit
// indices, the rotations as funnel shifts, no memory reads, and coalesced
// 4-byte stores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
    return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void threefry_words(uint32_t* __restrict__ out, long long n,
                                               uint32_t k0, uint32_t k1) {
    const uint32_t k2 = 0x1BD11BDAu ^ k0 ^ k1;
    const uint32_t ks[3] = {k0, k1, k2};
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        uint32_t x0 = (uint32_t)((unsigned long long)i >> 32) + k0;
        uint32_t x1 = (uint32_t)((unsigned long long)i & 0xFFFFFFFFull) + k1;
#pragma unroll
        for (int r = 0; r < 5; ++r) {
#pragma unroll
            for (int s = 0; s < 4; ++s) {
                x0 += x1;
                x1 = rotl(x1, rot[r & 1][s]);
                x1 ^= x0;
            }
            x0 += ks[(r + 1) % 3];
            x1 += ks[(r + 2) % 3] + (uint32_t)(r + 1);
        }
        out[i] = x0 ^ x1;
    }
}

__global__ void threefry_bits_kernel(uint32_t* __restrict__ out, long long n,
                                     uint32_t k0, uint32_t k1) {
    threefry_words(out, n, k0, k1);
}

// The same words under a key read from device memory at run time: a CUDA
// graph replays a launch with the scalar arguments it was captured with,
// so a replayed draw needs its key in a buffer the host rewrites between
// replays.  Every thread reads the two words once (one cached line).
__global__ void threefry_bits_dkey_kernel(uint32_t* __restrict__ out, long long n,
                                          const uint32_t* __restrict__ key) {
    threefry_words(out, n, __ldg(key), __ldg(key + 1));
}

unsigned int grid(long long n, int threads) {
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond 32 blocks/SM
    return (unsigned int)blocks;
}

}  // namespace

// out [n] u32 <- the first n words of the stream of key (k0, k1).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hm_threefry_bits(void* out, long long n, unsigned int k0,
                                unsigned int k1, void* stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    threefry_bits_kernel<<<grid(n, threads), threads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, n, k0, k1);
    return (int)cudaGetLastError();
}

// The same, with the key words (k0, k1) read from device memory at key[0],
// key[1] when the kernel runs.
extern "C" int hm_threefry_bits_dkey(void* out, long long n, const void* key,
                                     void* stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    threefry_bits_dkey_kernel<<<grid(n, threads), threads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, n, (const uint32_t*)key);
    return (int)cudaGetLastError();
}
