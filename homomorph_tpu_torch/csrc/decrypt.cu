// D1: the batched decrypt, parity(popcount(c & w)) over each row's limbs.
//
// A ciphered bit decrypts as (C mod S)(0) = parity(popcount(C & w))
// (src/cipher.rs:117-123), with w the key's decrypt mask
// (homomorph_tpu_torch/gf2/poly.py::decrypt_mask).  The JAX package writes
// it as jnp ops (homomorph_tpu/gf2/poly.py:383, decipher_bits; not a Pallas
// kernel), which XLA fuses into one pass over c.  The port's torch
// expression (poly.py::decipher_bits_plain) is about 22 kernels: the AND
// writes all of c again, seven XOR halvings of the limb axis and the
// 32-bit fold each read and write an intermediate.  This kernel takes
// their place on the card: it reads each row of c once.
//
// Layout: c [rows, L] u32 limbs, rows `stride` limbs apart (any stride: the
// kernel only reads c), a row's limbs contiguous; w [L] u32; out [rows]
// int32 0/1.
//
// Bound on the H100: bytes.  Each limb of c is read once (4 bytes) and each
// row writes 4 bytes; w is read through the read-only cache.  At the
// round trip's sum ([65,536, 32, 384] limbs, 3.22 GB) that is 0.96 ms at
// 3.35 TB/s.  The design keeps loads in flight and the arithmetic small:
//
// * A task is a run of one row's limbs, taken by a group of `group` threads
//   (a power of 2, up to the block): group 4 at L = 9, so a warp serves 8
//   rows; a warp a row at L = 384; the whole block at long rows, which are
//   also cut into `split` tasks, so that rows too long or too few to fill
//   the card still spread over every SM.  The wrapper's plan
//   (gf2/decrypt_kernel.py::decipher_plan) sets every parameter from the
//   shape alone; this file checks that they are in range and derives none.
// * Loads are 16 bytes (vec 4) where every row starts on a 16-byte
//   boundary, else 4 bytes (vec 1); either way a group's threads read
//   neighbouring words, and each thread issues UNROLL loads before it
//   uses one.  A row's last L mod 4 limbs (vec 4) are read as words by the
//   task that holds the row's end.
// * The mask is read through the read-only cache, which holds it: a mask
//   staged in shared memory measured 0.9% slower at the round trip's 384
//   limbs and 0.4-0.8% slower at 1,024 and 4,096 (H100, CUDA events); it
//   was 6-8% faster only with 4-byte loads at 9 and 33 limbs, which no
//   benchmark cell runs.
// * Each thread XORs its limbs into one word; the group XORs its words by
//   warp shuffles (and shared memory past a warp), and the parity is
//   __popc & 1.  A row in one task stores its bit; a row cut into tasks
//   XORs each task's bit into the output by atomicXor, after a memset of
//   the output in the same stream (a memset node in a CUDA graph).
// * The grid walks the tasks block by block (a grid-stride loop) with as
//   many blocks as are resident at once, so no second wave runs short.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;       // a block's threads (decrypt_kernel.THREADS)
constexpr int UNROLL = 4;          // a thread's loads in flight (decrypt_kernel.UNROLL)

template <int V> struct Vec;

template <> struct Vec<1> {
    using T = uint32_t;
    static __device__ __forceinline__ T zero() { return 0u; }
    static __device__ __forceinline__ uint32_t masked(T a, T m) { return a & m; }
};

template <> struct Vec<4> {
    using T = uint4;
    static __device__ __forceinline__ T zero() { return make_uint4(0u, 0u, 0u, 0u); }
    static __device__ __forceinline__ uint32_t masked(T a, T m) {
        return (a.x & m.x) ^ (a.y & m.y) ^ (a.z & m.z) ^ (a.w & m.w);
    }
};

template <int V>
__global__ void __launch_bounds__(THREADS)
decipher_parity_kernel(const uint32_t* __restrict__ c, const uint32_t* __restrict__ w,
                       int* __restrict__ out, long long rows, long long L, long long stride,
                       int group, int split, long long chunk) {
    using T = typename Vec<V>::T;
    __shared__ uint32_t warp_words[THREADS / 32];

    const T* wv = reinterpret_cast<const T*>(w);
    const long long nv = L / V;             // whole vectors a row
    const int tail = (int)(L - nv * V);     // limbs after them (vec 4 only)
    const int lane = threadIdx.x & (group - 1);
    const int per_block = THREADS / group;  // tasks a block takes a pass
    const long long tasks = rows * split;

    for (long long base = (long long)blockIdx.x * per_block; base < tasks;
         base += (long long)gridDim.x * per_block) {
        const long long q = base + threadIdx.x / group;
        uint32_t acc = 0u;
        if (q < tasks) {
            const long long row = split == 1 ? q : q / split;
            const long long part = q - row * split;
            const long long i0 = part * chunk;
            const long long i1 = i0 + chunk < nv ? i0 + chunk : nv;
            const uint32_t* cr = c + row * stride;
            const T* cv = reinterpret_cast<const T*>(cr);
            for (long long i = i0 + lane; i < i1; i += (long long)group * UNROLL) {
                T v[UNROLL];
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    const long long j = i + (long long)u * group;
                    v[u] = j < i1 ? __ldg(cv + j) : Vec<V>::zero();
                }
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    const long long j = i + (long long)u * group;
                    if (j < i1) acc ^= Vec<V>::masked(v[u], __ldg(wv + j));
                }
            }
            if (part == split - 1) {
                for (int t = lane; t < tail; t += group) {
                    const long long j = nv * V + t;
                    acc ^= __ldg(cr + j) & __ldg(w + j);
                }
            }
        }
        // the group's words XORed together: shuffles inside a warp, then
        // shared memory across the warps of a group larger than one
        for (int o = (group < 32 ? group : 32) / 2; o > 0; o >>= 1)
            acc ^= __shfl_xor_sync(0xffffffffu, acc, o);
        if (group > 32) {  // the same for the whole block
            if ((threadIdx.x & 31) == 0) warp_words[threadIdx.x >> 5] = acc;
            __syncthreads();
            if (lane == 0)
                for (int k = 1; k < group / 32; ++k) acc ^= warp_words[(threadIdx.x >> 5) + k];
            __syncthreads();
        }
        if (lane == 0 && q < tasks) {
            const int bit = __popc(acc) & 1;
            if (split == 1)
                out[q] = bit;
            else if (bit)
                atomicXor(out + q / split, 1);
        }
    }
}

template <int V>
int launch(const void* c, const void* w, void* out, long long rows, long long L,
           long long stride, int group, int split, long long chunk, int blocks,
           cudaStream_t stream) {
    decipher_parity_kernel<V><<<blocks, THREADS, 0, stream>>>(
        (const uint32_t*)c, (const uint32_t*)w, (int*)out, rows, L, stride, group, split, chunk);
    return (int)cudaGetLastError();
}

bool plan_ok(long long rows, long long L, long long stride, int vec, int group, int split,
             long long chunk, int blocks) {
    if (rows < 0 || L < 1 || stride < 0 || (vec != 1 && vec != 4) || L < vec) return false;
    if (group < 1 || group > THREADS || (group & (group - 1))) return false;
    const long long nv = L / vec;
    if (split < 1 || chunk < 1 || chunk * split < nv || chunk * (split - 1) >= nv) return false;
    if (blocks < 1) return false;
    return true;
}

}  // namespace

// out [rows] <- parity(popcount(c[r, :L] & w)) for each row r of c (rows
// `stride` limbs apart), on the plan's parameters (decrypt_kernel.py::
// DecipherPlan, same names).  With vec 4, c, stride and w must be 16-byte
// aligned (the wrapper checks).  Returns 0, cudaErrorInvalidValue for a
// plan out of range (nothing launched), or the launch's cudaGetLastError().
extern "C" int hm_decipher(const void* c, const void* w, void* out, long long rows, long long L,
                           long long stride, int vec, int group, int split, long long chunk,
                           int blocks, void* stream) {
    if (!plan_ok(rows, L, stride, vec, group, split, chunk, blocks))
        return (int)cudaErrorInvalidValue;
    if (rows == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (split > 1) {
        const cudaError_t err = cudaMemsetAsync(out, 0, (size_t)rows * sizeof(int), s);
        if (err != cudaSuccess) return (int)err;
    }
    if (vec == 4) return launch<4>(c, w, out, rows, L, stride, group, split, chunk, blocks, s);
    return launch<1>(c, w, out, rows, L, stride, group, split, chunk, blocks, s);
}

// *blocks_per_sm <- how many blocks of the kernel with `vec`-limb loads an
// SM holds at once (the plan's grid is that many per SM at most).  Returns
// the CUDA status.
extern "C" int hm_decipher_blocks_per_sm(int vec, int* blocks_per_sm) {
    if (vec == 4)
        return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks_per_sm, decipher_parity_kernel<4>, THREADS, 0);
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, decipher_parity_kernel<1>, THREADS, 0);
}
