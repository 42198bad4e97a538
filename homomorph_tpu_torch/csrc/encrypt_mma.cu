// K3 and X1: fused encryption of a flat bit batch as an int8 counts product
// on the tensor cores, with wgmma.
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
// masking.  Counts accumulate in int32, exact for every tau.  The plaintext
// bit is XORed into limb 0; limbs m with 32m >= D are zero apart from it.
//
// Bound on the H100: the 2*B*tau*D products at the int8 tensor-core rate
// (1,979 Tops/s dense) bind over the bytes at tau = 128 and 256 (K3 reads
// B*W words, X1 B*tau bytes; both write B*L words).
//
// Design (the plan is gf2/encrypt_kernel.py::mma_plan, passed in by the
// wrapper; encrypt_mma_walk walks it in torch):
// * The planes stay resident, the rows stream.  A block (four warpgroups,
//   one block per SM) copies a column slice of the planes, slice_limbs * 32
//   plane rows by kc bytes of K, into shared memory once, in wgmma's K-major
//   layout without swizzle (8-row x 16-byte core matrices of 128 bytes, the
//   K halves LBO apart and the 8-column groups SBO = 128 bytes apart).  Its
//   warpgroups then walk 64-row tiles, each of its own.  Re-reading the
//   planes for every row tile (rows resident instead) would cost L2 traffic
//   of the planes' size per tile.  The D = 288 planes of tau = 128 fit one
//   slice; tau = 256's 2,080 x 256 bytes take three.  When one tile's
//   planes do not fit at all (tau beyond ~7,000), passes over K XOR their
//   parities into the output (the parity of a sum is the XOR of the parts'
//   parities).
// * wgmma.mma_async.m64nNk32.s32.s8.s8 with A from registers and B, the
//   planes, from shared memory; N is 32, 64 or 96 (one to three limbs): a
//   slice's limbs are cut into tiles of at most three, as even as they go.
//   A needs no shared memory: the fragment of lane (g, t) of warp w is bytes
//   4t..4t+3 and 16+4t..16+4t+3 of the 32-byte k-step of rows 16w+g and
//   16w+g+8.  K3 builds it straight from the selection words (a nibble
//   spreads to four 0/1 bytes with one multiply); X1 loads it from its int8
//   rows (4-byte loads when tau % 4 == 0, bytes otherwise).  A thread holds
//   the fragments of 8 k-steps (256 bytes of K, 32 registers) and reuses them
//   for every column tile of the row tile when K fits them; K3 loads its
//   next tile's words while the current tile computes, X1 its next tile's
//   fragments while the current tile's limbs leave.
// * Epilogue: lane (g, t) holds columns 8j+2t and 8j+2t+1 (j = 0..3) of rows
//   g and g+8.  The planes' columns are permuted within each limb as they
//   are copied to shared memory, so those 8 columns are key bits 8t..8t+7:
//   each lane packs its parities into byte t of the limb's word of both rows
//   (three byte permutes gather four counts' low bytes, and a multiply packs
//   their parity bits) and stores the two bytes, with no shuffle; the plain
//   bit goes into byte 0 of limb 0 there.  The limbs go to the warpgroup's
//   stage in shared memory, and the whole tile then leaves as consecutive
//   words of its rows (one contiguous block when a slice holds every limb),
//   with zeros for limbs beyond the key.  Four warpgroups per SM overlap one
//   tile's epilogue and loads with another's products (measured against two
//   and three; 128 registers a thread, ptxas spills a few bytes).
// * ptxas serializes wgmma behind a branch it cannot prove uniform, and
//   fences each one whose registers a branch merges.  So the warpgroup index
//   is broadcast with a shuffle, and every run of k-steps is straight-line
//   code of 1, 2, 4 or 8 wgmma ended by its wait: K is padded with zeros to
//   such a run (mma_plan's Kq; tau = 33, 128 and 256 need no padding).
// * Safe under a CUDA graph capture: no descriptor or plan lives in device
//   memory; everything the kernel reads besides its operands is a kernel
//   parameter.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int WGS = 4;              // consumer warpgroups a block (MMA_WARPGROUPS)
constexpr int THREADS = 128 * WGS;
constexpr int TM = 64;              // rows of a warpgroup's tile (MMA_TILE_ROWS)
constexpr int TILE_LIMBS = 3;       // widest wgmma tile, m64n96 (MMA_TILE_LIMBS)
constexpr int KG = 8;               // k-steps of A fragments a thread holds
constexpr int SMEM_CAP = 232448;    // dynamic shared memory a block may use (MMA_SMEM_CAP)

struct Params {
    const void* a;  // selw [B, W] u32 (K3) or sel [B, tau] s8 (X1)
    const int8_t* planes;
    const uint32_t* plain;
    uint32_t* out;
    long long B, row_tiles;
    int tau, W, L, Kq, Lc, slice_limbs, n_slices, stride, kc, groups;
};

// The wgmma shapes of one to three limbs: acc [NL * 16] int32 per thread.
template <int NL>
struct Wgmma;

template <>
struct Wgmma<1> {
    static __device__ __forceinline__ void mma(int (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
            "{%16, %17, %18, %19}, %20, p;\n}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
              "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
    }
};

template <>
struct Wgmma<2> {
    static __device__ __forceinline__ void mma(int (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
            "{%32, %33, %34, %35}, %36, p;\n}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
              "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
              "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
              "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
    }
};

template <>
struct Wgmma<3> {
    static __device__ __forceinline__ void mma(int (&d)[48], const uint32_t (&a)[4], uint64_t desc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
            "{%48, %49, %50, %51}, %52, p;\n}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
              "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
              "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
              "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
              "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
              "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
    }
};

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving register reads and writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[KG][4]) {
#pragma unroll
    for (int i = 0; i < KG; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
__device__ __forceinline__ void bar_sync_wg(int wg) {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}
// The low bytes of four counts (3 byte permutes)
__device__ __forceinline__ uint32_t low_bytes(int a, int b, int c, int d) {
    return __byte_perm(__byte_perm((uint32_t)a, (uint32_t)b, 0x0040),
                       __byte_perm((uint32_t)c, (uint32_t)d, 0x0040), 0x5410);
}
// Bits 2j and 2j + 1 of the result: the parities of byte j of x0 and x1
// (the multiply moves bits 0..1 of each byte to bits 24 + 2j, with no carry
// into them)
__device__ __forceinline__ uint32_t parity_byte(uint32_t x0, uint32_t x1) {
    const uint32_t y = (x0 & 0x01010101u) | ((x1 << 1) & 0x02020202u);
    return (y * 0x01041040u) >> 24;
}

// The plane row of tile column n: within each limb, column 8j + 2t + v
// holds key bit 8t + 2j + v (an involution), so that lane t's columns of a
// limb are its byte t
__device__ __forceinline__ int plane_row(int n) {
    const int q = n & 31;
    return (n & ~31) | (((q >> 1) & 3) << 3) | ((q >> 3) << 1) | (q & 1);
}

// bits 0..3 of x -> bytes 0..3 of the result, each 0 or 1
__device__ __forceinline__ uint32_t spread4(uint32_t x) { return ((x & 0xFu) * 0x00204081u) & 0x01010101u; }

// wgmma shared-memory descriptor, no swizzle: start, LBO (K direction), SBO
// (8-row groups), all in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(sbo >> 4) << 32);
}

// 4 bytes of X1's row at k (zero past tau or past the batch)
template <int MODE>
__device__ __forceinline__ uint32_t sel4(const int8_t* sel, long long row, int k, const Params& p) {
    if (row >= p.B) return 0u;
    const int8_t* src = sel + row * p.tau + k;
    if constexpr (MODE == 1) {  // tau % 4 == 0: the 4 bytes are all in or all out
        return k < p.tau ? __ldg((const uint32_t*)src) : 0u;
    } else {
        uint32_t v = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i)
            if (k + i < p.tau) v |= (uint32_t)(uint8_t)__ldg(src + i) << (8 * i);
        return v;
    }
}

// K3's selection words of k-steps k / 32 .. k / 32 + kbytes / 32 - 1 for
// rows ra, rb (zero past the batch and in K's padding)
__device__ __forceinline__ void load_words(uint32_t (&w)[KG][2], const Params& p, long long ra,
                                           long long rb, int k, int kbytes) {
    const uint32_t* selw = (const uint32_t*)p.a;
#pragma unroll
    for (int ks = 0; ks < KG; ++ks) {
        const bool in = 32 * ks < kbytes && k / 32 + ks < p.W;
        w[ks][0] = in && ra < p.B ? __ldg(selw + ra * p.W + k / 32 + ks) : 0u;
        w[ks][1] = in && rb < p.B ? __ldg(selw + rb * p.W + k / 32 + ks) : 0u;
    }
}

// K3's A fragments from its words: lane t takes nibbles t and 4 + t
__device__ __forceinline__ void spread_words(uint32_t (&af)[KG][4], const uint32_t (&w)[KG][2],
                                             int t) {
#pragma unroll
    for (int ks = 0; ks < KG; ++ks) {
        af[ks][0] = spread4(w[ks][0] >> (4 * t));
        af[ks][1] = spread4(w[ks][1] >> (4 * t));
        af[ks][2] = spread4(w[ks][0] >> (16 + 4 * t));
        af[ks][3] = spread4(w[ks][1] >> (16 + 4 * t));
    }
}

// A fragments of k-steps k / 32 .. k / 32 + kbytes / 32 - 1 for rows ra, rb.
// MODE 0: K3's words; 1: X1, tau % 4 == 0; 2: X1, any tau.
template <int MODE>
__device__ __forceinline__ void load_a(uint32_t (&af)[KG][4], const Params& p, long long ra,
                                       long long rb, int k, int kbytes, int t) {
    if constexpr (MODE == 0) {
        uint32_t w[KG][2];
        load_words(w, p, ra, rb, k, kbytes);
        spread_words(af, w, t);
    } else {
        const int8_t* sel = (const int8_t*)p.a;
#pragma unroll
        for (int ks = 0; ks < KG; ++ks) {
            const int kk = k + 32 * ks + 4 * t;
            const bool in = 32 * ks < kbytes;
            af[ks][0] = in ? sel4<MODE>(sel, ra, kk, p) : 0u;
            af[ks][1] = in ? sel4<MODE>(sel, rb, kk, p) : 0u;
            af[ks][2] = in ? sel4<MODE>(sel, ra, kk + 16, p) : 0u;
            af[ks][3] = in ? sel4<MODE>(sel, rb, kk + 16, p) : 0u;
        }
    }
}

// NKS k-steps of products into acc, waited for: straight-line, so that the
// accumulator chain passes through no branch (ptxas serializes wgmma whose
// registers a branch merges)
template <int NL, int NKS>
__device__ __forceinline__ void run_ksteps(int (&acc)[NL * 16], uint32_t (&af)[KG][4],
                                           uint32_t addr, uint32_t kstep_bytes, uint32_t lbo) {
    fence_regs(acc);
    fence_regs(af);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
        Wgmma<NL>::mma(acc, af[ks], smem_desc(addr + ks * kstep_bytes, lbo, 128u));
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    fence_regs(af);
}

// One column tile of NL limbs (slice-local limbs lo .. lo+NL-1) of one row
// tile: the products over this pass's K, then the parities packed into the
// warpgroup's stage.
template <int NL, int MODE>
__device__ __forceinline__ void col_tile(uint32_t (&af)[KG][4], const Params& p, int k0, int kcur,
                                         long long ra, long long rb, uint32_t bs_addr, int n_groups,
                                         int lo, uint32_t* stage, int warp, int g, int t,
                                         uint32_t plain_a, uint32_t plain_b) {
    int acc[NL * 16];
#pragma unroll
    for (int i = 0; i < NL * 16; ++i) acc[i] = 0;
    const int n_kg = (kcur + 32 * KG - 1) / (32 * KG);
    const uint32_t lbo = (uint32_t)n_groups * 128u;  // one 16-byte K half of the slice
    for (int kg = 0; kg < n_kg; ++kg) {
        const int kb = min(32 * KG, kcur - 32 * KG * kg);  // 32, 64, 128 or 256 (mma_plan)
        if (n_kg > 1) load_a<MODE>(af, p, ra, rb, k0 + 32 * KG * kg, kb, t);
        // 16-byte K chunk 2 * KG * kg of the pass, the tile's first 8-column group
        const uint32_t addr = bs_addr + (uint32_t)(2 * KG * kg * n_groups + 4 * lo) * 128u;
        switch (kb >> 5) {
            case 1: run_ksteps<NL, 1>(acc, af, addr, 2 * lbo, lbo); break;
            case 2: run_ksteps<NL, 2>(acc, af, addr, 2 * lbo, lbo); break;
            case 4: run_ksteps<NL, 4>(acc, af, addr, 2 * lbo, lbo); break;
            default: run_ksteps<NL, 8>(acc, af, addr, 2 * lbo, lbo); break;
        }
    }
    // the planes' columns are permuted in shared memory (plane_row), so the
    // 8 columns lane (g, t) holds of a limb are bits 8t .. 8t+7: byte t of
    // the limb's word for rows g and g + 8
    uint8_t* st = (uint8_t*)stage;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
        const int* d = acc + 16 * l;  // d[4j + 2h + v]: row g + 8h, column 8j + 2t + v
        uint32_t lo_b = parity_byte(low_bytes(d[0], d[4], d[8], d[12]), low_bytes(d[1], d[5], d[9], d[13]));
        uint32_t hi_b = parity_byte(low_bytes(d[2], d[6], d[10], d[14]), low_bytes(d[3], d[7], d[11], d[15]));
        if (l == 0) {  // 0 unless this is byte 0 of limb 0 of the first pass
            lo_b ^= plain_a;
            hi_b ^= plain_b;
        }
        st[4 * ((16 * warp + g) * p.stride + lo + l) + t] = (uint8_t)lo_b;
        st[4 * ((16 * warp + g + 8) * p.stride + lo + l) + t] = (uint8_t)hi_b;
    }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1) encrypt_wgmma_kernel(const Params p) {
    extern __shared__ __align__(128) uint8_t smem[];
    const int slice = blockIdx.x % p.n_slices;
    const int group = blockIdx.x / p.n_slices;
    const int m0 = slice * p.slice_limbs;
    const int limbs = min(p.slice_limbs, p.Lc - m0);            // limbs this slice computes
    const int n_out = (slice == p.n_slices - 1 ? p.L : m0 + limbs) - m0;  // and writes
    const int n_groups = 4 * limbs;                              // 8-column groups
    const int Kp = 32 * p.W;
    const int Kq = p.Kq;  // K padded to 1, 2, 4 or a multiple of 8 k-steps
    // the warpgroup index, broadcast so that the compiler knows it uniform
    // (a branch it cannot prove uniform around wgmma serializes them)
    const int wg = __shfl_sync(0xFFFFFFFFu, (int)(threadIdx.x >> 7), 0);
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    int8_t* Bs = (int8_t*)smem;
    uint32_t* stage = (uint32_t*)(smem + p.slice_limbs * 32 * p.kc) + wg * TM * p.stride;
    const uint32_t bs_addr = (uint32_t)__cvta_generic_to_shared(Bs);
    const int n_ct = (limbs + TILE_LIMBS - 1) / TILE_LIMBS;
    // the copy-out's (row, limb) of word tid of a tile, and its step per 128 words
    const int r_first = tid / n_out, m_first = tid % n_out, dr = 128 / n_out, dm = 128 % n_out;
    uint32_t af[KG][4];
    uint32_t words[KG][2];  // K3: the selection words of the warpgroup's next tile

    for (int k0 = 0; k0 < Kq; k0 += p.kc) {
        const int kcur = min(p.kc, Kq - k0);
        // the slice's planes for this pass: 16-byte chunk c of tile column n
        // (plane row plane_row(n)) goes to core matrix (c, n / 8), row n % 8
        __syncthreads();  // the previous pass is done with Bs
        const int chunks = kcur / 16;
        for (int e = threadIdx.x; e < 32 * limbs * chunks; e += THREADS) {
            const int n = e / chunks, c = e - n * chunks;
            const uint4 v = k0 + 16 * c < Kp
                ? __ldg((const uint4*)(p.planes + (long long)(32 * m0 + plane_row(n)) * Kp + k0 + 16 * c))
                : make_uint4(0u, 0u, 0u, 0u);  // K's padding
            *(uint4*)(Bs + (c * n_groups + (n >> 3)) * 128 + (n & 7) * 16) = v;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
        __syncthreads();

        const bool one_group = kcur <= 32 * KG;  // A fragments serve every column tile
        const long long step = (long long)p.groups * WGS;
        long long tile = (long long)group * WGS + wg;
        const long long ra0 = tile * TM + 16 * warp + g;
        if (one_group) {  // the first tile's selection
            if constexpr (MODE == 0)
                load_words(words, p, ra0, ra0 + 8, k0, kcur);
            else
                load_a<MODE>(af, p, ra0, ra0 + 8, k0, kcur, t);
        }
        // the plain bits of rows ra, rb go into byte 0 of limb 0 in the first
        // pass (lane t == 0 holds byte 0)
        const bool plain_here = k0 == 0 && m0 == 0 && t == 0;
        for (; tile < p.row_tiles; tile += step) {
            const long long row0 = tile * TM;
            const long long ra = row0 + 16 * warp + g, rb = ra + 8;
            if (MODE == 0 && one_group) {
                spread_words(af, words, t);
                // the next tile's words are in flight while this one computes
                const long long na = ra + step * TM;
                load_words(words, p, na, na + 8, k0, kcur);
            }
            const uint32_t pa = plain_here && ra < p.B ? __ldg(p.plain + ra) & 1u : 0u;
            const uint32_t pb = plain_here && rb < p.B ? __ldg(p.plain + rb) & 1u : 0u;
            for (int ct = 0; ct < n_ct; ++ct) {
                const int lo = ct * limbs / n_ct, hi = (ct + 1) * limbs / n_ct;
                const uint32_t qa = lo == 0 ? pa : 0u, qb = lo == 0 ? pb : 0u;
                switch (hi - lo) {
                    case 1: col_tile<1, MODE>(af, p, k0, kcur, ra, rb, bs_addr, n_groups, lo, stage, warp, g, t, qa, qb); break;
                    case 2: col_tile<2, MODE>(af, p, k0, kcur, ra, rb, bs_addr, n_groups, lo, stage, warp, g, t, qa, qb); break;
                    default: col_tile<3, MODE>(af, p, k0, kcur, ra, rb, bs_addr, n_groups, lo, stage, warp, g, t, qa, qb); break;
                }
            }
            if (MODE != 0 && one_group) {
                // X1: the next tile's rows load while this tile leaves (the
                // last products were waited for, so af is free)
                const long long na = ra + step * TM;
                load_a<MODE>(af, p, na, na + 8, k0, kcur, t);
            }
            // the tile's limbs leave as consecutive words of its rows
            bar_sync_wg(wg);
            for (int e = tid, r = r_first, m = m_first; e < TM * n_out; e += 128) {
                const long long row = row0 + r;
                if (row < p.B) {
                    uint32_t v = m < limbs ? stage[r * p.stride + m] : 0u;
                    uint32_t* dst = p.out + row * p.L + m0 + m;
                    if (k0 > 0) v ^= *dst;  // a later pass: XOR onto the earlier passes' parities
                    *dst = v;
                }
                r += dr;  // (r, m) of e + 128
                m += dm;
                if (m >= n_out) {
                    m -= n_out;
                    ++r;
                }
            }
            bar_sync_wg(wg);  // the stage is free for the next tile
        }
    }
}

// mma_plan's fields, in its order (gf2/encrypt_kernel.py::MmaPlan)
struct Plan {
    long long W, Kp, Kq, Lc, kc, n_pass, slice_limbs, n_slices, stage_stride, row_tiles, groups,
        smem_bytes;
};
static_assert(sizeof(Plan) == 12 * sizeof(long long), "Plan is MmaPlan's twelve int64");

template <int MODE>
int launch_mode(const Params& p, int blocks, int smem_bytes, cudaStream_t stream) {
    static bool attr_set = false;  // the dynamic shared-memory limit, set at first launch
    if (!attr_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            encrypt_wgmma_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_CAP);
        if (err != cudaSuccess) return (int)err;
        attr_set = true;
    }
    encrypt_wgmma_kernel<MODE><<<blocks, THREADS, smem_bytes, stream>>>(p);
    return (int)cudaGetLastError();
}

int launch(bool words, const void* a, const void* planes, const void* plain, void* out,
           long long B, int tau, int W, int D, int L, const Plan& q, void* stream) {
    if (L < 1 || L > 65535 || W < 1 || tau < 1 || tau > 32 * W || D < 32 || D % 32)
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return 0;
    // the plan is mma_plan's, taken as it comes; checked only for what the
    // kernel relies on
    const int steps = q.Kq / 32;
    const bool kq_ok = q.Kq % 32 == 0 && q.Kq >= 32 * W &&
                       (steps == 1 || steps == 2 || steps == 4 || steps % KG == 0);
    const bool kc_ok = q.kc >= 32 && q.kc <= q.Kq &&
                       (q.kc % (32 * KG) == 0 || q.kc == 32 || q.kc == 64 || q.kc == 128);
    const bool slices_ok = q.Lc == min(L, D / 32) && q.slice_limbs >= 1 && q.n_slices >= 1 &&
                           (long long)(q.n_slices - 1) * q.slice_limbs < q.Lc &&
                           (long long)q.n_slices * q.slice_limbs >= q.Lc;
    const long long need = (long long)q.slice_limbs * 32 * q.kc + (long long)WGS * TM * 4 * q.stage_stride;
    const long long blocks = (long long)q.n_slices * q.groups;
    if (!kq_ok || !kc_ok || !slices_ok || q.stage_stride < q.slice_limbs || q.groups < 1 ||
        q.row_tiles != (B + TM - 1) / TM || need != q.smem_bytes || need > SMEM_CAP ||
        blocks > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    Params p;
    p.a = a;
    p.planes = (const int8_t*)planes;
    p.plain = (const uint32_t*)plain;
    p.out = (uint32_t*)out;
    p.B = B;
    p.row_tiles = q.row_tiles;
    p.tau = tau;
    p.W = W;
    p.L = L;
    p.Kq = q.Kq;
    p.Lc = q.Lc;
    p.slice_limbs = q.slice_limbs;
    p.n_slices = q.n_slices;
    p.stride = q.stage_stride;
    p.kc = q.kc;
    p.groups = q.groups;
    const cudaStream_t s = (cudaStream_t)stream;
    if (words) return launch_mode<0>(p, (int)blocks, q.smem_bytes, s);
    if (tau % 4 == 0) return launch_mode<1>(p, (int)blocks, q.smem_bytes, s);
    return launch_mode<2>(p, (int)blocks, q.smem_bytes, s);
}

}  // namespace

// K3: selw [B, W] u32, planes [D, 32W] s8, plain [B] u32 -> out [B, L] u32,
// on the plan of mma_plan(B, 32W, D, L), its twelve fields as int64 in
// MmaPlan's order.  Returns cudaGetLastError() after the launch (0 on
// success), cudaErrorInvalidValue for a plan the kernel cannot run.
extern "C" int hm_encrypt_mma_words(const void* selw, const void* planes, const void* plain,
                                    void* out, long long B, int W, int D, int L,
                                    const long long* plan, void* stream) {
    Plan q;
    std::memcpy(&q, plan, sizeof q);
    if (q.W != W) return (int)cudaErrorInvalidValue;
    return launch(true, selw, planes, plain, out, B, 32 * W, W, D, L, q, stream);
}

// X1: sel [B, tau] s8 0/1, planes [D, 32*ceil(tau/32)] s8, plain [B] u32
// -> out [B, L] u32, on the plan of mma_plan(B, tau, D, L), as for K3.
// Returns cudaGetLastError() after the launch.
extern "C" int hm_encrypt_mma_sel(const void* sel, const void* planes, const void* plain,
                                  void* out, long long B, int tau, int D, int L,
                                  const long long* plan, void* stream) {
    Plan q;
    std::memcpy(&q, plan, sizeof q);
    if (q.W != (tau + 31) / 32) return (int)cudaErrorInvalidValue;
    return launch(false, sel, planes, plain, out, B, tau, (int)q.W, D, L, q, stream);
}
