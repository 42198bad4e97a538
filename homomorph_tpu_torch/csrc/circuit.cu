// C1, C2 and C3: the glue of the carry-save tree multiplier and of the ripple
// adders (homomorph_tpu_torch/models/circuits.py), as three launches that
// take a whole level, or a whole ripple step, at once.
//
// Replaces the glue of the JAX package's circuits: the XORs, pads, slices,
// operand stacks and degree-class fits of homomorph_tpu/models/circuits.py::
// _batched_clmul_pairs (:726-755), _fit_bit (:756-764), _csa_accumulate
// (:765-843), _ripple_add_rows (:844-919) and add's carry chain (:153-242).
// Those are XLA ops that jax.jit fuses; there is no Pallas kernel.
//
// Every launch is a list of ops over the same `rows` rows.  An op reads up to
// NS sources and writes up to ND destinations, each a run of `width` limbs a
// row at `p + row * stride`.  Destination d is the XOR of the sources its
// `mask` names (bit s: source s), each source read as zero at and past its own
// width, written over the destination's whole width: a destination wider than
// its sources is zero-extended, a narrower one truncates them (the wrapper only
// truncates where the circuit knows the limbs past it are zero: a degree-class
// fit).  Nothing of a destination is left unwritten, so the wrapper allocates
// every output with torch.empty.
//
//   C1 hm_csa_level_in  (3 sources, 5 destinations, CSA_IN_OPS ops a launch):
//      a level's compressors, one op each: x, y, z -> the sum x ^ y (^ z) at
//      its width, and the rows of the level's grouped clmul operands, written
//      straight into each group's tensors: (x, y) for p1 and (x ^ y, z) for
//      p2 of a full adder, (x, y) of a half adder.  Also the ripple's first
//      launch (each column's x = a ^ b, its g operands, and the output lanes
//      that no carry reaches) and add's (x lanes, output lane 0).
//   C2 hm_csa_level_out (2 sources, 1 destination, CSA_OUT_OPS ops a launch):
//      a level's carries after its grouped clmuls: p1 (^ p2), read from the
//      groups' product rows, at the carry's bucketed width.
//   C3 hm_ripple_step   (3 sources, 2 destinations, one op):
//      one step of a carry chain: carry' = fit(prod, Lc) ^ g and
//      out[i+1] = x[i+1] ^ carry', the lane written straight into the
//      preallocated output [..., n, L_out], zero tail included.
//
// The ops reach the kernel by value, as one __grid_constant__ parameter (no
// host-to-device copy: a CUDA graph captures a whole product).  CUDA 12.1 and
// later take up to 32,764 bytes of parameters on sm_70 and up, so a launch of
// C1 takes at most CSA_IN_OPS = 240 ops (132 bytes each) and one of C2 at most
// CSA_OUT_OPS = 600 carries (52 bytes each); the wrapper splits a wider level
// into as many launches (u64's first level: 692 ops, three launches of C1 and
// two of C2; every level of the u32 product fits one).
//
// The work: op i covers rows * W_i limbs (W_i its widest destination), cut in
// tiles of TILE limbs; a block takes a tile, finds its op by binary search on
// the tiles' prefix (in the parameter), and each thread a limb of the tile:
// row = e / W, limb = e - row W, every source loaded once, every destination
// stored once.  Neighbouring threads touch neighbouring limbs of a row, so
// loads and stores coalesce; no shared memory.  Bound: bytes (each source
// read once, each destination written once, at 3.35 TB/s on the H100).  Each
// launch is small next to the level's clmuls: the point is one launch where
// the torch glue issued tens to hundreds.

#include <cuda_runtime.h>
#include <cstdint>

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12010
#error "circuit.cu passes up to 32,764 bytes of kernel parameters: it needs CUDA 12.1 or later"
#endif

namespace {

constexpr int THREADS = 256;
constexpr uint32_t TILE = 2048;        // limbs a block takes at once
constexpr int CSA_IN_OPS = 240;        // C1: ops a launch (kernels' parameter limit)
constexpr int CSA_OUT_OPS = 600;       // C2: carries a launch
constexpr int RIPPLE_OPS = 1;          // C3: one step
constexpr uint32_t WIDTH_MASK = (1u << 28) - 1;  // widths below 2^28 limbs; the mask above
constexpr int H100_SMS = 132;

struct Src {
    const uint32_t* p;
    uint32_t stride;  // words from a row to the next (0: one row for all)
    uint32_t width;   // limbs a row; 0: absent (reads as zero)
};

struct Dst {
    uint32_t* p;
    uint32_t stride;
    uint32_t wm;  // width | mask << 28; width 0: absent
};

template <int NS, int ND>
struct Op {
    Src src[NS];
    Dst dst[ND];
};

template <int NS, int ND, int CAP>
struct Launch {
    uint32_t n_ops;
    uint32_t rows;
    uint32_t begin[CAP + 1];  // op i has tiles [begin[i], begin[i+1])
    Op<NS, ND> op[CAP];
};

using InLaunch = Launch<3, 5, CSA_IN_OPS>;
using OutLaunch = Launch<2, 1, CSA_OUT_OPS>;
using StepLaunch = Launch<3, 2, RIPPLE_OPS>;
static_assert(sizeof(InLaunch) <= 32764, "C1's parameter passes 32,764 bytes");
static_assert(sizeof(OutLaunch) <= 32764, "C2's parameter passes 32,764 bytes");

template <int ND>
__host__ __device__ uint32_t widest(const Dst (&dst)[ND]) {
    uint32_t w = 0;
    for (int d = 0; d < ND; ++d) {
        const uint32_t wd = dst[d].wm & WIDTH_MASK;
        w = wd > w ? wd : w;
    }
    return w;
}

template <int NS, int ND, int CAP>
__device__ __forceinline__ void xor_rows(const Launch<NS, ND, CAP>& L) {
    const uint32_t total = L.begin[L.n_ops];
    for (uint32_t tile = blockIdx.x; tile < total; tile += gridDim.x) {
        uint32_t lo = 0, hi = L.n_ops - 1;  // the last op whose first tile is <= tile
        while (lo < hi) {
            const uint32_t mid = (lo + hi + 1) >> 1;
            if (L.begin[mid] <= tile) lo = mid; else hi = mid - 1;
        }
        const Op<NS, ND>& op = L.op[lo];
        const uint32_t W = widest(op.dst);
        const uint32_t e0 = (tile - L.begin[lo]) * TILE;
        const uint32_t e1 = min(e0 + TILE, L.rows * W);  // rows * W + TILE < 2^32 (checked)
        for (uint32_t e = e0 + threadIdx.x; e < e1; e += THREADS) {
            const uint32_t row = e / W;
            const uint32_t t = e - row * W;
            uint32_t v[NS];
#pragma unroll
            for (int s = 0; s < NS; ++s)
                v[s] = t < op.src[s].width
                           ? __ldg(op.src[s].p + (size_t)row * op.src[s].stride + t) : 0u;
#pragma unroll
            for (int d = 0; d < ND; ++d) {
                const uint32_t wm = op.dst[d].wm;
                if (t >= (wm & WIDTH_MASK)) continue;
                uint32_t x = 0;
#pragma unroll
                for (int s = 0; s < NS; ++s)
                    if ((wm >> (28 + s)) & 1u) x ^= v[s];
                op.dst[d].p[(size_t)row * op.dst[d].stride + t] = x;
            }
        }
    }
}

__global__ void __launch_bounds__(THREADS) csa_level_in_kernel(const __grid_constant__ InLaunch L) {
    xor_rows(L);
}

__global__ void __launch_bounds__(THREADS) csa_level_out_kernel(const __grid_constant__ OutLaunch L) {
    xor_rows(L);
}

__global__ void __launch_bounds__(THREADS) ripple_step_kernel(const __grid_constant__ StepLaunch L) {
    xor_rows(L);
}

bool aligned4(long long p) { return (p & 3) == 0; }

// words: n_ops, rows, then per op NS sources (pointer, stride, width) and ND
// destinations (pointer, stride, width, mask).  Checks each field and fills
// the launch; returns a cudaError (0 on success).
template <int NS, int ND, int CAP>
int read_launch(const long long* words, int n_words, Launch<NS, ND, CAP>* L) {
    constexpr int PER_OP = 3 * NS + 4 * ND;
    if (n_words < 2) return (int)cudaErrorInvalidValue;
    const long long n_ops = words[0], rows = words[1];
    if (n_ops < 1 || n_ops > CAP || rows < 1 || rows >= (1LL << 32) ||
        n_words != 2 + n_ops * PER_OP)
        return (int)cudaErrorInvalidValue;
    L->n_ops = (uint32_t)n_ops;
    L->rows = (uint32_t)rows;
    long long tiles = 0;
    for (long long i = 0; i < n_ops; ++i) {
        const long long* w = words + 2 + i * PER_OP;
        Op<NS, ND>& op = L->op[i];
        for (int s = 0; s < NS; ++s, w += 3) {
            const long long p = w[0], stride = w[1], width = w[2];
            if (width < 0 || width > WIDTH_MASK || stride < 0 || stride >= (1LL << 32) ||
                (width > 0 && (p == 0 || !aligned4(p))))
                return (int)cudaErrorInvalidValue;
            op.src[s].p = width ? (const uint32_t*)p : nullptr;
            op.src[s].stride = (uint32_t)stride;
            op.src[s].width = (uint32_t)width;
        }
        for (int d = 0; d < ND; ++d, w += 4) {
            const long long p = w[0], stride = w[1], width = w[2], mask = w[3];
            if (width < 0 || width > WIDTH_MASK || stride < 0 || stride >= (1LL << 32) ||
                mask < 0 || mask >= (1LL << NS) || (width > 0 && (p == 0 || !aligned4(p))))
                return (int)cudaErrorInvalidValue;
            op.dst[d].p = width ? (uint32_t*)p : nullptr;
            op.dst[d].stride = (uint32_t)stride;
            op.dst[d].wm = (uint32_t)width | ((uint32_t)mask << 28);
        }
        const long long W = widest(op.dst);
        if (rows * W + TILE >= (1LL << 32)) return (int)cudaErrorInvalidValue;
        L->begin[i] = (uint32_t)tiles;
        tiles += (rows * W + TILE - 1) / TILE;
        if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    }
    L->begin[n_ops] = (uint32_t)tiles;
    return 0;
}

template <int NS, int ND, int CAP>
int launch(void (*kernel)(Launch<NS, ND, CAP>), const long long* words, int n_words,
           void* stream) {
    Launch<NS, ND, CAP> L;
    const int err = read_launch(words, n_words, &L);
    if (err) return err;
    const uint32_t tiles = L.begin[L.n_ops];
    if (tiles == 0) return 0;  // every destination empty
    const uint32_t cap = H100_SMS * 16;
    kernel<<<tiles < cap ? tiles : cap, THREADS, 0, (cudaStream_t)stream>>>(L);
    return (int)cudaGetLastError();
}

}  // namespace

// C1: a carry-save level's compressors (or the ripple's and add's first
// launch); at most CSA_IN_OPS ops.
extern "C" int hm_csa_level_in(const long long* words, int n_words, void* stream) {
    return launch(csa_level_in_kernel, words, n_words, stream);
}

// C2: a carry-save level's carries; at most CSA_OUT_OPS.
extern "C" int hm_csa_level_out(const long long* words, int n_words, void* stream) {
    return launch(csa_level_out_kernel, words, n_words, stream);
}

// C3: one step of a carry chain.
extern "C" int hm_ripple_step(const long long* words, int n_words, void* stream) {
    return launch(ripple_step_kernel, words, n_words, stream);
}

// The ops a launch of C1, C2 and C3 takes at most (the wrapper checks its own
// constants against these once).
extern "C" void hm_circuit_caps(long long* out) {
    out[0] = CSA_IN_OPS;
    out[1] = CSA_OUT_OPS;
    out[2] = RIPPLE_OPS;
}
