// R1 and R2: the split and the join of the clmul dispatcher's Karatsuba
// route (homomorph_tpu_torch/gf2/kernels.py::clmul_rows), around ONE K1
// launch (csrc/clmul.cu).
//
// Replaces the route's glue of the JAX package: the pads, slices and XORs of
// homomorph_tpu/gf2/kernels.py::_karatsuba_flat (:356-387) and of the chunk
// branch of _clmul_flat (:212-225).  Those are XLA ops that jax.jit fuses;
// there is no Pallas kernel.  Run eagerly, the same glue was about eleven
// torch launches and three or four passes over device memory per level.
//
// The route (kernels.py::route_plan): at most one chunk step, which cuts the
// wider operand into n pieces of Ls limbs (the smaller operand repeats for
// each), then k split steps; split level i halves every row at h[i], the
// rows of x0, of x1 (padded to h[i]) and of x0 ^ x1 stacked in that order.
// Leaf row index, the order the torch glue has always had:
//
//   r0 + rows0 * (t_1 + 3 t_2 + ... + 3^(k-1) t_k),   r0 = b * n + j,
//
// rows0 = B * n, t_i in {0: x0, 1: x1, 2: x0 ^ x1} the digit of split level
// i.  The K1 launch takes the leaves of both operands, [rows0 3^k, w] each
// (w = h[k-1]), and gives their products, [rows0 3^k, 2w].
//
// R1 (hm_route_split): the whole descent in one launch, both operands.  A
// block takes G nodes at depth D at once (a node: a row r0 and the first D
// digits; G > 1 only at D = 0, where nodes are small): it stages each node
// in shared memory, splits it level by level inside shared memory (two
// buffers), and at the last level writes the three children of each limb
// straight to their leaf rows.  A thread takes one limb of a parent and
// writes its x0, x1 and x0 ^ x1 limbs.  Staging at D > 0 reads the original
// row: limb p of the node is the XOR of at most 2^(number of 2 digits)
// limbs of the row, at p plus the h of every level whose half the path (or
// one subset of its 2 digits) takes.  The hazard is padding: x1 padded to
// h, an odd width, the smaller operand padded to the wider at the first
// split, a last chunk piece narrower than Ls.  A limb past its node's real
// width is zero, but p + h can land on a real limb of the neighbouring half
// or row, so the real width W of every node on the path is tracked (W' =
// min(W, h) for x0 and x0 ^ x1, clamp(W - h, 0, h) for x1) and a term is
// read only if its position is below W at every level.  Inside shared
// memory the zeros are stored, so the levels below D need no widths.  D is
// the least depth whose subtree's inner levels fit SPLIT_SMEM_WORDS,
// deepened until the grid has two nodes an SM; D = k writes each leaf
// straight from the row.
//
// R2 (hm_route_join): the ascent, one launch per level or fewer.  Split
// level i turns the three products of each node's children, p0 (t = 0), p2
// (t = 1) and pm (t = 2), each 2 h[i] limbs, into the node's product:
//
//   out[t] = p0[t] ^ p0[t-h] ^ pm[t-h] ^ p2[t-h] ^ p2[t-2h],  t < lo[i],
//
// each term zero outside its row (lo[i] = Ls + Lg of that level, <= 4h).  A
// thread takes s < h and writes t = s, s+h, s+2h, s+3h from six loads:
// p0[s], p0[s+h], p2[s], p2[s+h], pm[s], pm[s+h].  The chunk step adds piece
// j at limb j Ls:
//
//   out[t] = piece[t/Ls][t%Ls] ^ piece[t/Ls - 1][Ls + t%Ls].
//
// The bottom levels run as one launch where a block's shared memory holds a
// whole subtree of them (3^m leaf products of 2w limbs): the block gathers
// the subtree's rows, joins m levels in shared memory, and writes the
// subtree root's product.  Every level above is one element-wise launch, and
// the chunk step one more.  The wrapper (kernels.py::join_launches) picks m
// with the same budget as JOIN_SMEM_WORDS here; this side refuses a launch
// that does not fit it.
//
// Bound on the H100: bytes.  R1 reads each original row once and writes each
// leaf row once; the staging's re-reads of a row (2^D of them at most) come
// from L2.  R2 reads each launch's products once and writes its output once.
// The route's table (B, widths, n, h[], lo[]) reaches the kernels by value
// as a struct argument, never as a device tensor, so a CUDA graph captures a
// routed product.  Offsets are 64-bit: the u64 product's leaves are
// [12,754,584, 32] per operand and its leaf products pass 2^31 bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 32;
constexpr int THREADS = 256;
// words of shared memory a block of R1 may take for its two buffers (32 KB:
// seven blocks share an SM), and R2's fused launch (64 KB: every fused level
// saves a pass over device memory)
constexpr long long SPLIT_SMEM_WORDS = 8192;
constexpr long long JOIN_SMEM_WORDS = 16384;
constexpr int MAX_GROUP = 64;   // nodes a block takes at once
constexpr int GROUP_WORK = 4096;  // limbs of work a block takes at once, at least
constexpr int H100_SMS = 132;  // the grid's target; any card is correct
constexpr int BLOCKS_PER_SM = 8;
constexpr int TILE = 2048;  // output limbs a block takes at once in R2's element-wise launches

struct Route {
    long long B;      // rows of the operands
    long long rows0;  // rows after the chunk step: B * n
    int Ls, Lg;       // the operands' widths, Ls <= Lg
    int n;            // pieces of the chunk step (1 without one)
    int chunked;      // 1 if the route starts with a chunk step
    int k;            // split levels, 1 <= k <= MAX_LEVELS
    int depth;        // R1: depth D of the nodes a block stages
    int group;        // R1: nodes a block takes at once (1 unless D = 0)
    int h[MAX_LEVELS];   // split point of each split level
    int lo[MAX_LEVELS];  // product width each split level's join writes
};

// The plan words the wrapper passes: B, Ls, Lg, n (0 without a chunk), k,
// h[0..k-1], lo[0..k-1].  Returns 0, or cudaErrorInvalidValue.
int read_route(const long long* w, Route* r) {
    r->B = w[0];
    r->Ls = (int)w[1];
    r->Lg = (int)w[2];
    r->chunked = w[3] > 0;
    r->n = r->chunked ? (int)w[3] : 1;
    r->k = (int)w[4];
    r->rows0 = r->B * r->n;
    r->depth = 0;
    r->group = 1;
    if (r->B < 1 || r->Ls < 1 || r->Lg < r->Ls || r->k < 1 || r->k > MAX_LEVELS)
        return (int)cudaErrorInvalidValue;
    if (r->chunked && (long long)r->n * r->Ls < r->Lg) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < r->k; ++i) {
        r->h[i] = (int)w[5 + i];
        r->lo[i] = (int)w[5 + r->k + i];
        const long long parent = i == 0 ? (r->chunked ? r->Ls : r->Lg) : r->h[i - 1];
        if (r->h[i] < 1 || 2LL * r->h[i] < parent || r->lo[i] > 4LL * r->h[i] ||
            r->lo[i] < 2LL * r->h[i])
            return (int)cudaErrorInvalidValue;
    }
    return 0;
}

__host__ __device__ long long pow3(int e) {
    long long p = 1;
    while (e-- > 0) p *= 3;
    return p;
}

// words of each of R1's two buffers for one node at depth D < k: the node
// (2 h[0] limbs at the root), and each inner level's 3^(i+1-D) children of
// h[i] limbs (the last level writes the leaves to device memory)
long long split_buffer_words(const Route& r, int D) {
    long long m = 1, words = D == 0 ? 2LL * r.h[0] : r.h[D - 1];
    for (int i = D; i < r.k - 1; ++i) {
        m *= 3;
        if (m * r.h[i] > words) words = m * r.h[i];
    }
    return words;
}

// ---------------------------------------------------------------- R1 --------

__global__ void __launch_bounds__(THREADS)
route_split_kernel(const uint32_t* __restrict__ small, const uint32_t* __restrict__ big,
                   uint32_t* __restrict__ leaf_s, uint32_t* __restrict__ leaf_g,
                   const Route r, int buf_words) {
    extern __shared__ __align__(16) uint32_t sh[];
    __shared__ int digit[MAX_LEVELS];
    __shared__ int width[MAX_LEVELS + 1];
    __shared__ long long base[MAX_GROUP];  // each node's first limb in its operand
    __shared__ int wid0[MAX_GROUP];        // each node's real width at D = 0
    __shared__ long long node_r0, node_pv;  // D > 0: the node's row and first D digits
    const int op = blockIdx.y;  // 0: the smaller operand, 1: the wider
    const uint32_t* src = op ? big : small;
    uint32_t* dst = op ? leaf_g : leaf_s;
    const int D = r.depth, k = r.k, w = r.h[k - 1], G = r.group;
    const long long p3D = pow3(D);
    const long long nodes = r.rows0 * p3D;
    const long long groups = (nodes + G - 1) / G;
    const int node_len = D == 0 ? 2 * r.h[0] : r.h[D - 1];
    uint32_t* const bufA = sh;
    uint32_t* const bufB = sh + (long long)G * buf_words;

    for (long long gi = blockIdx.x; gi < groups; gi += gridDim.x) {
        const long long n0 = gi * G;
        const int ng = (int)min((long long)G, nodes - n0);
        __syncthreads();  // the previous group's tables and buffers are done with
        if (D == 0) {
            for (int g = threadIdx.x; g < ng; g += blockDim.x) {
                const long long r0 = n0 + g, b = r0 / r.n;
                const int j = (int)(r0 - b * r.n);
                base[g] = op == 0 ? b * r.Ls : b * r.Lg + (r.chunked ? (long long)j * r.Ls : 0);
                wid0[g] = op == 0 ? r.Ls : (r.chunked ? min(r.Ls, r.Lg - j * r.Ls) : r.Lg);
            }
        } else if (threadIdx.x == 0) {
            const long long r0 = n0 % r.rows0, pv = n0 / r.rows0, b = r0 / r.n;
            const int j = (int)(r0 - b * r.n);
            node_r0 = r0;
            node_pv = pv;
            base[0] = op == 0 ? b * r.Ls : b * r.Lg + (r.chunked ? (long long)j * r.Ls : 0);
            width[0] = op == 0 ? r.Ls : (r.chunked ? min(r.Ls, r.Lg - j * r.Ls) : r.Lg);
            long long v = pv;
            for (int i = 0; i < D; ++i) {
                const int t = (int)(v % 3), hh = r.h[i], W = width[i];
                v /= 3;
                digit[i] = t;
                width[i + 1] = t == 1 ? max(0, min(W - hh, hh)) : min(W, hh);
            }
        }
        __syncthreads();
        // stage each node: at D = 0 its row (zeros past the real width), else
        // each limb the XOR of the row's limbs its path reaches
        if (D == 0) {
#pragma unroll 4
            for (int idx = threadIdx.x; idx < ng * node_len; idx += blockDim.x) {
                const int g = idx / node_len, p = idx - g * node_len;
                bufA[g * buf_words + p] = p < wid0[g] ? __ldg(src + base[g] + p) : 0u;
            }
        } else {
            unsigned twos = 0, ones = 0;
            for (int i = 0; i < D; ++i) {
                twos |= (unsigned)(digit[i] == 2) << i;
                ones |= (unsigned)(digit[i] == 1) << i;
            }
            const uint32_t* row = src + base[0];
            uint32_t* node_out = D < k ? bufA : dst + (node_r0 + r.rows0 * node_pv) * w;
            for (int p = threadIdx.x; p < node_len; p += blockDim.x) {
                uint32_t acc = 0u;
                for (unsigned s = twos;; s = (s - 1) & twos) {
                    const unsigned take = ones | s;  // levels whose x1 half the term reads
                    long long pos = p;
                    bool real = true;
                    for (int i = D - 1; i >= 0; --i) {
                        if ((take >> i) & 1u) pos += r.h[i];
                        if (pos >= width[i]) {
                            real = false;
                            break;
                        }
                    }
                    if (real) acc ^= __ldg(row + pos);
                    if (s == 0) break;
                }
                node_out[p] = acc;
            }
            if (D == k) continue;
        }
        __syncthreads();
        // split level by level: cur holds, for each node, M parents of len limbs
        uint32_t* cur = bufA;
        uint32_t* nxt = bufB;
        int M = 1, len = node_len;
        for (int i = D; i < k; ++i) {
            const int hh = r.h[i], per = M * hh;  // parent limbs (q, p) a node
            if (i < k - 1) {
                for (int idx = threadIdx.x; idx < ng * per; idx += blockDim.x) {
                    const int g = idx / per, rem = idx - g * per;
                    const int q = rem / hh, p = rem - q * hh;
                    const uint32_t* par = cur + g * buf_words + q * len;
                    const uint32_t x0 = par[p], x1 = hh + p < len ? par[hh + p] : 0u;
                    uint32_t* o = nxt + g * buf_words + rem;
                    o[0] = x0;
                    o[per] = x1;
                    o[2 * per] = x0 ^ x1;
                }
                __syncthreads();
                uint32_t* tmp = cur;
                cur = nxt;
                nxt = tmp;
                M *= 3;
                len = hh;
            } else {
                // the last level: leaf row r0 + rows0 (pv + 3^D (t M + q))
                const long long step = r.rows0 * p3D * M;
                for (int idx = threadIdx.x; idx < ng * per; idx += blockDim.x) {
                    const int g = idx / per, rem = idx - g * per;
                    const int q = rem / hh, p = rem - q * hh;
                    const uint32_t* par = cur + g * buf_words + q * len;
                    const uint32_t x0 = par[p], x1 = hh + p < len ? par[hh + p] : 0u;
                    const long long lead = (D == 0 ? n0 + g : node_r0) +
                                           r.rows0 * ((D == 0 ? 0 : node_pv) + p3D * q);
                    dst[lead * w + p] = x0;
                    dst[(lead + step) * w + p] = x1;
                    dst[(lead + 2 * step) * w + p] = x0 ^ x1;
                }
            }
        }
    }
}

// ---------------------------------------------------------------- R2 --------

// limbs s, s+h, s+2h and s+3h (those below lo) of a node's product from its
// children's products p0, p2, pm (2h limbs each), s < h
__device__ __forceinline__ void join4(const uint32_t* p0, const uint32_t* p2, const uint32_t* pm,
                                      int h, int s, int lo, uint32_t* out) {
    const uint32_t a0 = p0[s], a1 = p0[s + h], b0 = p2[s], b1 = p2[s + h];
    const uint32_t m0 = a0 ^ b0 ^ pm[s], m1 = a1 ^ b1 ^ pm[s + h];
    out[s] = a0;
    out[s + h] = a1 ^ m0;
    if (s + 2 * h < lo) out[s + 2 * h] = m1 ^ b0;
    if (s + 3 * h < lo) out[s + 3 * h] = b1;
}

// Element-wise launches walk tiles of at most TILE units: G whole rows of
// `units` when units < TILE, else one row's TILE-unit slice.
struct Tiles {
    long long rows;
    int units, G, per_row;
    __host__ __device__ long long count() const { return (rows + G - 1) / G * per_row; }
};

Tiles make_tiles(long long rows, int units) {
    Tiles t;
    t.rows = rows;
    t.units = units;
    t.G = units < TILE ? TILE / units : 1;
    t.per_row = (units + TILE - 1) / TILE;
    return t;
}

// one split level: in [3R, 2h] (p0 rows, then p2, then pm) -> out [R, lo];
// a unit is (row, s), s < h
__global__ void __launch_bounds__(THREADS)
route_join_level_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                        const Tiles tl, int h, int lo) {
    const long long R = tl.rows, n_tiles = tl.count(), w2 = 2LL * h;
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const long long rg = tile / tl.per_row;
        const int c0 = (int)(tile - rg * tl.per_row) * TILE;
        const long long r_lo = rg * tl.G;
        const int nr = (int)min((long long)tl.G, R - r_lo), nc = min(TILE, tl.units - c0);
#pragma unroll 4
        for (int e = threadIdx.x; e < nr * nc; e += blockDim.x) {
            const int rr = e / nc, s = c0 + e - rr * nc;
            const long long row = r_lo + rr;
            join4(in + row * w2, in + (row + R) * w2, in + (row + 2 * R) * w2, h, s, lo,
                  out + row * lo);
        }
    }
}

// the chunk step: in [B n, 2 Ls] -> out [B, Ls + Lg]; a unit is one limb
__global__ void __launch_bounds__(THREADS)
route_join_pieces_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                         const Tiles tl, int Ls, int n) {
    const long long n_tiles = tl.count();
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const long long rg = tile / tl.per_row;
        const int c0 = (int)(tile - rg * tl.per_row) * TILE;
        const long long r_lo = rg * tl.G;
        const int nr = (int)min((long long)tl.G, tl.rows - r_lo), nc = min(TILE, tl.units - c0);
#pragma unroll 4
        for (int e = threadIdx.x; e < nr * nc; e += blockDim.x) {
            const int rr = e / nc, t = c0 + e - rr * nc;
            const long long b = r_lo + rr;
            const int j = t / Ls, q = t - j * Ls;
            const uint32_t* pieces = in + b * n * 2LL * Ls;
            uint32_t v = j < n ? pieces[(long long)j * 2 * Ls + q] : 0u;
            if (j >= 1) v ^= pieces[(long long)(j - 1) * 2 * Ls + Ls + q];
            out[b * tl.units + t] = v;
        }
    }
}

// bufA[g][s][c] <- in[(n0 + g + R s) * w2 + c] for g < ng, s < S, c < w2, in
// words of V (uint4 where rows are whole 16-byte words): four loads in
// flight a thread before their stores, so the gather is not latency-bound
template <typename V>
__device__ __forceinline__ void gather_subtrees(const uint32_t* __restrict__ in, uint32_t* bufA,
                                                long long n0, int ng, long long R, int S, int w2,
                                                int bufA_words) {
    constexpr int E = sizeof(V) / 4;
    const int wv = w2 / E, per = S * wv, total = ng * per;
    const V* src = reinterpret_cast<const V*>(in);
    for (int i0 = threadIdx.x; i0 < total; i0 += 4 * blockDim.x) {
        V v[4];
        int dst[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int idx = i0 + u * blockDim.x;
            dst[u] = -1;
            if (idx < total) {
                const int g = idx / per, rem = idx - g * per;
                const int s = rem / wv, c = rem - s * wv;
                v[u] = src[(n0 + g + R * s) * wv + c];
                dst[u] = g * (bufA_words / E) + rem;
            }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (dst[u] >= 0) reinterpret_cast<V*>(bufA)[dst[u]] = v[u];
    }
}

// split levels top..bottom in one launch: a block takes G nodes of depth
// top at once; for each it gathers the 3^m products below it (rows r + R s,
// s = t_top + 3 t_(top+1) + ..., each 2 h[bottom] limbs), joins m levels in
// shared memory (A then B then A ...) and writes its product, lo[top] limbs
__global__ void __launch_bounds__(THREADS)
route_join_fused_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                        const Route r, int top, int bottom, int bufA_words, int bufB_words,
                        int G, int vec) {
    extern __shared__ __align__(16) uint32_t sh[];
    const long long R = r.rows0 * pow3(top);  // nodes of depth top
    const long long groups = (R + G - 1) / G;
    int S = 1;
    for (int i = top; i <= bottom; ++i) S *= 3;
    const int w2 = 2 * r.h[bottom];
    uint32_t* const bufA = sh;
    uint32_t* const bufB = sh + (long long)G * bufA_words;
    for (long long gi = blockIdx.x; gi < groups; gi += gridDim.x) {
        const long long n0 = gi * G;
        const int ng = (int)min((long long)G, R - n0);
        __syncthreads();  // the previous group's buffers are done with
        if (vec)
            gather_subtrees<uint4>(in, bufA, n0, ng, R, S, w2, bufA_words);
        else
            gather_subtrees<uint32_t>(in, bufA, n0, ng, R, S, w2, bufA_words);
        __syncthreads();
        uint32_t* cur = bufA;
        uint32_t* nxt = bufB;
        int cur_stride = bufA_words, nxt_stride = bufB_words;
        int M = S / 3;  // output nodes of the level, per node of depth top
        for (int lvl = bottom; lvl >= top; --lvl) {
            const int h = r.h[lvl], wi = 2 * h, lo = r.lo[lvl], units = M * h;
            for (int idx = threadIdx.x; idx < ng * units; idx += blockDim.x) {
                const int g = idx / units, rem = idx - g * units;
                const int q = rem / h, s = rem - q * h;
                const uint32_t* c = cur + g * cur_stride;
                uint32_t* o = lvl == top ? out + (n0 + g) * lo : nxt + g * nxt_stride + q * lo;
                join4(c + q * wi, c + (M + q) * wi, c + (2 * M + q) * wi, h, s, lo, o);
            }
            if (lvl == top) break;
            __syncthreads();
            uint32_t* tmp = cur;
            cur = nxt;
            nxt = tmp;
            const int ts = cur_stride;
            cur_stride = nxt_stride;
            nxt_stride = ts;
            M /= 3;
        }
    }
}

int set_smem(const void* kernel, long long words) {
    const long long bytes = words * 4;
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
}

unsigned int grid_for(long long work) {
    const long long cap = (long long)H100_SMS * BLOCKS_PER_SM;
    return (unsigned int)(work < cap ? (work > 0 ? work : 1) : cap);
}

// nodes a block takes at once: enough for GROUP_WORK limbs of work, within
// the shared memory and MAX_GROUP, leaving two groups an SM where there are
long long group_for(long long nodes, long long work, long long words, long long budget) {
    long long G = (GROUP_WORK + work - 1) / work;
    if (G > budget / words) G = budget / words;
    if (G > MAX_GROUP) G = MAX_GROUP;
    if (G > nodes / (2 * H100_SMS)) G = nodes / (2 * H100_SMS);
    return G < 1 ? 1 : G;
}

}  // namespace

// R1: small [B, Ls], big [B, Lg] -> leaf_s, leaf_g [B n 3^k, h[k-1]] each, in
// the leaf order above.  plan: see read_route.  Returns a cudaError (0 on
// success).
extern "C" int hm_route_split(const void* small, const void* big, void* leaf_s, void* leaf_g,
                              const long long* plan, void* stream) {
    Route r;
    int err = read_route(plan, &r);
    if (err) return err;
    int D = 0;
    while (D < r.k && 2 * split_buffer_words(r, D) > SPLIT_SMEM_WORDS) ++D;
    while (D < r.k && r.rows0 * pow3(D) < 2 * H100_SMS) ++D;
    r.depth = D;
    const long long buf = D < r.k ? split_buffer_words(r, D) : 0;
    if (D == 0)
        r.group = (int)group_for(r.rows0, pow3(r.k) * r.h[r.k - 1], 2 * buf, SPLIT_SMEM_WORDS);
    const long long smem = 2 * r.group * buf;
    err = set_smem((const void*)route_split_kernel, smem);
    if (err) return err;
    const long long nodes = r.rows0 * pow3(D);
    const dim3 grid(grid_for((nodes + r.group - 1) / r.group), 2);
    route_split_kernel<<<grid, THREADS, (size_t)smem * 4, (cudaStream_t)stream>>>(
        (const uint32_t*)small, (const uint32_t*)big, (uint32_t*)leaf_s, (uint32_t*)leaf_g, r,
        (int)buf);
    return (int)cudaGetLastError();
}

// R2, one launch: top < 0 joins the chunk step's pieces (in [B n, 2 Ls] ->
// out [B, Ls + Lg]); else split levels top..bottom (0-based, top <= bottom):
// in holds the products of level bottom's children [B n 3^(bottom+1),
// 2 h[bottom]], out gets level top's [B n 3^top, lo[top]].  More than one
// level runs fused and must fit JOIN_SMEM_WORDS.  Returns a cudaError.
extern "C" int hm_route_join(const void* in, void* out, const long long* plan, int top,
                             int bottom, void* stream) {
    Route r;
    int err = read_route(plan, &r);
    if (err) return err;
    const cudaStream_t st = (cudaStream_t)stream;
    if (top < 0) {
        if (!r.chunked) return (int)cudaErrorInvalidValue;
        const Tiles tl = make_tiles(r.B, r.Ls + r.Lg);
        route_join_pieces_kernel<<<grid_for(tl.count()), THREADS, 0, st>>>(
            (const uint32_t*)in, (uint32_t*)out, tl, r.Ls, r.n);
        return (int)cudaGetLastError();
    }
    if (bottom < top || bottom >= r.k) return (int)cudaErrorInvalidValue;
    if (top == bottom) {
        const Tiles tl = make_tiles(r.rows0 * pow3(top), r.h[top]);
        route_join_level_kernel<<<grid_for(tl.count()), THREADS, 0, st>>>(
            (const uint32_t*)in, (uint32_t*)out, tl, r.h[top], r.lo[top]);
        return (int)cudaGetLastError();
    }
    const int m = bottom - top + 1;
    const long long bufA = pow3(m) * 2 * r.h[bottom];
    const long long bufB = pow3(m - 1) * r.lo[bottom];
    if (bufA + bufB > JOIN_SMEM_WORDS) return (int)cudaErrorInvalidValue;
    const long long R = r.rows0 * pow3(top);
    const long long G = group_for(R, bufA, bufA + bufB, JOIN_SMEM_WORDS);
    const long long smem = G * (bufA + bufB);
    err = set_smem((const void*)route_join_fused_kernel, smem);
    if (err) return err;
    // rows of whole 16-byte words from a 16-byte aligned start: uint4 loads
    const int vec = r.h[bottom] % 2 == 0 && ((uintptr_t)in & 15) == 0;
    route_join_fused_kernel<<<grid_for((R + G - 1) / G), THREADS, (size_t)smem * 4, st>>>(
        (const uint32_t*)in, (uint32_t*)out, r, top, bottom, (int)bufA, (int)bufB, (int)G, vec);
    return (int)cudaGetLastError();
}
