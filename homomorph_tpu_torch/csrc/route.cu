// R1 and R2: the split and the join of the clmul dispatcher's Karatsuba
// route (homomorph_tpu_torch/gf2/kernels.py::clmul_rows), around ONE K1
// launch (csrc/clmul.cu).
//
// Replaces the route's glue of the JAX package: the pads, slices and XORs of
// homomorph_tpu/gf2/kernels.py::_karatsuba_flat (:356-387) and of the chunk
// branch of _clmul_flat (:212-225).  Those are XLA ops that jax.jit fuses;
// there is no Pallas kernel.
//
// The route (kernels.py::route_plan): at most one chunk step, which cuts the
// wider operand into n pieces of Ls limbs (the smaller operand repeats for
// each), then k split steps; split level i halves every row at h[i] into its
// x0, its x1 (padded to h[i]) and x0 ^ x1.  The leaves are node-major, the
// order in which _karatsuba_flat recurses:
//
//   leaf = r0 3^k + t_1 3^(k-1) + ... + t_k,   r0 = b * n + j,
//
// t_i in {0: x0, 1: x1, 2: x0 ^ x1} the digit of split level i, so the
// leaves under any node (r0 and its first D digits) are one run of 3^(k-D)
// rows.  The K1 launch takes the leaves of both operands, [rows0 3^k, w]
// each (rows0 = B n, w = h[k-1]), and gives their products, [rows0 3^k, 2w].
//
// The launch plans and their shared-memory layouts are made by the wrapper
// (kernels.py::split_plan, split_layout, join_launches, ascent_layout) and
// passed by value; the entries here check only that every region of a
// layout lies inside the block's shared memory and that the whole fits the
// card.  The route's table (B, widths, n, h[], lo[]) reaches the kernels as
// a struct argument too, never through device memory: a CUDA graph captures
// a routed product.
//
// R1 (hm_route_split): the whole descent in one launch, both operands.  A
// block takes G nodes of depth D at once (G > 1 only at D = 0), stages them
// in shared memory, splits them level by level there, and
// writes the last level's children straight to the leaves: the nodes'
// leaves are one run, written with 16-byte stores where w % 4 == 0.  A
// thread takes one limb (or four) of a parent and writes its x0, x1 and
// x0 ^ x1.  Threads walk fixed stripes of (parent, limb) with 32-bit offsets
// inside a block's run and one 64-bit base a run; no loop divides.  Staging
// at D > 0 reads the original row: limb p of the node is the XOR of at most
// 2^(number of 2 digits) terms row[p + off] read for p < lim, one term a
// choice of halves for the 2 digits.  lim is the padding hazard: x1 padded
// to h, an odd width, the smaller operand padded to the wider at the first
// split, a last chunk piece narrower than Ls.  A limb past a node's real
// width is zero, but p + off can land on a real limb of the neighbouring
// half or row, so lim is the least, over the levels above the node, of the
// real width there (W' = min(W, h) for x0 and x0 ^ x1, clamp(W - h, 0, h)
// for x1) less the offset still to add below it.  Inside shared memory the
// zeros are stored, so the levels below D need no widths.  The layout holds
// each level's input (the staged nodes, then the children of each level),
// the nodes' row starts and the terms' (off, lim).
//
// R2 (hm_route_join): the ascent.  Split level i turns the products of a
// node's three children, p0 (t = 0), p2 (t = 1) and pm (t = 2), each 2 h[i]
// limbs, into the node's product:
//
//   out[t] = p0[t] ^ p0[t-h] ^ pm[t-h] ^ p2[t-h] ^ p2[t-2h],  t < lo[i],
//
// each term zero outside its row (lo[i] = Ls + Lg of that level, <= 4h).  A
// thread takes s < h and writes t = s, s+h, s+2h, s+3h from six loads.  The
// chunk step adds piece j at limb j Ls:
//
//   out[t] = piece[t/Ls][t%Ls] ^ piece[t/Ls - 1][Ls + t%Ls].
//
// The ascent is one launch: a block takes a node of depth `top` and streams
// its leaf products, one run, in tiles of 3^tile products: TMA bulk copies
// (cp.async.bulk) into a ring of RING slots under mbarriers, the next tile's
// copy in flight while a tile is joined.  The tile's levels are joined in
// shared memory, then its product goes up: each level from the tile's root
// up to `top` keeps one product in shared memory, to which each child adds
// its terms as it comes (p0 at shifts 0 and h, p2 at h and 2h, pm at h;
// child 0 starts it), and a product whose third child is in goes up in
// turn; the node's product, once complete, is stored to its row.  Where a
// tile is a node's whole subtree, a block takes up to a tile's worth of
// nodes at once, one run too.  No level between the leaves and `top`
// passes through device memory.  The levels above `top` are one
// element-wise launch each, and the chunk step one more.  The layout holds
// the ring's slots, each tile level's output and each level's product above
// the tile.  A tile's join is a block barrier a level, so the ascent's time
// goes to those barriers more than to its bytes.

// Bound on the H100: bytes.  R1 reads each original row once and writes each
// leaf row once; the staging's re-reads of a row (2^D terms at most) come
// from L2.  R2 reads the leaves' products once and writes the product once,
// plus, above `top`, each level's products once more.  Offsets are 64-bit
// where rows pass 2^31 words: the u64 product's leaves are [12,754,584, 32]
// per operand and its leaf products pass 2^31 bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 32;
constexpr int THREADS = 256;
// R2's ascent: slots of its ring (kernels.py::ascent_layout allots them);
// a deeper ring measured no faster (PERF.md, section 6)
constexpr int RING = 2;
constexpr int H100_SMS = 132;  // the grid's target; any card is correct
constexpr int TILE = 2048;     // units a block takes at once in R2's element-wise launches

struct Route {
    long long B;      // rows of the operands
    long long rows0;  // rows after the chunk step: B * n
    int Ls, Lg;       // the operands' widths, Ls <= Lg
    int n;            // pieces of the chunk step (1 without one)
    int chunked;      // 1 if the route starts with a chunk step
    int k;            // split levels, 1 <= k <= MAX_LEVELS
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
    if (r->B < 1 || r->Ls < 1 || r->Lg < r->Ls || r->k < 1 || r->k > MAX_LEVELS)
        return (int)cudaErrorInvalidValue;
    if (r->chunked && (long long)r->n * r->Ls < r->Lg) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < r->k; ++i) {
        r->h[i] = (int)w[5 + i];
        r->lo[i] = (int)w[5 + r->k + i];
        const long long parent = i == 0 ? (r->chunked ? r->Ls : r->Lg) : r->h[i - 1];
        if (r->h[i] < 1 || 2LL * r->h[i] < parent || r->lo[i] > 4LL * r->h[i] ||
            r->lo[i] < 2LL * r->h[i] || (i > 0 && r->lo[i] != 2LL * r->h[i - 1]))
            return (int)cudaErrorInvalidValue;
    }
    return 0;
}

__host__ __device__ long long pow3(int e) {
    long long p = 1;
    while (e-- > 0) p *= 3;
    return p;
}

// q = a / b and r = a % b for 0 <= a < 2^22 and b >= 1: a float reciprocal
// is off by at most one, which one step corrects (an integer division
// costs tens of instructions, more than a level's work for most threads)
__device__ __forceinline__ void divmod(int a, int b, int& q, int& r) {
    q = (int)((float)a * __frcp_rn((float)b));
    r = a - q * b;
    if (r < 0) {
        --q;
        r += b;
    } else if (r >= b) {
        ++q;
        r -= b;
    }
}

// A thread's walk over the units (q, p), p < P, of a block: unit q P + p
// for first, first + step, ... (first, step < 2^22)
struct Stripe {
    int q, p, dq, dp;
    const int P;
    __device__ Stripe(int P_, int first, int step) : P(P_) {
        divmod(first, P_, q, p);
        divmod(step, P_, dq, dp);
    }
    __device__ void next() {
        q += dq;
        p += dp;
        if (p >= P) {
            p -= P;
            ++q;
        }
    }
};

// 1 or 4 limbs as one value: uint32_t or uint4
template <int V> struct Vec;
template <> struct Vec<1> {
    using T = uint32_t;
    __device__ static T zero() { return 0u; }
};
template <> struct Vec<4> {
    using T = uint4;
    __device__ static T zero() { return make_uint4(0u, 0u, 0u, 0u); }
};
__device__ __forceinline__ uint4 operator^(uint4 a, uint4 b) {
    return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}
template <int V> __device__ __forceinline__ typename Vec<V>::T ld(const uint32_t* p) {
    return *reinterpret_cast<const typename Vec<V>::T*>(p);
}
template <int V> __device__ __forceinline__ void st(uint32_t* p, typename Vec<V>::T v) {
    *reinterpret_cast<typename Vec<V>::T*>(p) = v;
}

// row[p .. p+V-1], each limb at or past lim read as zero
template <int V>
__device__ __forceinline__ typename Vec<V>::T ld_below(const uint32_t* row, int p, int lim) {
    if (p + V <= lim) return ld<V>(row + p);
    typename Vec<V>::T v = Vec<V>::zero();
    uint32_t* e = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int i = 0; i < V; ++i)
        if (p + i < lim) e[i] = row[p + i];
    return v;
}

// ---------------------------------------------------------------- R1 --------

struct Split {
    int depth, group;    // the wrapper's split_plan
    int in[MAX_LEVELS];  // offset (words) of the input of split level i >= depth
    int base;            // the nodes' row starts: `group` long longs
    int off, lim, cap;   // the staging terms' offsets and limits: `cap` ints each
    int words;           // all of it
    int vec_rows;        // stage with 16-byte loads
    int vec_leaves;      // write the leaves with 16-byte stores
};

// one split level: P parents of 2 hh limbs (cur) -> 3P children of cs
// limbs (nxt, a block's run), child 3q + t of parent q; a child's limbs
// past hh (cs = hh + 1 for an odd hh) are zero
template <int V>
__device__ __forceinline__ void split_level(const uint32_t* cur, uint32_t* nxt, int P, int hh,
                                            int cs) {
    using T = typename Vec<V>::T;
    for (Stripe s(cs / V, threadIdx.x, blockDim.x); s.q < P; s.next()) {
        const int p = s.p * V;
        const uint32_t* par = cur + s.q * 2 * hh;
        T x0 = Vec<V>::zero(), x1 = Vec<V>::zero();
        if (p < hh) {
            x0 = ld<V>(par + p);
            x1 = ld<V>(par + hh + p);
        }
        uint32_t* o = nxt + 3 * s.q * cs + p;
        st<V>(o, x0);
        st<V>(o + cs, x1);
        st<V>(o + 2 * cs, x0 ^ x1);
    }
}

// stage ng nodes of len limbs into dst (node g at g len): node g's limbs
// are the XOR of its terms, term e the row base[g or 0] from off[e], its
// limbs p < lim[e]; term g alone at depth 0, all nterms of the one node else
template <int V>
__device__ __forceinline__ void stage_nodes(const uint32_t* src, uint32_t* dst, int ng, int len,
                                            const long long* base, const int* off, const int* lim,
                                            int nterms, bool depth0) {
    using T = typename Vec<V>::T;
    for (Stripe s(len / V, threadIdx.x, blockDim.x); s.q < ng; s.next()) {
        const int g = s.q, p = s.p * V;
        const uint32_t* row = src + base[depth0 ? g : 0];
        T acc = Vec<V>::zero();
        for (int e = depth0 ? g : 0, end = depth0 ? g + 1 : nterms; e < end; ++e)
            acc = acc ^ ld_below<V>(row + off[e], p, lim[e]);
        st<V>(dst + g * len + p, acc);
    }
}

__global__ void __launch_bounds__(THREADS)
route_split_kernel(const uint32_t* __restrict__ small, const uint32_t* __restrict__ big,
                   uint32_t* __restrict__ leaf_s, uint32_t* __restrict__ leaf_g, const Route r,
                   const Split sp) {
    extern __shared__ __align__(16) uint32_t sh[];
    __shared__ int nterms;
    long long* const base = reinterpret_cast<long long*>(sh + sp.base);  // node rows' starts
    int* const off = reinterpret_cast<int*>(sh + sp.off);
    int* const lim = reinterpret_cast<int*>(sh + sp.lim);
    const int op = blockIdx.y;  // 0: the smaller operand, 1: the wider
    const uint32_t* src = op ? big : small;
    uint32_t* dst = op ? leaf_g : leaf_s;
    const int D = sp.depth, k = r.k, w = r.h[k - 1], G = sp.group;
    const long long p3D = pow3(D), nodes = r.rows0 * p3D, groups = (nodes + G - 1) / G;
    const long long leaves = pow3(k - D);  // a node's leaves
    const int len = D < k ? 2 * r.h[D] : w;  // a staged node's limbs

    for (long long gi = blockIdx.x; gi < groups; gi += gridDim.x) {
        const long long n0 = gi * G;
        const int ng = (int)min((long long)G, nodes - n0);
        __syncthreads();  // the previous group's tables and buffers are done with
        if (D == 0) {
            for (int g = threadIdx.x; g < ng; g += blockDim.x) {
                const long long r0 = n0 + g, b = r0 / r.n;
                const int j = (int)(r0 - b * r.n);
                base[g] = op == 0 ? b * r.Ls : b * r.Lg + (r.chunked ? (long long)j * r.Ls : 0);
                off[g] = 0;
                lim[g] = op == 0 ? r.Ls : (r.chunked ? min(r.Ls, r.Lg - j * r.Ls) : r.Lg);
            }
        } else if (threadIdx.x == 0) {
            const long long r0 = n0 / p3D, b = r0 / r.n;
            const int j = (int)(r0 - b * r.n);
            long long v = n0 - r0 * p3D;
            int digit[MAX_LEVELS], width[MAX_LEVELS + 1];
            for (int i = D - 1; i >= 0; --i) {
                digit[i] = (int)(v % 3);
                v /= 3;
            }
            base[0] = op == 0 ? b * r.Ls : b * r.Lg + (r.chunked ? (long long)j * r.Ls : 0);
            width[0] = op == 0 ? r.Ls : (r.chunked ? min(r.Ls, r.Lg - j * r.Ls) : r.Lg);
            unsigned twos = 0, ones = 0;
            for (int i = 0; i < D; ++i) {
                const int hh = r.h[i], W = width[i];
                width[i + 1] = digit[i] == 1 ? max(0, min(W - hh, hh)) : min(W, hh);
                twos |= (unsigned)(digit[i] == 2) << i;
                ones |= (unsigned)(digit[i] == 1) << i;
            }
            int count = 0;
            for (unsigned s = twos;; s = (s - 1) & twos) {
                const unsigned take = ones | s;  // levels whose x1 half the term reads
                int o = 0, l = width[D];
                for (int i = D - 1; i >= 0; --i) {
                    if ((take >> i) & 1u) o += r.h[i];
                    l = min(l, width[i] - o);
                }
                off[count] = o;
                lim[count] = l;
                ++count;
                if (s == 0) break;
            }
            nterms = count;
        }
        __syncthreads();
        // stage each node, or at D = k write each leaf straight from the row
        uint32_t* staged = D < k ? sh + sp.in[D] : dst + n0 * (long long)w;
        if (sp.vec_rows)
            stage_nodes<4>(src, staged, ng, len, base, off, lim, nterms, D == 0);
        else
            stage_nodes<1>(src, staged, ng, len, base, off, lim, nterms, D == 0);
        if (D == k) continue;
        __syncthreads();
        // split level by level: level i's input holds P parents of 2 h[i] limbs
        int P = ng;
        for (int i = D; i < k; ++i, P *= 3) {
            const int hh = r.h[i];
            const bool last = i == k - 1;
            // the last level writes the nodes' leaves, one run of ng 3^(k-D) rows
            uint32_t* o = last ? dst + n0 * leaves * w : sh + sp.in[i + 1];
            const int cs = last ? w : 2 * r.h[i + 1];
            if (hh % 4 == 0 && (!last || sp.vec_leaves))
                split_level<4>(sh + sp.in[i], o, P, hh, cs);
            else
                split_level<1>(sh + sp.in[i], o, P, hh, cs);
            if (last) break;
            __syncthreads();
        }
    }
}

// ---------------------------------------------------------------- R2 --------

// limbs s .. s+V-1, s+h .., s+2h .. and s+3h .. (those below lo) of a node's
// product from its children's products p0, p2, pm (2h limbs each), s < h
template <int V>
__device__ __forceinline__ void join4(const uint32_t* p0, const uint32_t* p2, const uint32_t* pm,
                                      int h, int s, int lo, uint32_t* out) {
    using T = typename Vec<V>::T;
    const T a0 = ld<V>(p0 + s), a1 = ld<V>(p0 + s + h), b0 = ld<V>(p2 + s), b1 = ld<V>(p2 + s + h);
    const T m0 = a0 ^ b0 ^ ld<V>(pm + s), m1 = a1 ^ b1 ^ ld<V>(pm + s + h);
    st<V>(out + s, a0);
    st<V>(out + s + h, a1 ^ m0);
    if (s + 2 * h < lo) st<V>(out + s + 2 * h, m1 ^ b0);
    if (s + 3 * h < lo) st<V>(out + s + 3 * h, b1);
}

// M nodes' products (lo limbs each, at o + q lo) from their children's
// (2h limbs each, child 3q + t at c + (3q + t) 2h)
template <int V>
__device__ __forceinline__ void join_nodes(const uint32_t* c, uint32_t* o, int M, int h, int lo) {
    for (Stripe s(h / V, threadIdx.x, blockDim.x); s.q < M; s.next()) {
        const uint32_t* p0 = c + 6 * s.q * h;
        join4<V>(p0, p0 + 2 * h, p0 + 4 * h, h, s.p * V, lo, o + s.q * lo);
    }
}

// child t (0: p0, 1: p2, 2: pm; 2h limbs) of a node into the node's product
// (lo limbs): p0 at shifts 0 and h, p2 at h and 2h, pm at h; child 0 starts
// it.  A thread owns limbs s, s+h, s+2h and s+3h of the product.
template <int V>
__device__ __forceinline__ void accumulate(const uint32_t* c, uint32_t* acc, int t, int h,
                                           int lo) {
    using T = typename Vec<V>::T;
    for (int s = threadIdx.x * V; s < h; s += blockDim.x * V) {
        const T a = ld<V>(c + s), b = ld<V>(c + s + h);
        const bool third = s + 2 * h < lo, fourth = s + 3 * h < lo;
        if (t == 0) {
            st<V>(acc + s, a);
            st<V>(acc + s + h, a ^ b);
            if (third) st<V>(acc + s + 2 * h, b);
            if (fourth) st<V>(acc + s + 3 * h, Vec<V>::zero());
        } else if (t == 1) {
            st<V>(acc + s + h, ld<V>(acc + s + h) ^ a);
            if (third) st<V>(acc + s + 2 * h, ld<V>(acc + s + 2 * h) ^ a ^ b);
            if (fourth) st<V>(acc + s + 3 * h, ld<V>(acc + s + 3 * h) ^ b);
        } else {
            st<V>(acc + s + h, ld<V>(acc + s + h) ^ a);
            if (third) st<V>(acc + s + 2 * h, ld<V>(acc + s + 2 * h) ^ b);
        }
    }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// one tile's bulk copy into the ring, completing the barrier's phase
__device__ __forceinline__ void bulk_load(uint32_t* dst, const uint32_t* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
            "r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n\t.reg .pred done;\n"
        "WAIT:\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
        "@!done bra WAIT;\n}" ::"r"(smem_addr(bar)),
        "r"(parity)
        : "memory");
}

struct Ascent {
    int top, tile;          // the wrapper's join_launches
    int group;              // nodes a block takes at once (1 unless a tile is a node)
    long long tiles;        // tiles a node: 3^(k - top - tile)
    int tile_words, slot;   // a node's tile's words (3^tile 2w), a ring slot's
    int lvl[MAX_LEVELS];    // offset (words) of each tile level's output (bottom .. k-1)
    int acc[MAX_LEVELS];    // offset of each level's product from top to the tile
    int words;              // all of it
    int bulk;               // TMA bulk copies (even w, 16-byte aligned input)
    int vec_out;            // 16-byte aligned output
};

// the ascent: a block takes `group` nodes of depth top (out rows g0 ..), tile
// after tile
__global__ void __launch_bounds__(THREADS)
route_join_ascent_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                         const Route r, const Ascent a) {
    extern __shared__ __align__(16) uint32_t sh[];
    __shared__ __align__(8) uint64_t full[RING];
    const int k = r.k, top = a.top, bottom = k - a.tile;  // the tile's root depth
    const int lo_top = r.lo[top], G = a.group;
    const long long nodes = r.rows0 * pow3(top), groups = (nodes + G - 1) / G;
    const bool row_vec = a.vec_out && lo_top % 4 == 0;
    const int M0 = (int)pow3(a.tile - 1);  // a node's products at the tile's first level
    // thread 0's next copy: tile n_next of group g_next (one run of its nodes)
    long long g_next = blockIdx.x;
    long long n_next = 0;
    auto issue = [&](int stage) {
        if (g_next < groups) {
            const long long g0 = g_next * G, ng = min((long long)G, nodes - g0);
            bulk_load(sh + stage * a.slot, in + (g0 * a.tiles + n_next) * a.tile_words,
                      (uint32_t)(ng * a.tile_words * 4), &full[stage]);
        }
        if (++n_next == a.tiles) {
            n_next = 0;
            g_next += gridDim.x;
        }
    };
    if (a.bulk && threadIdx.x == 0) {
        for (int s = 0; s < RING; ++s) mbar_init(&full[s]);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        for (int s = 0; s < RING; ++s) issue(s);
    }
    __syncthreads();
    int stage = 0;
    uint32_t parity = 0;
    for (long long gg = blockIdx.x; gg < groups; gg += gridDim.x) {
        const long long g0 = gg * G;
        const int ng = (int)min((long long)G, nodes - g0);
        uint32_t* const row = out + g0 * lo_top;
        for (long long n = 0; n < a.tiles; ++n) {
            uint32_t* const slot = sh + stage * a.slot;
            if (a.bulk) {
                mbar_wait(&full[stage], parity);
            } else {
                const uint32_t* src = in + (g0 * a.tiles + n) * a.tile_words;
                for (int e = threadIdx.x; e < ng * a.tile_words; e += blockDim.x) slot[e] = src[e];
                __syncthreads();
            }
            // the tile's levels, k-1 up to bottom, each into its buffer (into
            // the rows when bottom is top)
            const uint32_t* c = slot;
            int M = ng * M0;
            for (int j = k - 1; j >= bottom; --j, M /= 3) {
                const int h = r.h[j], lo = r.lo[j];
                const bool at_top = j == top;
                uint32_t* o = at_top ? row : sh + a.lvl[j];
                if (h % 4 == 0 && lo % 4 == 0 && (!at_top || row_vec))
                    join_nodes<4>(c, o, M, h, lo);
                else
                    join_nodes<1>(c, o, M, h, lo);
                __syncthreads();
                if (j == k - 1 && a.bulk && threadIdx.x == 0) issue(stage);
                c = o;
            }
            if (++stage == RING) {
                stage = 0;
                parity ^= 1u;
            }
            // its product up the levels above it while it is a third child
            // (one node a block here); the node's own product, complete, to
            // its row
            long long v = n;
            for (int i = bottom - 1; i >= top; --i) {
                const int t = (int)(v % 3), h = r.h[i], lo = r.lo[i];
                v /= 3;
                uint32_t* acc = sh + a.acc[i];
                if (h % 4 == 0 && lo % 4 == 0)
                    accumulate<4>(c, acc, t, h, lo);
                else
                    accumulate<1>(c, acc, t, h, lo);
                __syncthreads();
                if (t != 2) break;
                c = acc;
                if (i == top) {
                    if (row_vec)
                        for (int e = threadIdx.x * 4; e < lo_top; e += blockDim.x * 4)
                            st<4>(row + e, ld<4>(acc + e));
                    else
                        for (int e = threadIdx.x; e < lo_top; e += blockDim.x) row[e] = acc[e];
                }
            }
        }
    }
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

// one split level alone: in [3R, 2h] (node q's children at rows 3q, 3q+1,
// 3q+2) -> out [R, lo]; a unit is (node, s), s < h
template <int V>
__global__ void __launch_bounds__(THREADS)
route_join_level_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                        const Tiles tl, int h, int lo) {
    const long long n_tiles = tl.count();
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const long long rg = tile / tl.per_row;
        const int c0 = (int)(tile - rg * tl.per_row) * TILE;
        const long long r_lo = rg * tl.G;
        const int nr = (int)min((long long)tl.G, tl.rows - r_lo), nc = min(TILE, h - c0);
        const uint32_t* c = in + r_lo * 6 * h;
        uint32_t* o = out + r_lo * lo;
        for (Stripe s(nc / V, threadIdx.x, blockDim.x); s.q < nr; s.next()) {
            const uint32_t* p0 = c + 6 * s.q * h;
            join4<V>(p0, p0 + 2 * h, p0 + 4 * h, h, c0 + s.p * V, lo, o + s.q * lo);
        }
    }
}

// the chunk step: in [B n, 2 Ls] -> out [B, Ls + Lg].  The output row is
// n + 1 slots of Ls limbs (the last one cut at Ls + Lg); a unit is (slot
// row (b, j), q), q < Ls: out[b][j Ls + q] = piece j [q] ^ piece j-1 [Ls + q]
template <int V>
__global__ void __launch_bounds__(THREADS)
route_join_pieces_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                         const Tiles tl, int Ls, int Lg, int n) {
    using T = typename Vec<V>::T;
    const long long n_tiles = tl.count();
    const int Lo = Ls + Lg;
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const long long rg = tile / tl.per_row;
        const int c0 = (int)(tile - rg * tl.per_row) * TILE;
        const long long r_lo = rg * tl.G, b0 = r_lo / (n + 1);
        const int j0 = (int)(r_lo - b0 * (n + 1));
        const int nr = (int)min((long long)tl.G, tl.rows - r_lo), nc = min(TILE, Ls - c0);
        Stripe s(nc / V, threadIdx.x, blockDim.x);
        long long b = b0;
        int j = j0 + s.q;
        while (j > n) {
            j -= n + 1;
            ++b;
        }
        while (s.q < nr) {
            const int q = c0 + s.p * V, t = j * Ls + q;
            if (t < Lo) {
                const uint32_t* pieces = in + b * n * 2LL * Ls;
                T v = j < n ? ld<V>(pieces + (long long)j * 2 * Ls + q) : Vec<V>::zero();
                if (j >= 1) v = v ^ ld<V>(pieces + (long long)(j - 1) * 2 * Ls + Ls + q);
                st<V>(out + b * Lo + t, v);
            }
            const int q0 = s.q;
            s.next();
            j += s.q - q0;
            while (j > n) {
                j -= n + 1;
                ++b;
            }
        }
    }
}

// the kernel's dynamic shared memory: above the default 48 KB less its
// static shared memory only once this is set; refused past the card's
// opt-in limit
int set_smem(const void* kernel, long long words) {
    if (words == 0) return 0;
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    int err = (int)cudaGetDevice(&dev);
    if (!err) err = (int)cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (!err) err = (int)cudaFuncGetAttributes(&attr, kernel);
    if (err) return err;
    if (words * 4 + (long long)attr.sharedSizeBytes > optin) return (int)cudaErrorInvalidValue;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)(words * 4));
}

// blocks for `work` units of a kernel: at most the card's resident blocks
unsigned int grid_for(const void* kernel, long long work, long long smem_words) {
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                      (size_t)smem_words * 4) != cudaSuccess ||
        per_sm < 1)
        per_sm = 1;
    const long long cap = (long long)H100_SMS * per_sm;
    return (unsigned int)(work < cap ? (work > 0 ? work : 1) : cap);
}

bool aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

// a layout's region [at, at + len) lies in its `words` and starts on a
// multiple of `align` words
bool region(long long at, long long len, long long words, int align) {
    return at >= 0 && at % align == 0 && at + len <= words;
}

constexpr long long MAX_WORDS = 1 << 20;  // a layout's words, at most (4 MB: past any card)

}  // namespace

// R1: small [B, Ls], big [B, Lg] -> leaf_s, leaf_g [B n 3^k, h[k-1]] each, in
// the leaf order above.  plan: see read_route.  layout (n_layout words, the
// wrapper's split_plan and split_layout): depth, group, base, off, lim, cap,
// words, then the input offset of each split level from depth to k-1.
// Returns a cudaError (0 on success).
extern "C" int hm_route_split(const void* small, const void* big, void* leaf_s, void* leaf_g,
                              const long long* plan, const long long* layout, int n_layout,
                              void* stream) {
    Route r;
    int err = read_route(plan, &r);
    if (err) return err;
    if (n_layout < 7) return (int)cudaErrorInvalidValue;
    const long long depth = layout[0], group = layout[1], words = layout[6];
    if (depth < 0 || depth > r.k || depth > 30 || group < 1 || (depth > 0 && group > 1) ||
        n_layout != 7 + r.k - depth || words < 0 || words > MAX_WORDS ||
        layout[5] < (depth > 0 ? 1LL << depth : group) ||
        !region(layout[2], 2 * group, words, 2) || !region(layout[3], layout[5], words, 1) ||
        !region(layout[4], layout[5], words, 1))
        return (int)cudaErrorInvalidValue;
    Split sp;
    sp.depth = (int)depth;
    sp.group = (int)group;
    sp.base = (int)layout[2];
    sp.off = (int)layout[3];
    sp.lim = (int)layout[4];
    sp.cap = (int)layout[5];
    sp.words = (int)words;
    for (int i = sp.depth; i < r.k; ++i) {
        const long long at = layout[7 + i - sp.depth];
        if (!region(at, group * pow3(i - sp.depth) * 2 * r.h[i], words, 4))
            return (int)cudaErrorInvalidValue;
        sp.in[i] = (int)at;
    }
    const int w = r.h[r.k - 1];
    bool offsets4 = r.Ls % 4 == 0 && r.Lg % 4 == 0;
    for (int i = 0; i < sp.depth; ++i) offsets4 = offsets4 && r.h[i] % 4 == 0;
    const int len = sp.depth < r.k ? 2 * r.h[sp.depth] : w;
    sp.vec_rows = offsets4 && len % 4 == 0 && aligned(small) && aligned(big) &&
                  (sp.depth < r.k || (aligned(leaf_s) && aligned(leaf_g)));
    sp.vec_leaves = w % 4 == 0 && aligned(leaf_s) && aligned(leaf_g);
    err = set_smem((const void*)route_split_kernel, words);
    if (err) return err;
    const long long groups = (r.rows0 * pow3(sp.depth) + group - 1) / group;
    const unsigned int blocks = grid_for((const void*)route_split_kernel, 2 * groups, words);
    const dim3 grid((blocks + 1) / 2, 2);
    route_split_kernel<<<grid, THREADS, (size_t)words * 4, (cudaStream_t)stream>>>(
        (const uint32_t*)small, (const uint32_t*)big, (uint32_t*)leaf_s, (uint32_t*)leaf_g, r, sp);
    return (int)cudaGetLastError();
}

// R2, one launch of the wrapper's join_launches, given as n_launch words:
// (-1, 0) joins the chunk step's pieces (in [B n, 2 Ls] -> out [B, Ls +
// Lg]); (top, 0) the split level `top` alone (in [B n 3^(top+1), 2 h[top]]
// -> out [B n 3^top, lo[top]]); (top, tile, group, slot, words, the output
// offset of each tile level from k-tile to k-1, the product offset of each
// level from top to k-tile-1) the ascent from the leaves' products (in
// [B n 3^k, 2 h[k-1]]) to the nodes of depth top (out [B n 3^top,
// lo[top]]) in tiles of `tile` levels, `group` nodes a block (more than one
// only where a tile is a node's whole subtree), with the wrapper's
// ascent_layout.  Returns a cudaError.
extern "C" int hm_route_join(const void* in, void* out, const long long* plan,
                             const long long* launch, int n_launch, void* stream) {
    Route r;
    int err = read_route(plan, &r);
    if (err) return err;
    if (n_launch < 2) return (int)cudaErrorInvalidValue;
    const long long top = launch[0], tile = launch[1];
    const cudaStream_t st = (cudaStream_t)stream;
    const bool vec = aligned(in) && aligned(out);
    if (top < 0) {
        if (!r.chunked || top != -1 || tile != 0 || n_launch != 2) return (int)cudaErrorInvalidValue;
        const Tiles tl = make_tiles(r.B * (r.n + 1), r.Ls);
        if (vec && r.Ls % 4 == 0 && r.Lg % 4 == 0) {
            const void* kern = (const void*)route_join_pieces_kernel<4>;
            route_join_pieces_kernel<4><<<grid_for(kern, tl.count(), 0), THREADS, 0, st>>>(
                (const uint32_t*)in, (uint32_t*)out, tl, r.Ls, r.Lg, r.n);
        } else {
            const void* kern = (const void*)route_join_pieces_kernel<1>;
            route_join_pieces_kernel<1><<<grid_for(kern, tl.count(), 0), THREADS, 0, st>>>(
                (const uint32_t*)in, (uint32_t*)out, tl, r.Ls, r.Lg, r.n);
        }
        return (int)cudaGetLastError();
    }
    if (top >= r.k || tile < 0 || top + tile > r.k) return (int)cudaErrorInvalidValue;
    if (tile == 0) {
        if (n_launch != 2) return (int)cudaErrorInvalidValue;
        const int h = r.h[top], lo = r.lo[top];
        const Tiles tl = make_tiles(r.rows0 * pow3((int)top), h);
        if (vec && h % 4 == 0 && lo % 4 == 0) {
            const void* kern = (const void*)route_join_level_kernel<4>;
            route_join_level_kernel<4><<<grid_for(kern, tl.count(), 0), THREADS, 0, st>>>(
                (const uint32_t*)in, (uint32_t*)out, tl, h, lo);
        } else {
            const void* kern = (const void*)route_join_level_kernel<1>;
            route_join_level_kernel<1><<<grid_for(kern, tl.count(), 0), THREADS, 0, st>>>(
                (const uint32_t*)in, (uint32_t*)out, tl, h, lo);
        }
        return (int)cudaGetLastError();
    }
    const int k = r.k, w = r.h[k - 1], bottom = k - (int)tile;
    if (n_launch != 5 + k - top) return (int)cudaErrorInvalidValue;
    const long long group = launch[2], slot = launch[3], words = launch[4];
    const long long tile_words = pow3((int)tile) * 2 * w;
    if (group < 1 || (group > 1 && bottom > top) || words < 0 || words > MAX_WORDS ||
        slot % 4 != 0 || slot < group * tile_words || RING * slot > words)
        return (int)cudaErrorInvalidValue;
    Ascent a;
    a.top = (int)top;
    a.tile = (int)tile;
    a.group = (int)group;
    a.tiles = pow3(bottom - a.top);
    a.tile_words = (int)tile_words;
    a.slot = (int)slot;
    a.words = (int)words;
    for (int j = bottom; j < k; ++j) {
        const long long at = launch[5 + j - bottom];
        if (j != top && !region(at, group * pow3(j - bottom) * r.lo[j], words, 4))
            return (int)cudaErrorInvalidValue;
        a.lvl[j] = (int)at;
    }
    for (int i = a.top; i < bottom; ++i) {
        const long long at = launch[5 + a.tile + i - a.top];
        if (!region(at, r.lo[i], words, 4)) return (int)cudaErrorInvalidValue;
        a.acc[i] = (int)at;
    }
    a.bulk = w % 2 == 0 && aligned(in);
    a.vec_out = aligned(out);
    const void* kern = (const void*)route_join_ascent_kernel;
    err = set_smem(kern, words);
    if (err) return err;
    const long long groups = (r.rows0 * pow3(a.top) + group - 1) / group;
    route_join_ascent_kernel<<<grid_for(kern, groups, words), THREADS, (size_t)words * 4, st>>>(
        (const uint32_t*)in, (uint32_t*)out, r, a);
    return (int)cudaGetLastError();
}
