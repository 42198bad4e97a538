// K2: fused encryption of a flat bit batch, as table lookups in shared memory.
//
// Replaces homomorph_tpu/gf2/encrypt_kernel.py::_encrypt_kernel_v2 (launched
// by _encrypt_fused with v2=True).  The TPU kernel unpacked the selection
// words to bf16, ran the counts sel @ pk_bits on the MXU, took each count
// mod 2 and repacked the bit columns with two more matmuls.  Over GF(2) a
// ciphertext is a plain XOR of selected key rows,
//
//   C = XOR_{i : sel_i = 1} T_i  ^  x,
//
// so no product is needed at all ("Four Russians"): the tau selection bits
// are cut into chunks of K = 8 bits (the bytes of the selection words,
// LSB-first as gf2/poly.py orders bits), and for chunk j the block holds in
// shared memory the table of all 2^K XOR combinations of the key rows
// T_{Kj} .. T_{Kj+K-1}.  Entry v is entry (v without its top bit b) XOR
// T_{Kj+b}: K rounds of one XOR of one key row each, a barrier between
// rounds.  Limb m of a row's ciphertext is then XOR_j table[j][chunk_j][m]:
// ceil(tau/K) lookups and XORs per limb.  Key rows beyond tau are zero, so
// the random selection bits beyond tau need no mask.  The plaintext bit is
// folded into limb 0.
//
// Layout: a block owns one tile of TW key limbs and a contiguous range of
// rows, builds the tile's tables once and streams its rows through them
// (about one block per SM: the tables take most of the shared memory).
// Thread t serves limb t % TW of row t / TW, so a row's lanes read one
// table entry's consecutive limbs and the stores of a row are consecutive
// (whole rows when one tile covers every limb).  Each thread loads the
// selection words and plaintext bits of 2-4 rows before looking any of
// them up, so their loads are in flight together (loading the plaintext
// bit only at the store, as a first version did, exposed its latency; a
// second version that copied each step's words into a shared-memory ring
// with cp.async was slower still, its block barriers costing more than the
// copies saved).  When the tables of all chunks do not fit (tau > 8
// words), the chunks are taken in passes of NW selection words and the
// output is read back and XORed between passes by the thread that wrote it.
// hm_encrypt_table picks NW from tau and TW from the card's opt-in shared
// memory (the fewest tiles of equal width whose tables fit); every choice
// gives the same bits.  Chunks of 4 bits (2 tiles of 33 limbs at tau = 256)
// were 1.6x slower than bytes (10 tiles of 7), for twice the lookups.
//
// Bound on the H100: the selection words, plaintext bits and output limbs
// cross HBM once (3.35 TB/s), and the lookups read B * ceil(tau/8) * limbs
// words of shared memory at 128 bytes per SM per clock; at tau = 128 the
// two are about equal, at tau = 256 the lookups bind.

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int K = 8;  // selection bits per chunk: one byte
constexpr int CPW = 32 / K;  // chunks per selection word
constexpr int MAX_NW = 8;  // selection words per pass of the largest instance
constexpr int MAX_DEVICES = 64;
// rows whose selection words a thread loads at once (NW words each), as
// many as 64 registers a thread hold without spilling
__host__ __device__ constexpr int rows_per_thread(int nw) { return nw >= 8 ? 2 : 4; }

template <int NW>
__global__ void __launch_bounds__(THREADS, 1)
encrypt_table_kernel(const uint32_t* __restrict__ selw, const uint32_t* __restrict__ pk,
                     const uint32_t* __restrict__ plain, uint32_t* out,
                     long long B, int W, int tau, int ld_pk, int L, int Lt, int TW,
                     int n_tiles, long long rows_per_group) {
    constexpr uint32_t MASK = (1u << K) - 1u;
    constexpr int EPT = rows_per_thread(NW);
    extern __shared__ uint32_t tab[];  // [chunk][entry][TW]

    const int tile = blockIdx.x % n_tiles;
    const long long group = blockIdx.x / n_tiles;
    const int m0 = tile * TW;
    const int tw = min(TW, Lt - m0);
    const long long r_lo = group * rows_per_group;
    const long long r_hi = min(B, r_lo + rows_per_group);
    if (r_lo >= r_hi) return;

    const int R = THREADS / tw;  // rows per step
    const int r_t = threadIdx.x / tw;
    const int mm = threadIdx.x - r_t * tw;
    const int m = m0 + mm;
    const int n_chunks = (tau + K - 1) / K;
    const int n_pass = (W + NW - 1) / NW;

    for (int p = 0; p < n_pass; ++p) {
        const int w0 = p * NW;
        const int nw = min(NW, W - w0);
        const int c0 = w0 * CPW;
        const int nch = min(NW * CPW, n_chunks - c0);
        if (p > 0) __syncthreads();  // the previous pass is done with the tables

        // build: entry 0 is zero; round b fills entries [2^b, 2^(b+1))
        for (int e = threadIdx.x; e < nch * tw; e += THREADS) {
            const int j = e / tw;
            tab[(j << K) * tw + (e - j * tw)] = 0u;
        }
        __syncthreads();
#pragma unroll 1
        for (int b = 0; b < K; ++b) {
            const int half = 1 << b;
            const int items = nch * half * tw;
            for (int e = threadIdx.x; e < items; e += THREADS) {
                const int rest = e / tw;
                const int col = e - rest * tw;
                const int u = rest & (half - 1);
                const int j = rest >> b;
                const int row = (c0 + j) * K + b;
                const uint32_t key = row < tau ? __ldg(pk + (long long)row * ld_pk + m0 + col) : 0u;
                const int base = (j << K) * tw + col;
                tab[base + (half + u) * tw] = tab[base + u * tw] ^ key;
            }
            __syncthreads();
        }
        if (r_t >= R) continue;

        const bool last = p == n_pass - 1;
        for (long long row = r_lo + r_t; row < r_hi; row += (long long)EPT * R) {
            uint32_t s[EPT][NW];
            uint32_t acc[EPT];
#pragma unroll
            for (int u = 0; u < EPT; ++u) {
                const long long rr = row + (long long)u * R;
                const bool ok = rr < r_hi;
#pragma unroll
                for (int w = 0; w < NW; ++w)
                    s[u][w] = (ok && w < nw) ? __ldg(selw + rr * W + w0 + w) : 0u;
                // the previous passes' limb and the plaintext bit start the
                // accumulator, loaded beside the words
                uint32_t a = 0u;
                if (ok && p > 0) a = out[rr * L + m];
                if (ok && last && m == 0) a ^= __ldg(plain + rr) & 1u;
                acc[u] = a;
            }
#pragma unroll
            for (int w = 0; w < NW; ++w) {
#pragma unroll
                for (int c = 0; c < CPW; ++c) {
                    const int j = w * CPW + c;
                    if (j < nch) {
                        const uint32_t* t = tab + (j << K) * tw + mm;
#pragma unroll
                        for (int u = 0; u < EPT; ++u)
                            acc[u] ^= t[((s[u][w] >> (c * K)) & MASK) * tw];
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < EPT; ++u) {
                const long long rr = row + (long long)u * R;
                if (rr < r_hi) out[rr * L + m] = acc[u];
            }
        }
    }
}

// per card: its SM count and the shared memory a block may opt into
struct Card {
    int sms = 0, smem_optin = 0;
};
// per card and kernel instance: whether the opt-in is set, and the blocks
// per SM at the last shared-memory size it was launched with
struct Instance {
    bool opted_in = false;
    size_t smem = 0;
    int per_sm = 0;
};
std::mutex cache_mutex;
Card cards[MAX_DEVICES];

cudaError_t card(int dev, Card* c) {
    std::lock_guard<std::mutex> lock(cache_mutex);
    Card& cached = cards[dev];
    if (!cached.sms) {
        Card q;
        cudaError_t err = cudaDeviceGetAttribute(&q.sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&q.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err != cudaSuccess) return err;
        cached = q;
    }
    *c = cached;
    return cudaSuccess;
}

// selection words per pass: the instance that holds all W words, or passes
// of the largest
int pass_words(int W) {
    for (int nw = 1; nw < MAX_NW; nw *= 2)
        if (nw >= W) return nw;
    return MAX_NW;
}

size_t table_bytes(int tau, int nw, int tw) {
    const int slots = min(nw * CPW, (tau + K - 1) / K);
    return (size_t)slots * (1u << K) * tw * sizeof(uint32_t);
}

template <int NW>
int launch(const uint32_t* selw, const uint32_t* pk, const uint32_t* plain, uint32_t* out,
           long long B, int W, int tau, int ld_pk, int L, int Lt, int dev, const Card& c,
           cudaStream_t stream) {
    static Instance instances[MAX_DEVICES];
    auto kernel = encrypt_table_kernel<NW>;
    // the fewest tiles of equal width whose tables fit one block
    const int fit = min(THREADS, c.smem_optin / (int)table_bytes(tau, NW, 1));
    if (fit < 1) return (int)cudaErrorInvalidConfiguration;
    const int n_tiles = (Lt + fit - 1) / fit;
    const int TW = (Lt + n_tiles - 1) / n_tiles;
    const size_t smem = table_bytes(tau, NW, TW);
    int per_sm;
    {
        std::lock_guard<std::mutex> lock(cache_mutex);
        Instance& in = instances[dev];
        cudaError_t err;
        if (!in.opted_in) {
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       c.smem_optin);
            if (err != cudaSuccess) return (int)err;
            in.opted_in = true;
        }
        if (in.smem != smem || !in.per_sm) {
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&in.per_sm, kernel, THREADS, smem);
            if (err != cudaSuccess) return (int)err;
            in.smem = smem;
        }
        per_sm = in.per_sm;
    }
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    // as many row groups as keep every SM busy, and no group smaller than a step
    const long long step = (long long)rows_per_thread(NW) * (THREADS / TW);
    long long groups = max(1LL, (long long)c.sms * per_sm / n_tiles);
    groups = min(groups, (B + step - 1) / step);
    const long long rows_per_group = (B + groups - 1) / groups;
    groups = (B + rows_per_group - 1) / rows_per_group;
    kernel<<<(unsigned int)(groups * n_tiles), THREADS, smem, stream>>>(
        selw, pk, plain, out, B, W, tau, ld_pk, L, Lt, TW, n_tiles, rows_per_group);
    return (int)cudaGetLastError();
}

}  // namespace

// selw [B, W] (W = ceil(tau/32)), pk [tau, ld_pk] key limbs, plain [B] ->
// out [B, L], all contiguous u32.  Writes limbs [0, Lt) of each row (Lt <=
// min(ld_pk, L)); the caller zeroes limbs Lt..L-1.  Returns
// cudaGetLastError() after the launch, or the error of a refused query or
// attribute (0 on success).
extern "C" int hm_encrypt_table(const void* selw, const void* pk, const void* plain, void* out,
                                long long B, int W, int tau, int ld_pk, int L, int Lt,
                                void* stream) {
    if (B < 1 || W < 1 || tau < 1 || tau > 32 * W || Lt < 1 || Lt > L || Lt > ld_pk)
        return (int)cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    Card c;
    if ((err = card(dev, &c)) != cudaSuccess) return (int)err;
    const auto* s = (const uint32_t*)selw;
    const auto* k = (const uint32_t*)pk;
    const auto* x = (const uint32_t*)plain;
    auto* o = (uint32_t*)out;
    auto st = (cudaStream_t)stream;
    switch (pass_words(W)) {
        case 1: return launch<1>(s, k, x, o, B, W, tau, ld_pk, L, Lt, dev, c, st);
        case 2: return launch<2>(s, k, x, o, B, W, tau, ld_pk, L, Lt, dev, c, st);
        case 4: return launch<4>(s, k, x, o, B, W, tau, ld_pk, L, Lt, dev, c, st);
        default: return launch<MAX_NW>(s, k, x, o, B, W, tau, ld_pk, L, Lt, dev, c, st);
    }
}
