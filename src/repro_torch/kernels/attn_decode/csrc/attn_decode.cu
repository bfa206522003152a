// One decode token's attention, read straight from the KV cache.
//
// Replaces no TPU kernel: the reference computes decode attention in plain
// jnp (src/repro/models/layers.py::attention_decode: an einsum over the
// upcast cache, a mask, a softmax and a second einsum), and the port's plain
// version of it (kernel.py::attn_decode_plain) is that code in PyTorch.  On
// the card that code wrote a float32 copy of each layer's whole K cache and
// laid K and V out again for its two batched products: about seven times
// the bytes the mathematics needs.  This kernel reads each visible cache row
// once, in its stored type, and widens it in registers.
//
// What bounds it on an H100: device-memory bytes.  A row of K and a row of
// V (hd elements each) feed 2 hd multiply-adds per query head, so there are
// about G flops a byte against the ~295 a byte where the tensor cores
// become the limit: the tensor cores play no part, and the design is about
// keeping enough 16-byte loads in flight.
//
//   * One block per (batch row, kv head, split of the positions); the G
//     query heads of a kv head share every row the block loads.
//   * A cache row is hd elements, contiguous, at a stride of KH hd elements
//     from the next position.  TPR lanes take one row (a 16-byte vector
//     each), a warp 32 / TPR rows at once, and every lane issues UNROLL rows'
//     loads before it uses any: with 256 threads a block keeps 16 KB in
//     flight, a few MB over the card.
//   * Only the visible positions are read.  They are one run of positions,
//     [lo, pos] (the ring rule of slot_positions with the window), and
//     position p lies in slot p % S: a masked slot has exactly zero weight
//     in the reference's softmax (exp(-1e30 - max) is 0), so skipping it
//     leaves out no arithmetic.
//   * The rounding points are the reference's: logits are float32 sums of
//     float32 products times hd^-0.5; the softmax is float32 over all the
//     positions at once; the probabilities are rounded to q's type before
//     they weight V; P.V is summed in float32 and rounded to q's type once.
//     So the logits are kept (in shared memory) until the softmax's max
//     and sum are known, and V is read after that: K and V are still each
//     read once.
//   * Where B KH blocks cannot fill the card (or one block's logits would
//     not fit in shared memory) the positions are split over blocks: a
//     first kernel writes each split's logits with its (max, sum), a second
//     merges the splits' (max, sum), weights its V rows and writes its
//     partial sums; the block that finishes last for a (row, head) adds the
//     partials in split order, so the result does not depend on the order
//     in which blocks finish.
//
// Built once a variant, with -DAD_HD (head dim), -DAD_KT (cache type:
// 0 float32, 1 bfloat16) and -DAD_GM (query heads a kv head, at most).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#if !defined(AD_HD) || !defined(AD_KT) || !defined(AD_GM)
#error "build with -DAD_HD=<head dim> -DAD_KT=<0 float32 | 1 bfloat16> -DAD_GM=<G at most>"
#endif

constexpr int HD = AD_HD;
constexpr int GM = AD_GM;
constexpr bool KT_BF16 = AD_KT == 1;
typedef uint16_t bf16_bits;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = KT_BF16 ? 8 : 4;          // cache elements a 16-byte load
static_assert(HD % VEC == 0, "a row is a whole number of 16-byte vectors");
constexpr int NV = HD / VEC;                  // 16-byte vectors a row
constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }
constexpr int TPR = NV >= 32 ? 32 : pow2_at_least(NV);   // lanes a row
constexpr int VPT = (NV + TPR - 1) / TPR;     // vectors a lane, a row
constexpr int EPT = VPT * VEC;                // elements a lane, a row
constexpr int RPW = 32 / TPR;                 // rows a warp at once
constexpr int RPB = WARPS * RPW;              // rows the block at once
constexpr int UNROLL = 4;                     // rows a lane has in flight
constexpr unsigned FULL = 0xffffffffu;

struct Params {
    const void* q;       // [B, KH, G, HD] in q's type (its length-1 axis dropped)
    const void* k;       // [B, S, KH, HD] in the cache's type
    const void* v;
    void* out;           // [B, KH, G, HD] in q's type
    float* logits;       // split: [B, KH, G, n_valid]
    float* stats;        // split: [n_split, B, KH, G, 2] (max, sum of exp)
    float* partial;      // split: [n_split, B, KH, G, HD]
    int* tickets;        // split: [B, KH], zero on entry
    int B, S, KH, G;
    int lo;              // first visible position
    int n_valid;         // visible positions lo .. lo + n_valid - 1
    int chunk;           // positions a split
    int n_split;
    int q_bf16;          // q, the probabilities and out are bfloat16
    float scale;
};

__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bits_to_float(bf16_bits h) {
    return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// The EPT cache elements of a lane's vectors, widened to float32.  A
// float32 cache read by a bfloat16 query is first rounded to bfloat16, as
// the reference's cast of the cache to q's type does.
__device__ __forceinline__ void widen(const uint4 (&raw)[VPT], float (&f)[EPT],
                                      bool to_bf16) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
        const uint32_t w[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            if constexpr (KT_BF16) {
                f[i * VEC + 2 * c] = __uint_as_float(w[c] << 16);
                f[i * VEC + 2 * c + 1] = __uint_as_float(w[c] & 0xffff0000u);
            } else {
                const float x = __uint_as_float(w[c]);
                f[i * VEC + c] = to_bf16 ? bf16_round(x) : x;
            }
        }
    }
}

// The 16-byte vectors of position j's row that this lane holds.
__device__ __forceinline__ void load_row(const Params& p, const void* cache,
                                         int b, int kh, int j, int t,
                                         uint4 (&raw)[VPT]) {
    int slot = p.lo % p.S + j;
    if (slot >= p.S) slot -= p.S;
    const uint4* row = reinterpret_cast<const uint4*>(
        static_cast<const char*>(cache) +
        ((((size_t)b * p.S + slot) * p.KH + kh) * HD) * (KT_BF16 ? 2 : 4));
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
        const int v = t + i * TPR;
        raw[i] = v < NV ? __ldcs(row + v) : make_uint4(0, 0, 0, 0);
    }
}

// Sum (or max) of x over the block; every thread gets the result, added
// in the same order on every thread.  red holds WARPS floats.
template <bool MAX>
__device__ float block_reduce(float x, float* red) {
#pragma unroll
    for (int off = 16; off; off >>= 1) {
        const float y = __shfl_xor_sync(FULL, x, off);
        x = MAX ? fmaxf(x, y) : x + y;
    }
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
    __syncthreads();
    float r = red[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
    __syncthreads();
    return r;
}

__device__ void load_q(const Params& p, int b, int kh, float* qs) {
    const size_t base = ((size_t)b * p.KH + kh) * p.G * HD;
    for (int i = threadIdx.x; i < p.G * HD; i += THREADS)
        qs[i] = p.q_bf16
            ? bits_to_float(static_cast<const bf16_bits*>(p.q)[base + i])
            : static_cast<const float*>(p.q)[base + i];
}

// Logits of positions [j0, j1) for every query head: lg[g * ld + j - j0].
__device__ void qk_phase(const Params& p, int b, int kh, int j0, int j1,
                         const float* qs, float* lg, int ld) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int sub = lane / TPR, t = lane % TPR;
    const bool to_bf16 = !KT_BF16 && p.q_bf16;
    float qr[GM][EPT];
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
        for (int i = 0; i < VPT; ++i)
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
                const int v = t + i * TPR;
                qr[g][i * VEC + e] =
                    g < p.G && v < NV ? qs[g * HD + v * VEC + e] : 0.f;
            }
    // wbase is the same on every lane of a warp, so the shuffles below
    // always run on the full warp
    for (int wbase = j0 + warp * RPW; wbase < j1; wbase += RPB * UNROLL) {
        uint4 raw[UNROLL][VPT];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int j = wbase + sub + u * RPB;
            if (j < j1) {
                load_row(p, p.k, b, kh, j, t, raw[u]);
            } else {
#pragma unroll
                for (int i = 0; i < VPT; ++i) raw[u][i] = make_uint4(0, 0, 0, 0);
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            float kf[EPT];
            widen(raw[u], kf, to_bf16);
            float dot[GM];
#pragma unroll
            for (int g = 0; g < GM; ++g) {
                float s = 0.f;
#pragma unroll
                for (int e = 0; e < EPT; ++e) s += kf[e] * qr[g][e];
#pragma unroll
                for (int off = TPR / 2; off; off >>= 1)
                    s += __shfl_xor_sync(FULL, s, off);
                dot[g] = s;
            }
            const int j = wbase + sub + u * RPB;
            if (t == 0 && j < j1) {
#pragma unroll
                for (int g = 0; g < GM; ++g)
                    if (g < p.G) lg[g * ld + j - j0] = dot[g] * p.scale;
            }
        }
    }
}

// The (max, sum of exp(l - max)) of query head g's n logits in lg.
__device__ float2 chunk_stats(const float* lg, int n, float* red) {
    float m = -INFINITY;
    for (int j = threadIdx.x; j < n; j += THREADS) m = fmaxf(m, lg[j]);
    m = block_reduce<true>(m, red);
    float z = 0.f;
    for (int j = threadIdx.x; j < n; j += THREADS) z += expf(lg[j] - m);
    return make_float2(m, block_reduce<false>(z, red));
}

// lg's n logits of one query head become their probabilities under the
// softmax's (max, sum), rounded to q's type.
__device__ void normalize(float* lg, const float* src, int n, float2 ms,
                          bool to_bf16) {
    for (int j = threadIdx.x; j < n; j += THREADS) {
        const float w = expf(src[j] - ms.x) / ms.y;
        lg[j] = to_bf16 ? bf16_round(w) : w;
    }
}

// acc += the probabilities pr[g * ld + j - j0] times V's rows [j0, j1).
__device__ void pv_phase(const Params& p, int b, int kh, int j0, int j1,
                         const float* pr, int ld, float (&acc)[GM][EPT]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int sub = lane / TPR, t = lane % TPR;
    const bool to_bf16 = !KT_BF16 && p.q_bf16;
    for (int wbase = j0 + warp * RPW; wbase < j1; wbase += RPB * UNROLL) {
        uint4 raw[UNROLL][VPT];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int j = wbase + sub + u * RPB;
            if (j < j1) {
                load_row(p, p.v, b, kh, j, t, raw[u]);
            } else {
#pragma unroll
                for (int i = 0; i < VPT; ++i) raw[u][i] = make_uint4(0, 0, 0, 0);
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int j = wbase + sub + u * RPB;
            if (j >= j1) continue;
            float vf[EPT];
            widen(raw[u], vf, to_bf16);
#pragma unroll
            for (int g = 0; g < GM; ++g) {
                if (g >= p.G) continue;
                const float w = pr[g * ld + j - j0];
#pragma unroll
                for (int e = 0; e < EPT; ++e) acc[g][e] += w * vf[e];
            }
        }
    }
}

// The block's sums for query head g: acc over the warp's rows, then over
// the warps, in a fixed order.  Thread d < HD returns element d; red holds
// WARPS * HD floats.
__device__ float head_sum(float (&acc)[EPT], float* red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int sub = lane / TPR, t = lane % TPR;
#pragma unroll
    for (int e = 0; e < EPT; ++e)
#pragma unroll
        for (int off = TPR; off < 32; off <<= 1)
            acc[e] += __shfl_xor_sync(FULL, acc[e], off);
    if (sub == 0) {
#pragma unroll
        for (int i = 0; i < VPT; ++i) {
            const int v = t + i * TPR;
            if (v < NV)
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                    red[warp * HD + v * VEC + e] = acc[i * VEC + e];
        }
    }
    __syncthreads();
    float s = 0.f;
    if (threadIdx.x < HD)
        for (int w = 0; w < WARPS; ++w) s += red[w * HD + threadIdx.x];
    __syncthreads();
    return s;
}

__device__ void store_out(const Params& p, size_t i, float x) {
    if (p.q_bf16)
        static_cast<__nv_bfloat16*>(p.out)[i] = __float2bfloat16_rn(x);
    else
        static_cast<float*>(p.out)[i] = x;
}

// The whole run of positions in one block: logits, softmax, P.V, out.
__global__ void __launch_bounds__(THREADS) attn_decode_kernel(Params p) {
    extern __shared__ float lg[];                 // [G][n_valid]
    __shared__ float qs[GM * HD];
    __shared__ float red[WARPS * HD];
    const int kh = blockIdx.y, b = blockIdx.z, n = p.n_valid;
    load_q(p, b, kh, qs);
    __syncthreads();
    qk_phase(p, b, kh, 0, n, qs, lg, n);
    __syncthreads();
    for (int g = 0; g < p.G; ++g) {
        const float2 ms = chunk_stats(lg + g * n, n, red);
        normalize(lg + g * n, lg + g * n, n, ms, p.q_bf16);
    }
    __syncthreads();
    float acc[GM][EPT] = {};
    pv_phase(p, b, kh, 0, n, lg, n, acc);
    const size_t base = ((size_t)b * p.KH + kh) * p.G * HD;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
        if (g >= p.G) break;
        const float s = head_sum(acc[g], red);
        if (threadIdx.x < HD) store_out(p, base + g * HD + threadIdx.x, s);
    }
}

// Split, first pass: the split's logits and their (max, sum) to memory.
__global__ void __launch_bounds__(THREADS) attn_decode_qk_kernel(Params p) {
    extern __shared__ float lg[];                 // [G][chunk]
    __shared__ float qs[GM * HD];
    __shared__ float red[WARPS];
    const int sp = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
    const int j0 = sp * p.chunk, j1 = min(j0 + p.chunk, p.n_valid), n = j1 - j0;
    load_q(p, b, kh, qs);
    __syncthreads();
    qk_phase(p, b, kh, j0, j1, qs, lg, p.chunk);
    __syncthreads();
    for (int g = 0; g < p.G; ++g) {
        const float2 ms = chunk_stats(lg + g * p.chunk, n, red);
        const size_t row = ((size_t)b * p.KH + kh) * p.G + g;
        if (threadIdx.x == 0) {
            float* st = p.stats + 2 * (sp * (size_t)p.B * p.KH * p.G + row);
            st[0] = ms.x;
            st[1] = ms.y;
        }
        float* dst = p.logits + row * p.n_valid + j0;
        for (int j = threadIdx.x; j < n; j += THREADS) dst[j] = lg[g * p.chunk + j];
    }
}

// Split, second pass: the splits' (max, sum) merged, the split's
// probabilities times its V rows; the last block of a (row, head) adds the
// partial sums in split order and writes out.
__global__ void __launch_bounds__(THREADS) attn_decode_pv_kernel(Params p) {
    extern __shared__ float lg[];                 // [G][chunk]
    __shared__ float red[WARPS * HD];
    __shared__ int last;
    const int sp = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
    const int j0 = sp * p.chunk, j1 = min(j0 + p.chunk, p.n_valid), n = j1 - j0;
    const size_t rows = (size_t)p.B * p.KH * p.G;
    for (int g = 0; g < p.G; ++g) {
        const size_t row = ((size_t)b * p.KH + kh) * p.G + g;
        float m = -INFINITY, z = 0.f;
        for (int i = 0; i < p.n_split; ++i) m = fmaxf(m, p.stats[2 * (i * rows + row)]);
        for (int i = 0; i < p.n_split; ++i) {
            const float* st = p.stats + 2 * (i * rows + row);
            z += st[1] * expf(st[0] - m);
        }
        normalize(lg + g * p.chunk, p.logits + row * p.n_valid + j0, n,
                  make_float2(m, z), p.q_bf16);
    }
    __syncthreads();
    float acc[GM][EPT] = {};
    pv_phase(p, b, kh, j0, j1, lg, p.chunk, acc);
    const size_t base = ((size_t)b * p.KH + kh) * p.G * HD;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
        if (g >= p.G) break;
        const float s = head_sum(acc[g], red);
        if (threadIdx.x < HD) p.partial[sp * rows * HD + base + g * HD + threadIdx.x] = s;
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
        last = atomicAdd(p.tickets + (size_t)b * p.KH + kh, 1) == p.n_split - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int i = threadIdx.x; i < p.G * HD; i += THREADS) {
        float s = 0.f;
        for (int k = 0; k < p.n_split; ++k) s += __ldcg(p.partial + k * rows * HD + base + i);
        store_out(p, base + i, s);
    }
}

// The launch: one kernel when n_split is 1, else the two passes.  Returns
// cudaGetLastError() after the launches (0: launched).
extern "C" int attn_decode(const void* q, const void* k, const void* v,
                           void* out, float* ws, int* tickets, int B, int S,
                           int KH, int G, int lo, int n_valid, int n_split,
                           int q_bf16, float scale, void* stream) {
    Params p;
    p.q = q;
    p.k = k;
    p.v = v;
    p.out = out;
    p.tickets = tickets;
    p.B = B;
    p.S = S;
    p.KH = KH;
    p.G = G;
    p.lo = lo;
    p.n_valid = n_valid;
    p.n_split = n_split;
    p.chunk = (n_valid + n_split - 1) / n_split;
    p.q_bf16 = q_bf16;
    p.scale = scale;
    p.logits = ws;
    p.stats = ws ? ws + (size_t)B * KH * G * n_valid : nullptr;
    p.partial = ws ? p.stats + (size_t)n_split * B * KH * G * 2 : nullptr;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (n_split == 1) {
        attn_decode_kernel<<<dim3(1, KH, B), THREADS,
                             (size_t)G * n_valid * sizeof(float), st>>>(p);
    } else {
        const size_t smem = (size_t)G * p.chunk * sizeof(float);
        attn_decode_qk_kernel<<<dim3(n_split, KH, B), THREADS, smem, st>>>(p);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
        attn_decode_pv_kernel<<<dim3(n_split, KH, B), THREADS, smem, st>>>(p);
    }
    return static_cast<int>(cudaGetLastError());
}
