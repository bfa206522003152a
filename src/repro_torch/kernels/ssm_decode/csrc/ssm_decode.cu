// One decode token through a Mamba2 mixer's core, and the RMSNorm of its
// input, read straight from the caches.
//
// Replaces no TPU kernel: the reference computes the decode step in plain
// jnp (src/repro/models/ssm.py::_step: a concat and an einsum for the
// convolution, softplus, exp, two einsums for the state and the output,
// the gate and the norm), and the port's plain version of it
// (models/ssm.py::_step) is that code in PyTorch: some fifty small
// kernels a layer, each launched from the host.  On a model of 81 Mamba2
// layers (Zamba2-7B) the host's launches took longer than the device's
// work, so the decode step was paced by the host.  These two kernels do a
// layer's norm in one launch and its whole step between the two
// projections in two.
//
// What bounds them on an H100: device-memory bytes.  The step reads and
// writes each (row, head)'s float32 state [N, P] once and touches every
// element a handful of times; the norm reads a row and writes it.
//
//   * ssm_step_kernel: one block a (row, head).  Its threads first run
//     the depthwise causal convolution (K taps over the cached K-1
//     inputs and the new one, then SiLU) for the head's P x channels and
//     its group's N B and N C channels, in the conv state's type as the
//     plain version's concat and einsum run it, and write the
//     shifted conv state (the head that leads its group writes B and C).
//     Thread p then walks the N rows of column p of the state (coalesced
//     over p): s = s exp(dt A) + B[n] dt x[p], y += C[n] s.  Then y + D x,
//     times silu(z), to a float32 scratch row, and the sum of its squares
//     over the head to a scratch slot (no atomics: the order is fixed).
//   * ssm_norm_kernel: one block a (row, norm group): the group's sum of
//     squares from its heads' slots, in head order, then y rsqrt(mean +
//     eps) g rounded to the activations' type.  A norm group is an SSM
//     group (Zamba2's gated norm) or the whole row.
//   * rms_norm_kernel: one block a row: v rsqrt(mean(v^2) + eps) g in
//     float32, rounded once, where v is x, plus the previous layer's
//     output (the residual add, written back as the stream's next value)
//     and a shared block's output, each sum rounded as the plain
//     version's is.  A stack of layers then takes one launch a layer for
//     its residual add and its norm.
//
// Everything is float32 inside; inputs are widened on load and the
// outputs rounded once (the plain version rounds to the activations'
// type after several of its steps).  The conv is the exception: it keeps
// the plain version's roundings in the conv state's type.  Built once, with no compile-time
// sizes: every width is an argument.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr unsigned FULL = 0xffffffffu;
constexpr int NORM_THREADS = 256;

__device__ __forceinline__ float load(const void* p, size_t i, int bf16) {
    return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store(void* p, size_t i, float x, int bf16) {
    if (bf16)
        static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
    else
        static_cast<float*>(p)[i] = x;
}

// A raw element of a cache copied, src[i] to dst[j], of the same type.
__device__ __forceinline__ void copy(void* dst, size_t j, const void* src,
                                     size_t i, int bf16) {
    if (bf16)
        static_cast<uint16_t*>(dst)[j] = static_cast<const uint16_t*>(src)[i];
    else
        static_cast<float*>(dst)[j] = static_cast<const float*>(src)[i];
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// layers.silu in bfloat16: x * (1 / (1 + exp(-x))), each step rounded to
// bfloat16 as the plain version's ops round it (exp in double, so that
// its float32 value is the correctly rounded one the host's exp gives)
__device__ float silu_bf16(float x) {
    const float e = round_bf16(static_cast<float>(exp(-static_cast<double>(x))));
    return round_bf16(x * round_bf16(1.f / round_bf16(1.f + e)));
}

// torch.nn.functional.softplus (beta 1, threshold 20)
__device__ __forceinline__ float softplus(float x) {
    return x > 20.f ? x : log1pf(expf(x));
}

// Sum of x over the block, the same on every thread, in a fixed order.
// red holds 32 floats.
__device__ float block_sum(float x, float* red) {
#pragma unroll
    for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
    const int warps = (blockDim.x + 31) / 32;
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
    __syncthreads();
    float r = 0.f;
    for (int w = 0; w < warps; ++w) r += red[w];
    __syncthreads();
    return r;
}

struct StepParams {
    const void* proj;      // [B, d_proj]: z [din] | xBC [C] | dt [H], act type
    const void* conv_in;   // [B, K-1, C], cache type
    const float* ssm_in;   // [B, H, N, P]
    const float* conv_w;   // [K, C]
    const float* conv_b;   // [C]
    const float* dt_bias;  // [H]
    const float* a_log;    // [H]
    const float* d_skip;   // [H]
    const float* norm_g;   // [din]
    void* conv_out;        // [B, K-1, C], cache type
    float* ssm_out;        // [B, H, N, P]
    float* y;              // [B, din] scratch: gated output before the norm
    float* sq;             // [B, H] scratch: each head's sum of squares
    void* out;             // [B, din], act type
    int B, din, N, G, H, P, K, C, d_proj, n_norm;
    float dt_min, eps;     // dt_min <= 0: no floor
    int act_bf16, cache_bf16;
};

// Channel c of the convolution (c indexes xBC) for row b: its output
// after SiLU.  Slot k of the conv state holds the input k + 1 steps
// before the newest (oldest first); with write, the new state takes the
// old slots 1 .. K-2 and, last, the new input (its cast to the cache's
// type, as the plain version's).  The conv runs in the cache's type, as
// the plain version's does on the state with the new input cast to it:
// with a bfloat16 cache the new input, the weights and the bias are
// rounded to bfloat16, the products (exact in float32) summed in tap
// order and rounded, the bias added and rounded, and SiLU rounded step
// by step.
__device__ float conv_channel(const StepParams& p, int b, int c, bool write) {
    const size_t prow = (size_t)b * p.d_proj + p.din;
    const size_t crow = (size_t)b * (p.K - 1) * p.C;
    const int r = p.cache_bf16;
    const float cur = load(p.proj, prow + c, p.act_bf16);
    float acc = 0.f;
    for (int k = 0; k < p.K - 1; ++k) {
        const size_t i = crow + (size_t)k * p.C + c;
        const float w = p.conv_w[(size_t)k * p.C + c];
        acc += (r ? round_bf16(w) : w) * load(p.conv_in, i, r);
        if (write && k > 0) copy(p.conv_out, i - p.C, p.conv_in, i, r);
    }
    const float w = p.conv_w[(size_t)(p.K - 1) * p.C + c];
    if (write)
        store(p.conv_out, crow + (size_t)(p.K - 2) * p.C + c, cur, r);
    if (!r)
        return silu(acc + w * cur + p.conv_b[c]);
    acc = round_bf16(acc + round_bf16(w) * round_bf16(cur));
    return silu_bf16(round_bf16(acc + round_bf16(p.conv_b[c])));
}

__global__ void ssm_step_kernel(StepParams p) {
    extern __shared__ float sm[];                 // xs [P], Bs [N], Cs [N]
    __shared__ float red[32];
    float* xs = sm;
    float* Bs = sm + p.P;
    float* Cs = Bs + p.N;
    const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
    const int per_group = p.H / p.G, g = h / per_group;
    const bool lead = h % per_group == 0;
    if (t < p.P) xs[t] = conv_channel(p, b, h * p.P + t, true);
    if (t < p.N) {
        Bs[t] = conv_channel(p, b, p.din + g * p.N + t, lead);
        Cs[t] = conv_channel(p, b, p.din + (p.G + g) * p.N + t, lead);
    }
    __syncthreads();
    float dt = softplus(load(p.proj, (size_t)b * p.d_proj + p.din + p.C + h,
                             p.act_bf16) + p.dt_bias[h]);
    if (p.dt_min > 0.f) dt = fmaxf(dt, p.dt_min);
    const float decay = expf(dt * -expf(p.a_log[h]));
    float sq = 0.f;
    if (t < p.P) {
        const float x = xs[t], dtx = dt * x;
        const size_t base = (((size_t)b * p.H + h) * p.N) * p.P + t;
        float acc = 0.f;
        for (int n = 0; n < p.N; ++n) {
            const float s = p.ssm_in[base + (size_t)n * p.P] * decay + Bs[n] * dtx;
            p.ssm_out[base + (size_t)n * p.P] = s;
            acc += Cs[n] * s;
        }
        const float z = load(p.proj, (size_t)b * p.d_proj + h * p.P + t,
                             p.act_bf16);
        const float yv = (acc + p.d_skip[h] * x) * silu(z);
        p.y[(size_t)b * p.din + h * p.P + t] = yv;
        sq = yv * yv;
    }
    sq = block_sum(sq, red);
    if (t == 0) p.sq[(size_t)b * p.H + h] = sq;
}

__global__ void __launch_bounds__(NORM_THREADS) ssm_norm_kernel(StepParams p) {
    const int j = blockIdx.x, b = blockIdx.y;
    const int cols = p.din / p.n_norm, heads = p.H / p.n_norm;
    float ms = 0.f;
    for (int i = 0; i < heads; ++i) ms += p.sq[(size_t)b * p.H + j * heads + i];
    const float r = rsqrtf(ms / cols + p.eps);
    for (int c = threadIdx.x; c < cols; c += NORM_THREADS) {
        const size_t i = (size_t)b * p.din + (size_t)j * cols + c;
        store(p.out, i, p.y[i] * r * p.norm_g[(size_t)j * cols + c], p.act_bf16);
    }
}

// Row r of x: v = x (+ add: the sum rounded to the activations' type and
// written to h_out, the residual stream's next value) (+ extra: rounded
// again, as the plain version's sum is), then v rsqrt(mean(v^2) + eps) g.
__global__ void __launch_bounds__(NORM_THREADS) rms_norm_kernel(
        const void* x, const void* add, const void* extra, const float* g,
        void* out, void* h_out, int D, float eps, int bf16) {
    __shared__ float red[32];
    const size_t row = (size_t)blockIdx.x * D;
    auto value = [&](int c) {
        float v = load(x, row + c, bf16);
        if (add) {
            v += load(add, row + c, bf16);
            if (bf16) v = __bfloat162float(__float2bfloat16_rn(v));
        }
        return v;
    };
    auto input = [&](float v, int c) {
        if (extra) {
            v += load(extra, row + c, bf16);
            if (bf16) v = __bfloat162float(__float2bfloat16_rn(v));
        }
        return v;
    };
    float s = 0.f;
    for (int c = threadIdx.x; c < D; c += NORM_THREADS) {
        const float v = input(value(c), c);
        s += v * v;
    }
    const float r = rsqrtf(block_sum(s, red) / D + eps);
    for (int c = threadIdx.x; c < D; c += NORM_THREADS) {
        const float h = value(c);
        if (add) store(h_out, row + c, h, bf16);
        store(out, row + c, input(h, c) * r * g[c], bf16);
    }
}

// The step: ssm_step_kernel then ssm_norm_kernel.  Returns
// cudaGetLastError() after the launches (0: launched).
extern "C" int ssm_decode_step(
        const void* proj, const void* conv_in, const float* ssm_in,
        const float* conv_w, const float* conv_b, const float* dt_bias,
        const float* a_log, const float* d_skip, const float* norm_g,
        void* conv_out, float* ssm_out, float* y, float* sq, void* out,
        int B, int din, int N, int G, int H, int P, int K, int n_norm,
        float dt_min, float eps, int act_bf16, int cache_bf16, void* stream) {
    StepParams p;
    p.proj = proj;
    p.conv_in = conv_in;
    p.ssm_in = ssm_in;
    p.conv_w = conv_w;
    p.conv_b = conv_b;
    p.dt_bias = dt_bias;
    p.a_log = a_log;
    p.d_skip = d_skip;
    p.norm_g = norm_g;
    p.conv_out = conv_out;
    p.ssm_out = ssm_out;
    p.y = y;
    p.sq = sq;
    p.out = out;
    p.B = B;
    p.din = din;
    p.N = N;
    p.G = G;
    p.H = H;
    p.P = P;
    p.K = K;
    p.C = din + 2 * G * N;
    p.d_proj = din + p.C + H;
    p.n_norm = n_norm;
    p.dt_min = dt_min;
    p.eps = eps;
    p.act_bf16 = act_bf16;
    p.cache_bf16 = cache_bf16;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int m = P > N ? P : N;
    const int threads = (m + 31) / 32 * 32;
    ssm_step_kernel<<<dim3(H, B), threads, (P + 2 * N) * sizeof(float), st>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ssm_norm_kernel<<<dim3(n_norm, B), NORM_THREADS, 0, st>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// (x (+ add) (+ extra)) RMS-normed with gain g, rows of D; add and extra
// may be null; with add, x + add goes to h_out (which may be x itself:
// a row is read whole before it is written).
extern "C" int rms_norm(const void* x, const void* add, const void* extra,
                        const float* g, void* out, void* h_out, int rows,
                        int D, float eps, int bf16, void* stream) {
    rms_norm_kernel<<<rows, NORM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        x, add, extra, g, out, h_out, D, eps, bf16);
    return static_cast<int>(cudaGetLastError());
}
