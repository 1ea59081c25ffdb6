// RG-LRU linear recurrence (the Griffin / RecurrentGemma recurrent block) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py::rglru_pallas (body
// _rglru_kernel): per channel w of every sequence b,
//     log_a_t = r_t * (-8 * softplus(lam)),  a_t = exp(log_a_t),
//     beta_t  = sqrt(max(1 - exp(2 * log_a_t), 1e-12)),
//     h_t     = a_t * h_{t-1} + beta_t * (i_t * x_t),  y_t = h_t,
// from h_0 = h0 (or zeros), all in fp32; y is written in x's dtype, the last
// state in fp32. softplus has no threshold (as jax.nn.softplus), in the
// stable form max(l, 0) + log1p(exp(-|l|)); beta is computed as written, not
// as 1 - a^2.
//
// What bounds it on an H100: the recurrence is diagonal, so there is no
// matrix work; x, r and i are read once and y is written once. At the serving
// shape (B = 1, T = 2048, W = 4096, bf16) that is 67 MB, ~20 us of memory
// time. The design is the simple one: one thread owns one (b, w) channel and
// walks t in order, so loads are coalesced across w and the carried state
// never leaves a register (the TPU kernel keeps it in VMEM scratch across
// its sequential T grid axis; here a loop inside the thread takes that
// axis's place, and any T works: there is no T % block_t rule). The t loop
// runs in groups of U steps, and the next group's loads are issued before
// the current group's arithmetic, so 2U steps of x/r/i are in flight while
// the single dependent FMA chain of h runs. At B = 1 this is only W threads
// (32 blocks of 128 at W = 4096), one warp per SM sub-partition on 32 SMs,
// so the kernel is bound by memory latency, not bandwidth. A chunked
// parallel scan over T (per-chunk (prod a, u) summaries, a combine, a
// fix-up pass) is what would fill the card; that is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;  // threads (channels) per block
constexpr int U = 16;    // time steps per group; two groups are in flight
constexpr float C = 8.0f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {  // element strides of a (B, T, W) tensor; W is unit-stride
  long long b, t;
};

__device__ __forceinline__ float rglru_step(float h, float x, float r, float i, float base) {
  const float log_a = r * base;
  const float a = expf(log_a);
  const float beta = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f));
  return a * h + beta * (i * x);
}

template <typename T>
__global__ void __launch_bounds__(NT) rglru_kernel(
    const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ i,
    const float* __restrict__ lam, const float* __restrict__ h0, T* __restrict__ y,
    float* __restrict__ h_last, int T_len, int W, Strides xs, Strides rs, Strides is) {
  const int w = blockIdx.x * NT + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const float l = lam[w];
  const float base = -C * (fmaxf(l, 0.f) + log1pf(expf(-fabsf(l))));
  float h = h0 != nullptr ? h0[static_cast<long long>(b) * W + w] : 0.f;
  const T* xp = x + b * xs.b + w;
  const T* rp = r + b * rs.b + w;
  const T* ip = i + b * is.b + w;
  T* yp = y + static_cast<long long>(b) * T_len * W + w;

  const int t_full = T_len - T_len % U;
  T cx[U], cr[U], ci[U];
  if (t_full > 0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cx[u] = xp[u * xs.t];
      cr[u] = rp[u * rs.t];
      ci[u] = ip[u * is.t];
    }
  }
  for (int t = 0; t < t_full; t += U) {
    T nx[U], nr[U], ni[U];
    if (t + U < t_full) {  // the next group's loads go out before this group's arithmetic
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long tt = t + U + u;
        nx[u] = xp[tt * xs.t];
        nr[u] = rp[tt * rs.t];
        ni[u] = ip[tt * is.t];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = rglru_step(h, to_f(cx[u]), to_f(cr[u]), to_f(ci[u]), base);
      yp[static_cast<long long>(t + u) * W] = from_f<T>(h);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cx[u] = nx[u];
      cr[u] = nr[u];
      ci[u] = ni[u];
    }
  }
  for (int t = t_full; t < T_len; ++t) {  // the ragged tail, one step at a time
    h = rglru_step(h, to_f(xp[t * xs.t]), to_f(rp[t * rs.t]), to_f(ip[t * is.t]), base);
    yp[static_cast<long long>(t) * W] = from_f<T>(h);
  }
  h_last[static_cast<long long>(b) * W + w] = h;
}

template <typename T>
int launch(const void* x, const void* r, const void* i, const float* lam, const float* h0,
           void* y, float* h_last, int B, int T_len, int W, Strides xs, Strides rs, Strides is,
           cudaStream_t stream) {
  const dim3 grid((W + NT - 1) / NT, B);
  rglru_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const T*>(i), lam, h0,
      static_cast<T*>(y), h_last, T_len, W, xs, rs, is);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, r, i (B,T,W) of one dtype with unit stride along W, strides in elements;
// lam (W,) fp32; h0 (B,W) fp32 contiguous or null (zeros); y (B,T,W)
// contiguous in x's dtype; h_last (B,W) fp32 contiguous. dtype: 0 = float32,
// 1 = bfloat16. Returns the cudaError_t of the launch (0 on success).
int rglru_scan_fwd(const void* x, const void* r, const void* i, const void* lam, const void* h0,
                   void* y, void* h_last, int B, int T_len, int W, long long x_sb, long long x_st,
                   long long r_sb, long long r_st, long long i_sb, long long i_st, int dtype,
                   void* stream) {
  if (B == 0 || W == 0) return 0;
  const Strides xs{x_sb, x_st}, rs{r_sb, r_st}, is{i_sb, i_st};
  const float* l = static_cast<const float*>(lam);
  const float* h = static_cast<const float*>(h0);
  float* hl = static_cast<float*>(h_last);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, r, i, l, h, y, hl, B, T_len, W, xs, rs, is, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, r, i, l, h, y, hl, B, T_len, W, xs, rs, is, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
