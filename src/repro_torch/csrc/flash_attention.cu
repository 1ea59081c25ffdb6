// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel): GQA attention with an online softmax, causal and
// sliding-window masks, fp32 running statistics, output in q's dtype.
//
// What bounds it on an H100: at the serving shapes (T = 128, H = 32, K = 8,
// hd = 128, bf16) one call moves ~2.6 MB of q/k/v/o and does ~134 MFLOP, so
// the least time is the memory time, ~0.8 us, far under a launch. The
// design keeps every intermediate on chip: S = Q·Kᵀ and P live in shared
// memory one 32x32 tile at a time and never reach device memory, K and V are
// read once per query tile, and q/k/v are read in place through their strides
// (no host-side pad, fold or transpose: the ragged T and S edges are masked
// here). The products run on CUDA cores in fp32; moving them onto the tensor
// cores (wgmma) is later work, and is what a long prompt would need.
//
// head_dim 256 (recurrentgemma-9b: 16 query heads on 1 kv head, a 2048-token
// window) is a further instantiation of the same code: a block needs 102,912 B
// of shared memory (two blocks per SM) and each thread holds 32 accumulators.
// At T = 2048 a prefill call does ~34 GFLOP on CUDA cores in fp32, where the
// tensor cores would bound it at ~35 us: it is operation-bound and slow.
//
// Layout: one block per (batch, kv head, tile of BR folded query rows). Row
// r of the fold is query position r / G and head kv_head * G + r % G, so the
// G query heads of a kv head share each K/V tile. Causal blocks stop at the
// last key the tile's last row can see; windowed blocks start at the first
// key the tile's first row can see. Masked lanes contribute an explicit 0 to
// the softmax, and a row whose sum stays 0 is written as zeros.
#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BR = 32;   // folded query rows per block
constexpr int BC = 32;   // keys per tile: one lane per key
constexpr int NT = 256;  // threads per block (8 warps)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Strides {  // element strides of a (B, seq, heads, hd) tensor; hd is unit-stride
  long long b, s, h;
};

template <int HD>
constexpr int smem_floats() {
  return BR * HD + BC * (HD + 1) + BC * HD + BR * BC + 3 * BR;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    int T_len, int S, int G, Strides qs, Strides ks, Strides vs, Strides os,
    float sm_scale, int causal, int window) {
  static_assert((BR * HD) % NT == 0, "accumulator must split evenly over threads");
  constexpr int PER = BR * HD / NT;
  extern __shared__ float smem[];
  float* sQ = smem;                 // BR x HD, pre-scaled
  float* sK = sQ + BR * HD;         // BC x (HD + 1): padded against bank conflicts
  float* sV = sK + BC * (HD + 1);   // BC x HD
  float* sP = sV + BC * HD;         // BR x BC probabilities of the current tile
  float* sM = sP + BR * BC;         // BR running max
  float* sL = sM + BR;              // BR running sum
  float* sA = sL + BR;              // BR rescale factor of the current tile

  const int b = blockIdx.z, kh = blockIdx.y;
  const int r0 = blockIdx.x * BR;
  const int rows = T_len * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < BR * HD; i += NT) {
    const int r = i / HD, d = i % HD, row = r0 + r;
    float x = 0.f;
    if (row < rows) {
      const int t = row / G, h = kh * G + row % G;
      x = to_f(q[b * qs.b + t * qs.s + h * qs.h + d]) * sm_scale;
    }
    sQ[i] = x;
  }
  if (tid < BR) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }
  float acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j] = 0.f;

  const int t_first = r0 / G;
  const int t_last = (min(r0 + BR, rows) - 1) / G;
  const int kv_end = causal ? min(S, t_last + 1) : S;
  const int kv_begin = window > 0 ? max(0, t_first - window + 1) : 0;
  __syncthreads();

  for (int s0 = kv_begin; s0 < kv_end; s0 += BC) {
    for (int i = tid; i < BC * HD; i += NT) {
      const int j = i / HD, d = i % HD, s = s0 + j;
      float kx = 0.f, vx = 0.f;
      if (s < kv_end) {
        kx = to_f(k[b * ks.b + s * ks.s + kh * ks.h + d]);
        vx = to_f(v[b * vs.b + s * vs.s + kh * vs.h + d]);
      }
      sK[j * (HD + 1) + d] = kx;
      sV[j * HD + d] = vx;
    }
    __syncthreads();

    // scores and online-softmax statistics: a warp per row, a lane per key
    for (int r = warp; r < BR; r += NT / 32) {
      const int row = r0 + r, t = row / G, s = s0 + lane;
      bool ok = row < rows && s < kv_end;
      if (causal) ok = ok && s <= t;
      if (window > 0) ok = ok && t - s < window;
      float sc = NEG_INF;
      if (ok) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot += sQ[r * HD + d] * sK[lane * (HD + 1) + d];
        sc = dot;
      }
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, warp_max(sc));
      const float p = ok ? expf(sc - m_new) : 0.f;
      const float l_tile = warp_sum(p);
      sP[r * BC + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[r] = alpha;
        sL[r] = alpha * sL[r] + l_tile;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P · V; thread owns elements tid + j * NT of the BR x HD tile
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * NT, r = i / HD, d = i % HD;
      float a = acc[j] * sA[r];
#pragma unroll 8
      for (int c = 0; c < BC; ++c) a += sP[r * BC + c] * sV[c * HD + d];
      acc[j] = a;
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * NT, r = i / HD, d = i % HD, row = r0 + r;
    if (row < rows) {
      const float l = sL[r] == 0.f ? 1.f : sL[r];
      const int t = row / G, h = kh * G + row % G;
      o[b * os.b + t * os.s + h * os.h + d] = from_f<T>(acc[j] / l);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int T_len, int S, int H,
           int K, Strides qs, Strides ks, Strides vs, Strides os, int causal, int window,
           cudaStream_t stream) {
  constexpr int smem = smem_floats<HD>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int G = H / K;
  const dim3 grid((T_len * G + BR - 1) / BR, K, B);
  const float sm_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  flash_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), T_len, S, G, qs, ks, vs, os, sm_scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B, int T_len,
                int S, int H, int K, Strides qs, Strides ks, Strides vs, Strides os, int causal,
                int window, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, T_len, S, H, K, qs, ks, vs, os, causal, window, st);
    case 32: return launch<T, 32>(q, k, v, o, B, T_len, S, H, K, qs, ks, vs, os, causal, window, st);
    case 64: return launch<T, 64>(q, k, v, o, B, T_len, S, H, K, qs, ks, vs, os, causal, window, st);
    case 128: return launch<T, 128>(q, k, v, o, B, T_len, S, H, K, qs, ks, vs, os, causal, window, st);
    case 256: return launch<T, 256>(q, k, v, o, B, T_len, S, H, K, qs, ks, vs, os, causal, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q (B,T,H,hd), k/v (B,S,K,hd), o (B,T,H,hd); strides in elements, hd unit-stride.
// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window.
// Returns the cudaError_t of the launch (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int T_len,
                        int S, int H, int K, int hd, long long q_sb, long long q_st,
                        long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh, long long o_sb,
                        long long o_st, long long o_sh, int causal, int window, int dtype,
                        void* stream) {
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_st, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || T_len == 0) return 0;
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, B, T_len, S, H, K, qs, ks, vs, os, causal, window, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, T_len, S, H, K, qs, ks, vs, os, causal,
                                      window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block at head_dim hd, in bytes (-1: unsupported hd).
int flash_attention_smem_bytes(int hd) {
  switch (hd) {
    case 16: return smem_floats<16>() * sizeof(float);
    case 32: return smem_floats<32>() * sizeof(float);
    case 64: return smem_floats<64>() * sizeof(float);
    case 128: return smem_floats<128>() * sizeof(float);
    case 256: return smem_floats<256>() * sizeof(float);
    default: return -1;
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
