// Paged flash-decode for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// paged_decode_attention (body _decode_kernel): one new query token per
// sequence attends over that sequence's KV pages, found through its page
// table. fp32 running (max, sum, acc); pages past the sequence's length are
// never read and positions >= length are masked; length 0 gives zeros.
//
// What bounds it on an H100: it reads each valid K/V element once, 4096 bytes
// per token at the serving shapes (K = 8, hd = 128, bf16), ~0.66 MB at 160
// tokens, so ~0.2 us of memory time: a launch costs more. The design reads
// pages in place from the (P, page, K, hd) arena, with a stride of K*hd
// between tokens. The TPU wrapper's transpose of the whole arena is not
// carried over: on the serving path that would copy every layer's cache on
// every step. The block reads page_table[b, p] itself, only for the pages
// that hold valid tokens, and the scores and probabilities stay in shared
// memory.
//
// Layout: one block per (sequence, kv head), holding that kv head's G query
// rows. Tokens are visited in tiles of 32 (one lane per token), whatever the
// page size. At B = 1 and K = 8 this fills 8 of the 132 SMs; splitting the
// pages over more blocks with a combine step is later work.
//
// head_dim 256 (recurrentgemma-9b, G = 16 query heads on its one kv head,
// decoding over a 2048-slot ring) is a further instantiation: 100,928 B of
// shared memory at G = 16, and the grid is one block at B = 1, which walks
// the whole 2 MB ring alone.
#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TK = 32;   // tokens per tile: one lane per token
constexpr int NT = 128;  // threads per block (4 warps)
constexpr int MAX_G = 64;
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

struct Args {
  int G, P, page, maxp;
  long long q_sb, q_sh;         // q (B, H, hd)
  long long kv_sp, kv_st, kv_sk;  // arena (P, page, K, hd); k and v share strides
  long long pt_sb;              // page_table (B, maxp) row stride
  long long o_sb, o_sh;         // o (B, H, hd)
  float sm_scale;
};

template <int HD>
int smem_bytes(int G) {
  return (2 * G * HD + TK * (HD + 1) + TK * HD + G * TK + 3 * G + (G & 1)) * sizeof(float) +
         TK * sizeof(long long);
}

template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ pk, const TKV* __restrict__ pv,
    const int* __restrict__ page_table, const int* __restrict__ lengths, TQ* __restrict__ o,
    Args a) {
  extern __shared__ float smem[];
  const int G = a.G;
  float* sQ = smem;                // G x HD, pre-scaled
  float* sAcc = sQ + G * HD;       // G x HD
  float* sK = sAcc + G * HD;       // TK x (HD + 1): padded against bank conflicts
  float* sV = sK + TK * (HD + 1);  // TK x HD
  float* sP = sV + TK * HD;        // G x TK
  float* sM = sP + G * TK;
  float* sL = sM + G;
  float* sA = sL + G;
  long long* sOff = reinterpret_cast<long long*>(sA + G + (G & 1));  // 8-byte aligned

  const int kh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = max(0, min(lengths[b], a.maxp * a.page));

  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    sQ[i] = to_f(q[b * a.q_sb + (kh * G + g) * a.q_sh + d]) * a.sm_scale;
    sAcc[i] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    sM[g] = NEG_INF;
    sL[g] = 0.f;
  }

  for (int p0 = 0; p0 < len; p0 += TK) {
    if (tid < TK) {
      const int pos = p0 + tid;
      long long off = -1;
      if (pos < len) {
        const int pid = min(max(page_table[b * a.pt_sb + pos / a.page], 0), a.P - 1);
        off = pid * a.kv_sp + (pos % a.page) * a.kv_st + kh * a.kv_sk;
      }
      sOff[tid] = off;
    }
    __syncthreads();
    for (int i = tid; i < TK * HD; i += NT) {
      const int j = i / HD, d = i % HD;
      const long long off = sOff[j];
      sK[j * (HD + 1) + d] = off >= 0 ? to_f(pk[off + d]) : 0.f;
      sV[j * HD + d] = off >= 0 ? to_f(pv[off + d]) : 0.f;
    }
    __syncthreads();

    // scores and online-softmax statistics: a warp per query row, a lane per token
    for (int g = warp; g < G; g += NT / 32) {
      const bool ok = p0 + lane < len;
      float sc = NEG_INF;
      if (ok) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot += sQ[g * HD + d] * sK[lane * (HD + 1) + d];
        sc = dot;
      }
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, warp_max(sc));
      const float p = ok ? expf(sc - m_new) : 0.f;
      const float l_tile = warp_sum(p);
      sP[g * TK + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[g] = alpha;
        sL[g] = alpha * sL[g] + l_tile;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * HD; i += NT) {
      const int g = i / HD, d = i % HD;
      float acc = sAcc[i] * sA[g];
#pragma unroll 8
      for (int c = 0; c < TK; ++c) acc += sP[g * TK + c] * sV[c * HD + d];
      sAcc[i] = acc;
    }
    __syncthreads();
  }
  __syncthreads();

  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    const float l = sL[g] == 0.f ? 1.f : sL[g];
    o[b * a.o_sb + (kh * G + g) * a.o_sh + d] = from_f<TQ>(sAcc[i] / l);
  }
}

template <typename TQ, typename TKV, int HD>
int launch(const void* q, const void* pk, const void* pv, const int* pt, const int* lengths,
           void* o, int B, int K, const Args& a, cudaStream_t stream) {
  static int configured = 0;  // largest dynamic shared memory size set so far
  const int smem = smem_bytes<HD>(a.G);
  if (smem > 48 * 1024 && smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_kernel<TQ, TKV, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const dim3 grid(K, B);
  paged_decode_kernel<TQ, TKV, HD><<<grid, NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(pk), static_cast<const TKV*>(pv), pt,
      lengths, static_cast<TQ*>(o), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int dispatch_hd(int hd, const void* q, const void* pk, const void* pv, const int* pt,
                const int* lengths, void* o, int B, int K, const Args& a, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<TQ, TKV, 16>(q, pk, pv, pt, lengths, o, B, K, a, st);
    case 32: return launch<TQ, TKV, 32>(q, pk, pv, pt, lengths, o, B, K, a, st);
    case 64: return launch<TQ, TKV, 64>(q, pk, pv, pt, lengths, o, B, K, a, st);
    case 128: return launch<TQ, TKV, 128>(q, pk, pv, pt, lengths, o, B, K, a, st);
    case 256: return launch<TQ, TKV, 256>(q, pk, pv, pt, lengths, o, B, K, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q (B,H,hd); pages_k/pages_v (P,page,K,hd) with equal strides; page_table
// (B,maxp) int32 with unit column stride; lengths (B,) int32 contiguous;
// o (B,H,hd). Strides in elements, hd unit-stride. q_dtype / kv_dtype:
// 0 = float32, 1 = bfloat16; o has q's dtype. Returns the launch's cudaError_t.
int paged_decode_fwd(const void* q, const void* pk, const void* pv, const void* page_table,
                     const void* lengths, void* o, int B, int H, int K, int hd, int P, int page,
                     int maxp, long long q_sb, long long q_sh, long long kv_sp, long long kv_st,
                     long long kv_sk, long long pt_sb, long long o_sb, long long o_sh,
                     int q_dtype, int kv_dtype, void* stream) {
  if (B == 0) return 0;
  if (K <= 0 || H % K != 0 || H / K > MAX_G || P <= 0 || page <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{H / K, P, page, maxp, q_sb, q_sh, kv_sp, kv_st, kv_sk, pt_sb, o_sb, o_sh,
         static_cast<float>(1.0 / sqrt(static_cast<double>(hd)))};
  const int* pt = static_cast<const int*>(page_table);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return dispatch_hd<float, float>(hd, q, pk, pv, pt, ln, o, B, K, a, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return dispatch_hd<float, __nv_bfloat16>(hd, q, pk, pv, pt, ln, o, B, K, a, st);
  if (q_dtype == 1 && kv_dtype == 0)
    return dispatch_hd<__nv_bfloat16, float>(hd, q, pk, pv, pt, ln, o, B, K, a, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(hd, q, pk, pv, pt, ln, o, B, K, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block at head_dim hd and G query heads per kv
// head, in bytes (-1: unsupported hd).
int paged_decode_smem_bytes(int hd, int G) {
  switch (hd) {
    case 16: return smem_bytes<16>(G);
    case 32: return smem_bytes<32>(G);
    case 64: return smem_bytes<64>(G);
    case 128: return smem_bytes<128>(G);
    case 256: return smem_bytes<256>(G);
    default: return -1;
  }
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
