// Paged flash-decode for Hopper (sm_90a): split over the sequence, then combine.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// paged_decode_attention (body _decode_kernel): one new query token per
// sequence attends over that sequence's KV pages, found through its page
// table. fp32 scores and online softmax; positions >= length are never read
// and are masked; length 0 gives zeros.
//
// What bounds it on an H100: bytes. Each valid K/V element is read once:
// 2.11 MB over recurrentgemma-9b's full 2048-slot ring (hd 256, one kv head,
// bf16), 0.67 MB at qwen3-4b's 160 tokens (hd 128, 8 kv heads), so 0.63 and
// 0.20 us at 3.35 TB/s. The TPU kernel walks the pages along a sequential grid
// axis; one block per (sequence, kv head) doing the same on this card is one
// block at B = 1 with MQA, waiting on each tile's loads in turn.
//
// The design (flash-decode):
// 1. paged_decode_partial_kernel, grid (splits, K, B), 128 threads. Each
//    block takes one contiguous range of split_len token positions (whole
//    16-token tiles) of one (sequence, kv head) and its G query rows. The
//    host picks splits from the page table's capacity (the lengths live on
//    the device), so that B * K * splits fills the 132 SMs where it can. The
//    block reads its pages' ids into shared memory, then streams 16-token
//    K/V tiles with 16-byte cp.async into a double buffer, the next tile's
//    copies in flight while the current tile is multiplied. Tokens past the
//    length are zero-filled by the copy itself. Scores: a half-warp per query
//    row, a lane per token, 16-byte K reads from rows padded by 16 bytes (no
//    bank conflicts), q pre-scaled by 1/sqrt(hd) in fp32 shared memory; the
//    online softmax runs on half-warp shuffles with (m, l) in registers. P.V
//    runs a thread per (row, 16-byte column of V). A split wholly past the
//    length reads nothing and writes an empty partial (m = -1e30, l = 0,
//    acc = 0). Each block writes (m, l, acc[G, hd]) in fp32 to a workspace.
// 2. paged_decode_combine_kernel, grid (H, B): rescales each split's partial
//    by exp(m_s - m_max), sums, divides by the total l, and writes zeros where
//    that total is 0.
#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;  // tokens per tile: one lane of a half-warp per token
constexpr int NT = 128;   // threads per block of the partial kernel (4 warps)
constexpr int NTC = 128;  // threads per block of the combine kernel
constexpr int MAX_G = 64;
constexpr int MAX_ROW_ITERS = MAX_G * TILE / NT;  // (row, token) pairs per thread
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of K or V as fp32: 4 floats or 8 bf16
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ float half_max(float x) {  // over the 16 lanes of a half-warp
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  int G, P, page, maxp, split_len, splits;
  long long q_sb, q_sh;           // q (B, H, hd)
  long long kv_sp, kv_st, kv_sk;  // arena (P, page, K, hd); k and v share strides
  long long pt_sb;                // page_table (B, maxp) row stride
  long long o_sb, o_sh;           // o (B, H, hd)
  float sm_scale;
};

// page ids one split can touch: split_len tokens starting anywhere in a page
__host__ __device__ inline int split_pages(int split_len, int page) {
  return (split_len + page - 1) / page + 1;
}

template <typename TKV, int HD>
__host__ __device__ constexpr int row_elems() {  // a K/V row in shared memory, padded by 16 bytes
  return HD + Vec<TKV>::N;
}

template <typename TKV, int HD>
int smem_bytes(int G, int npid) {
  return 2 * G * HD * sizeof(float)                            // sQ, sAcc
         + 2 * 2 * TILE * row_elems<TKV, HD>() * sizeof(TKV)  // K, V double buffers
         + (G * TILE + G) * sizeof(float)                     // sP, sAlpha
         + ((npid + 3) / 4) * 4 * sizeof(int);
}

// Copies the 16-token K/V tile starting at position p0 into sK/sV (rows of
// RS elements) by 16-byte cp.async, as one commit group. A token at or past
// t1 is zero-filled (src size 0), so P.V sees 0 there, not stale data.
template <typename TKV, int HD>
__device__ __forceinline__ void load_tile(TKV* sK, TKV* sV, const TKV* __restrict__ pk,
                                          const TKV* __restrict__ pv, const int* sPid,
                                          const Args& a, int kh, int p0, int t1, int first_page,
                                          int tid) {
  constexpr int VN = Vec<TKV>::N, VPR = HD / VN, RS = row_elems<TKV, HD>();
  for (int i = tid; i < TILE * VPR; i += NT) {
    const int j = i / VPR, c = (i % VPR) * VN, pos = p0 + j;
    const bool ok = pos < t1;
    long long off = 0;
    if (ok) off = sPid[pos / a.page - first_page] * a.kv_sp + (pos % a.page) * a.kv_st + kh * a.kv_sk;
    cp_async16(sK + j * RS + c, pk + off + c, ok ? 16 : 0);
    cp_async16(sV + j * RS + c, pv + off + c, ok ? 16 : 0);
  }
  cp_async_commit();
}

template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(NT) paged_decode_partial_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ pk, const TKV* __restrict__ pv,
    const int* __restrict__ page_table, const int* __restrict__ lengths,
    float* __restrict__ ws_ml, float* __restrict__ ws_acc, Args a) {
  constexpr int VN = Vec<TKV>::N;   // elements per 16-byte vector
  constexpr int VPR = HD / VN;      // vectors per K/V row
  constexpr int RS = row_elems<TKV, HD>();
  static_assert(HD % VN == 0, "head_dim must be whole 16-byte vectors");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = a.G;
  float* sQ = reinterpret_cast<float*>(smem_raw);  // G x HD, pre-scaled
  float* sAcc = sQ + G * HD;                         // G x HD
  TKV* sK = reinterpret_cast<TKV*>(sAcc + G * HD);   // 2 x TILE x RS
  TKV* sV = sK + 2 * TILE * RS;                      // 2 x TILE x RS
  float* sP = reinterpret_cast<float*>(sV + 2 * TILE * RS);  // G x TILE
  float* sAlpha = sP + G * TILE;                     // G
  int* sPid = reinterpret_cast<int*>(sAlpha + G);

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, hlane = tid & 15;
  const int len = max(0, min(lengths[b], a.maxp * a.page));
  const int t0 = split * a.split_len;
  const int t1 = min(t0 + a.split_len, len);
  const long long part = (static_cast<long long>(b) * gridDim.y + kh) * a.splits + split;
  float* acc_out = ws_acc + part * G * HD;
  float* ml_out = ws_ml + part * G * 2;

  if (t0 >= t1) {  // the split lies wholly past the length: an empty partial
    for (int i = tid; i < G * HD; i += NT) acc_out[i] = 0.f;
    for (int g = tid; g < G; g += NT) {
      ml_out[2 * g] = NEG_INF;
      ml_out[2 * g + 1] = 0.f;
    }
    return;
  }

  const int first_page = t0 / a.page;
  const int npid = (t1 - 1) / a.page - first_page + 1;
  for (int i = tid; i < npid; i += NT)
    sPid[i] = min(max(page_table[b * a.pt_sb + first_page + i], 0), a.P - 1);
  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    sQ[i] = to_f(q[b * a.q_sb + (kh * G + g) * a.q_sh + d]) * a.sm_scale;
    sAcc[i] = 0.f;
  }
  __syncthreads();

  const int ntiles = (t1 - t0 + TILE - 1) / TILE;
  float m_run[MAX_ROW_ITERS], l_run[MAX_ROW_ITERS];
#pragma unroll
  for (int r = 0; r < MAX_ROW_ITERS; ++r) {
    m_run[r] = NEG_INF;
    l_run[r] = 0.f;
  }

  load_tile<TKV, HD>(sK, sV, pk, pv, sPid, a, kh, t0, t1, first_page, tid);
  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    cp_async_wait_all();
    __syncthreads();  // tile landed for every thread; the other buffer is free
    if (tile + 1 < ntiles)
      load_tile<TKV, HD>(sK + (buf ^ 1) * TILE * RS, sV + (buf ^ 1) * TILE * RS, pk, pv, sPid, a, kh,
                         t0 + (tile + 1) * TILE, t1, first_page, tid);
    const TKV* tK = sK + buf * TILE * RS;
    const TKV* tV = sV + buf * TILE * RS;
    const int p0 = t0 + tile * TILE;

    // scores and online-softmax statistics: a half-warp per query row, a lane per token
#pragma unroll
    for (int r = 0; r < MAX_ROW_ITERS; ++r) {
      if (r * NT >= G * TILE) continue;  // uniform over the block
      const int pair = r * NT + tid;
      const int g = min(pair / TILE, G - 1);
      const bool ok = pair < G * TILE && p0 + hlane < t1;
      float dot = 0.f;
      const float* qrow = sQ + g * HD;
      const TKV* krow = tK + hlane * RS;
#pragma unroll 4
      for (int c = 0; c < HD; c += VN) {
        float kx[VN];
        Vec<TKV>::load(krow + c, kx);
#pragma unroll
        for (int e = 0; e < VN; e += 4) {
          const float4 qx = *reinterpret_cast<const float4*>(qrow + c + e);
          dot += qx.x * kx[e] + qx.y * kx[e + 1] + qx.z * kx[e + 2] + qx.w * kx[e + 3];
        }
      }
      const float sc = ok ? dot : NEG_INF;
      const float m_new = fmaxf(m_run[r], half_max(sc));
      const float p = ok ? expf(sc - m_new) : 0.f;
      const float l_tile = half_sum(p);
      const float alpha = expf(m_run[r] - m_new);
      l_run[r] = alpha * l_run[r] + l_tile;
      m_run[r] = m_new;
      if (pair < G * TILE) {
        sP[g * TILE + hlane] = p;
        if (hlane == 0) sAlpha[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V: a thread per (row, 16-byte column of V)
    for (int u = tid; u < G * VPR; u += NT) {
      const int g = u / VPR, c = (u % VPR) * VN;
      float* accp = sAcc + g * HD + c;
      const float al = sAlpha[g];
      float acc[VN];
#pragma unroll
      for (int e = 0; e < VN; ++e) acc[e] = accp[e] * al;
#pragma unroll 4
      for (int j = 0; j < TILE; ++j) {
        const float p = sP[g * TILE + j];
        float vx[VN];
        Vec<TKV>::load(tV + j * RS + c, vx);
#pragma unroll
        for (int e = 0; e < VN; ++e) acc[e] += p * vx[e];
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) accp[e] = acc[e];
    }
    // the next iteration's __syncthreads orders these writes before the reads
  }
  __syncthreads();

  for (int i = tid; i < G * HD; i += NT) acc_out[i] = sAcc[i];
#pragma unroll
  for (int r = 0; r < MAX_ROW_ITERS; ++r) {
    if (r * NT >= G * TILE) continue;
    const int pair = r * NT + tid;
    if (pair < G * TILE && hlane == 0) {
      const int g = pair / TILE;
      ml_out[2 * g] = m_run[r];
      ml_out[2 * g + 1] = l_run[r];
    }
  }
}

// One block per (query head, sequence): o = sum_s w_s acc_s / sum_s w_s l_s,
// w_s = exp(m_s - max m), zeros where the total l is 0.
template <typename TQ, int HD>
__global__ void __launch_bounds__(NTC) paged_decode_combine_kernel(
    const float* __restrict__ ws_ml, const float* __restrict__ ws_acc, TQ* __restrict__ o,
    int G, int splits, long long o_sb, long long o_sh) {
  constexpr int V4 = HD / 4;       // float4 columns of a row: 4 to 64
  constexpr int SL = NTC / V4;     // splits summed side by side: 2 to 32
  static_assert(NTC % V4 == 0, "a block covers whole rows");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* sSum = reinterpret_cast<float4*>(smem_raw);  // SL x V4 = NTC
  float* sW = reinterpret_cast<float*>(sSum + SL * V4);  // splits
  __shared__ float sRed[NTC / 32];
  __shared__ float sMax, sL;

  const int h = blockIdx.x, b = blockIdx.y, kh = h / G, g = h % G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long part0 = (static_cast<long long>(b) * gridDim.x / G + kh) * splits;
  const float* ml = ws_ml + part0 * G * 2 + g * 2;  // split s at ml[s * 2G]

  float mx = NEG_INF;
  for (int s = tid; s < splits; s += NTC) mx = fmaxf(mx, ml[s * 2 * G]);
  for (int o2 = 16; o2 > 0; o2 >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
  if (lane == 0) sRed[warp] = mx;
  __syncthreads();
  if (tid == 0) {
    float m = sRed[0];
    for (int w = 1; w < NTC / 32; ++w) m = fmaxf(m, sRed[w]);
    sMax = m;
  }
  __syncthreads();
  const float m_max = sMax;
  float lsum = 0.f;
  for (int s = tid; s < splits; s += NTC) {
    const float w = expf(ml[s * 2 * G] - m_max);
    sW[s] = w;
    lsum += w * ml[s * 2 * G + 1];
  }
  for (int o2 = 16; o2 > 0; o2 >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, o2);
  __syncthreads();  // sRed reused
  if (lane == 0) sRed[warp] = lsum;
  __syncthreads();
  if (tid == 0) {
    float l = 0.f;
    for (int w = 0; w < NTC / 32; ++w) l += sRed[w];
    sL = l;
  }
  __syncthreads();

  const int c = tid % V4, sl = tid / V4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = sl; s < splits; s += SL) {
    const float w = sW[s];
    const float4 x = *reinterpret_cast<const float4*>(ws_acc + ((part0 + s) * G + g) * HD + 4 * c);
    acc.x += w * x.x; acc.y += w * x.y; acc.z += w * x.z; acc.w += w * x.w;
  }
  sSum[sl * V4 + c] = acc;
  __syncthreads();
  if (tid < V4) {
    float4 t = sSum[tid];
    for (int k = 1; k < SL; ++k) {
      const float4 x = sSum[k * V4 + tid];
      t.x += x.x; t.y += x.y; t.z += x.z; t.w += x.w;
    }
    const float l = sL;
    const float inv = l == 0.f ? 0.f : 1.f / l;
    TQ* out = o + b * o_sb + h * o_sh + 4 * tid;
    out[0] = from_f<TQ>(t.x * inv);
    out[1] = from_f<TQ>(t.y * inv);
    out[2] = from_f<TQ>(t.z * inv);
    out[3] = from_f<TQ>(t.w * inv);
  }
}

int combine_smem_bytes(int splits) {  // sSum (one float4 a thread), then sW
  return NTC * static_cast<int>(sizeof(float4)) + splits * static_cast<int>(sizeof(float));
}

template <typename TQ, typename TKV, int HD>
int launch(const void* q, const void* pk, const void* pv, const int* pt, const int* lengths,
           float* ws_ml, float* ws_acc, void* o, int B, int K, const Args& a, cudaStream_t stream) {
  static int configured = 0;  // largest dynamic shared memory size set so far
  const int smem = smem_bytes<TKV, HD>(a.G, split_pages(a.split_len, a.page));
  if (smem > 48 * 1024 && smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_partial_kernel<TQ, TKV, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  paged_decode_partial_kernel<TQ, TKV, HD><<<dim3(a.splits, K, B), NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(pk), static_cast<const TKV*>(pv), pt,
      lengths, ws_ml, ws_acc, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  static int configured_c = 0;
  const int smem_c = combine_smem_bytes(a.splits);
  if (smem_c > 48 * 1024 && smem_c > configured_c) {
    e = cudaFuncSetAttribute(paged_decode_combine_kernel<TQ, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_c);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured_c = smem_c;
  }
  paged_decode_combine_kernel<TQ, HD><<<dim3(K * a.G, B), NTC, smem_c, stream>>>(
      ws_ml, ws_acc, static_cast<TQ*>(o), a.G, a.splits, a.o_sb, a.o_sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int dispatch_hd(int hd, const void* q, const void* pk, const void* pv, const int* pt,
                const int* lengths, float* ws_ml, float* ws_acc, void* o, int B, int K,
                const Args& a, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<TQ, TKV, 16>(q, pk, pv, pt, lengths, ws_ml, ws_acc, o, B, K, a, st);
    case 32: return launch<TQ, TKV, 32>(q, pk, pv, pt, lengths, ws_ml, ws_acc, o, B, K, a, st);
    case 64: return launch<TQ, TKV, 64>(q, pk, pv, pt, lengths, ws_ml, ws_acc, o, B, K, a, st);
    case 128: return launch<TQ, TKV, 128>(q, pk, pv, pt, lengths, ws_ml, ws_acc, o, B, K, a, st);
    case 256: return launch<TQ, TKV, 256>(q, pk, pv, pt, lengths, ws_ml, ws_acc, o, B, K, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TKV>
int smem_for(int hd, int G, int npid) {
  switch (hd) {
    case 16: return smem_bytes<TKV, 16>(G, npid);
    case 32: return smem_bytes<TKV, 32>(G, npid);
    case 64: return smem_bytes<TKV, 64>(G, npid);
    case 128: return smem_bytes<TKV, 128>(G, npid);
    case 256: return smem_bytes<TKV, 256>(G, npid);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// q (B,H,hd); pages_k/pages_v (P,page,K,hd) with equal strides, 16-byte
// aligned rows; page_table (B,maxp) int32 with unit column stride; lengths
// (B,) int32 contiguous; o (B,H,hd). ws_ml (B,K,splits,G,2) and ws_acc
// (B,K,splits,G,hd) fp32 contiguous scratch. Split s covers token positions
// [s * split_len, (s + 1) * split_len). Strides in elements, hd unit-stride.
// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16; o has q's dtype. Launches
// the partial and the combine kernel; returns the first cudaError_t.
int paged_decode_fwd(const void* q, const void* pk, const void* pv, const void* page_table,
                     const void* lengths, void* ws_ml, void* ws_acc, void* o, int B, int H, int K,
                     int hd, int P, int page, int maxp, int split_len, int splits, long long q_sb,
                     long long q_sh, long long kv_sp, long long kv_st, long long kv_sk,
                     long long pt_sb, long long o_sb, long long o_sh, int q_dtype, int kv_dtype,
                     void* stream) {
  if (B == 0) return 0;
  if (K <= 0 || H % K != 0 || H / K > MAX_G || P <= 0 || page <= 0 || splits <= 0 ||
      split_len <= 0 || split_len % TILE != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{H / K, P, page, maxp, split_len, splits, q_sb, q_sh, kv_sp, kv_st, kv_sk, pt_sb,
         o_sb, o_sh, static_cast<float>(1.0 / sqrt(static_cast<double>(hd)))};
  const int* pt = static_cast<const int*>(page_table);
  const int* ln = static_cast<const int*>(lengths);
  float* ml = static_cast<float*>(ws_ml);
  float* acc = static_cast<float*>(ws_acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return dispatch_hd<float, float>(hd, q, pk, pv, pt, ln, ml, acc, o, B, K, a, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return dispatch_hd<float, __nv_bfloat16>(hd, q, pk, pv, pt, ln, ml, acc, o, B, K, a, st);
  if (q_dtype == 1 && kv_dtype == 0)
    return dispatch_hd<__nv_bfloat16, float>(hd, q, pk, pv, pt, ln, ml, acc, o, B, K, a, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(hd, q, pk, pv, pt, ln, ml, acc, o, B, K, a,
                                                     st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block of the partial kernel at head_dim hd,
// G query heads per kv head, pages of `page` tokens and splits of split_len
// tokens, in bytes (-1: unsupported hd or dtype). kv_dtype: 0 fp32, 1 bf16.
int paged_decode_smem_bytes(int hd, int G, int kv_dtype, int page, int split_len) {
  const int npid = split_pages(split_len, page);
  if (kv_dtype == 0) return smem_for<float>(hd, G, npid);
  if (kv_dtype == 1) return smem_for<__nv_bfloat16>(hd, G, npid);
  return -1;
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
