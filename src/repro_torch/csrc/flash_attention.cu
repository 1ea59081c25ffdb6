// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel): GQA attention with an online softmax, causal and
// sliding-window masks, fp32 running statistics, output in q's dtype.
//
// What bounds it on an H100:
// - recurrentgemma-9b's prefill (T = 2048, 16 query heads on 1 kv head,
//   hd = 256, window 2048, bf16) is bound by operations: 34.4 GFLOP of
//   products, 0.0348 ms at the tensor cores' 989 TFLOP/s, against 35.7 MB of
//   q/k/v/o (0.011 ms). On CUDA cores in fp32 (67 TFLOP/s, and two
//   shared-memory reads per FMA) it cannot come near that.
// - qwen3-4b's (T = 128, H = 32, K = 8, hd = 128) is bound by bytes: 2.6 MB of
//   q/k/v/o, 0.8 us, under a launch; there the design has to keep latency out.
//
// The design, for bf16 inputs (the serving path), flash_fwd_mma_kernel, after
// FlashAttention-2: 4 warps per block, 16 folded query rows per warp (64 per
// block). Both products run on the tensor cores with
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (bf16 operands, fp32
// accumulation). Q.K^T takes Q fragments from registers (hd <= 128; at hd 256
// they are read again from shared memory by ldmatrix to leave room for the
// 128 fp32 accumulators of O) and K from shared memory by ldmatrix; S stays
// in registers, is scaled by sm_scale in fp32, masked, and runs the online
// softmax on the fragments (a row's 4 threads meet by shuffles); P is
// rounded to bf16 in registers (the one rounding the plain version does not
// make) and is the A operand of P.V, with V read by ldmatrix.trans. K/V tiles
// of BC keys (64 at hd <= 128, 32 at hd 256) arrive by 16-byte cp.async in
// rows padded by 16 bytes (ldmatrix without bank conflicts), double-buffered
// so that the next tile loads while the current one is multiplied. Row
// blocks are launched latest-first, so the causal blocks with the most keys
// start first. wgmma with TMA and a producer warp is the next step.
//
// fp32 inputs (the parity path) cannot go through bf16 tensor cores within
// their tolerance; flash_fwd_kernel keeps them on CUDA cores in fp32: S = Q.K^T
// and P live in shared memory one 32x32 tile at a time.
//
// Both kernels: one block per (batch, kv head, tile of folded query rows).
// Row r of the fold is query position r / G and head kv_head * G + r % G, so
// the G query heads of a kv head share each K/V tile. Causal blocks stop at
// the last key the tile's last row can see; windowed blocks start at the first
// key the tile's first row can see. q/k/v are read in place through their
// strides (no host-side pad, fold or transpose); ragged T and S are masked in
// the kernel. Masked lanes contribute an explicit 0 to the softmax, and a row
// whose sum stays 0 is written as zeros.
#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BR = 32;   // folded query rows per block
constexpr int BC = 32;   // keys per tile: one lane per key
constexpr int NT = 256;  // threads per block (8 warps)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// ---- bf16 on the tensor cores ----

constexpr int NTM = 128;  // threads per block of the tensor-core kernel (4 warps)
constexpr int BRM = 64;   // folded query rows per block: 16 per warp

template <int HD> __host__ __device__ constexpr int mma_bc() { return HD <= 128 ? 64 : 32; }  // keys per tile
template <int HD> __host__ __device__ constexpr int mma_rs() { return HD + 8; }  // row stride in shared memory, bf16

template <int HD>
__host__ __device__ constexpr int mma_smem_bytes() {
  return (BRM + 4 * mma_bc<HD>()) * mma_rs<HD>() * 2;  // Q, then K and V double-buffered
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
// c += a (16x16, row) . b (16x8, col), bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(NTM) flash_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int T_len, int S, int G,
    Strides qs, Strides ks, Strides vs, Strides os, float sm_scale, int causal, int window) {
  constexpr int BCM = mma_bc<HD>(), RS = mma_rs<HD>();
  constexpr int KC = HD / 16;    // 16-wide chunks of head_dim (the k of Q.K^T)
  constexpr int NS = BCM / 8;    // 8-key column tiles of S
  constexpr int NO = HD / 8;     // 8-wide column tiles of O
  constexpr int VR = HD / 8;     // 16-byte vectors per row
  constexpr bool Q_IN_REGS = HD <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BRM x RS
  __nv_bfloat16* sK = sQ + BRM * RS;                                 // 2 x BCM x RS
  __nv_bfloat16* sV = sK + 2 * BCM * RS;                             // 2 x BCM x RS

  const int b = blockIdx.z, kh = blockIdx.y;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BRM;  // latest rows first: they see the most keys
  const int rows = T_len * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t_first = r0 / G;
  const int t_last = (min(r0 + BRM, rows) - 1) / G;
  const int kv_end = causal ? min(S, t_last + 1) : S;
  const int kv_begin = window > 0 ? max(0, t_first - window + 1) : 0;

  for (int i = tid; i < BRM * VR; i += NTM) {
    const int r = i / VR, c = (i % VR) * 8, row = r0 + r;
    const __nv_bfloat16* src = q;
    if (row < rows) src = q + b * qs.b + (row / G) * qs.s + (kh * G + row % G) * qs.h + c;
    cp_async16(sQ + r * RS + c, src, row < rows ? 16 : 0);  // rows past the end: zeros
  }
  auto load_kv = [&](int s0, int buf) {
    for (int i = tid; i < BCM * VR; i += NTM) {
      const int j = i / VR, c = (i % VR) * 8, s = s0 + j;
      const bool ok = s < kv_end;
      const __nv_bfloat16* ksrc = k;
      const __nv_bfloat16* vsrc = v;
      if (ok) {
        ksrc = k + b * ks.b + s * ks.s + kh * ks.h + c;
        vsrc = v + b * vs.b + s * vs.s + kh * vs.h + c;
      }
      // keys past kv_end are zero-filled: P is 0 there and V must not be stale
      cp_async16(sK + (buf * BCM + j) * RS + c, ksrc, ok ? 16 : 0);
      cp_async16(sV + (buf * BCM + j) * RS + c, vsrc, ok ? 16 : 0);
    }
  };
  const int ntiles = kv_end > kv_begin ? (kv_end - kv_begin + BCM - 1) / BCM : 0;
  if (ntiles > 0) load_kv(kv_begin, 0);
  cp_async_commit();

  // this thread's two rows of the warp's 16: g and g + 8; columns 2 * tq, 2 * tq + 1 of each tile
  const int g = lane >> 2, tq = lane & 3, wr0 = warp * 16;
  const int row_lo = r0 + wr0 + g, row_hi = row_lo + 8;
  const int t_row[2] = {row_lo / G, row_hi / G};
  const bool row_ok[2] = {row_lo < rows, row_hi < rows};

  float acc_o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc_o[n][0] = acc_o[n][1] = acc_o[n][2] = acc_o[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};  // l: this thread's columns only
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  unsigned qf[Q_IN_REGS ? KC : 1][4];

  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1, s0 = kv_begin + tile * BCM;
    cp_async_wait_all();
    __syncthreads();  // the tile (and Q) landed for every thread; the other buffer is free
    if (tile + 1 < ntiles) load_kv(s0 + BCM, buf ^ 1);
    cp_async_commit();
    const __nv_bfloat16* tK = sK + buf * BCM * RS;
    const __nv_bfloat16* tV = sV + buf * BCM * RS;
    if (Q_IN_REGS && tile == 0) {
#pragma unroll
      for (int kc = 0; kc < (Q_IN_REGS ? KC : 0); ++kc)
        ldmatrix_x4(qf[kc], sQ + (wr0 + (lane & 15)) * RS + kc * 16 + (lane >> 4) * 8);
    }

    // S = Q . K^T on the tensor cores
    float acc_s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) acc_s[n][0] = acc_s[n][1] = acc_s[n][2] = acc_s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      unsigned a[4];
      if constexpr (Q_IN_REGS) {
        a[0] = qf[kc][0]; a[1] = qf[kc][1]; a[2] = qf[kc][2]; a[3] = qf[kc][3];
      } else {
        ldmatrix_x4(a, sQ + (wr0 + (lane & 15)) * RS + kc * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        unsigned bk[4];
        ldmatrix_x4(bk, tK + (np * 16 + (lane & 7) + (lane >> 4) * 8) * RS + kc * 16 + ((lane >> 3) & 1) * 8);
        mma_16816(acc_s[2 * np], a, bk[0], bk[1]);
        mma_16816(acc_s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // scale in fp32, mask, online softmax on the fragments; exponentials in
    // base 2 with log2(e) folded into the scale (m is kept in that domain)
    const bool need_mask = s0 + BCM > kv_end || r0 + BRM > rows ||
                           (causal && s0 + BCM - 1 > t_first) ||
                           (window > 0 && t_last - s0 >= window);  // uniform over the block
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = t_row[hr];
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bool ok = true;
          if (need_mask) {
            const int s = s0 + n * 8 + tq * 2 + e;
            ok = row_ok[hr] && s < kv_end;
            if (causal) ok = ok && s <= t;
            if (window > 0) ok = ok && t - s < window;
          }
          const float x = ok ? acc_s[n][hr * 2 + e] * scale_log2 : NEG_INF;
          acc_s[n][hr * 2 + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hr], mx);
      const float alpha = exp2f(m_run[hr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = acc_s[n][hr * 2 + e];
          const float p = x == NEG_INF ? 0.f : exp2f(x - m_new);  // masked lanes: an explicit 0
          acc_s[n][hr * 2 + e] = p;
          sum += p;
        }
      }
      l_run[hr] = l_run[hr] * alpha + sum;
      m_run[hr] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc_o[n][hr * 2] *= alpha;
        acc_o[n][hr * 2 + 1] *= alpha;
      }
    }

    // O += P . V: P from the S fragments, rounded to bf16; V by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BCM / 16; ++kk) {
      unsigned a[4];
      a[0] = pack_bf16(acc_s[2 * kk][0], acc_s[2 * kk][1]);
      a[1] = pack_bf16(acc_s[2 * kk][2], acc_s[2 * kk][3]);
      a[2] = pack_bf16(acc_s[2 * kk + 1][0], acc_s[2 * kk + 1][1]);
      a[3] = pack_bf16(acc_s[2 * kk + 1][2], acc_s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, tV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + dp * 16 + (lane >> 4) * 8);
        mma_16816(acc_o[2 * dp], a, bv[0], bv[1]);
        mma_16816(acc_o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_run[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (!row_ok[hr]) continue;
    const float inv = l == 0.f ? 0.f : 1.f / l;  // a row whose sum is 0: zeros
    const int row = hr ? row_hi : row_lo;
    __nv_bfloat16* dst = o + b * os.b + (row / G) * os.s + (kh * G + row % G) * os.h + tq * 2;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(acc_o[n][hr * 2] * inv, acc_o[n][hr * 2 + 1] * inv);
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B, int T_len, int S,
               int H, int K, Strides qs, Strides ks, Strides vs, Strides os, int causal,
               int window, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_mma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int G = H / K;
  const dim3 grid((T_len * G + BRM - 1) / BRM, K, B);
  const float sm_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  flash_fwd_mma_kernel<HD><<<grid, NTM, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), T_len, S, G, qs, ks,
      vs, os, sm_scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_hd(int hd, int dtype, const void* q, const void* k, const void* v, void* o, int B,
                int T_len, int S, int H, int K, Strides qs, Strides ks, Strides vs, Strides os,
                int causal, int window, cudaStream_t st) {
#define FLASH_CASE(HD)                                                                         \
  case HD:                                                                                     \
    return dtype == 0 ? launch<float, HD>(q, k, v, o, B, T_len, S, H, K, qs, ks, vs, os,       \
                                          causal, window, st)                                  \
                      : launch_mma<HD>(q, k, v, o, B, T_len, S, H, K, qs, ks, vs, os, causal, \
                                       window, st);
  switch (hd) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}

template <int HD>
int smem_bytes(int dtype) {
  return dtype == 0 ? smem_floats<HD>() * static_cast<int>(sizeof(float)) : mma_smem_bytes<HD>();
}

}  // namespace

extern "C" {

// q (B,T,H,hd), k/v (B,S,K,hd), o (B,T,H,hd); strides in elements, hd unit-stride.
// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; rows of q/k/v
// must start on 16 bytes). window <= 0 means no window.
// Returns the cudaError_t of the launch (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int T_len,
                        int S, int H, int K, int hd, long long q_sb, long long q_st,
                        long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh, long long o_sb,
                        long long o_st, long long o_sh, int causal, int window, int dtype,
                        void* stream) {
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_st, o_sh};
  if (B == 0 || T_len == 0) return 0;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_hd(hd, dtype, q, k, v, o, B, T_len, S, H, K, qs, ks, vs, os, causal, window,
                     static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one block at head_dim hd for dtype (0 fp32, 1
// bf16), in bytes (-1: unsupported hd).
int flash_attention_smem_bytes(int hd, int dtype) {
  switch (hd) {
    case 16: return smem_bytes<16>(dtype);
    case 32: return smem_bytes<32>(dtype);
    case 64: return smem_bytes<64>(dtype);
    case 128: return smem_bytes<128>(dtype);
    case 256: return smem_bytes<256>(dtype);
    default: return -1;
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
