// RG-LRU linear recurrence (the Griffin / RecurrentGemma recurrent block) for
// Hopper (sm_90a), as a chunked scan over T.
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
// time. A thread per (b, w) channel walking all T steps (the TPU kernel's
// sequential T grid axis turned into a loop) puts only W threads on the card
// at B = 1 (32 blocks of 128 on 132 SMs) and is bound by memory latency.
//
// So T is cut into chunks of L = S * LS = 128 steps, and a block owns one
// (b, chunk, 32-channel) tile: 16 chunks x 128 tiles = 2048 blocks of 256
// threads at the serving shape, 4 on an SM. h over a chunk is
// h_in * prod(a) + (h from zero), so one pass does:
//   1. x/r/i arrive in shared memory by 16-byte cp.async (plain loads where
//      the views are not 16-byte aligned), each warp copying and waiting for
//      the rows and channels it reads; rows past T and channels past W are
//      zeros, which make identity steps (a = exp(0) = 1, u = 0), so a ragged
//      chunk needs no other masking;
//   2. thread (s, w) walks the LS steps of sub-chunk s of channel w from
//      h = 0, keeping a_t and u_t = beta_t * i_t * x_t in registers, and
//      leaves (prod a, h) of its sub-chunk;
//   3. the sub-chunks fold, in order, into the chunk's aggregate
//      (A, U) = (prod a, h from zero), written to a workspace, then a flag
//      with release semantics;
//   4. the c chunks before it are cut into S runs; the threads of sub-chunk
//      s wait for the flags of run s and fold its aggregates in order from
//      the identity; every thread then folds the S runs in order from h0
//      (h entering the chunk) and on through the sub-chunks before its own;
//   5. each thread runs its LS steps again from there, from the a_t and u_t
//      it kept; y goes through the warp's own rows of the x plane and out in
//      16-byte pieces; the last chunk writes h_last.
// A block takes its tile from a ticket (an atomic counter, chunk-major), not
// from blockIdx, so every block of an earlier chunk has started before it
// and publishes before it waits: no block waits on one that is not
// resident. Nothing is folded in an order that depends on timing (no
// look-back that takes whatever prefix is ready), so the output is
// bit-identical from call to call and under CUDA-graph replay. The ticket
// and the flags live in a workspace the caller allocates per call and that
// rglru_scan_fwd zeroes with cudaMemsetAsync on the call's stream. A
// thread's dependent chain is 2 * LS steps and about c / S + 2 S folds.
// a_t and beta_t use expf and sqrtf, as the plain version does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CW = 32;         // channels of a tile
constexpr int LS = 16;         // steps a thread walks: one sub-chunk
constexpr int S = 8;           // sub-chunks of a chunk
constexpr int MIN_BLOCKS = 4;  // blocks an SM must hold at once (caps the registers at 64)
constexpr int L = S * LS;   // steps of a chunk
constexpr int NT = CW * S;  // threads of a block: (sub-chunk s, channel w); a warp is 32 channels of one s
constexpr float C = 8.0f;
static_assert(CW % 32 == 0, "a warp is 32 channels of one sub-chunk");

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

struct Params {
  const void* x;
  const void* r;
  const void* i;
  const float* lam;
  const float* h0;  // (B, W) or null
  void* y;
  float* h_last;
  int B, T, W, n_chunks, n_tiles;
  Strides xs, rs, is;
  int vec;          // 1: 16-byte cp.async (16-byte aligned views); 0: plain loads
  unsigned* ticket;  // zeroed per call
  unsigned* flags;   // (B, n_tiles, n_chunks), zeroed per call
  float2* agg;       // (B, n_chunks, n_tiles * CW): each chunk's (prod a, h from zero)
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Issues the copies of the rows and channels of x, r, i that the calling warp
// reads (the LS rows of its sub-chunk, its 32 channels) into their places in
// the three (L, CW) planes of the tile in shared memory; rows past T and
// channels past W are zeros. Each warp waits for its own copies
// (wait_warp_tile), so no block barrier follows. Views that are not 16-byte
// aligned are read by plain loads, waited for here.
template <typename T>
__device__ __forceinline__ void load_warp_tile(const Params& p, T* tile, int b, int t_sub, int w_warp) {
  const int lane = threadIdx.x % 32;
  const T* src[3] = {static_cast<const T*>(p.x) + b * p.xs.b, static_cast<const T*>(p.r) + b * p.rs.b,
                     static_cast<const T*>(p.i) + b * p.is.b};
  const long long st[3] = {p.xs.t, p.rs.t, p.is.t};
  T* dst = tile + (t_sub % L) * CW + w_warp % CW;
  if (p.vec) {
    constexpr int PER = 16 / sizeof(T);  // elements of a 16-byte piece
    constexpr int PPR = 32 / PER;        // pieces of a warp's row
#pragma unroll
    for (int plane = 0; plane < 3; ++plane) {
#pragma unroll
      for (int q = lane; q < LS * PPR; q += 32) {
        const int row = q / PPR, wc = w_warp + (q % PPR) * PER, t = t_sub + row;
        const int bytes = t < p.T && wc < p.W ? min(PER, p.W - wc) * static_cast<int>(sizeof(T)) : 0;
        const T* g = bytes ? src[plane] + t * st[plane] + wc : src[plane];
        cp_async16(dst + (plane * L + row) * CW + (q % PPR) * PER, g, bytes);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
#pragma unroll
    for (int plane = 0; plane < 3; ++plane) {
#pragma unroll 1
      for (int row = 0; row < LS; ++row) {
        const int t = t_sub + row, wc = w_warp + lane;
        dst[(plane * L + row) * CW + lane] = t < p.T && wc < p.W ? src[plane][t * st[plane] + wc] : from_f<T>(0.f);
      }
    }
  }
}
__device__ __forceinline__ void wait_warp_tile() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) rglru_chunk_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);  // planes x, r, i, each (L, CW)
  __shared__ float sub_a[S][CW], sub_h[S][CW], runs_a[S][CW], runs_u[S][CW];
  __shared__ unsigned ticket;
  const int wl = threadIdx.x % CW, s = threadIdx.x / CW;

  // tiles in ticket order: chunk-major, so every block of an earlier chunk has started
  if (threadIdx.x == 0) ticket = atomicAdd(p.ticket, 1u);
  __syncthreads();
  const unsigned blk = ticket;
  const int per_chunk = p.B * p.n_tiles;
  const int c = blk / per_chunk, b = (blk % per_chunk) / p.n_tiles, tile_w = blk % p.n_tiles;
  const int w = tile_w * CW + wl, t_sub = c * L + s * LS;
  load_warp_tile<T>(p, tile, b, t_sub, w - wl % 32);

  // 2. the sub-chunk from h = 0, a_t and u_t kept
  const float l = w < p.W ? p.lam[w] : 0.f;
  const float base = -C * (fmaxf(l, 0.f) + log1pf(expf(-fabsf(l))));
  float a[LS], u[LS], prod = 1.f, h = 0.f;
  wait_warp_tile();
#pragma unroll
  for (int k = 0; k < LS; ++k) {  // zeros past T give a = exp(0) = 1 and u = 0 exactly: identity steps
    const int e = (s * LS + k) * CW + wl;
    const float log_a = to_f(tile[L * CW + e]) * base;
    a[k] = expf(log_a);
    const float beta = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f));
    u[k] = beta * (to_f(tile[2 * L * CW + e]) * to_f(tile[e]));
    h = a[k] * h + u[k];
    prod *= a[k];
  }
  sub_a[s][wl] = prod;
  sub_h[s][wl] = h;
  __syncthreads();

  // 3. the chunk's aggregate, published for the chunks after it by the CW
  //    threads of sub-chunk 0, then one release of the chunk's flag
  const long long agg_row = static_cast<long long>(p.n_tiles) * CW;
  float2* agg = p.agg + static_cast<long long>(b) * p.n_chunks * agg_row + w;
  unsigned* flag = p.flags + (b * p.n_tiles + tile_w) * p.n_chunks;
  if (c + 1 < p.n_chunks && s == 0) {
    float A = sub_a[0][wl], U = sub_h[0][wl];
    for (int j = 1; j < S; ++j) {
      U = sub_a[j][wl] * U + sub_h[j][wl];
      A *= sub_a[j][wl];
    }
    agg[c * agg_row] = make_float2(A, U);
    asm volatile("bar.sync 1, %0;\n" ::"n"(CW) : "memory");
    if (threadIdx.x == 0) st_release(flag + c, 1u);
  }

  // 4. h entering the chunk. The c earlier chunks are cut into S runs; the
  //    threads of sub-chunk s wait for the flags of run s and fold its
  //    aggregates in order from the identity. Every thread then folds the S
  //    runs in order from h0, and on through the sub-chunks before its own.
  const int run = (c + S - 1) / S, k0 = min(c, s * run), k1 = min(c, k0 + run);
  for (int k = k0 + threadIdx.x % 32; k < k1; k += 32) {
    while (ld_acquire(flag + k) == 0u) __nanosleep(32);
  }
  __syncwarp();
  float run_a = 1.f, run_u = 0.f;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float2 g = __ldcg(agg + k * agg_row);
    run_u = g.x * run_u + g.y;
    run_a *= g.x;
  }
  runs_a[s][wl] = run_a;
  runs_u[s][wl] = run_u;
  __syncthreads();
  h = p.h0 != nullptr && w < p.W ? p.h0[static_cast<long long>(b) * p.W + w] : 0.f;
  for (int j = 0; j < S; ++j) h = runs_a[j][wl] * h + runs_u[j][wl];
  for (int j = 0; j < s; ++j) h = sub_a[j][wl] * h + sub_h[j][wl];

  // 5. the sub-chunk again from there; y goes through the warp's own rows of
  //    the x plane and out in 16-byte pieces (element by element where a row
  //    of y is not 16-byte aligned or the warp's channels pass W)
  const int warp_w = w - wl % 32, lane = wl % 32;
  T* y_tile = tile + s * LS * CW + warp_w % CW;
#pragma unroll
  for (int k = 0; k < LS; ++k) {
    h = a[k] * h + u[k];
    y_tile[k * CW + lane] = from_f<T>(h);
  }
  __syncwarp();
  T* y = static_cast<T*>(p.y) + (static_cast<long long>(b) * p.T + t_sub) * p.W + warp_w;
  if ((p.W * sizeof(T)) % 16 == 0 && warp_w + 32 <= p.W) {
    constexpr int PER = 16 / sizeof(T), PPR = 32 / PER;
#pragma unroll
    for (int q = lane; q < LS * PPR; q += 32) {
      const int row = q / PPR, col = (q % PPR) * PER;
      if (t_sub + row < p.T) {
        *reinterpret_cast<uint4*>(y + static_cast<long long>(row) * p.W + col) =
            *reinterpret_cast<const uint4*>(y_tile + row * CW + col);
      }
    }
  } else {
    for (int k = 0; k < LS; ++k) {
      if (t_sub + k < p.T && w < p.W) y[static_cast<long long>(k) * p.W + lane] = y_tile[k * CW + lane];
    }
  }
  if (c + 1 == p.n_chunks && s == S - 1 && w < p.W) p.h_last[static_cast<long long>(b) * p.W + w] = h;
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = 3 * L * CW * sizeof(T);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(rglru_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  rglru_chunk_kernel<T><<<p.B * p.n_chunks * p.n_tiles, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

int n_chunks(int T_len) { return (T_len + L - 1) / L; }
int n_tiles(int W) { return (W + CW - 1) / CW; }
size_t flags_bytes(int B, int T_len, int W) {  // the ticket, then the flags, in 16-byte units
  return (16 + 4 * static_cast<size_t>(B) * n_tiles(W) * n_chunks(T_len) + 15) / 16 * 16;
}

}  // namespace

extern "C" {

// Bytes of the workspace rglru_scan_fwd takes for (B, T, W): the ticket and
// the flags, then the chunk aggregates.
long long rglru_scan_workspace_bytes(int B, int T_len, int W) {
  return static_cast<long long>(flags_bytes(B, T_len, W)) +
         8LL * B * n_chunks(T_len) * n_tiles(W) * CW;
}

// x, r, i (B,T,W) of one dtype with unit stride along W, strides in elements;
// lam (W,) fp32; h0 (B,W) fp32 contiguous or null (zeros); y (B,T,W)
// contiguous in x's dtype; h_last (B,W) fp32 contiguous; workspace of
// rglru_scan_workspace_bytes, 16-byte aligned, any contents. dtype: 0 =
// float32, 1 = bfloat16. Returns the cudaError_t of the launch (0 on success).
int rglru_scan_fwd(const void* x, const void* r, const void* i, const void* lam, const void* h0,
                   void* y, void* h_last, void* workspace, int B, int T_len, int W, long long x_sb,
                   long long x_st, long long r_sb, long long r_st, long long i_sb, long long i_st,
                   int dtype, void* stream) {
  if (B == 0 || W == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t state_bytes = static_cast<size_t>(B) * W * sizeof(float);
  if (T_len == 0) {  // no step: h_last is h0
    return static_cast<int>(h0 != nullptr
        ? cudaMemcpyAsync(h_last, h0, state_bytes, cudaMemcpyDeviceToDevice, st)
        : cudaMemsetAsync(h_last, 0, state_bytes, st));
  }
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t es = dtype == 0 ? 4 : 2;
  const auto aligned = [es](const void* ptr, long long sb, long long stt) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (sb * es) % 16 == 0 && (stt * es) % 16 == 0;
  };
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  Params p{x, r, i, static_cast<const float*>(lam), static_cast<const float*>(h0), y,
           static_cast<float*>(h_last), B, T_len, W, n_chunks(T_len), n_tiles(W),
           Strides{x_sb, x_st}, Strides{r_sb, r_st}, Strides{i_sb, i_st},
           aligned(x, x_sb, x_st) && aligned(r, r_sb, r_st) && aligned(i, i_sb, i_st),
           reinterpret_cast<unsigned*>(ws), reinterpret_cast<unsigned*>(ws + 16),
           reinterpret_cast<float2*>(ws + flags_bytes(B, T_len, W))};
  cudaError_t e = cudaMemsetAsync(ws, 0, flags_bytes(B, T_len, W), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(dtype == 0 ? launch<float>(p, st) : launch<__nv_bfloat16>(p, st));
}

const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
