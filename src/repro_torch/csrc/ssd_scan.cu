// Mamba-2 SSD chunk kernels, for Hopper (sm_90a).
//
// Replace the two TPU kernels of src/repro/kernels/ssd_scan.py::ssd_chunked_pallas:
//   ssd_states_kernel  <- _states_kernel (pallas_call at :85): per (batch, chunk,
//                         head) the intra-chunk output y_diag = (C·Bᵀ ⊙ L)·x with
//                         L = exp(cum_i - cum_j) for i >= j, and the chunk state
//                         S = xᵀ·(B ⊙ exp(cum[-1] - cum)); both fp32.
//   ssd_output_kernel  <- _output_kernel (pallas_call at :117):
//                         y = y_diag + (C ⊙ exp(cum))·H_inᵀ, written in x's dtype.
// The inter-chunk recurrence between them (nc steps of an elementwise update)
// stays in PyTorch, as the reference keeps it in a host lax.scan.
//
// What bounds them on an H100: at the serving shape of mamba2-1.3b (b 1,
// t 1024, h 64, p 64, n 128, chunk 256, bf16) each call moves ~34 MB (the
// fp32 y_diag and S dominate) and ssd_states does ~2 GFLOP of products, so
// both are memory-bound: ~10 us each at 3.35 TB/s.
//
// Design. The TPU program holds a whole chunk (~0.7 MiB) in VMEM; a block here
// has at most 227 KB of shared memory, so ssd_states tiles like a causal flash
// loop without a softmax: a block owns BR rows i of one (batch, chunk, head)
// and streams BC-wide j-tiles of B and x up to the diagonal, with the BR x BC
// score tile in shared memory only. The chunk state S is a second reduction
// over j: the same launch carries extra blocks per (batch, chunk, head), each
// owning 4·NT elements of the p x n state. Each block computes the chunk's
// cumsum of dA itself with a warp-shuffle scan (one element per thread, so a
// chunk is at most NT = 256 long). C·Bᵀ does not depend on the head when
// g = 1, but it is recomputed per head, as on the TPU: sharing it, tensor
// cores (wgmma) and TMA are later work. All products run in fp32 on CUDA cores.
// Inputs are read in place through their strides (B and C are views into the
// model's fused xBC activation), and positions t >= T_len of the last chunk are
// masked in the kernels as identity steps (dA = 0, x = B = C = 0), so the host
// pads nothing; y is written straight into (b, t, h, p).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;             // threads per block (8 warps)
constexpr int BR = 32;              // chunk rows i per block
constexpr int BC = 32;              // chunk columns j per tile: one lane per column
constexpr int MAX_CHUNK = NT;       // the cumsum gives each thread one position
constexpr int MAX_STATE = 256;      // n; bounds shared memory
constexpr int STATE_PER_THREAD = 4;
constexpr int STATE_TILE = STATE_PER_THREAD * NT;  // state elements per state block
constexpr int ROWS_PER_WARP = BR / (NT / 32);
static_assert(ROWS_PER_WARP == 4, "the score loop keeps 4 rows per warp in registers");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides3 {  // element strides over (batch, time, head)
  long long b, t, h;
};

// cum[i] = dA[t0] + ... + dA[t0 + i] over the chunk starting at t0, for every
// i < NT; positions past the chunk or past T_len add 0. Needs blockDim == NT.
__device__ void chunk_cumsum(const float* __restrict__ dA, Strides3 as, int b, int h, int t0,
                             int cs, int T_len, float* cum, float* warp_tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = t0 + tid;
  float v = (tid < cs && t < T_len) ? dA[b * as.b + t * as.t + h * as.h] : 0.f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < NT / 32 ? warp_tot[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    if (lane < NT / 32) warp_tot[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_tot[warp - 1];
  cum[tid] = v;
  __syncthreads();
}

template <int P>
int states_smem_floats(int N) {
  return NT + NT / 32 + BR * N + BC * (N + 1) + BC * P + BR * BC;
}

template <int P>
int output_smem_floats(int N) {
  return NT + NT / 32 + BR * N + P * (N + 1);
}

// grid (row_tiles + state_tiles, H, batch * nc). Blocks x < row_tiles write
// BR rows of y_diag; the others write STATE_TILE elements of S.
template <typename T, int P>
__global__ void __launch_bounds__(NT) ssd_states_kernel(
    const T* __restrict__ x, const float* __restrict__ dA, const T* __restrict__ Bm,
    const T* __restrict__ Cm, float* __restrict__ y_diag, float* __restrict__ S, int T_len, int cs,
    int nc, int H, int N, Strides3 xs, Strides3 as, Strides3 bs, Strides3 cstr, int row_tiles) {
  extern __shared__ float smem[];
  float* cum = smem;                 // NT
  float* wtot = cum + NT;            // NT / 32
  float* sC = wtot + NT / 32;        // BR x N
  float* sB = sC + BR * N;           // BC x (N + 1): padded against bank conflicts
  float* sX = sB + BC * (N + 1);     // BC x P
  float* sS = sX + BC * P;           // BR x BC scores of the current tile

  const int bc = blockIdx.z, b = bc / nc, c = bc % nc, h = blockIdx.y;
  const int t0 = c * cs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  chunk_cumsum(dA, as, b, h, t0, cs, T_len, cum, wtot);
  const long long head = (static_cast<long long>(bc) * H + h);

  if (blockIdx.x < row_tiles) {
    constexpr int PER = BR * P / NT;
    static_assert(PER * NT == BR * P, "y_diag tile must split evenly over threads");
    const int i0 = blockIdx.x * BR;
    for (int e = tid; e < BR * N; e += NT) {
      const int r = e / N, k = e % N, i = i0 + r, t = t0 + i;
      sC[e] = (i < cs && t < T_len) ? to_f(Cm[b * cstr.b + t * cstr.t + k]) : 0.f;
    }
    float acc[PER];
#pragma unroll
    for (int m = 0; m < PER; ++m) acc[m] = 0.f;
    const int j_end = min(cs, i0 + BR);  // causal: the block's last row sees j < i0 + BR
    for (int j0 = 0; j0 < j_end; j0 += BC) {
      __syncthreads();  // sC is loaded; the previous tile is consumed
      for (int e = tid; e < BC * N; e += NT) {
        const int jj = e / N, k = e % N, j = j0 + jj, t = t0 + j;
        sB[jj * (N + 1) + k] = (j < cs && t < T_len) ? to_f(Bm[b * bs.b + t * bs.t + k]) : 0.f;
      }
      for (int e = tid; e < BC * P; e += NT) {
        const int jj = e / P, d = e % P, j = j0 + jj, t = t0 + j;
        sX[e] = (j < cs && t < T_len) ? to_f(x[b * xs.b + t * xs.t + h * xs.h + d]) : 0.f;
      }
      __syncthreads();
      {  // scores: lane = column, each warp 4 rows
        const int r0 = warp * ROWS_PER_WARP, j = j0 + lane;
        float dot[ROWS_PER_WARP] = {0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < N; ++k) {
          const float bv = sB[lane * (N + 1) + k];
#pragma unroll
          for (int q = 0; q < ROWS_PER_WARP; ++q) dot[q] += sC[(r0 + q) * N + k] * bv;
        }
#pragma unroll
        for (int q = 0; q < ROWS_PER_WARP; ++q) {
          const int i = i0 + r0 + q;
          const bool ok = i >= j && i < cs && j < cs;
          sS[(r0 + q) * BC + lane] = ok ? dot[q] * expf(cum[i] - cum[j]) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < PER; ++m) {  // acc += scores · x; element tid + m·NT of the BR x P tile
        const int idx = tid + m * NT, r = idx / P, d = idx % P;
        float a = acc[m];
#pragma unroll 8
        for (int cc = 0; cc < BC; ++cc) a += sS[r * BC + cc] * sX[cc * P + d];
        acc[m] = a;
      }
    }
    float* yo = y_diag + head * cs * P;
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int idx = tid + m * NT, r = idx / P, d = idx % P, i = i0 + r;
      if (i < cs) yo[i * P + d] = acc[m];
    }
  } else {
    const int s0 = (blockIdx.x - row_tiles) * STATE_TILE;
    const float last = cum[cs - 1];
    float* sBd = sB;  // BC x N, B scaled by its decay to the chunk's end
    float acc[STATE_PER_THREAD] = {0.f, 0.f, 0.f, 0.f};
    for (int j0 = 0; j0 < cs; j0 += BC) {
      __syncthreads();
      for (int e = tid; e < BC * N; e += NT) {
        const int jj = e / N, k = e % N, j = j0 + jj, t = t0 + j;
        sBd[e] = (j < cs && t < T_len) ? to_f(Bm[b * bs.b + t * bs.t + k]) * expf(last - cum[j]) : 0.f;
      }
      for (int e = tid; e < BC * P; e += NT) {
        const int jj = e / P, d = e % P, j = j0 + jj, t = t0 + j;
        sX[e] = (j < cs && t < T_len) ? to_f(x[b * xs.b + t * xs.t + h * xs.h + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < STATE_PER_THREAD; ++q) {
        const int idx = s0 + tid + q * NT;
        if (idx < P * N) {
          const int d = idx / N, k = idx % N;
          float a = acc[q];
#pragma unroll 8
          for (int jj = 0; jj < BC; ++jj) a += sX[jj * P + d] * sBd[jj * N + k];
          acc[q] = a;
        }
      }
    }
    float* so = S + head * P * N;
#pragma unroll
    for (int q = 0; q < STATE_PER_THREAD; ++q) {
      const int idx = s0 + tid + q * NT;
      if (idx < P * N) so[idx] = acc[q];
    }
  }
}

// grid (row_tiles, H, batch * nc): each block writes BR rows of y.
template <typename T, int P>
__global__ void __launch_bounds__(NT) ssd_output_kernel(
    const float* __restrict__ y_diag, const float* __restrict__ dA, const T* __restrict__ Cm,
    const float* __restrict__ H_in, T* __restrict__ y, int T_len, int cs, int nc, int H, int N,
    Strides3 as, Strides3 cstr, Strides3 ys) {
  constexpr int PER = BR * P / NT;
  extern __shared__ float smem[];
  float* cum = smem;             // NT
  float* wtot = cum + NT;        // NT / 32
  float* sC = wtot + NT / 32;    // BR x N, C scaled by exp(cum)
  float* sH = sC + BR * N;       // P x (N + 1): padded against bank conflicts

  const int bc = blockIdx.z, b = bc / nc, c = bc % nc, h = blockIdx.y;
  const int t0 = c * cs, i0 = blockIdx.x * BR;
  const int tid = threadIdx.x;
  chunk_cumsum(dA, as, b, h, t0, cs, T_len, cum, wtot);
  const long long head = (static_cast<long long>(bc) * H + h);
  for (int e = tid; e < BR * N; e += NT) {
    const int r = e / N, k = e % N, i = i0 + r, t = t0 + i;
    sC[e] = (i < cs && t < T_len) ? to_f(Cm[b * cstr.b + t * cstr.t + k]) * expf(cum[i]) : 0.f;
  }
  const float* hin = H_in + head * P * N;
  for (int e = tid; e < P * N; e += NT) sH[(e / N) * (N + 1) + e % N] = hin[e];
  __syncthreads();
  const float* yd = y_diag + head * cs * P;
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int idx = tid + m * NT, r = idx / P, d = idx % P, i = i0 + r, t = t0 + i;
    if (i < cs && t < T_len) {
      float o = 0.f;
#pragma unroll 8
      for (int k = 0; k < N; ++k) o += sC[r * N + k] * sH[d * (N + 1) + k];
      y[b * ys.b + t * ys.t + h * ys.h + d] = from_f<T>(yd[i * P + d] + o);
    }
  }
}

// Raise the kernel's dynamic shared memory limit once it needs more than 48 KB.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, int* configured) {
  if (bytes > *configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    *configured = bytes;
  }
  return 0;
}

template <typename T, int P>
int launch_states(const void* x, const float* dA, const void* B, const void* C, float* y_diag,
                  float* S, int batch, int T_len, int H, int N, int cs, Strides3 xs, Strides3 as,
                  Strides3 bs, Strides3 cstr, cudaStream_t stream) {
  static int configured = 48 * 1024;
  const int smem = states_smem_floats<P>(N) * static_cast<int>(sizeof(float));
  const int rc = allow_smem(ssd_states_kernel<T, P>, smem, &configured);
  if (rc) return rc;
  const int nc = (T_len + cs - 1) / cs;
  const int row_tiles = (cs + BR - 1) / BR;
  const int state_tiles = (P * N + STATE_TILE - 1) / STATE_TILE;
  const dim3 grid(row_tiles + state_tiles, H, batch * nc);
  ssd_states_kernel<T, P><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), dA, static_cast<const T*>(B), static_cast<const T*>(C), y_diag, S,
      T_len, cs, nc, H, N, xs, as, bs, cstr, row_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int launch_output(const float* y_diag, const float* dA, const void* C, const float* H_in, void* y,
                  int batch, int T_len, int H, int N, int cs, Strides3 as, Strides3 cstr,
                  Strides3 ys, cudaStream_t stream) {
  static int configured = 48 * 1024;
  const int smem = output_smem_floats<P>(N) * static_cast<int>(sizeof(float));
  const int rc = allow_smem(ssd_output_kernel<T, P>, smem, &configured);
  if (rc) return rc;
  const int nc = (T_len + cs - 1) / cs;
  const dim3 grid((cs + BR - 1) / BR, H, batch * nc);
  ssd_output_kernel<T, P><<<grid, NT, smem, stream>>>(
      y_diag, dA, static_cast<const T*>(C), H_in, static_cast<T*>(y), T_len, cs, nc, H, N, as,
      cstr, ys);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int P, int N, int cs) {
  return (P == 16 || P == 32 || P == 64 || P == 128) && N >= 1 && N <= MAX_STATE && cs >= 1 &&
         cs <= MAX_CHUNK;
}

}  // namespace

extern "C" {

// x (b,t,h,p) and B/C (b,t,1,n) in dtype (0 = float32, 1 = bfloat16), dA (b,t,h)
// float32, read through element strides (p and n unit-stride). Writes y_diag
// (b,nc,h,cs,p) and S (b,nc,h,p,n), float32, contiguous, nc = ceil(t / cs).
// Returns the cudaError_t of the launch (0 on success).
int ssd_states_fwd(const void* x, const void* dA, const void* B, const void* C, void* y_diag,
                   void* S, int batch, int T_len, int H, int P, int N, int cs, long long x_sb,
                   long long x_st, long long x_sh, long long a_sb, long long a_st, long long a_sh,
                   long long b_sb, long long b_st, long long c_sb, long long c_st, int dtype,
                   void* stream) {
  if (!shape_ok(P, N, cs)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || T_len == 0 || H == 0) return 0;
  const Strides3 xs{x_sb, x_st, x_sh}, as{a_sb, a_st, a_sh}, bs{b_sb, b_st, 0}, cstr{c_sb, c_st, 0};
  const float* a = static_cast<const float*>(dA);
  float* yd = static_cast<float*>(y_diag);
  float* s = static_cast<float*>(S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_STATES(T, PP) \
  return launch_states<T, PP>(x, a, B, C, yd, s, batch, T_len, H, N, cs, xs, as, bs, cstr, st)
#define SSD_STATES_P(T)                   \
  switch (P) {                            \
    case 16: SSD_STATES(T, 16);           \
    case 32: SSD_STATES(T, 32);           \
    case 64: SSD_STATES(T, 64);           \
    default: SSD_STATES(T, 128);          \
  }
  if (dtype == 0) SSD_STATES_P(float)
  if (dtype == 1) SSD_STATES_P(__nv_bfloat16)
#undef SSD_STATES_P
#undef SSD_STATES
  return static_cast<int>(cudaErrorInvalidValue);
}

// y_diag (b,nc,h,cs,p) and H_in (b,nc,h,p,n) float32 contiguous, dA (b,t,h)
// float32 and C (b,t,1,n) in dtype through element strides; writes y (b,t,h,p)
// in dtype through its strides (p unit-stride).
int ssd_output_fwd(const void* y_diag, const void* dA, const void* C, const void* H_in, void* y,
                   int batch, int T_len, int H, int P, int N, int cs, long long a_sb,
                   long long a_st, long long a_sh, long long c_sb, long long c_st, long long y_sb,
                   long long y_st, long long y_sh, int dtype, void* stream) {
  if (!shape_ok(P, N, cs)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || T_len == 0 || H == 0) return 0;
  const Strides3 as{a_sb, a_st, a_sh}, cstr{c_sb, c_st, 0}, ys{y_sb, y_st, y_sh};
  const float* yd = static_cast<const float*>(y_diag);
  const float* a = static_cast<const float*>(dA);
  const float* hin = static_cast<const float*>(H_in);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_OUTPUT(T, PP) \
  return launch_output<T, PP>(yd, a, C, hin, y, batch, T_len, H, N, cs, as, cstr, ys, st)
#define SSD_OUTPUT_P(T)                   \
  switch (P) {                            \
    case 16: SSD_OUTPUT(T, 16);           \
    case 32: SSD_OUTPUT(T, 32);           \
    case 64: SSD_OUTPUT(T, 64);           \
    default: SSD_OUTPUT(T, 128);          \
  }
  if (dtype == 0) SSD_OUTPUT_P(float)
  if (dtype == 1) SSD_OUTPUT_P(__nv_bfloat16)
#undef SSD_OUTPUT_P
#undef SSD_OUTPUT
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block of each kernel, in bytes (-1: unsupported shape).
int ssd_states_smem_bytes(int P, int N) {
  if (!shape_ok(P, N, 1)) return -1;
  switch (P) {
    case 16: return states_smem_floats<16>(N) * sizeof(float);
    case 32: return states_smem_floats<32>(N) * sizeof(float);
    case 64: return states_smem_floats<64>(N) * sizeof(float);
    default: return states_smem_floats<128>(N) * sizeof(float);
  }
}

int ssd_output_smem_bytes(int P, int N) {
  if (!shape_ok(P, N, 1)) return -1;
  switch (P) {
    case 16: return output_smem_floats<16>(N) * sizeof(float);
    case 32: return output_smem_floats<32>(N) * sizeof(float);
    case 64: return output_smem_floats<64>(N) * sizeof(float);
    default: return output_smem_floats<128>(N) * sizeof(float);
  }
}

const char* ssd_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
