// Mamba-2 SSD chunk kernels, for Hopper (sm_90a).
//
// Replace the two TPU kernels of src/repro/kernels/ssd_scan.py::ssd_chunked_pallas:
//   ssd_states  <- _states_kernel (pallas_call at :85): per (batch, chunk, head)
//                  the intra-chunk output y_diag = (C·Bᵀ ⊙ L)·x with
//                  L = exp(cum_i - cum_j) for i >= j, and the chunk state
//                  S = xᵀ·(B ⊙ exp(cum[-1] - cum)); both fp32.
//   ssd_output  <- _output_kernel (pallas_call at :117):
//                  y = y_diag + (C ⊙ exp(cum))·H_inᵀ, written in x's dtype.
// The inter-chunk recurrence between them (nc steps of an elementwise update)
// stays in PyTorch, as the reference keeps it in a host lax.scan.
//
// What bounds them on an H100: bytes. At the serving shape of mamba2-1.3b
// (b 1, t 1024, h 64, p 64, n 128, chunk 256, bf16) ssd_states reads 8.9 MB
// (x, B, C, dA) and writes 25.2 MB (fp32 y_diag and S): 34.3 MB, 10.2 us at
// 3.35 TB/s, against ~3.2 GFLOP of products (3.3 us at the bf16 tensor-core
// rate). ssd_output reads 25.4 MB (fp32 y_diag and H_in, C, dA) and writes
// 8.4 MB of y: 34.1 MB, 10.2 us, against 1.07 GFLOP.
//
// Design, for bf16 inputs (the serving path): every product runs on the
// tensor cores, mma.sync.aligned.m16n8k16 with bf16 operands and fp32
// accumulators, fragments by ldmatrix / ldmatrix.trans from shared-memory rows
// padded by 16 bytes, tiles by 16-byte cp.async (ragged rows, columns and
// positions zero-filled with source size 0), 16 rows per warp.
//   ssd_states_mma_kernel (8 warps): a row block owns 128 rows i of one
//     (batch, chunk, head), keeps C's rows in shared memory and streams
//     64-wide j-tiles of B and x up to the diagonal, double-buffered; a warp
//     skips the tiles past its rows. Per tile C·Bᵀ lands in fp32 fragments,
//     is scaled by L and masked there, and is the A operand of scores·x (x
//     by ldmatrix.trans), as S and P in a flash loop. Off the diagonal L
//     factors into a per-row and a per-column exponential (the latter
//     computed once per block). A state block of the same launch owns a
//     64 x 128 tile of S (fewer d rows when p < 64) and reduces over all j:
//     A = (x ⊙ decay)ᵀ from ldmatrix.trans fragments scaled in registers,
//     B = B's j-rows by ldmatrix.trans. Every element of y_diag and S is
//     written by one block, without atomics.
//   ssd_output_mma_kernel (8 warps): a block owns 128 rows i; the y_diag tile
//     and C's rows arrive by cp.async with H_in's first 32 columns, and each
//     next 32 columns of H_in load while the current ones, converted once to
//     bf16 terms in shared memory, go through C·H_inᵀ; the epilogue adds
//     exp(cum_i)·acc to the y_diag tile and writes y.
// What holds them back (launch/ssd_variants.py; PERF.md): at the serving
// shape ssd_states takes 6.5x its byte bound, and its arithmetic alone
// (tiles never loaded) takes ~73% of that time, its loads and writes alone
// ~49%: it is bound by the latency of its mma.sync, ldmatrix and
// exponential chains at 16 warps an SM more than by bytes. The three terms
// cost ~17% of it, the exponentials ~10%. ssd_output takes 2.7x its bound,
// its loads alone ~81% of that.
//
// Rounding. The kernels round to bf16 nowhere beyond their bf16 inputs x, B
// and C, whose products are exact. The JAX model rounds at four points:
// scores (src/repro/models/mamba2.py:75), decay_states (:79), the carried
// state H (:84-88) and state_decay (:99). A one-ulp bf16 flip of such a
// value, which another summation order or exp implementation gives now and
// then, moves y_diag or S by up to ~200x the fp32 tolerance they are held to
// here, and rounding H_in to bf16 moves y by up to ~5x its bf16 tolerance
// against the sequential oracle (python -m repro_torch.launch.ssd_precision).
// So each fp32 operand (the scores, x ⊙ decay, H_in) enters the tensor cores
// as three bf16 terms hi + mid + lo, which sum to it exactly (split3): three
// products where the JAX model takes one.
//
// fp32 inputs (the parity path) keep the CUDA-core kernels below,
// ssd_states_kernel and ssd_output_kernel: a block owns BR = 32 rows i and
// streams 32-wide j-tiles, the score tile in shared memory; state blocks own
// 4·NT elements of S; all products in fp32. C·Bᵀ does not depend on the head
// when g = 1 but is recomputed per head in both designs.
//
// Both: each block computes the chunk's cumsum of dA itself (a warp-shuffle
// scan); inputs are read in place through their strides (B and C are views
// into the model's fused xBC activation); positions t >= T_len of the last
// chunk are masked in the kernels as identity steps (dA = 0, x = B = C = 0),
// so the host pads nothing; y is written straight into (b, t, h, p).
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

// The CUDA-core kernels run fp32 only (bf16 takes the tensor-core kernels).
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// ---- bf16 on the tensor cores ----

constexpr int NTS = 256;  // threads per block of ssd_states_mma_kernel (8 warps)
constexpr int BRS = 128;  // chunk rows i per row block of ssd_states: 16 per warp
constexpr int BCM = 64;   // chunk positions j per tile
constexpr int SKM = 128;  // state columns k per state block
constexpr int NTO = 256;  // threads per block of ssd_output_mma_kernel (8 warps)
constexpr int BRO = 128;  // chunk rows i per block of ssd_output: 16 per warp
constexpr int OKM = 32;   // columns k of H_in per step of ssd_output
constexpr int MMA_FLOATS = 2 * MAX_CHUNK + 8;  // cum, decays, warp totals: floats before the tiles
static_assert(NTS == NT && NTO == NT, "the cumsum gives each thread one position");

__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }
// Row stride in shared memory, in bf16 elements, of a tile w wide (w a
// multiple of 16): an odd number of 16-byte units, so the 8 rows of an
// ldmatrix fall into 8 different bank groups.
__host__ __device__ constexpr int rs(int w) { return w + 8; }
template <int P> __host__ __device__ constexpr int state_rows() { return P < 64 ? P : 64; }

template <int P>
int states_mma_smem_bytes(int N) {
  const int rn = rs(pad16(N));
  const int rows = (BRS + 2 * BCM) * rn + 2 * BCM * rs(P);                    // C, B x2, x x2
  const int state = 2 * BCM * rs(state_rows<P>()) + 2 * BCM * rs(SKM);       // x x2, B x2
  return MMA_FLOATS * 4 + 2 * (rows > state ? rows : state);
}

template <int P>
int output_mma_smem_bytes(int N) {  // cum; fp32 y_diag and two steps of H_in; three bf16 terms of H_in; C
  return MMA_FLOATS * 4 + (BRO * (P + 8) + 2 * P * (OKM + 4)) * 4 + (3 * P * rs(OKM) + BRO * rs(pad16(N))) * 2;
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

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) { return *reinterpret_cast<unsigned*>(&v); }

// Two fp32 values as three bf16x2 terms, hi + mid + lo = the values: each
// term takes the next 8 bits of the significand (the first element in the
// low half, as an mma fragment wants the smaller column there).
__device__ __forceinline__ void split3(float v0, float v1, unsigned& hi, unsigned& mid, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float r0 = v0 - __low2float(h), r1 = v1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m)));
}

// c += (hi + mid + lo) . b, the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const unsigned (&hi)[4], const unsigned (&mid)[4],
                                     const unsigned (&lo)[4], unsigned b0, unsigned b1) {
  mma_16816(c, lo, b0, b1);
  mma_16816(c, mid, b0, b1);
  mma_16816(c, hi, b0, b1);
}

// Rows i0 .. i0 + BRS - 1 of y_diag for one (batch, chunk, head).
template <int P>
__device__ __forceinline__ void states_rows_mma(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ Bm,
    const __nv_bfloat16* __restrict__ Cm, float* __restrict__ yo, const float* cum, const float* colf,
    __nv_bfloat16* tiles, int i0, int b, int h, int t0, int cs, int T_len, int N, Strides3 xs,
    Strides3 bs, Strides3 cstr) {
  constexpr int RX = rs(P), VX = P / 8;  // row stride of x tiles; 16-byte pieces per row
  const int NP = pad16(N), RN = rs(NP), VN = NP / 8;
  __nv_bfloat16* sC = tiles;              // BRS x RN
  __nv_bfloat16* sB = sC + BRS * RN;      // 2 x BCM x RN
  __nv_bfloat16* sX = sB + 2 * BCM * RN;  // 2 x BCM x RX
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // C's rows once; rows past the chunk or T_len and columns k >= N: zeros
  for (int e = tid; e < BRS * VN; e += NTS) {
    const int r = e / VN, c = (e % VN) * 8, t = t0 + i0 + r;
    const bool ok = i0 + r < cs && t < T_len && c < N;
    cp_async16(sC + r * RN + c, ok ? Cm + b * cstr.b + t * cstr.t + c : Cm, ok ? min(16, 2 * (N - c)) : 0);
  }
  auto load_tile = [&](int j0, int buf) {
    for (int e = tid; e < BCM * VN; e += NTS) {
      const int r = e / VN, c = (e % VN) * 8, t = t0 + j0 + r;
      const bool ok = j0 + r < cs && t < T_len && c < N;
      cp_async16(sB + (buf * BCM + r) * RN + c, ok ? Bm + b * bs.b + t * bs.t + c : Bm,
                 ok ? min(16, 2 * (N - c)) : 0);
    }
    for (int e = tid; e < BCM * VX; e += NTS) {
      const int r = e / VX, c = (e % VX) * 8, t = t0 + j0 + r;
      const bool ok = j0 + r < cs && t < T_len;
      cp_async16(sX + (buf * BCM + r) * RX + c, ok ? x + b * xs.b + t * xs.t + h * xs.h + c : x,
                 ok ? 16 : 0);
    }
  };
  const int ntiles = (min(cs, i0 + BRS) + BCM - 1) / BCM;  // causal: up to the diagonal
  load_tile(0, 0);
  cp_async_commit();

  // this thread's rows of the warp's 16: il and il + 8; columns 2 * tq, 2 * tq + 1 of each 8-wide tile
  const int g = lane >> 2, tq = lane & 3, wr0 = warp * 16, il = i0 + wr0 + g;
  const float cum_i[2] = {cum[il], cum[il + 8]};
  float acc[P / 8][4];
#pragma unroll
  for (int n = 0; n < P / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1, j0 = tile * BCM;
    cp_async_wait_all();
    __syncthreads();  // the tile (and C) landed for every thread; the other buffer is free
    if (tile + 1 < ntiles) load_tile(j0 + BCM, buf ^ 1);
    cp_async_commit();
    const __nv_bfloat16* tB = sB + buf * BCM * RN;
    const __nv_bfloat16* tX = sX + buf * BCM * RX;
    if (j0 > i0 + wr0 + 15) continue;  // causal: the tile is past every row of this warp

    // C·Bᵀ on the tensor cores: bf16 products are exact, the sums fp32
    float s[BCM / 8][4];
#pragma unroll
    for (int n = 0; n < BCM / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int kc = 0; kc < NP / 16; ++kc) {
      unsigned a[4];
      ldmatrix_x4(a, sC + (wr0 + (lane & 15)) * RN + kc * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < BCM / 16; ++np) {
        unsigned bk[4];
        ldmatrix_x4(bk, tB + (np * 16 + (lane & 7) + (lane >> 4) * 8) * RN + kc * 16 + ((lane >> 3) & 1) * 8);
        mma_16816(s[2 * np], a, bk[0], bk[1]);
        mma_16816(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }
    // scores = C·Bᵀ · exp(cum_i - cum_j) for j <= i, else 0. Rows and columns
    // past the chunk are zero already (C and B were zero-filled). Off the
    // diagonal every j < i, and with jl the tile's last column the decay is
    // exp(cum_i - cum_jl) · exp(cum_jl - cum_j), two factors <= 1 (dA <= 0),
    // the second computed once per block (colf): 2 exponentials a thread
    // instead of 32.
    if (j0 + BCM <= i0 + wr0) {
      const float cl = cum[j0 + BCM - 1];
      const float ri0 = expf(cum_i[0] - cl), ri1 = expf(cum_i[1] - cl);
#pragma unroll
      for (int n = 0; n < BCM / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float cj = colf[j0 + n * 8 + 2 * tq + e];
          s[n][e] *= ri0 * cj;
          s[n][2 + e] *= ri1 * cj;
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < BCM / 8; ++n) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + n * 8 + 2 * tq + e;
            float& v = s[n][hr * 2 + e];
            v = j <= il + hr * 8 ? v * expf(cum_i[hr] - cum[j]) : 0.f;
          }
        }
      }
    }
    // y_diag += scores · x: the scores as three bf16 terms (A), x by ldmatrix.trans (B)
#pragma unroll
    for (int kk = 0; kk < BCM / 16; ++kk) {
      unsigned hi[4], mid[4], lo[4];
      split3(s[2 * kk][0], s[2 * kk][1], hi[0], mid[0], lo[0]);
      split3(s[2 * kk][2], s[2 * kk][3], hi[1], mid[1], lo[1]);
      split3(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], mid[2], lo[2]);
      split3(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], mid[3], lo[3]);
#pragma unroll
      for (int dp = 0; dp < P / 16; ++dp) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, tX + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RX + dp * 16 + (lane >> 4) * 8);
        mma3(acc[2 * dp], hi, mid, lo, bv[0], bv[1]);
        mma3(acc[2 * dp + 1], hi, mid, lo, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait_all();
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = il + hr * 8;
    if (i >= cs) continue;
#pragma unroll
    for (int n = 0; n < P / 8; ++n)
      *reinterpret_cast<float2*>(yo + i * P + n * 8 + 2 * tq) = make_float2(acc[n][hr * 2], acc[n][hr * 2 + 1]);
  }
}

// x (bf16x2 of positions j, j + 1) times their decays, as three bf16x2 terms
__device__ __forceinline__ void scale_split(unsigned xv, float d0, float d1, unsigned& hi, unsigned& mid,
                                            unsigned& lo) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&xv);
  split3(__low2float(v) * d0, __high2float(v) * d1, hi, mid, lo);
}

// One tile of S (state_rows<P>() rows d from d0, SKM columns k from k0) for
// one (batch, chunk, head): S = (x ⊙ decay)ᵀ·B over every j of the chunk.
template <int P>
__device__ __forceinline__ void states_tile_mma(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ Bm, float* __restrict__ so,
    const float* dec, __nv_bfloat16* tiles, int d0, int k0, int b, int h, int t0, int cs, int T_len,
    int N, Strides3 xs, Strides3 bs) {
  constexpr int SD = state_rows<P>();
  constexpr int WD = SD / 16, WK = NTS / 32 / WD;  // warps along d and along k
  constexpr int NW = SKM / 8 / WK;                 // 8-wide column tiles per warp
  constexpr int RX = rs(SD), RB = rs(SKM), VX = SD / 8, VB = SKM / 8;
  static_assert(NW % 2 == 0, "B fragments come in pairs of column tiles");
  __nv_bfloat16* sX = tiles;              // 2 x BCM x RX
  __nv_bfloat16* sB = sX + 2 * BCM * RX;  // 2 x BCM x RB
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto load_tile = [&](int j0, int buf) {
    for (int e = tid; e < BCM * VX; e += NTS) {
      const int r = e / VX, c = (e % VX) * 8, t = t0 + j0 + r;
      const bool ok = j0 + r < cs && t < T_len;
      cp_async16(sX + (buf * BCM + r) * RX + c, ok ? x + b * xs.b + t * xs.t + h * xs.h + d0 + c : x,
                 ok ? 16 : 0);
    }
    for (int e = tid; e < BCM * VB; e += NTS) {
      const int r = e / VB, c = (e % VB) * 8, t = t0 + j0 + r, k = k0 + c;
      const bool ok = j0 + r < cs && t < T_len && k < N;
      cp_async16(sB + (buf * BCM + r) * RB + c, ok ? Bm + b * bs.b + t * bs.t + k : Bm,
                 ok ? min(16, 2 * (N - k)) : 0);
    }
  };
  const int ntiles = (cs + BCM - 1) / BCM;
  load_tile(0, 0);
  cp_async_commit();

  const int g = lane >> 2, tq = lane & 3, wd = warp % WD, wk = warp / WD;
  float acc[NW][4];
#pragma unroll
  for (int n = 0; n < NW; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1, j0 = tile * BCM;
    cp_async_wait_all();
    __syncthreads();
    if (tile + 1 < ntiles) load_tile(j0 + BCM, buf ^ 1);
    cp_async_commit();
    const __nv_bfloat16* tX = sX + buf * BCM * RX;
    const __nv_bfloat16* tB = sB + buf * BCM * RB;
#pragma unroll
    for (int kk = 0; kk < BCM / 16; ++kk) {
      // A = (x ⊙ decay)ᵀ: xᵀ by ldmatrix.trans (rows d, columns j), scaled per j and split
      unsigned a[4];
      ldmatrix_x4_trans(a, tX + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * RX + wd * 16 + ((lane >> 3) & 1) * 8);
      const float* dj = dec + j0 + kk * 16 + 2 * tq;
      unsigned hi[4], mid[4], lo[4];
      scale_split(a[0], dj[0], dj[1], hi[0], mid[0], lo[0]);
      scale_split(a[1], dj[0], dj[1], hi[1], mid[1], lo[1]);
      scale_split(a[2], dj[8], dj[9], hi[2], mid[2], lo[2]);
      scale_split(a[3], dj[8], dj[9], hi[3], mid[3], lo[3]);
#pragma unroll
      for (int np = 0; np < NW / 2; ++np) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, tB + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RB + wk * NW * 8 + np * 16 +
                                  (lane >> 4) * 8);
        mma3(acc[2 * np], hi, mid, lo, bv[0], bv[1]);
        mma3(acc[2 * np + 1], hi, mid, lo, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait_all();
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int d = d0 + wd * 16 + g + hr * 8;
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      const int k = k0 + wk * NW * 8 + n * 8 + 2 * tq;
      if (k + 1 < N && N % 2 == 0) {
        *reinterpret_cast<float2*>(so + d * N + k) = make_float2(acc[n][hr * 2], acc[n][hr * 2 + 1]);
      } else {
        if (k < N) so[d * N + k] = acc[n][hr * 2];
        if (k + 1 < N) so[d * N + k + 1] = acc[n][hr * 2 + 1];
      }
    }
  }
}

// grid (row_tiles + state_tiles, H, batch * nc), NTS threads. Blocks x <
// row_tiles write BRS rows of y_diag (the latest rows first: they stream the
// most tiles); the others one tile of S.
template <int P>
__global__ void __launch_bounds__(NTS) ssd_states_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dA,
    const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ Cm,
    float* __restrict__ y_diag, float* __restrict__ S, int T_len, int cs, int nc, int H, int N,
    Strides3 xs, Strides3 as, Strides3 bs, Strides3 cstr, int row_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);  // MAX_CHUNK
  float* dec = cum + MAX_CHUNK;                     // MAX_CHUNK: decays (state blocks), colf (row blocks)
  float* wtot = dec + MAX_CHUNK;                    // NTS / 32
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem_raw + MMA_FLOATS * 4);
  const int bc = blockIdx.z, b = bc / nc, c = bc % nc, h = blockIdx.y, t0 = c * cs;
  chunk_cumsum(dA, as, b, h, t0, cs, T_len, cum, wtot);
  const long long head = static_cast<long long>(bc) * H + h;
  if (static_cast<int>(blockIdx.x) < row_tiles) {
    const int i0 = (row_tiles - 1 - blockIdx.x) * BRS;
    for (int j = threadIdx.x; j < MAX_CHUNK; j += NTS) dec[j] = expf(cum[(j / BCM) * BCM + BCM - 1] - cum[j]);
    __syncthreads();
    states_rows_mma<P>(x, Bm, Cm, y_diag + head * cs * P, cum, dec, tiles, i0, b, h, t0, cs, T_len, N, xs, bs,
                       cstr);
  } else {
    const float last = cum[cs - 1];
    for (int j = threadIdx.x; j < MAX_CHUNK; j += NTS) dec[j] = expf(last - cum[j]);
    __syncthreads();
    constexpr int SD = state_rows<P>();
    const int st = blockIdx.x - row_tiles;
    states_tile_mma<P>(x, Bm, S + head * P * N, dec, tiles, (st % (P / SD)) * SD, (st / (P / SD)) * SKM, b, h, t0,
                       cs, T_len, N, xs, bs);
  }
}

// grid (row_tiles, H, batch * nc), NTO threads: each block writes BRO rows of y.
template <int P>
__global__ void __launch_bounds__(NTO) ssd_output_mma_kernel(
    const float* __restrict__ y_diag, const float* __restrict__ dA, const __nv_bfloat16* __restrict__ Cm,
    const float* __restrict__ H_in, __nv_bfloat16* __restrict__ y, int T_len, int cs, int nc, int H,
    int N, Strides3 as, Strides3 cstr, Strides3 ys) {
  constexpr int RY = P + 8, RF = OKM + 4, RH = rs(OKM);  // row strides: fp32 y_diag and H_in tiles, bf16 terms
  const int NP = pad16(N), RN = rs(NP), VN = NP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);                    // MAX_CHUNK
  float* wtot = cum + 2 * MAX_CHUNK;                                  // NTO / 32
  float* sY = reinterpret_cast<float*>(smem_raw + MMA_FLOATS * 4);   // BRO x RY
  float* sF = sY + BRO * RY;                                          // 2 x P x RF: H_in's columns, fp32
  __nv_bfloat16* sH = reinterpret_cast<__nv_bfloat16*>(sF + 2 * P * RF);  // 3 x P x RH: hi, mid, lo
  __nv_bfloat16* sC = sH + 3 * P * RH;                                // BRO x RN

  const int bc = blockIdx.z, b = bc / nc, c = bc % nc, h = blockIdx.y;
  const int t0 = c * cs, i0 = blockIdx.x * BRO;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long head = static_cast<long long>(bc) * H + h;
  const float* yd = y_diag + head * cs * P;
  const float* hin = H_in + head * P * N;
  // every input of the block in flight at once: the y_diag tile, C's rows,
  // then H_in's first OKM columns (16-byte pieces when rows of H_in allow)
  for (int e = tid; e < BRO * P / 4; e += NTO) {
    const int r = e / (P / 4), col = (e % (P / 4)) * 4, i = i0 + r;
    cp_async16(sY + r * RY + col, i < cs ? yd + i * P + col : yd, i < cs ? 16 : 0);
  }
  for (int e = tid; e < BRO * VN; e += NTO) {
    const int r = e / VN, col = (e % VN) * 8, t = t0 + i0 + r;
    const bool ok = i0 + r < cs && t < T_len && col < N;
    cp_async16(sC + r * RN + col, ok ? Cm + b * cstr.b + t * cstr.t + col : Cm, ok ? min(16, 2 * (N - col)) : 0);
  }
  auto load_h = [&](int k0, float* dst) {  // H_in[:, k0 .. k0 + OKM) into dst, zeros past N
    for (int e = tid; e < P * OKM / 4; e += NTO) {
      const int d = e / (OKM / 4), col = (e % (OKM / 4)) * 4, k = k0 + col;
      if (N % 4 == 0) {
        cp_async16(dst + d * RF + col, k < N ? hin + d * N + k : hin, k < N ? 16 : 0);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) dst[d * RF + col + u] = k + u < N ? hin[d * N + k + u] : 0.f;
      }
    }
  };
  load_h(0, sF);
  cp_async_commit();
  chunk_cumsum(dA, as, b, h, t0, cs, T_len, cum, wtot);

  const int g = lane >> 2, tq = lane & 3, wr0 = warp * 16;
  float acc[P / 8][4];
#pragma unroll
  for (int n = 0; n < P / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int steps = (N + OKM - 1) / OKM;
  for (int step = 0; step < steps; ++step) {
    const int k0 = step * OKM;
    cp_async_wait_all();
    __syncthreads();  // this step's H_in columns landed; the previous step's terms are consumed
    const float* f = sF + (step & 1) * P * RF;
    for (int e = tid; e < P * OKM / 4; e += NTO) {  // the fp32 columns as three bf16 terms
      const int d = e / (OKM / 4), col = (e % (OKM / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(f + d * RF + col);
      uint2 hi, mid, lo;
      split3(v.x, v.y, hi.x, mid.x, lo.x);
      split3(v.z, v.w, hi.y, mid.y, lo.y);
      __nv_bfloat16* dst = sH + d * RH + col;
      *reinterpret_cast<uint2*>(dst) = hi;
      *reinterpret_cast<uint2*>(dst + P * RH) = mid;
      *reinterpret_cast<uint2*>(dst + 2 * P * RH) = lo;
    }
    if (step + 1 < steps) load_h(k0 + OKM, sF + ((step + 1) & 1) * P * RF);  // overlaps the products
    cp_async_commit();
    __syncthreads();
    // acc += C · H_inᵀ: C's rows by ldmatrix (A), H_in's rows d by ldmatrix (B), per term
#pragma unroll
    for (int kc = 0; kc < OKM / 16; ++kc) {
      if (k0 + kc * 16 >= NP) break;  // past C's (padded) columns: the terms there are zeros
      unsigned a[4];
      ldmatrix_x4(a, sC + (wr0 + (lane & 15)) * RN + k0 + kc * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int dp = 0; dp < P / 16; ++dp) {
#pragma unroll
        for (int term = 2; term >= 0; --term) {  // lo, mid, hi
          unsigned bk[4];
          ldmatrix_x4(bk, sH + (term * P + dp * 16 + (lane & 7) + (lane >> 4) * 8) * RH + kc * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_16816(acc[2 * dp], a, bk[0], bk[1]);
          mma_16816(acc[2 * dp + 1], a, bk[2], bk[3]);
        }
      }
    }
  }
  cp_async_wait_all();
  // y = y_diag + exp(cum_i) · (C · H_inᵀ)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = wr0 + g + hr * 8, i = i0 + r, t = t0 + i;
    if (i >= cs || t >= T_len) continue;
    const float sc = expf(cum[i]);
    __nv_bfloat16* dst = y + b * ys.b + t * ys.t + h * ys.h + 2 * tq;
#pragma unroll
    for (int n = 0; n < P / 8; ++n) {
      const float2 base = *reinterpret_cast<const float2*>(sY + r * RY + n * 8 + 2 * tq);
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(base.x + sc * acc[n][hr * 2], base.y + sc * acc[n][hr * 2 + 1]);
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

template <int P>
int launch_states_mma(const void* x, const float* dA, const void* B, const void* C, float* y_diag,
                      float* S, int batch, int T_len, int H, int N, int cs, Strides3 xs,
                      Strides3 as, Strides3 bs, Strides3 cstr, cudaStream_t stream) {
  static int configured = 48 * 1024;
  const int smem = states_mma_smem_bytes<P>(N);
  const int rc = allow_smem(ssd_states_mma_kernel<P>, smem, &configured);
  if (rc) return rc;
  const int nc = (T_len + cs - 1) / cs;
  const int row_tiles = (cs + BRS - 1) / BRS;
  const int state_tiles = (P / state_rows<P>()) * ((N + SKM - 1) / SKM);
  const dim3 grid(row_tiles + state_tiles, H, batch * nc);
  using bf = __nv_bfloat16;
  ssd_states_mma_kernel<P><<<grid, NTS, smem, stream>>>(
      static_cast<const bf*>(x), dA, static_cast<const bf*>(B), static_cast<const bf*>(C), y_diag, S,
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

template <int P>
int launch_output_mma(const float* y_diag, const float* dA, const void* C, const float* H_in,
                      void* y, int batch, int T_len, int H, int N, int cs, Strides3 as,
                      Strides3 cstr, Strides3 ys, cudaStream_t stream) {
  static int configured = 48 * 1024;
  const int smem = output_mma_smem_bytes<P>(N);
  const int rc = allow_smem(ssd_output_mma_kernel<P>, smem, &configured);
  if (rc) return rc;
  const int nc = (T_len + cs - 1) / cs;
  const dim3 grid((cs + BRO - 1) / BRO, H, batch * nc);
  ssd_output_mma_kernel<P><<<grid, NTO, smem, stream>>>(
      y_diag, dA, static_cast<const __nv_bfloat16*>(C), H_in, static_cast<__nv_bfloat16*>(y), T_len,
      cs, nc, H, N, as, cstr, ys);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int P, int N, int cs) {
  return (P == 16 || P == 32 || P == 64 || P == 128) && N >= 1 && N <= MAX_STATE && cs >= 1 &&
         cs <= MAX_CHUNK;
}

template <int P>
int states_smem(int N, int dtype) {
  return dtype == 0 ? states_smem_floats<P>(N) * static_cast<int>(sizeof(float)) : states_mma_smem_bytes<P>(N);
}

template <int P>
int output_smem(int N, int dtype) {
  return dtype == 0 ? output_smem_floats<P>(N) * static_cast<int>(sizeof(float)) : output_mma_smem_bytes<P>(N);
}

}  // namespace

extern "C" {

// x (b,t,h,p) and B/C (b,t,1,n) in dtype (0 = float32 on CUDA cores, 1 =
// bfloat16 on the tensor cores, whose rows must start on 16 bytes), dA (b,t,h)
// float32, read through element strides (p and n unit-stride). Writes y_diag
// (b,nc,h,cs,p) and S (b,nc,h,p,n), float32, contiguous, nc = ceil(t / cs).
// Returns the cudaError_t of the launch (0 on success).
int ssd_states_fwd(const void* x, const void* dA, const void* B, const void* C, void* y_diag,
                   void* S, int batch, int T_len, int H, int P, int N, int cs, long long x_sb,
                   long long x_st, long long x_sh, long long a_sb, long long a_st, long long a_sh,
                   long long b_sb, long long b_st, long long c_sb, long long c_st, int dtype,
                   void* stream) {
  if (!shape_ok(P, N, cs) || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || T_len == 0 || H == 0) return 0;
  const Strides3 xs{x_sb, x_st, x_sh}, as{a_sb, a_st, a_sh}, bs{b_sb, b_st, 0}, cstr{c_sb, c_st, 0};
  const float* a = static_cast<const float*>(dA);
  float* yd = static_cast<float*>(y_diag);
  float* s = static_cast<float*>(S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_STATES(PP)                                                                        \
  case PP:                                                                                    \
    return dtype == 0                                                                         \
               ? launch_states<float, PP>(x, a, B, C, yd, s, batch, T_len, H, N, cs, xs, as, bs, cstr, st) \
               : launch_states_mma<PP>(x, a, B, C, yd, s, batch, T_len, H, N, cs, xs, as, bs, cstr, st);
  switch (P) {
    SSD_STATES(16)
    SSD_STATES(32)
    SSD_STATES(64)
    SSD_STATES(128)
  }
#undef SSD_STATES
  return static_cast<int>(cudaErrorInvalidValue);
}

// y_diag (b,nc,h,cs,p) and H_in (b,nc,h,p,n) float32 contiguous (on 16 bytes
// for bfloat16), dA (b,t,h) float32 and C (b,t,1,n) in dtype through element
// strides; writes y (b,t,h,p) in dtype through its strides (p unit-stride).
int ssd_output_fwd(const void* y_diag, const void* dA, const void* C, const void* H_in, void* y,
                   int batch, int T_len, int H, int P, int N, int cs, long long a_sb,
                   long long a_st, long long a_sh, long long c_sb, long long c_st, long long y_sb,
                   long long y_st, long long y_sh, int dtype, void* stream) {
  if (!shape_ok(P, N, cs) || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || T_len == 0 || H == 0) return 0;
  const Strides3 as{a_sb, a_st, a_sh}, cstr{c_sb, c_st, 0}, ys{y_sb, y_st, y_sh};
  const float* yd = static_cast<const float*>(y_diag);
  const float* a = static_cast<const float*>(dA);
  const float* hin = static_cast<const float*>(H_in);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_OUTPUT(PP)                                                                                  \
  case PP:                                                                                              \
    return dtype == 0 ? launch_output<float, PP>(yd, a, C, hin, y, batch, T_len, H, N, cs, as, cstr, ys, st) \
                      : launch_output_mma<PP>(yd, a, C, hin, y, batch, T_len, H, N, cs, as, cstr, ys, st);
  switch (P) {
    SSD_OUTPUT(16)
    SSD_OUTPUT(32)
    SSD_OUTPUT(64)
    SSD_OUTPUT(128)
  }
#undef SSD_OUTPUT
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block of each kernel for dtype (0 fp32, 1
// bf16), in bytes (-1: unsupported shape).
int ssd_states_smem_bytes(int P, int N, int dtype) {
  if (!shape_ok(P, N, 1)) return -1;
  switch (P) {
    case 16: return states_smem<16>(N, dtype);
    case 32: return states_smem<32>(N, dtype);
    case 64: return states_smem<64>(N, dtype);
    default: return states_smem<128>(N, dtype);
  }
}

int ssd_output_smem_bytes(int P, int N, int dtype) {
  if (!shape_ok(P, N, 1)) return -1;
  switch (P) {
    case 16: return output_smem<16>(N, dtype);
    case 32: return output_smem<32>(N, dtype);
    case 64: return output_smem<64>(N, dtype);
    default: return output_smem<128>(N, dtype);
  }
}

const char* ssd_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
