// Row gathers through the MoE routing maps, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The reference (src/repro/models/moe.py::_moe_tokens)
// leaves the MoE's dispatch and combine to XLA's gathers and scatter-adds;
// the port wrote them as PyTorch advanced indexing, whose backward is an
// accumulating index_put_: it sorts the indices and one warp adds up each run
// of equal indices row after row. Every dead slot of the (E, C) dispatch
// table reads the one pad row, and every dropped routed entry reads the
// combine's pad row, so thousands of rows were summed in series into a row
// whose gradient is thrown away.
//
// models/moe.py::dispatch gives two maps that are inverses of each other:
// table (E, C), each slot's token (N where the slot is dead), and slots
// (N, k), each token's places in the flattened (E*C) expert outputs in
// ascending expert id (E*C where the token lost that expert). So each of the
// two kernels here is the other's backward, and neither needs an atomic, a
// sort or a sum into a shared row:
//
//   moe_gather_rows:     out[r] = src[idx[r]], zeros where idx[r] is not a
//                        row of src (the pad index M = src's rows). The
//                        dispatch's forward (xe = xt through table) and the
//                        combine's backward (d_ye = dy through table).
//   moe_gather_sum_rows: out[n] = sum over j of src[places[n, j]], in j
//                        order, skipping places that are not a row of src.
//                        The combine's forward (y from ye through slots) and
//                        the dispatch's backward (d_xt from d_xe through
//                        slots).
//
// What bounds them on an H100: bytes. Each copies live rows and writes every
// output row: at qwen2-moe's 1 x 4096 training microbatch (N 4096, k 4, E 60,
// C 384, d 2048, bf16) the dispatch's output is 23040 rows of 4 KB (94 MB, ~82%
// of them zeros) and the combine's 4096 rows read from ~4300 live ones, under
// 0.1 ms at 3.35 TB/s. A warp owns one output row and walks it in 16-byte
// vectors, several loads in flight before their stores; a dead row is written
// as zeros without a read of src. Nothing is shared between warps, so the
// result is the same bits in every call.
//
// The sum has two roundings, a template argument: ROUND_EACH rounds to the
// element type after every add, in j order, as the expression it replaces
// (y = ye[slots[:, 0]]; y = y + ye[slots[:, j]]) did; otherwise the sum runs
// in fp32 from zero and is rounded once, as the accumulating index_put_ it
// replaces in the backward did.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 4;  // output rows of a block, one warp each
constexpr int U = 4;      // 16-byte vectors a lane has in flight

template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 store(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static float round(float x) { return x; }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const uint4& v, float* f) {  // element 2i is the low half of word i
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 store(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
};

__device__ __forceinline__ bool is_row(long long i, long long M) { return i >= 0 && i < M; }

// src (M, nvec) and out (rows, nvec) in 16-byte vectors; idx (rows,)
__global__ void __launch_bounds__(WARPS * 32)
    gather_rows_kernel(const uint4* __restrict__ src, const long long* __restrict__ idx, uint4* __restrict__ out,
                       long long rows, long long M, int nvec) {
  const long long r = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long i = idx[r];
  uint4* o = out + r * nvec;
  if (!is_row(i, M)) {
    for (int v = lane; v < nvec; v += 32) o[v] = make_uint4(0, 0, 0, 0);
    return;
  }
  const uint4* s = src + i * nvec;
  for (int v0 = lane; v0 < nvec; v0 += 32 * U) {
    uint4 buf[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (v0 + 32 * u < nvec) buf[u] = __ldg(s + v0 + 32 * u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (v0 + 32 * u < nvec) o[v0 + 32 * u] = buf[u];
    }
  }
}

// src (M, nvec) and out (rows, nvec) in 16-byte vectors of T; places (rows, k)
template <typename T, bool ROUND_EACH>
__global__ void __launch_bounds__(WARPS * 32)
    gather_sum_rows_kernel(const uint4* __restrict__ src, const long long* __restrict__ places,
                           uint4* __restrict__ out, long long rows, int k, long long M, int nvec) {
  constexpr int N = Vec<T>::N;
  const long long r = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long* p = places + r * k;
  uint4* o = out + r * nvec;
  for (int v0 = lane; v0 < nvec; v0 += 32 * U) {
    float acc[U][N];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int e = 0; e < N; ++e) acc[u][e] = 0.0f;
    }
    for (int j = 0; j < k; ++j) {
      const long long i = p[j];
      const bool live = is_row(i, M);
      uint4 buf[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        buf[u] = live && v0 + 32 * u < nvec ? __ldg(src + i * nvec + v0 + 32 * u) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float f[N];
        Vec<T>::load(buf[u], f);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          if (ROUND_EACH) {  // the first term as it is, then each sum rounded: a dead place adds +0
            acc[u][e] = j == 0 ? f[e] : Vec<T>::round(acc[u][e] + f[e]);
          } else {  // fp32 from +0
            acc[u][e] += f[e];
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (v0 + 32 * u < nvec) o[v0 + 32 * u] = Vec<T>::store(acc[u]);
    }
  }
}

unsigned blocks(long long rows) { return static_cast<unsigned>((rows + WARPS - 1) / WARPS); }

template <typename T>
cudaError_t launch_sum(const void* src, const void* places, void* out, long long rows, int k, long long M, int nvec,
                       bool fp32_sum, cudaStream_t stream) {
  const auto* s = static_cast<const uint4*>(src);
  const auto* p = static_cast<const long long*>(places);
  auto* o = static_cast<uint4*>(out);
  if (fp32_sum) {
    gather_sum_rows_kernel<T, false><<<blocks(rows), WARPS * 32, 0, stream>>>(s, p, o, rows, k, M, nvec);
  } else {
    gather_sum_rows_kernel<T, true><<<blocks(rows), WARPS * 32, 0, stream>>>(s, p, o, rows, k, M, nvec);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// src (M, row_bytes / 16 vectors) and out (rows, the same) contiguous and
// 16-byte aligned; idx (rows,) int64 contiguous. Returns the cudaError_t of
// the launch (0 on success).
int moe_gather_rows(const void* src, const void* idx, void* out, long long rows, long long M, long long row_bytes,
                    void* stream) {
  if (rows == 0 || row_bytes == 0) return 0;
  if (row_bytes % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  gather_rows_kernel<<<blocks(rows), WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<const long long*>(idx), static_cast<uint4*>(out), rows, M,
      static_cast<int>(row_bytes / 16));
  return static_cast<int>(cudaGetLastError());
}

// src (M, d) and out (rows, d) contiguous and 16-byte aligned, d a multiple
// of 8; places (rows, k) int64 contiguous. dtype: 0 = float32, 1 = bfloat16.
// fp32_sum: 0 rounds after each add, 1 sums in fp32 and rounds once.
int moe_gather_sum_rows(const void* src, const void* places, void* out, long long rows, int k, long long M, int d,
                        int dtype, int fp32_sum, void* stream) {
  if (rows == 0 || d == 0) return 0;
  if (d % 8 != 0 || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0 ? launch_sum<float>(src, places, out, rows, k, M, d / 4, fp32_sum, st)
                                     : launch_sum<__nv_bfloat16>(src, places, out, rows, k, M, d / 8, fp32_sum, st));
}

const char* moe_gather_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
