// Hand-written Hopper (sm_90a) kernels for the Q-GenX exchange.
//
// One source for the five exchange kernels, sharing __device__ row
// helpers the way repro/kernels/common.py is shared by the Pallas kernels:
//
//   qx_quantize                  <- repro/kernels/quantize.py::quantize_blocks
//   qx_dequant_reduce_requantize <- repro/kernels/dequant_reduce.py::
//                                     dequant_reduce_requantize_blocks
//   qx_dequantize                <- repro/kernels/dequantize.py::dequantize_blocks
//   qx_dequant_reduce            <- repro/kernels/dequant_reduce.py::dequant_reduce_blocks
//   qx_segment_qdq               <- repro/kernels/segment_quantize.py::
//                                     quantize_dequantize_segments
//
// Design (same for all five): one thread block per bucket row, the level
// table (s + 2 <= 128 floats; kernel 5: the stacked [T, S_max] tables)
// staged in shared memory, a block reduction
// for the row norm, 16-byte loads and stores when the bucket width allows
// (VEC = 4 coordinates per thread step), and the ragged row edge handled
// here — no padding of rows to a tile multiple.  All four are bound by
// device-memory traffic on the H100 (a few flops per byte moved), so the
// design reads each input once from HBM and writes each output once.
//
// Bit parity with the reference: u = |x| / norm and xi = (u - lo) / (hi -
// lo) are IEEE round-to-nearest divisions (__fdiv_rn), products and sums
// use the _rn intrinsics so nvcc cannot contract them into FMAs (the file
// is also built with -fmad=false), and the K-mean is acc * (1/K) summed in
// worker order — the Pallas kernels' arithmetic.  Indices, packed bytes,
// L^inf norms and kernel 5's estimates therefore match the plain PyTorch
// versions bit for bit; L^2 norms differ only in summation order.
//
// Plain C interface (bound with ctypes): every entry point selects the
// tensors' device, launches on PyTorch's current stream and returns the
// cudaError_t of its launch.  The caller allocates every buffer.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxSymbols = 128;
constexpr int kMaxThreads = 256;
constexpr int kMaxTables = 32;  // kernel 5: level tables per launch

// ---------------------------------------------------------------------------
// Shared row helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load_levels(float* s_lv, const float* levels,
                                            int num_symbols) {
  for (int j = threadIdx.x; j < num_symbols; j += blockDim.x) s_lv[j] = levels[j];
}

// max that propagates NaN, as jnp.max and torch.amax do (fmaxf drops it,
// which would hide a non-finite gradient behind a finite norm)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Block-wide max (q = inf) or sum (q = 2) of one float per thread.
__device__ __forceinline__ float block_reduce(float v, bool is_max, float* s_red) {
  for (int off = 16; off > 0; off >>= 1) {
    float o = __shfl_down_sync(0xffffffffu, v, off);
    v = is_max ? nan_max(v, o) : __fadd_rn(v, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? s_red[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      float o = __shfl_down_sync(0xffffffffu, v, off);
      v = is_max ? nan_max(v, o) : __fadd_rn(v, o);
    }
    if (lane == 0) s_red[0] = v;
  }
  __syncthreads();
  float r = s_red[0];
  __syncthreads();  // s_red is reused by the next reduction
  return r;
}

__device__ __forceinline__ float norm_term(float x, bool is_max) {
  return is_max ? fabsf(x) : __fmul_rn(x, x);
}

__device__ __forceinline__ float finish_norm(float acc, bool is_max) {
  return is_max ? acc : __fsqrt_rn(acc);
}

// Q of one coordinate: signed level index of x given the row's safe norm.
__device__ __forceinline__ int quant_one(float x, float r, float safe,
                                         const float* s_lv, int num_symbols) {
  float u = __fdiv_rn(fabsf(x), safe);
  u = fminf(fmaxf(u, 0.0f), 1.0f);
  int tau = 0;
  for (int j = 1; j < num_symbols - 1; ++j) tau += (u >= s_lv[j]) ? 1 : 0;
  const float lo = s_lv[tau], hi = s_lv[tau + 1];
  const float xi = __fdiv_rn(__fsub_rn(u, lo), __fsub_rn(hi, lo));
  const int idx = tau + ((r < xi) ? 1 : 0);
  return x < 0.0f ? -idx : idx;
}

// DEQ of one signed index.
__device__ __forceinline__ float deq_one(int i, float norm, const float* s_lv) {
  float v = s_lv[i < 0 ? -i : i];
  v = i < 0 ? -v : v;
  return __fmul_rn(v, norm);
}

__device__ __forceinline__ uint8_t pack_pair(int a, int b) {
  return static_cast<uint8_t>((a & 0xF) | ((b & 0xF) << 4));
}

__device__ __forceinline__ int nib_lo(uint8_t byte) {
  int a = byte & 0xF;
  return a >= 8 ? a - 16 : a;
}

__device__ __forceinline__ int nib_hi(uint8_t byte) {
  int b = (byte >> 4) & 0xF;
  return b >= 8 ? b - 16 : b;
}

// Load VEC consecutive floats starting at p (16-byte load when VEC == 4).
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = p[e];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) p[e] = v[e];
  }
}

// Write VEC signed indices as int8 (VEC bytes) or packed int4 (VEC/2 bytes).
template <int VEC, bool PACK4>
__device__ __forceinline__ void store_indices(int8_t* row_out, int col, const int* q) {
  if constexpr (PACK4) {
    uint8_t* o = reinterpret_cast<uint8_t*>(row_out) + col / 2;
#pragma unroll
    for (int e = 0; e < VEC; e += 2) o[e / 2] = pack_pair(q[e], q[e + 1]);
  } else if constexpr (VEC == 4) {
    char4 c = make_char4(q[0], q[1], q[2], q[3]);
    *reinterpret_cast<char4*>(row_out + col) = c;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) row_out[col + e] = static_cast<int8_t>(q[e]);
  }
}

// Read VEC signed indices starting at column col of one payload row.
template <int VEC, bool PACK4>
__device__ __forceinline__ void load_indices(const int8_t* row_in, int col, int* q) {
  if constexpr (PACK4) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(row_in) + col / 2;
#pragma unroll
    for (int e = 0; e < VEC; e += 2) {
      const uint8_t byte = p[e / 2];
      q[e] = nib_lo(byte);
      q[e + 1] = nib_hi(byte);
    }
  } else if constexpr (VEC == 4) {
    const char4 c = *reinterpret_cast<const char4*>(row_in + col);
    q[0] = c.x; q[1] = c.y; q[2] = c.z; q[3] = c.w;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) q[e] = row_in[col + e];
  }
}

// Quantize one row held at `src` (global or shared memory) against the
// noise row; writes the payload row and the row norm.
template <int VEC, bool PACK4>
__device__ __forceinline__ void quantize_row(const float* src, const float* noise_row,
                                             int bucket, bool q_is_inf,
                                             const float* s_lv, int num_symbols,
                                             float* s_red, int8_t* out_row,
                                             float* norm_out) {
  const int ngroups = bucket / VEC;
  float part = 0.0f;
  for (int g = threadIdx.x; g < ngroups; g += blockDim.x) {
    float v[VEC];
    load_vec<VEC>(src + g * VEC, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float t = norm_term(v[e], q_is_inf);
      part = q_is_inf ? nan_max(part, t) : __fadd_rn(part, t);
    }
  }
  const float norm = finish_norm(block_reduce(part, q_is_inf, s_red), q_is_inf);
  const float safe = norm > 0.0f ? norm : 1.0f;
  for (int g = threadIdx.x; g < ngroups; g += blockDim.x) {
    float v[VEC], r[VEC];
    int q[VEC];
    load_vec<VEC>(src + g * VEC, v);
    load_vec<VEC>(noise_row + g * VEC, r);
#pragma unroll
    for (int e = 0; e < VEC; ++e) q[e] = quant_one(v[e], r[e], safe, s_lv, num_symbols);
    store_indices<VEC, PACK4>(out_row, g * VEC, q);
  }
  if (threadIdx.x == 0) *norm_out = norm;
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

template <int VEC, bool PACK4>
__global__ void quantize_kernel(const float* __restrict__ x,
                                const float* __restrict__ noise,
                                const float* __restrict__ levels, int num_symbols,
                                int bucket, bool q_is_inf,
                                int8_t* __restrict__ out, float* __restrict__ norms) {
  __shared__ float s_lv[kMaxSymbols];
  __shared__ float s_red[32];
  load_levels(s_lv, levels, num_symbols);
  __syncthreads();
  const long long row = blockIdx.x;
  const long long pcols = PACK4 ? bucket / 2 : bucket;
  quantize_row<VEC, PACK4>(x + row * bucket, noise + row * bucket, bucket, q_is_inf,
                           s_lv, num_symbols, s_red, out + row * pcols, norms + row);
}

template <int VEC, bool PACK4>
__global__ void dequantize_kernel(const int8_t* __restrict__ idx,
                                  const float* __restrict__ norms,
                                  const float* __restrict__ levels, int num_symbols,
                                  int bucket, float* __restrict__ out) {
  __shared__ float s_lv[kMaxSymbols];
  load_levels(s_lv, levels, num_symbols);
  __syncthreads();
  const long long row = blockIdx.x;
  const long long pcols = PACK4 ? bucket / 2 : bucket;
  const float norm = norms[row];
  const int8_t* in_row = idx + row * pcols;
  float* out_row = out + row * bucket;
  for (int g = threadIdx.x; g < bucket / VEC; g += blockDim.x) {
    int q[VEC];
    float v[VEC];
    load_indices<VEC, PACK4>(in_row, g * VEC, q);
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = deq_one(q[e], norm, s_lv);
    store_vec<VEC>(out_row + g * VEC, v);
  }
}

// acc = sum_k DEQ(payload_k) in worker order, then acc * (1/K).
template <int VEC, bool PACK4>
__device__ __forceinline__ void mean_group(const int8_t* idx, const float* norms,
                                           int K, long long nb, long long row,
                                           int bucket, int col, float inv_k,
                                           const float* s_lv, float* acc) {
  const long long pcols = PACK4 ? bucket / 2 : bucket;
  for (int k = 0; k < K; ++k) {
    int q[VEC];
    const long long r = (long long)k * nb + row;
    load_indices<VEC, PACK4>(idx + r * pcols, col, q);
    const float norm = norms[r];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float term = deq_one(q[e], norm, s_lv);
      acc[e] = k == 0 ? term : __fadd_rn(acc[e], term);
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = __fmul_rn(acc[e], inv_k);
}

template <int VEC, bool PACK4>
__global__ void dequant_reduce_kernel(const int8_t* __restrict__ idx,
                                      const float* __restrict__ norms,
                                      const float* __restrict__ levels, int num_symbols,
                                      int K, long long nb, int bucket, float inv_k,
                                      float* __restrict__ out) {
  __shared__ float s_lv[kMaxSymbols];
  load_levels(s_lv, levels, num_symbols);
  __syncthreads();
  const long long row = blockIdx.x;
  for (int g = threadIdx.x; g < bucket / VEC; g += blockDim.x) {
    float acc[VEC];
    mean_group<VEC, PACK4>(idx, norms, K, nb, row, bucket, g * VEC, inv_k, s_lv, acc);
    store_vec<VEC>(out + row * bucket + g * VEC, acc);
  }
}

// The reduced row lives only in shared memory (dynamic, bucket floats).
template <int VEC, bool PACK4>
__global__ void dequant_reduce_requantize_kernel(
    const int8_t* __restrict__ idx, const float* __restrict__ norms,
    const float* __restrict__ noise, const float* __restrict__ levels,
    int num_symbols, int K, long long nb, int bucket, bool q_is_inf, float inv_k,
    int8_t* __restrict__ out, float* __restrict__ onorms) {
  extern __shared__ float4 s_dyn[];
  float* s_row = reinterpret_cast<float*>(s_dyn);
  __shared__ float s_lv[kMaxSymbols];
  __shared__ float s_red[32];
  load_levels(s_lv, levels, num_symbols);
  __syncthreads();
  const long long row = blockIdx.x;
  for (int g = threadIdx.x; g < bucket / VEC; g += blockDim.x) {
    float acc[VEC];
    mean_group<VEC, PACK4>(idx, norms, K, nb, row, bucket, g * VEC, inv_k, s_lv, acc);
    store_vec<VEC>(s_row + g * VEC, acc);
  }
  __syncthreads();
  const long long pcols = PACK4 ? bucket / 2 : bucket;
  quantize_row<VEC, PACK4>(s_row, noise + row * bucket, bucket, q_is_inf, s_lv,
                           num_symbols, s_red, out + row * pcols, onorms + row);
}


// Kernel 5: fused Q∘DEQ of one bucket row under its own level table.  The
// row's table t = seg[row] is one of the T stacked tables (shared memory,
// T * S_max floats); only the f32 estimate is written.  The bracket counts
// the interior levels 1 .. ns[t] - 2 of table t — the reference's masked
// compare over the union of levels, which never counts a row against
// another table's entries or the 1.0 padding.  The clamp keeps a NaN
// (as jnp.clip and torch.clamp do) so a non-finite row matches the plain
// version; a table id outside [0, T) writes NaN over its row.
struct SymbolCounts {
  int v[kMaxTables];
};

template <int VEC, bool STOCHASTIC>
__global__ void segment_qdq_kernel(const float* __restrict__ x,
                                   const float* __restrict__ noise,
                                   const float* __restrict__ tables,
                                   const int* __restrict__ seg, int T, int s_max,
                                   SymbolCounts ns, int bucket, bool q_is_inf,
                                   float* __restrict__ out) {
  extern __shared__ float4 s_dyn[];
  float* s_tab = reinterpret_cast<float*>(s_dyn);
  __shared__ float s_red[32];
  for (int j = threadIdx.x; j < T * s_max; j += blockDim.x) s_tab[j] = tables[j];
  __syncthreads();
  const long long row = blockIdx.x;
  const float* x_row = x + row * bucket;
  float* out_row = out + row * bucket;
  const int t = seg[row];
  const int ngroups = bucket / VEC;
  if (t < 0 || t >= T) {
    for (int g = threadIdx.x; g < ngroups; g += blockDim.x) {
      float v[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = __int_as_float(0x7fc00000);
      store_vec<VEC>(out_row + g * VEC, v);
    }
    return;
  }
  const float* lv = s_tab + t * s_max;
  const int top = ns.v[t] - 1;  // interior levels are 1 .. top - 1
  float part = 0.0f;
  for (int g = threadIdx.x; g < ngroups; g += blockDim.x) {
    float v[VEC];
    load_vec<VEC>(x_row + g * VEC, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float a = norm_term(v[e], q_is_inf);
      part = q_is_inf ? nan_max(part, a) : __fadd_rn(part, a);
    }
  }
  const float norm = finish_norm(block_reduce(part, q_is_inf, s_red), q_is_inf);
  const float safe = norm > 0.0f ? norm : 1.0f;
  for (int g = threadIdx.x; g < ngroups; g += blockDim.x) {
    float v[VEC], r[VEC];
    load_vec<VEC>(x_row + g * VEC, v);
    if constexpr (STOCHASTIC) load_vec<VEC>(noise + row * bucket + g * VEC, r);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float u = __fdiv_rn(fabsf(v[e]), safe);
      u = u > 1.0f ? 1.0f : (u < 0.0f ? 0.0f : u);
      int tau = 0;
      for (int j = 1; j < top; ++j) tau += (u >= lv[j]) ? 1 : 0;
      const float lo = lv[tau], hi = lv[tau + 1];
      const float xi = __fdiv_rn(__fsub_rn(u, lo), __fsub_rn(hi, lo));
      const bool up = STOCHASTIC ? (r[e] < xi) : (xi >= 0.5f);
      const float q = lv[tau + (up ? 1 : 0)];
      v[e] = __fmul_rn(v[e] < 0.0f ? -q : q, norm);
    }
    store_vec<VEC>(out_row + g * VEC, v);
  }
}

int threads_for(int bucket, int vec) {
  int groups = bucket / vec;
  int t = ((groups + 31) / 32) * 32;
  if (t > kMaxThreads) t = kMaxThreads;
  if (t < 32) t = 32;
  return t;
}

// VEC = 4 when the bucket is a multiple of 4 (16-byte accesses; every row
// starts 16-byte aligned), else 2 (int4 needs pairs), else 1 (int8 only).
int pick_vec(int bucket, bool pack4) {
  if (bucket % 4 == 0) return 4;
  if (bucket % 2 == 0) return 2;
  return pack4 ? 0 : 1;
}

bool bad_args(int num_symbols, long long nb, int bucket, int vec) {
  return num_symbols < 2 || num_symbols > kMaxSymbols || nb < 0 || nb > 0x7fffffffLL ||
         bucket <= 0 || vec == 0;
}

// Calls f(integral_constant<VEC>, bool_constant<PACK4>) for the runtime
// (vec, pack4) pair; int4 packing is only instantiated for even VEC.
template <class F>
void dispatch(int vec, bool pack4, F&& f) {
  using V4 = std::integral_constant<int, 4>;
  using V2 = std::integral_constant<int, 2>;
  using V1 = std::integral_constant<int, 1>;
  if (vec == 4) {
    if (pack4) f(V4{}, std::true_type{}); else f(V4{}, std::false_type{});
  } else if (vec == 2) {
    if (pack4) f(V2{}, std::true_type{}); else f(V2{}, std::false_type{});
  } else {
    f(V1{}, std::false_type{});
  }
}

}  // namespace

extern "C" {

int qx_quantize(const float* x, const float* noise, const float* levels,
                int num_symbols, long long nb, int bucket, int q_is_inf, int bits,
                int8_t* out, float* norms, int device, void* stream) {
  const bool pack4 = bits == 4;
  const int vec = pick_vec(bucket, pack4);
  if (bad_args(num_symbols, nb, bucket, vec)) return cudaErrorInvalidValue;
  if (nb == 0) return cudaSuccess;
  if (cudaError_t e = cudaSetDevice(device)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(bucket, vec);
  dispatch(vec, pack4, [&](auto v, auto p) {
    quantize_kernel<decltype(v)::value, decltype(p)::value><<<(unsigned)nb, threads, 0, s>>>(
        x, noise, levels, num_symbols, bucket, q_is_inf != 0, out, norms);
  });
  return cudaGetLastError();
}

int qx_dequantize(const int8_t* idx, const float* norms, const float* levels,
                  int num_symbols, long long nb, int bucket, int bits, float* out,
                  int device, void* stream) {
  const bool pack4 = bits == 4;
  const int vec = pick_vec(bucket, pack4);
  if (bad_args(num_symbols, nb, bucket, vec)) return cudaErrorInvalidValue;
  if (nb == 0) return cudaSuccess;
  if (cudaError_t e = cudaSetDevice(device)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(bucket, vec);
  dispatch(vec, pack4, [&](auto v, auto p) {
    dequantize_kernel<decltype(v)::value, decltype(p)::value><<<(unsigned)nb, threads, 0, s>>>(
        idx, norms, levels, num_symbols, bucket, out);
  });
  return cudaGetLastError();
}

int qx_dequant_reduce(const int8_t* idx, const float* norms, const float* levels,
                      int num_symbols, int K, long long nb, int bucket, int bits,
                      float inv_k, float* out, int device, void* stream) {
  const bool pack4 = bits == 4;
  const int vec = pick_vec(bucket, pack4);
  if (bad_args(num_symbols, nb, bucket, vec) || K < 1) return cudaErrorInvalidValue;
  if (nb == 0) return cudaSuccess;
  if (cudaError_t e = cudaSetDevice(device)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(bucket, vec);
  dispatch(vec, pack4, [&](auto v, auto p) {
    dequant_reduce_kernel<decltype(v)::value, decltype(p)::value>
        <<<(unsigned)nb, threads, 0, s>>>(idx, norms, levels, num_symbols, K, nb, bucket,
                                          inv_k, out);
  });
  return cudaGetLastError();
}

int qx_dequant_reduce_requantize(const int8_t* idx, const float* norms,
                                 const float* noise, const float* levels,
                                 int num_symbols, int K, long long nb, int bucket,
                                 int q_is_inf, int bits, float inv_k, int8_t* out,
                                 float* onorms, int device, void* stream) {
  const bool pack4 = bits == 4;
  const int vec = pick_vec(bucket, pack4);
  // the reduced row is staged in dynamic shared memory (48 KB default cap)
  const size_t smem = sizeof(float) * (size_t)bucket;
  if (bad_args(num_symbols, nb, bucket, vec) || K < 1 || smem > 48 * 1024)
    return cudaErrorInvalidValue;
  if (nb == 0) return cudaSuccess;
  if (cudaError_t e = cudaSetDevice(device)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(bucket, vec);
  dispatch(vec, pack4, [&](auto v, auto p) {
    dequant_reduce_requantize_kernel<decltype(v)::value, decltype(p)::value>
        <<<(unsigned)nb, threads, smem, s>>>(idx, norms, noise, levels, num_symbols, K, nb,
                                             bucket, q_is_inf != 0, inv_k, out, onorms);
  });
  return cudaGetLastError();
}

int qx_segment_qdq(const float* x, const float* noise, const float* tables,
                   const int* seg, int T, int s_max, const int* num_symbols,
                   long long nb, int bucket, int q_is_inf, int stochastic, float* out,
                   int device, void* stream) {
  const int vec = pick_vec(bucket, false);
  // the stacked tables are staged in dynamic shared memory (48 KB default cap)
  const size_t smem = sizeof(float) * (size_t)T * (size_t)s_max;
  if (T < 1 || T > kMaxTables || s_max < 2 || s_max > kMaxSymbols || nb < 0 ||
      nb > 0x7fffffffLL || bucket <= 0 || smem > 48 * 1024 || (stochastic && !noise))
    return cudaErrorInvalidValue;
  SymbolCounts ns = {};
  for (int t = 0; t < T; ++t) {
    if (num_symbols[t] < 2 || num_symbols[t] > s_max) return cudaErrorInvalidValue;
    ns.v[t] = num_symbols[t];
  }
  if (nb == 0) return cudaSuccess;
  if (cudaError_t e = cudaSetDevice(device)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(bucket, vec);
  auto launch = [&](auto v, auto st) {
    segment_qdq_kernel<decltype(v)::value, decltype(st)::value>
        <<<(unsigned)nb, threads, smem, s>>>(x, noise, tables, seg, T, s_max, ns, bucket,
                                             q_is_inf != 0, out);
  };
  using V4 = std::integral_constant<int, 4>;
  using V2 = std::integral_constant<int, 2>;
  using V1 = std::integral_constant<int, 1>;
  if (stochastic) {
    if (vec == 4) launch(V4{}, std::true_type{});
    else if (vec == 2) launch(V2{}, std::true_type{});
    else launch(V1{}, std::true_type{});
  } else {
    if (vec == 4) launch(V4{}, std::false_type{});
    else if (vec == 2) launch(V2{}, std::false_type{});
    else launch(V1{}, std::false_type{});
  }
  return cudaGetLastError();
}

}  // extern "C"
