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
//   qx_philox                    (test entry: raw Philox4x32-10 words)
//
// Kernels 1, 2 and 5 take their stochastic-rounding noise from a
// compile-time source: the host's [rows, bucket] f32 buffer, or — the
// device-PRNG variants, replacing repro/kernels/common.py::prng_uniform
// (TPU kernel B5) at its call sites in quantize.py, dequant_reduce.py and
// segment_quantize.py — Philox4x32-10 computed in registers from a 64-bit
// seed passed by value, with no noise buffer read and no host-to-card copy.
// Coordinate (row, col) of a launch draws output word col % 4 of Philox at
// counter (row, col / 4, 0, 0) under key (seed low word, seed high word),
// mapped to the reference's 24-bit grid ((w >> 8) & 0xFFFFFF) * 2^-24: a
// function of (seed, row, col) only, equal to the plain version
// repro_torch/kernels/ref.py::philox_uniform whatever the block shape.
// Dropping the buffer takes 4 B per coordinate off each kernel's traffic
// and adds ~25 integer operations per coordinate (10 Philox rounds per
// four draws), so the device-PRNG variants of kernels 1 and 2 may be bound
// by integer issue rather than by bytes.
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

// ---------------------------------------------------------------------------
// Rounding noise sources (compile-time)
// ---------------------------------------------------------------------------

// Philox4x32-10 (Salmon et al., SC'11, with the Random123 constants):
// one call maps a 128-bit counter and a 64-bit key to four 32-bit words.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i > 0) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// One word -> the 24-bit grid in [0, 1) (exact: a 24-bit integer times 2^-24).
__device__ __forceinline__ float u24(uint32_t w) {
  return __fmul_rn(__uint2float_rn(w >> 8), 5.9604644775390625e-08f);
}

__device__ __forceinline__ uint2 seed_key(unsigned long long seed) {
  return make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
}

// The host draw: one row of the [rows, bucket] f32 noise buffer.
struct BufferNoise {
  const float* row;
  template <int VEC>
  __device__ __forceinline__ void get(int col, float* r) const {
    load_vec<VEC>(row + col, r);
  }
};

// The device draw (B5): the VEC draws of columns col .. col + VEC - 1.
struct PhiloxNoise {
  uint2 key;
  uint32_t row;
  template <int VEC>
  __device__ __forceinline__ void get(int col, float* r) const {
    if constexpr (VEC == 4) {  // col % 4 == 0: the four words of one counter
      const uint4 w = philox4x32_10(make_uint4(row, static_cast<uint32_t>(col) >> 2, 0u, 0u),
                                    key);
      r[0] = u24(w.x); r[1] = u24(w.y); r[2] = u24(w.z); r[3] = u24(w.w);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const uint32_t c = static_cast<uint32_t>(col + e);
        const uint4 w = philox4x32_10(make_uint4(row, c >> 2, 0u, 0u), key);
        const uint32_t lane = c & 3u;
        r[e] = u24(lane == 0 ? w.x : lane == 1 ? w.y : lane == 2 ? w.z : w.w);
      }
    }
  }
};

// Kernel 5's nearest rounding: no noise at all.
struct NoNoise {};

// The source of one launch row: the buffer's row, or Philox at this row.
template <class Noise>
__device__ __forceinline__ Noise row_noise(const float* noise, unsigned long long seed,
                                           long long row, int bucket) {
  if constexpr (std::is_same<Noise, BufferNoise>::value) {
    return BufferNoise{noise + row * bucket};
  } else if constexpr (std::is_same<Noise, PhiloxNoise>::value) {
    return PhiloxNoise{seed_key(seed), static_cast<uint32_t>(row)};
  } else {
    return NoNoise{};
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
// row's noise source; writes the payload row and the row norm.
template <int VEC, bool PACK4, class Noise>
__device__ __forceinline__ void quantize_row(const float* src, const Noise& noise,
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
    noise.template get<VEC>(g * VEC, r);
#pragma unroll
    for (int e = 0; e < VEC; ++e) q[e] = quant_one(v[e], r[e], safe, s_lv, num_symbols);
    store_indices<VEC, PACK4>(out_row, g * VEC, q);
  }
  if (threadIdx.x == 0) *norm_out = norm;
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

template <int VEC, bool PACK4, class Noise>
__global__ void quantize_kernel(const float* __restrict__ x,
                                const float* __restrict__ noise, unsigned long long seed,
                                const float* __restrict__ levels, int num_symbols,
                                int bucket, bool q_is_inf,
                                int8_t* __restrict__ out, float* __restrict__ norms) {
  __shared__ float s_lv[kMaxSymbols];
  __shared__ float s_red[32];
  load_levels(s_lv, levels, num_symbols);
  __syncthreads();
  const long long row = blockIdx.x;
  const long long pcols = PACK4 ? bucket / 2 : bucket;
  quantize_row<VEC, PACK4>(x + row * bucket, row_noise<Noise>(noise, seed, row, bucket),
                           bucket, q_is_inf, s_lv, num_symbols, s_red, out + row * pcols,
                           norms + row);
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
template <int VEC, bool PACK4, class Noise>
__global__ void dequant_reduce_requantize_kernel(
    const int8_t* __restrict__ idx, const float* __restrict__ norms,
    const float* __restrict__ noise, unsigned long long seed,
    const float* __restrict__ levels,
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
  quantize_row<VEC, PACK4>(s_row, row_noise<Noise>(noise, seed, row, bucket), bucket,
                           q_is_inf, s_lv, num_symbols, s_red, out + row * pcols,
                           onorms + row);
}


// Kernel 5: fused Q∘DEQ of one bucket row under its own level table.  The
// row's table t = seg[row] is one of the T stacked tables (shared memory,
// T * S_max floats); only the f32 estimate is written.  The bracket counts
// the interior levels 1 .. ns[t] - 2 of table t — the reference's masked
// compare over the union of levels, which never counts a row against
// another table's entries or the 1.0 padding.  The clamp keeps a NaN
// (as jnp.clip and torch.clamp do) so a non-finite row matches the plain
// version; a table id outside [0, T) writes NaN over its row.  Noise is
// NoNoise for nearest rounding (xi >= 0.5).
struct SymbolCounts {
  int v[kMaxTables];
};

template <int VEC, class Noise>
__global__ void segment_qdq_kernel(const float* __restrict__ x,
                                   const float* __restrict__ noise, unsigned long long seed,
                                   const float* __restrict__ tables,
                                   const int* __restrict__ seg, int T, int s_max,
                                   SymbolCounts ns, int bucket, bool q_is_inf,
                                   float* __restrict__ out) {
  constexpr bool STOCHASTIC = !std::is_same<Noise, NoNoise>::value;
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
  const Noise src = row_noise<Noise>(noise, seed, row, bucket);
  for (int g = threadIdx.x; g < ngroups; g += blockDim.x) {
    float v[VEC], r[VEC];
    load_vec<VEC>(x_row + g * VEC, v);
    if constexpr (STOCHASTIC) src.template get<VEC>(g * VEC, r);
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

// Test entry: raw Philox4x32-10 words of n (counter, key) pairs, so the
// known-answer vectors can be checked on the card.
__global__ void philox_kernel(const uint4* __restrict__ ctr, const uint2* __restrict__ key,
                              long long n, uint4* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) out[i] = philox4x32_10(ctr[i], key[i]);
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

template <class T>
struct Tag {
  using type = T;
};

// Calls f(Tag<PhiloxNoise>) or f(Tag<BufferNoise>).
template <class F>
void with_noise(bool device_prng, F&& f) {
  if (device_prng) f(Tag<PhiloxNoise>{}); else f(Tag<BufferNoise>{});
}

// A launch's noise arguments: the device PRNG takes no buffer, the host
// draw needs one.
bool bad_noise(const float* noise, int device_prng) {
  return device_prng ? noise != nullptr : noise == nullptr;
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

int qx_quantize(const float* x, const float* noise, unsigned long long seed,
                int device_prng, const float* levels, int num_symbols, long long nb,
                int bucket, int q_is_inf, int bits, int8_t* out, float* norms, int device,
                void* stream) {
  const bool pack4 = bits == 4;
  const int vec = pick_vec(bucket, pack4);
  if (bad_args(num_symbols, nb, bucket, vec) || bad_noise(noise, device_prng))
    return cudaErrorInvalidValue;
  if (nb == 0) return cudaSuccess;
  if (cudaError_t e = cudaSetDevice(device)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(bucket, vec);
  dispatch(vec, pack4, [&](auto v, auto p) {
    with_noise(device_prng != 0, [&](auto n) {
      quantize_kernel<decltype(v)::value, decltype(p)::value, typename decltype(n)::type>
          <<<(unsigned)nb, threads, 0, s>>>(x, noise, seed, levels, num_symbols, bucket,
                                            q_is_inf != 0, out, norms);
    });
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
                                 const float* noise, unsigned long long seed,
                                 int device_prng, const float* levels,
                                 int num_symbols, int K, long long nb, int bucket,
                                 int q_is_inf, int bits, float inv_k, int8_t* out,
                                 float* onorms, int device, void* stream) {
  const bool pack4 = bits == 4;
  const int vec = pick_vec(bucket, pack4);
  // the reduced row is staged in dynamic shared memory (48 KB default cap)
  const size_t smem = sizeof(float) * (size_t)bucket;
  if (bad_args(num_symbols, nb, bucket, vec) || K < 1 || smem > 48 * 1024 ||
      bad_noise(noise, device_prng))
    return cudaErrorInvalidValue;
  if (nb == 0) return cudaSuccess;
  if (cudaError_t e = cudaSetDevice(device)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(bucket, vec);
  dispatch(vec, pack4, [&](auto v, auto p) {
    with_noise(device_prng != 0, [&](auto n) {
      dequant_reduce_requantize_kernel<decltype(v)::value, decltype(p)::value,
                                       typename decltype(n)::type>
          <<<(unsigned)nb, threads, smem, s>>>(idx, norms, noise, seed, levels, num_symbols,
                                               K, nb, bucket, q_is_inf != 0, inv_k, out,
                                               onorms);
    });
  });
  return cudaGetLastError();
}

int qx_segment_qdq(const float* x, const float* noise, unsigned long long seed,
                   int device_prng, const float* tables, const int* seg, int T, int s_max,
                   const int* num_symbols, long long nb, int bucket, int q_is_inf,
                   int stochastic, float* out, int device, void* stream) {
  const int vec = pick_vec(bucket, false);
  // the stacked tables are staged in dynamic shared memory (48 KB default cap)
  const size_t smem = sizeof(float) * (size_t)T * (size_t)s_max;
  if (T < 1 || T > kMaxTables || s_max < 2 || s_max > kMaxSymbols || nb < 0 ||
      nb > 0x7fffffffLL || bucket <= 0 || smem > 48 * 1024 ||
      (stochastic ? bad_noise(noise, device_prng) : device_prng != 0))
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
  auto launch = [&](auto n) {
    using Noise = typename decltype(n)::type;
    if (vec == 4) {
      segment_qdq_kernel<4, Noise><<<(unsigned)nb, threads, smem, s>>>(
          x, noise, seed, tables, seg, T, s_max, ns, bucket, q_is_inf != 0, out);
    } else if (vec == 2) {
      segment_qdq_kernel<2, Noise><<<(unsigned)nb, threads, smem, s>>>(
          x, noise, seed, tables, seg, T, s_max, ns, bucket, q_is_inf != 0, out);
    } else {
      segment_qdq_kernel<1, Noise><<<(unsigned)nb, threads, smem, s>>>(
          x, noise, seed, tables, seg, T, s_max, ns, bucket, q_is_inf != 0, out);
    }
  };
  if (stochastic) with_noise(device_prng != 0, launch); else launch(Tag<NoNoise>{});
  return cudaGetLastError();
}

int qx_philox(const uint32_t* ctr, const uint32_t* key, long long n, uint32_t* out,
              int device, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if (cudaError_t e = cudaSetDevice(device)) return e;
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  philox_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(ctr), reinterpret_cast<const uint2*>(key), n,
      reinterpret_cast<uint4*>(out));
  return cudaGetLastError();
}

}  // extern "C"
