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
// and adds ~12 integer operations per coordinate (10 Philox rounds per
// four draws).
//
// What bounds them on the H100.  Kernels 3 and 4 by device-memory bytes
// (a few flops per byte moved).  Kernels 1, 2 and 5 move few bytes per
// coordinate for what they compute (two IEEE divisions, the bracket, the
// rounding and, for kernel 2, the dequantized K-mean: ~60-80 issued
// instructions per coordinate), so instruction issue bounds them as much
// as bytes: kernel 1 with host noise sits near its byte bound, kernel 2
// and the device-draw variants (+~15 issue slots per coordinate for
// Philox, whose multiplies run at half rate) are bound by issue.
//
// Kernels 1, 2 and 5 (quantize; dequant∘mean∘requantize; the segment-fused
// quantize∘dequantize): one warp per bucket row, kWarpRows rows to a
// block, each warp striding over the rows of a grid sized to fill every SM
// (row_grid, given the kernel's real shared memory).  A lane holds
// kLaneCols = 8 coordinates in registers, a 256-wide chunk per warp (two
// 16-byte groups a lane when the bucket is a multiple of 4, the warp's
// lanes on neighbouring groups so that each access of the warp is one
// contiguous span); that keeps a thread near 64 registers, 32 warps an SM,
// enough to hide each row's load latency behind the other warps'
// arithmetic (16 coordinates a lane took ~100 registers and ran slower;
// kernel 5's two chunks take 72, 24 warps an SM).  The row norm is
// a warp-shuffle reduction: no block barrier once the level table is
// staged.  Kernel 2 computes the K-mean straight into those registers; the
// reduced row never leaves them.  A row wider than one chunk (the main
// path's 512 is two) keeps its first chunk in registers and takes a second
// pass over the rest: kernel 1 re-reads x (from L1/L2), kernel 2
// recomputes the K-mean from the payload (the same arithmetic, so the same
// bits); kernel 5 holds two chunks, a 512 row whole, and re-reads only
// past them.  The host noise is loaded together with the row (kernel 2:
// right after worker 0's payload, before anything waits on it); the device draw
// is computed at that point too, before the norm, under the loads'
// latency.  The bracket tau = #{1 <= j <= s : lv[j] <= u} is one lookup in
// a 257-cell table of [0, 1] and one compare when no cell holds two levels
// (every uniform table), else a binary search over the interior levels (4
// steps for s = 15, where a scan compares 15 times); kernel 5 keeps one
// such cell table per stacked level table, in a compact layout.  Either
// equals the reference's compare count for a SORTED level table only:
// every table the port builds is one (uniform_levels, exponential_levels;
// validate_levels requires strictly increasing levels), and a caller of
// these kernels must keep to that.  A zero dividend skips __fdiv_rn's slow
// path (0 / b = +0).
//
// Kernels 3 and 4: one thread block per bucket row, the level table (s + 2
// <= 128 floats) staged in shared memory, 16-byte loads and stores when
// the bucket width allows (VEC = 4 coordinates per thread step).  All five
// handle the ragged row edge here — no padding of rows to a tile multiple
// — and read each input once from HBM and write each output once.
//
// Bit parity with the reference: u = |x| / norm and xi = (u - lo) / (hi -
// lo) are IEEE round-to-nearest divisions (__fdiv_rn, or div_rn), products
// and sums use the _rn intrinsics so nvcc cannot contract them into FMAs
// (the file is also built with -fmad=false), and the K-mean is acc * (1/K) summed in
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

__device__ __forceinline__ float norm_term(float x, bool is_max) {
  return is_max ? fabsf(x) : __fmul_rn(x, x);
}

__device__ __forceinline__ float finish_norm(float acc, bool is_max) {
  return is_max ? acc : __fsqrt_rn(acc);
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
  if constexpr (PACK4 && VEC == 4) {  // one 2-byte store (col / 2 is even)
    *reinterpret_cast<uint16_t*>(reinterpret_cast<uint8_t*>(row_out) + col / 2) =
        static_cast<uint16_t>(pack_pair(q[0], q[1]) | (pack_pair(q[2], q[3]) << 8));
  } else if constexpr (PACK4) {
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

// ---------------------------------------------------------------------------
// Kernels 1 and 2: one warp per bucket row, the row held in registers
// ---------------------------------------------------------------------------

constexpr int kWarpRows = 8;  // rows (warps) per block
constexpr int kRowThreads = 32 * kWarpRows;
constexpr int kLaneCols = 8;  // coordinates a lane holds: a 256-wide chunk per warp
constexpr int kCells = 256;    // cells of [0, 1] in the bracket's first lookup

// The level table as kernels 1 and 2 read it, staged once per block.
struct LevelTables {
  float lv[kMaxSymbols];        // the levels
  float2 ends[kMaxSymbols];     // bracket j's ends (lv[j], lv[j + 1])
  float key[kMaxSymbols];       // interior levels 1 .. s at their index, +inf elsewhere
  int below[kCells + 1];        // cell c: #interior levels <= c / kCells ...
  float next[kCells + 1];       // ... and the next interior level (+inf if none)
};

// Stages the tables; returns true when no open cell (c, c + 1) / kCells
// holds two levels (every uniform table up to kMaxSymbols), so that one
// compare after the cell's count finds the bracket.  Both barriers are
// the kernel's only ones.
__device__ __forceinline__ bool stage_tables(LevelTables& t, const float* levels,
                                             int num_symbols) {
  const int s = num_symbols - 2;
  for (int j = threadIdx.x; j < kMaxSymbols; j += blockDim.x) {
    const float lo = j < num_symbols ? levels[j] : 0.0f;
    t.lv[j] = lo;
    t.ends[j] = make_float2(lo, j + 1 < num_symbols ? levels[j + 1] : 0.0f);
    t.key[j] = j >= 1 && j <= s ? lo : __int_as_float(0x7f800000);
  }
  __syncthreads();
  bool coarse = false;
  for (int c = threadIdx.x; c <= kCells; c += blockDim.x) {
    const float lo = c * (1.0f / kCells), hi = (c + 1) * (1.0f / kCells);  // exact
    int le = 0, lt = 0;
    for (int j = 1; j <= s; ++j) {
      le += t.key[j] <= lo ? 1 : 0;
      lt += t.key[j] < hi ? 1 : 0;
    }
    t.below[c] = le;
    t.next[c] = t.key[le + 1];
    coarse = coarse || lt - le > 1;
  }
  return !__syncthreads_or(coarse);
}

// The binary search's first step: the largest power of two <= s, the
// interior level count (1 if there is none).  Its steps then reach key
// 2 * step - 1 <= 127, and t.key is +inf past s.
__device__ __forceinline__ int first_step(int num_symbols) {
  int step = 1;
  while (2 * step <= num_symbols - 2) step *= 2;
  return step;
}

// Max (q = inf) or sum (q = 2) over the warp's 32 lanes, the same bits in
// every lane (the butterfly adds each pair in both orders, and IEEE
// addition commutes).
__device__ __forceinline__ float warp_reduce(float v, bool is_max) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = is_max ? nan_max(v, o) : __fadd_rn(v, o);
  }
  return v;
}

// Group i (of kLaneCols / VEC) of this lane in chunk c of a row.
template <int VEC>
__device__ __forceinline__ int group_of(int c, int i, int lane) {
  return (c * (kLaneCols / VEC) + i) * 32 + lane;
}

// This lane's coordinates of chunk c of an f32 row; zero past the row's end.
template <int VEC>
__device__ __forceinline__ void load_chunk(const float* row, int c, int ngroups, int lane,
                                           float* v) {
#pragma unroll
  for (int i = 0; i < kLaneCols / VEC; ++i) {
    const int g = group_of<VEC>(c, i, lane);
    if (g < ngroups) {
      load_vec<VEC>(row + g * VEC, v + i * VEC);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[i * VEC + e] = 0.0f;
    }
  }
}

// This lane's draws of chunk c: host-noise loads, or Philox in registers.
template <int VEC, class Noise>
__device__ __forceinline__ void draw_chunk(const Noise& noise, int c, int ngroups, int lane,
                                           float* r) {
#pragma unroll
  for (int i = 0; i < kLaneCols / VEC; ++i) {
    const int g = group_of<VEC>(c, i, lane);
    if (g < ngroups) {
      noise.template get<VEC>(g * VEC, r + i * VEC);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) r[i * VEC + e] = 0.0f;
    }
  }
}

// This lane's part of the row norm, continued over one more chunk.
__device__ __forceinline__ float chunk_norm(const float* v, bool is_max, float part) {
#pragma unroll
  for (int e = 0; e < kLaneCols; ++e) {
    const float t = norm_term(v[e], is_max);
    part = is_max ? nan_max(part, t) : __fadd_rn(part, t);
  }
  return part;
}

// IEEE a / b for b > 0, with a zero dividend kept off __fdiv_rn's slow
// path (its range check sends 0 / b there): +0 / b is +0, and the
// division is made of b / b instead.  Exact zeros are common: padding,
// gradients of unused rows, and every coordinate of kernel 2 that sits on
// a level (u - lo == 0).
__device__ __forceinline__ float div_rn(float a, float b) {
  const float q = __fdiv_rn(a != 0.0f ? a : b, b);
  return a != 0.0f ? q : 0.0f;
}

// Q of this lane's share of chunk c (values v, draws r) given the row's safe
// norm: writes its payload bytes.  The bracket tau = #{1 <= j <= s :
// lv[j] <= u}: with a fine table, the count up to u's cell plus one
// compare; else a binary search, all kLaneCols coordinates in step, key by
// key from the largest step down.  Both equal the compare count for a
// sorted table.
template <int VEC, bool PACK4>
__device__ __forceinline__ void quantize_chunk(const float* v, const float* r, float safe,
                                               const LevelTables& t, bool fine, int step0,
                                               int8_t* out_row, int c, int ngroups, int lane) {
  float u[kLaneCols];
  int tau[kLaneCols];
  uint32_t neg = 0;
#pragma unroll
  for (int e = 0; e < kLaneCols; ++e) {
    u[e] = fminf(fmaxf(div_rn(fabsf(v[e]), safe), 0.0f), 1.0f);  // NaN -> 0
    neg |= (v[e] < 0.0f ? 1u : 0u) << e;
  }
  if (fine) {
#pragma unroll
    for (int e = 0; e < kLaneCols; ++e) {
      const int cell = __float2int_rz(__fmul_rn(u[e], float(kCells)));  // u in [0, 1]
      tau[e] = t.below[cell] + (t.next[cell] <= u[e] ? 1 : 0);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kLaneCols; ++e) tau[e] = 0;
    for (int step = step0; step > 0; step >>= 1) {
#pragma unroll
      for (int e = 0; e < kLaneCols; ++e) tau[e] += t.key[tau[e] + step] <= u[e] ? step : 0;
    }
  }
#pragma unroll
  for (int i = 0; i < kLaneCols / VEC; ++i) {
    const int g = group_of<VEC>(c, i, lane);
    if (g >= ngroups) continue;
    int q[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int e = i * VEC + j;
      const float2 ends = t.ends[tau[e]];
      const float lo = ends.x, hi = ends.y;
      const float xi = div_rn(__fsub_rn(u[e], lo), __fsub_rn(hi, lo));
      const int idx = tau[e] + (r[e] < xi ? 1 : 0);
      q[j] = (neg >> e) & 1u ? -idx : idx;
    }
    store_indices<VEC, PACK4>(out_row, g * VEC, q);
  }
}

// This lane's signed indices of chunk c of one payload row; 0 past its end.
template <int VEC, bool PACK4>
__device__ __forceinline__ void load_index_chunk(const int8_t* in_row, int c, int ngroups,
                                                 int lane, int* q) {
#pragma unroll
  for (int i = 0; i < kLaneCols / VEC; ++i) {
    const int g = group_of<VEC>(c, i, lane);
    if (g < ngroups) {
      load_indices<VEC, PACK4>(in_row, g * VEC, q + i * VEC);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) q[i * VEC + e] = 0;
    }
  }
}

// The K-mean of this lane's share of chunk c, straight into registers:
// acc = sum_k DEQ(payload_k) in worker order, then acc * (1/K) (the
// arithmetic of mean_group); zero past the row's end.  Worker 0 is peeled
// so that `issued` (the row's noise loads, or its draws) runs in straight
// line right after worker 0's loads, before anything waits on them.
template <int VEC, bool PACK4, class F>
__device__ __forceinline__ void mean_chunk(const int8_t* idx, const float* norms, int K,
                                           long long nb, long long row, long long pcols,
                                           int c, int ngroups, int lane, float inv_k,
                                           const float* s_lv, float* acc, F&& issued) {
  int q[kLaneCols];
  load_index_chunk<VEC, PACK4>(idx + row * pcols, c, ngroups, lane, q);
  const float norm0 = norms[row];
  issued();
#pragma unroll
  for (int e = 0; e < kLaneCols; ++e) acc[e] = deq_one(q[e], norm0, s_lv);
  for (int k = 1; k < K; ++k) {
    const long long r = (long long)k * nb + row;
    load_index_chunk<VEC, PACK4>(idx + r * pcols, c, ngroups, lane, q);
    const float norm = norms[r];
#pragma unroll
    for (int e = 0; e < kLaneCols; ++e) acc[e] = __fadd_rn(acc[e], deq_one(q[e], norm, s_lv));
  }
#pragma unroll
  for (int i = 0; i < kLaneCols / VEC; ++i) {
    const bool live = group_of<VEC>(c, i, lane) < ngroups;  // a NaN norm must not leak
#pragma unroll
    for (int e = i * VEC; e < (i + 1) * VEC; ++e) acc[e] = live ? __fmul_rn(acc[e], inv_k) : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

template <int VEC, bool PACK4, class Noise>
__global__ void __launch_bounds__(kRowThreads)
quantize_kernel(const float* __restrict__ x, const float* __restrict__ noise,
                unsigned long long seed, const float* __restrict__ levels, int num_symbols,
                long long nb, int bucket, bool q_is_inf, int8_t* __restrict__ out,
                float* __restrict__ norms) {
  __shared__ LevelTables t;
  const bool fine = stage_tables(t, levels, num_symbols);
  const int lane = threadIdx.x & 31, step0 = first_step(num_symbols);
  const int ngroups = bucket / VEC, per_chunk = 32 * (kLaneCols / VEC);
  const int nchunks = (ngroups + per_chunk - 1) / per_chunk;
  const long long pcols = PACK4 ? bucket / 2 : bucket;
  for (long long row = (long long)blockIdx.x * kWarpRows + (threadIdx.x >> 5); row < nb;
       row += (long long)gridDim.x * kWarpRows) {
    const float* x_row = x + row * bucket;
    const Noise src = row_noise<Noise>(noise, seed, row, bucket);
    float v[kLaneCols], r[kLaneCols];
    load_chunk<VEC>(x_row, 0, ngroups, lane, v);
    draw_chunk<VEC>(src, 0, ngroups, lane, r);  // with x's loads in flight
    float part = chunk_norm(v, q_is_inf, 0.0f);
    for (int c = 1; c < nchunks; ++c) {  // a row wider than the registers: its norm
      float w[kLaneCols];
      load_chunk<VEC>(x_row, c, ngroups, lane, w);
      part = chunk_norm(w, q_is_inf, part);
    }
    const float norm = finish_norm(warp_reduce(part, q_is_inf), q_is_inf);
    const float safe = norm > 0.0f ? norm : 1.0f;
    int8_t* out_row = out + row * pcols;
    quantize_chunk<VEC, PACK4>(v, r, safe, t, fine, step0, out_row, 0, ngroups, lane);
    for (int c = 1; c < nchunks; ++c) {  // ... and its second pass, x from L1/L2
      load_chunk<VEC>(x_row, c, ngroups, lane, v);
      draw_chunk<VEC>(src, c, ngroups, lane, r);
      quantize_chunk<VEC, PACK4>(v, r, safe, t, fine, step0, out_row, c, ngroups, lane);
    }
    if (lane == 0) norms[row] = norm;
  }
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

// The reduced row lives only in registers (a row wider than 512: its first
// chunk; the rest is recomputed from the payload in the second pass).
template <int VEC, bool PACK4, class Noise>
__global__ void __launch_bounds__(kRowThreads) dequant_reduce_requantize_kernel(
    const int8_t* __restrict__ idx, const float* __restrict__ norms,
    const float* __restrict__ noise, unsigned long long seed,
    const float* __restrict__ levels,
    int num_symbols, int K, long long nb, int bucket, bool q_is_inf, float inv_k,
    int8_t* __restrict__ out, float* __restrict__ onorms) {
  __shared__ LevelTables t;
  const bool fine = stage_tables(t, levels, num_symbols);
  const int lane = threadIdx.x & 31, step0 = first_step(num_symbols);
  const int ngroups = bucket / VEC, per_chunk = 32 * (kLaneCols / VEC);
  const int nchunks = (ngroups + per_chunk - 1) / per_chunk;
  const long long pcols = PACK4 ? bucket / 2 : bucket;
  for (long long row = (long long)blockIdx.x * kWarpRows + (threadIdx.x >> 5); row < nb;
       row += (long long)gridDim.x * kWarpRows) {
    const Noise src = row_noise<Noise>(noise, seed, row, bucket);
    float v[kLaneCols], r[kLaneCols];
    mean_chunk<VEC, PACK4>(idx, norms, K, nb, row, pcols, 0, ngroups, lane, inv_k, t.lv, v,
                           [&] { draw_chunk<VEC>(src, 0, ngroups, lane, r); });
    float part = chunk_norm(v, q_is_inf, 0.0f);
    for (int c = 1; c < nchunks; ++c) {  // a row wider than the registers: its norm
      float w[kLaneCols];
      mean_chunk<VEC, PACK4>(idx, norms, K, nb, row, pcols, c, ngroups, lane, inv_k, t.lv, w,
                             [] {});
      part = chunk_norm(w, q_is_inf, part);
    }
    const float norm = finish_norm(warp_reduce(part, q_is_inf), q_is_inf);
    const float safe = norm > 0.0f ? norm : 1.0f;
    int8_t* out_row = out + row * pcols;
    quantize_chunk<VEC, PACK4>(v, r, safe, t, fine, step0, out_row, 0, ngroups, lane);
    for (int c = 1; c < nchunks; ++c) {  // ... and its second pass: the same K-mean again
      mean_chunk<VEC, PACK4>(idx, norms, K, nb, row, pcols, c, ngroups, lane, inv_k, t.lv, v,
                             [&] { draw_chunk<VEC>(src, c, ngroups, lane, r); });
      quantize_chunk<VEC, PACK4>(v, r, safe, t, fine, step0, out_row, c, ngroups, lane);
    }
    if (lane == 0) onorms[row] = norm;
  }
}


// Kernel 5: fused Q∘DEQ of one bucket row under its own level table, one
// warp per row as in kernels 1 and 2.  The row's table t = seg[row] is one
// of the T stacked tables; only the f32 estimate is written.  The bracket
// counts the interior levels 1 .. ns[t] - 2 of table t — the reference's
// masked compare over the union of levels, which never counts a row
// against another table's entries or the 1.0 padding.  The clamp keeps a
// NaN (as jnp.clip and torch.clamp do) so a non-finite row matches the
// plain version; a table id outside [0, T) writes NaN over its row (its
// norm is made NaN).  Noise is NoNoise for nearest rounding (xi >= 0.5).
//
// Its tables, in dynamic shared memory: the stacked [T, s_max] levels as
// given, then kCellStride bytes a table, one per cell of [0, 1]: how many
// of the table's interior levels lie at or below c / kCells.  The
// bracket's ends and the next level are read from the levels themselves,
// so the layout is compact: T * (4 * s_max + kCellStride) bytes, 24.7 KB
// at the contract's T = 32 and s_max = 128, under the 48 KB a block has
// without an opt-in; registers, not shared memory, bound the blocks an SM
// holds at any T (3).  A table
// whose open cells each hold at most one level (every uniform table) takes
// the cell count plus one compare; any other (exponential tables) the
// binary search, both per table.
struct SymbolCounts {
  int v[kMaxTables];
};

constexpr int kCellStride = 260;  // kCells + 1 bytes, rounded up to a word

// The binary search's first step over s interior levels: the largest power
// of two <= s (0 when there are none).
__device__ __forceinline__ int top_step(int s) {
  return s > 0 ? 1 << (31 - __clz(s)) : 0;
}

// Interior levels (1 .. s) of a sorted table at or below x (below x with
// STRICT); for staging the cell counts.
template <bool STRICT>
__device__ __forceinline__ int count_levels(const float* lv, int s, float x) {
  int n = 0;
  for (int step = top_step(s); step > 0; step >>= 1) {
    const int j = n + step;
    const float l = lv[min(j, s)];
    n = j <= s && (STRICT ? l < x : l <= x) ? j : n;
  }
  return n;
}

// Q∘DEQ of this lane's share of chunk c (values v, draws r) under one table
// lv with s interior levels, given the row's norm and safe norm: writes its
// estimates.
template <int VEC, bool STOCHASTIC>
__device__ __forceinline__ void qdq_chunk(const float* v, const float* r, float norm, float safe,
                                          const float* lv, const uint8_t* below, int s,
                                          bool fine, float* out_row, int c, int ngroups,
                                          int lane) {
  float u[kLaneCols];
  int tau[kLaneCols];
#pragma unroll
  for (int e = 0; e < kLaneCols; ++e) {
    const float a = div_rn(fabsf(v[e]), safe);
    u[e] = a > 1.0f ? 1.0f : (a < 0.0f ? 0.0f : a);  // keeps a NaN
  }
  if (fine) {
#pragma unroll
    for (int e = 0; e < kLaneCols; ++e) {
      // a NaN u takes cell 0 (no level at or below it: tau = 0, as the
      // compares give)
      const int cell = __float2int_rz(fminf(fmaxf(__fmul_rn(u[e], float(kCells)), 0.0f),
                                            float(kCells)));
      const int b = below[cell];
      tau[e] = min(b + (lv[b + 1] <= u[e] ? 1 : 0), s);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kLaneCols; ++e) tau[e] = 0;
    for (int step = top_step(s); step > 0; step >>= 1) {
#pragma unroll
      for (int e = 0; e < kLaneCols; ++e) {
        const int j = tau[e] + step;
        tau[e] = j <= s && lv[min(j, s)] <= u[e] ? j : tau[e];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kLaneCols / VEC; ++i) {
    const int g = group_of<VEC>(c, i, lane);
    if (g >= ngroups) continue;
    float o[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int e = i * VEC + j;
      const float lo = lv[tau[e]], hi = lv[tau[e] + 1];
      const float xi = div_rn(__fsub_rn(u[e], lo), __fsub_rn(hi, lo));
      const bool up = STOCHASTIC ? r[e] < xi : xi >= 0.5f;
      const float q = up ? hi : lo;
      o[j] = __fmul_rn(v[e] < 0.0f ? -q : q, norm);
    }
    store_vec<VEC>(out_row + g * VEC, o);
  }
}

// At most 80 registers a thread, 3 blocks (24 warps) an SM: x's two chunks
// stay in registers.  Left to itself nvcc holds the host-noise kernel to
// 64 registers with a stack frame, ~11 % slower at the tinyllama buffer.
template <int VEC, class Noise>
__global__ void __launch_bounds__(kRowThreads, 3)
segment_qdq_kernel(const float* __restrict__ x, const float* __restrict__ noise,
                   unsigned long long seed, const float* __restrict__ tables,
                   const int* __restrict__ seg, int T, int s_max, SymbolCounts ns, long long nb,
                   int bucket, bool q_is_inf, float* __restrict__ out) {
  constexpr bool STOCHASTIC = !std::is_same<Noise, NoNoise>::value;
  extern __shared__ float4 s_dyn[];
  float* s_lv = reinterpret_cast<float*>(s_dyn);
  uint8_t* s_below = reinterpret_cast<uint8_t*>(s_lv + T * s_max);
  __shared__ int s_interior[kMaxTables];
  __shared__ unsigned s_coarse;  // bit t: table t has a cell holding two levels
  for (int j = threadIdx.x; j < T * s_max; j += blockDim.x) s_lv[j] = tables[j];
  if (threadIdx.x == 0) {
    s_coarse = 0;
#pragma unroll
    for (int t = 0; t < kMaxTables; ++t)
      if (t < T) s_interior[t] = ns.v[t] - 2;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < T * (kCells + 1); i += blockDim.x) {
    const int t = i / (kCells + 1), c = i - t * (kCells + 1);
    const float* lv = s_lv + t * s_max;
    const int s = s_interior[t];
    const int le = count_levels<false>(lv, s, c * (1.0f / kCells));  // exact
    const int lt = count_levels<true>(lv, s, (c + 1) * (1.0f / kCells));
    s_below[t * kCellStride + c] = static_cast<uint8_t>(le);
    if (lt - le > 1) atomicOr(&s_coarse, 1u << t);
  }
  __syncthreads();  // the kernel's last barrier
  const int lane = threadIdx.x & 31;
  const int ngroups = bucket / VEC, per_chunk = 32 * (kLaneCols / VEC);
  const int nchunks = (ngroups + per_chunk - 1) / per_chunk;
  for (long long row = (long long)blockIdx.x * kWarpRows + (threadIdx.x >> 5); row < nb;
       row += (long long)gridDim.x * kWarpRows) {
    const float* x_row = x + row * bucket;
    const Noise src = row_noise<Noise>(noise, seed, row, bucket);
    const int t = seg[row];
    float v[kLaneCols], w[kLaneCols], r[kLaneCols];  // x's chunks 0 and 1, a draw
    load_chunk<VEC>(x_row, 0, ngroups, lane, v);
    if constexpr (STOCHASTIC) draw_chunk<VEC>(src, 0, ngroups, lane, r);  // under x's loads
    load_chunk<VEC>(x_row, 1, ngroups, lane, w);  // zeros past the row's end
    float part = chunk_norm(w, q_is_inf, chunk_norm(v, q_is_inf, 0.0f));
    for (int c = 2; c < nchunks; ++c) {  // a row wider than the registers: its norm
      float z[kLaneCols];
      load_chunk<VEC>(x_row, c, ngroups, lane, z);
      part = chunk_norm(z, q_is_inf, part);
    }
    const bool bad = t < 0 || t >= T;  // no such table: NaN over the row
    const int tt = bad ? 0 : t;
    const float norm = bad ? __int_as_float(0x7fc00000)
                           : finish_norm(warp_reduce(part, q_is_inf), q_is_inf);
    const float safe = norm > 0.0f ? norm : 1.0f;
    const float* lv = s_lv + tt * s_max;
    const uint8_t* below = s_below + tt * kCellStride;
    const int s = s_interior[tt];
    const bool fine = !((s_coarse >> tt) & 1u);
    float* out_row = out + row * bucket;
    qdq_chunk<VEC, STOCHASTIC>(v, r, norm, safe, lv, below, s, fine, out_row, 0, ngroups, lane);
    if (nchunks > 1) {  // chunk 1 from registers, its draw now
      if constexpr (STOCHASTIC) draw_chunk<VEC>(src, 1, ngroups, lane, r);
      qdq_chunk<VEC, STOCHASTIC>(w, r, norm, safe, lv, below, s, fine, out_row, 1, ngroups,
                                 lane);
    }
    for (int c = 2; c < nchunks; ++c) {  // ... and a second pass over the rest, x from L1/L2
      load_chunk<VEC>(x_row, c, ngroups, lane, v);
      if constexpr (STOCHASTIC) draw_chunk<VEC>(src, c, ngroups, lane, r);
      qdq_chunk<VEC, STOCHASTIC>(v, r, norm, safe, lv, below, s, fine, out_row, c, ngroups,
                                 lane);
    }
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

// The grid of kernels 1, 2 and 5: enough blocks of kRowThreads to fill
// every SM of the device at the kernel's occupancy (with its dynamic shared
// memory, smem bytes a block), and no more than the rows need; each warp
// then strides over the rows.  Rows that need no more blocks than the card
// has SMs skip the occupancy query.
template <class Kernel>
cudaError_t row_grid(Kernel kernel, int device, long long nb, size_t smem, unsigned* blocks) {
  int sms = 0, per_sm = 0;
  if (cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))
    return e;
  const long long need = (nb + kWarpRows - 1) / kWarpRows;
  if (need > sms) {
    if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                      kRowThreads, smem))
      return e;
  }
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *blocks = static_cast<unsigned>(need < full ? need : full);
  return cudaSuccess;
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
  cudaError_t err = cudaSuccess;
  dispatch(vec, pack4, [&](auto v, auto p) {
    with_noise(device_prng != 0, [&](auto n) {
      constexpr int V = decltype(v)::value;
      constexpr bool P = decltype(p)::value;
      using N = typename decltype(n)::type;
      unsigned blocks = 0;
      err = row_grid(quantize_kernel<V, P, N>, device, nb, 0, &blocks);
      if (err == cudaSuccess)
        quantize_kernel<V, P, N><<<blocks, kRowThreads, 0, s>>>(
            x, noise, seed, levels, num_symbols, nb, bucket, q_is_inf != 0, out, norms);
    });
  });
  if (err != cudaSuccess) return err;
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
  if (bad_args(num_symbols, nb, bucket, vec) || K < 1 || bad_noise(noise, device_prng))
    return cudaErrorInvalidValue;
  if (nb == 0) return cudaSuccess;
  if (cudaError_t e = cudaSetDevice(device)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  dispatch(vec, pack4, [&](auto v, auto p) {
    with_noise(device_prng != 0, [&](auto n) {
      constexpr int V = decltype(v)::value;
      constexpr bool P = decltype(p)::value;
      using N = typename decltype(n)::type;
      unsigned blocks = 0;
      err = row_grid(dequant_reduce_requantize_kernel<V, P, N>, device, nb, 0, &blocks);
      if (err == cudaSuccess)
        dequant_reduce_requantize_kernel<V, P, N><<<blocks, kRowThreads, 0, s>>>(
            idx, norms, noise, seed, levels, num_symbols, K, nb, bucket, q_is_inf != 0, inv_k,
            out, onorms);
    });
  });
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int qx_segment_qdq(const float* x, const float* noise, unsigned long long seed,
                   int device_prng, const float* tables, const int* seg, int T, int s_max,
                   const int* num_symbols, long long nb, int bucket, int q_is_inf,
                   int stochastic, float* out, int device, void* stream) {
  const int vec = pick_vec(bucket, false);
  // the tables and their cell counts, in dynamic shared memory (24.7 KB at
  // most: under the 48 KB default cap)
  const size_t smem = (size_t)T * (sizeof(float) * (size_t)s_max + kCellStride);
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
  cudaError_t err = cudaSuccess;
  auto launch = [&](auto kernel) {
    unsigned blocks = 0;
    err = row_grid(kernel, device, nb, smem, &blocks);
    if (err == cudaSuccess)
      kernel<<<blocks, kRowThreads, smem, s>>>(x, noise, seed, tables, seg, T, s_max, ns, nb,
                                               bucket, q_is_inf != 0, out);
  };
  auto with_vec = [&](auto n) {
    using N = typename decltype(n)::type;
    if (vec == 4) launch(segment_qdq_kernel<4, N>);
    else if (vec == 2) launch(segment_qdq_kernel<2, N>);
    else launch(segment_qdq_kernel<1, N>);
  };
  if (stochastic) with_noise(device_prng != 0, with_vec); else with_vec(Tag<NoNoise>{});
  if (err != cudaSuccess) return err;
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
