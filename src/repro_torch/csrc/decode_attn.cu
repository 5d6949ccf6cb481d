// Single-token GQA decode attention over the compressed cache (CUDA C++ for
// sm_90a): split-key (flash-decoding) with masked-tile skipping.
//
// Replaces two TPU kernels of src/repro/kernels/linformer_attn.py:
// decode_attn (body _decode_kernel -> _attend_pinned) and decode_attn_q
// (_decode_kernel_q), the same attention over the paged, quantized cache,
// whose ring and page-gathered slots arrive as int8 or fp8 e4m3 codes with
// one fp32 scale per (row, kv head, token or slot). Per (batch row b, kv
// head h) the G query heads of the group take one softmax over [raw ring,
// c tokens | compressed slots, M], with per-row additive fp32 biases
// (0 = attendable, -1e30 = masked) for the ring (B, c) and the slots
// (B, M). Scores, probabilities and accumulation are fp32; the output has
// q's dtype.
//
// What bounds it on an H100: bytes. With G = 4 query rows per key it does
// 4·Dh·G = 16·Dh flops a key against 4·Dh bytes of bf16 k and v (2·Dh of
// int8): ~4 flops a byte in bf16, ~8 in int8. SIMT fp32 (67 TFLOP/s) runs
// out only at ~20 flops a byte against 3.35 TB/s, so the tensor cores are
// not needed: q·k and p·v stay fp32 FMAs.
//
// What the design does about it:
// - Split the key range over blocks (flash-decoding). The grid is (row x kv
//   head, key split, group of 4 query rows); the wrapper picks the number
//   of splits from B·Hkv and c + M so that about two blocks per SM run at
//   B = 1 as at B = 4 (kernels/common.decode_splits). Each split keeps its
//   4 rows' fp32 (m, l, o) and writes them to scratch the wrapper
//   allocates; decode_combine_kernel merges the splits of a (row, head) in
//   split order and writes the output. It is launched as a programmatic
//   dependent of the split kernel, so its launch overlaps the splits' run.
//   No float atomics: the result is bit-identical from launch to launch,
//   and the launch sequence has no host sync or allocation, so it can be
//   captured into a CUDA graph. One split writes the output itself and the
//   combine is not launched.
// - Wide loads. A key row's Dh elements are spread over kLanes lanes, each
//   holding one 16-byte piece (8 bf16, 4 fp32, 16 int8/fp8 codes); each lane
//   issues all kKeys rows' k and v pieces of a 64-key tile before it uses
//   any, so a tile costs one memory round trip after its biases; q, the
//   first tile's biases and the row's bias scan share one round trip. Where a base address or a
//   stride is not a multiple of 16 bytes, the same registers are filled
//   element by element instead (ring_vec / slot_vec): nothing is refused
//   or rerouted. Quantized codes are dequantised in registers right after
//   the load, code x per-token scale, as the plain version does.
// - q·k with shuffles. Each lane multiplies its piece against the 4 query
//   rows held in registers and the kLanes partial dots are summed with
//   xor shuffles; p·v accumulates in the lane's registers. Lane groups
//   (then warps, through shared memory) merge their online-softmax states
//   at the end in a fixed order.
// - Skipping dead bytes. When the row attends at least one key, a 64-key
//   tile whose 64 biases are all masked is skipped whole (and a masked key
//   of a live tile is neither loaded nor scored): exp(-1e30 - m) is exactly
//   0 in fp32 for any finite score m of a visible key, so the result is the
//   plain version's. A row that masks every key skips nothing and returns
//   the plain version's uniform average over all c + M values. A split left
//   with no visible key reports m = -inf, l = 0, which the merges weigh 0
//   without forming -inf - (-inf).
// - Rounding: probabilities stay fp32 through the value product and are
//   normalised once at the end (the TPU kernel and the plain version cast
//   the normalised probabilities to the value dtype first); equal in fp32.
//
// -Xptxas -v (sm_90a, CUDA 12.8): no instance spills. decode_split_kernel
// uses 128 registers for bf16 q and cache at Dh = 128 (256 threads, capped
// for two blocks an SM), 157-163 at Dh 16-64, 122-124 for fp32 (up to 512
// threads); 228-255 over int8/fp8 codes, whose 16-byte piece is 16
// elements (q and the accumulators of 4 rows x 16 dims in registers);
// decode_combine_kernel 32.
//
// What still holds it back: at the decode shapes a call moves ~5 MB, less
// than one launch's ramp, so its time is two launches (split, combine) and
// the chain of memory round trips in a split block (q and biases, k and v,
// the state's write) and in the combine; a split with several tiles loads
// them one after another, and the quantized instances' register count
// allows two 128-thread blocks an SM.
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kTile = 64;          // keys per tile: the unit of skipping and of a split
constexpr int kGroupRows = 4;      // query rows (of a kv head's G) one block takes
constexpr int kKeysPerLane = 4;    // key rows of a tile one lane holds at once
constexpr int kCombineThreads = 128;

// One lane's share of the work: a 16-byte piece of a key row.
template <typename S, int Dh>
struct DecodeCfg {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(S));   // elements per piece
  static constexpr int kLanes = Dh / kVec;                        // lanes per key row
  static constexpr int kKeys = kLanes >= 2 ? kKeysPerLane : 2;    // rows a lane holds
  static constexpr int kThreads = kTile * kLanes / kKeys;
  static constexpr int kWarps = kThreads / 32;
  static_assert(kLanes >= 1 && kLanes <= 32 && (kLanes & (kLanes - 1)) == 0,
                "a key row spans a power-of-two number of lanes within a warp");
  static_assert(kThreads % 32 == 0 && kThreads <= 512, "whole warps");
};

struct DecodeParams {
  const void* q;       // (B, Hkv, G, Dh), contiguous
  const void* rk;      // (B, Hkv, c, Dh), strided
  const void* rv;
  const void* ck;      // (B, Hkv, M, Dh), strided
  const void* cv;
  const float* rks;    // (B, Hkv, c) per-token scales of a quantized ring, or null
  const float* rvs;
  const float* cks;    // (B, Hkv, M) per-slot scales of quantized slots, or null
  const float* cvs;
  const float* bias_loc;   // (B, c), contiguous
  const float* bias_glob;  // (B, M), contiguous
  void* out;           // (B, Hkv, G, Dh), contiguous
  float* part;         // split scratch: o (B·Hkv, nsplit, G, Dh), m and l (B·Hkv, nsplit, G)
  long long rs_b, rs_h, rs_s;  // ring strides (k and v share them)
  long long cs_b, cs_h, cs_s;  // slot strides (k and v share them)
  long long rss_b, rss_h, rss_s;  // ring scale strides (k and v share them)
  long long css_b, css_h, css_s;  // slot scale strides (k and v share them)
  int B, Hkv, G, Dh, c, M;
  int nsplit, tiles_per_split;
  int ring_vec, slot_vec;  // 16-byte loads allowed (bases and strides aligned)
  float scale;
};

// One 16-byte piece: vector load where allowed, else element by element
// into the same registers.
template <typename S>
__device__ __forceinline__ uint4 load_piece(const S* src, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(src);
  constexpr int n = 16 / static_cast<int>(sizeof(S));
  S e[n];
#pragma unroll
  for (int u = 0; u < n; ++u) e[u] = src[u];
  uint4 raw;
  memcpy(&raw, e, 16);
  return raw;
}

// Element u of a piece, as fp32 (a code, for quantized storage).
template <typename S>
__device__ __forceinline__ float piece_elem(const uint4& raw, int u) {
  S e[16 / sizeof(S)];
  memcpy(e, &raw, 16);
  return to_f32<S>(e[u]);
}

// Programmatic dependent launch (sm_90): the combine kernel is launched
// while the split kernel still runs, as soon as every split block has
// started, and waits in griddepcontrol.wait until the split grid has
// finished and its writes are visible.
__device__ __forceinline__ void allow_dependent_launch() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
#endif
}
__device__ __forceinline__ void wait_for_primary_grid() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

// max that propagates NaN (fmaxf drops it): a visible key whose score is
// NaN (a poisoned row's K or scale) makes the running max, hence the row's
// output, NaN, as in the plain version, so the serving NaN guard sees it.
// Masked keys are never scored (-inf), so no masked NaN reaches here.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// exp(m - mx), the weight of a softmax state of running max m under the
// joint max mx; a state that saw no key (m = -inf) weighs 0, also when mx
// is -inf itself.
__device__ __forceinline__ float state_weight(float m, float mx) {
  return m == neg_inf() ? 0.f : expf(m - mx);
}

// T: q and the output; S: the cache storage (T, or int8_t / __nv_fp8_e4m3
// with scales).
template <typename T, typename S, int Dh>
__global__ void __launch_bounds__(DecodeCfg<S, Dh>::kThreads,
                                  DecodeCfg<S, Dh>::kThreads <= 256 ? 2 : 1)
    decode_split_kernel(DecodeParams p) {
  using Cfg = DecodeCfg<S, Dh>;
  constexpr int kVec = Cfg::kVec, kLanes = Cfg::kLanes, kKeys = Cfg::kKeys;
  constexpr int kThreads = Cfg::kThreads, kWarps = Cfg::kWarps;
  constexpr int kRowsAtOnce = kThreads / kLanes;   // key rows of one load step
  constexpr bool kScaled = !std::is_same<T, S>::value;
  constexpr unsigned kFull = 0xffffffffu;
  __shared__ float sm_o[kWarps][kGroupRows][Dh];
  __shared__ float sm_m[kWarps][kGroupRows];
  __shared__ float sm_l[kWarps][kGroupRows];

  allow_dependent_launch();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int sub = tid % kLanes, grp = tid / kLanes;
  const int bh = blockIdx.x, split = blockIdx.y, g0 = blockIdx.z * kGroupRows;
  const int b = bh / p.Hkv, h = bh % p.Hkv;
  const int rows = min(kGroupRows, p.G - g0);
  const int c = p.c, total = p.c + p.M;
  const float* BL = p.bias_loc + static_cast<long long>(b) * p.c;
  const float* BG = p.bias_glob + static_cast<long long>(b) * p.M;
  auto bias = [&](int j) { return j < c ? BL[j] : BG[j - c]; };

  // q, the first tile's biases and the row's scan are loaded together
  const T* Q = static_cast<const T*>(p.q) + (static_cast<long long>(bh) * p.G + g0) * Dh
      + sub * kVec;
  float qf[kGroupRows][kVec];
  float m[kGroupRows], l[kGroupRows], acc[kGroupRows][kVec];
#pragma unroll
  for (int g = 0; g < kGroupRows; ++g) {
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      qf[g][u] = g < rows ? to_f32<T>(Q[g * Dh + u]) : 0.f;
      acc[g][u] = 0.f;
    }
    m[g] = neg_inf();
    l[g] = 0.f;
  }

  // The biases of this lane's key rows of a tile, -inf past the end (no
  // key: weight 0, as a -inf bias would give).
  const int ntiles = (total + kTile - 1) / kTile;
  const int t_begin = split * p.tiles_per_split;
  const int t_end = min(t_begin + p.tiles_per_split, ntiles);
  float bj[kKeys];
  auto tile_biases = [&](int t) {
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const int j = t * kTile + grp + i * kRowsAtOnce;
      bj[i] = j < total ? bias(j) : neg_inf();
    }
  };
  tile_biases(t_begin);  // in flight with the row's scan below

  // Skip masked tiles and keys only if the row attends some key.
  int seen = 0;
  for (int j = tid; j < total; j += kThreads) seen |= bias(j) > kNegInf;
  const bool skip = __syncthreads_or(seen);

  const S* RK = static_cast<const S*>(p.rk) + b * p.rs_b + h * p.rs_h + sub * kVec;
  const S* RV = static_cast<const S*>(p.rv) + b * p.rs_b + h * p.rs_h + sub * kVec;
  const S* CK = static_cast<const S*>(p.ck) + b * p.cs_b + h * p.cs_h + sub * kVec;
  const S* CV = static_cast<const S*>(p.cv) + b * p.cs_b + h * p.cs_h + sub * kVec;
  const float* RKS = kScaled ? p.rks + b * p.rss_b + h * p.rss_h : nullptr;
  const float* RVS = kScaled ? p.rvs + b * p.rss_b + h * p.rss_h : nullptr;
  const float* CKS = kScaled ? p.cks + b * p.css_b + h * p.css_h : nullptr;
  const float* CVS = kScaled ? p.cvs + b * p.css_b + h * p.css_h : nullptr;

  for (int t = t_begin; t < t_end; ++t) {
    if (t > t_begin) tile_biases(t);
    // the block's lane groups hold all 64 keys of the tile between them
    int live = 0;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) live |= bj[i] > kNegInf;
    if (skip && !__syncthreads_or(live)) continue;  // every key masked: weight 0
    // issue every load of this lane's key rows before using any
    uint4 kr[kKeys], vr[kKeys];
    float ks[kKeys], vs[kKeys];
    bool ok[kKeys];
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const int j = t * kTile + grp + i * kRowsAtOnce;
      ok[i] = skip ? bj[i] > kNegInf : bj[i] != neg_inf();
      kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
      ks[i] = vs[i] = 1.f;
      if (ok[i]) {
        if (j < c) {
          kr[i] = load_piece<S>(RK + j * p.rs_s, p.ring_vec);
          vr[i] = load_piece<S>(RV + j * p.rs_s, p.ring_vec);
          if (kScaled) {
            ks[i] = RKS[j * p.rss_s];
            vs[i] = RVS[j * p.rss_s];
          }
        } else {
          const int mm = j - c;
          kr[i] = load_piece<S>(CK + mm * p.cs_s, p.slot_vec);
          vr[i] = load_piece<S>(CV + mm * p.cs_s, p.slot_vec);
          if (kScaled) {
            ks[i] = CKS[mm * p.css_s];
            vs[i] = CVS[mm * p.css_s];
          }
        }
      }
    }
    // scores: the lane's piece of q·k, summed over the row's kLanes lanes
    float s[kKeys][kGroupRows];
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
#pragma unroll
      for (int g = 0; g < kGroupRows; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          float kv = piece_elem<S>(kr[i], u);
          if (kScaled) kv *= ks[i];
          dot = fmaf(qf[g][u], kv, dot);
        }
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(kFull, dot, off);
        s[i][g] = ok[i] ? dot * p.scale + bj[i] : neg_inf();
      }
    }
    // online softmax of this lane group's keys
#pragma unroll
    for (int g = 0; g < kGroupRows; ++g) {
      float mt = s[0][g];
#pragma unroll
      for (int i = 1; i < kKeys; ++i) mt = nan_max(mt, s[i][g]);
      const float mn = nan_max(m[g], mt);
      if (mn == neg_inf()) continue;  // no key of this group in the tile
      const float alpha = expf(m[g] - mn);
      l[g] *= alpha;
#pragma unroll
      for (int u = 0; u < kVec; ++u) acc[g][u] *= alpha;
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        const float pr = expf(s[i][g] - mn);
        l[g] += pr;
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          float vv = piece_elem<S>(vr[i], u);
          if (kScaled) vv *= vs[i];
          acc[g][u] = fmaf(pr, vv, acc[g][u]);
        }
      }
      m[g] = mn;
    }
  }

  // merge the lane groups of a warp (xor butterfly: every lane ends with
  // the same sums)
#pragma unroll
  for (int off = kLanes; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < kGroupRows; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lo = __shfl_xor_sync(kFull, l[g], off);
      const float mn = nan_max(m[g], mo);
      const float a = state_weight(m[g], mn), w = state_weight(mo, mn);
      l[g] = l[g] * a + lo * w;
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const float ao = __shfl_xor_sync(kFull, acc[g][u], off);
        acc[g][u] = acc[g][u] * a + ao * w;
      }
      m[g] = mn;
    }
  }
  if (lane < kLanes) {
#pragma unroll
    for (int g = 0; g < kGroupRows; ++g) {
#pragma unroll
      for (int u = 0; u < kVec; ++u) sm_o[warp][g][sub * kVec + u] = acc[g][u];
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps in order; one split writes the output, several their
  // states for decode_combine_kernel
  const long long slot = static_cast<long long>(bh) * p.nsplit + split;
  const long long n_states = static_cast<long long>(p.B) * p.Hkv * p.nsplit * p.G;
  for (int idx = tid; idx < rows * Dh; idx += kThreads) {
    const int g = idx / Dh, d = idx % Dh;
    float mx = neg_inf();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = nan_max(mx, sm_m[w][g]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = state_weight(sm_m[w][g], mx);
      lsum += sm_l[w][g] * a;
      o += sm_o[w][g][d] * a;
    }
    if (p.nsplit == 1) {
      T* O = static_cast<T*>(p.out) + (static_cast<long long>(bh) * p.G + g0 + g) * Dh;
      O[d] = from_f32<T>(o / lsum);
    } else {
      const long long st = slot * p.G + g0 + g;
      p.part[st * Dh + d] = o;
      if (d == 0) {
        p.part[n_states * Dh + st] = mx;
        p.part[n_states * (Dh + 1) + st] = lsum;
      }
    }
  }
}

// Merge the nsplit states of each (row, kv head) in split order, normalise
// and write the output: one thread for 4 output elements (16-byte loads of
// the states' o).
template <typename T>
__global__ void __launch_bounds__(kCombineThreads) decode_combine_kernel(DecodeParams p) {
  wait_for_primary_grid();
  const int bh = blockIdx.x, G = p.G, Dh = p.Dh, ns = p.nsplit;
  const long long n_states = static_cast<long long>(p.B) * p.Hkv * ns * G;
  const long long first = static_cast<long long>(bh) * ns * G;
  const float* PO = p.part + first * Dh;
  const float* PM = p.part + n_states * Dh + first;
  const float* PL = p.part + n_states * (Dh + 1) + first;
  T* O = static_cast<T*>(p.out) + static_cast<long long>(bh) * G * Dh;
  for (int idx = threadIdx.x * 4; idx < G * Dh; idx += kCombineThreads * 4) {
    const int g = idx / Dh, d = idx % Dh;
    float mx = neg_inf();
#pragma unroll 4
    for (int s = 0; s < ns; ++s) mx = nan_max(mx, PM[s * G + g]);
    float lsum = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int s = 0; s < ns; ++s) {
      const float a = state_weight(PM[s * G + g], mx);
      const float4 po =
          *reinterpret_cast<const float4*>(PO + (static_cast<long long>(s) * G + g) * Dh + d);
      lsum += PL[s * G + g] * a;
      o[0] += po.x * a;
      o[1] += po.y * a;
      o[2] += po.z * a;
      o[3] += po.w * a;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) O[idx + u] = from_f32<T>(o[u] / lsum);
  }
}

template <typename T, typename S, int Dh>
cudaError_t launch(const DecodeParams& p, cudaStream_t stream) {
  constexpr int threads = DecodeCfg<S, Dh>::kThreads;
  const dim3 grid(p.B * p.Hkv, p.nsplit, (p.G + kGroupRows - 1) / kGroupRows);
  decode_split_kernel<T, S, Dh><<<grid, threads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.nsplit == 1) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.B * p.Hkv);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.stream = stream;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_combine_kernel<T>, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, typename S>
cudaError_t dispatch_dh(const DecodeParams& p, cudaStream_t stream) {
  switch (p.Dh) {
    case 16: return launch<T, S, 16>(p, stream);
    case 32: return launch<T, S, 32>(p, stream);
    case 64: return launch<T, S, 64>(p, stream);
    case 128: return launch<T, S, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_cache(const DecodeParams& p, int dtype, int cache_dtype,
                           cudaStream_t stream) {
  if (cache_dtype == dtype) return dispatch_dh<T, T>(p, stream);
  if (cache_dtype == kInt8) return dispatch_dh<T, int8_t>(p, stream);
  if (cache_dtype == kFp8E4M3) return dispatch_dh<T, __nv_fp8_e4m3>(p, stream);
  return cudaErrorInvalidValue;
}

// 16-byte loads of a (k, v) pair are allowed when both bases and every
// stride (in bytes) are multiples of 16.
bool vec_ok(const void* k, const void* v, const long long* strides, int elem_bytes) {
  if (reinterpret_cast<std::uintptr_t>(k) % 16 || reinterpret_cast<std::uintptr_t>(v) % 16)
    return false;
  for (int i = 0; i < 3; ++i)
    if ((strides[i] * elem_bytes) % 16) return false;
  return true;
}

}  // namespace
}  // namespace repro_torch

// dtype: q and out; cache_dtype: the ring and the slots, either dtype or a
// quantized storage (int8, fp8 e4m3) whose fp32 scales are raw_k_s / raw_v_s
// (B, Hkv, c) and comp_k_s / comp_v_s (B, Hkv, M) (all four null for a dense
// cache). part: fp32 scratch of B·Hkv·nsplit·G·(Dh + 2) elements (null when
// nsplit is 1); nsplit splits of tiles_per_split 64-key tiles cover the
// c + M keys (kernels/common.decode_splits). strides: 12 element strides
// (batch, head, position) of the ring (raw_k and raw_v share them), the
// slots (comp_k and comp_v share them), the ring scales and the slot scales
// (unused when null). Returns the launches' cudaError_t.
extern "C" int decode_forward(const void* q, const void* raw_k, const void* raw_v,
                              const void* comp_k, const void* comp_v, const float* raw_k_s,
                              const float* raw_v_s, const float* comp_k_s,
                              const float* comp_v_s, const void* bias_loc,
                              const void* bias_glob, void* out, float* part,
                              const long long* strides, int B, int Hkv, int G, int Dh,
                              int c, int M, int nsplit, int tiles_per_split, float scale,
                              int dtype, int cache_dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || Hkv <= 0 || G <= 0 || Dh <= 0 || c <= 0 || M < 0)
    return cudaErrorInvalidValue;
  const bool scaled = raw_k_s != nullptr;
  if ((raw_v_s == nullptr) == scaled || (comp_k_s == nullptr) == scaled ||
      (comp_v_s == nullptr) == scaled || scaled == (cache_dtype == dtype))
    return cudaErrorInvalidValue;
  const int ntiles = (c + M + kTile - 1) / kTile;
  if (nsplit < 1 || tiles_per_split < 1 || (nsplit - 1) * tiles_per_split >= ntiles ||
      nsplit * tiles_per_split < ntiles || (nsplit > 1) != (part != nullptr) ||
      nsplit > 65535 || (G + kGroupRows - 1) / kGroupRows > 65535)
    return cudaErrorInvalidValue;
  const int elem_bytes = cache_dtype == kFloat32 ? 4 : cache_dtype == kBFloat16 ? 2 : 1;
  DecodeParams p;
  p.q = q;
  p.rk = raw_k;
  p.rv = raw_v;
  p.ck = comp_k;
  p.cv = comp_v;
  p.rks = raw_k_s;
  p.rvs = raw_v_s;
  p.cks = comp_k_s;
  p.cvs = comp_v_s;
  p.bias_loc = static_cast<const float*>(bias_loc);
  p.bias_glob = static_cast<const float*>(bias_glob);
  p.out = out;
  p.part = part;
  p.rs_b = strides[0];
  p.rs_h = strides[1];
  p.rs_s = strides[2];
  p.cs_b = strides[3];
  p.cs_h = strides[4];
  p.cs_s = strides[5];
  p.rss_b = strides[6];
  p.rss_h = strides[7];
  p.rss_s = strides[8];
  p.css_b = strides[9];
  p.css_h = strides[10];
  p.css_s = strides[11];
  p.B = B;
  p.Hkv = Hkv;
  p.G = G;
  p.Dh = Dh;
  p.c = c;
  p.M = M;
  p.nsplit = nsplit;
  p.tiles_per_split = tiles_per_split;
  p.ring_vec = vec_ok(raw_k, raw_v, strides, elem_bytes);
  p.slot_vec = vec_ok(comp_k, comp_v, strides + 3, elem_bytes);
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_cache<float>(p, dtype, cache_dtype, s);
  if (dtype == kBFloat16) return dispatch_cache<__nv_bfloat16>(p, dtype, cache_dtype, s);
  return cudaErrorInvalidValue;
}
