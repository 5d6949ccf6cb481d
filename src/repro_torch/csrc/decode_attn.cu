// Single-token GQA decode attention over the compressed cache (CUDA C++ for
// sm_90a).
//
// Replaces two TPU kernels of src/repro/kernels/linformer_attn.py:
// decode_attn (body _decode_kernel -> _attend_pinned) and decode_attn_q
// (_decode_kernel_q), the same attention over the paged, quantized cache:
// the ring and the page-gathered slots arrive as int8 or fp8 e4m3 codes with
// one fp32 scale per (row, kv head, token or slot), dequantised as each key
// tile is loaded into shared memory, so the cache bytes read shrink with the
// storage dtype. Per (batch row b, kv head h) the G query heads of the group
// take one softmax over [raw ring, c tokens | compressed slots, M], with
// per-row additive fp32 biases (0 = attendable, -1e30 = masked) for the ring
// (B, c) and the slots (B, M). Scores and accumulation are fp32; the output
// has q's dtype.
//
// What bounds it on an H100: bytes. One step reads the whole ring and slot
// buffers of every (row, kv head) once and does only 4*Dh flops per key and
// query head (G = 4 heads share each key), far below the ridge of the card.
//
// What the design does about it. The TPU kernel pinned both cache operands
// in VMEM and took one softmax over their concatenated scores, one grid step
// per (b, h). Here one thread block per (b, h) streams 64-key tiles of
// [ring | slots] through shared memory once, keeping the G query rows, their
// fp32 accumulators and an online softmax (running max and sum per row) in
// shared memory, so each cache byte is read once. Known limit of this first
// version: only B * Hkv blocks run (32 at B = 4, Hkv = 8, for 132 SMs), and
// masked keys are read too; splitting the key range over more blocks
// (flash-decoding) and skipping masked tiles are the next steps.
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;  // keys per shared-memory tile

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
  long long rs_b, rs_h, rs_s;  // ring strides (k and v share them)
  long long cs_b, cs_h, cs_s;  // slot strides (k and v share them)
  long long rss_b, rss_h, rss_s;  // ring scale strides (k and v share them)
  long long css_b, css_h, css_s;  // slot scale strides (k and v share them)
  int Hkv, G, Dh, c, M;
  float scale;
};

// T: q and the output; S: the cache storage (T, int8_t or __nv_fp8_e4m3,
// the latter two with scales)
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads) decode_kernel(DecodeParams p) {
  extern __shared__ float smem[];
  const int G = p.G, Dh = p.Dh, P = Dh + 1;
  float* sQ = smem;               // G x Dh
  float* sO = sQ + G * Dh;        // G x Dh accumulators
  float* sK = sO + G * Dh;        // kTile x P
  float* sV = sK + kTile * P;     // kTile x P
  float* sS = sV + kTile * P;     // G x kTile scores, then probabilities
  float* sM = sS + G * kTile;     // G running max
  float* sL = sM + G;             // G running sum
  float* sA = sL + G;             // G rescale factor of the current tile

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / p.Hkv, h = bh % p.Hkv;
  const T* Q = static_cast<const T*>(p.q) + static_cast<long long>(bh) * G * Dh;
  const S* RK = static_cast<const S*>(p.rk) + b * p.rs_b + h * p.rs_h;
  const S* RV = static_cast<const S*>(p.rv) + b * p.rs_b + h * p.rs_h;
  const S* CK = static_cast<const S*>(p.ck) + b * p.cs_b + h * p.cs_h;
  const S* CV = static_cast<const S*>(p.cv) + b * p.cs_b + h * p.cs_h;
  const bool scaled = p.rks != nullptr;
  const float* RKS = scaled ? p.rks + b * p.rss_b + h * p.rss_h : nullptr;
  const float* RVS = scaled ? p.rvs + b * p.rss_b + h * p.rss_h : nullptr;
  const float* CKS = scaled ? p.cks + b * p.css_b + h * p.css_h : nullptr;
  const float* CVS = scaled ? p.cvs + b * p.css_b + h * p.css_h : nullptr;
  const float* BL = p.bias_loc + static_cast<long long>(b) * p.c;
  const float* BG = p.bias_glob + static_cast<long long>(b) * p.M;
  T* O = static_cast<T*>(p.out) + static_cast<long long>(bh) * G * Dh;

  for (int i = tid; i < G * Dh; i += kThreads) {
    sQ[i] = to_f32<T>(Q[i]);
    sO[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    sM[g] = kNegInf;
    sL[g] = 0.f;
  }

  const int total = p.c + p.M;
  for (int j0 = 0; j0 < total; j0 += kTile) {
    const int n = min(kTile, total - j0);
    __syncthreads();  // the previous tile is consumed (and sQ is loaded)
    for (int idx = tid; idx < kTile * Dh; idx += kThreads) {
      const int r = idx / Dh, d = idx % Dh, j = j0 + r;
      float kv = 0.f, vv = 0.f;
      if (r < n) {
        if (j < p.c) {
          kv = to_f32<S>(RK[j * p.rs_s + d]);
          vv = to_f32<S>(RV[j * p.rs_s + d]);
          if (scaled) {
            kv *= RKS[j * p.rss_s];
            vv *= RVS[j * p.rss_s];
          }
        } else {
          const int m = j - p.c;
          kv = to_f32<S>(CK[m * p.cs_s + d]);
          vv = to_f32<S>(CV[m * p.cs_s + d]);
          if (scaled) {
            kv *= CKS[m * p.css_s];
            vv *= CVS[m * p.css_s];
          }
        }
      }
      sK[r * P + d] = kv;
      sV[r * P + d] = vv;
    }
    __syncthreads();

    for (int idx = tid; idx < G * kTile; idx += kThreads) {
      const int g = idx / kTile, r = idx % kTile, j = j0 + r;
      float s = neg_inf();  // past the end of the key range: weight exactly 0
      if (r < n) {
        float dot = 0.f;
        for (int d = 0; d < Dh; ++d) dot = fmaf(sQ[g * Dh + d], sK[r * P + d], dot);
        s = dot * p.scale + (j < p.c ? BL[j] : BG[j - p.c]);
      }
      sS[idx] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kThreads / 32) {
      float mx = neg_inf();
      for (int r = lane; r < kTile; r += 32) mx = fmaxf(mx, sS[g * kTile + r]);
      mx = warp_max(mx);
      const float m_new = fmaxf(sM[g], mx);
      float sum = 0.f;
      for (int r = lane; r < kTile; r += 32) {
        const float pr = expf(sS[g * kTile + r] - m_new);
        sS[g * kTile + r] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(sM[g] - m_new);
        sA[g] = alpha;
        sL[g] = sL[g] * alpha + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * Dh; idx += kThreads) {
      const int g = idx / Dh, d = idx % Dh;
      float acc = sO[idx] * sA[g];
      for (int r = 0; r < n; ++r) acc = fmaf(sS[g * kTile + r], sV[r * P + d], acc);
      sO[idx] = acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * Dh; idx += kThreads)
    O[idx] = from_f32<T>(sO[idx] / sL[idx / Dh]);
}

template <typename T, typename S>
cudaError_t launch(const DecodeParams& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (2 * p.G * p.Dh + 2 * kTile * (p.Dh + 1) + p.G * kTile + 3 * p.G);
  auto kernel = decode_kernel<T, S>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * p.Hkv, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_cache(const DecodeParams& p, int B, int dtype, int cache_dtype,
                           cudaStream_t stream) {
  if (cache_dtype == dtype) return launch<T, T>(p, B, stream);
  if (cache_dtype == kInt8) return launch<T, int8_t>(p, B, stream);
  if (cache_dtype == kFp8E4M3) return launch<T, __nv_fp8_e4m3>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// dtype: q and out; cache_dtype: the ring and the slots, either dtype or a
// quantized storage (int8, fp8 e4m3) whose fp32 scales are raw_k_s / raw_v_s
// (B, Hkv, c) and comp_k_s / comp_v_s (B, Hkv, M) (all four null for a dense
// cache). strides: 12 element strides (batch, head, position) of the ring
// (raw_k and raw_v share them), the slots (comp_k and comp_v share them),
// the ring scales and the slot scales (unused when null). Returns the
// launch's cudaError_t.
extern "C" int decode_forward(const void* q, const void* raw_k, const void* raw_v,
                              const void* comp_k, const void* comp_v, const float* raw_k_s,
                              const float* raw_v_s, const float* comp_k_s,
                              const float* comp_v_s, const void* bias_loc,
                              const void* bias_glob, void* out, const long long* strides,
                              int B, int Hkv, int G, int Dh, int c, int M, float scale,
                              int dtype, int cache_dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || Hkv <= 0 || G <= 0 || Dh <= 0 || c <= 0 || M < 0)
    return cudaErrorInvalidValue;
  const bool scaled = raw_k_s != nullptr;
  if ((raw_v_s == nullptr) == scaled || (comp_k_s == nullptr) == scaled ||
      (comp_v_s == nullptr) == scaled || scaled == (cache_dtype == dtype))
    return cudaErrorInvalidValue;
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
  p.Hkv = Hkv;
  p.G = G;
  p.Dh = Dh;
  p.c = c;
  p.M = M;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_cache<float>(p, B, dtype, cache_dtype, s);
  if (dtype == kBFloat16) return dispatch_cache<__nv_bfloat16>(p, B, dtype, cache_dtype, s);
  return cudaErrorInvalidValue;
}
