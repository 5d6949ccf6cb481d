// Exact (bidirectional) Linformer attention over the compressed keys and
// values, forward (CUDA C++ for sm_90a).
//
// Replaces the TPU kernel linformer_attn of src/repro/kernels/linformer_attn.py
// (body _kernel -> _softmax_attend): out = softmax(q k-barᵀ * scale) v-bar,
// each query row over all K compressed slots, nothing masked. q (B, H, S, Dh);
// k-bar, v-bar (B, Hkv, K, Dh); out (B, H, S, Dh) in q's dtype. GQA: query
// head h reads kv head h / G, never a repeated copy (the TPU wrapper repeats
// k-bar / v-bar to H heads before the call). Scores, probabilities and the
// accumulation are fp32; the TPU kernel casts the normalised probabilities to
// v-bar's dtype before the value product, this kernel keeps them in fp32 (the
// same in fp32; a rounding-level difference in bf16).
//
// What bounds it on an H100: bytes. At the paper's shapes (S = 512, K = 128,
// Dh = 64) it does 4*Dh flops per (row, slot) pair against one read of q,
// k-bar, v-bar and one write of the output: about 25 flops a byte in bf16,
// far below the tensor cores' ridge.
//
// What the design does about it. The TPU kernel pinned the whole k-bar / v-bar
// of a head in VMEM (K <= 512) and took a one-pass softmax per query block.
// K = 512 at Dh = 128 would need 512 KB of fp32 shared memory, above the
// 227 KB a block may use, so here the slots are streamed instead: one thread
// block owns one (batch*head, tile of 64 query rows) and walks k-bar / v-bar
// in 64-slot tiles through shared memory with an online fp32 softmax (running
// max and sum per row, normalised once at the end), the tile step of the
// blockwise-causal kernel (attn_tile.cuh) without its causal mask. Any K
// runs; the wrapper keeps the JAX package's K <= 512 bound only to refuse the
// shapes it refuses. A ragged last query tile (S not a multiple of 64) loads
// zeros past the end and stores only the rows that exist. All SIMT fp32:
// moving the two products to tensor cores is the next step.
#include <cstdint>

#include "attn_tile.cuh"
#include "common.cuh"

namespace repro_torch {
namespace {

using attn_tile::kPPitch;
using attn_tile::kThreads;
using attn_tile::kTileK;
using attn_tile::tile_step;

constexpr int kTileQ = 64;                // query rows per thread block

struct Strides {
  long long b, h, s;                      // elements; the last dim is contiguous
};

struct ExactParams {
  const void* q;
  const void* kbar;
  const void* vbar;
  void* out;
  Strides sq, skv, so;                    // k-bar and v-bar share one stride set
  int H, Hkv, S, K;
  float scale;
};

template <typename T, int Dh>
__global__ void __launch_bounds__(kThreads) exact_fwd_kernel(ExactParams p) {
  constexpr int RQ = kTileQ / 16, RD = Dh / 16, P = Dh + 1;
  extern __shared__ float smem[];
  float* sQ = smem;                 // kTileQ x P
  float* sK = sQ + kTileQ * P;      // kTileK x P
  float* sV = sK + kTileK * P;      // kTileK x P
  float* sP = sV + kTileK * P;      // kTileQ x kPPitch

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = blockIdx.x * kTileQ;
  const int rows = min(kTileQ, p.S - q0);

  const T* Q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* KB = static_cast<const T*>(p.kbar) + b * p.skv.b + hk * p.skv.h;
  const T* VB = static_cast<const T*>(p.vbar) + b * p.skv.b + hk * p.skv.h;
  T* O = static_cast<T*>(p.out) + b * p.so.b + h * p.so.h;

  load_rows<kThreads, T, Dh>(sQ, Q + q0 * p.sq.s, p.sq.s, kTileQ, rows);

  float o[RQ][RD], m[RQ], l[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < RD; ++jd) o[i][jd] = 0.f;
  }

  for (int j0 = 0; j0 < p.K; j0 += kTileK) {
    const int valid = min(kTileK, p.K - j0);
    __syncthreads();  // the previous tile is consumed (and sQ is loaded)
    load_rows<kThreads, T, Dh>(sK, KB + j0 * p.skv.s, p.skv.s, kTileK, valid);
    load_rows<kThreads, T, Dh>(sV, VB + j0 * p.skv.s, p.skv.s, kTileK, valid);
    __syncthreads();
    tile_step<Dh, kTileQ>(sQ, sK, sV, sP, o, m, l, p.scale, valid, false, 0);
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int jd = 0; jd < RD; ++jd)
      O[(q0 + r) * p.so.s + tx + 16 * jd] = from_f32<T>(o[i][jd] * inv);
  }
}

template <typename T, int Dh>
cudaError_t launch(const ExactParams& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((kTileQ + 2 * kTileK) * (Dh + 1) + kTileQ * kPPitch);
  auto kernel = exact_fwd_kernel<T, Dh>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kTileQ - 1) / kTileQ, B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const ExactParams& p, int B, int Dh, cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch<T, 16>(p, B, stream);
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// q (B,H,S,Dh); kbar, vbar (B,Hkv,K,Dh); out (B,H,S,Dh), all in `dtype`.
// strides: 9 element strides (batch, head, seq) of q, of kbar and vbar
// (shared) and of out. Returns the launch's cudaError_t.
extern "C" int linformer_attn_forward(const void* q, const void* kbar, const void* vbar,
                                      void* out, const long long* strides, int B, int H,
                                      int Hkv, int S, int K, int Dh, float scale, int dtype,
                                      void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || K <= 0 || Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  ExactParams p;
  p.q = q;
  p.kbar = kbar;
  p.vbar = vbar;
  p.out = out;
  p.sq = {strides[0], strides[1], strides[2]};
  p.skv = {strides[3], strides[4], strides[5]};
  p.so = {strides[6], strides[7], strides[8]};
  p.H = H;
  p.Hkv = Hkv;
  p.S = S;
  p.K = K;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_head_dim<float>(p, B, Dh, s);
  if (dtype == kBFloat16) return dispatch_head_dim<__nv_bfloat16>(p, B, Dh, s);
  return cudaErrorInvalidValue;
}
