// Sequence projection of the exact Linformer form, K-bar = Eᵀ x (CUDA C++ for
// sm_90a).
//
// Replaces the TPU kernel seq_projection of src/repro/kernels/seq_projection.py
// (body _kernel): out[b, h, k, :] = sum over s of E[s, k] * x[b, h, s, :],
// with x (B, H, S, Dh) the keys or values in any (batch, head, seq) strides,
// E (S, K) one shared projection (a leading-row view E[:S] of the stored
// (max_seq, K) E; its row stride is passed), out (B, H, K, Dh) in x's dtype.
// The products and the sum are fp32, as the TPU kernel's fp32 VMEM
// accumulator.
//
// What bounds it on an H100: bytes. It does 2*Dh flops per (s, k) pair against
// one read of x and E and one write of the much smaller output: at the
// paper's shapes (S = 512, K = 128, Dh = 64) about 25 flops a byte in bf16.
//
// What the design does about it. The TPU kernel swept the sequence axis as the
// innermost grid dimension and carried the (K, Dh) sum in VMEM scratch from
// one grid step to the next; CUDA blocks run in no order, so the sweep is a
// loop inside one block instead: one thread block per (batch*head, tile of 64
// slots) walks S in 32-row steps, stages the E tile and the x tile through
// shared memory in fp32, and keeps its 64 x Dh outputs in registers (16 x 16
// threads, each 4 slots x Dh/16 columns), written once at the end. No
// atomics, no second pass: the sum runs in one fixed order, so the result is
// deterministic. E is shared by every (b, h) and read from L2 after the first
// blocks; the slot tiles of one (b, h) are neighbours in the grid, so x's
// second read (K = 128 is two slot tiles) also comes from L2.
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kTileK = 64;      // slots per thread block
constexpr int kTileS = 32;      // sequence rows per shared-memory step

struct SpParams {
  const void* x;
  const void* e;
  void* out;
  long long xs_b, xs_h, xs_s;   // x strides (elements); the last dim is contiguous
  long long es;                 // E's row stride
  long long os_b, os_h, os_k;   // out strides
  int H, S, K;
};

template <typename T, int Dh>
__global__ void __launch_bounds__(kThreads) seq_projection_kernel(SpParams p) {
  constexpr int RK = kTileK / 16, RD = Dh / 16;
  __shared__ float sE[kTileS][kTileK];
  __shared__ float sX[kTileS][Dh];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * kTileK;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const T* X = static_cast<const T*>(p.x) + b * p.xs_b + h * p.xs_h;
  const T* E = static_cast<const T*>(p.e);
  T* O = static_cast<T*>(p.out) + b * p.os_b + h * p.os_h;

  float acc[RK][RD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;

  for (int s0 = 0; s0 < p.S; s0 += kTileS) {
    const int rows = min(kTileS, p.S - s0);
    __syncthreads();  // the previous step is consumed
    for (int idx = tid; idx < kTileS * kTileK; idx += kThreads) {
      const int r = idx / kTileK, c = idx % kTileK;
      sE[r][c] = r < rows && k0 + c < p.K ? to_f32<T>(E[(s0 + r) * p.es + k0 + c]) : 0.f;
    }
    for (int idx = tid; idx < kTileS * Dh; idx += kThreads) {
      const int r = idx / Dh, d = idx % Dh;
      sX[r][d] = r < rows ? to_f32<T>(X[(s0 + r) * p.xs_s + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kTileS; ++r) {
      float e[RK], xv[RD];
#pragma unroll
      for (int i = 0; i < RK; ++i) e[i] = sE[r][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < RD; ++j) xv[j] = sX[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(e[i], xv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k >= p.K) continue;
#pragma unroll
    for (int j = 0; j < RD; ++j) O[k * p.os_k + tx + 16 * j] = from_f32<T>(acc[i][j]);
  }
}

template <typename T, int Dh>
cudaError_t launch(const SpParams& p, int B, cudaStream_t stream) {
  const dim3 grid((p.K + kTileK - 1) / kTileK, B * p.H);
  seq_projection_kernel<T, Dh><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const SpParams& p, int B, int Dh, cudaStream_t stream) {
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

// x (B,H,S,Dh); e (S,K); out (B,H,K,Dh), all in `dtype`. strides: 7 element
// strides: x's (batch, head, seq), E's row, out's (batch, head, slot).
// Returns the launch's cudaError_t.
extern "C" int seq_projection_forward(const void* x, const void* e, void* out,
                                      const long long* strides, int B, int H, int S, int K,
                                      int Dh, int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || H <= 0 || S <= 0 || K <= 0) return cudaErrorInvalidValue;
  SpParams p;
  p.x = x;
  p.e = e;
  p.out = out;
  p.xs_b = strides[0];
  p.xs_h = strides[1];
  p.xs_s = strides[2];
  p.es = strides[3];
  p.os_b = strides[4];
  p.os_h = strides[5];
  p.os_k = strides[6];
  p.H = H;
  p.S = S;
  p.K = K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_head_dim<float>(p, B, Dh, s);
  if (dtype == kBFloat16) return dispatch_head_dim<__nv_bfloat16>(p, B, Dh, s);
  return cudaErrorInvalidValue;
}
