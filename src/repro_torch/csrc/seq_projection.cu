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
// paper's shapes (S = 512, K = 128, Dh = 64) about 100 flops a byte in bf16,
// a third of the tensor cores' ridge, but 50 times the fp32 CUDA cores'.
//
// What the design does about it. The TPU kernel swept the sequence axis as the
// innermost grid dimension and carried the (K, Dh) sum in VMEM scratch from
// one grid step to the next; CUDA blocks run in no order, so the sweep is a
// loop inside one block instead, and the sum runs in one fixed order with no
// atomics (the result is deterministic). Two designs, by dtype:
//
// bf16 (seq_projection_mma_kernel, the model's dtype): the products run on
// the tensor cores (mma.sync m16n8k16, fp32 accumulators). One block of 8
// warps owns (batch*head, a tile of up to 128 slots, 16 a warp), so at
// K = 128 it reads its x once. S streams in 64-row chunks of x (64 x Dh) and
// of E (64 x slot tile), double-buffered with 16-byte cp.async copies into
// shared memory (pitch +8 bf16, free of ldmatrix bank conflicts); A = Eᵀ and
// B = x both come out of shared memory by ldmatrix.trans, and a warp's
// 16 x Dh sums stay in registers until the one store. A ragged S is
// zero-filled; slots >= K are neither loaded nor stored. An operand whose
// base or row stride is not a multiple of 16 bytes (E[:S] at K = 1 or 70, a
// view that starts one element into a buffer) is read element by element
// into the same layout. E is shared by every (b, h): its chunks come by
// cp.async.ca, through L1, where the other blocks on the SM find them (a
// persistent variant that kept E[:S] in shared memory and walked several
// heads per block measured slower on the H100).
//
// fp32 (seq_projection_kernel, the card's parity path; tensor cores would
// round it to TF32): SIMT. One thread block per (batch*head, tile of 64
// slots) walks S in 32-row steps, stages the E tile and the x tile through
// shared memory in fp32, and keeps its 64 x Dh outputs in registers (16 x 16
// threads, each 4 slots x Dh/16 columns), written once at the end.
#include <cstdint>

#include "common.cuh"
#include "mma_bf16.cuh"

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
  bool x_vec, e_vec;            // bf16 kernel: x / E rows go by 16-byte copies
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

// -- bf16: tensor cores ------------------------------------------------------

namespace tc {
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpSlots = 16;            // one m-tile a warp: 4·Dh/8 accumulators a thread
constexpr int kTileK = kWarps * kWarpSlots;  // slots per block
constexpr int kChunkS = 64;               // sequence rows per stage
constexpr int kStages = 2;
constexpr int kEPitch = kTileK + 8;

template <int Dh>
struct Tile {
  static constexpr int kXPitch = Dh + 8;
  static constexpr int kStageElems = kChunkS * (kXPitch + kEPitch);  // x and E chunks
};
}  // namespace tc

template <int Dh>
__global__ void __launch_bounds__(tc::kThreads) seq_projection_mma_kernel(SpParams p) {
  using Tl = tc::Tile<Dh>;
  using bf16 = __nv_bfloat16;
  constexpr int NT = Dh / 8, XP = Tl::kXPitch, EP = tc::kEPitch;
  extern __shared__ uint4 smem_sp[];
  bf16* stages = reinterpret_cast<bf16*>(smem_sp);  // kStages x (x chunk, E chunk)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * tc::kTileK;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const bf16* X = static_cast<const bf16*>(p.x) + b * p.xs_b + h * p.xs_h;
  const bf16* E = static_cast<const bf16*>(p.e) + k0;
  bf16* O = static_cast<bf16*>(p.out) + b * p.os_b + h * p.os_h;
  const int kvalid = min(tc::kTileK, p.K - k0);
  const int nchunks = (p.S + tc::kChunkS - 1) / tc::kChunkS;

  auto load_chunk = [&](int c) {
    bf16* sx = stages + (c % tc::kStages) * Tl::kStageElems;
    bf16* se = sx + tc::kChunkS * XP;
    const int s0 = c * tc::kChunkS, rows = min(tc::kChunkS, p.S - s0);
    mma::load_tile<tc::kThreads, tc::kChunkS, Dh, XP>(sx, X + s0 * p.xs_s, p.xs_s, rows, Dh,
                                                      p.x_vec);
    // E through L1: the blocks an SM holds read the same E chunks
    mma::load_tile<tc::kThreads, tc::kChunkS, tc::kTileK, EP, true>(se, E + s0 * p.es, p.es,
                                                                    rows, kvalid, p.e_vec);
    mma::cp_async_commit();
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  load_chunk(0);
  for (int c = 0; c < nchunks; ++c) {
    mma::cp_async_wait<0>();
    __syncthreads();  // chunk c has landed for all; the other stage is consumed
    if (c + 1 < nchunks) load_chunk(c + 1);
    const bf16* sx = stages + (c % tc::kStages) * Tl::kStageElems;
    const bf16* se = sx + tc::kChunkS * XP;
#pragma unroll
    for (int ks = 0; ks < tc::kChunkS / 16; ++ks) {
      // A = Eᵀ (the warp's 16 slots x 16 rows of s): matrices (slots +0/+8) x (s +0/+8)
      uint32_t a[4];
      mma::ldmatrix_x4_trans(a, se + (ks * 16 + (lane >> 4) * 8 + (lane & 7)) * EP
                                    + warp * tc::kWarpSlots + ((lane >> 3) & 1) * 8);
      // B = x (16 rows of s x 16 columns): matrices (s +0/+8) x (d +0/+8)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        mma::ldmatrix_x4_trans(
            bf, sx + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * XP + np * 16
                    + (lane >> 4) * 8);
        mma::mma_bf16_16816(acc[2 * np], a, bf[0], bf[1]);
        mma::mma_bf16_16816(acc[2 * np + 1], a, bf[2], bf[3]);
      }
    }
  }

  // C fragment: (slot g / g + 8, columns 2t, 2t + 1); out's strides are even
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int k = k0 + warp * tc::kWarpSlots + g + 8 * half;
    if (k >= p.K) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<uint32_t*>(O + k * p.os_k + nt * 8 + 2 * t) =
          mma::pack_bf16x2(acc[nt][2 * half], acc[nt][2 * half + 1]);
  }
}

template <int Dh>
cudaError_t launch_mma(const SpParams& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * tc::kStages * tc::Tile<Dh>::kStageElems;
  auto kernel = seq_projection_mma_kernel<Dh>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.K + tc::kTileK - 1) / tc::kTileK, B * p.H);
  kernel<<<grid, tc::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const SpParams& p, int B, int Dh, cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch_mma<16>(p, B, stream);
    case 32: return launch_mma<32>(p, B, stream);
    case 64: return launch_mma<64>(p, B, stream);
    case 128: return launch_mma<128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// x (B,H,S,Dh); e (S,K); out (B,H,K,Dh), all in `dtype`. strides: 7 element
// strides: x's (batch, head, seq), E's row, out's (batch, head, slot).
// fp32 runs the SIMT kernel, bf16 the tensor-core kernel. Returns the
// launch's cudaError_t.
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
  if (dtype != kBFloat16) return cudaErrorInvalidValue;
  // the bf16 kernel stores bf16 pairs: out's base and strides must be even
  if (reinterpret_cast<uintptr_t>(out) % 4 != 0 || ((p.os_b | p.os_h | p.os_k) & 1))
    return cudaErrorInvalidValue;
  p.x_vec = mma::aligned16(x, p.xs_b, p.xs_h, p.xs_s);
  p.e_vec = mma::aligned16(e, p.es);
  return dispatch_mma(p, B, Dh, s);
}
