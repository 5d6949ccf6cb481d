// Blockwise-causal Linformer attention, forward (CUDA C++ for sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/blockwise_causal_attn.py:
// blockwise_causal_attn, both forms: the plain one (body _kernel ->
// _attend_block -> _joint_scores) and, given non-null `m` / `denom`
// pointers, the residual-emitting one (return_residuals=True, _kernel_res).
// Each query row t of block n = t / c takes one joint softmax over its own
// block (causal, keys n*c .. t) and the compressed slots m < n*r of the
// earlier blocks. Scores and accumulation are fp32; the output has q's dtype.
// GQA: query head h reads kv head h / G, never a repeated copy.
//
// The residual form also writes each row's softmax max and denominator in
// fp32, which the backward (blockwise_causal_attn_bwd.cu) recomputes the
// probabilities from. The online softmax rescales its running denominator
// whenever the running max moves, so after the last tile the pair (m, l) is
// exactly _attend_block's (the max over the joint row and the sum of
// exp(s - max)); that final pair is what gets written.
//
// What bounds it on an H100. At serving prefill lengths (S of a few thousand,
// Dh = 128) the work is about 4*Dh flops per visible (row, key) pair against
// one read of q, k, v, k-bar, v-bar and one write of the output: in bf16 that
// sits below the tensor cores' ridge, so the bound is memory traffic. This
// first version computes on the fp32 CUDA cores, not the tensor cores, so in
// practice it is bound by fp32 FMA issue; moving the two products to wgmma
// is the next step.
//
// What the design does about it. The TPU kernel pinned all M = (S/c)*r slots
// in VMEM per grid step (1 MiB each for k-bar and v-bar at M = 4096, Dh = 128,
// bf16), far past the 227 KB of shared memory of one block. Here one thread
// block owns one (batch*head, query tile of BQ rows); a tile never straddles
// two attention blocks (BQ divides c). It streams 64-key tiles through shared
// memory with an online softmax in fp32 (running max and sum per row,
// normalised once at the end): first only the visible slot tiles (m < n*r),
// then the own block up to the tile's last row, so tiles above the diagonal
// are never loaded. Each score tile is 16 x 16 threads with a register block
// of (BQ/16) x 4 scores and (BQ/16) x (Dh/16) output accumulators; rows are
// padded by one float in shared memory so the inner products are free of bank
// conflicts.
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;             // 16 x 16
constexpr int kTileK = 64;                // keys or slots per shared-memory tile
constexpr int kPPitch = kTileK + 16;      // probability tile pitch (no bank conflicts)

struct Strides {
  long long b, h, s;                      // elements; the last dim is contiguous
};

struct BcaParams {
  const void* q;
  const void* k;
  const void* v;
  const void* kbar;
  const void* vbar;
  void* out;
  float* m;                               // (B, H, S) residuals, or null
  float* denom;
  Strides sq, skv, sslot, so;
  int H, Hkv, S, M, block_size, block_slots;
  float scale;
};

// One key tile of the online softmax. Column `col` of the tile is visible to
// tile row `row` when col < valid and, for the causal local tile,
// col <= row + diag (diag = first query row - first key of the tile).
template <int Dh, int BQ>
__device__ __forceinline__ void tile_step(const float* sQ, const float* sK, const float* sV,
                                          float* sP, float (&o)[BQ / 16][Dh / 16],
                                          float (&m)[BQ / 16], float (&l)[BQ / 16],
                                          float scale, int valid, bool causal, int diag) {
  constexpr int RQ = BQ / 16, RK = kTileK / 16, RD = Dh / 16, P = Dh + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float s[RQ][RK];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RK; ++j) s[i][j] = 0.f;

#pragma unroll 4
  for (int d = 0; d < Dh; ++d) {
    float qv[RQ], kv[RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) qv[i] = sQ[(ty + 16 * i) * P + d];
#pragma unroll
    for (int j = 0; j < RK; ++j) kv[j] = sK[(tx + 16 * j) * P + d];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = ty + 16 * i;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      const int col = tx + 16 * j;
      const bool ok = col < valid && (!causal || col <= row + diag);
      s[i][j] = ok ? s[i][j] * scale : kNegInf;
      mx = fmaxf(mx, s[i][j]);
    }
    mx = half_warp_max(mx);
    const float m_new = fmaxf(m[i], mx);
    const float alpha = expf(m[i] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      const float pj = expf(s[i][j] - m_new);
      sP[row * kPPitch + tx + 16 * j] = pj;
      rs += pj;
    }
    rs = half_warp_sum(rs);
    l[i] = l[i] * alpha + rs;
    m[i] = m_new;
#pragma unroll
    for (int jd = 0; jd < RD; ++jd) o[i][jd] *= alpha;
  }
  __syncthreads();  // the probability tile is complete

  for (int j = 0; j < valid; ++j) {
    float vv[RD];
#pragma unroll
    for (int jd = 0; jd < RD; ++jd) vv[jd] = sV[j * P + tx + 16 * jd];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const float pij = sP[(ty + 16 * i) * kPPitch + j];
#pragma unroll
      for (int jd = 0; jd < RD; ++jd) o[i][jd] = fmaf(pij, vv[jd], o[i][jd]);
    }
  }
}

template <typename T, int Dh, int BQ>
__global__ void __launch_bounds__(kThreads) bca_fwd_kernel(BcaParams p) {
  constexpr int RQ = BQ / 16, RD = Dh / 16, P = Dh + 1;
  extern __shared__ float smem[];
  float* sQ = smem;                 // BQ x P
  float* sK = sQ + BQ * P;          // kTileK x P
  float* sV = sK + kTileK * P;      // kTileK x P
  float* sP = sV + kTileK * P;      // BQ x kPPitch

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int n = q0 / p.block_size;

  const T* Q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* K = static_cast<const T*>(p.k) + b * p.skv.b + hk * p.skv.h;
  const T* V = static_cast<const T*>(p.v) + b * p.skv.b + hk * p.skv.h;
  const T* KB = static_cast<const T*>(p.kbar) + b * p.sslot.b + hk * p.sslot.h;
  const T* VB = static_cast<const T*>(p.vbar) + b * p.sslot.b + hk * p.sslot.h;
  T* O = static_cast<T*>(p.out) + b * p.so.b + h * p.so.h;

  load_rows<kThreads, T, Dh>(sQ, Q + q0 * p.sq.s, p.sq.s, BQ, BQ);

  float o[RQ][RD], m[RQ], l[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < RD; ++jd) o[i][jd] = 0.f;
  }

  // compressed slots of the blocks before n: every row of the tile sees them
  const int nslots = n * p.block_slots;
  for (int j0 = 0; j0 < nslots; j0 += kTileK) {
    const int valid = min(kTileK, nslots - j0);
    __syncthreads();  // the previous tile is consumed
    load_rows<kThreads, T, Dh>(sK, KB + j0 * p.sslot.s, p.sslot.s, kTileK, valid);
    load_rows<kThreads, T, Dh>(sV, VB + j0 * p.sslot.s, p.sslot.s, kTileK, valid);
    __syncthreads();
    tile_step<Dh, BQ>(sQ, sK, sV, sP, o, m, l, p.scale, valid, false, 0);
  }

  // the own block, causally, up to the tile's last row
  const int k_end = q0 + BQ;
  for (int j0 = n * p.block_size; j0 < k_end; j0 += kTileK) {
    const int valid = min(kTileK, k_end - j0);
    __syncthreads();
    load_rows<kThreads, T, Dh>(sK, K + j0 * p.skv.s, p.skv.s, kTileK, valid);
    load_rows<kThreads, T, Dh>(sV, V + j0 * p.skv.s, p.skv.s, kTileK, valid);
    __syncthreads();
    tile_step<Dh, BQ>(sQ, sK, sV, sP, o, m, l, p.scale, valid, true, q0 - j0);
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int jd = 0; jd < RD; ++jd)
      O[row * p.so.s + tx + 16 * jd] = from_f32<T>(o[i][jd] * inv);
    // every lane of the half warp holds the same (m, l) after the reductions
    if (p.m != nullptr && tx == 0) {
      const long long at = static_cast<long long>(bh) * p.S + row;
      p.m[at] = m[i];
      p.denom[at] = l[i];
    }
  }
}

template <typename T, int Dh, int BQ>
cudaError_t launch(const BcaParams& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((BQ + 2 * kTileK) * (Dh + 1) + BQ * kPPitch);
  auto kernel = bca_fwd_kernel<T, Dh, BQ>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.S / BQ, B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int BQ>
cudaError_t dispatch_head_dim(const BcaParams& p, int B, int Dh, cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch<T, 16, BQ>(p, B, stream);
    case 32: return launch<T, 32, BQ>(p, B, stream);
    case 64: return launch<T, 64, BQ>(p, B, stream);
    case 128: return launch<T, 128, BQ>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_tile(const BcaParams& p, int B, int Dh, cudaStream_t stream) {
  if (p.block_size % 64 == 0) return dispatch_head_dim<T, 64>(p, B, Dh, stream);
  if (p.block_size % 16 == 0) return dispatch_head_dim<T, 16>(p, B, Dh, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// q (B,H,S,Dh); k, v (B,Hkv,S,Dh); kbar, vbar (B,Hkv,M,Dh); out (B,H,S,Dh);
// m, denom: null, or contiguous (B,H,S) fp32 for the residuals.
// strides: 12 element strides (batch, head, seq) of q, k and v (shared),
// kbar and vbar (shared), and out. Returns the launch's cudaError_t.
extern "C" int bca_forward(const void* q, const void* k, const void* v, const void* kbar,
                           const void* vbar, void* out, float* m, float* denom,
                           const long long* strides, int B, int H, int Hkv, int S, int M,
                           int Dh, int block_size, int block_slots, float scale, int dtype,
                           void* stream) {
  using namespace repro_torch;
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || block_size <= 0 || S % block_size != 0 ||
      M != (S / block_size) * block_slots)
    return cudaErrorInvalidValue;
  BcaParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kbar = kbar;
  p.vbar = vbar;
  p.out = out;
  p.m = m;
  p.denom = denom;
  if ((m == nullptr) != (denom == nullptr)) return cudaErrorInvalidValue;
  p.sq = {strides[0], strides[1], strides[2]};
  p.skv = {strides[3], strides[4], strides[5]};
  p.sslot = {strides[6], strides[7], strides[8]};
  p.so = {strides[9], strides[10], strides[11]};
  p.H = H;
  p.Hkv = Hkv;
  p.S = S;
  p.M = M;
  p.block_size = block_size;
  p.block_slots = block_slots;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_tile<float>(p, B, Dh, s);
  if (dtype == kBFloat16) return dispatch_tile<__nv_bfloat16>(p, B, Dh, s);
  return cudaErrorInvalidValue;
}
