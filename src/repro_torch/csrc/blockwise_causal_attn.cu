// Blockwise-causal Linformer attention, forward (CUDA C++ for sm_90a).
//
// Replaces three TPU kernels of src/repro/kernels/blockwise_causal_attn.py,
// each in its plain and (given non-null `m` / `denom` pointers) its
// residual-emitting form:
//
// * blockwise_causal_attn (_kernel, _kernel_res -> _attend_block ->
//   _joint_scores): each query row t of block n = t / c takes one joint
//   softmax over its own block (causal, keys n*c .. t) and the compressed
//   slots m < n*r of the earlier blocks;
// * blockwise_causal_prefix_attn (_prefix_kernel, _prefix_kernel_res): the
//   same for a query chunk whose row b starts at absolute block
//   start_blocks[b], against a full slot buffer of M slots: chunk block n
//   sees the slots m < min((start_blocks[b] + n)*r, M) (the TPU kernel masks
//   its M pinned slots the same way); the start blocks are read on the
//   device, so one build serves every offset without a host sync;
// * blockwise_causal_prefix_attn_q (_prefix_kernel_q): the prefix form over
//   a quantized slot buffer (int8 or fp8 e4m3 codes with one fp32 scale per
//   slot), dequantised as each slot tile is loaded into shared memory; the
//   chunk's own keys and values are activations, in q's dtype.
//
// Scores and accumulation are fp32; the output has q's dtype. GQA: query
// head h reads kv head h / G, never a repeated copy.
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
// What the design does about it. The TPU kernel pinned all M slots in VMEM
// per grid step (1 MiB each for k-bar and v-bar at M = 4096, Dh = 128, bf16),
// far past the 227 KB of shared memory of one block. Here one thread block
// owns one (batch*head, query tile of BQ rows); a tile never straddles two
// attention blocks (BQ divides c). It streams 64-key tiles through shared
// memory with an online softmax in fp32 (running max and sum per row,
// normalised once at the end): first only the visible slot tiles, then the
// own block up to the tile's last row, so tiles above the diagonal and slots
// past the visibility cut are never loaded. Each score tile is 16 x 16
// threads with a register block of (BQ/16) x 4 scores and (BQ/16) x (Dh/16)
// output accumulators; rows are padded by one float in shared memory so the
// inner products are free of bank conflicts.
#include <cstdint>

#include "attn_tile.cuh"
#include "common.cuh"

namespace repro_torch {
namespace {

using attn_tile::kPPitch;
using attn_tile::kThreads;
using attn_tile::kTileK;
using attn_tile::tile_step;

struct Strides {
  long long b, h, s;                      // elements; the last dim is contiguous
};

struct BcaParams {
  const void* q;
  const void* k;
  const void* v;
  const void* kbar;                       // slot storage: q's dtype, int8 or fp8
  const void* vbar;
  void* out;
  float* m;                               // (B, H, S) residuals, or null
  float* denom;
  const int* start_blocks;                // (B,) absolute start block, or null (zeros)
  const float* kbar_scale;                // (B, Hkv, M) per-slot scales of quantized
  const float* vbar_scale;                // slots, or null
  Strides sq, skv, sslot, so, sscale;
  int H, Hkv, S, M, block_size, block_slots;
  float scale;
};

// T: q, k, v and the output; S: the slot storage (T, int8_t or __nv_fp8_e4m3)
template <typename T, typename S, int Dh, int BQ>
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
  const S* KB = static_cast<const S*>(p.kbar) + b * p.sslot.b + hk * p.sslot.h;
  const S* VB = static_cast<const S*>(p.vbar) + b * p.sslot.b + hk * p.sslot.h;
  const long long sc0 = b * p.sscale.b + hk * p.sscale.h;
  const float* KS = p.kbar_scale == nullptr ? nullptr : p.kbar_scale + sc0;
  const float* VS = p.vbar_scale == nullptr ? nullptr : p.vbar_scale + sc0;
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

  // compressed slots of the blocks before absolute block nb0 + n, clamped
  // at the buffer: every row of the tile sees them
  const int nb0 = p.start_blocks == nullptr ? 0 : p.start_blocks[b];
  const int nslots = min((nb0 + n) * p.block_slots, p.M);
  for (int j0 = 0; j0 < nslots; j0 += kTileK) {
    const int valid = min(kTileK, nslots - j0);
    const long long ks = j0 * p.sscale.s;
    __syncthreads();  // the previous tile is consumed
    load_rows_scaled<kThreads, S, Dh>(sK, KB + j0 * p.sslot.s, p.sslot.s,
                                      KS == nullptr ? nullptr : KS + ks, p.sscale.s, kTileK,
                                      valid);
    load_rows_scaled<kThreads, S, Dh>(sV, VB + j0 * p.sslot.s, p.sslot.s,
                                      VS == nullptr ? nullptr : VS + ks, p.sscale.s, kTileK,
                                      valid);
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

template <typename T, typename S, int Dh, int BQ>
cudaError_t launch(const BcaParams& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((BQ + 2 * kTileK) * (Dh + 1) + BQ * kPPitch);
  auto kernel = bca_fwd_kernel<T, S, Dh, BQ>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.S / BQ, B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename S, int BQ>
cudaError_t dispatch_head_dim(const BcaParams& p, int B, int Dh, cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch<T, S, 16, BQ>(p, B, stream);
    case 32: return launch<T, S, 32, BQ>(p, B, stream);
    case 64: return launch<T, S, 64, BQ>(p, B, stream);
    case 128: return launch<T, S, 128, BQ>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename S>
cudaError_t dispatch_tile(const BcaParams& p, int B, int Dh, cudaStream_t stream) {
  if (p.block_size % 64 == 0) return dispatch_head_dim<T, S, 64>(p, B, Dh, stream);
  if (p.block_size % 16 == 0) return dispatch_head_dim<T, S, 16>(p, B, Dh, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_slots(const BcaParams& p, int B, int Dh, int dtype, int slot_dtype,
                           cudaStream_t stream) {
  if (slot_dtype == dtype) return dispatch_tile<T, T>(p, B, Dh, stream);
  if (slot_dtype == kInt8) return dispatch_tile<T, int8_t>(p, B, Dh, stream);
  if (slot_dtype == kFp8E4M3) return dispatch_tile<T, __nv_fp8_e4m3>(p, B, Dh, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// q (B,H,S,Dh); k, v (B,Hkv,S,Dh); kbar, vbar (B,Hkv,M,Dh); out (B,H,S,Dh);
// m, denom: null, or contiguous (B,H,S) fp32 for the residuals.
// start_blocks: null (the training form: M must be (S/c)*r), or a device
// (B,) int32 of per-row absolute start blocks (the prefix form, any M).
// dtype: q, k, v and out; slot_dtype: kbar and vbar, either dtype or a
// quantized storage (int8, fp8 e4m3) whose (B,Hkv,M) fp32 scales are
// kbar_scale / vbar_scale (null for dense slots).
// strides: 15 element strides (batch, head, seq) of q, k and v (shared),
// kbar and vbar (shared), out, and the two scales (shared; unused when
// null). Returns the launch's cudaError_t.
extern "C" int bca_forward(const void* q, const void* k, const void* v, const void* kbar,
                           const void* vbar, void* out, float* m, float* denom,
                           const int* start_blocks, const float* kbar_scale,
                           const float* vbar_scale, const long long* strides, int B, int H,
                           int Hkv, int S, int M, int Dh, int block_size, int block_slots,
                           float scale, int dtype, int slot_dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || block_size <= 0 || S % block_size != 0 ||
      M < 0 || (start_blocks == nullptr && M != (S / block_size) * block_slots))
    return cudaErrorInvalidValue;
  if ((m == nullptr) != (denom == nullptr) ||
      (kbar_scale == nullptr) != (vbar_scale == nullptr) ||
      (kbar_scale == nullptr) != (slot_dtype == dtype))
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
  p.start_blocks = start_blocks;
  p.kbar_scale = kbar_scale;
  p.vbar_scale = vbar_scale;
  p.sq = {strides[0], strides[1], strides[2]};
  p.skv = {strides[3], strides[4], strides[5]};
  p.sslot = {strides[6], strides[7], strides[8]};
  p.so = {strides[9], strides[10], strides[11]};
  p.sscale = {strides[12], strides[13], strides[14]};
  p.H = H;
  p.Hkv = Hkv;
  p.S = S;
  p.M = M;
  p.block_size = block_size;
  p.block_slots = block_slots;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_slots<float>(p, B, Dh, dtype, slot_dtype, s);
  if (dtype == kBFloat16) return dispatch_slots<__nv_bfloat16>(p, B, Dh, dtype, slot_dtype, s);
  return cudaErrorInvalidValue;
}
