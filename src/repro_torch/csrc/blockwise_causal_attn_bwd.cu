// Blockwise-causal Linformer attention, backward (CUDA C++ for sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/blockwise_causal_attn.py:
// blockwise_causal_attn_bwd (body _bwd_kernel). From the forward's saved
// per-row residuals (max m and denominator, blockwise_causal_attn.cu) it
// recomputes the joint probabilities p = exp(s - m) / denom over each query
// row's [own block, causal | slots of blocks < n + start_blocks[b]] and
// returns dq (q's dtype), dk_loc / dv_loc (B, Hkv, S, Dh) fp32 and dk-bar /
// dv-bar (B, Hkv, M, Dh) fp32:
//   dv = P^T dO,  dP = dO V^T,  delta = rowsum(dP * P) over the JOINT row,
//   dS = P * (dP - delta),  dq = dS K * scale,  dk = dS^T Q * scale.
// GQA: query head h reads kv head h / G; the G query heads of a group are
// summed inside one block, never through a repeated copy.
//
// What bounds it on an H100. About 10*Dh flops per visible (row, key) pair
// (five products) against one read of q, k, v, the slots, dO and the
// residuals and one write of the five gradients: at the training shapes
// (S = 4096, c = 256, r = 16, Dh = 128) that is ~83 GFLOP against ~0.3 GB,
// so the tensor cores' rate would bound it. This first version computes on
// the fp32 CUDA cores, so in practice it is bound by fp32 FMA issue and by
// the longest dk/dv block (below); tensor cores are the next step.
//
// What the design does about it. The TPU kernel walks a (B*Hkv, nb, G) grid
// in order and sums dk_loc / dv_loc over the G group members, and the slot
// gradients over all nb*G steps, in VMEM scratch carried from one grid step
// to the next. CUDA blocks run concurrently, so the sums are split by owner,
// deterministically and without atomics, into two kernels on one stream:
//   (a) bca_bwd_dq_kernel, one block per (b*H + h, query tile of BQ rows): a
//       first pass over the row's visible tiles (slots, then the own block up
//       to the tile's last row, as in the forward) computes delta and writes
//       it; a second pass computes dS and accumulates dq in registers;
//   (b) bca_bwd_dkdv_kernel, one block per (b*Hkv + kv head, key tile or
//       slot tile of TK rows): it keeps its key and value tile in shared
//       memory and loops over every contributing (group member, query tile)
//       - for a local key tile of block n, query block n's rows at or after
//       the tile's first key; for a slot tile whose first slot belongs to
//       block j, every row of blocks n >= j - start_blocks[b] + 1 - reading
//       delta from (a), and writes dk / dv once in fp32. Slot tiles, whose
//       row ranges are the longest, take the lowest block indices so they are
//       scheduled first. A slot no row sees gets exact zeros.
// Scores are recomputed in the forward's order (fp32 FMA over d), so p
// reproduces the forward's probabilities.
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;             // 16 x 16
constexpr int kTileK = 64;                // dq kernel: keys or slots per tile
constexpr int kSPitch = kTileK + 16;      // dq kernel: dS tile pitch

struct Strides {
  long long b, h, s;                      // elements; the last dim is contiguous
};

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* kbar;
  const void* vbar;
  const void* dout;
  const float* m;                         // (B, H, S) contiguous
  const float* denom;
  const int* start_blocks;                // (B,), or null for all zeros
  void* dq;                               // q's dtype
  float* delta;                           // (B, H, S) contiguous, written by (a)
  float* dk;                              // dk_loc, dv_loc (B, Hkv, S, Dh)
  float* dv;
  float* dkbar;                           // (B, Hkv, M, Dh)
  float* dvbar;
  Strides sq, skv, sslot, sdo, sdq, sdkv, sdslot;
  int H, Hkv, S, M, block_size, block_slots;
  float scale;
};

// s = A B^T and dp = C D^T for a (16*RA) x (16*RB) tile, accumulated over d in
// the forward's order: A, C rows a*16 + ra, B, D rows b*16 + rb (pitch Dh + 1).
template <int Dh, int RA, int RB>
__device__ __forceinline__ void two_products(const float* A, const float* C, const float* Bm,
                                             const float* D, int ra, int rb,
                                             float (&s)[RA][RB], float (&dp)[RA][RB]) {
  constexpr int P = Dh + 1;
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int j = 0; j < RB; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < Dh; ++d) {
    float av[RA], cv[RA], bv[RB], dv[RB];
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      av[i] = A[(ra + 16 * i) * P + d];
      cv[i] = C[(ra + 16 * i) * P + d];
    }
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      bv[j] = Bm[(rb + 16 * j) * P + d];
      dv[j] = D[(rb + 16 * j) * P + d];
    }
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        dp[i][j] = fmaf(cv[i], dv[j], dp[i][j]);
      }
  }
}

// (a) dq and delta for one (b*H + h, query tile of BQ rows).
template <typename T, int Dh, int BQ>
__global__ void __launch_bounds__(kThreads) bca_bwd_dq_kernel(BwdParams p) {
  constexpr int RQ = BQ / 16, RK = kTileK / 16, RD = Dh / 16, P = Dh + 1;
  extern __shared__ float smem[];
  float* sQ = smem;                 // BQ x P
  float* sO = sQ + BQ * P;          // dO: BQ x P
  float* sK = sO + BQ * P;          // kTileK x P
  float* sV = sK + kTileK * P;      // kTileK x P
  float* sS = sV + kTileK * P;      // dS: BQ x kSPitch

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int n = q0 / p.block_size;
  const int nb0 = p.start_blocks != nullptr ? p.start_blocks[b] : 0;

  const T* Q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* K = static_cast<const T*>(p.k) + b * p.skv.b + hk * p.skv.h;
  const T* V = static_cast<const T*>(p.v) + b * p.skv.b + hk * p.skv.h;
  const T* KB = static_cast<const T*>(p.kbar) + b * p.sslot.b + hk * p.sslot.h;
  const T* VB = static_cast<const T*>(p.vbar) + b * p.sslot.b + hk * p.sslot.h;
  const T* DO = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  T* DQ = static_cast<T*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
  const long long rows = static_cast<long long>(bh) * p.S + q0;

  load_rows<kThreads, T, Dh>(sQ, Q + q0 * p.sq.s, p.sq.s, BQ, BQ);
  load_rows<kThreads, T, Dh>(sO, DO + q0 * p.sdo.s, p.sdo.s, BQ, BQ);
  float mr[RQ], dr[RQ], delta[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    mr[i] = p.m[rows + ty + 16 * i];
    dr[i] = p.denom[rows + ty + 16 * i];
    delta[i] = 0.f;
  }

  // the row's visible tiles: slots of blocks < n + nb0, then the own block
  const int nslots = min((n + nb0) * p.block_slots, p.M);
  const int n_slot_tiles = (nslots + kTileK - 1) / kTileK;
  const int loc0 = n * p.block_size, k_end = q0 + BQ;
  const int n_tiles = n_slot_tiles + (k_end - loc0 + kTileK - 1) / kTileK;

  float acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int jd = 0; jd < RD; ++jd) acc[i][jd] = 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    for (int t = 0; t < n_tiles; ++t) {
      const bool slot = t < n_slot_tiles;
      const int j0 = slot ? t * kTileK : loc0 + (t - n_slot_tiles) * kTileK;
      const int valid = min(kTileK, (slot ? nslots : k_end) - j0);
      __syncthreads();  // the previous tile is consumed
      if (slot) {
        load_rows<kThreads, T, Dh>(sK, KB + j0 * p.sslot.s, p.sslot.s, kTileK, valid);
        load_rows<kThreads, T, Dh>(sV, VB + j0 * p.sslot.s, p.sslot.s, kTileK, valid);
      } else {
        load_rows<kThreads, T, Dh>(sK, K + j0 * p.skv.s, p.skv.s, kTileK, valid);
        load_rows<kThreads, T, Dh>(sV, V + j0 * p.skv.s, p.skv.s, kTileK, valid);
      }
      __syncthreads();
      float s[RQ][RK], dp[RQ][RK];
      two_products<Dh, RQ, RK>(sQ, sO, sK, sV, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int row = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          const int col = tx + 16 * j;
          const bool ok = col < valid && (slot || col <= row + q0 - j0);
          const float pr = ok ? expf(s[i][j] * p.scale - mr[i]) / dr[i] : 0.f;
          if (pass == 0)
            delta[i] = fmaf(pr, dp[i][j], delta[i]);
          else
            sS[row * kSPitch + col] = pr * (dp[i][j] - delta[i]);
        }
      }
      if (pass == 0) continue;
      __syncthreads();  // the dS tile is complete
      for (int j = 0; j < valid; ++j) {
        float kv[RD];
#pragma unroll
        for (int jd = 0; jd < RD; ++jd) kv[jd] = sK[j * P + tx + 16 * jd];
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float ds = sS[(ty + 16 * i) * kSPitch + j];
#pragma unroll
          for (int jd = 0; jd < RD; ++jd) acc[i][jd] = fmaf(ds, kv[jd], acc[i][jd]);
        }
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        delta[i] = half_warp_sum(delta[i]);
        if (tx == 0) p.delta[rows + ty + 16 * i] = delta[i];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
#pragma unroll
    for (int jd = 0; jd < RD; ++jd)
      DQ[row * p.sdq.s + tx + 16 * jd] = from_f32<T>(acc[i][jd] * p.scale);
  }
}

// (b) dk / dv for one (b*Hkv + kv head, tile of TK keys or slots). Blocks
// below n_slot_tiles own slot tiles, the rest own local key tiles. Query
// tiles have TK rows too (TK divides the block size).
template <typename T, int Dh, int TK>
__global__ void __launch_bounds__(kThreads) bca_bwd_dkdv_kernel(BwdParams p, int n_slot_tiles) {
  constexpr int BQ = TK, RK = TK / 16, RQ = BQ / 16, RD = Dh / 16, P = Dh + 1;
  constexpr int PP = BQ % 32 == 0 ? BQ + 16 : BQ;  // two rows 16 banks apart
  extern __shared__ float smem[];
  float* sK = smem;                 // TK x P
  float* sV = sK + TK * P;          // TK x P
  float* sQ = sV + TK * P;          // BQ x P
  float* sO = sQ + BQ * P;          // dO: BQ x P
  float* sP = sO + BQ * P;          // P^T: TK x PP
  float* sS = sP + TK * PP;         // dS^T: TK x PP
  float* sM = sS + TK * PP;         // BQ each: m, denom, delta of the rows
  float* sD = sM + BQ;
  float* sL = sD + BQ;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bkv = blockIdx.y;
  const int b = bkv / p.Hkv, hk = bkv % p.Hkv;
  const int G = p.H / p.Hkv;
  const int c = p.block_size, nb = p.S / c;
  const int nb0 = p.start_blocks != nullptr ? p.start_blocks[b] : 0;
  const bool slot = static_cast<int>(blockIdx.x) < n_slot_tiles;

  int key0, valid, row_begin, row_end;
  const T* Ksrc;
  const T* Vsrc;
  long long rs;
  if (slot) {
    key0 = blockIdx.x * TK;
    valid = min(TK, p.M - key0);
    // rows of block nq see the tile's first slot iff key0 / r < nq + nb0
    const int nq0 = max(0, key0 / p.block_slots - nb0 + 1);
    row_begin = min(nq0, nb) * c;
    row_end = p.S;
    Ksrc = static_cast<const T*>(p.kbar) + b * p.sslot.b + hk * p.sslot.h;
    Vsrc = static_cast<const T*>(p.vbar) + b * p.sslot.b + hk * p.sslot.h;
    rs = p.sslot.s;
  } else {
    key0 = (blockIdx.x - n_slot_tiles) * TK;
    valid = TK;
    row_begin = key0;                          // rows before the first key see none
    row_end = (key0 / c + 1) * c;              // the key's own block
    Ksrc = static_cast<const T*>(p.k) + b * p.skv.b + hk * p.skv.h;
    Vsrc = static_cast<const T*>(p.v) + b * p.skv.b + hk * p.skv.h;
    rs = p.skv.s;
  }
  load_rows<kThreads, T, Dh>(sK, Ksrc + key0 * rs, rs, TK, valid);
  load_rows<kThreads, T, Dh>(sV, Vsrc + key0 * rs, rs, TK, valid);

  float dk[RK][RD], dv[RK][RD];
#pragma unroll
  for (int a = 0; a < RK; ++a)
#pragma unroll
    for (int jd = 0; jd < RD; ++jd) dk[a][jd] = dv[a][jd] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* Q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
    const T* DO = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
    const long long rows = static_cast<long long>(b * p.H + h) * p.S;
    for (int r0 = row_begin; r0 < row_end; r0 += BQ) {
      __syncthreads();  // the previous row tile is consumed
      load_rows<kThreads, T, Dh>(sQ, Q + r0 * p.sq.s, p.sq.s, BQ, BQ);
      load_rows<kThreads, T, Dh>(sO, DO + r0 * p.sdo.s, p.sdo.s, BQ, BQ);
      if (threadIdx.x < BQ) {
        sM[threadIdx.x] = p.m[rows + r0 + threadIdx.x];
        sD[threadIdx.x] = p.denom[rows + r0 + threadIdx.x];
        sL[threadIdx.x] = p.delta[rows + r0 + threadIdx.x];
      }
      __syncthreads();
      float s[RK][RQ], dp[RK][RQ];
      two_products<Dh, RK, RQ>(sK, sV, sQ, sO, ty, tx, s, dp);
#pragma unroll
      for (int a = 0; a < RK; ++a) {
        const int kk = ty + 16 * a;
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const int rr = tx + 16 * i, row = r0 + rr, key = key0 + kk;
          const bool ok = kk < valid && (slot ? key / p.block_slots < row / c + nb0 : key <= row);
          const float pr = ok ? expf(s[a][i] * p.scale - sM[rr]) / sD[rr] : 0.f;
          sP[kk * PP + rr] = pr;
          sS[kk * PP + rr] = pr * (dp[a][i] - sL[rr]);
        }
      }
      __syncthreads();  // the P^T and dS^T tiles are complete
      for (int rr = 0; rr < BQ; ++rr) {
        float ov[RD], qv[RD];
#pragma unroll
        for (int jd = 0; jd < RD; ++jd) {
          ov[jd] = sO[rr * P + tx + 16 * jd];
          qv[jd] = sQ[rr * P + tx + 16 * jd];
        }
#pragma unroll
        for (int a = 0; a < RK; ++a) {
          const float pa = sP[(ty + 16 * a) * PP + rr];
          const float sa = sS[(ty + 16 * a) * PP + rr];
#pragma unroll
          for (int jd = 0; jd < RD; ++jd) {
            dv[a][jd] = fmaf(pa, ov[jd], dv[a][jd]);
            dk[a][jd] = fmaf(sa, qv[jd], dk[a][jd]);
          }
        }
      }
    }
  }

  float* DK = slot ? p.dkbar + b * p.sdslot.b + hk * p.sdslot.h
                   : p.dk + b * p.sdkv.b + hk * p.sdkv.h;
  float* DV = slot ? p.dvbar + b * p.sdslot.b + hk * p.sdslot.h
                   : p.dv + b * p.sdkv.b + hk * p.sdkv.h;
  const long long os = slot ? p.sdslot.s : p.sdkv.s;
#pragma unroll
  for (int a = 0; a < RK; ++a) {
    const int kk = ty + 16 * a;
    if (kk >= valid) continue;
#pragma unroll
    for (int jd = 0; jd < RD; ++jd) {
      DK[(key0 + kk) * os + tx + 16 * jd] = dk[a][jd] * p.scale;
      DV[(key0 + kk) * os + tx + 16 * jd] = dv[a][jd];
    }
  }
}

template <typename T, int Dh, int BQ>
cudaError_t launch(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr int P = Dh + 1;
  const size_t smem_dq = sizeof(float) * (2 * BQ * P + 2 * kTileK * P + BQ * kSPitch);
  constexpr int PP = BQ % 32 == 0 ? BQ + 16 : BQ;
  const size_t smem_kv = sizeof(float) * (4 * BQ * P + 2 * BQ * PP + 3 * BQ);
  auto dq_kernel = bca_bwd_dq_kernel<T, Dh, BQ>;
  auto kv_kernel = bca_bwd_dkdv_kernel<T, Dh, BQ>;
  cudaError_t err = allow_smem(dq_kernel, smem_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem(kv_kernel, smem_kv);
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3(p.S / BQ, B * p.H), kThreads, smem_dq, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_slot_tiles = (p.M + BQ - 1) / BQ;
  kv_kernel<<<dim3(n_slot_tiles + p.S / BQ, B * p.Hkv), kThreads, smem_kv, stream>>>(
      p, n_slot_tiles);
  return cudaGetLastError();
}

template <typename T, int BQ>
cudaError_t dispatch_head_dim(const BwdParams& p, int B, int Dh, cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch<T, 16, BQ>(p, B, stream);
    case 32: return launch<T, 32, BQ>(p, B, stream);
    case 64: return launch<T, 64, BQ>(p, B, stream);
    case 128: return launch<T, 128, BQ>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_tile(const BwdParams& p, int B, int Dh, cudaStream_t stream) {
  if (p.block_size % 64 == 0) return dispatch_head_dim<T, 64>(p, B, Dh, stream);
  if (p.block_size % 16 == 0) return dispatch_head_dim<T, 16>(p, B, Dh, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// q, dout (B,H,S,Dh); k, v (B,Hkv,S,Dh); kbar, vbar (B,Hkv,M,Dh) with
// M >= (max start block + S/c)*r; m, denom, delta contiguous (B,H,S) fp32;
// start_blocks (B,) int32 or null; dq (B,H,S,Dh) in q's dtype; dk, dv
// (B,Hkv,S,Dh) and dkbar, dvbar (B,Hkv,M,Dh) fp32.
// strides: 21 element strides (batch, head, seq) of q, k and v (shared),
// kbar and vbar (shared), dout, dq, dk and dv (shared), dkbar and dvbar
// (shared). Launches the dq kernel, then the dk/dv kernel, on `stream`;
// returns the first launch error.
extern "C" int bca_backward(const void* q, const void* k, const void* v, const void* kbar,
                            const void* vbar, const void* dout, const float* m,
                            const float* denom, const int* start_blocks, void* dq,
                            float* delta, float* dk, float* dv, float* dkbar, float* dvbar,
                            const long long* strides, int B, int H, int Hkv, int S, int M,
                            int Dh, int block_size, int block_slots, float scale, int dtype,
                            void* stream) {
  using namespace repro_torch;
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || block_size <= 0 || S % block_size != 0 ||
      block_slots <= 0 || M < (S / block_size) * block_slots)
    return cudaErrorInvalidValue;
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kbar = kbar;
  p.vbar = vbar;
  p.dout = dout;
  p.m = m;
  p.denom = denom;
  p.start_blocks = start_blocks;
  p.dq = dq;
  p.delta = delta;
  p.dk = dk;
  p.dv = dv;
  p.dkbar = dkbar;
  p.dvbar = dvbar;
  Strides* all[] = {&p.sq, &p.skv, &p.sslot, &p.sdo, &p.sdq, &p.sdkv, &p.sdslot};
  for (int i = 0; i < 7; ++i) *all[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
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
