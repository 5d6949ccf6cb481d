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
// summed inside one block, never through a repeated copy. No atomics: two
// launches give the same bits; no host sync, so a launch can be captured in
// a CUDA graph; the scratch buffers (delta, the slot partials) come from the
// wrapper.
//
// What bounds it on an H100. About 10*Dh flops per visible (row, key) pair
// (five products) against one read of q, k, v, the slots, dO and the
// residuals and one write of the five gradients: at the training shapes
// (B = 2, H = 32, Hkv = 8, S = 4096, c = 256, r = 16, Dh = 128) ~0.3 GB,
// 0.09 ms at 3.35 TB/s, and ~83 GFLOP, 0.08 ms at 989 TFLOP/s: balanced,
// so both the bytes and the tensor cores' rate bound it.
//
// Two routes, chosen by dtype:
//
// bf16 (the training dtype): tensor cores (mma.sync m16n8k16, fp32
// accumulators, ldmatrix, cp.async; csrc/mma_bf16.cuh), three launches:
//   (a) bca_bwd_dq_mma_kernel: a block owns 64 query rows of one (b, h), 16
//       a warp (each warp's rows lie in one attention block, since c is a
//       multiple of 16); q and dO stay in shared memory, 64-key tiles of
//       k and v stream through two cp.async buffers, the slot tiles up to
//       the last row's cut and then the own block's keys, exactly the
//       forward's walk, twice: the first pass computes s = q k^T and
//       dp = dO v^T and sums delta = rowsum(dP * P) in registers (written
//       for (b)); the second recomputes both, forms dS in the C fragments
//       and accumulates dq = dS K with K by ldmatrix.trans. Query tiles go
//       heaviest (last) first.
//   (b) bca_bwd_dkdv_mma_kernel, FlashAttention-2's layout: a block owns a
//       tile of 64 keys or slots of one (b, kv head), 16 a warp, in shared
//       memory, and walks its rows in steps of 32 (q, dO, m, denom and
//       delta through two cp.async buffers) for each of the G query heads.
//       Each warp computes s^T = K Q^T and dp^T = V dO^T (Q, dO as B
//       operands by plain ldmatrix); P^T and dS^T come out of the C
//       fragments already in the A layout of dv = P^T dO and dk = dS^T Q (dO,
//       Q by ldmatrix.trans); dk and dv stay in registers (2 * Dh / 8 * 4
//       fp32 a thread). A local key tile sees at most its block's rows; a
//       slot tile sees every later block's rows, up to G*S, so each slot
//       tile's rows are cut into splits of kSplitRows (common.py
//       bca_bwd_slot_rows mirrors the schedule), each split a block that
//       writes fp32 partials; slot splits go first in the grid, then the
//       local tiles, heaviest first.
//   (c) bca_bwd_reduce_kernel sums the partials of the splits that hold
//       rows, in split order, into dk-bar / dv-bar: a slot no row sees gets
//       exact zeros.
// s and dp multiply bf16 inputs exactly (fp32 accumulation; only the order
// of the sums differs from the plain twin). The other three products take
// fp32 P or dS, as the TPU kernel does: each is carried as two bf16 terms,
// hi = bf16(x) and lo = bf16(x - hi) (error <= 2^-17 |x|), and multiplied
// twice into the same accumulator, so the gradients keep the fp32 bounds
// (24*Dh flops a visible pair in all: s and dp three times, the split
// products twice). delta is JAX's rowsum(dP * P), not FlashAttention's
// rowsum(dO * O): the wrapper has no O, and a bf16 O would cost the bound.
//
// fp32 (the card's parity path; tensor cores would round to TF32): the
// first SIMT design, two kernels on one stream:
//   bca_bwd_dq_kernel, one block per (b*H + h, query tile of BQ rows): a
//       first pass over the row's visible tiles (slots, then the own block up
//       to the tile's last row, as in the forward) computes delta and writes
//       it; a second pass computes dS and accumulates dq in registers;
//   bca_bwd_dkdv_kernel, one block per (b*Hkv + kv head, key tile or slot
//       tile of TK rows): it keeps its key and value tile in shared memory
//       and loops over every contributing (group member, query tile) - for
//       a local key tile of block n, query block n's rows at or after the
//       tile's first key; for a slot tile whose first slot belongs to block
//       j, every row of blocks n >= j - start_blocks[b] + 1 - reading delta
//       from the first kernel, and writes dk / dv once in fp32. Slot tiles
//       take the lowest block indices so they are scheduled first. A slot no
//       row sees gets exact zeros.
// Scores are recomputed in the forward's order (fp32 FMA over d), so p
// reproduces the forward's probabilities.
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;             // SIMT: 16 x 16
constexpr int kTileK = 64;                // SIMT dq kernel: keys or slots per tile
constexpr int kSPitch = kTileK + 16;      // SIMT dq kernel: dS tile pitch

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
  float* part;                            // bf16 route: (2, nsplit, B, Hkv, M, Dh)
  Strides sq, skv, sslot, sdo, sdq, sdkv, sdslot;
  int B, H, Hkv, S, M, Dh, block_size, block_slots;
  float scale;
  bool q_vec, kv_vec, slot_vec, do_vec, dq_vec;  // tensor cores: 16-byte copies
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

template <int Dh, int BQ>
cudaError_t launch_simt(const BwdParams& p, cudaStream_t stream) {
  constexpr int P = Dh + 1;
  const size_t smem_dq = sizeof(float) * (2 * BQ * P + 2 * kTileK * P + BQ * kSPitch);
  constexpr int PP = BQ % 32 == 0 ? BQ + 16 : BQ;
  const size_t smem_kv = sizeof(float) * (4 * BQ * P + 2 * BQ * PP + 3 * BQ);
  auto dq_kernel = bca_bwd_dq_kernel<float, Dh, BQ>;
  auto kv_kernel = bca_bwd_dkdv_kernel<float, Dh, BQ>;
  cudaError_t err = allow_smem(dq_kernel, smem_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem(kv_kernel, smem_kv);
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3(p.S / BQ, p.B * p.H), kThreads, smem_dq, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_slot_tiles = (p.M + BQ - 1) / BQ;
  kv_kernel<<<dim3(n_slot_tiles + p.S / BQ, p.B * p.Hkv), kThreads, smem_kv, stream>>>(
      p, n_slot_tiles);
  return cudaGetLastError();
}

template <int BQ>
cudaError_t dispatch_simt_head_dim(const BwdParams& p, cudaStream_t stream) {
  switch (p.Dh) {
    case 16: return launch_simt<16, BQ>(p, stream);
    case 32: return launch_simt<32, BQ>(p, stream);
    case 64: return launch_simt<64, BQ>(p, stream);
    case 128: return launch_simt<128, BQ>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_simt(const BwdParams& p, cudaStream_t stream) {
  if (p.block_size % 64 == 0) return dispatch_simt_head_dim<64>(p, stream);
  if (p.block_size % 16 == 0) return dispatch_simt_head_dim<16>(p, stream);
  return cudaErrorInvalidValue;
}

// -- bf16: tensor cores -------------------------------------------------------

namespace tcb {
constexpr int kWarps = 4;                   // warps a block, all three kernels
constexpr int kThreads = 32 * kWarps;
constexpr int kTileK = 16 * kWarps;         // dk/dv kernel: keys or slots a block, 16 a warp
constexpr int kRowStep = 32;                // dk/dv kernel: query rows a pipeline step
constexpr int kTileQ = 16 * kWarps;         // dq kernel: query rows a block, 16 a warp
constexpr int kTileKey = 64;                // dq kernel: keys or slots a pipeline step
constexpr int kStages = 2;                  // cp.async buffers of both kernels
constexpr int kSplitRows = 512;             // query rows of one split of a slot tile
constexpr int kReduceThreads = 256;

// Dynamic shared memory, bf16 rows of pitch Dh + 8 (no ldmatrix bank
// conflicts). dk/dv kernel: the block's k and v tiles, then per stage a q
// and a dO tile of kRowStep rows and the step's m, denom and delta (fp32).
// dq kernel: the block's q and dO tiles, then per stage a k and a v tile of
// kTileKey rows; dq is staged through stage 0 at the end.
template <int Dh>
struct Layout {
  static constexpr int kPitch = Dh + 8;
  static constexpr int kKVBytes = 2 * kTileK * kPitch * 2;
  static constexpr int kStepBytes = 2 * kRowStep * kPitch * 2 + 3 * kRowStep * 4;
  static constexpr int kDkdvBytes = kKVBytes + kStages * kStepBytes;
  static constexpr int kQBytes = 2 * kTileQ * kPitch * 2;
  static constexpr int kKeyBytes = 2 * kTileKey * kPitch * 2;
  static constexpr int kDqBytes = kQBytes + kStages * kKeyBytes;
};

// The split schedule of the slot tiles (kernels/common.py bca_bwd_slot_rows
// mirrors it): the rows of chunk block n see the slots of absolute blocks
// < n + nb0, so slot tile `tile` is first seen by row first_row(tile), and
// split sp of its rows is [max(sp * kSplitRows, first_row), min((sp + 1) *
// kSplitRows, S)), empty when that is.
__host__ __device__ inline int nsplit(int S) { return (S + kSplitRows - 1) / kSplitRows; }
__host__ __device__ inline int first_row(int slot, int S, int c, int r, int nb0) {
  const int n = slot / r - nb0 + 1;     // the first chunk block that sees `slot`
  if (n <= 0) return 0;
  return static_cast<long long>(n) * c < S ? n * c : S;
}
__host__ __device__ inline void split_rows(int tile, int sp, int S, int c, int r, int nb0,
                                           int& lo, int& hi) {
  const int first = first_row(tile * kTileK, S, c, r, nb0);
  lo = sp * kSplitRows > first ? sp * kSplitRows : first;
  hi = (sp + 1) * kSplitRows < S ? (sp + 1) * kSplitRows : S;
}
}  // namespace tcb

// fp32 x0, x1 as two bf16x2 terms: hi = bf16(x), lo = bf16(x - hi); hi + lo
// is within 2^-17 |x| of x, so two products with the same bf16 operand keep
// an fp32 operand's precision.
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = mma::pack_bf16x2(x0, x1);
  lo = mma::pack_bf16x2(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

// acc[n-tile] (16 x 8 each, ND of them) += A · B for a warp's 16 x Dh A and
// the k-step's B rows at `src` (16 rows of pitch P, read transposed: rows are
// the k dimension), A given as hi and lo terms.
template <int ND, int P>
__device__ __forceinline__ void mma_split_trans(float (&acc)[ND][4], const uint32_t (&hi)[4],
                                                const uint32_t (&lo)[4],
                                                const __nv_bfloat16* src, int lane) {
#pragma unroll
  for (int dp = 0; dp < ND / 2; ++dp) {
    uint32_t f[4];
    mma::ldmatrix_x4_trans(f, src + (((lane >> 3) & 1) * 8 + (lane & 7)) * P + dp * 16
                                  + (lane >> 4) * 8);
    mma::mma_bf16_16816(acc[2 * dp], hi, f[0], f[1]);
    mma::mma_bf16_16816(acc[2 * dp], lo, f[0], f[1]);
    mma::mma_bf16_16816(acc[2 * dp + 1], hi, f[2], f[3]);
    mma::mma_bf16_16816(acc[2 * dp + 1], lo, f[2], f[3]);
  }
}

// c[n-tile] (NC of them, 16 x 8 each) = A B^T for the 16 A rows at `a` and
// the NC * 8 B rows at `b` (both pitch P, Dh columns): A by ldmatrix, B by
// plain ldmatrix (its rows are the n dimension).
template <int NC, int Dh, int P>
__device__ __forceinline__ void mma_abt(float (&c)[NC][4], const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, int lane) {
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < Dh / 16; ++kd) {
    uint32_t af[4];
    mma::ldmatrix_x4(af, a + (lane & 15) * P + kd * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NC / 2; ++np) {
      uint32_t bf[4];
      mma::ldmatrix_x4(bf, b + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * P + kd * 16
                               + ((lane >> 3) & 1) * 8);
      mma::mma_bf16_16816(c[2 * np], af, bf[0], bf[1]);
      mma::mma_bf16_16816(c[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// (a) dq and delta for 64 query rows of one (b, h); see the note at the top.
template <int Dh>
__global__ void __launch_bounds__(tcb::kThreads, 2) bca_bwd_dq_mma_kernel(BwdParams p) {
  using L = tcb::Layout<Dh>;
  using bf16 = __nv_bfloat16;
  constexpr int kThreads = tcb::kThreads, kStages = tcb::kStages;
  constexpr int TK = tcb::kTileKey, TQ = tcb::kTileQ, P = L::kPitch;
  constexpr int NS = TK / 8, ND = Dh / 8;          // score / dq n-tiles
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ uint4 smem_bwd_dq[];
  unsigned char* const base = reinterpret_cast<unsigned char*>(smem_bwd_dq);
  bf16* const sQ = reinterpret_cast<bf16*>(base);  // q tile; the dO tile at + TQ * P
  bf16* const sO = sQ + TQ * P;
  auto stage_kv = [&](int st) {                    // k tile; the v tile at + TK * P
    return reinterpret_cast<bf16*>(base + L::kQBytes + st * L::kKeyBytes);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // block -> (group member, query tile, kv head, row b): the heads of a kv
  // head next to each other (their k, v and slot tiles meet in L2), the
  // heaviest (last) query tile first
  const int G = p.H / p.Hkv;
  const int nq = (p.S + TQ - 1) / TQ;
  int id = blockIdx.x;
  const int gi = id % G;
  id /= G;
  const int qt = nq - 1 - id % nq;
  id /= nq;
  const int hk = id % p.Hkv;
  const int b = id / p.Hkv;
  const int h = hk * G + gi;
  const int c = p.block_size;
  const int q0 = qt * TQ;
  const int q_end = min(q0 + TQ, p.S);
  const int nb0 = p.start_blocks == nullptr ? 0 : p.start_blocks[b];
  const int nsl_blk = min((nb0 + (q_end - 1) / c) * p.block_slots, p.M);
  const int k_beg = (q0 / c) * c;
  const int nst = (nsl_blk + TK - 1) / TK;
  const int n_items = nst + (q_end - k_beg + TK - 1) / TK;
  // this warp's 16 rows r0 .. r0 + 15 lie in one attention block (or past S)
  const int r0 = q0 + 16 * warp;
  const bool active = r0 < p.S;
  const int kb_w = (r0 / c) * c;
  const int nsl_w = min((nb0 + r0 / c) * p.block_slots, p.M);

  const bf16* Q = static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h;
  const bf16* DO = static_cast<const bf16*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  const bf16* K = static_cast<const bf16*>(p.k) + b * p.skv.b + hk * p.skv.h;
  const bf16* V = static_cast<const bf16*>(p.v) + b * p.skv.b + hk * p.skv.h;
  const bf16* KB = static_cast<const bf16*>(p.kbar) + b * p.sslot.b + hk * p.sslot.h;
  const bf16* VB = static_cast<const bf16*>(p.vbar) + b * p.sslot.b + hk * p.sslot.h;
  bf16* DQ = static_cast<bf16*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
  const long long rows = (static_cast<long long>(b) * p.H + h) * p.S;

  // step w < 2 * n_items: pass w / n_items over item w % n_items (item i <
  // nst: slot tile i; else own-block key tile i - nst). One cp.async group a
  // call (empty past the last step).
  auto issue = [&](int w) {
    if (w < 2 * n_items) {
      if (w == 0) {
        mma::load_tile<kThreads, TQ, Dh, P>(sQ, Q + q0 * p.sq.s, p.sq.s, q_end - q0, Dh, p.q_vec);
        mma::load_tile<kThreads, TQ, Dh, P>(sO, DO + q0 * p.sdo.s, p.sdo.s, q_end - q0, Dh,
                                            p.do_vec);
      }
      const int i = w % n_items;
      bf16* skv = stage_kv(w % kStages);
      if (i < nst) {
        const int j0 = i * TK, valid = min(TK, nsl_blk - j0);
        mma::load_tile<kThreads, TK, Dh, P>(skv, KB + j0 * p.sslot.s, p.sslot.s, valid, Dh,
                                            p.slot_vec);
        mma::load_tile<kThreads, TK, Dh, P>(skv + TK * P, VB + j0 * p.sslot.s, p.sslot.s, valid,
                                            Dh, p.slot_vec);
      } else {
        const int j0 = k_beg + (i - nst) * TK, valid = min(TK, q_end - j0);
        mma::load_tile<kThreads, TK, Dh, P>(skv, K + j0 * p.skv.s, p.skv.s, valid, Dh, p.kv_vec);
        mma::load_tile<kThreads, TK, Dh, P>(skv + TK * P, V + j0 * p.skv.s, p.skv.s, valid, Dh,
                                            p.kv_vec);
      }
    }
    mma::cp_async_commit();
  };

  // rows g and g + 8 of the warp: max in log2 units, 1 / denom, delta
  float m2[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  if (active) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      m2[rr] = p.m[rows + r0 + g + 8 * rr] * kLog2e;
      inv[rr] = 1.f / p.denom[rows + r0 + g + 8 * rr];
    }
  }
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const float sl2 = p.scale * kLog2e;

#pragma unroll
  for (int w = 0; w < kStages - 1; ++w) issue(w);
  for (int w = 0; w < 2 * n_items; ++w) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // step w has landed for all; the buffers of step w - 1 are consumed
    issue(w + kStages - 1);
    const int pass = w / n_items, i = w % n_items;
    if (pass == 1 && i == 0) {
      // the first pass is complete: delta of rows g, g + 8 (the quad's sum)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        delta[rr] += __shfl_xor_sync(0xffffffffu, delta[rr], 1);
        delta[rr] += __shfl_xor_sync(0xffffffffu, delta[rr], 2);
        if (active && t == 0) p.delta[rows + r0 + g + 8 * rr] = delta[rr];
      }
    }
    if (!active) continue;
    const bool slot = i < nst;
    int j0, live;
    bool masked;
    if (slot) {
      j0 = i * TK;
      if (j0 >= nsl_w) continue;
      live = nsl_w - j0;
      masked = live < TK;
    } else {
      j0 = k_beg + (i - nst) * TK;
      if (j0 + TK <= kb_w || j0 > r0 + 15) continue;
      live = r0 + 16 - j0;
      masked = j0 < kb_w || live <= TK;
    }
    const bf16* sk = stage_kv(w % kStages);
    const bf16* sv = sk + TK * P;
    float s[NS][4], dp[NS][4];
    mma_abt<NS, Dh, P>(s, sQ + 16 * warp * P, sk, lane);
    mma_abt<NS, Dh, P>(dp, sO + 16 * warp * P, sv, lane);
    // p = exp(s * scale - m) / denom in base 2; masked entries exactly 0
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1, col = nt * 8 + 2 * t + (e & 1);
        const bool ok = !masked || (slot ? col < live
                                         : j0 + col >= kb_w && j0 + col <= r0 + g + 8 * rr);
        const float prob = mma::exp2_approx(fmaf(s[nt][e], sl2, -m2[rr])) * inv[rr];
        s[nt][e] = ok ? prob : 0.f;
      }
    if (pass == 0) {
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) delta[e >> 1] = fmaf(s[nt][e], dp[nt][e], delta[e >> 1]);
      continue;
    }
    // dS = P (dP - delta), then dq += dS K: dS from the C fragments as A
    // (hi and lo terms), K by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      float d[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d[half][e] = s[2 * kk + half][e] * (dp[2 * kk + half][e] - delta[e >> 1]);
      uint32_t hi[4], lo[4];
      split_bf16x2(d[0][0], d[0][1], hi[0], lo[0]);
      split_bf16x2(d[0][2], d[0][3], hi[1], lo[1]);
      split_bf16x2(d[1][0], d[1][1], hi[2], lo[2]);
      split_bf16x2(d[1][2], d[1][3], hi[3], lo[3]);
      mma_split_trans<ND, P>(acc, hi, lo, sk + kk * 16 * P, lane);
    }
  }

  // dq * scale as bf16, staged in the warp's own rows of stage 0 (no copy is
  // in flight), stored in 16-byte pieces
  mma::cp_async_wait<0>();
  __syncthreads();
  if (!active) return;
  bf16* so = stage_kv(0) + warp * 16 * P;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    *reinterpret_cast<uint32_t*>(so + g * P + nd * 8 + 2 * t) =
        mma::pack_bf16x2(acc[nd][0] * p.scale, acc[nd][1] * p.scale);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * P + nd * 8 + 2 * t) =
        mma::pack_bf16x2(acc[nd][2] * p.scale, acc[nd][3] * p.scale);
  }
  __syncwarp();
  const int n_rows = min(16, p.S - r0);
  for (int idx = lane; idx < n_rows * ND; idx += 32) {
    const int rr = idx / ND, cc = (idx % ND) * 8;
    bf16* dst = DQ + (r0 + rr) * p.sdq.s + cc;
    const bf16* src = so + rr * P + cc;
    if (p.dq_vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = src[e];
    }
  }
}

// (b) dk / dv of one tile of 64 keys or slots of one (b, kv head), over one
// split of a slot tile's rows; see the note at the top.
template <int Dh>
__global__ void __launch_bounds__(tcb::kThreads, 2) bca_bwd_dkdv_mma_kernel(BwdParams p) {
  using L = tcb::Layout<Dh>;
  using bf16 = __nv_bfloat16;
  constexpr int kThreads = tcb::kThreads, kStages = tcb::kStages;
  constexpr int TK = tcb::kTileK, RS = tcb::kRowStep, P = L::kPitch;
  constexpr int NR = RS / 8, ND = Dh / 8;          // s^T / dk n-tiles
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ uint4 smem_bwd_dkdv[];
  unsigned char* const base = reinterpret_cast<unsigned char*>(smem_bwd_dkdv);
  bf16* const sK = reinterpret_cast<bf16*>(base);  // the block's k tile; v at + TK * P
  bf16* const sV = sK + TK * P;
  auto stage_q = [&](int st) {                     // q rows; the dO rows at + RS * P
    return reinterpret_cast<bf16*>(base + L::kKVBytes + st * L::kStepBytes);
  };
  auto stage_rows = [&](int st) {                  // m, denom, delta: RS each
    return reinterpret_cast<float*>(base + L::kKVBytes + st * L::kStepBytes + 2 * RS * P * 2);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int G = p.H / p.Hkv, c = p.block_size, r = p.block_slots;
  // block -> (item, row b and kv head), every (b, kv head) of an item
  // together; items: the slot splits (last split first), then the local key
  // tiles (with c a multiple of 64, each block's first tile first)
  const int bkv = blockIdx.x % (p.B * p.Hkv);
  const int item = blockIdx.x / (p.B * p.Hkv);
  const int b = bkv / p.Hkv, hk = bkv % p.Hkv;
  const int nb0 = p.start_blocks == nullptr ? 0 : p.start_blocks[b];
  const int n_slot_tiles = (p.M + TK - 1) / TK;
  const int nsp = tcb::nsplit(p.S);
  const bool slot = item < n_slot_tiles * nsp;
  int key0, valid, lo, hi, sp = 0;
  if (slot) {
    sp = nsp - 1 - item / n_slot_tiles;
    const int tile = item % n_slot_tiles;
    key0 = tile * TK;
    valid = min(TK, p.M - key0);
    tcb::split_rows(tile, sp, p.S, c, r, nb0, lo, hi);
    if (lo >= hi) return;                           // no row of this split sees the tile
  } else {
    const int li = item - n_slot_tiles * nsp;
    if (c % TK == 0) {
      const int nb = p.S / c;
      key0 = (li % nb) * c + (li / nb) * TK;
    } else {
      key0 = li * TK;
    }
    valid = min(TK, p.S - key0);
    lo = key0;                                      // rows before the first key see none
    hi = min(p.S, ((key0 + valid - 1) / c + 1) * c);  // the last key's own block
  }
  // this warp's 16 keys or slots k0 .. k0 + 15 (one attention block each):
  // rows [w_lo, w_hi) may see some of them, rows from w_full see all
  const int k0 = key0 + 16 * warp;
  const bool wact = 16 * warp < valid;
  int w_lo, w_hi, w_full;
  if (slot) {
    w_lo = max(lo, tcb::first_row(k0, p.S, c, r, nb0));
    w_hi = hi;
    w_full = 16 * warp + 16 <= valid ? max(lo, tcb::first_row(k0 + 15, p.S, c, r, nb0))
                                     : INT_MAX;
  } else {
    w_lo = max(lo, k0);
    w_hi = min(hi, (k0 / c + 1) * c);
    w_full = k0 + 15;
  }

  const bf16* Ksrc;
  const bf16* Vsrc;
  long long ks;
  bool kvec;
  if (slot) {
    Ksrc = static_cast<const bf16*>(p.kbar) + b * p.sslot.b + hk * p.sslot.h;
    Vsrc = static_cast<const bf16*>(p.vbar) + b * p.sslot.b + hk * p.sslot.h;
    ks = p.sslot.s;
    kvec = p.slot_vec;
  } else {
    Ksrc = static_cast<const bf16*>(p.k) + b * p.skv.b + hk * p.skv.h;
    Vsrc = static_cast<const bf16*>(p.v) + b * p.skv.b + hk * p.skv.h;
    ks = p.skv.s;
    kvec = p.kv_vec;
  }

  // step w < items: group member w / n_steps, rows lo + (w % n_steps) * RS.
  // One cp.async group a call (empty past the last step); rows at or past hi
  // load as zeros (m 0, denom 1, delta 0).
  const int n_steps = (hi - lo + RS - 1) / RS;
  const int items = G * n_steps;
  auto issue = [&](int w) {
    if (w < items) {
      if (w == 0) {
        mma::load_tile<kThreads, TK, Dh, P>(sK, Ksrc + key0 * ks, ks, valid, Dh, kvec);
        mma::load_tile<kThreads, TK, Dh, P>(sV, Vsrc + key0 * ks, ks, valid, Dh, kvec);
      }
      const int st = w % kStages, h = hk * G + w / n_steps;
      const int r0 = lo + (w % n_steps) * RS, vr = min(RS, hi - r0);
      bf16* sq = stage_q(st);
      mma::load_tile<kThreads, RS, Dh, P>(
          sq, static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h + r0 * p.sq.s, p.sq.s, vr,
          Dh, p.q_vec);
      mma::load_tile<kThreads, RS, Dh, P>(
          sq + RS * P, static_cast<const bf16*>(p.dout) + b * p.sdo.b + h * p.sdo.h + r0 * p.sdo.s,
          p.sdo.s, vr, Dh, p.do_vec);
      float* sr = stage_rows(st);
      const long long at = (static_cast<long long>(b) * p.H + h) * p.S + r0;
      for (int i = threadIdx.x; i < 3 * RS; i += kThreads) {
        const int j = i % RS, which = i / RS;
        if (j < vr)
          mma::cp_async_4(sr + i, (which == 0 ? p.m : which == 1 ? p.denom : p.delta) + at + j);
        else
          sr[i] = which == 1 ? 1.f : 0.f;
      }
    }
    mma::cp_async_commit();
  };

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  const float sl2 = p.scale * kLog2e;

#pragma unroll
  for (int w = 0; w < kStages - 1; ++w) issue(w);
  for (int w = 0; w < items; ++w) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // step w has landed for all; the buffers of step w - 1 are consumed
    issue(w + kStages - 1);
    const int r0 = lo + (w % n_steps) * RS;
    if (!wact || r0 >= w_hi || r0 + RS <= w_lo) continue;
    const bool masked = r0 < w_full || r0 + RS > w_hi;
    const int st = w % kStages;
    const bf16* sq = stage_q(st);
    const bf16* so = sq + RS * P;
    const float* sr = stage_rows(st);

    // s^T = K Q^T (16 keys x RS rows), then P^T, masked entries exactly 0
    float pt[NR][4];
    mma_abt<NR, Dh, P>(pt, sK + 16 * warp * P, sq, lane);
#pragma unroll
    for (int nt = 0; nt < NR; ++nt) {
      const int col = nt * 8 + 2 * t;              // this thread's rows col, col + 1
      const float2 mm = *reinterpret_cast<const float2*>(sr + col);
      const float2 dd = *reinterpret_cast<const float2*>(sr + RS + col);
      const float m2[2] = {mm.x * kLog2e, mm.y * kLog2e};
      const float inv[2] = {1.f / dd.x, 1.f / dd.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + col + (e & 1), key = k0 + g + 8 * (e >> 1);
        const bool ok = !masked || (row < w_hi && (slot ? key - key0 < valid &&
                                                             key / r < row / c + nb0
                                                        : key <= row));
        const float prob = mma::exp2_approx(fmaf(pt[nt][e], sl2, -m2[e & 1])) * inv[e & 1];
        pt[nt][e] = ok ? prob : 0.f;
      }
    }
    // dv += P^T dO: A from the C fragments (rows 16 kk .. 16 kk + 15 of the
    // step), dO by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < RS / 16; ++kk) {
      uint32_t hi_[4], lo_[4];
      split_bf16x2(pt[2 * kk][0], pt[2 * kk][1], hi_[0], lo_[0]);
      split_bf16x2(pt[2 * kk][2], pt[2 * kk][3], hi_[1], lo_[1]);
      split_bf16x2(pt[2 * kk + 1][0], pt[2 * kk + 1][1], hi_[2], lo_[2]);
      split_bf16x2(pt[2 * kk + 1][2], pt[2 * kk + 1][3], hi_[3], lo_[3]);
      mma_split_trans<ND, P>(dv, hi_, lo_, so + kk * 16 * P, lane);
    }
    // dp^T = V dO^T, dS^T = P^T (dp^T - delta), dk += dS^T Q
    float dpt[NR][4];
    mma_abt<NR, Dh, P>(dpt, sV + 16 * warp * P, so, lane);
#pragma unroll
    for (int nt = 0; nt < NR; ++nt) {
      const float2 dl = *reinterpret_cast<const float2*>(sr + 2 * RS + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[nt][e] = pt[nt][e] * (dpt[nt][e] - (e & 1 ? dl.y : dl.x));
    }
#pragma unroll
    for (int kk = 0; kk < RS / 16; ++kk) {
      uint32_t hi_[4], lo_[4];
      split_bf16x2(dpt[2 * kk][0], dpt[2 * kk][1], hi_[0], lo_[0]);
      split_bf16x2(dpt[2 * kk][2], dpt[2 * kk][3], hi_[1], lo_[1]);
      split_bf16x2(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1], hi_[2], lo_[2]);
      split_bf16x2(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3], hi_[3], lo_[3]);
      mma_split_trans<ND, P>(dk, hi_, lo_, sq + kk * 16 * P, lane);
    }
  }
  mma::cp_async_wait<0>();
  if (!wact) return;

  // keys g and g + 8 of the warp, 2 columns an n-tile: local keys straight
  // into dk_loc / dv_loc, slots into this split's partials
  float* DK;
  float* DV;
  long long os;
  if (slot) {
    const long long plane = static_cast<long long>(p.B) * p.Hkv * p.M * Dh;
    DK = p.part + sp * plane + (static_cast<long long>(bkv) * p.M) * Dh;
    DV = DK + nsp * plane;
    os = Dh;
  } else {
    DK = p.dk + b * p.sdkv.b + hk * p.sdkv.h;
    DV = p.dv + b * p.sdkv.b + hk * p.sdkv.h;
    os = p.sdkv.s;
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int kk = 16 * warp + g + 8 * rr;
    if (kk >= valid) continue;
    float* dkr = DK + (key0 + kk) * os;
    float* dvr = DV + (key0 + kk) * os;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      *reinterpret_cast<float2*>(dkr + nd * 8 + 2 * t) =
          make_float2(dk[nd][2 * rr] * p.scale, dk[nd][2 * rr + 1] * p.scale);
      *reinterpret_cast<float2*>(dvr + nd * 8 + 2 * t) =
          make_float2(dv[nd][2 * rr], dv[nd][2 * rr + 1]);
    }
  }
}

// (c) dk-bar / dv-bar: the partials of the splits that hold rows, summed in
// split order; exact zeros where none does.
__global__ void __launch_bounds__(tcb::kReduceThreads) bca_bwd_reduce_kernel(BwdParams p) {
  const long long idx = static_cast<long long>(blockIdx.x) * tcb::kReduceThreads + threadIdx.x;
  const long long per = static_cast<long long>(p.M) * p.Dh;
  if (idx >= p.B * p.Hkv * per) return;
  const int bkv = static_cast<int>(idx / per);
  const int m = static_cast<int>(idx % per / p.Dh), d = static_cast<int>(idx % p.Dh);
  const int b = bkv / p.Hkv, hk = bkv % p.Hkv;
  const int nb0 = p.start_blocks == nullptr ? 0 : p.start_blocks[b];
  const int nsp = tcb::nsplit(p.S);
  const long long plane = p.B * p.Hkv * per;
  float sk = 0.f, sv = 0.f;
  for (int sp = 0; sp < nsp; ++sp) {
    int lo, hi;
    tcb::split_rows(m / tcb::kTileK, sp, p.S, p.block_size, p.block_slots, nb0, lo, hi);
    if (lo >= hi) continue;
    sk += p.part[sp * plane + idx];
    sv += p.part[(nsp + sp) * plane + idx];
  }
  const long long at = b * p.sdslot.b + hk * p.sdslot.h + m * p.sdslot.s + d;
  p.dkbar[at] = sk;
  p.dvbar[at] = sv;
}

template <int Dh>
cudaError_t launch_mma(const BwdParams& p, cudaStream_t stream) {
  using L = tcb::Layout<Dh>;
  auto dq_kernel = bca_bwd_dq_mma_kernel<Dh>;
  auto kv_kernel = bca_bwd_dkdv_mma_kernel<Dh>;
  cudaError_t err = allow_smem(dq_kernel, L::kDqBytes);
  if (err != cudaSuccess) return err;
  err = allow_smem(kv_kernel, L::kDkdvBytes);
  if (err != cudaSuccess) return err;
  const long long nq = (p.S + tcb::kTileQ - 1) / tcb::kTileQ;
  const long long dq_blocks = static_cast<long long>(p.B) * p.H * nq;
  const long long kv_items = static_cast<long long>((p.M + tcb::kTileK - 1) / tcb::kTileK) *
                                 tcb::nsplit(p.S) +
                             (p.S + tcb::kTileK - 1) / tcb::kTileK;
  const long long kv_blocks = kv_items * p.B * p.Hkv;
  const long long red_blocks =
      (static_cast<long long>(p.B) * p.Hkv * p.M * Dh + tcb::kReduceThreads - 1) /
      tcb::kReduceThreads;
  if (dq_blocks > INT_MAX || kv_blocks > INT_MAX || red_blocks > INT_MAX)
    return cudaErrorInvalidValue;
  dq_kernel<<<static_cast<unsigned>(dq_blocks), tcb::kThreads, L::kDqBytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kv_kernel<<<static_cast<unsigned>(kv_blocks), tcb::kThreads, L::kDkdvBytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bca_bwd_reduce_kernel<<<static_cast<unsigned>(red_blocks), tcb::kReduceThreads, 0, stream>>>(
      p);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const BwdParams& p, cudaStream_t stream) {
  if (p.block_size % 16 != 0) return cudaErrorInvalidValue;
  switch (p.Dh) {
    case 16: return launch_mma<16>(p, stream);
    case 32: return launch_mma<32>(p, stream);
    case 64: return launch_mma<64>(p, stream);
    case 128: return launch_mma<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The route the last bca_backward call launched (bca_backward_route):
// kRouteSimt, kRouteMma, or -1 before the first launch.
constexpr int kRouteSimt = 0;
constexpr int kRouteMma = 1;
int last_route = -1;

}  // namespace
}  // namespace repro_torch

// q, dout (B,H,S,Dh); k, v (B,Hkv,S,Dh); kbar, vbar (B,Hkv,M,Dh) with
// M >= (max start block + S/c)*r; m, denom, delta contiguous (B,H,S) fp32;
// start_blocks (B,) int32 or null; dq (B,H,S,Dh) in q's dtype; dk, dv
// (B,Hkv,S,Dh) and dkbar, dvbar (B,Hkv,M,Dh) fp32; part: for bf16 a
// contiguous fp32 scratch of 2 * ceil(S / 512) * B * Hkv * M * Dh (the slot
// splits' partials; kernels/common.py bca_bwd_partials_shape), unused (may be
// null) for fp32.
// strides: 21 element strides (batch, head, seq) of q, k and v (shared),
// kbar and vbar (shared), dout, dq, dk and dv (shared), dkbar and dvbar
// (shared). fp32 launches the SIMT dq and dk/dv kernels, bf16 the
// tensor-core dq, dk/dv and reduction kernels, on `stream`; returns the
// first launch error.
extern "C" int bca_backward(const void* q, const void* k, const void* v, const void* kbar,
                            const void* vbar, const void* dout, const float* m,
                            const float* denom, const int* start_blocks, void* dq,
                            float* delta, float* dk, float* dv, float* dkbar, float* dvbar,
                            float* part, const long long* strides, int B, int H, int Hkv,
                            int S, int M, int Dh, int block_size, int block_slots, float scale,
                            int dtype, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || block_size <= 0 || S % block_size != 0 ||
      block_slots <= 0 || M < (S / block_size) * block_slots ||
      (dtype == kBFloat16 && part == nullptr))
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
  p.part = part;
  Strides* all[] = {&p.sq, &p.skv, &p.sslot, &p.sdo, &p.sdq, &p.sdkv, &p.sdslot};
  for (int i = 0; i < 7; ++i) *all[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.S = S;
  p.M = M;
  p.Dh = Dh;
  p.block_size = block_size;
  p.block_slots = block_slots;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    last_route = kRouteSimt;
    return dispatch_simt(p, s);
  }
  if (dtype != kBFloat16) return cudaErrorInvalidValue;
  p.q_vec = mma::aligned16(q, p.sq.b, p.sq.h, p.sq.s);
  p.kv_vec = mma::aligned16(k, p.skv.b, p.skv.h, p.skv.s) && mma::aligned16(v);
  p.slot_vec = mma::aligned16(kbar, p.sslot.b, p.sslot.h, p.sslot.s) && mma::aligned16(vbar);
  p.do_vec = mma::aligned16(dout, p.sdo.b, p.sdo.h, p.sdo.s);
  p.dq_vec = mma::aligned16(dq, p.sdq.b, p.sdq.h, p.sdq.s);
  last_route = kRouteMma;
  return dispatch_mma(p, s);
}

// The route the last bca_backward call of this process launched: 0 the SIMT
// kernels, 1 the tensor-core kernels, -1 none yet (a probe for the tests of
// the routes).
extern "C" int bca_backward_route() { return repro_torch::last_route; }
