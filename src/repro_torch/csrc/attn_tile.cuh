// The online-softmax tile step shared by the forward attention kernels
// (blockwise_causal_attn.cu, linformer_attn.cu): one shared-memory tile of
// up to kTileK keys or slots against a query tile of BQ rows, 16 x 16
// threads, each with a register block of (BQ/16) x 4 scores and
// (BQ/16) x (Dh/16) fp32 output accumulators. Rows are padded by one float
// in shared memory (pitch Dh + 1), so the inner products are free of bank
// conflicts.
#pragma once

#include "common.cuh"

namespace repro_torch {
namespace attn_tile {

constexpr int kThreads = 256;             // 16 x 16
constexpr int kTileK = 64;                // keys or slots per shared-memory tile
constexpr int kPPitch = kTileK + 16;      // probability tile pitch (no bank conflicts)

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

}  // namespace attn_tile
}  // namespace repro_torch
