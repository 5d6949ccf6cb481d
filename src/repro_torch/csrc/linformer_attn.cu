// Exact (bidirectional) Linformer attention over the compressed keys and
// values, forward (CUDA C++ for sm_90a).
//
// Replaces the TPU kernel linformer_attn of src/repro/kernels/linformer_attn.py
// (body _kernel -> _softmax_attend): out = softmax(q k-barᵀ * scale) v-bar,
// each query row over all K compressed slots, nothing masked. q (B, H, S, Dh);
// k-bar, v-bar (B, Hkv, K, Dh); out (B, H, S, Dh) in q's dtype. GQA: query
// head h reads kv head h / G, never a repeated copy (the TPU wrapper repeats
// k-bar / v-bar to H heads before the call). Scores, the softmax and the
// accumulation are fp32.
//
// What bounds it on an H100: bytes. At the paper's shapes (S = 512, K = 128,
// Dh = 64) it does 4*Dh flops per (row, slot) pair against one read of q,
// k-bar, v-bar and one write of the output: about 100 flops a byte in bf16,
// a third of the tensor cores' ridge, but 50 times the fp32 CUDA cores'.
//
// What the design does about it. The TPU kernel pinned the whole k-bar / v-bar
// of a head in VMEM (K <= 512) and took a one-pass softmax per query block.
// Here a thread block owns (batch*head, query rows); the query tiles of one
// kv head are neighbours in the grid, so k-bar / v-bar come from L2 after
// the first block. Two designs, by dtype:
//
// bf16 (exact_fwd_mma_kernel, the model's dtype): both products run on the
// tensor cores (mma.sync m16n8k16, fp32 accumulators). A block of 4 warps of
// 16 query rows takes two 64-row query tiles in turn (k-bar / v-bar are
// loaded once for 128 rows, the second q tile arrives while the first is
// computed), and at most 128 registers a thread let 4 blocks share an SM.
// The q tiles arrive by 16-byte cp.async copies (pitch Dh + 8 bf16, no
// ldmatrix bank conflicts) and go to registers as A fragments. k-bar and
// v-bar come in slot tiles of 128 (64 at Dh = 128); at K <= 128, Dh <= 64
// (the paper's K = 128, Dh = 64) the head's whole k-bar and v-bar are one
// tile and one load, and the online softmax never rescales. Larger K (up to
// the JAX package's 512) streams the tiles, double-buffered, once for each
// q tile, with an online softmax; shared memory does not grow with K. The
// scores stay in registers: row max and sum by quad shuffles, slots >= K at
// -inf, P = exp(S - m) rounded to bf16 straight into the A fragments of the
// value product (the C layout of two n-tiles is the A layout of one k-step;
// v-bar comes by ldmatrix.trans). The output is divided by the fp32 row sum
// once at the end, staged through the warp's own q rows and stored in
// 16-byte pieces; rows past S are not stored. Nothing else leaves the
// block. Cast point: the TPU kernel rounds the normalised probabilities to
// v-bar's dtype; this kernel rounds the unnormalised exp(S - m) (as
// FlashAttention does) and normalises in fp32: both errors are at most
// 2^-9 * max|v-bar| an output. An operand whose base or row stride is not a
// multiple of 16 bytes is read element by element into the same layout.
//
// fp32 (exact_fwd_kernel, the card's parity path; tensor cores would round
// it to TF32): SIMT. A block owns one tile of 64 query rows and walks
// k-bar / v-bar in 64-slot tiles through shared memory with an online fp32
// softmax (running max and sum per row, normalised once at the end), the tile step of the blockwise-causal kernel
// (attn_tile.cuh) without its causal mask, probabilities in fp32 through
// the value product. A ragged last query tile (S not a multiple of 64)
// loads zeros past the end and stores only the rows that exist.
#include <cstdint>

#include "attn_tile.cuh"
#include "common.cuh"
#include "mma_bf16.cuh"

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
  bool q_vec, kv_vec, o_vec;              // bf16 kernel: rows go by 16-byte copies
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

// -- bf16: tensor cores ------------------------------------------------------

namespace tc {
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileQ = 16 * kWarps;       // query rows per tile, 16 a warp
constexpr int kQTiles = 2;                // query tiles per block

template <int Dh>
struct Tile {
  static constexpr int kTileKV = Dh <= 64 ? 128 : 64;   // slots per shared-memory tile
  static constexpr int kPitch = Dh + 8;
  static constexpr int kQElems = kTileQ * kPitch;        // a q tile
  static constexpr int kKVElems = 2 * kTileKV * kPitch;  // a k-bar and a v-bar tile
};

// Blocks an SM must hold: one slot tile at Dh <= 64 fits 128 registers a
// thread (4 blocks, 16 warps an SM); the online softmax over several tiles
// needs more.
template <int Dh, bool OneTile>
constexpr int min_blocks() {
  return OneTile && Dh <= 64 ? 4 : 2;
}

// dynamic shared memory: two q tiles and one k-bar / v-bar stage (two when
// K spans more than one tile)
template <int Dh>
size_t smem_bytes(int K) {
  using Tl = Tile<Dh>;
  const int stages = K > Tl::kTileKV ? 2 : 1;
  return sizeof(__nv_bfloat16) * (2 * Tl::kQElems + stages * Tl::kKVElems);
}
}  // namespace tc

// OneTile: K fits one slot tile (the paper's K = 128): loaded once for both
// q tiles, a plain softmax per q tile; else the slot tiles stream with an
// online softmax.
template <int Dh, bool OneTile>
__global__ void __launch_bounds__(tc::kThreads, tc::min_blocks<Dh, OneTile>())
    exact_fwd_mma_kernel(ExactParams p) {
  using Tl = tc::Tile<Dh>;
  using bf16 = __nv_bfloat16;
  constexpr int TK = Tl::kTileKV, P = Tl::kPitch;
  constexpr int NS = TK / 8, ND = Dh / 8, KD = Dh / 16;  // score / output n-tiles, q k-steps
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ uint4 smem_exact[];
  bf16* sQ2 = reinterpret_cast<bf16*>(smem_exact);  // two q tiles
  bf16* sKV = sQ2 + 2 * Tl::kQElems;                  // stages x (k-bar tile, v-bar tile)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int ntiles = OneTile ? 1 : (p.K + TK - 1) / TK;
  // one item per (q tile, slot tile); a single slot tile is loaded once and
  // serves both q tiles
  const int items = tc::kQTiles * ntiles;

  const bf16* Q = static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h;
  const bf16* KB = static_cast<const bf16*>(p.kbar) + b * p.skv.b + hk * p.skv.h;
  const bf16* VB = static_cast<const bf16*>(p.vbar) + b * p.skv.b + hk * p.skv.h;
  bf16* O = static_cast<bf16*>(p.out) + b * p.so.b + h * p.so.h;

  auto kv_stage = [&](int w) { return sKV + (OneTile ? 0 : w % 2) * Tl::kKVElems; };
  auto issue = [&](int w) {
    if (w >= items) return;
    const int qt = w / ntiles, j = w % ntiles;
    if (j == 0) {
      const int q0 = (blockIdx.x * tc::kQTiles + qt) * tc::kTileQ;
      mma::load_tile<tc::kThreads, tc::kTileQ, Dh, P>(sQ2 + (qt % 2) * Tl::kQElems,
                                                      Q + q0 * p.sq.s, p.sq.s,
                                                      max(0, min(tc::kTileQ, p.S - q0)), Dh,
                                                      p.q_vec);
    }
    if (!OneTile || w == 0) {
      bf16* sk = kv_stage(w);
      const int valid = min(TK, p.K - j * TK);
      const long long off = static_cast<long long>(j) * TK * p.skv.s;
      mma::load_tile<tc::kThreads, TK, Dh, P>(sk, KB + off, p.skv.s, valid, Dh, p.kv_vec);
      mma::load_tile<tc::kThreads, TK, Dh, P>(sk + TK * P, VB + off, p.skv.s, valid, Dh,
                                              p.kv_vec);
    }
    mma::cp_async_commit();
  };

  uint32_t qf[KD][4];
  float o[ND][4], m[2], l[2];
  const float sl2 = p.scale * kLog2e;

  issue(0);
  for (int w = 0; w < items; ++w) {
    mma::cp_async_wait<0>();
    __syncthreads();  // item w has landed for all; the buffers of item w - 1 are consumed
    issue(w + 1);
    const int qt = w / ntiles, j = w % ntiles;
    bf16* sQ = sQ2 + (qt % 2) * Tl::kQElems;
    if (j == 0) {
      // the warp's 16 q rows as A fragments: matrices (rows +0/+8) x (d +0/+8)
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        mma::ldmatrix_x4(qf[kd], sQ + (warp * 16 + (lane & 15)) * P + kd * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < ND; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = neg_inf();  // rows g and g + 8 of the warp, in log2 units
        l[r] = 0.f;        // this thread's part of the row sums
      }
    }
    const bf16* sk = kv_stage(w);
    const bf16* sv = sk + TK * P;
    const int valid = min(TK, p.K - j * TK);

    // S = q k-barᵀ: B fragments from k-bar rows, matrices (slots +0/+8) x (d +0/+8)
    float s[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int np = 0; np < NS / 2; ++np)
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t kf[4];
        mma::ldmatrix_x4(kf, sk + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * P + kd * 16
                                 + ((lane >> 3) & 1) * 8);
        mma::mma_bf16_16816(s[2 * np], qf[kd], kf[0], kf[1]);
        mma::mma_bf16_16816(s[2 * np + 1], qf[kd], kf[2], kf[3]);
      }

    // softmax in log2 units, online across slot tiles; slots >= valid (only
    // in a ragged last tile) at -inf (weight exactly 0)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= sl2;
    if (valid < TK) {
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (nt * 8 + 2 * t + (e & 1) >= valid) s[nt][e] = neg_inf();
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if (!OneTile) {
        const float alpha = mma::exp2_approx(m[r] - mx[r]);
        l[r] *= alpha;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          o[nd][2 * r] *= alpha;
          o[nd][2 * r + 1] *= alpha;
        }
      }
      m[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = mma::exp2_approx(s[nt][e] - m[e >> 1]);
        l[e >> 1] += s[nt][e];
      }

    // O += P v-bar: P from the score registers, v-bar by ldmatrix.trans,
    // matrices (slots +0/+8) x (d +0/+8)
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint32_t pa[4] = {mma::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                              mma::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                              mma::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              mma::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t vf[4];
        mma::ldmatrix_x4_trans(vf, sv + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * P
                                       + dp * 16 + (lane >> 4) * 8);
        mma::mma_bf16_16816(o[2 * dp], pa, vf[0], vf[1]);
        mma::mma_bf16_16816(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    if (j + 1 < ntiles) continue;

    // the q tile is done: normalise by the row sums, stage the warp's 16
    // rows in its own rows of the q tile (q lives in registers), store
    // 16-byte pieces of the rows below S
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / l[r];
    }
    bf16* so = sQ + warp * 16 * P;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      *reinterpret_cast<uint32_t*>(so + g * P + nd * 8 + 2 * t) =
          mma::pack_bf16x2(o[nd][0] * inv[0], o[nd][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(so + (g + 8) * P + nd * 8 + 2 * t) =
          mma::pack_bf16x2(o[nd][2] * inv[1], o[nd][3] * inv[1]);
    }
    __syncwarp();
    const int q0 = (blockIdx.x * tc::kQTiles + qt) * tc::kTileQ;
    for (int idx = lane; idx < 16 * ND; idx += 32) {
      const int r = idx / ND, c = (idx % ND) * 8;
      const int row = q0 + warp * 16 + r;
      if (row >= p.S) continue;
      bf16* dst = O + row * p.so.s + c;
      const bf16* src = so + r * P + c;
      if (p.o_vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = src[e];
      }
    }
  }
}

template <int Dh>
cudaError_t launch_mma(const ExactParams& p, int B, cudaStream_t stream) {
  const size_t smem = tc::smem_bytes<Dh>(p.K);
  auto kernel = p.K <= tc::Tile<Dh>::kTileKV ? exact_fwd_mma_kernel<Dh, true>
                                             : exact_fwd_mma_kernel<Dh, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int qtiles = (p.S + tc::kTileQ - 1) / tc::kTileQ;
  const dim3 grid((qtiles + tc::kQTiles - 1) / tc::kQTiles, B * p.H);
  kernel<<<grid, tc::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const ExactParams& p, int B, int Dh, cudaStream_t stream) {
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

// q (B,H,S,Dh); kbar, vbar (B,Hkv,K,Dh); out (B,H,S,Dh), all in `dtype`.
// strides: 9 element strides (batch, head, seq) of q, of kbar and vbar
// (shared) and of out. fp32 runs the SIMT kernel, bf16 the tensor-core
// kernel. Returns the launch's cudaError_t.
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
  if (dtype != kBFloat16) return cudaErrorInvalidValue;
  p.q_vec = mma::aligned16(q, p.sq.b, p.sq.h, p.sq.s);
  p.kv_vec = mma::aligned16(kbar, p.skv.b, p.skv.h, p.skv.s) && mma::aligned16(vbar);
  p.o_vec = mma::aligned16(out, p.so.b, p.so.h, p.so.s);
  return dispatch_mma(p, B, Dh, s);
}
