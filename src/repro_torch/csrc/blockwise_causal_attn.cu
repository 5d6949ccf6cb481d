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
//   slot); the chunk's own keys and values are activations, in q's dtype.
//
// Scores and accumulation are fp32; the output has q's dtype. GQA: query
// head h reads kv head h / G, never a repeated copy.
//
// The residual form also writes each row's softmax max and denominator in
// fp32, which the backward (blockwise_causal_attn_bwd.cu) recomputes the
// probabilities from. The online softmax rescales its running denominator
// whenever the running max moves, so after the last tile the pair (m, l) is
// exactly _attend_block's (the max over the joint row of s*scale, natural
// units, and the sum of exp(s*scale - max)); that final pair is what gets
// written.
//
// What bounds it on an H100. The work is about 4*Dh flops per visible (row,
// key) pair against one read of q, k, v, k-bar, v-bar and one write of the
// output. At the chunked serve's chunk forward (B=4, H=32, Hkv=8, P=512,
// c=256, r=16, Dh=128, M=288) a row sees ~232 keys: ~185 flops a byte in
// bf16, under the tensor cores' ridge (~295), so the bound is bytes; at the
// train step's (B=2, S=4096, M=256) a row sees ~248: bytes again.
//
// Two designs, chosen by dtype:
//
// bf16 (bca_prefix_mma_kernel: every form in the model dtype - kernels 1
// and 1r, the training form, with null start blocks read as zeros; 4, 4r
// and 8 with start blocks): both products on the tensor cores (mma.sync
// m16n8k16, fp32 accumulators). A block owns one 64-row query tile of one row b and
// of two query heads of one kv head (one when the group G is odd), 4 warps
// a head; each warp owns 16 rows, which lie in one attention block (c is a
// multiple of 16), so each warp keeps its own visibility cut and diagonal
// when c is not a multiple of 64 and the tile spans blocks. q goes to
// registers as A fragments once. 64-key tiles stream through shared memory
// by 16-byte cp.async into rows of pitch Dh + 8 bf16 (no ldmatrix bank
// conflicts), in three buffers (two heads a block: two tiles in flight) or
// two (one head, so that two blocks share an SM): first the slot tiles up
// to the tile's last row's cut, then the own block's keys up to its last
// row; nothing past either is loaded, and every tile serves both heads. A
// warp skips a tile it sees nothing of, and in the value product the
// 16-key groups past its rows; masks apply only in a warp's last partial
// slot tile and on its diagonal (and, when the tile spans blocks, to the
// keys of an earlier block). The scores stay in registers: softmax in
// base 2 (scale*log2 e folded in, ex2.approx), row max and sum by quad
// shuffles, P = exp2(s - m) rounded to bf16 straight into the value
// product's A fragments, v by ldmatrix.trans, the output divided by the
// fp32 row sum once at the end, staged through shared memory and stored in
// 16-byte pieces. The residual max is converted back to natural units
// (times ln 2) before it is written. Every row sees its own diagonal key,
// so its sum is never 0. Cast point: the TPU kernel rounds the normalised
// probabilities to v's dtype; this kernel rounds the unnormalised
// exp(s - m) (as FlashAttention does) and normalises in fp32: both errors
// are at most 2^-9 * max|v| an output. What holds it back (PERF.md): about
// 220 registers a thread leave 8 warps on an SM, too few to hide the
// latency of the loads and of the mma.sync chains.
//
//   Quantized slots (kernel 8) are held exact: every int8 code and every
//   finite e4m3 code is a bf16 value. The codes land by cp.async (16 a
//   piece) in a byte tile, are converted to bf16 in shared memory without
//   rounding, and the per-slot fp32 scales (staged per tile, by 4-byte
//   cp.async; they arrive with stride Hkv along M) apply outside the
//   products: each score column is multiplied by its k-bar scale before the
//   row max, each p by its v-bar scale before P is rounded to bf16, and the
//   row sum takes the unscaled p. The only rounding is the one the dense
//   slots have.
//
//   Grid: one block per (query tile, row b, head pair) in one dimension,
//   the head pairs of a kv head fastest, then the query tiles of that kv
//   head (last tile first: it sees the most keys and slots), so k, v and
//   the slot tiles come from L2. No atomics: two launches give the same
//   bits. An operand whose base or row stride is not a multiple of 16 bytes
//   is read element by element (byte by byte for codes) into the same
//   layout.
//
// fp32 (bca_fwd_kernel: the card's fp32 parity path of every form, where
// tensor cores would round to TF32): SIMT, bound by fp32 FMA issue. The TPU
// kernel pinned all M slots in VMEM per grid step (1 MiB each for k-bar and v-bar at M = 4096,
// Dh = 128, bf16), far past the 227 KB of shared memory of one block. Here
// one thread block owns one (batch*head, query tile of BQ rows); a tile
// never straddles two attention blocks (BQ divides c). It streams 64-key
// tiles through shared memory with an online softmax in fp32 (running max
// and sum per row, normalised once at the end): first only the visible
// slot tiles, then the own block up to the tile's last row, so tiles above
// the diagonal and slots past the visibility cut are never loaded. Each
// score tile is 16 x 16 threads with a register block of (BQ/16) x 4 scores
// and (BQ/16) x (Dh/16) output accumulators; rows are padded by one float
// in shared memory so the inner products are free of bank conflicts;
// quantized slots are dequantised as each slot tile is loaded.
#include <cstdint>

#include <climits>
#include <type_traits>

#include "attn_tile.cuh"
#include "common.cuh"
#include "mma_bf16.cuh"

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
  bool q_vec, kv_vec, slot_vec, o_vec;    // tensor-core kernel: rows go by 16-byte copies
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

// The kernel the last bca_forward call launched (bca_forward_route):
// kRouteSimt, kRouteMma, or -1 before the first launch.
constexpr int kRouteSimt = 0;
constexpr int kRouteMma = 1;
int last_route = -1;

template <typename T, typename S, int Dh, int BQ>
cudaError_t launch(const BcaParams& p, int B, cudaStream_t stream) {
  last_route = kRouteSimt;
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

// -- bf16: tensor cores -------------------------------------------------------

namespace tc {
constexpr int kWarpsPerHead = 4;
constexpr int kTileQ = 16 * kWarpsPerHead;  // query rows of a head a block, 16 a warp
constexpr int kTileK = 64;                  // keys or slots a shared-memory tile
constexpr int kCodePad = 16;                // bytes past Dh in a row of a code tile
constexpr int kMaxHeads = 2;                // query heads a block (of one kv head)

// A block takes the 64-row query tile of kHeads query heads of one kv head
// (2 when the group G is even, else 1), so every k, v and slot tile it
// loads serves 64 * kHeads rows; one block of two heads, or two of one,
// fill an SM's registers. Its tiles stream through kStages buffers: three
// for two heads, which have the SM's shared memory to themselves; two for
// one head, so two blocks fit.
__host__ __device__ constexpr int threads(int heads) { return 32 * kWarpsPerHead * heads; }
__host__ __device__ constexpr int stages(int heads) { return heads == 2 ? 3 : 2; }

// Dynamic shared memory, per stage: a k and a v tile of bf16 rows of pitch
// Dh + 8; for quantized slots (S = int8_t or fp8) also a k and a v code tile
// of byte rows of pitch Dh + kCodePad and the tile's k and v fp32 scales.
// The q tiles (one a head) lie in the last stage's k and v tiles until
// their fragments are in registers; the output is staged through stage 0
// at the end.
template <int Dh, typename S, int Heads>
struct Layout {
  static constexpr bool kQuant = !std::is_same<S, __nv_bfloat16>::value;
  static constexpr int kStages = stages(Heads);
  static constexpr int kPitch = Dh + 8;                       // bf16 elements
  static constexpr int kCodePitch = Dh + kCodePad;            // bytes
  static constexpr int kTileBytes = kTileK * kPitch * 2;      // one k or v tile
  static constexpr int kCodeBytes = kQuant ? kTileK * kCodePitch : 0;
  static constexpr int kScaleBytes = kQuant ? kTileK * 4 : 0;
  static constexpr int kStageBytes = 2 * (kTileBytes + kCodeBytes + kScaleBytes);
  static constexpr int kSmemBytes = kStages * kStageBytes;
};
static_assert(kTileQ * kMaxHeads <= 2 * kTileK, "the q tiles are staged in a k and a v tile");
}  // namespace tc

// Stage a Rows x Dh tile of 1-byte codes (row stride `rs` bytes) into shared
// memory with pitch Pitch: rows >= valid_rows become zeros. With `vec` whole
// 16-code pieces go by cp.async, else byte by byte. All Threads threads take
// part.
template <int Threads, int Rows, int Dh, int Pitch>
__device__ __forceinline__ void load_code_tile(unsigned char* dst, const unsigned char* src,
                                               long long rs, int valid_rows, bool vec) {
  static_assert(Dh % 16 == 0 && Pitch % 16 == 0, "16-byte pieces");
  constexpr int kPieces = Dh / 16;
  for (int idx = threadIdx.x; idx < Rows * kPieces; idx += Threads) {
    const int r = idx / kPieces, c = (idx % kPieces) * 16;
    unsigned char* d = dst + r * Pitch + c;
    if (r < valid_rows && vec) {
      mma::cp_async_16(d, src + r * rs + c);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (r < valid_rows) {
        const unsigned char* s = src + r * rs + c;
#pragma unroll
        for (int j = 0; j < 16; ++j) w[j / 4] |= static_cast<uint32_t>(s[j]) << (8 * (j % 4));
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// One 1-byte code as bf16: exact (an int8 code is an integer of at most 8
// bits; an e4m3 code has 3 mantissa bits and exponents inside bf16's range).
template <typename S> __device__ __forceinline__ float code_to_f32(unsigned char c);
template <> __device__ __forceinline__ float code_to_f32<int8_t>(unsigned char c) {
  return static_cast<float>(static_cast<int8_t>(c));
}
template <> __device__ __forceinline__ float code_to_f32<__nv_fp8_e4m3>(unsigned char c) {
  __nv_fp8_e4m3 x;
  x.__x = c;
  return static_cast<float>(x);
}

// Convert a stage's k and v code tiles (2 * kTileK rows, k then v, pitch
// CodePitch bytes) to bf16 rows (pitch Pitch) of its k and v tiles. All
// Threads threads take part.
template <typename S, int Threads, int Dh, int Pitch, int CodePitch>
__device__ __forceinline__ void convert_codes(__nv_bfloat16* dst, const unsigned char* src) {
  constexpr int kPieces = Dh / 16;
  for (int idx = threadIdx.x; idx < 2 * tc::kTileK * kPieces; idx += Threads) {
    const int r = idx / kPieces, c = (idx % kPieces) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * CodePitch + c);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t word = w[j / 2] >> (16 * (j % 2));
      o[j] = mma::pack_bf16x2(code_to_f32<S>(word & 0xffu), code_to_f32<S>((word >> 8) & 0xffu));
    }
    uint4* d = reinterpret_cast<uint4*>(dst + r * Pitch + c);
    d[0] = make_uint4(o[0], o[1], o[2], o[3]);
    d[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// S: the slot storage (bf16, int8_t or __nv_fp8_e4m3); q, k, v and the
// output are bf16; start_blocks null means all zeros (the training form,
// M = (S/c)*r). Heads: query heads a block.
template <typename S, int Dh, int Heads>
__global__ void __launch_bounds__(tc::threads(Heads), 2 / Heads)
    bca_prefix_mma_kernel(BcaParams p) {
  using L = tc::Layout<Dh, S, Heads>;
  using bf16 = __nv_bfloat16;
  constexpr int kThreads = tc::threads(Heads), kStages = L::kStages;
  constexpr int TK = tc::kTileK, P = L::kPitch;
  constexpr int NS = TK / 8, ND = Dh / 8, KD = Dh / 16;  // score / output n-tiles, q k-steps
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr float kLn2 = 0.6931471805599453f;
  extern __shared__ uint4 smem_prefix[];
  unsigned char* const base = reinterpret_cast<unsigned char*>(smem_prefix);
  auto stage_kv = [&](int st) {                 // k tile; the v tile follows at + TK * P
    return reinterpret_cast<bf16*>(base + st * L::kStageBytes);
  };
  auto stage_codes = [&](int st) {              // k codes; the v codes follow at + TK * pitch
    return base + st * L::kStageBytes + 2 * L::kTileBytes;
  };
  auto stage_scales = [&](int st) {             // k scales; the v scales follow at + TK
    return reinterpret_cast<float*>(base + st * L::kStageBytes + 2 * L::kTileBytes
                                    + 2 * L::kCodeBytes);
  };
  bf16* const sQ = stage_kv(kStages - 1);       // head i's q tile at + i * kTileQ * P

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int hw = warp / tc::kWarpsPerHead;      // this warp's head in the block
  const int wr = warp % tc::kWarpsPerHead;      // and its 16 rows in the query tile
  // block -> (head pair in the group, query tile, kv head, row b)
  const int G = p.H / p.Hkv;
  const int nq = (p.S + tc::kTileQ - 1) / tc::kTileQ;
  int id = blockIdx.x;
  const int gi = id % (G / Heads);
  id /= G / Heads;
  const int qt = nq - 1 - id % nq;              // the heaviest query tile first
  id /= nq;
  const int hk = id % p.Hkv;
  const int b = id / p.Hkv;
  const int h0 = hk * G + gi * Heads;           // the block's first query head
  const int c = p.block_size;
  const int q0 = qt * tc::kTileQ;
  const int q_end = min(q0 + tc::kTileQ, p.S);  // the tile's rows below S
  const int nb0 = p.start_blocks == nullptr ? 0 : p.start_blocks[b];
  // the block loads the slots its last row sees and the own-block keys from
  // its first row's block start up to its last row
  const int nsl_blk = min((nb0 + (q_end - 1) / c) * p.block_slots, p.M);
  const int k_beg = (q0 / c) * c;
  const int nst = (nsl_blk + TK - 1) / TK;
  const int items = nst + (q_end - k_beg + TK - 1) / TK;
  // this warp's 16 rows r0 .. r0 + 15 lie in one attention block (or past S)
  const int r0 = q0 + 16 * wr;
  const bool active = r0 < p.S;
  const int kb_w = (r0 / c) * c;
  const int nsl_w = min((nb0 + r0 / c) * p.block_slots, p.M);

  const bf16* Q = static_cast<const bf16*>(p.q) + b * p.sq.b + h0 * p.sq.h;
  const bf16* K = static_cast<const bf16*>(p.k) + b * p.skv.b + hk * p.skv.h;
  const bf16* V = static_cast<const bf16*>(p.v) + b * p.skv.b + hk * p.skv.h;
  const S* KB = static_cast<const S*>(p.kbar) + b * p.sslot.b + hk * p.sslot.h;
  const S* VB = static_cast<const S*>(p.vbar) + b * p.sslot.b + hk * p.sslot.h;
  const long long sc0 = b * p.sscale.b + hk * p.sscale.h;
  bf16* O = static_cast<bf16*>(p.out) + b * p.so.b + (h0 + hw) * p.so.h;

  // item w < nst: slot tile w; else own-block key tile w - nst. Every call
  // commits one cp.async group (empty past the last item), so waiting for
  // all but the newest kStages - 2 groups waits for item w.
  auto issue = [&](int w) {
    if (w < items) {
      const int st = w % kStages;
      if (w == 0) {
#pragma unroll
        for (int i = 0; i < Heads; ++i)
          mma::load_tile<kThreads, tc::kTileQ, Dh, P>(sQ + i * tc::kTileQ * P,
                                                      Q + i * p.sq.h + q0 * p.sq.s, p.sq.s,
                                                      q_end - q0, Dh, p.q_vec);
      }
      bf16* skv = stage_kv(st);
      if (w < nst) {
        const int j0 = w * TK, valid = min(TK, nsl_blk - j0);
        if constexpr (L::kQuant) {
          unsigned char* sc = stage_codes(st);
          const auto* kb = reinterpret_cast<const unsigned char*>(KB + j0 * p.sslot.s);
          const auto* vb = reinterpret_cast<const unsigned char*>(VB + j0 * p.sslot.s);
          load_code_tile<kThreads, TK, Dh, L::kCodePitch>(sc, kb, p.sslot.s, valid, p.slot_vec);
          load_code_tile<kThreads, TK, Dh, L::kCodePitch>(sc + TK * L::kCodePitch, vb,
                                                          p.sslot.s, valid, p.slot_vec);
          float* ss = stage_scales(st);
          for (int i = threadIdx.x; i < 2 * TK; i += kThreads) {
            const int r = i % TK;
            const float* src =
                (i < TK ? p.kbar_scale : p.vbar_scale) + sc0 + (j0 + r) * p.sscale.s;
            if (r < valid)
              mma::cp_async_4(ss + i, src);
            else
              ss[i] = 0.f;
          }
        } else {
          mma::load_tile<kThreads, TK, Dh, P>(skv, KB + j0 * p.sslot.s, p.sslot.s, valid, Dh,
                                              p.slot_vec);
          mma::load_tile<kThreads, TK, Dh, P>(skv + TK * P, VB + j0 * p.sslot.s, p.sslot.s,
                                              valid, Dh, p.slot_vec);
        }
      } else {
        const int j0 = k_beg + (w - nst) * TK, valid = min(TK, q_end - j0);
        mma::load_tile<kThreads, TK, Dh, P>(skv, K + j0 * p.skv.s, p.skv.s, valid, Dh,
                                            p.kv_vec);
        mma::load_tile<kThreads, TK, Dh, P>(skv + TK * P, V + j0 * p.skv.s, p.skv.s, valid, Dh,
                                            p.kv_vec);
      }
    }
    mma::cp_async_commit();
  };

  uint32_t qf[KD][4];
  float o[ND][4], m[2], l[2];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = neg_inf();  // rows g and g + 8 of the warp, in log2 units
    l[r] = 0.f;        // this thread's part of the row sums
  }
  const float sl2 = p.scale * kLog2e;

#pragma unroll
  for (int w = 0; w < kStages - 1; ++w) issue(w);
  for (int w = 0; w < items; ++w) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // item w has landed for all; the buffers of item w - 1 are consumed
    if (w == 0) {
      // the warp's 16 q rows as A fragments: matrices (rows +0/+8) x (d +0/+8)
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        mma::ldmatrix_x4(qf[kd], sQ + (hw * tc::kTileQ + wr * 16 + (lane & 15)) * P + kd * 16
                                     + (lane >> 4) * 8);
      __syncthreads();  // q is in registers: the last stage is free
    }
    issue(w + kStages - 1);
    const int st = w % kStages;
    const bool slot = w < nst;
    if constexpr (L::kQuant) {
      if (slot) {
        convert_codes<S, kThreads, Dh, P, L::kCodePitch>(stage_kv(st), stage_codes(st));
        __syncthreads();
      }
    }
    if (!active) continue;
    // the tile's first key or slot; `live`: its columns any row of the warp
    // may see; `masked`: some row of the warp does not see some column
    int j0, live;
    bool masked;
    if (slot) {
      j0 = w * TK;
      if (j0 >= nsl_w) continue;
      live = nsl_w - j0;
      masked = live < TK;
    } else {
      j0 = k_beg + (w - nst) * TK;
      if (j0 + TK <= kb_w || j0 > r0 + 15) continue;
      live = r0 + 16 - j0;
      masked = j0 < kb_w || live <= TK;
    }
    const int groups = min(TK / 16, (live + 15) / 16);  // 16-column groups with a live column
    const bf16* sk = stage_kv(st);
    const bf16* sv = sk + TK * P;

    // S = q kᵀ: B fragments from k rows, matrices (keys +0/+8) x (d +0/+8);
    // all NS accumulators in flight at each k-step (the column groups past
    // `groups` are computed too: skipping them, a branch in this loop, cost
    // more than it saved)
    float s[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kf[4];
        mma::ldmatrix_x4(kf, sk + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * P + kd * 16
                                 + ((lane >> 3) & 1) * 8);
        mma::mma_bf16_16816(s[2 * np], qf[kd], kf[0], kf[1]);
        mma::mma_bf16_16816(s[2 * np + 1], qf[kd], kf[2], kf[3]);
      }
    }

    // scores in log2 units (quantized slots: times their k-bar scale
    // first); masked columns at -inf (weight exactly 0)
    const float* ks = stage_scales(st);
    if (L::kQuant && slot) {
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        const float2 sc = *reinterpret_cast<const float2*>(ks + nt * 8 + 2 * t);
        s[nt][0] *= sc.x;
        s[nt][1] *= sc.y;
        s[nt][2] *= sc.x;
        s[nt][3] *= sc.y;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= sl2;
    if (masked) {
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t + (e & 1);
          const bool ok = slot ? col < live
                               : j0 + col >= kb_w && j0 + col <= r0 + g + 8 * (e >> 1);
          if (!ok) s[nt][e] = neg_inf();
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float alpha = mma::exp2_approx(m[r] - mx[r]);
      l[r] *= alpha;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        o[nd][2 * r] *= alpha;
        o[nd][2 * r + 1] *= alpha;
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
    if (L::kQuant && slot) {  // p times its v-bar scale, before the bf16 rounding
      const float* vs = ks + TK;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        const float2 sc = *reinterpret_cast<const float2*>(vs + nt * 8 + 2 * t);
        s[nt][0] *= sc.x;
        s[nt][1] *= sc.y;
        s[nt][2] *= sc.x;
        s[nt][3] *= sc.y;
      }
    }

    // O += P v: P from the score registers, v by ldmatrix.trans, matrices
    // (keys +0/+8) x (d +0/+8)
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      if (kk >= groups) break;
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
  }

  // normalise by the row sums, stage the warp's 16 rows in its own rows of
  // stage 0 (every warp is past its last tile; no copy is in flight), store
  // 16-byte pieces
  mma::cp_async_wait<0>();
  __syncthreads();
  if (!active) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  bf16* so = stage_kv(0) + warp * 16 * P;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    *reinterpret_cast<uint32_t*>(so + g * P + nd * 8 + 2 * t) =
        mma::pack_bf16x2(o[nd][0] * inv[0], o[nd][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * P + nd * 8 + 2 * t) =
        mma::pack_bf16x2(o[nd][2] * inv[1], o[nd][3] * inv[1]);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * ND; idx += 32) {
    const int r = idx / ND, cc = (idx % ND) * 8;
    bf16* dst = O + (r0 + r) * p.so.s + cc;
    const bf16* src = so + r * P + cc;
    if (p.o_vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = src[e];
    }
  }
  if (p.m != nullptr && t == 0) {
    const long long at = (static_cast<long long>(b) * p.H + h0 + hw) * p.S + r0 + g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      p.m[at + 8 * r] = m[r] * kLn2;  // natural units of s * scale
      p.denom[at + 8 * r] = l[r];
    }
  }
}

template <typename S, int Dh, int Heads>
cudaError_t launch_prefix_mma(const BcaParams& p, int B, cudaStream_t stream) {
  last_route = kRouteMma;
  constexpr size_t smem = tc::Layout<Dh, S, Heads>::kSmemBytes;
  auto kernel = bca_prefix_mma_kernel<S, Dh, Heads>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(B) * (p.H / Heads) *
                           ((p.S + tc::kTileQ - 1) / tc::kTileQ);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), tc::threads(Heads), smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename S, int Heads>
cudaError_t dispatch_prefix_head_dim(const BcaParams& p, int B, int Dh, cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch_prefix_mma<S, 16, Heads>(p, B, stream);
    case 32: return launch_prefix_mma<S, 32, Heads>(p, B, stream);
    case 64: return launch_prefix_mma<S, 64, Heads>(p, B, stream);
    case 128: return launch_prefix_mma<S, 128, Heads>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// two query heads a block when the group is even, else one
template <typename S>
cudaError_t dispatch_prefix_heads(const BcaParams& p, int B, int Dh, cudaStream_t stream) {
  if ((p.H / p.Hkv) % 2 == 0) return dispatch_prefix_head_dim<S, 2>(p, B, Dh, stream);
  return dispatch_prefix_head_dim<S, 1>(p, B, Dh, stream);
}

cudaError_t dispatch_prefix_mma(const BcaParams& p, int B, int Dh, int slot_dtype,
                                cudaStream_t stream) {
  if (p.block_size % 16 != 0) return cudaErrorInvalidValue;
  if (slot_dtype == kBFloat16) return dispatch_prefix_heads<__nv_bfloat16>(p, B, Dh, stream);
  if (slot_dtype == kInt8) return dispatch_prefix_heads<int8_t>(p, B, Dh, stream);
  if (slot_dtype == kFp8E4M3) return dispatch_prefix_heads<__nv_fp8_e4m3>(p, B, Dh, stream);
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
// kbar_scale / vbar_scale (null for dense slots; may be null at M = 0),
// with start blocks only.
// strides: 15 element strides (batch, head, seq) of q, k and v (shared),
// kbar and vbar (shared), out, and the two scales (shared; unused when
// null). bf16 runs the tensor-core kernel (with start blocks or without),
// fp32 the SIMT kernel. Returns the launch's cudaError_t.
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
  // quantized slots exist only in the prefix form (the paged cache)
  const bool quantized = slot_dtype != dtype;
  if ((m == nullptr) != (denom == nullptr) ||
      (kbar_scale == nullptr) != (vbar_scale == nullptr) ||
      (!quantized && kbar_scale != nullptr) || (quantized && M > 0 && kbar_scale == nullptr) ||
      (quantized && start_blocks == nullptr))
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
  if (dtype != kBFloat16) return cudaErrorInvalidValue;
  p.q_vec = mma::aligned16(q, p.sq.b, p.sq.h, p.sq.s);
  p.kv_vec = mma::aligned16(k, p.skv.b, p.skv.h, p.skv.s) && mma::aligned16(v);
  p.slot_vec = quantized ? mma::aligned16<1>(kbar, p.sslot.b, p.sslot.h, p.sslot.s) &&
                               mma::aligned16<1>(vbar)
                         : mma::aligned16(kbar, p.sslot.b, p.sslot.h, p.sslot.s) &&
                               mma::aligned16(vbar);
  p.o_vec = mma::aligned16(out, p.so.b, p.so.h, p.so.s);
  return dispatch_prefix_mma(p, B, Dh, slot_dtype, s);
}

// The kernel the last bca_forward call of this process launched: 0 the SIMT
// bca_fwd_kernel (fp32), 1 the tensor-core bca_prefix_mma_kernel (bf16), -1
// none yet (a probe for the tests of the routes).
extern "C" int bca_forward_route() { return repro_torch::last_route; }
