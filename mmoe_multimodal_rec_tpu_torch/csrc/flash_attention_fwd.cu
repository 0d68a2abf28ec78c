// Self-attention forward for Hopper (sm_90a), packed-qkv and split-q/k/v.
//
// Replaces two Pallas TPU kernels of mmoe_multimodal_rec_tpu/ops/
// flash_attention.py, which share one body (`_head_fwd`):
// - `_fused_attention_fwd_packed_impl` -> `_fwd_kernel_packed` (public API
//   `flash_attention_packed`, the serving path's ViT and merged-LoRA text);
// - `_fused_attention_fwd_impl` -> `_fwd_kernel` (public API
//   `flash_attention`, the training path's text self-attention, with dropout).
// Python wrappers and plain PyTorch versions:
// mmoe_multimodal_rec_tpu_torch/ops/flash_attention.py.
//
// What it computes, per (batch row b, head h):
//   out[b, :, h*dh:(h+1)*dh] = dropout(softmax(Q K^T / sqrt(dh),
//                                      pad keys -> -1e9)) V
// with q/k/v read in place from their projection layouts.  Head h's columns
// start at (h / hb) * group_stride + (h % hb) * dh of each row, rows are
// row_stride apart, and q, k and v have their own base pointers:
// - packed (group-interleaved qkv [B, L, 3D] from pack_qkv_weights): q = qkv,
//   k = qkv + w, v = qkv + 2w, row_stride 3D, group_stride 3w (w = hb*dh);
// - split (q, k, v [B, L, D] each): row_stride D, hb = H, group_stride 0.
// The output is [B, L, D] head-major.  Optionally the softmax statistics of
// every row are written for the backward (csrc/flash_attention_bwd.cu):
// stats[(b*H + h)*L + q] = (m, l), the row max of the base-2 scores
// s*log2(e)/sqrt(dh) and the row sum of exp2(s - m) over all keys.  The
// backward rebuilds p = exp2(s - m) / l exactly as this kernel made it.  A
// single log-sum-exp would not do: an all-pad row has m = -1e9, where fp32
// cannot hold m + log2(l) apart from m.
//
// Bound on this card: at the main path's shapes (text B=128, L=384, D=768;
// ViT B=64, L=197) each call must move q, k, v once and the output once
// (302 MB text, 77.5 MB ViT) against 58 / 7.6 GFLOP of matmul, so it is
// memory-bound at the H100's 3.35 TB/s (90 us text, 23 us ViT); the tensor
// cores would need only 59 / 8 us.  The design keeps the [L, L] score matrix
// out of device memory: one block of 4 warps per (q tile of 64 rows, head,
// batch row) walks the keys in tiles of 64 with an online max-shifted
// softmax in fp32, so device memory sees each q row once and each k/v row
// once per q tile (the re-reads of one head's k/v, 2*L*dh*2 = 98 KB, hit
// L2: blocks of one (b, h) are adjacent in the grid).
//
// bf16 (the main path): FlashAttention-2 style.  Each warp owns 16 query
// rows; QK^T and PV run on the tensor cores as mma.sync m16n8k16 (bf16 in,
// fp32 accumulate) with the scores, the probabilities and the output
// accumulator held in registers (the score accumulator is reused as the A
// operand of PV), and operands fed from shared memory by ldmatrix.  The
// next k/v tile is fetched by cp.async while the current one is in use
// (two stages).  fp32 inputs take a plain FMA kernel whose scores and
// partial products go through shared memory; it exists for exact checks.
// wgmma, TMA and warp specialisation are later work.
//
// Semantics:
// - Softmax is the exact max-shifted form (the JAX kernel's
//   MMOE_SAFE_SOFTMAX=1 branch), in base 2; it equals the default
//   exp(clip(s, +-60)) form whenever |s| < 60.
// - A padded key's score is REPLACED by -1e9 (equal to adding the -1e9
//   bias whenever the row has a real key, since exp underflows to 0 either
//   way).  So an all-pad row gives exactly uniform weights over the L real
//   keys, as the einsum path (models/layers._dot_product_attention) does.
//   The JAX kernel differs there when L is not a multiple of 128: it also
//   spreads weight over its zero-padded key tail.
// - The ragged tail (L = 197) is handled by bounds, not by padding L:
//   keys >= L score -inf, q rows >= L are not stored.
// - Dropout: the keep mask is the JAX interpret-mode murmur hash
//   (`_keep_mask(use_prng=False)`), keyed on ((b*H + h)*L + q)*lk_pad + k
//   with lk_pad = L rounded up to 128, keep = bits >= threshold.  The
//   counter depends on the position only, so q may be tiled freely.  The
//   row sum counts every key, kept or dropped, and 1/(1-rate) rides the
//   epilogue, as in `_head_fwd`.  Masks are bit-identical to the JAX
//   interpret mode.
//
// C interface (ctypes): mmoe_flash_attention_fwd returns cudaError_t as an
// int; 0 means the launch was accepted.  It launches on the given stream,
// does not synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int WARPS = 4;  // warp w owns query rows [16w, 16w + 16)
constexpr int THREADS = WARPS * 32;
constexpr float NEG_MASK = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// Where one (b, h) head's rows live, and what the call does with them.
template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const uint8_t* pad;  // [B, L], 1 = padded key; may be null
  T* out;              // [B, L, H*DH]
  float2* stats;       // [B, H, L] (m, l); may be null
  int L, H, hb, row_stride, group_stride, lk_pad;
  float scale2;        // log2(e) / sqrt(dh)
  uint32_t seed, threshold;
  float keep_scale;    // 1 / (1 - rate)
  int dropout;
};

// ops/flash_attention.py:_hash_bits over one uint32 counter.
__device__ __forceinline__ uint32_t hash_bits(uint32_t x, uint32_t seed) {
  x = x * 2654435761u + seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Score of one key: the scaled dot product for a real key, -1e9 for a
// padded key, -inf past L (`bias` is 0, NEG_MASK or -inf).
__device__ __forceinline__ float masked_score(float dot, float scale,
                                              float bias) {
  return bias == 0.0f ? dot * scale : bias;
}

__device__ __forceinline__ float key_bias(const uint8_t* pad_b, int key,
                                          int L) {
  return key >= L ? -INFINITY : (pad_b && pad_b[key]) ? NEG_MASK : 0.0f;
}

// Column offset of head h in a row.
__device__ __forceinline__ size_t head_col(int h, int hb, int group_stride,
                                           int dh) {
  return (size_t)(h / hb) * group_stride + (size_t)(h % hb) * dh;
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src must still be a
// mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared memory: the q tile, then two stages of (k tile, v tile), then two
// stages of key biases.  Rows are padded by 16 bytes so the 8 row
// addresses of every ldmatrix fall in distinct bank groups.
template <int DH>
struct MmaLayout {
  static constexpr int LD = DH + 8;     // bf16 per smem row
  static constexpr int TILE = BQ * LD;  // bf16 per 64-row tile (BQ == BK)
  static constexpr size_t q = 0;
  static constexpr size_t kv = q + sizeof(bf16) * TILE;
  static constexpr size_t bias = kv + sizeof(bf16) * 4 * TILE;
  static constexpr size_t bytes = bias + sizeof(float) * 2 * BK;
};

// rows [row0, row0 + 64) x DH columns of one head into smem by cp.async;
// rows past L are zero-filled.
template <int DH>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src, int row0,
                                        int L, int row_stride) {
  constexpr int LD = MmaLayout<DH>::LD;
  constexpr int CPR = DH / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < BQ * CPR; i += THREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    const bool valid = row0 + r < L;
    cp_async16(dst + r * LD + c,
               src + (size_t)(valid ? row0 + r : 0) * row_stride + c, valid);
  }
}

// SPLIT: q/k/v of their own [B, L, D] (head h at column h*DH); else the
// packed layout.  STATS: the softmax statistics are stored for the
// backward.  Three instantiations: split with statistics (#2), packed
// without (#1 on the serving path, which has no backward: the store's
// registers cost it 15%), and packed with (#1 where qkv needs a gradient,
// HoME's fine-tuned ViT layers), so a profile tells them apart and serving
// keeps its lower register count.  At dh 64, at most 128 registers a
// thread: 4 blocks (16 warps) per SM.
template <int DH, bool SPLIT, bool STATS>
__global__ void __launch_bounds__(THREADS, DH == 64 ? 4 : 1)
attention_fwd_bf16(const Args<bf16> a) {
  using Lay = MmaLayout<DH>;
  constexpr int LD = Lay::LD;
  constexpr int KD = DH / 16;  // k16 steps of QK^T
  constexpr int NS = BK / 8;   // n8 tiles of scores per warp
  constexpr int NO = DH / 8;   // n8 tiles of output per warp
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + Lay::q);
  bf16* kvs = reinterpret_cast<bf16*>(smem + Lay::kv);
  float* biases = reinterpret_cast<float*>(smem + Lay::bias);

  const int L = a.L;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = a.H * DH;
  const size_t base = (size_t)b * L * a.row_stride +
                      (SPLIT ? (size_t)h * DH
                             : head_col(h, a.hb, a.group_stride, DH));
  const bf16* qsrc = a.q + base;
  const bf16* ksrc = a.k + base;
  const bf16* vsrc = a.v + base;
  const uint8_t* pad_b = a.pad ? a.pad + (size_t)b * L : nullptr;
  const int nk = (L + BK - 1) / BK;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row (and +8)
  const int qd = lane % 4;  // fragment column pair
  // ldmatrix.x4: lane supplies row (lane % 8) of matrix (lane / 8)
  const int mrow = lane % 8;
  const int mat = lane / 8;

  auto load_kv = [&](int kt) {
    const int stage = kt & 1;
    bf16* ks = kvs + stage * 2 * Lay::TILE;
    cp_tile<DH>(ks, ksrc, kt * BK, L, a.row_stride);
    cp_tile<DH>(ks + Lay::TILE, vsrc, kt * BK, L, a.row_stride);
    for (int i = threadIdx.x; i < BK; i += THREADS)
      biases[stage * BK + i] = key_bias(pad_b, kt * BK + i, L);
    cp_async_commit();
  };

  cp_tile<DH>(qs, qsrc, q0, L, a.row_stride);
  load_kv(0);  // one group: q and the first k/v tile

  // this lane's two rows, and their dropout counters at key 0 (uint32
  // wrap, as in JAX)
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  const uint32_t bh = (uint32_t)b * (uint32_t)a.H + (uint32_t)h;
  const uint32_t kbase0 =
      (bh * (uint32_t)L + (uint32_t)row0) * (uint32_t)a.lk_pad;
  const uint32_t kbase1 =
      (bh * (uint32_t)L + (uint32_t)row1) * (uint32_t)a.lk_pad;

  uint32_t qf[KD][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};  // this lane's share of the row sums

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; every warp is done with kt - 1
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldmatrix_x4(qf[kk], qs + (warp * 16 + (mat % 2) * 8 + mrow) * LD +
                                kk * 16 + (mat / 2) * 8);
    }
    if (kt + 1 < nk) load_kv(kt + 1);  // overlaps this tile's math

    const bf16* ks = kvs + (kt & 1) * 2 * Lay::TILE;
    const bf16* vs = ks + Lay::TILE;
    const float* bias = biases + (kt & 1) * BK;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        // matrices: (keys j, dims lo), (j, hi), (j+1, lo), (j+1, hi)
        uint32_t kf[4];
        ldmatrix_x4(kf, ks + ((j + mat / 2) * 8 + mrow) * LD + kk * 16 +
                            (mat % 2) * 8);
        mma_bf16(s[j], qf[kk], kf[0], kf[1]);
        mma_bf16(s[j + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // online softmax (base 2); element e of tile j is row (e < 2 ? g :
    // g + 8), key j*8 + 2*qd + (e & 1)
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = masked_score(s[j][e], a.scale2,
                               bias[j * 8 + 2 * qd + (e & 1)]);
        tmax[e / 2] = fmaxf(tmax[e / 2], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      // every tile holds a key < L, so tmax is finite and alpha is
      // exp2(-inf) = 0 on the first tile
      const float m_new = fmaxf(m[i], tmax[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[j][e] - m[e / 2]);
        l[e / 2] += p;
        if (a.dropout) {
          const uint32_t key = (uint32_t)(kt * BK + j * 8 + 2 * qd + (e & 1));
          if (hash_bits((e < 2 ? kbase0 : kbase1) + key, a.seed) <
              a.threshold)
            p = 0.0f;
        }
        s[j][e] = p;
      }
    }

    // O += P V: the score accumulators of key tiles 2kk, 2kk+1 are the A
    // fragment of keys [16kk, 16kk + 16)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        // transposed matrices: (keys lo, dims n), (keys hi, n), (lo, n+1),
        // (hi, n+1)
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs + (kk * 16 + (mat % 2) * 8 + mrow) * LD +
                                  (n + mat / 2) * 8);
        mma_bf16(o[n], pa, vf[0], vf[1]);
        mma_bf16(o[n + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // epilogue: full row sums, normalise, store bf16 pairs
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (STATS && a.stats && qd == 0) {
    float2* st = a.stats + (size_t)bh * L;
    if (row0 < L) st[row0] = make_float2(m[0], l[0]);
    if (row1 < L) st[row1] = make_float2(m[1], l[1]);
  }
  const float inv0 = a.keep_scale / l[0];
  const float inv1 = a.keep_scale / l[1];
  bf16* orow0 = a.out + ((size_t)b * L + row0) * D + h * DH + 2 * qd;
  bf16* orow1 = orow0 + (size_t)8 * D;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (row0 < L)
      *reinterpret_cast<uint32_t*>(orow0 + n * 8) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (row1 < L)
      *reinterpret_cast<uint32_t*>(orow1 + n * 8) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// fp32: plain FMA kernel (exact checks; not on the main path)
// ---------------------------------------------------------------------------

template <int DH>
struct Fp32Layout {
  static constexpr int LDT = DH + 4;                   // q, k, v tiles
  static constexpr int LDS = (DH > BK ? DH : BK) + 4;  // scores / P@V
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(float) * BQ * LDT;
  static constexpr size_t v = k + sizeof(float) * BK * LDT;
  static constexpr size_t s = v + sizeof(float) * BK * LDT;
  static constexpr size_t o = s + sizeof(float) * BQ * LDS;
  static constexpr size_t bias = o + sizeof(float) * BQ * DH;
  static constexpr size_t bytes = bias + sizeof(float) * BK;
};

template <int DH>
__device__ __forceinline__ void load_tile_fp32(float* dst, const float* src,
                                               int row0, int L,
                                               int row_stride) {
  constexpr int LDT = Fp32Layout<DH>::LDT;
  constexpr int VPR = DH / 4;
  for (int i = threadIdx.x; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < L)
      val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) *
                                                       row_stride + c);
    *reinterpret_cast<float4*>(dst + r * LDT + c) = val;
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
attention_fwd_fp32(const Args<float> a) {
  using Lay = Fp32Layout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + Lay::q);
  float* ks = reinterpret_cast<float*>(smem + Lay::k);
  float* vs = reinterpret_cast<float*>(smem + Lay::v);
  float* ss = reinterpret_cast<float*>(smem + Lay::s);
  float* os = reinterpret_cast<float*>(smem + Lay::o);
  float* bias = reinterpret_cast<float*>(smem + Lay::bias);

  const int L = a.L;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = a.H * DH;
  const size_t base = (size_t)b * L * a.row_stride +
                      head_col(h, a.hb, a.group_stride, DH);
  const float* ksrc = a.k + base;
  const float* vsrc = a.v + base;
  const uint8_t* pad_b = a.pad ? a.pad + (size_t)b * L : nullptr;

  load_tile_fp32<DH>(qs, a.q + base, q0, L, a.row_stride);
  for (int i = threadIdx.x; i < BQ * DH; i += THREADS) os[i] = 0.0f;

  // lane pair (2r', 2r'+1) of warp w owns row r = 16w + r'; each lane takes
  // every other column
  const int r = (threadIdx.x / 32) * 16 + (threadIdx.x % 32) / 2;
  const int half = threadIdx.x % 2;
  const uint32_t bh = (uint32_t)b * (uint32_t)a.H + (uint32_t)h;
  const uint32_t key_base =
      (bh * (uint32_t)L + (uint32_t)(q0 + r)) * (uint32_t)a.lk_pad;
  float m = -INFINITY;
  float l = 0.0f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile_fp32<DH>(ks, ksrc, k0, L, a.row_stride);
    load_tile_fp32<DH>(vs, vsrc, k0, L, a.row_stride);
    for (int i = threadIdx.x; i < BK; i += THREADS)
      bias[i] = key_bias(pad_b, k0 + i, L);
    __syncthreads();

    float* srow = ss + r * Lay::LDS;
    const float* qrow = qs + r * Lay::LDT;
    float tile_max = -INFINITY;
    for (int c = half; c < BK; c += 2) {
      const float* krow = ks + c * Lay::LDT;
      float dot = 0.0f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) dot += qrow[d] * krow[d];
      srow[c] = masked_score(dot, a.scale2, bias[c]);
      tile_max = fmaxf(tile_max, srow[c]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = exp2f(m - m_new);
    m = m_new;
    float sum = 0.0f;
    for (int c = half; c < BK; c += 2) {
      float p = exp2f(srow[c] - m);
      sum += p;
      if (a.dropout &&
          hash_bits(key_base + (uint32_t)(k0 + c), a.seed) < a.threshold)
        p = 0.0f;
      srow[c] = p;
    }
    l = l * alpha + sum + __shfl_xor_sync(0xffffffffu, sum, 1);
    __syncwarp();
    float* orow = os + r * DH;
    for (int c = half; c < DH; c += 2) {
      float acc = 0.0f;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) acc += srow[j] * vs[j * Lay::LDT + c];
      orow[c] = orow[c] * alpha + acc;
    }
  }

  if (q0 + r < L) {
    if (a.stats && half == 0)
      a.stats[(size_t)bh * L + q0 + r] = make_float2(m, l);
    const float inv = a.keep_scale / l;
    float* dst = a.out + ((size_t)b * L + q0 + r) * D + h * DH;
    for (int c = half; c < DH; c += 2) dst[c] = os[r * DH + c] * inv;
  }
}

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem_bytes, const Args<T>& a,
                   int batch, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.L + BQ - 1) / BQ, a.H, batch);
  kernel<<<grid, THREADS, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
Args<T> make_args(const void* q, const void* k, const void* v,
                  const void* pad, void* out, void* stats, int L, int H,
                  int hb, int row_stride, int group_stride, int lk_pad,
                  float scale, unsigned int seed, unsigned int threshold,
                  float keep_scale, int dropout) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.pad = static_cast<const uint8_t*>(pad);
  a.out = static_cast<T*>(out);
  a.stats = static_cast<float2*>(stats);
  a.L = L;
  a.H = H;
  a.hb = hb;
  a.row_stride = row_stride;
  a.group_stride = group_stride;
  a.lk_pad = lk_pad;
  a.scale2 = scale * LOG2E;
  a.seed = seed;
  a.threshold = threshold;
  a.keep_scale = keep_scale;
  a.dropout = dropout;
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  pad and stats may be null.
// Element strides and offsets: row_stride between rows of q/k/v, head h at
// column (h / hb) * group_stride + (h % hb) * head_dim; lk_pad is the
// dropout counter's key stride.
extern "C" int mmoe_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* pad, void* out,
    void* stats, int dtype, int batch, int L, int n_heads, int hb,
    int head_dim, int row_stride, int group_stride, int lk_pad, float scale,
    unsigned int seed, unsigned int threshold, float keep_scale, int dropout,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MMOE_LAUNCH(T, DH, KERNEL, LAYOUT)                                   \
  launch<T>(KERNEL, LAYOUT<DH>::bytes,                                       \
            make_args<T>(q, k, v, pad, out, stats, L, n_heads, hb,           \
                         row_stride, group_stride, lk_pad, scale, seed,      \
                         threshold, keep_scale, dropout),                    \
            batch, s)
  const bool split = group_stride == 0 && hb == n_heads;
  if (dtype == 1 && head_dim == 64)
    return split ? MMOE_LAUNCH(bf16, 64, (attention_fwd_bf16<64, true, true>),
                               MmaLayout)
           : stats
               ? MMOE_LAUNCH(bf16, 64, (attention_fwd_bf16<64, false, true>),
                             MmaLayout)
               : MMOE_LAUNCH(bf16, 64, (attention_fwd_bf16<64, false, false>),
                             MmaLayout);
  if (dtype == 1 && head_dim == 128)
    return split
               ? MMOE_LAUNCH(bf16, 128, (attention_fwd_bf16<128, true, true>),
                             MmaLayout)
           : stats
               ? MMOE_LAUNCH(bf16, 128,
                             (attention_fwd_bf16<128, false, true>), MmaLayout)
               : MMOE_LAUNCH(bf16, 128,
                             (attention_fwd_bf16<128, false, false>),
                             MmaLayout);
  if (dtype == 0 && head_dim == 64)
    return MMOE_LAUNCH(float, 64, attention_fwd_fp32<64>, Fp32Layout);
  if (dtype == 0 && head_dim == 128)
    return MMOE_LAUNCH(float, 128, attention_fwd_fp32<128>, Fp32Layout);
#undef MMOE_LAUNCH
  return (int)cudaErrorInvalidValue;
}
