// Packed-qkv self-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mmoe_multimodal_rec_tpu/ops/flash_attention.py
// `_fused_attention_fwd_packed_impl` -> `_fwd_kernel_packed` -> `_head_fwd`
// (public API `flash_attention_packed`).  Python wrapper and plain PyTorch
// version: mmoe_multimodal_rec_tpu_torch/ops/flash_attention.py.
//
// What it computes, per (batch row b, head h):
//   out[b, :, h*dh:(h+1)*dh] = softmax(Q K^T / sqrt(dh), pad keys -> -1e9) V
// with q/k/v read straight from the GROUP-INTERLEAVED qkv [B, L, 3D] layout
// that pack_qkv_weights builds: head group g = h / hb, w = hb*dh, and this
// head's q columns start at g*3w + (h % hb)*dh, k at +w, v at +2w.
//
// Bound on this card: at the serving shapes (text B=128, L=384, D=768;
// ViT B=64, L=197) each call must move the qkv once and the output once
// (302 MB text, 77.5 MB ViT) against 58 / 7.6 GFLOP of matmul, so it is
// memory-bound at the H100's 3.35 TB/s (90 us text, 23 us ViT); the tensor
// cores would need only 59 / 8 us.  The design keeps the [L, L] score matrix
// out of device memory: one block of 4 warps per (q tile of 64 rows, head,
// batch row) walks the keys in tiles of 64 with an online max-shifted
// softmax in fp32, so device memory sees each q row once and each k/v row
// once per q tile (the re-reads of one head's k/v, 2*L*dh*2 = 98 KB, hit
// L2: blocks of one (b, h) are adjacent in the grid).
//
// bf16 (the serving path): FlashAttention-2 style.  Each warp owns 16 query
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
//   MMOE_SAFE_SOFTMAX=1 branch); it equals the default exp(clip(s, +-60))
//   form whenever |s| < 60.
// - A padded key's score is REPLACED by -1e9 (equal to adding the -1e9
//   bias whenever the row has a real key, since exp underflows to 0 either
//   way).  So an all-pad row gives exactly uniform weights over the L real
//   keys, as the einsum path (models/layers._dot_product_attention) does.
//   The JAX kernel differs there when L is not a multiple of 128: it also
//   spreads weight over its zero-padded key tail.  The serving path never
//   meets the difference: text L = 384 has no pad tail, the ViT no mask.
// - The ragged tail (L = 197) is handled by bounds, not by padding L:
//   keys >= L score -inf, q rows >= L are not stored.
// - Dropout (rate > 0, L a multiple of 128): the keep mask is the JAX
//   interpret-mode murmur hash (`_keep_mask(use_prng=False)`), keyed on
//   ((b*H + h)*L + q)*L + k, keep = bits >= threshold.  The row sum counts
//   every key, kept or dropped, and 1/(1-rate) rides the epilogue, as in
//   `_head_fwd`.  Masks are bit-identical to the JAX interpret mode.
//
// C interface (ctypes): mmoe_flash_attention_packed returns cudaError_t as
// an int; 0 means the launch was accepted.  It launches on the given
// stream, does not synchronise and allocates nothing.

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

template <int DH>
__global__ void __launch_bounds__(THREADS)
packed_attention_fwd_bf16(const bf16* __restrict__ qkv,
                          const uint8_t* __restrict__ pad,
                          bf16* __restrict__ out, int L, int H, int hb,
                          float scale, uint32_t seed, uint32_t threshold,
                          float keep_scale, int dropout) {
  using Lay = MmaLayout<DH>;
  constexpr int LD = Lay::LD;
  constexpr int KD = DH / 16;  // k16 steps of QK^T
  constexpr int NS = BK / 8;   // n8 tiles of scores per warp
  constexpr int NO = DH / 8;   // n8 tiles of output per warp
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + Lay::q);
  bf16* kvs = reinterpret_cast<bf16*>(smem + Lay::kv);
  float* biases = reinterpret_cast<float*>(smem + Lay::bias);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * DH;
  const int w = hb * DH;
  const int row_stride = 3 * D;
  const bf16* qsrc = qkv + (size_t)b * L * row_stride + (h / hb) * 3 * w +
                     (h % hb) * DH;
  const bf16* ksrc = qsrc + w;
  const bf16* vsrc = qsrc + 2 * w;
  const uint8_t* pad_b = pad ? pad + (size_t)b * L : nullptr;
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
    cp_tile<DH>(ks, ksrc, kt * BK, L, row_stride);
    cp_tile<DH>(ks + Lay::TILE, vsrc, kt * BK, L, row_stride);
    for (int i = threadIdx.x; i < BK; i += THREADS)
      biases[stage * BK + i] = key_bias(pad_b, kt * BK + i, L);
    cp_async_commit();
  };

  cp_tile<DH>(qs, qsrc, q0, L, row_stride);
  load_kv(0);  // one group: q and the first k/v tile

  // this lane's two rows, and their dropout counters at key 0 (uint32
  // wrap, as in JAX)
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  const uint32_t bh = (uint32_t)b * (uint32_t)H + (uint32_t)h;
  const uint32_t kbase0 = (bh * (uint32_t)L + (uint32_t)row0) * (uint32_t)L;
  const uint32_t kbase1 = (bh * (uint32_t)L + (uint32_t)row1) * (uint32_t)L;
  const float scale2 = scale * LOG2E;  // softmax in base 2

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
        s[j][e] = masked_score(s[j][e], scale2, bias[j * 8 + 2 * qd + (e & 1)]);
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
        if (dropout) {
          const uint32_t key = (uint32_t)(kt * BK + j * 8 + 2 * qd + (e & 1));
          if (hash_bits((e < 2 ? kbase0 : kbase1) + key, seed) < threshold)
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
  const float inv0 = keep_scale / l[0];
  const float inv1 = keep_scale / l[1];
  bf16* orow0 = out + ((size_t)b * L + row0) * D + h * DH + 2 * qd;
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
// fp32: plain FMA kernel (exact checks; not on the serving path)
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
packed_attention_fwd_fp32(const float* __restrict__ qkv,
                          const uint8_t* __restrict__ pad,
                          float* __restrict__ out, int L, int H, int hb,
                          float scale, uint32_t seed, uint32_t threshold,
                          float keep_scale, int dropout) {
  using Lay = Fp32Layout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + Lay::q);
  float* ks = reinterpret_cast<float*>(smem + Lay::k);
  float* vs = reinterpret_cast<float*>(smem + Lay::v);
  float* ss = reinterpret_cast<float*>(smem + Lay::s);
  float* os = reinterpret_cast<float*>(smem + Lay::o);
  float* bias = reinterpret_cast<float*>(smem + Lay::bias);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * DH;
  const int w = hb * DH;
  const int row_stride = 3 * D;
  const float* qsrc = qkv + (size_t)b * L * row_stride + (h / hb) * 3 * w +
                      (h % hb) * DH;
  const float* ksrc = qsrc + w;
  const float* vsrc = qsrc + 2 * w;
  const uint8_t* pad_b = pad ? pad + (size_t)b * L : nullptr;

  load_tile_fp32<DH>(qs, qsrc, q0, L, row_stride);
  for (int i = threadIdx.x; i < BQ * DH; i += THREADS) os[i] = 0.0f;

  // lane pair (2r', 2r'+1) of warp w owns row r = 16w + r'; each lane takes
  // every other column
  const int r = (threadIdx.x / 32) * 16 + (threadIdx.x % 32) / 2;
  const int half = threadIdx.x % 2;
  const uint32_t key_base =
      (((uint32_t)b * (uint32_t)H + (uint32_t)h) * (uint32_t)L +
       (uint32_t)(q0 + r)) * (uint32_t)L;
  float m = -INFINITY;
  float l = 0.0f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile_fp32<DH>(ks, ksrc, k0, L, row_stride);
    load_tile_fp32<DH>(vs, vsrc, k0, L, row_stride);
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
      srow[c] = masked_score(dot, scale, bias[c]);
      tile_max = fmaxf(tile_max, srow[c]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    m = m_new;
    float sum = 0.0f;
    for (int c = half; c < BK; c += 2) {
      float p = expf(srow[c] - m);
      sum += p;
      if (dropout && hash_bits(key_base + (uint32_t)(k0 + c), seed) < threshold)
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
    const float inv = keep_scale / l;
    float* dst = out + ((size_t)b * L + q0 + r) * D + h * DH;
    for (int c = half; c < DH; c += 2) dst[c] = os[r * DH + c] * inv;
  }
}

template <typename T, int DH, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem_bytes, const void* qkv,
                   const void* pad, void* out, int batch, int L, int H, int hb,
                   float scale, uint32_t seed, uint32_t threshold,
                   float keep_scale, int dropout, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BQ - 1) / BQ, H, batch);
  kernel<<<grid, THREADS, smem_bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<const uint8_t*>(pad),
      static_cast<T*>(out), L, H, hb, scale, seed, threshold, keep_scale,
      dropout);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  pad may be null (no key is padded).
extern "C" int mmoe_flash_attention_packed(
    const void* qkv, const void* pad, void* out, int dtype, int batch, int L,
    int n_heads, int hb, int head_dim, float scale, unsigned int seed,
    unsigned int threshold, float keep_scale, int dropout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MMOE_LAUNCH(T, DH, KERNEL, LAYOUT)                                  \
  launch<T, DH>(KERNEL<DH>, LAYOUT<DH>::bytes, qkv, pad, out, batch, L,     \
                n_heads, hb, scale, seed, threshold, keep_scale, dropout, s)
  if (dtype == 1 && head_dim == 64)
    return MMOE_LAUNCH(bf16, 64, packed_attention_fwd_bf16, MmaLayout);
  if (dtype == 1 && head_dim == 128)
    return MMOE_LAUNCH(bf16, 128, packed_attention_fwd_bf16, MmaLayout);
  if (dtype == 0 && head_dim == 64)
    return MMOE_LAUNCH(float, 64, packed_attention_fwd_fp32, Fp32Layout);
  if (dtype == 0 && head_dim == 128)
    return MMOE_LAUNCH(float, 128, packed_attention_fwd_fp32, Fp32Layout);
#undef MMOE_LAUNCH
  return (int)cudaErrorInvalidValue;
}
