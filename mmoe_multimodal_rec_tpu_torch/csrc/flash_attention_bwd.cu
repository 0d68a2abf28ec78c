// Self-attention backward for Hopper (sm_90a), split-q/k/v and packed-qkv.
//
// Replaces two Pallas TPU kernels of mmoe_multimodal_rec_tpu/ops/
// flash_attention.py, which share one body (`_head_bwd`):
// - `_fused_attention_bwd_impl` -> `_bwd_kernel` (the backward of public
//   API `flash_attention`), and, at rate 0, the plain XLA recompute that
//   `_vjp_bwd` runs there instead;
// - `_fused_attention_bwd_packed_impl` -> `_bwd_kernel_packed` (the
//   backward of `flash_attention_packed`: HoME's fine-tuned ViT layers).
// Python wrappers and plain PyTorch versions (`flash_attention_bwd_reference`,
// `flash_attention_packed_bwd_reference`):
// mmoe_multimodal_rec_tpu_torch/ops/flash_attention.py.
//
// Layouts.  Split: q, k, v, dO, dq, dk, dv are [B, L, D] each (head h at
// column h*dh).  Packed: q, k, v are read in place from the
// group-interleaved qkv [B, L, 3D] as the forward reads them (row stride 3D,
// head h at column (h / hb) * 3w + (h % hb) * dh, k and v w = hb*dh columns
// after q), dO is [B, L, D] head-major, and dq, dk, dv are written into one
// dqkv [B, L, 3D] in the same layout, so the projection's backward is one
// matmul.  One template parameter tells the two apart; the split
// instantiation is the code it was before the packed one was added.
//
// What it computes, per (batch row b, head h), from q, k, v [B, L, H*dh],
// the pad mask, the seed, dO and the forward's softmax statistics (m, l)
// (csrc/flash_attention_fwd.cu):
//   p    = exp2(s - m) / l, s the base-2 score with padded keys at -1e9,
//          i.e. the pre-dropout softmax exactly as the forward made it;
//   keep = the forward's keep mask, regenerated from the position hash;
//   dv   = (p*keep)^T dO / (1 - r)             (p*keep cast to the input
//                                                 dtype first, as in JAX)
//   dp   = keep * (dO v^T)
//   ds   = p * (dp - delta) * scale / (1 - r),  cast to the input dtype
//   dq   = ds k,   dk = ds^T q,
// with delta = rowsum(dp * p) in fp32, as JAX takes it, summed from the p
// and dp rebuilt here, so it stays the exact row sum.  FlashAttention-2's
// cheaper equal form (1 - r) * rowsum(dO * O) rounds through the stored O:
// in bf16, a row whose weight sits on one key (p = 1) then leaves ds a bf16
// ulp of dO*v away from 0 in every row, and dk of that key sums it over all
// L rows (5% of the largest dk measured on the card at L = 128, rate 0.1).
//
// What bounds it on this card (text B=128, L=384, D=768, H=12, bf16): not
// the bytes (q, k, v, dO and the statistics in, dq, dk, dv out: 533 MB,
// 0.16 ms at 3.35 TB/s) nor the operations (the algorithm's 10*B*L^2*D =
// 145 GFLOP, 0.15 ms at 989 TFLOP/s), nine times below its time, but
// latency: each 64 x 64 tile step is a chain of dependent waits (the
// tile's copies, a wgmma group, ~30 scalar instructions a score element for
// exp2f, the dropout hash and ds, a second wgmma group) that only other
// blocks hide, so the time follows the warps an SM keeps in flight: dq
// keeps 16 (four one-warpgroup blocks at 128 registers), dkdv 12 (three at
// 168).  Designs that did less work with fewer warps in flight measured
// slower (PERF.md): a thread-block cluster per (b, h) (14 or 10
// units, one hash) and one block per (b, h) kept 8 warps an SM; storing
// keep bits for a later walk cost registers and spilled.  The 128-byte
// swizzle decided wgmma: on the unswizzled core-matrix layout the same
// products were 9-20% slower than mma.sync, swizzled 7-11% faster.
//
// The design is FlashAttention-2's, deterministic, in two launches; every
// product is a wgmma of the block's one warpgroup (m64n64k16 or m64n128k16,
// bf16 in, fp32 accumulate), tiles in shared memory in the 128-byte swizzle:
// - `dq`: one block per (64 q rows, head, batch row), q and dO resident;
//   S = Q K^T and dP = dO V^T take both operands from shared memory, and
//   warp w holds rows [16w, 16w + 16) of each in registers.  It walks the
//   key tiles twice (two cp.async stages): first for delta, written out for
//   the next kernel, then for ds and dQ += ds K, ds the A operand from
//   registers (the accumulator's layout is the A operand's);
// - `dkdv`: one block per (64 keys, head, batch row), k and v resident; it
//   forms S^T = K Q^T and dP^T = V dO^T, so p*keep and ds come out as the
//   register A operands of dV += (p*keep)^T dO and dK += ds^T Q with no
//   transpose; the q/dO tiles stream through two cp.async stages.
// Work: S and dP three times (dq twice, dkdv once), dQ, dK, dV: 18*B*L^2*D
// operations for the algorithm's 10; three exp2f and three hashes a score
// element.  Every sum is in a fixed order, with no atomics, so every
// gradient is the same from run to run: delta, each lane over its 16 keys
// a tile, tile by tile, then over its quad (xor 1, then 2); dQ over the key
// tiles in order and dK, dV over the q tiles in order, in registers; each
// product over its k16 steps, issued in order into one accumulator.
// delta stays exact because it is summed from the same fp32 p and dp*keep
// that ds is formed from, never from the stored output.
// fp32 inputs take a plain kernel of shared-memory tiles and FMA products
// (exact checks; not on the main path).
//
// C interface (ctypes): mmoe_flash_attention_bwd returns cudaError_t as an
// int; 0 means every launch was accepted.  It launches on the given stream,
// does not synchronise and allocates nothing: `delta` is caller-provided
// fp32 scratch [B, H, L].  The bound above counts q, k, v, dO, the
// statistics in and dq, dk, dv out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr float NEG_MASK = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const uint8_t* pad;   // [B, L], 1 = padded key; may be null
  const T* dout;        // dO [B, L, D]
  const float2* stats;  // [B, H, L] (m, l) from the forward
  float* delta;         // [B, H, L] scratch
  T* dq;
  T* dk;
  T* dv;
  int L, H, lk_pad;
  int row_stride, hb, group_stride;  // the packed layout (bf16 only)
  float scale;          // 1 / sqrt(dh)
  uint32_t seed, threshold;
  float keep_scale;     // 1 / (1 - rate)
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

__device__ __forceinline__ float key_bias(const uint8_t* pad_b, int key,
                                          int L) {
  return key >= L ? -INFINITY : (pad_b && pad_b[key]) ? NEG_MASK : 0.0f;
}

// C [M, N] (+)= A(m, k) * B(k, n) over shared memory, fp32 FMA.
// A(m, k) = TA ? A[k*lda + m] : A[m*lda + k];
// B(k, n) = TB ? B[n*ldb + k] : B[k*ldb + n];  C[m*ldc + n].
template <int M, int N, int K, bool TA, bool TB, bool ACC>
__device__ __forceinline__ void block_gemm(float* C, int ldc, const float* A,
                                           int lda, const float* B, int ldb) {
  for (int i = threadIdx.x; i < M * N; i += THREADS) {
    const int m = i / N;
    const int n = i % N;
    float acc = ACC ? C[m * ldc + n] : 0.0f;
    for (int k = 0; k < K; ++k)
      acc += (TA ? A[k * lda + m] : A[m * lda + k]) *
             (TB ? B[n * ldb + k] : B[k * ldb + n]);
    C[m * ldc + n] = acc;
  }
}

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// ---------------------------------------------------------------------------
// fp32: shared-memory tiles and FMA products, 8 warps a block (exact checks)
// ---------------------------------------------------------------------------

// Shared memory of both fp32 passes: four [BT, DH] input tiles (q, dO, k,
// v), the S and dP tiles (which then hold p*keep and ds in place), two
// [BT, DH] accumulators, and per-row/per-key vectors.
template <int DH, int BT>
struct Layout {
  static constexpr int LDT = DH + 4;  // [BT, DH] input tiles
  static constexpr int LDF = BT + 4;  // [BT, BT] tiles
  static constexpr int LDA = DH + 4;  // [BT, DH] accumulators
  static constexpr size_t tile = align128(sizeof(float) * BT * LDT);
  static constexpr size_t ftile = align128(sizeof(float) * BT * LDF);
  static constexpr size_t acc = align128(sizeof(float) * BT * LDA);
  static constexpr size_t vec = align128(sizeof(float) * BT);
  static constexpr size_t qs = 0;
  static constexpr size_t dos = qs + tile;
  static constexpr size_t ks = dos + tile;
  static constexpr size_t vs = ks + tile;
  static constexpr size_t s = vs + tile;   // S, then p*keep
  static constexpr size_t dp = s + ftile;  // dP, then ds
  static constexpr size_t acc0 = dp + ftile;
  static constexpr size_t acc1 = acc0 + acc;
  static constexpr size_t rm = acc1 + acc;  // row max
  static constexpr size_t rl = rm + vec;    // 1 / row sum
  static constexpr size_t rd = rl + vec;    // row delta
  static constexpr size_t kb = rd + vec;    // key bias
  static constexpr size_t bytes = kb + vec;
};

// rows [row0, row0 + BT) x DH of one head into smem (16-byte loads); rows
// past L are zero.
template <int DH, int BT, int LDT>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int L, int row_stride) {
  constexpr int VEC = 4;
  for (int i = threadIdx.x; i < BT * DH / VEC; i += THREADS) {
    const int r = i / (DH / VEC);
    const int c = (i % (DH / VEC)) * VEC;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < L)
      val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) *
                                                       row_stride + c);
    *reinterpret_cast<float4*>(dst + r * LDT + c) = val;
  }
}

// Softmax statistics (row max, 1 / row sum) and, when delta is given,
// delta of the q rows [q0, q0 + BT).
template <int BT>
__device__ __forceinline__ void load_rows(float* rm, float* rl, float* rd,
                                          const float2* stats,
                                          const float* delta, int q0, int L) {
  for (int i = threadIdx.x; i < BT; i += THREADS) {
    const bool valid = q0 + i < L;
    const float2 st = valid ? stats[q0 + i] : make_float2(0.0f, 1.0f);
    rm[i] = st.x;
    rl[i] = 1.0f / st.y;
    if (delta) rd[i] = valid ? delta[q0 + i] : 0.0f;
  }
}

// p of q row `row` at key `key` (s the raw dot product, kbias the key's
// bias, m the row max, linv 1 / row sum), as the forward made it, and
// whether dropout keeps it.
__device__ __forceinline__ float prob(const Args<float>& a, uint32_t bh,
                                      int row, int key, float s, float kbias,
                                      float m, float linv, bool* keep) {
  const float s2 = kbias == 0.0f ? s * a.scale * LOG2E : kbias;
  *keep = true;
  if (a.dropout) {
    const uint32_t ctr =
        (bh * (uint32_t)a.L + (uint32_t)row) * (uint32_t)a.lk_pad +
        (uint32_t)key;
    *keep = hash_bits(ctr, a.seed) >= a.threshold;
  }
  return exp2f(s2 - m) * linv;
}

// The [BT q rows, BT keys] elementwise step, in place: ds over dP and, when
// `want_p`, p*keep over S.  Each thread reads and writes only its own
// elements.
template <int BT, int LDF>
__device__ __forceinline__ void softmax_grad_tile(
    const Args<float>& a, uint32_t bh, int q0, int k0, float* S, float* dP,
    const float* rm, const float* rl, const float* rd, const float* kb,
    bool want_p) {
  const float ds_scale = a.scale * a.keep_scale;
  for (int i = threadIdx.x; i < BT * BT; i += THREADS) {
    const int r = i / BT;
    const int c = i % BT;
    float pd = 0.0f, ds = 0.0f;
    if (q0 + r < a.L) {
      bool keep;
      const float p = prob(a, bh, q0 + r, k0 + c, S[r * LDF + c], kb[c],
                           rm[r], rl[r], &keep);
      const float dp = keep ? dP[r * LDF + c] : 0.0f;
      pd = keep ? p : 0.0f;
      ds = p * (dp - rd[r]) * ds_scale;
    }
    if (want_p) S[r * LDF + c] = pd;
    dP[r * LDF + c] = ds;
  }
}

// This thread's share of rowsum(dp * p) over one [BT, BT] tile: row
// tid / TPR, keys tid % TPR, + TPR, ... (a fixed order).
template <int BT, int LDF>
__device__ __forceinline__ float delta_part(const Args<float>& a,
                                            uint32_t bh, int q0, int k0,
                                            const float* S, const float* dP,
                                            const float* rm, const float* rl,
                                            const float* kb) {
  constexpr int TPR = THREADS / BT;
  const int r = threadIdx.x / TPR;
  float acc = 0.0f;
  if (q0 + r < a.L) {
    for (int c = threadIdx.x % TPR; c < BT; c += TPR) {
      bool keep;
      const float p = prob(a, bh, q0 + r, k0 + c, S[r * LDF + c], kb[c],
                           rm[r], rl[r], &keep);
      if (keep) acc += dP[r * LDF + c] * p;
    }
  }
  return acc;
}

template <int DH, int BT>
__global__ void __launch_bounds__(THREADS, 2)
attention_bwd_dkdv(const Args<float> a) {
  using Lay = Layout<DH, BT>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + Lay::qs);
  float* dos = reinterpret_cast<float*>(smem + Lay::dos);
  float* ks = reinterpret_cast<float*>(smem + Lay::ks);
  float* vs = reinterpret_cast<float*>(smem + Lay::vs);
  float* S = reinterpret_cast<float*>(smem + Lay::s);
  float* dP = reinterpret_cast<float*>(smem + Lay::dp);
  float* dK = reinterpret_cast<float*>(smem + Lay::acc0);
  float* dV = reinterpret_cast<float*>(smem + Lay::acc1);
  float* rm = reinterpret_cast<float*>(smem + Lay::rm);
  float* rl = reinterpret_cast<float*>(smem + Lay::rl);
  float* rd = reinterpret_cast<float*>(smem + Lay::rd);
  float* kb = reinterpret_cast<float*>(smem + Lay::kb);

  const int L = a.L;
  const int k0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = a.H * DH;
  const uint32_t bh = (uint32_t)b * (uint32_t)a.H + (uint32_t)h;
  const size_t base = (size_t)b * L * D + (size_t)h * DH;
  const uint8_t* pad_b = a.pad ? a.pad + (size_t)b * L : nullptr;

  load_tile<DH, BT, Lay::LDT>(ks, a.k + base, k0, L, D);
  load_tile<DH, BT, Lay::LDT>(vs, a.v + base, k0, L, D);
  for (int i = threadIdx.x; i < BT; i += THREADS)
    kb[i] = key_bias(pad_b, k0 + i, L);
  for (int i = threadIdx.x; i < BT * Lay::LDA; i += THREADS)
    dK[i] = dV[i] = 0.0f;

  for (int q0 = 0; q0 < L; q0 += BT) {
    __syncthreads();  // the previous q tile is done with
    load_tile<DH, BT, Lay::LDT>(qs, a.q + base, q0, L, D);
    load_tile<DH, BT, Lay::LDT>(dos, a.dout + base, q0, L, D);
    load_rows<BT>(rm, rl, rd, a.stats + (size_t)bh * L,
                  a.delta + (size_t)bh * L, q0, L);
    __syncthreads();
    block_gemm<BT, BT, DH, false, true, false>(S, Lay::LDF, qs, Lay::LDT,
                                                  ks, Lay::LDT);
    block_gemm<BT, BT, DH, false, true, false>(dP, Lay::LDF, dos, Lay::LDT,
                                                  vs, Lay::LDT);
    __syncthreads();
    softmax_grad_tile<BT, Lay::LDF>(a, bh, q0, k0, S, dP, rm, rl, rd, kb,
                                    true);
    __syncthreads();
    // dV += (p*keep)^T dO,  dK += ds^T q
    block_gemm<BT, DH, BT, true, false, true>(dV, Lay::LDA, S, Lay::LDF,
                                                 dos, Lay::LDT);
    block_gemm<BT, DH, BT, true, false, true>(dK, Lay::LDA, dP, Lay::LDF,
                                                 qs, Lay::LDT);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BT * DH; i += THREADS) {
    const int r = i / DH;
    const int c = i % DH;
    if (k0 + r < L) {
      const size_t g = base + (size_t)(k0 + r) * D + c;
      a.dk[g] = dK[r * Lay::LDA + c];
      a.dv[g] = dV[r * Lay::LDA + c] * a.keep_scale;
    }
  }
}

template <int DH, int BT>
__global__ void __launch_bounds__(THREADS, 2)
attention_bwd_dq(const Args<float> a) {
  using Lay = Layout<DH, BT>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + Lay::qs);
  float* dos = reinterpret_cast<float*>(smem + Lay::dos);
  float* ks = reinterpret_cast<float*>(smem + Lay::ks);
  float* vs = reinterpret_cast<float*>(smem + Lay::vs);
  float* S = reinterpret_cast<float*>(smem + Lay::s);
  float* dP = reinterpret_cast<float*>(smem + Lay::dp);
  float* dQ = reinterpret_cast<float*>(smem + Lay::acc0);
  float* rm = reinterpret_cast<float*>(smem + Lay::rm);
  float* rl = reinterpret_cast<float*>(smem + Lay::rl);
  float* rd = reinterpret_cast<float*>(smem + Lay::rd);
  float* kb = reinterpret_cast<float*>(smem + Lay::kb);

  const int L = a.L;
  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = a.H * DH;
  const uint32_t bh = (uint32_t)b * (uint32_t)a.H + (uint32_t)h;
  const size_t base = (size_t)b * L * D + (size_t)h * DH;
  const uint8_t* pad_b = a.pad ? a.pad + (size_t)b * L : nullptr;

  load_tile<DH, BT, Lay::LDT>(qs, a.q + base, q0, L, D);
  load_tile<DH, BT, Lay::LDT>(dos, a.dout + base, q0, L, D);
  load_rows<BT>(rm, rl, rd, a.stats + (size_t)bh * L, nullptr, q0, L);
  for (int i = threadIdx.x; i < BT * Lay::LDA; i += THREADS) dQ[i] = 0.0f;

  // pass 1: delta = rowsum(dp * p) of this tile's rows, for pass 2 and for
  // the dkdv kernel
  auto load_keys = [&](int k0) {
    load_tile<DH, BT, Lay::LDT>(ks, a.k + base, k0, L, D);
    load_tile<DH, BT, Lay::LDT>(vs, a.v + base, k0, L, D);
    for (int i = threadIdx.x; i < BT; i += THREADS)
      kb[i] = key_bias(pad_b, k0 + i, L);
  };
  float part = 0.0f;
  for (int k0 = 0; k0 < L; k0 += BT) {
    __syncthreads();  // the previous key tile is done with
    load_keys(k0);
    __syncthreads();
    block_gemm<BT, BT, DH, false, true, false>(S, Lay::LDF, qs, Lay::LDT,
                                                  ks, Lay::LDT);
    block_gemm<BT, BT, DH, false, true, false>(dP, Lay::LDF, dos, Lay::LDT,
                                                  vs, Lay::LDT);
    __syncthreads();
    part += delta_part<BT, Lay::LDF>(a, bh, q0, k0, S, dP, rm, rl, kb);
  }
  constexpr int TPR = THREADS / BT;
#pragma unroll
  for (int s = 1; s < TPR; s *= 2)
    part += __shfl_xor_sync(0xffffffffu, part, s);
  if (threadIdx.x % TPR == 0) {
    const int r = threadIdx.x / TPR;
    rd[r] = part;
    if (q0 + r < L) a.delta[(size_t)bh * L + q0 + r] = part;
  }

  // pass 2: ds and dQ
  for (int k0 = 0; k0 < L; k0 += BT) {
    __syncthreads();  // the previous key tile is done with
    load_keys(k0);
    __syncthreads();
    block_gemm<BT, BT, DH, false, true, false>(S, Lay::LDF, qs, Lay::LDT,
                                                  ks, Lay::LDT);
    block_gemm<BT, BT, DH, false, true, false>(dP, Lay::LDF, dos, Lay::LDT,
                                                  vs, Lay::LDT);
    __syncthreads();
    softmax_grad_tile<BT, Lay::LDF>(a, bh, q0, k0, S, dP, rm, rl, rd, kb,
                                    false);
    __syncthreads();
    // dQ += ds k
    block_gemm<BT, DH, BT, false, false, true>(dQ, Lay::LDA, dP, Lay::LDF,
                                                  ks, Lay::LDT);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BT * DH; i += THREADS) {
    const int r = i / DH;
    const int c = i % DH;
    if (q0 + r < L)
      a.dq[base + (size_t)(q0 + r) * D + c] = dQ[r * Lay::LDA + c];
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma kernels, one warpgroup (4 warps, 64 rows) a block
// ---------------------------------------------------------------------------

constexpr int MT = 64;            // rows of a q or key tile
constexpr int MWARPS = 4;         // warp w holds rows [16w, 16w + 16)
constexpr int MTHREADS = MWARPS * 32;
constexpr int NSTAGE = 2;         // cp.async stages of the streamed tiles

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

// every committed group but the newest N has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Element (r, c) of a [64, W] bf16 tile in shared memory, in wgmma's
// 128-byte swizzle: the tile is W/64 atoms of [64 rows, 64 columns], a row
// 128 bytes, and the 16-byte chunk c/8 of row r sits at chunk (c/8) ^ (r%8)
// of its row, so the 8 rows of a core matrix fall in distinct banks.
// Tiles start on 1024-byte boundaries (the swizzle is of address bits).
__device__ __forceinline__ int at(int r, int c) {
  return (c >> 6) * (MT * 64) + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) +
         (c & 7);
}

// Shared memory of both bf16 passes: two resident [64, DH] tiles, NSTAGE
// stages of two streamed tiles, NSTAGE stages of up to three per-row
// vectors.
template <int DH>
struct MmaLayout {
  static constexpr int TILE = MT * DH;  // bf16 a tile
  static constexpr size_t resident = 0;
  static constexpr size_t stages = resident + sizeof(bf16) * 2 * TILE;
  static constexpr size_t vecs = stages + sizeof(bf16) * NSTAGE * 2 * TILE;
  static constexpr size_t bytes = vecs + sizeof(float) * NSTAGE * 3 * MT;
};

// rows [row0, row0 + 64) x DH columns of one head into smem by cp.async;
// rows past L are zero-filled.
template <int DH>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src, int row0,
                                        int L, int row_stride) {
  constexpr int CPR = DH / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < MT * CPR; i += MTHREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    const bool valid = row0 + r < L;
    cp_async16(dst + at(r, c),
               src + (size_t)(valid ? row0 + r : 0) * row_stride + c, valid);
  }
}

// The warp's 16 x 64 accumulator `p` rounded to bf16 as the A fragment of
// k16 step kk (the accumulator of one n8 column tile and the A operand of a
// k16 step share the mma.sync layout, so S -> P and dP -> dS need no
// shuffle).
__device__ __forceinline__ void to_a_frag(uint32_t (&pa)[4],
                                          const float (&p)[MT / 8][4],
                                          int kk) {
  pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
  pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
  pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
  pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
}

// wgmma: a 64 x N x 16 product of the whole warpgroup, B (and A, or A from
// registers) read from shared memory through a matrix descriptor: start
// address, leading and stride byte offsets, and the 128-byte swizzle.  A
// K-major operand (rows M or N, K along a row): 8-row groups 1024 bytes
// apart; a k16 step starts 32 bytes on inside its 64-column atom (a dh 128
// tile's second atom is 8 KB on).  An MN-major operand (rows K, M or N
// along a row): 8-row groups of K 1024 bytes apart, 64-column atoms 8 KB
// apart; a k16 step starts 16 rows on.  The accumulator of m64nN holds, for
// each warp's 16 rows, the mma.sync C layout of each n8 column tile
// (float[N/8][4]); an A operand from registers is the mma.sync A layout of
// the warp's 16 rows.
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t kdesc(const bf16* p) {
  return wg_desc(p, 16, 1024);
}

__device__ __forceinline__ uint64_t mndesc(const bf16* p) {
  return wg_desc(p, MT * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// cp.async's writes to shared memory made visible to wgmma's reads (the
// async proxy); before the barrier that publishes them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the accumulator's registers are written by wgmma behind the compiler's
// back: pin them across issue and wait
template <int N>
__device__ __forceinline__ void wg_pin(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    asm volatile("" : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]),
                 "+f"(d[j][3])::"memory");
}

#define WG_D8(d, j)                                                      \
  "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3]),            \
      "+f"(d[j + 1][0]), "+f"(d[j + 1][1]), "+f"(d[j + 1][2]),           \
      "+f"(d[j + 1][3])
#define WG_D32(d) WG_D8(d, 0), WG_D8(d, 2), WG_D8(d, 4), WG_D8(d, 6)
#define WG_D64(d) WG_D32(d), WG_D8(d, 8), WG_D8(d, 10), WG_D8(d, 12), \
                  WG_D8(d, 14)
#define WG_R32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define WG_R64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 64) (+)= A . B^T, A and B K-major in shared memory; acc = 0
// overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[MT / 8][4], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(d)
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x N) += A . B, A this warp's 16 rows from registers, B MN-major
// in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(N == 64 || N == 128, "m64n64 or m64n128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_D64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// s = A0 . B0^T and dp = A1 . B1^T over DH, the four [64, DH] tiles
// K-major in shared memory: the scores and dP of the block's 64 rows
// against 64 rows of the other side, one commit group, k16 steps in order.
template <int DH>
__device__ __forceinline__ void scores_wg(float (&s)[MT / 8][4],
                                          float (&dp)[MT / 8][4],
                                          const bf16* a0, const bf16* b0,
                                          const bf16* a1, const bf16* b1) {
  wg_pin<MT / 8>(s);
  wg_pin<MT / 8>(dp);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss(s, kdesc(a0 + at(0, kk * 16)), kdesc(b0 + at(0, kk * 16)), kk);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss(dp, kdesc(a1 + at(0, kk * 16)), kdesc(b1 + at(0, kk * 16)), kk);
  wg_commit();
  wg_wait0();
  wg_pin<MT / 8>(s);
  wg_pin<MT / 8>(dp);
}

// Issue out (64 x DH) += P . tile, P [64, 64] from the A fragments `pa`
// (k16 steps in order), tile [64, DH] MN-major in shared memory; the
// caller fences, commits and waits.
template <int DH>
__device__ __forceinline__ void frag_times_wg(float (&out)[DH / 8][4],
                                              const uint32_t (&pa)[MT / 16][4],
                                              const bf16* tile) {
#pragma unroll
  for (int kk = 0; kk < MT / 16; ++kk)
    wgmma_rs<DH>(out, pa[kk], mndesc(tile + at(kk * 16, 0)));
}

// Where one (b, h) head's rows start: q, k, v (and dq, dk, dv), with their
// row stride, and dO, whose row stride is D.
template <int DH, bool PACKED>
struct HeadRows {
  size_t in, dout;
  int stride;
  __device__ __forceinline__ HeadRows(const Args<bf16>& a, int b, int h) {
    const int D = a.H * DH;
    stride = PACKED ? a.row_stride : D;
    const size_t col = PACKED ? (size_t)(h / a.hb) * a.group_stride +
                                    (size_t)(h % a.hb) * DH
                              : (size_t)h * DH;
    in = (size_t)b * a.L * stride + col;
    dout = (size_t)b * a.L * D + (size_t)h * DH;
  }
};

// Store a 16 x DH fp32 fragment (times `scale`) as bf16 rows r0, r0 + 8,
// `stride` elements apart (rows >= L skipped).
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst,
                                           const float (&o)[DH / 8][4],
                                           int r0, int L, int stride,
                                           float scale) {
  const int qd = threadIdx.x % 4;
  bf16* row0 = dst + (size_t)r0 * stride + 2 * qd;
  bf16* row1 = row0 + (size_t)8 * stride;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(row0 + n * 8) =
          pack_bf16(o[n][0] * scale, o[n][1] * scale);
    if (r0 + 8 < L)
      *reinterpret_cast<uint32_t*>(row1 + n * 8) =
          pack_bf16(o[n][2] * scale, o[n][3] * scale);
  }
}

// dK, dV: one block (one warpgroup) per (64 keys, head, batch row); warp w
// holds keys k0 + [16w, 16w + 16) of S^T = K Q^T and dP^T = V dO^T, so
// p*keep and ds come out as the A operands of dV += (p*keep)^T dO and
// dK += ds^T Q with no transpose.  The q and dO tiles stream through
// NSTAGE cp.async stages with their rows' (m, 1/l, delta).  At dh 64 it is
// built for 3 blocks an SM (168 registers); at dh 128 shared memory allows
// 2, so no register cap is set.
template <int DH, bool PACKED>
__global__ void __launch_bounds__(MTHREADS, DH == 64 ? 3 : 1)
attention_bwd_dkdv_bf16(const Args<bf16> a) {
  using Lay = MmaLayout<DH>;
  constexpr int NS = MT / 8;
  constexpr int NO = DH / 8;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem + Lay::resident);
  bf16* vs = ks + Lay::TILE;
  bf16* stages = reinterpret_cast<bf16*>(smem + Lay::stages);
  float* vecs = reinterpret_cast<float*>(smem + Lay::vecs);

  const int L = a.L;
  const int k0 = blockIdx.x * MT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = a.H * DH;
  const uint32_t bh = (uint32_t)b * (uint32_t)a.H + (uint32_t)h;
  const HeadRows<DH, PACKED> rows(a, b, h);
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int qd = lane % 4;
  const int key0 = k0 + (threadIdx.x / 32) * 16 + g;  // and key0 + 8
  const uint8_t* pad_b = a.pad ? a.pad + (size_t)b * L : nullptr;
  const float kb[2] = {key_bias(pad_b, key0, L),
                       key_bias(pad_b, key0 + 8, L)};
  const float scale2 = a.scale * LOG2E;
  const float ds_scale = a.scale * a.keep_scale;
  const int nq = (L + MT - 1) / MT;

  // q tile qt into stage qt % NSTAGE, one commit group (empty past nq)
  auto load_q = [&](int qt) {
    if (qt < nq) {
      const int s = qt % NSTAGE;
      bf16* qs = stages + s * 2 * Lay::TILE;
      cp_tile<DH>(qs, a.q + rows.in, qt * MT, L, rows.stride);
      cp_tile<DH>(qs + Lay::TILE, a.dout + rows.dout, qt * MT, L, D);
      float* v = vecs + s * 3 * MT;
      for (int i = threadIdx.x; i < MT; i += MTHREADS) {
        const int q = qt * MT + i;
        const bool valid = q < L;
        // a q row past L gets m = inf, 1/l = 0: p = 0 there
        const float2 st = valid ? a.stats[(size_t)bh * L + q]
                                : make_float2(INFINITY, 1.0f);
        v[i] = st.x;
        v[MT + i] = valid ? 1.0f / st.y : 0.0f;
        v[2 * MT + i] = valid ? a.delta[(size_t)bh * L + q] : 0.0f;
      }
    }
    cp_async_commit();
  };

  cp_tile<DH>(ks, a.k + rows.in, k0, L, rows.stride);
  cp_tile<DH>(vs, a.v + rows.in, k0, L, rows.stride);
  // group 0: k, v and q tile 0; then q tiles 1 .. NSTAGE - 2
#pragma unroll
  for (int qt = 0; qt < NSTAGE - 1; ++qt) load_q(qt);

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = dv[n][0] = dv[n][1] =
        dv[n][2] = dv[n][3] = 0.0f;

  for (int qt = 0; qt < nq; ++qt) {
    cp_async_wait<NSTAGE - 2>();
    fence_async_smem();
    __syncthreads();  // tile qt landed; every warp is done with qt - 1
    load_q(qt + NSTAGE - 1);  // into qt - 1's stage; overlaps this tile
    const bf16* qs = stages + (qt % NSTAGE) * 2 * Lay::TILE;
    const bf16* dos = qs + Lay::TILE;
    const float* m = vecs + (qt % NSTAGE) * 3 * MT;
    const float* linv = m + MT;
    const float* delta = m + 2 * MT;

    float s[NS][4], dp[NS][4];
    scores_wg<DH>(s, dp, ks, qs, vs, dos);  // S^T: keys x q, and dP^T
    // element e of tile j: key (e < 2 ? key0 : key0 + 8), q column
    // j*8 + 2*qd + (e & 1)
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * qd + (e & 1);
        const float bias = kb[e / 2];
        const float s2 = bias == 0.0f ? s[j][e] * scale2 : bias;
        const float p = exp2f(s2 - m[c]) * linv[c];
        bool keep = true;
        if (a.dropout) {
          const uint32_t ctr =
              (bh * (uint32_t)L + (uint32_t)(qt * MT + c)) *
                  (uint32_t)a.lk_pad +
              (uint32_t)(key0 + (e / 2) * 8);
          keep = hash_bits(ctr, a.seed) >= a.threshold;
        }
        dp[j][e] = p * ((keep ? dp[j][e] : 0.0f) - delta[c]) * ds_scale;
        s[j][e] = keep ? p : 0.0f;
      }
    }
    uint32_t pa[MT / 16][4], da[MT / 16][4];
#pragma unroll
    for (int kk = 0; kk < MT / 16; ++kk) {
      to_a_frag(pa[kk], s, kk);
      to_a_frag(da[kk], dp, kk);
    }
    wg_pin<NO>(dv);
    wg_pin<NO>(dk);
    wg_fence();
    frag_times_wg<DH>(dv, pa, dos);  // dV += (p*keep)^T dO
    frag_times_wg<DH>(dk, da, qs);   // dK += ds^T q
    wg_commit();
    wg_wait0();
    wg_pin<NO>(dv);
    wg_pin<NO>(dk);
  }
  store_rows<DH>(a.dk + rows.in, dk, key0, L, rows.stride, 1.0f);
  store_rows<DH>(a.dv + rows.in, dv, key0, L, rows.stride, a.keep_scale);
}

// dQ (and delta): one block (one warpgroup) per (64 q rows, head, batch
// row); warp w holds rows q0 + [16w, 16w + 16) of S = Q K^T and
// dP = dO V^T.  It walks the keys twice through NSTAGE cp.async stages:
// first for delta = rowsum(dp * p) (written out for the dkdv pass), then
// for ds and dQ += ds K.  At dh 64 it is built for 4 blocks an SM (128
// registers); at dh 128 shared memory allows 2, so no register cap is set.
template <int DH, bool PACKED>
__global__ void __launch_bounds__(MTHREADS, DH == 64 ? 4 : 1)
attention_bwd_dq_bf16(const Args<bf16> a) {
  using Lay = MmaLayout<DH>;
  constexpr int NS = MT / 8;
  constexpr int NO = DH / 8;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + Lay::resident);
  bf16* dos = qs + Lay::TILE;
  bf16* stages = reinterpret_cast<bf16*>(smem + Lay::stages);
  float* biases = reinterpret_cast<float*>(smem + Lay::vecs);

  const int L = a.L;
  const int q0 = blockIdx.x * MT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = a.H * DH;
  const uint32_t bh = (uint32_t)b * (uint32_t)a.H + (uint32_t)h;
  const HeadRows<DH, PACKED> rows(a, b, h);
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int qd = lane % 4;
  const int row0 = q0 + (threadIdx.x / 32) * 16 + g;  // and row0 + 8
  const uint8_t* pad_b = a.pad ? a.pad + (size_t)b * L : nullptr;
  const float scale2 = a.scale * LOG2E;
  const float ds_scale = a.scale * a.keep_scale;
  const int nk = (L + MT - 1) / MT;

  float m[2], linv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    const float2 st = r < L ? a.stats[(size_t)bh * L + r]
                            : make_float2(INFINITY, 1.0f);
    m[i] = st.x;
    linv[i] = r < L ? 1.0f / st.y : 0.0f;
  }

  // tile t of the two walks is key tile t % nk, in stage t % NSTAGE; one
  // commit group (empty past the walks)
  auto load_kv = [&](int t) {
    if (t < 2 * nk) {
      const int s = t % NSTAGE;
      const int kt = t % nk;
      bf16* ks = stages + s * 2 * Lay::TILE;
      cp_tile<DH>(ks, a.k + rows.in, kt * MT, L, rows.stride);
      cp_tile<DH>(ks + Lay::TILE, a.v + rows.in, kt * MT, L, rows.stride);
      for (int i = threadIdx.x; i < MT; i += MTHREADS)
        biases[s * MT + i] = key_bias(pad_b, kt * MT + i, L);
    }
    cp_async_commit();
  };

  cp_tile<DH>(qs, a.q + rows.in, q0, L, rows.stride);
  cp_tile<DH>(dos, a.dout + rows.dout, q0, L, D);
  // group 0: q, dO and the first k/v tile; then tiles 1 .. NSTAGE - 2
#pragma unroll
  for (int t = 0; t < NSTAGE - 1; ++t) load_kv(t);

  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.0f;
  float delta[2] = {0.0f, 0.0f};

  for (int t = 0; t < 2 * nk; ++t) {
    cp_async_wait<NSTAGE - 2>();
    fence_async_smem();
    __syncthreads();  // tile t landed; every warp is done with t - 1
    load_kv(t + NSTAGE - 1);  // into t - 1's stage; overlaps this tile
    if (t == nk) {
      // delta of this lane's rows: the sum over its quad
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
        delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
        if (qd == 0 && row0 + 8 * i < L)
          a.delta[(size_t)bh * L + row0 + 8 * i] = delta[i];
      }
    }
    const int k0 = (t % nk) * MT;
    const bf16* ks = stages + (t % NSTAGE) * 2 * Lay::TILE;
    const bf16* vs = ks + Lay::TILE;
    const float* bias = biases + (t % NSTAGE) * MT;

    float s[NS][4], dp[NS][4];
    scores_wg<DH>(s, dp, qs, ks, dos, vs);  // S: q x keys, and dP
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * qd + (e & 1);
        const float s2 = bias[c] == 0.0f ? s[j][e] * scale2 : bias[c];
        const float p = exp2f(s2 - m[e / 2]) * linv[e / 2];
        bool keep = true;
        if (a.dropout) {
          const uint32_t ctr =
              (bh * (uint32_t)L + (uint32_t)(row0 + (e / 2) * 8)) *
                  (uint32_t)a.lk_pad +
              (uint32_t)(k0 + c);
          keep = hash_bits(ctr, a.seed) >= a.threshold;
        }
        const float dpk = keep ? dp[j][e] : 0.0f;
        if (t < nk)
          delta[e / 2] += dpk * p;
        else
          dp[j][e] = p * (dpk - delta[e / 2]) * ds_scale;
      }
    }
    if (t >= nk) {  // dQ += ds k
      uint32_t da[MT / 16][4];
#pragma unroll
      for (int kk = 0; kk < MT / 16; ++kk) to_a_frag(da[kk], dp, kk);
      wg_pin<NO>(dq);
      wg_fence();
      frag_times_wg<DH>(dq, da, ks);
      wg_commit();
      wg_wait0();
      wg_pin<NO>(dq);
    }
  }
  store_rows<DH>(a.dq + rows.in, dq, row0, L, rows.stride, 1.0f);
}

template <int DH, int BT>
cudaError_t launch_fp32(const Args<float>& a, int batch, cudaStream_t stream) {
  using Lay = Layout<DH, BT>;
  const dim3 grid((a.L + BT - 1) / BT, a.H, batch);
  // dq first: it writes delta, which dkdv reads
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq<DH, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Lay::bytes);
  if (err != cudaSuccess) return err;
  attention_bwd_dq<DH, BT><<<grid, THREADS, Lay::bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_dkdv<DH, BT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Lay::bytes);
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv<DH, BT><<<grid, THREADS, Lay::bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int DH, bool PACKED>
cudaError_t launch_bf16(const Args<bf16>& a, int batch, cudaStream_t stream) {
  using Lay = MmaLayout<DH>;
  const dim3 grid((a.L + MT - 1) / MT, a.H, batch);
  // dq first: it writes delta, which dkdv reads
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_bf16<DH, PACKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lay::bytes);
  if (err != cudaSuccess) return err;
  attention_bwd_dq_bf16<DH, PACKED><<<grid, MTHREADS, Lay::bytes, stream>>>(
      a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_dkdv_bf16<DH, PACKED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Lay::bytes);
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_bf16<DH, PACKED>
      <<<grid, MTHREADS, Lay::bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
Args<T> make_args(const void* q, const void* k, const void* v,
                  const void* pad, const void* dout,
                  const void* stats, void* delta, void* dq, void* dk,
                  void* dv, int L, int H, int lk_pad, float scale,
                  unsigned int seed, unsigned int threshold, float keep_scale,
                  int dropout) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.pad = static_cast<const uint8_t*>(pad);
  a.dout = static_cast<const T*>(dout);
  a.stats = static_cast<const float2*>(stats);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<T*>(dq);
  a.dk = static_cast<T*>(dk);
  a.dv = static_cast<T*>(dv);
  a.L = L;
  a.H = H;
  a.lk_pad = lk_pad;
  // the split layout; the packed entry point sets its own
  a.row_stride = 0;
  a.hb = H;
  a.group_stride = 0;
  a.scale = scale;
  a.seed = seed;
  a.threshold = threshold;
  a.keep_scale = keep_scale;
  a.dropout = dropout;
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, dout, dq, dk, dv are
// [B, L, n_heads*head_dim] contiguous; pad [B, L] may be null; stats
// [B, n_heads, L] float2; delta [B, n_heads, L] fp32 scratch.
extern "C" int mmoe_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* pad,
    const void* dout, const void* stats, void* delta,
    void* dq, void* dk, void* dv, int dtype, int batch, int L, int n_heads,
    int head_dim, int lk_pad, float scale, unsigned int seed,
    unsigned int threshold, float keep_scale, int dropout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const Args<bf16> a = make_args<bf16>(q, k, v, pad, dout, stats, delta,
                                         dq, dk, dv, L, n_heads, lk_pad,
                                         scale, seed, threshold, keep_scale,
                                         dropout);
    if (head_dim == 64) return launch_bf16<64, false>(a, batch, s);
    if (head_dim == 128) return launch_bf16<128, false>(a, batch, s);
  } else if (dtype == 0) {
    const Args<float> a = make_args<float>(q, k, v, pad, dout, stats, delta,
                                           dq, dk, dv, L, n_heads, lk_pad,
                                           scale, seed, threshold,
                                           keep_scale, dropout);
    if (head_dim == 64) return launch_fp32<64, 64>(a, batch, s);
    // dh 128 takes 32-row tiles to stay inside 227 KB of shared memory
    if (head_dim == 128) return launch_fp32<128, 32>(a, batch, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The packed backward, bf16 only: qkv and dqkv [B, L, 3D] in the
// group-interleaved layout (hb heads a group), dout [B, L, n_heads*head_dim]
// head-major; pad [B, L] may be null; stats [B, n_heads, L] float2 from the
// forward; delta [B, n_heads, L] fp32 scratch.
extern "C" int mmoe_flash_attention_bwd_packed(
    const void* qkv, const void* pad, const void* dout, const void* stats,
    void* delta, void* dqkv, int dtype, int batch, int L, int n_heads, int hb,
    int head_dim, int lk_pad, float scale, unsigned int seed,
    unsigned int threshold, float keep_scale, int dropout, void* stream) {
  if (dtype != 1 || hb <= 0 || n_heads % hb) return (int)cudaErrorInvalidValue;
  const size_t w = (size_t)hb * head_dim;
  const bf16* in = static_cast<const bf16*>(qkv);
  bf16* out = static_cast<bf16*>(dqkv);
  Args<bf16> a = make_args<bf16>(in, in + w, in + 2 * w, pad, dout, stats,
                                 delta, out, out + w, out + 2 * w, L, n_heads,
                                 lk_pad, scale, seed, threshold, keep_scale,
                                 dropout);
  a.row_stride = 3 * n_heads * head_dim;
  a.hb = hb;
  a.group_stride = (int)(3 * w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch_bf16<64, true>(a, batch, s);
  if (head_dim == 128) return launch_bf16<128, true>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}
