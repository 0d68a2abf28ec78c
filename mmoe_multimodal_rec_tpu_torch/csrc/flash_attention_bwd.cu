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
// with delta = rowsum(dp * p) in fp32, as JAX takes it.  FlashAttention-2's
// cheaper equal form (1 - r) * rowsum(dO * O) rounds through the stored O:
// in bf16, a row whose weight sits on one key (p = 1) then leaves ds a bf16
// ulp of dO*v away from 0 in every row, and dk of that key sums it over all
// L rows (5% of the largest dk measured on the card at L = 128, rate 0.1).
//
// Bound on this card (text B=128, L=384, D=768, bf16): it must read q, k,
// v, dO and the statistics and write dq, dk, dv, about 535 MB, 0.16 ms
// at 3.35 TB/s, against 10*B*L^2*D = 145 GFLOP, 0.15 ms at 989 TFLOP/s: it
// is close to balanced.  The design is FlashAttention-2's, deterministic:
// - `dq`: one block of 4 warps per (64 q rows, head, batch row); warp w
//   owns 16 rows and computes S = Q K^T and dP = dO V^T on the tensor cores
//   (mma.sync m16n8k16, bf16 in, fp32 accumulate) with its q/dO fragments,
//   the scores and the dQ accumulator in registers, as the forward does.
//   It walks the key tiles twice (two cp.async stages): first for delta,
//   written out for the next kernel, then for ds and dQ += ds K;
// - `dkdv`: one block of 4 warps per (64 keys, head, batch row); warp w
//   owns 16 keys and computes S^T = K Q^T and dP^T = V dO^T, so p*keep and
//   ds come out in the A-operand layout of dV += (p*keep)^T dO and
//   dK += ds^T Q with no transpose; the q/dO tiles stream through two
//   cp.async stages.
// Two passes instead of fp32 atomics, and every sum in a fixed order, so
// every gradient is the same from run to run.  Both passes rebuild S and
// dP (the dq pass twice), so the card does 18*B*L^2*D operations for the
// 10 the algorithm needs; one fused pass, wgmma and TMA are later work.
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
// bf16: tensor-core kernels with every tile's fragments in registers
// ---------------------------------------------------------------------------

constexpr int MT = 64;            // rows of a q or key tile
constexpr int MWARPS = 4;         // warp w owns rows [16w, 16w + 16)
constexpr int MTHREADS = MWARPS * 32;

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

// Shared memory of both bf16 passes: two resident [64, DH] tiles, two
// stages of two streamed tiles, two stages of three per-row vectors.  Rows
// are padded by 16 bytes so the 8 row addresses of every ldmatrix fall in
// distinct bank groups.
template <int DH>
struct MmaLayout {
  static constexpr int LD = DH + 8;     // bf16 per smem row
  static constexpr int TILE = MT * LD;  // bf16 per 64-row tile
  static constexpr size_t resident = 0;
  static constexpr size_t stages = resident + sizeof(bf16) * 2 * TILE;
  static constexpr size_t vecs = stages + sizeof(bf16) * 4 * TILE;
  static constexpr size_t bytes = vecs + sizeof(float) * 2 * 3 * MT;
};

// rows [row0, row0 + 64) x DH columns of one head into smem by cp.async;
// rows past L are zero-filled.
template <int DH>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src, int row0,
                                        int L, int row_stride) {
  constexpr int LD = MmaLayout<DH>::LD;
  constexpr int CPR = DH / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < MT * CPR; i += MTHREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    const bool valid = row0 + r < L;
    cp_async16(dst + r * LD + c,
               src + (size_t)(valid ? row0 + r : 0) * row_stride + c, valid);
  }
}

// A fragments of this warp's 16 rows of a resident tile, all k16 steps.
template <int DH>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[DH / 16][4],
                                             const bf16* tile) {
  constexpr int LD = MmaLayout<DH>::LD;
  const int lane = threadIdx.x % 32;
  const int row = (threadIdx.x / 32) * 16 + ((lane / 8) % 2) * 8 + lane % 8;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ldmatrix_x4(f[kk], tile + row * LD + kk * 16 + (lane / 16) * 8);
}

// acc[j] (16 x 8 tiles over the 64 rows of `tile`) = A . tile^T, A this
// warp's fragments: the scores of 16 rows against 64 rows of the other
// side (the forward's QK^T).
template <int DH>
__device__ __forceinline__ void rows_dot_tile(float (&acc)[MT / 8][4],
                                              const uint32_t (&f)[DH / 16][4],
                                              const bf16* tile) {
  constexpr int LD = MmaLayout<DH>::LD;
  const int lane = threadIdx.x % 32;
  const int mrow = lane % 8;
  const int mat = lane / 8;
#pragma unroll
  for (int j = 0; j < MT / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < MT / 8; j += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, tile + ((j + mat / 2) * 8 + mrow) * LD + kk * 16 +
                         (mat % 2) * 8);
      mma_bf16(acc[j], f[kk], b[0], b[1]);
      mma_bf16(acc[j + 1], f[kk], b[2], b[3]);
    }
  }
}

// out[n] (16 x DH) += P . tile, P the 16 x 64 C fragments `p` (rounded to
// bf16 as the A operand) and tile [64, DH] (the forward's PV).
template <int DH>
__device__ __forceinline__ void frag_times_tile(float (&out)[DH / 8][4],
                                                const float (&p)[MT / 8][4],
                                                const bf16* tile) {
  constexpr int LD = MmaLayout<DH>::LD;
  const int lane = threadIdx.x % 32;
  const int mrow = lane % 8;
  const int mat = lane / 8;
#pragma unroll
  for (int kk = 0; kk < MT / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < DH / 8; n += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, tile + (kk * 16 + (mat % 2) * 8 + mrow) * LD +
                               (n + mat / 2) * 8);
      mma_bf16(out[n], pa, b[0], b[1]);
      mma_bf16(out[n + 1], pa, b[2], b[3]);
    }
  }
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

// dK, dV: one block of 4 warps per (64 keys, head, batch row); warp w owns
// keys k0 + [16w, 16w + 16) and works on S^T = K Q^T and dP^T = V dO^T, so
// p*keep and ds come out as the A operands of dV += (p*keep)^T dO and
// dK += ds^T Q with no transpose.  The q and dO tiles stream through two
// cp.async stages with their rows' (m, 1/l, delta).
template <int DH, bool PACKED>
__global__ void __launch_bounds__(MTHREADS)
attention_bwd_dkdv_bf16(const Args<bf16> a) {
  using Lay = MmaLayout<DH>;
  constexpr int NS = MT / 8;
  constexpr int NO = DH / 8;
  extern __shared__ __align__(128) unsigned char smem[];
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

  auto load_q = [&](int qt) {
    const int s = qt & 1;
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
    cp_async_commit();
  };

  cp_tile<DH>(ks, a.k + rows.in, k0, L, rows.stride);
  cp_tile<DH>(vs, a.v + rows.in, k0, L, rows.stride);
  load_q(0);  // one group: k, v and the first q/dO tile

  uint32_t kf[DH / 16][4], vf[DH / 16][4];
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = dv[n][0] = dv[n][1] =
        dv[n][2] = dv[n][3] = 0.0f;

  for (int qt = 0; qt < nq; ++qt) {
    cp_async_wait_all();
    __syncthreads();  // tile qt landed; every warp is done with qt - 1
    if (qt == 0) {
      load_a_frags<DH>(kf, ks);
      load_a_frags<DH>(vf, vs);
    }
    if (qt + 1 < nq) load_q(qt + 1);  // overlaps this tile's math
    const bf16* qs = stages + (qt & 1) * 2 * Lay::TILE;
    const bf16* dos = qs + Lay::TILE;
    const float* m = vecs + (qt & 1) * 3 * MT;
    const float* linv = m + MT;
    const float* delta = m + 2 * MT;

    float s[NS][4], dp[NS][4];
    rows_dot_tile<DH>(s, kf, qs);    // S^T: keys x q
    rows_dot_tile<DH>(dp, vf, dos);  // dP^T
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
    frag_times_tile<DH>(dv, s, dos);  // dV += (p*keep)^T dO
    frag_times_tile<DH>(dk, dp, qs);  // dK += ds^T q
  }
  store_rows<DH>(a.dk + rows.in, dk, key0, L, rows.stride, 1.0f);
  store_rows<DH>(a.dv + rows.in, dv, key0, L, rows.stride, a.keep_scale);
}

// dQ (and delta): one block of 4 warps per (64 q rows, head, batch row);
// warp w owns rows q0 + [16w, 16w + 16) and works on S = Q K^T and
// dP = dO V^T as the forward does.  It walks the keys twice through two
// cp.async stages: first for delta = rowsum(dp * p) (written out for the
// dkdv pass), then for ds and dQ += ds K.
template <int DH, bool PACKED>
__global__ void __launch_bounds__(MTHREADS)
attention_bwd_dq_bf16(const Args<bf16> a) {
  using Lay = MmaLayout<DH>;
  constexpr int NS = MT / 8;
  constexpr int NO = DH / 8;
  extern __shared__ __align__(128) unsigned char smem[];
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

  // tile t of the two walks is key tile t % nk, in stage t & 1
  auto load_kv = [&](int t) {
    const int s = t & 1;
    const int kt = t % nk;
    bf16* ks = stages + s * 2 * Lay::TILE;
    cp_tile<DH>(ks, a.k + rows.in, kt * MT, L, rows.stride);
    cp_tile<DH>(ks + Lay::TILE, a.v + rows.in, kt * MT, L, rows.stride);
    for (int i = threadIdx.x; i < MT; i += MTHREADS)
      biases[s * MT + i] = key_bias(pad_b, kt * MT + i, L);
    cp_async_commit();
  };

  cp_tile<DH>(qs, a.q + rows.in, q0, L, rows.stride);
  cp_tile<DH>(dos, a.dout + rows.dout, q0, L, D);
  load_kv(0);  // one group: q, dO and the first k/v tile

  uint32_t qf[DH / 16][4], dof[DH / 16][4];
  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.0f;
  float delta[2] = {0.0f, 0.0f};

  for (int t = 0; t < 2 * nk; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every warp is done with t - 1
    if (t == 0) {
      load_a_frags<DH>(qf, qs);
      load_a_frags<DH>(dof, dos);
    }
    if (t + 1 < 2 * nk) load_kv(t + 1);
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
    const bf16* ks = stages + (t & 1) * 2 * Lay::TILE;
    const bf16* vs = ks + Lay::TILE;
    const float* bias = biases + (t & 1) * MT;

    float s[NS][4], dp[NS][4];
    rows_dot_tile<DH>(s, qf, ks);    // S: q x keys
    rows_dot_tile<DH>(dp, dof, vs);  // dP
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
    if (t >= nk) frag_times_tile<DH>(dq, dp, ks);  // dQ += ds k
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
