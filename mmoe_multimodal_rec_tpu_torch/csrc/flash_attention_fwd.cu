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
// stats[(b*H_total + h0 + h)*L + q] = (m, l) (the global head: under
// tensor parallelism the rank's heads fill their rows of [B, H_total, L]),
// the row max of the base-2 scores
// s*log2(e)/sqrt(dh) and the row sum of exp2(s - m) over all keys.  The
// backward rebuilds p = exp2(s - m) / l exactly as this kernel made it.  A
// single log-sum-exp would not do: an all-pad row has m = -1e9, where fp32
// cannot hold m + log2(l) apart from m.
//
// Bound on this card: at the main path's shapes (text B=128, L=384, D=768,
// H=12; ViT B=64, L=197) a call must move q, k, v once and the output once
// (302 MB text, 77.5 MB ViT) against 58 / 7.6 GFLOP of products: 90 us and
// 23 us at 3.35 TB/s, where the tensor cores would need 59 and 8 us.  With a
// pad mask a row needs only its real keys' k and v rows and products (a
// text row of real length n, n keys), and chip_smoke.py counts the bound
// from what the call's mask needs (67 us for the text shape at real
// lengths spread over [1, L]).
//
// bf16 (the main path), one body for the six instantiations (dh 64 / 128 x
// split with statistics, packed with, packed without): a block is two
// consumer warpgroups, each owning a 64-row q tile of one (b, h), that walk
// the head's key tiles of 64 together, so a K/V tile in shared memory
// serves two q tiles (by design, the bytes copied from L2 into shared
// memory fall from 4.3x the qkv bytes at the text shape to 2.3x, 1.5x with
// skipping; chip_smoke.py's fwd_l2_bytes counts them).  Per
// key tile and warpgroup: S = Q K^T is a wgmma (m64n64k16, both operands
// K-major in shared memory); the online max-shifted softmax in fp32 runs on
// the accumulator in registers; O += P V is a wgmma with P, rounded to
// bf16, as the register A operand (the accumulator's layout is the A
// operand's) and V as the MN-major B operand read through the descriptor's
// transpose.  Every tile lives in shared memory in the 128-byte swizzle,
// written chunk by chunk by cp.async to its swizzled place.  K/V tiles
// stream through a ring of 4 stages, 2 tiles in flight ahead of the one in
// use, issued while the tile's S product runs; each stage has a `full`
// mbarrier, completed by every thread's cp.async arrivals, and an `empty`
// one, completed when every warp is done with the tile, so no tile waits on
// a drain of the pipeline or on a block-wide barrier.  The key biases (0,
// -1e9 for a padded key, -inf past L) are made once a block from the pad
// mask, and classify each key tile: all keys real (no mask work), some
// (masked per element), or none (skipped: its weights are exp2(-1e9 - m) =
// 0 exactly, so skipping changes no bit of the output or of (m, l); a row
// with no real key walks every tile, for uniform weights over the L keys).
// The last key tile's keys past L score -inf (ViT: 59 of its 64 at
// L = 197; an n16 product over its 5 real keys measured no faster, PERF.md).
// exp2 runs as ex2.approx.ftz: a weight below 2^-126 flushes to 0.  Each
// warp stages its normalised 16 output rows through its rows of the q tile
// and stores them 16 bytes a lane.  At dh 64, 2 blocks (16 warps) an SM at
// <= 128 registers, no spill (chip_smoke.py's build phase checks it).
//
// What bounds it now (PERF.md): neither bytes nor operations (2.5-3x
// the bound at the main shapes) but the chain of dependent waits a key
// tile is for its warpgroup: the S product, the softmax's instructions on
// the accumulator, the PV product, with the SM's units far from busy.
// Reordering that chain did not move it: PV of a tile beside S of the next,
// FlashAttention-3's softmax under PV, and ping-pong turns of the two
// warpgroups all measured within 3% of this body (2 stages, 1 ahead, too);
// one or three warpgroups a block, and walking a head's q tiles in rounds,
// lost.
// fp32 inputs take a plain FMA kernel whose scores and partial products go
// through shared memory; it exists for exact checks.
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
//   with lk_pad = L rounded up to 128, keep = bits >= threshold.  A
//   tensor-parallel shard holding heads [h0, h0 + H) of H_total keys on
//   b*H_total + h0 + h in place of b*H + h, so its mask is that slice of
//   the full call's (a data-parallel shard's batch offset is folded into
//   the seed by the caller, models/layers).  The
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
  float2* stats;       // [B, H_total, L] (m, l); may be null
  int L, H, hb, row_stride, group_stride, lk_pad;
  // the dropout counter's head stride and first head: these H heads are
  // [h0, h0 + H) of H_total (a tensor-parallel shard; H_total = H, h0 = 0
  // otherwise)
  uint32_t H_total, h0;
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
// bf16: wgmma kernel, QT consumer warpgroups a block sharing a K/V ring
// ---------------------------------------------------------------------------

constexpr int MT = 64;        // rows of a q tile, keys of a key tile
constexpr int QT = 2;         // consumer warpgroups (64-row q tiles) a block
constexpr int NSTAGE = 4;     // K/V ring stages
constexpr int AHEAD = 2;      // K/V tiles in flight ahead of the one in use
constexpr int WG_THREADS = 128;
constexpr int MMA_THREADS = QT * WG_THREADS;
static_assert(AHEAD >= 1 && AHEAD < NSTAGE, "a stage is refilled only "
              "after the tile before it in the ring is done with");

// How a key tile's keys stand: none real (skipped unless the row has no
// real key at all), all real (no mask work), or some.
enum : uint8_t { TILE_DEAD = 0, TILE_FULL = 1, TILE_PARTIAL = 2 };

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

// 2^x on the special function unit; a result below 2^-126 flushes to 0
// (exp2f's handling of such results costs a compare and two multiplies an
// element)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// mbarriers in shared memory.  `full`: completed by the asynchronous
// arrival of each thread's cp.async copies (noinc: each arrival counts as
// one of the expected ones); `empty`: by one arrival a warp.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
      ::"r"(smem_u32(bar))
      : "memory");
}

// the barrier arrives once every cp.async this thread issued has landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
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

// wgmma: a 64 x N x 16 product of the whole warpgroup, B (and A, or A from
// registers) read from shared memory through a matrix descriptor: start
// address, leading and stride byte offsets, and the 128-byte swizzle.  A
// K-major operand (rows M or N, K along a row): 8-row groups 1024 bytes
// apart; a k16 step starts 32 bytes on inside its 64-column atom (a dh 128
// tile's second atom is 8 KB on).  An MN-major operand (rows K, N along a
// row): 8-row groups of K 1024 bytes apart, 64-column atoms 8 KB apart; a
// k16 step starts 16 rows on.  The accumulator of m64nN holds, for each
// warp's 16 rows, the mma.sync C layout of each n8 column tile
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


// cp.async's writes to shared memory ordered before wgmma's reads (the
// async proxy); after the mbarrier wait that shows they landed
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
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
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

// Shared memory: QT q tiles (each warpgroup's, then its output's staging),
// NSTAGE stages of (k tile, v tile), the ring's mbarriers, then per call
// one class byte a key tile and the key biases (64 a tile).
template <int DH>
struct MmaLayout {
  static constexpr int TILE = MT * DH;  // bf16 a tile
  static constexpr size_t q = 0;
  static constexpr size_t kv = q + sizeof(bf16) * QT * TILE;
  static constexpr size_t bars = kv + sizeof(bf16) * NSTAGE * 2 * TILE;
  static constexpr size_t classes = bars + sizeof(uint64_t) * 2 * NSTAGE;
  __host__ __device__ static size_t biases(int nk) {
    return classes + (nk + 15) / 16 * 16;
  }
  static size_t bytes(int nk) { return biases(nk) + sizeof(float) * MT * nk; }
};

// SPLIT: q/k/v of their own [B, L, D] (head h at column h*DH); else the
// packed layout.  STATS: the softmax statistics are stored for the
// backward.  Three instantiations a head dim: split with statistics (#2),
// packed without (#1 on the serving path, which has no backward) and packed
// with (#1 where qkv needs a gradient, HoME's fine-tuned ViT layers), so a
// profile tells them apart and serving keeps its lower register count.
// At dh 64 the register cap keeps 16 warps an SM in flight (2 blocks of 2
// warpgroups at 128 registers); at dh 128 shared memory allows one block,
// so no cap is set.
template <int DH, bool SPLIT, bool STATS>
__global__ void __launch_bounds__(MMA_THREADS, DH == 64 ? 2 : 1)
attention_fwd_bf16(const Args<bf16> a) {
  using Lay = MmaLayout<DH>;
  constexpr int NO = DH / 8;   // n8 tiles of output per warp
  constexpr int CPR = DH / 8;  // 16-byte chunks a tile row
  // A thread copies column chunk tid % CPR of rows tid / CPR + k*STEP of a
  // 64-row tile: STEP is a multiple of 8, so every chunk of the thread keeps
  // the first one's swizzle and sits k*STEP rows on.
  constexpr int STEP_KV = MMA_THREADS / CPR;
  constexpr int STEP_Q = WG_THREADS / CPR;
  static_assert(MT % STEP_KV == 0 && STEP_KV % 8 == 0 && STEP_Q % 8 == 0,
                "a thread's chunks of a tile share their swizzle");
  extern __shared__ __align__(1024) unsigned char smem_mma[];

  const int L = a.L;
  const int nk = (L + MT - 1) / MT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS;
  const int warp = (tid / 32) % 4;  // in its warpgroup
  const int lane = tid % 32;
  const int g = lane / 4;   // fragment row (and +8)
  const int qd = lane % 4;  // fragment column pair
  const int q0 = (blockIdx.x * QT + wg) * MT;
  const size_t head = (size_t)b * L * a.row_stride +
                      (SPLIT ? (size_t)h * DH
                             : head_col(h, a.hb, a.group_stride, DH));

  bf16* qs = reinterpret_cast<bf16*>(smem_mma + Lay::q) + wg * Lay::TILE;
  bf16* kv = reinterpret_cast<bf16*>(smem_mma + Lay::kv);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_mma + Lay::bars);
  uint64_t* empty = full + NSTAGE;
  uint8_t* classes = smem_mma + Lay::classes;
  float* bias = reinterpret_cast<float*>(smem_mma + Lay::biases(nk));

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], MMA_THREADS);
      mbar_init(&empty[s], QT * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // this warpgroup's q tile, rows past L zero-filled (a warpgroup wholly
  // past L computes on zeros and stores nothing); the first stage's full
  // barrier covers these copies
  {
    const int wt = tid % WG_THREADS;
    const int row = wt / CPR;
    const int col = (wt % CPR) * 8;
    bf16* dst = qs + at(row, col);
    const bf16* src = a.q + head + col;
#pragma unroll
    for (int k = 0; k < MT / STEP_Q; ++k) {
      const int r = q0 + row + k * STEP_Q;
      const bool valid = r < L;
      cp_async16(dst + k * STEP_Q * 64,
                 src + (valid ? (size_t)r * a.row_stride : 0), valid);
    }
  }
  // the key biases, once a block, and each key tile's class (without a
  // pad mask only a last tile reaching past L is partial)
  const uint8_t* pad_b = a.pad ? a.pad + (size_t)b * L : nullptr;
  for (int i = tid; i < nk * MT; i += MMA_THREADS)
    bias[i] = key_bias(pad_b, i, L);
  for (int t = tid; !pad_b && t < nk; t += MMA_THREADS)
    classes[t] = (t + 1) * MT <= L ? TILE_FULL : TILE_PARTIAL;
  __syncthreads();
  bool all_pad = false;
  if (pad_b) {
    int saw_real = 0;
    for (int t = tid / 32; t < nk; t += MMA_THREADS / 32) {
      const bool r0 = bias[t * MT + lane] == 0.0f;
      const bool r1 = bias[t * MT + 32 + lane] == 0.0f;
      const bool any = __any_sync(0xffffffffu, r0 || r1);
      const bool all = __all_sync(0xffffffffu, r0 && r1);
      if (lane == 0)
        classes[t] = any ? (all ? TILE_FULL : TILE_PARTIAL) : TILE_DEAD;
      saw_real |= any;
    }
    // a row with no real key weighs every key below L alike: walk them all
    all_pad = !__syncthreads_or(saw_real);
  }
  auto live = [&](int t) {
    return all_pad || classes[t] != TILE_DEAD;
  };
  auto next_live = [&](int t) {
    while (t < nk && !live(t)) ++t;
    return t;
  };

  // The next live key tile into the next ring stage: every thread its
  // chunks (rows past L zero-filled from row 0's address), then its arrival
  // on the stage's full barrier once they land.  Fills run AHEAD live tiles
  // in front of the walk; each is issued while the S product of the tile
  // AHEAD before it runs, after that tile's wait and proxy fence (the
  // fence waits for the thread's outstanding copies, so it must not follow
  // a fill issued just before).
  const int frow = tid / CPR;
  const int fcol = (tid % CPR) * 8;
  const int fdst = at(frow, fcol);
  int kf = next_live(0);  // the next tile to fill
  int filled = 0;         // live tiles filled so far
  auto fill_next = [&]() {
    if (kf >= nk) return;
    const int stage = filled % NSTAGE;
    // the stage's last tile, `filled - NSTAGE`, is done with
    if (filled >= NSTAGE) mbar_wait(&empty[stage], (filled / NSTAGE - 1) & 1);
    bf16* ks = kv + stage * 2 * Lay::TILE + fdst;
    const int r0 = kf * MT + frow;
    const bf16* kp = a.k + head + fcol;
    const bf16* vp = a.v + head + fcol;
#pragma unroll
    for (int k = 0; k < MT / STEP_KV; ++k) {
      const int r = r0 + k * STEP_KV;
      const bool valid = r < L;
      const size_t off = valid ? (size_t)r * a.row_stride : 0;
      cp_async16(ks + k * STEP_KV * 64, kp + off, valid);
      cp_async16(ks + Lay::TILE + k * STEP_KV * 64, vp + off, valid);
    }
    cp_async_arrive(&full[stage]);
    ++filled;
    kf = next_live(kf + 1);
  };
#pragma unroll
  for (int f = 0; f < AHEAD; ++f) fill_next();

  // this lane's two rows, and their dropout counters at key 0 (uint32
  // wrap, as in JAX)
  const int row0 = q0 + warp * 16 + g;
  // the global head: the dropout counter's and the statistics' row
  const uint32_t bh = (uint32_t)b * a.H_total + a.h0 + (uint32_t)h;
  const uint32_t kbase0 =
      (bh * (uint32_t)L + (uint32_t)row0) * (uint32_t)a.lk_pad;
  const uint32_t kbase1 = kbase0 + 8u * (uint32_t)a.lk_pad;

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};  // this lane's share of the row sums

  // Each live key tile kt, walked i-th: S = Q K^T on wgmma, the next fill
  // issued in its shadow, the online softmax on the accumulator, O += P V
  // on wgmma, then the tile's stage is released.
  constexpr int NS = MT / 8;  // n8 tiles of scores per warp
  for (int kt = next_live(0), i = 0; kt < nk; kt = next_live(kt + 1), ++i) {
    const int stage = i % NSTAGE;
    mbar_wait(&full[stage], (i / NSTAGE) & 1);
    fence_async_smem();
    const bf16* ks = kv + stage * 2 * Lay::TILE;
    const bf16* vs = ks + Lay::TILE;
    float s[NS][4];
    wg_pin<NS>(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(s, kdesc(qs + at(0, kk * 16)), kdesc(ks + at(0, kk * 16)), kk);
    wg_commit();
    fill_next();
    wg_wait0();
    wg_pin<NS>(s);

    // base-2 scores; element e of n8 tile j is row (e < 2 ? g : g + 8),
    // key j*8 + 2*qd + (e & 1)
    float tmax[2] = {-INFINITY, -INFINITY};
    if (all_pad || classes[kt] != TILE_FULL) {
      const float* kb = bias + kt * MT;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = masked_score(s[j][e], a.scale2,
                                 kb[j * 8 + 2 * qd + (e & 1)]);
          tmax[e / 2] = fmaxf(tmax[e / 2], s[j][e]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= a.scale2;
          tmax[e / 2] = fmaxf(tmax[e / 2], s[j][e]);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      // every walked tile holds a key < L, so tmax is finite and alpha is
      // 2^-inf = 0 on the first one
      const float m_new = fmaxf(m[r], tmax[r]);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
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
        float p = ex2(s[j][e] - m[e / 2]);
        l[e / 2] += p;
        if (a.dropout) {
          const uint32_t key = (uint32_t)(kt * MT + j * 8 + 2 * qd + (e & 1));
          if (hash_bits((e < 2 ? kbase0 : kbase1) + key, a.seed) <
              a.threshold)
            p = 0.0f;
        }
        s[j][e] = p;
      }
    }

    // O += P V: the score accumulators of n8 tiles 2kk, 2kk+1, rounded to
    // bf16, are the A operand of keys [16kk, 16kk + 16)
    uint32_t pa[MT / 16][4];
#pragma unroll
    for (int kk = 0; kk < MT / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    wg_pin<NO>(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < MT / 16; ++kk)
      wgmma_rs<DH>(o, pa[kk], mndesc(vs + at(kk * 16, 0)));
    wg_commit();
    wg_wait0();
    wg_pin<NO>(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  }

  // epilogue: full row sums, the statistics, O normalised in registers and
  // staged through this warp's 16 rows of the q tile (their last reader,
  // the final S product, completed before this warp's final PV could), then
  // 16-byte stores of whole rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (STATS && a.stats && qd == 0) {
    float2* st = a.stats + (size_t)bh * L;
    if (row0 < L) st[row0] = make_float2(m[0], l[0]);
    if (row0 + 8 < L) st[row0 + 8] = make_float2(m[1], l[1]);
  }
  const float inv0 = a.keep_scale / l[0];
  const float inv1 = a.keep_scale / l[1];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<uint32_t*>(qs + at(r0, n * 8 + 2 * qd)) =
        pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(qs + at(r0 + 8, n * 8 + 2 * qd)) =
        pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
  __syncwarp();
  const int D = a.H * DH;
  bf16* out = a.out + (size_t)b * L * D + (size_t)h * DH;
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = warp * 16 + i / CPR;
    const int c = (i % CPR) * 8;
    if (q0 + r < L)
      *reinterpret_cast<uint4*>(out + (size_t)(q0 + r) * D + c) =
          *reinterpret_cast<const uint4*>(qs + at(r, c));
  }
}

// The fp32 kernel's tiles: 64 query rows a block, keys in tiles of 64, 4
// warps.
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;


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
  // the global head: the dropout counter's and the statistics' row
  const uint32_t bh = (uint32_t)b * a.H_total + a.h0 + (uint32_t)h;
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

template <int DH, bool SPLIT, bool STATS>
cudaError_t launch_bf16(const Args<bf16>& a, int batch, cudaStream_t stream) {
  const int nk = (a.L + MT - 1) / MT;
  const size_t bytes = MmaLayout<DH>::bytes(nk);
  auto kernel = attention_fwd_bf16<DH, SPLIT, STATS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((nk + QT - 1) / QT, a.H, batch);
  kernel<<<grid, MMA_THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_fp32(const Args<float>& a, int batch, cudaStream_t stream) {
  auto kernel = attention_fwd_fp32<DH>;
  const size_t bytes = Fp32Layout<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.L + BQ - 1) / BQ, a.H, batch);
  kernel<<<grid, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
Args<T> make_args(const void* q, const void* k, const void* v,
                  const void* pad, void* out, void* stats, int L, int H,
                  int hb, int row_stride, int group_stride, int lk_pad,
                  int H_total, int h0, float scale, unsigned int seed,
                  unsigned int threshold, float keep_scale, int dropout) {
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
  a.H_total = (uint32_t)H_total;
  a.h0 = (uint32_t)h0;
  a.scale2 = scale * LOG2E;
  a.seed = seed;
  a.threshold = threshold;
  a.keep_scale = keep_scale;
  a.dropout = dropout;
  return a;
}

template <int DH>
cudaError_t launch_bf16_layout(const Args<bf16>& a, bool split, bool stats,
                               int batch, cudaStream_t s) {
  if (split) return launch_bf16<DH, true, true>(a, batch, s);
  return stats ? launch_bf16<DH, false, true>(a, batch, s)
               : launch_bf16<DH, false, false>(a, batch, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  pad and stats may be null.
// Element strides and offsets: row_stride between rows of q/k/v, head h at
// column (h / hb) * group_stride + (h % hb) * head_dim; lk_pad is the
// dropout counter's key stride; the n_heads heads are [h0, h0 + n_heads) of
// H_total, so the counter is ((b*H_total + h0 + h)*L + q)*lk_pad + k, and
// stats is [B, H_total, L] (the shard's heads' rows written).
extern "C" int mmoe_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* pad, void* out,
    void* stats, int dtype, int batch, int L, int n_heads, int hb,
    int head_dim, int row_stride, int group_stride, int lk_pad, int H_total,
    int h0, float scale, unsigned int seed, unsigned int threshold,
    float keep_scale, int dropout, void* stream) {
  if (h0 < 0 || h0 + n_heads > H_total) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const Args<bf16> a = make_args<bf16>(
        q, k, v, pad, out, stats, L, n_heads, hb, row_stride, group_stride,
        lk_pad, H_total, h0, scale, seed, threshold, keep_scale, dropout);
    // the split layout always stores the statistics (its backward reads
    // them); the packed one only when asked
    const bool split = group_stride == 0 && hb == n_heads;
    if (head_dim == 64)
      return launch_bf16_layout<64>(a, split, stats != nullptr, batch, s);
    if (head_dim == 128)
      return launch_bf16_layout<128>(a, split, stats != nullptr, batch, s);
  } else if (dtype == 0) {
    const Args<float> a = make_args<float>(
        q, k, v, pad, out, stats, L, n_heads, hb, row_stride, group_stride,
        lk_pad, H_total, h0, scale, seed, threshold, keep_scale, dropout);
    if (head_dim == 64) return launch_fp32<64>(a, batch, s);
    if (head_dim == 128) return launch_fp32<128>(a, batch, s);
  }
  return (int)cudaErrorInvalidValue;
}
