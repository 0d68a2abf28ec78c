// Fused LoRA-input dropout and thin matmuls for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of mmoe_multimodal_rec_tpu/ops/
// lora_dropout.py (public API `lora_dropout_matmul`):
// - `_fwd_impl` -> `_fwd_kernel`:  t  = (keep * h * inv) @ A        [M, r]
// - `_da_impl`  -> `_da_kernel`:   dA = (keep * h * inv)^T @ dt     [D, r]
// - `_dh_impl`  -> `_dh_kernel`:   dh = keep * (dt @ A^T) * inv     [M, D]
// Python wrappers and plain PyTorch versions:
// mmoe_multimodal_rec_tpu_torch/ops/lora_dropout.py.
//
// h and dh are [M, D], A is [D, r], t and dt are [M, r], one dtype T (bf16
// or fp32), row-major.  Products accumulate in fp32.  The dropped input is
// (keep ? T(h * h_scale) : 0), h_scale = 1/(1-rate) rounded to T, as the JAX
// kernels multiply in h's dtype; dh is (keep ? g * g_scale : 0) rounded to
// T, g_scale the fp32 1/(1-rate).  The keep mask is HashDropout's: the
// murmur3-finalizer hash of the flat index row*D + col (uint32 wrap),
// keep = bits >= threshold.  It is computed in registers wherever h or dh
// is touched, so the dropped [M, D] tensor is never written.
//
// What bounds them on this card.  At the main path's shape (M = 49152 rows
// = 128 chunks x 384 tokens, D = 768, r = 8, bf16) each kernel reads or
// writes one [M, D] tensor (75.5 MB) and moves little else (t/dt 0.8 MB):
// 23 us at 3.35 TB/s.  The product is 2*M*D*r = 0.6 GFLOP, under 1 us on
// the tensor cores.  So bytes would bound them, but the per-element work
// takes longer than the bytes: the SMs execute 64 integer lanes a clock
// (IMAD included), so at 37.7 M elements every integer instruction an
// element costs ~2.3 us at 1.98 GHz.  The first port spent ~26
// instructions an element (the fp32 round trip, the hash with one multiply
// per index, 8 fp32 FMAs), and dA also a 66 KB shared epilogue per 256
// rows.  The design below needs 10 integer instructions an element for the
// mask and the masking (the hash's 2 shifts, 3 xors, 2 multiplies and
// compare; the index add; the masking AND); the compiled loops spend 14-16
// with addressing and register moves (dh's 11: it loads nothing an
// element), and on an H100 SXM at 700 W the kernels take 33 (fwd), 34 + 2
// (dA and its reduction) and 30 (dh) us of device time: integer
// throughput, not bytes, still bounds them.  Moving the shifts to the
// multiply pipe (`__umulhi`) or unrolling the loop twice (no register
// moves, twice the code) made fwd and dA slower.
//
// The bf16 design (the main path's kernels):
// - Products on the tensor cores, `mma.sync.m16n8k16` bf16 x bf16 -> fp32,
//   one n tile per 8 columns of r (r = 8: one; a ragged last tile is
//   padded with zero columns).  A product's k order is free as long as both
//   operands take it, so each lane feeds the 16-byte vectors it loaded
//   straight into its fragments (below), and nothing is staged but A.
// - The hash for fewer instructions, bit for bit the same keep mask
//   (`keep_x`): x = i * kGolden + seed is a per-row base plus per-column
//   constants (no multiply an element), and the hash's last xor-shift folds
//   into the compare.
// - The dropped input on packed bf16 (`drop_pair`): h * h_scale on a bf16
//   pair with one `mul.rn.bf16x2`, the dropped halves zeroed with a mask.
//   h_scale = 1/(1-rate) >= 1 is a bf16 value, so the product of two bf16
//   values is exact in fp32 (16 significant bits, its last bit at 2^-140 or
//   above, fp32's smallest being 2^-149; an overflow is inf either way):
//   rounding it once to bf16 gives the bits of an fp32 multiply followed
//   by rounding to bf16, which is what the plain version computes.
// - Loads: 16 bytes a lane, 8 a lane in flight and the next step's 8
//   sent before the current step is computed, with no bound checks where
//   the step lies inside the tensors; at most 128 registers (2 blocks of 8
//   warps an SM), checked by chip_smoke.py's spill check.
// - fwd (`lora_fwd_mma_kernel`): a warp takes 16-row tiles; per 128-column
//   step lane (g, c) of the warp (g = lane / 4, c = lane % 4) loads rows
//   g and g + 8, columns 32q + 8c .. +8 (q < 4): each vector's first four
//   values are one product's A-fragment slots (k = 2c, 2c + 1, 2c + 8,
//   2c + 9), its last four the next product's.  The block keeps A^T's
//   r tile in shared memory (12.8 KB at D = 768), rows padded so that one
//   16-byte read a lane gives both products' B fragments without bank
//   conflicts.  Tiles go round-robin over the blocks first and then over a
//   block's warps, so every SM gets the same share of rows.
// - dA (`lora_da_mma_kernel`): the product is (keep*h)^T @ dt, so A's rows
//   are columns of h and its k is rows of h.  A lane loads one 16-byte
//   vector (8 columns) of each of four rows (2c, 2c + 1, 2c + 8, 2c + 9 of
//   16) and pairs them with `prmt`: 4 products a 16 rows, the sums staying
//   in 16 accumulator registers a lane for the block's whole row range.  A
//   block is 8 warps on one 64-column slab and one long row range; the
//   card holds every block at once (as many ranges a slab as fit), so each
//   SM sums the same number of rows.  The 8 warps' accumulators meet once
//   in 16 KB of shared memory, in warp order, and the block writes fp32
//   partials [ranges, D, r]; `lora_da_reduce_kernel` sums the ranges in
//   order.  No atomics: two calls give the same bits.
// - dh (`lora_dh_mma_kernel`): dt @ A^T with dt's 16-row tile as the A
//   operand (`mma.sync.m16n8k8`, k = r = 8 in one step; a ragged r pads k
//   with zeros, a larger one takes more steps) and A's rows as B.  Each warp
//   owns a slab of 128 columns, keeps its 16 B fragments in registers and
//   walks 16-row tiles down M, so A is read once a warp and dt 4 bytes a
//   lane a row.  Product j of a 32-column group maps its n = 2c + e to
//   column 8c + 2j + e, so a lane's 16 sums are 8 neighbouring columns of
//   two rows: each is scaled in fp32, rounded to bf16 in pairs, masked by
//   `keep_x` (a dropped half zeroed) and stored as one 16-byte vector, with
//   no staging.  The card's blocks are shared by the slabs, each slab's
//   tiles round-robin over its blocks, one wave.
// The fp32 instantiations (card tests, lora_check, an fp32 model) keep
// CUDA-core bodies with the same hash (`keep_x`): TF32 products would miss
// fp32's limits.
// - fwd: each warp takes 4 rows at a time (persistent grid over row
//   groups); each lane accumulates its columns' share of the 4 x 8 sums,
//   then a recursive-halving butterfly leaves lane L with the total of
//   (row L / 8, column L % 8): 31 shuffles and one coalesced 32-value store.
// - dA: a block sums rows_per_block rows (8 warps, interleaved rows) for
//   one tile of 32 x 16-byte column vectors; its warps' partials meet in
//   shared memory in a fixed order, then the ordered reduction.
// - dh: each warp takes 4 rows at a time; each lane builds 4 x 4 outputs
//   (one 16-byte vector of each row) from dt and A (A is tiny and stays in
//   L1), applies the mask and the scale and stores 16 bytes a row.
// Rows past M (a ragged last tile) and columns past D or r are masked by
// bounds; D must be a multiple of 8 (whole 16-byte bf16 vectors).
//
// C interface (ctypes): each function returns cudaError_t as an int; 0 means
// every launch was accepted.  It launches on the given stream, does not
// synchronise and allocates nothing (`partial` is caller-provided fp32
// scratch [ceil(M / rows_per_block), D, r]).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RT = 8;  // columns of r per tile (the n of mma.m16n8k16)
constexpr int RW = 4;  // rows a warp takes at a time (fp32 fwd, dh)
constexpr int MMA_BLOCKS = 2;    // blocks an SM the bf16 kernels are built for
constexpr int TILE = 16;         // rows of an mma tile (fwd) or k step (dA)
constexpr int FWD_COLS = 128;    // columns of h a fwd warp reads per step
constexpr int AT_PAD = 32;       // bf16 padding of each row of A^T in smem
constexpr int DA_ROWS = 32;      // rows of h a dA warp reads per step
constexpr int DA_SLAB = 64;      // columns of h a dA block covers
constexpr int DH_SLAB = 128;     // columns of dh a bf16 dh warp owns
constexpr int DH_GROUPS = DH_SLAB / 32;

constexpr uint32_t kGolden = 2654435761u;

struct Params {
  int M, D, R;
  uint32_t seed, threshold;
  uint32_t thr_hi;  // threshold >> 16
  uint32_t dk;      // D * kGolden (mod 2^32): the hash input's step a row
  float scale;      // h_scale (fwd, dA) or g_scale (dh)
};

// The hash input of flat index i: i * kGolden + seed (uint32 wrap).  Index
// i + 1 adds kGolden and the next row adds dk, so callers walk a row's
// inputs by addition.
__device__ __forceinline__ uint32_t hash_x(uint32_t i, const Params& p) {
  return i * kGolden + p.seed;
}

// keep = ops/flash_attention.py:_hash_bits(i) >= threshold, from the hash
// input x of i, for fwd, dA and dh alike.  The hash ends with
// `x ^= x >> 16; keep = x >= T`, and that last xor-shift is folded into the
// compare:  (x ^ (x >> 16)) >= T  <=>  (x ^ (T >> 16)) >= T  (unsigned).
// Proof: the two left-hand values share x's high half H.  If H differs
// from T's high half, the high halves alone decide both compares, the same
// way.  If H equals it, the low halves lo(x) ^ H and lo(x) ^ (T >> 16) are
// equal, so the two values are equal.  tests/test_torch_cuda.py reads the
// mask back through every kernel and holds it bit for bit against
// hash_keep_mask.
__device__ __forceinline__ bool keep_x(uint32_t x, const Params& p) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return (x ^ p.thr_hi) >= p.threshold;
}

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);  // elements per 16-byte vector
};

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// One 16-byte vector at p (16-byte aligned) as floats.
template <typename T>
__device__ __forceinline__ void load_vec(float (&v)[Vec<T>::N],
                                         const T* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) v[i] = to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p,
                                          const float (&v)[Vec<T>::N]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) e[i] = from_f<T>(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// p[0 .. 8) as floats, 0 from p[n] on; 16-byte loads where p is aligned.
template <typename T>
__device__ __forceinline__ void load8(float (&v)[RT], const T* p, int n) {
  constexpr int N = Vec<T>::N;
  if (n >= RT && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int k = 0; k < RT / N; ++k) {
      float part[N];
      load_vec<T>(part, p + k * N);
#pragma unroll
      for (int i = 0; i < N; ++i) v[k * N + i] = part[i];
    }
  } else {
#pragma unroll
    for (int j = 0; j < RT; ++j) v[j] = j < n ? to_f(p[j]) : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

// The dropped input of one 16-byte fp32 vector: h at flat index idx0 ..
// idx0+N.
__device__ __forceinline__ void dropped(float (&hm)[Vec<float>::N],
                                        const float* h, uint32_t idx0,
                                        const Params& p) {
  load_vec<float>(hm, h);
  const uint32_t x = hash_x(idx0, p);
#pragma unroll
  for (int i = 0; i < Vec<float>::N; ++i)
    hm[i] = keep_x(x + (uint32_t)i * kGolden, p) ? hm[i] * p.scale : 0.0f;
}

// One step of the halving below: lanes with bit S set keep v[S .. 2S),
// the others v[0 .. S), each summed with its partner's, in v[0 .. S).
template <int S>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool upper = lane & S;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float send = upper ? v[i] : v[i + S];
    const float keep = upper ? v[i + S] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
}

// Recursive halving over the warp: lane L ends with the sum over all lanes
// of v[L] (31 shuffles for 32 values).
__device__ __forceinline__ float reduce32(float (&v)[32]) {
  const int lane = threadIdx.x % 32;
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0];
}

// t[:, tile] for r tile blockIdx.y.
__global__ void __launch_bounds__(THREADS)
lora_fwd_f32_kernel(const Params p, const float* __restrict__ h,
                    const float* __restrict__ a, float* __restrict__ t) {
  constexpr int N = Vec<float>::N;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int j0 = blockIdx.y * RT;
  const int nvec = p.D / N;
  const int ngroups = (p.M + RW - 1) / RW;
  for (int g = blockIdx.x * WARPS + warp; g < ngroups;
       g += gridDim.x * WARPS) {
    const int m0 = g * RW;
    float acc[RW * RT];
#pragma unroll
    for (int k = 0; k < RW * RT; ++k) acc[k] = 0.0f;
    for (int v = lane; v < nvec; v += 32) {
      const int c0 = v * N;
      float hm[RW][N];
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
        const int m = m0 + rr;
        if (m < p.M) {
          dropped(hm[rr], h + (size_t)m * p.D + c0,
                  (uint32_t)m * (uint32_t)p.D + (uint32_t)c0, p);
        } else {
#pragma unroll
          for (int i = 0; i < N; ++i) hm[rr][i] = 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float av[RT];
        load8<float>(av, a + (size_t)(c0 + i) * p.R + j0, p.R - j0);
#pragma unroll
        for (int rr = 0; rr < RW; ++rr)
#pragma unroll
          for (int j = 0; j < RT; ++j) acc[rr * RT + j] += hm[rr][i] * av[j];
      }
    }
    const float total = reduce32(acc);
    const int m = m0 + lane / RT;
    const int j = j0 + lane % RT;
    if (m < p.M && j < p.R) t[(size_t)m * p.R + j] = total;
  }
}

// Shared memory of one fp32 dA block: each warp's [32 lanes][N*RT]
// partials, rows padded by one float so that both the per-lane writes and
// the per-element reads fall in distinct banks.
constexpr size_t da_f32_smem_bytes() {
  return sizeof(float) * WARPS * 32 * (Vec<float>::N * RT + 1);
}

// fp32 partial dA of rows [blockIdx.x * rows_per_block, +rows_per_block),
// column vectors [32 * blockIdx.y, +32), r tile blockIdx.z.
__global__ void __launch_bounds__(THREADS)
lora_da_f32_kernel(const Params p, const float* __restrict__ h,
                   const float* __restrict__ dt, float* __restrict__ partial,
                   int rows_per_block) {
  constexpr int N = Vec<float>::N;
  constexpr int K = N * RT;  // partials per lane
  extern __shared__ __align__(16) float red[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int nvec = p.D / N;
  const int v = blockIdx.y * 32 + lane;
  const int j0 = blockIdx.z * RT;
  const int row0 = blockIdx.x * rows_per_block;
  const int row_end = min(row0 + rows_per_block, p.M);

  float acc[N][RT];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) acc[i][j] = 0.0f;
  if (v < nvec) {
    const int c0 = v * N;
    for (int m = row0 + warp; m < row_end; m += WARPS) {
      float hm[N], dv[RT];
      dropped(hm, h + (size_t)m * p.D + c0,
              (uint32_t)m * (uint32_t)p.D + (uint32_t)c0, p);
      load8<float>(dv, dt + (size_t)m * p.R + j0, p.R - j0);
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) acc[i][j] += hm[i] * dv[j];
    }
  }
  float* mine = red + (size_t)(warp * 32 + lane) * (K + 1);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) mine[i * RT + j] = acc[i][j];
  __syncthreads();
  // element e = (lane l, k): column (32 * blockIdx.y + l) * N + k / RT,
  // r index j0 + k % RT; consecutive threads write consecutive addresses
  // when r == RT
  for (int e = threadIdx.x; e < 32 * K; e += THREADS) {
    const int l = e / K;
    const int k = e % K;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      s += red[(size_t)(w * 32 + l) * (K + 1) + k];
    const int vv = blockIdx.y * 32 + l;
    const int j = j0 + k % RT;
    if (vv < nvec && j < p.R)
      partial[((size_t)blockIdx.x * p.D + vv * N + k / RT) * p.R + j] = s;
  }
}

// dh = keep * (dt @ A^T) * g_scale, fp32: each warp takes RW rows at a time;
// each lane builds RW x 4 outputs (one 16-byte vector of each row) from dt
// and A (A is tiny and stays in L1), applies the mask and the scale and
// stores 16 bytes a row.
__global__ void __launch_bounds__(THREADS)
lora_dh_f32_kernel(const Params p, const float* __restrict__ dt,
                   const float* __restrict__ a, float* __restrict__ dh) {
  constexpr int N = Vec<float>::N;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int nvec = p.D / N;
  const int ngroups = (p.M + RW - 1) / RW;
  for (int g = blockIdx.x * WARPS + warp; g < ngroups;
       g += gridDim.x * WARPS) {
    const int m0 = g * RW;
    for (int v = lane; v < nvec; v += 32) {
      const int c0 = v * N;
      float acc[RW][N];
#pragma unroll
      for (int rr = 0; rr < RW; ++rr)
#pragma unroll
        for (int i = 0; i < N; ++i) acc[rr][i] = 0.0f;
      for (int j0 = 0; j0 < p.R; j0 += RT) {
        float dv[RW][RT];
#pragma unroll
        for (int rr = 0; rr < RW; ++rr) {
          const int m = m0 + rr < p.M ? m0 + rr : p.M - 1;
          load8<float>(dv[rr], dt + (size_t)m * p.R + j0, p.R - j0);
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
          float av[RT];
          load8<float>(av, a + (size_t)(c0 + i) * p.R + j0, p.R - j0);
#pragma unroll
          for (int rr = 0; rr < RW; ++rr)
#pragma unroll
            for (int j = 0; j < RT; ++j) acc[rr][i] += dv[rr][j] * av[j];
        }
      }
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
        const int m = m0 + rr;
        if (m >= p.M) continue;
        const uint32_t x =
            hash_x((uint32_t)m * (uint32_t)p.D + (uint32_t)c0, p);
        float out[N];
#pragma unroll
        for (int i = 0; i < N; ++i)
          out[i] = keep_x(x + (uint32_t)i * kGolden, p)
                       ? acc[rr][i] * p.scale
                       : 0.0f;
        store_vec<float>(dh + (size_t)m * p.D + c0, out);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// a * b on two bf16 pairs, each product rounded once to bf16.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The dropped input of the bf16 pair w whose first value has hash input x:
// w * h_scale (inv2: h_scale in both halves), a dropped half zeroed.
__device__ __forceinline__ uint32_t drop_pair(uint32_t w, uint32_t x,
                                              uint32_t inv2,
                                              const Params& p) {
  uint32_t v = mul_bf16x2(w, inv2);
  if (!keep_x(x, p)) v &= 0xFFFF0000u;
  if (!keep_x(x + kGolden, p)) v &= 0x0000FFFFu;
  return v;
}

// The dropped input of 8 bf16 in place, the first with hash input x.
__device__ __forceinline__ void drop8(uint4& v, uint32_t x, uint32_t inv2,
                                      const Params& p) {
  v.x = drop_pair(v.x, x, inv2, p);
  v.y = drop_pair(v.y, x + 2 * kGolden, inv2, p);
  v.z = drop_pair(v.z, x + 4 * kGolden, inv2, p);
  v.w = drop_pair(v.w, x + 6 * kGolden, inv2, p);
}

// c += A @ B, A 16 x 16 (a0..a3: rows g / g+8 x k 2c..2c+1, then k
// 2c+8..2c+9), B 16 x 8 (b0: k 2c..2c+1, b1: k 2c+8..2c+9, column g), c
// 16 x 8 (rows g, g+8 x columns 2c, 2c+1); g = lane / 4, c = lane % 4.
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 ldg16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint32_t inv_pair(float scale) {
  const uint32_t s = __bfloat16_as_ushort(__float2bfloat16_rn(scale));
  return s | (s << 16);
}

// Row length (bf16) of A^T's r tile in shared memory: D rounded up to a
// whole fwd step, plus AT_PAD, so that rows g and g + 1 start 64 bytes
// apart modulo 128 and a quarter-warp's 16-byte reads hit distinct banks.
__host__ __device__ constexpr int at_stride(int D) {
  return (D + FWD_COLS - 1) / FWD_COLS * FWD_COLS + AT_PAD;
}

// Lane (g, c)'s 16-byte vectors of one fwd step: rows 16*tile + g + 8*rr,
// columns FWD_COLS*step + 32*q + 8*c; zeros past M or D.  kFull: the step
// lies inside h, so no load needs a bound.
template <bool kFull>
__device__ __forceinline__ void fwd_load_at(uint4 (&v)[2][4],
                                            const bf16* __restrict__ h,
                                            const Params& p, int tile,
                                            int step, int g, int c) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int m = tile * TILE + g + 8 * rr;
    const bf16* row = h + (size_t)m * p.D + step * FWD_COLS + 8 * c;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = step * FWD_COLS + 32 * q + 8 * c;
      v[rr][q] = kFull || (m < p.M && col < p.D) ? ldg16(row + 32 * q)
                                                 : make_uint4(0, 0, 0, 0);
    }
  }
}

__device__ __forceinline__ void fwd_load(uint4 (&v)[2][4],
                                         const bf16* __restrict__ h,
                                         const Params& p, int tile, int step,
                                         int g, int c) {
  if ((tile + 1) * TILE <= p.M && (step + 1) * FWD_COLS <= p.D)
    fwd_load_at<true>(v, h, p, tile, step, g, c);
  else
    fwd_load_at<false>(v, h, p, tile, step, g, c);
}

// t[:, r tile blockIdx.y].  Block b's warps take tiles b, b + G, b + 2G, ...
// (G = gridDim.x) in turn, warp w the (w + WARPS k)-th of them.
__global__ void __launch_bounds__(THREADS, MMA_BLOCKS)
lora_fwd_mma_kernel(const Params p, const bf16* __restrict__ h,
                    const bf16* __restrict__ a, bf16* __restrict__ t) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* at = reinterpret_cast<bf16*>(smem);  // [RT][at_stride(D)]
  const int ats = at_stride(p.D);
  const int j0 = blockIdx.y * RT;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int ntiles = (p.M + TILE - 1) / TILE;
  const int nsteps = (p.D + FWD_COLS - 1) / FWD_COLS;
  const int tile_step = gridDim.x * WARPS;
  int tile = blockIdx.x + gridDim.x * (threadIdx.x / 32);
  // the first step's loads fly while the block stages A^T
  uint4 cur[2][4], nxt[2][4];
  if (tile < ntiles) fwd_load(cur, h, p, tile, 0, g, c);
  for (int e = threadIdx.x; e < RT * ats; e += THREADS) {
    const int d = e / RT;
    const int n = e % RT;
    at[n * ats + d] = d < p.D && j0 + n < p.R
                          ? a[(size_t)d * p.R + j0 + n]
                          : __float2bfloat16_rn(0.0f);
  }
  __syncthreads();
  if (tile >= ntiles) return;
  const uint32_t inv2 = inv_pair(p.scale);
  const bf16* at_lane = at + g * ats + 8 * c;

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int step = 0;;) {
    int next_tile = tile, next_step = step + 1;
    if (next_step == nsteps) {
      next_step = 0;
      next_tile += tile_step;
    }
    const bool more = next_tile < ntiles;
    if (more) fwd_load(nxt, h, p, next_tile, next_step, g, c);

    const uint32_t xc = (uint32_t)(step * FWD_COLS + 8 * c) * kGolden;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 b = *reinterpret_cast<const uint4*>(
          at_lane + step * FWD_COLS + 32 * q);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const uint32_t m = (uint32_t)(tile * TILE + g + 8 * rr);
        drop8(cur[rr][q], m * p.dk + p.seed + xc + (uint32_t)(32 * q) *
                                                      kGolden,
              inv2, p);
      }
      mma16816(acc, cur[0][q].x, cur[1][q].x, cur[0][q].y, cur[1][q].y,
               b.x, b.y);
      mma16816(acc, cur[0][q].z, cur[1][q].z, cur[0][q].w, cur[1][q].w,
               b.z, b.w);
    }
    if (next_step == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = tile * TILE + g + 8 * (i / 2);
        const int j = j0 + 2 * c + i % 2;
        if (m < p.M && j < p.R)
          t[(size_t)m * p.R + j] = __float2bfloat16_rn(acc[i]);
        acc[i] = 0.0f;
      }
    }
    if (!more) break;
    tile = next_tile;
    step = next_step;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int q = 0; q < 4; ++q) cur[rr][q] = nxt[rr][q];
  }
}

// Row of slot s (of 4) of lane c within a 16-row k step: k slots 2c, 2c+1,
// 2c+8, 2c+9 of the mma.
__device__ __forceinline__ int da_row(int s, int c) {
  return 2 * c + (s & 1) + 8 * (s >> 1);
}

// Lane (g, c)'s inputs of one dA step (rows DA_ROWS*unit .. +DA_ROWS, two
// k steps): h vectors at columns col .. col+8 of rows da_row(s, c) of each
// k step, and dt's B fragments (column j of those rows, paired); zeros past
// M, D or r.  kFull: the step lies inside h and dt, so no load needs a
// bound.
template <bool kFull>
__device__ __forceinline__ void da_load_at(uint4 (&v)[2][4],
                                           uint32_t (&b)[2][2],
                                           const bf16* __restrict__ h,
                                           const bf16* __restrict__ dt,
                                           const Params& p, int unit,
                                           int col, int j, int c) {
  const unsigned short* dtu = reinterpret_cast<const unsigned short*>(dt);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    uint32_t e[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int m = unit * DA_ROWS + TILE * k + da_row(s, c);
      v[k][s] = kFull || (m < p.M && col < p.D)
                    ? ldg16(h + (size_t)m * p.D + col)
                    : make_uint4(0, 0, 0, 0);
      e[s] = kFull || (m < p.M && j < p.R) ? __ldg(dtu + (size_t)m * p.R + j)
                                           : 0u;
    }
    b[k][0] = e[0] | (e[1] << 16);
    b[k][1] = e[2] | (e[3] << 16);
  }
}

// cols_in: the block's columns of h and r all lie inside h and dt.
__device__ __forceinline__ void da_load(uint4 (&v)[2][4],
                                        uint32_t (&b)[2][2],
                                        const bf16* __restrict__ h,
                                        const bf16* __restrict__ dt,
                                        const Params& p, int unit, int col,
                                        int j, int c, bool cols_in) {
  if (cols_in && (unit + 1) * DA_ROWS <= p.M)
    da_load_at<true>(v, b, h, dt, p, unit, col, j, c);
  else
    da_load_at<false>(v, b, h, dt, p, unit, col, j, c);
}

// fp32 partial dA of units [units_per_block * blockIdx.x, +units_per_block)
// (DA_ROWS rows each), columns [DA_SLAB * blockIdx.y, +DA_SLAB), r tile
// blockIdx.z.  Warp w takes units w, w + WARPS, ... of the range; lane
// (g, c) covers columns DA_SLAB * blockIdx.y + 8g .. +8, and its product j
// (of 4) the mma rows g -> column 2j, g + 8 -> column 2j + 1 of those.
__global__ void __launch_bounds__(THREADS, MMA_BLOCKS)
lora_da_mma_kernel(const Params p, const bf16* __restrict__ h,
                   const bf16* __restrict__ dt, float* __restrict__ partial,
                   int units_per_block) {
  __shared__ float red[WARPS][16][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int j0 = blockIdx.z * RT;
  const int col = blockIdx.y * DA_SLAB + 8 * g;
  const int nunits = (p.M + DA_ROWS - 1) / DA_ROWS;
  const int unit_end = min((blockIdx.x + 1) * units_per_block, nunits);
  const uint32_t inv2 = inv_pair(p.scale);
  const uint32_t xc = p.seed + (uint32_t)col * kGolden;
  const bool cols_in =
      (blockIdx.y + 1) * DA_SLAB <= p.D && j0 + RT <= p.R;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
  int unit = blockIdx.x * units_per_block + warp;
  if (unit < unit_end) {
    uint4 cur[2][4], nxt[2][4];
    uint32_t bcur[2][2], bnxt[2][2];
    da_load(cur, bcur, h, dt, p, unit, col, j0 + g, c, cols_in);
    for (;;) {
      const bool more = unit + WARPS < unit_end;
      if (more)
        da_load(nxt, bnxt, h, dt, p, unit + WARPS, col, j0 + g, c,
                cols_in);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint32_t m =
              (uint32_t)(unit * DA_ROWS + TILE * k + da_row(s, c));
          drop8(cur[k][s], m * p.dk + xc, inv2, p);
        }
        const uint32_t w[4][4] = {
            {cur[k][0].x, cur[k][0].y, cur[k][0].z, cur[k][0].w},
            {cur[k][1].x, cur[k][1].y, cur[k][1].z, cur[k][1].w},
            {cur[k][2].x, cur[k][2].y, cur[k][2].z, cur[k][2].w},
            {cur[k][3].x, cur[k][3].y, cur[k][3].z, cur[k][3].w}};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma16816(acc[j], __byte_perm(w[0][j], w[1][j], 0x5410),
                   __byte_perm(w[0][j], w[1][j], 0x7632),
                   __byte_perm(w[2][j], w[3][j], 0x5410),
                   __byte_perm(w[2][j], w[3][j], 0x7632), bcur[k][0],
                   bcur[k][1]);
      }
      if (!more) break;
      unit += WARPS;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int s = 0; s < 4; ++s) cur[k][s] = nxt[k][s];
        bcur[k][0] = bnxt[k][0];
        bcur[k][1] = bnxt[k][1];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) red[warp][4 * j + i][lane] = acc[j][i];
  __syncthreads();
  // element (k, l): lane l's acc[k / 4][k % 4], summed over the warps in
  // order
  for (int e = threadIdx.x; e < 16 * 32; e += THREADS) {
    const int k = e / 32;
    const int l = e % 32;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][k][l];
    const int d = blockIdx.y * DA_SLAB + 8 * (l / 4) + 2 * (k / 4) +
                  (k % 4) / 2;
    const int n = j0 + 2 * (l % 4) + k % 2;
    if (d < p.D && n < p.R)
      partial[((size_t)blockIdx.x * p.D + d) * p.R + n] = s;
  }
}

// dA[i] = sum over blocks b, in order, of partial[b][i]; i < D*r.
template <typename T>
__global__ void __launch_bounds__(THREADS)
lora_da_reduce_kernel(const float* __restrict__ partial, T* __restrict__ da,
                      int nblk, int n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  int b = 0;
  for (; b + 8 <= nblk; b += 8) {  // 8 loads in flight, summed in order
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = partial[(size_t)(b + u) * n + i];
#pragma unroll
    for (int u = 0; u < 8; ++u) s += v[u];
  }
  for (; b < nblk; ++b) s += partial[(size_t)b * n + i];
  da[i] = from_f<T>(s);
}

// c += A @ B, m16n8k8: A 16 x 8 (a0: row g, a1: row g + 8, k 2c..2c+1),
// B 8 x 8 (b: k 2c..2c+1, column g), c as mma16816's.
__device__ __forceinline__ void mma1688(float (&c)[4], uint32_t a0,
                                        uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// x[row][k], x[row][k + 1] of a row-major [rows, R] bf16 matrix as one pair
// (k in the low half), k even; zero past rows or R.
__device__ __forceinline__ uint32_t pair_at(const bf16* __restrict__ x,
                                            int row, int rows, int k, int R) {
  if (row >= rows || k >= R) return 0u;
  const unsigned short* u =
      reinterpret_cast<const unsigned short*>(x) + (size_t)row * R + k;
  if ((R & 1) == 0) return __ldg(reinterpret_cast<const unsigned int*>(u));
  const uint32_t lo = __ldg(u);
  return k + 1 < R ? lo | ((uint32_t)__ldg(u + 1) << 16) : lo;
}

// dh of two neighbouring columns: (v0, v1) * g_scale rounded once to a bf16
// pair (v0 in the low half), a dropped half zeroed; x: v0's hash input.
__device__ __forceinline__ uint32_t dh_pair(float v0, float v1, uint32_t x,
                                            const Params& p) {
  const __nv_bfloat162 w2 = __floats2bfloat162_rn(v0 * p.scale, v1 * p.scale);
  uint32_t w = *reinterpret_cast<const uint32_t*>(&w2);
  if (!keep_x(x, p)) w &= 0xFFFF0000u;
  if (!keep_x(x + kGolden, p)) w &= 0x0000FFFFu;
  return w;
}

// One warp's walk of dh's 16-row tiles tile, tile + tile_step, ... over its
// slab of DH_SLAB columns from col0 (DH_GROUPS groups of 32).  Product j of
// group q gives lane (g, c) the sums of rows g and g + 8 at n = 2c, 2c + 1;
// B's column n is mapped to column 8 (n / 2) + 2j + n % 2 of the group, so
// over j = 0..3 the lane holds columns 8c .. 8c + 8 of both rows, one
// 16-byte store each.  kOneStep (R <= 8, one k step): the slab's B
// fragments stay in registers and the next tile's A fragments are loaded
// before the current tile is stored; otherwise every k step's fragments are
// loaded per tile (from L1: A and dt are small).
template <bool kOneStep>
__device__ __forceinline__ void dh_walk(const Params& p,
                                        const bf16* __restrict__ dt,
                                        const bf16* __restrict__ a,
                                        bf16* __restrict__ dh, int tile,
                                        int tile_step, int ntiles, int col0,
                                        int g, int c) {
  uint32_t b[DH_GROUPS][4];
  bool col_in[DH_GROUPS];
#pragma unroll
  for (int q = 0; q < DH_GROUPS; ++q) {
    col_in[q] = col0 + 32 * q + 8 * c < p.D;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[q][j] = kOneStep ? pair_at(a, col0 + 32 * q + 8 * (g >> 1) + 2 * j +
                                          (g & 1),
                                   p.D, 2 * c, p.R)
                         : 0u;
  }
  const uint32_t xc = p.seed + (uint32_t)(col0 + 8 * c) * kGolden;
  uint32_t a0 = 0u, a1 = 0u;
  if (kOneStep) {
    a0 = pair_at(dt, tile * TILE + g, p.M, 2 * c, p.R);
    a1 = pair_at(dt, tile * TILE + g + 8, p.M, 2 * c, p.R);
  }
  for (;;) {
    const int m = tile * TILE + g;
    const int next = tile + tile_step;
    uint32_t n0 = 0u, n1 = 0u;
    if (kOneStep && next < ntiles) {
      n0 = pair_at(dt, next * TILE + g, p.M, 2 * c, p.R);
      n1 = pair_at(dt, next * TILE + g + 8, p.M, 2 * c, p.R);
    }
    const uint32_t xr0 = (uint32_t)m * p.dk + xc;
    const uint32_t xr1 = xr0 + 8u * p.dk;
    bf16* row0 = dh + (size_t)m * p.D + col0 + 8 * c;
    bf16* row1 = row0 + (size_t)8 * p.D;
#pragma unroll
    for (int q = 0; q < DH_GROUPS; ++q) {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
      if (kOneStep) {
#pragma unroll
        for (int j = 0; j < 4; ++j) mma1688(acc[j], a0, a1, b[q][j]);
      } else {
        for (int k = 2 * c; k < p.R + 2 * c; k += RT) {
          const uint32_t f0 = pair_at(dt, m, p.M, k, p.R);
          const uint32_t f1 = pair_at(dt, m + 8, p.M, k, p.R);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma1688(acc[j], f0, f1,
                    pair_at(a, col0 + 32 * q + 8 * (g >> 1) + 2 * j + (g & 1),
                            p.D, k, p.R));
        }
      }
      if (!col_in[q]) continue;
      const uint32_t xq = (uint32_t)(32 * q) * kGolden;
      if (m < p.M)
        *reinterpret_cast<uint4*>(row0 + 32 * q) = make_uint4(
            dh_pair(acc[0][0], acc[0][1], xr0 + xq, p),
            dh_pair(acc[1][0], acc[1][1], xr0 + xq + 2 * kGolden, p),
            dh_pair(acc[2][0], acc[2][1], xr0 + xq + 4 * kGolden, p),
            dh_pair(acc[3][0], acc[3][1], xr0 + xq + 6 * kGolden, p));
      if (m + 8 < p.M)
        *reinterpret_cast<uint4*>(row1 + 32 * q) = make_uint4(
            dh_pair(acc[0][2], acc[0][3], xr1 + xq, p),
            dh_pair(acc[1][2], acc[1][3], xr1 + xq + 2 * kGolden, p),
            dh_pair(acc[2][2], acc[2][3], xr1 + xq + 4 * kGolden, p),
            dh_pair(acc[3][2], acc[3][3], xr1 + xq + 6 * kGolden, p));
    }
    if (next >= ntiles) break;
    tile = next;
    a0 = n0;
    a1 = n1;
  }
}

// dh = keep * (dt @ A^T) * g_scale, bf16, for the slab of DH_SLAB columns
// blockIdx.y.  Block b's warps take tiles b, b + G, b + 2G, ... (G =
// gridDim.x) in turn, warp w the (w + WARPS k)-th of them, as in the fwd
// kernel.
__global__ void __launch_bounds__(THREADS, MMA_BLOCKS)
lora_dh_mma_kernel(const Params p, const bf16* __restrict__ dt,
                   const bf16* __restrict__ a, bf16* __restrict__ dh) {
  const int lane = threadIdx.x % 32;
  const int ntiles = (p.M + TILE - 1) / TILE;
  const int tile = blockIdx.x + gridDim.x * (threadIdx.x / 32);
  if (tile >= ntiles) return;
  const int col0 = blockIdx.y * DH_SLAB;
  if (p.R <= RT)
    dh_walk<true>(p, dt, a, dh, tile, gridDim.x * WARPS, ntiles, col0,
                  lane / 4, lane % 4);
  else
    dh_walk<false>(p, dt, a, dh, tile, gridDim.x * WARPS, ntiles, col0,
                   lane / 4, lane % 4);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Blocks of `kernel` the card holds at once (THREADS each, `smem` bytes of
// dynamic shared memory).  Asked once per kernel, shared memory size and
// device, then kept: the occupancy query costs the host more than a
// launch.
struct CardBlocks {
  const void* kernel;
  size_t smem;
  int dev, blocks;
};
std::mutex card_blocks_mu;
std::vector<CardBlocks> card_blocks_seen;

template <typename Kernel>
cudaError_t card_blocks(Kernel kernel, size_t smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(card_blocks_mu);
  for (const CardBlocks& e : card_blocks_seen) {
    if (e.kernel == fn && e.smem == smem && e.dev == dev) {
      *blocks = e.blocks;
      return cudaSuccess;
    }
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  card_blocks_seen.push_back({fn, smem, dev, *blocks});
  return cudaSuccess;
}

// Blocks for a persistent grid: as many as fit on the card at once, and no
// more than the work has.
template <typename Kernel>
cudaError_t persistent_blocks(Kernel kernel, size_t smem, int work_blocks,
                              int* blocks) {
  cudaError_t err = card_blocks(kernel, smem, blocks);
  if (err != cudaSuccess) return err;
  if (*blocks > work_blocks) *blocks = work_blocks;
  if (*blocks < 1) *blocks = 1;
  return cudaSuccess;
}

Params make_params(int M, int D, int R, unsigned int seed,
                   unsigned int threshold, float scale) {
  Params p;
  p.M = M;
  p.D = D;
  p.R = R;
  p.seed = seed;
  p.threshold = threshold;
  p.thr_hi = threshold >> 16;
  p.dk = (uint32_t)D * kGolden;
  p.scale = scale;
  return p;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

cudaError_t fwd_f32(const Params& p, const void* h, const void* a, void* t,
                    cudaStream_t s) {
  int blocks = 0;
  cudaError_t err = persistent_blocks(
      lora_fwd_f32_kernel, 0, cdiv(cdiv(p.M, RW), WARPS), &blocks);
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks, cdiv(p.R, RT));
  lora_fwd_f32_kernel<<<grid, THREADS, 0, s>>>(
      p, static_cast<const float*>(h), static_cast<const float*>(a),
      static_cast<float*>(t));
  return cudaGetLastError();
}

cudaError_t fwd_bf16(const Params& p, const void* h, const void* a, void* t,
                     cudaStream_t s) {
  const size_t smem = sizeof(bf16) * RT * at_stride(p.D);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lora_fwd_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  int blocks = 0;
  err = persistent_blocks(lora_fwd_mma_kernel, smem,
                          cdiv(cdiv(p.M, TILE), WARPS), &blocks);
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks, cdiv(p.R, RT));
  lora_fwd_mma_kernel<<<grid, THREADS, smem, s>>>(
      p, static_cast<const bf16*>(h), static_cast<const bf16*>(a),
      static_cast<bf16*>(t));
  return cudaGetLastError();
}

template <typename T>
cudaError_t da_reduce(const float* partial, void* out, int nblk,
                      const Params& p, cudaStream_t s) {
  const int n = p.D * p.R;
  lora_da_reduce_kernel<T><<<cdiv(n, THREADS), THREADS, 0, s>>>(
      partial, static_cast<T*>(out), nblk, n);
  return cudaGetLastError();
}

cudaError_t da_f32(const Params& p, const void* h, const void* dt,
                   float* partial, void* out, int rows_per_block,
                   cudaStream_t s) {
  constexpr size_t smem = da_f32_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      lora_da_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int nblk = cdiv(p.M, rows_per_block);
  const dim3 grid(nblk, cdiv(p.D / Vec<float>::N, 32), cdiv(p.R, RT));
  lora_da_f32_kernel<<<grid, THREADS, smem, s>>>(
      p, static_cast<const float*>(h), static_cast<const float*>(dt),
      partial, rows_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return da_reduce<float>(partial, out, nblk, p, s);
}

// Row ranges a slab: as many as the card holds blocks of all slabs and r
// tiles at once, and no more than `partial` has room for (ceil(M /
// rows_per_block)); then ranges of equal whole units.  The split depends
// on the card and the shape only, so two calls sum in the same order.
cudaError_t da_bf16(const Params& p, const void* h, const void* dt,
                    float* partial, void* out, int rows_per_block,
                    cudaStream_t s) {
  int blocks = 0;
  cudaError_t err = card_blocks(lora_da_mma_kernel, 0, &blocks);
  if (err != cudaSuccess) return err;
  const int slabs = cdiv(p.D, DA_SLAB);
  const int rtiles = cdiv(p.R, RT);
  const int nunits = cdiv(p.M, DA_ROWS);
  int ranges = blocks / (slabs * rtiles);
  if (ranges > cdiv(p.M, rows_per_block)) ranges = cdiv(p.M, rows_per_block);
  if (ranges > nunits) ranges = nunits;
  if (ranges < 1) ranges = 1;
  const int units_per_block = cdiv(nunits, ranges);
  ranges = cdiv(nunits, units_per_block);
  const dim3 grid(ranges, slabs, rtiles);
  lora_da_mma_kernel<<<grid, THREADS, 0, s>>>(
      p, static_cast<const bf16*>(h), static_cast<const bf16*>(dt), partial,
      units_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return da_reduce<bf16>(partial, out, ranges, p, s);
}

cudaError_t dh_f32(const Params& p, const void* dt, const void* a, void* out,
                   cudaStream_t s) {
  int blocks = 0;
  cudaError_t err = persistent_blocks(lora_dh_f32_kernel, 0,
                                      cdiv(cdiv(p.M, RW), WARPS), &blocks);
  if (err != cudaSuccess) return err;
  lora_dh_f32_kernel<<<blocks, THREADS, 0, s>>>(
      p, static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<float*>(out));
  return cudaGetLastError();
}

// One wave: the card's blocks shared equally by the slabs, each slab's
// tiles round-robin over its blocks.
cudaError_t dh_bf16(const Params& p, const void* dt, const void* a, void* out,
                    cudaStream_t s) {
  int blocks = 0;
  cudaError_t err = card_blocks(lora_dh_mma_kernel, 0, &blocks);
  if (err != cudaSuccess) return err;
  const int slabs = cdiv(p.D, DH_SLAB);
  int per_slab = blocks / slabs;
  if (per_slab > cdiv(cdiv(p.M, TILE), WARPS))
    per_slab = cdiv(cdiv(p.M, TILE), WARPS);
  if (per_slab < 1) per_slab = 1;
  lora_dh_mma_kernel<<<dim3(per_slab, slabs), THREADS, 0, s>>>(
      p, static_cast<const bf16*>(dt), static_cast<const bf16*>(a),
      static_cast<bf16*>(out));
  return cudaGetLastError();
}

bool shape_ok(int M, int D, int R) {
  return M > 0 && D > 0 && R > 0 && D % 8 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  h [M, D], a [D, R], t [M, R].
extern "C" int mmoe_lora_dropout_fwd(const void* h, const void* a, void* t,
                                     int dtype, int M, int D, int R,
                                     unsigned int seed,
                                     unsigned int threshold, float h_scale,
                                     void* stream) {
  if (!shape_ok(M, D, R)) return (int)cudaErrorInvalidValue;
  const Params p = make_params(M, D, R, seed, threshold, h_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return fwd_bf16(p, h, a, t, s);
  if (dtype == 0) return fwd_f32(p, h, a, t, s);
  return (int)cudaErrorInvalidValue;
}

// h [M, D], dt [M, R]; partial fp32 [ceil(M / rows_per_block), D, R]
// scratch; da [D, R] in the dtype of h.  fp32 sums rows_per_block rows a
// block; bf16 at least that many a row range (da_bf16).
extern "C" int mmoe_lora_dropout_da(const void* h, const void* dt,
                                    void* partial, void* da_out, int dtype,
                                    int M, int D, int R, int rows_per_block,
                                    unsigned int seed,
                                    unsigned int threshold, float h_scale,
                                    void* stream) {
  if (!shape_ok(M, D, R) || rows_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(M, D, R, seed, threshold, h_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  if (dtype == 1) return da_bf16(p, h, dt, part, da_out, rows_per_block, s);
  if (dtype == 0) return da_f32(p, h, dt, part, da_out, rows_per_block, s);
  return (int)cudaErrorInvalidValue;
}

// dt [M, R], a [D, R], dh [M, D].
extern "C" int mmoe_lora_dropout_dh(const void* dt, const void* a,
                                    void* dh_out, int dtype, int M, int D,
                                    int R, unsigned int seed,
                                    unsigned int threshold, float g_scale,
                                    void* stream) {
  if (!shape_ok(M, D, R)) return (int)cudaErrorInvalidValue;
  const Params p = make_params(M, D, R, seed, threshold, g_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dh_bf16(p, dt, a, dh_out, s);
  if (dtype == 0) return dh_f32(p, dt, a, dh_out, s);
  return (int)cudaErrorInvalidValue;
}
