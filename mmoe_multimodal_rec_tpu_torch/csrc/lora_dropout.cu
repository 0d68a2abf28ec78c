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
// Bound on this card: at the main path's shape (M = 49152 rows = 128 chunks
// x 384 tokens, D = 768, r = 8, bf16) each kernel reads or writes one
// [M, D] tensor (75.5 MB) and moves little else (t/dt 0.8 MB), against
// 2*M*D*r = 0.6 GFLOP: all three are bound by bytes, about 23 us each at
// 3.35 TB/s.  The design reads h, or writes dh, exactly once in 16-byte
// vectors along rows (a warp covers 512 contiguous bytes of a row) and
// keeps every partial sum in registers.  r is tiled by 8: at r = 8 one tile
// (the main path); a larger r re-reads h once per tile (fwd, dA) or walks
// the tiles in registers (dh).  Tensor cores are not used at r = 8; the
// hash (4 integer multiplies an element) and the 8 FMAs an element are
// what a faster version would have to trim.
// - fwd: each warp takes 4 rows at a time (persistent grid over row
//   groups); each lane accumulates its columns' share of the 4 x 8 sums,
//   then a recursive-halving butterfly leaves lane L with the total of
//   (row L / 8, column L % 8): 31 shuffles and one coalesced 32-value store.
// - dA: the TPU adds every row block into one output block over a
//   sequential grid.  Here a block sums 256 rows (8 warps, interleaved
//   rows) for one tile of 32 x 16-byte column vectors; its warps' partials
//   meet in shared memory in a fixed order and the block writes fp32
//   partials [nblocks, D, r]; a second kernel sums the blocks in order.  No
//   atomics, so the gradient is the same from run to run.
// - dh: each warp takes 4 rows at a time; each lane builds 4 x 8 outputs
//   (one 16-byte vector of each row) from dt and A (A is tiny and stays in
//   L1), applies the mask and the scale and stores 16 bytes a row.
// Rows past M (a ragged last row group or block) are masked by bounds.
//
// C interface (ctypes): each function returns cudaError_t as an int; 0 means
// every launch was accepted.  It launches on the given stream, does not
// synchronise and allocates nothing (`partial` is caller-provided fp32
// scratch [ceil(M / rows_per_block), D, r]).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RT = 8;  // columns of r per tile
constexpr int RW = 4;  // rows a warp takes at a time (fwd, dh); RW*RT == 32

struct Params {
  int M, D, R;
  uint32_t seed, threshold;
  float scale;  // h_scale (fwd, dA) or g_scale (dh)
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

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);  // elements per 16-byte vector
};

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
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

// The dropped input of one 16-byte vector: h at flat index idx0 .. idx0+N.
template <typename T>
__device__ __forceinline__ void dropped(float (&hm)[Vec<T>::N], const T* h,
                                        uint32_t idx0, const Params& p) {
  load_vec<T>(hm, h);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) {
    const float x = to_f(from_f<T>(hm[i] * p.scale));
    hm[i] = hash_bits(idx0 + (uint32_t)i, p.seed) >= p.threshold ? x : 0.0f;
  }
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
template <typename T>
__global__ void __launch_bounds__(THREADS)
lora_fwd_kernel(const Params p, const T* __restrict__ h,
                const T* __restrict__ a, T* __restrict__ t) {
  constexpr int N = Vec<T>::N;
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
          dropped<T>(hm[rr], h + (size_t)m * p.D + c0,
                     (uint32_t)m * (uint32_t)p.D + (uint32_t)c0, p);
        } else {
#pragma unroll
          for (int i = 0; i < N; ++i) hm[rr][i] = 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float av[RT];
        load8<T>(av, a + (size_t)(c0 + i) * p.R + j0, p.R - j0);
#pragma unroll
        for (int rr = 0; rr < RW; ++rr)
#pragma unroll
          for (int j = 0; j < RT; ++j) acc[rr * RT + j] += hm[rr][i] * av[j];
      }
    }
    const float total = reduce32(acc);
    const int m = m0 + lane / RT;
    const int j = j0 + lane % RT;
    if (m < p.M && j < p.R) t[(size_t)m * p.R + j] = from_f<T>(total);
  }
}

// Shared memory of one dA block: each warp's [32 lanes][N*RT] partials,
// rows padded by one float so that both the per-lane writes and the
// per-element reads fall in distinct banks.
template <typename T>
constexpr size_t da_smem_bytes() {
  return sizeof(float) * WARPS * 32 * (Vec<T>::N * RT + 1);
}

// fp32 partial dA of rows [blockIdx.x * rows_per_block, +rows_per_block),
// column vectors [32 * blockIdx.y, +32), r tile blockIdx.z.
template <typename T>
__global__ void __launch_bounds__(THREADS)
lora_da_kernel(const Params p, const T* __restrict__ h,
               const T* __restrict__ dt, float* __restrict__ partial,
               int rows_per_block) {
  constexpr int N = Vec<T>::N;
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
      dropped<T>(hm, h + (size_t)m * p.D + c0,
                 (uint32_t)m * (uint32_t)p.D + (uint32_t)c0, p);
      load8<T>(dv, dt + (size_t)m * p.R + j0, p.R - j0);
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

// dA[i] = sum over blocks b, in order, of partial[b][i]; i < D*r.
template <typename T>
__global__ void __launch_bounds__(THREADS)
lora_da_reduce_kernel(const float* __restrict__ partial, T* __restrict__ da,
                      int nblk, int n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int b = 0; b < nblk; ++b) s += partial[(size_t)b * n + i];
  da[i] = from_f<T>(s);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lora_dh_kernel(const Params p, const T* __restrict__ dt,
               const T* __restrict__ a, T* __restrict__ dh) {
  constexpr int N = Vec<T>::N;
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
          load8<T>(dv[rr], dt + (size_t)m * p.R + j0, p.R - j0);
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
          float av[RT];
          load8<T>(av, a + (size_t)(c0 + i) * p.R + j0, p.R - j0);
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
        const uint32_t idx0 = (uint32_t)m * (uint32_t)p.D + (uint32_t)c0;
        float out[N];
#pragma unroll
        for (int i = 0; i < N; ++i)
          out[i] = hash_bits(idx0 + (uint32_t)i, p.seed) >= p.threshold
                       ? acc[rr][i] * p.scale
                       : 0.0f;
        store_vec<T>(dh + (size_t)m * p.D + c0, out);
      }
    }
  }
}

// Blocks for a persistent grid: as many as fit on the card at once, and no
// more than the work has.
template <typename Kernel>
cudaError_t persistent_blocks(Kernel kernel, size_t smem, int work_blocks,
                              int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return err;
  const int cap = sms * (per_sm > 0 ? per_sm : 1);
  *blocks = work_blocks < cap ? work_blocks : cap;
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
  p.scale = scale;
  return p;
}

template <typename T>
cudaError_t fwd(const Params& p, const void* h, const void* a, void* t,
                cudaStream_t s) {
  int blocks = 0;
  const int groups = (p.M + RW - 1) / RW;
  cudaError_t err = persistent_blocks(lora_fwd_kernel<T>, 0,
                                      (groups + WARPS - 1) / WARPS, &blocks);
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks, (p.R + RT - 1) / RT);
  lora_fwd_kernel<T><<<grid, THREADS, 0, s>>>(
      p, static_cast<const T*>(h), static_cast<const T*>(a),
      static_cast<T*>(t));
  return cudaGetLastError();
}

template <typename T>
cudaError_t da(const Params& p, const void* h, const void* dt,
               float* partial, void* out, int rows_per_block,
               cudaStream_t s) {
  constexpr size_t smem = da_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      lora_da_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int nblk = (p.M + rows_per_block - 1) / rows_per_block;
  const int nvec = p.D / Vec<T>::N;
  const dim3 grid(nblk, (nvec + 31) / 32, (p.R + RT - 1) / RT);
  lora_da_kernel<T><<<grid, THREADS, smem, s>>>(
      p, static_cast<const T*>(h), static_cast<const T*>(dt), partial,
      rows_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = p.D * p.R;
  lora_da_reduce_kernel<T><<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      partial, static_cast<T*>(out), nblk, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dh(const Params& p, const void* dt, const void* a, void* out,
               cudaStream_t s) {
  int blocks = 0;
  const int groups = (p.M + RW - 1) / RW;
  cudaError_t err = persistent_blocks(lora_dh_kernel<T>, 0,
                                      (groups + WARPS - 1) / WARPS, &blocks);
  if (err != cudaSuccess) return err;
  lora_dh_kernel<T><<<blocks, THREADS, 0, s>>>(
      p, static_cast<const T*>(dt), static_cast<const T*>(a),
      static_cast<T*>(out));
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
  if (dtype == 1) return fwd<bf16>(p, h, a, t, s);
  if (dtype == 0) return fwd<float>(p, h, a, t, s);
  return (int)cudaErrorInvalidValue;
}

// h [M, D], dt [M, R]; partial fp32 [ceil(M / rows_per_block), D, R]
// scratch; da [D, R] in the dtype of h.
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
  if (dtype == 1) return da<bf16>(p, h, dt, part, da_out, rows_per_block, s);
  if (dtype == 0)
    return da<float>(p, h, dt, part, da_out, rows_per_block, s);
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
  if (dtype == 1) return dh<bf16>(p, dt, a, dh_out, s);
  if (dtype == 0) return dh<float>(p, dt, a, dh_out, s);
  return (int)cudaErrorInvalidValue;
}
