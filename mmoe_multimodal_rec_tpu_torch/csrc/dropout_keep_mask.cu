// The attention-weight dropout keep mask for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `dropout_keep_mask` of
// mmoe_multimodal_rec_tpu/ops/flash_attention.py (grid (b, h), one int8
// [lq, lk_pad] block each, sliced to [..., :lk] != 0 afterwards).  Python
// wrapper and plain PyTorch version: `dropout_keep_mask` and
// `dropout_keep_mask_reference` in mmoe_multimodal_rec_tpu_torch/ops/
// flash_attention.py.  On the port's main path it draws the keep mask of
// the short attentions that stay plain torch (models/layers.
// _dot_product_attention: the sentence cross expert at L = 64 and the fuse
// experts at L = 2) in every training forward.
//
// What it computes: the bool mask [rows = b*h*lq, lk] (torch.bool, one byte
// each, 0 or 1), written directly without a padded tail, where
//   keep[row, k] = hash(row * lk_pad + k) >= threshold
// in uint32 arithmetic that wraps modulo 2^32 (row = (bi*H + hi)*lq + q, so
// the counter is ((bi*H + hi)*lq + q)*lk_pad + k), hash the murmur3
// finalizer of `hash_bits` below (the same as csrc/flash_attention_fwd.cu,
// csrc/flash_attention_bwd.cu and csrc/lora_dropout.cu compute), threshold
// = uint32(rate * (2^32 - 1)).  Bit-identical to the JAX interpret-mode
// stream.
//
// Bound on this card: it reads nothing and writes rows*lk bytes, 4 integer
// multiplies an element.  At the main path's shapes ([64, 8, 64, 64], 2.1
// MB, and [64, 8, 2, 2], 2 KB) the bytes take 0.6 us and 0.6 ns at 3.35
// TB/s, so a call is bound by its launch (a few us), not by the card.  The
// design is the simple one: one thread per run of 16 consecutive keys of a
// row, stored as one 16-byte vector where lk is a multiple of 16 (rows then
// start 16-byte aligned), byte by byte elsewhere (lk = 2, or a ragged lk);
// a grid-stride loop covers any size.
//
// C interface (ctypes): mmoe_dropout_keep_mask returns cudaError_t as an
// int; 0 means the launch was accepted.  It launches on the given stream,
// does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RUN = 16;        // keys a thread writes: one 16-byte vector
constexpr int MAX_BLOCKS = 4096;

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

// VEC: lk % 16 == 0, every run is 16 whole keys and 16-byte aligned.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    keep_mask_kernel(uint8_t* __restrict__ out, long long rows, int lk,
                     int lk_pad, int runs, uint32_t seed,
                     uint32_t threshold) {
  const long long total = rows * runs;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / runs;
    const int k0 = (int)(i - row * runs) * RUN;
    // the counter wraps modulo 2^32, as the JAX kernel's uint32 does
    const uint32_t base = (uint32_t)row * (uint32_t)lk_pad + (uint32_t)k0;
    uint8_t* dst = out + row * lk + k0;
    if (VEC) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          word |= (uint32_t)(hash_bits(base + 4 * j + e, seed) >= threshold)
                  << (8 * e);
        w[j] = word;
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      const int n = lk - k0 < RUN ? lk - k0 : RUN;
      for (int e = 0; e < n; ++e)
        dst[e] = hash_bits(base + (uint32_t)e, seed) >= threshold;
    }
  }
}

}  // namespace

// out: [rows, lk] bytes (a torch.bool tensor), 16-byte aligned; rows =
// b*h*lq; lk_pad: the counter's row stride (lk rounded up to 128 unless the
// caller gives another).
extern "C" int mmoe_dropout_keep_mask(void* out, long long rows, int lk,
                                      int lk_pad, unsigned int seed,
                                      unsigned int threshold, void* stream) {
  if (rows <= 0 || lk <= 0 || lk_pad <= 0) return (int)cudaErrorInvalidValue;
  const int runs = (lk + RUN - 1) / RUN;
  const long long total = rows * runs;
  const long long want = (total + THREADS - 1) / THREADS;
  const int blocks = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (lk % RUN == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0)
    keep_mask_kernel<true><<<blocks, THREADS, 0, s>>>(o, rows, lk, lk_pad,
                                                      runs, seed, threshold);
  else
    keep_mask_kernel<false><<<blocks, THREADS, 0, s>>>(o, rows, lk, lk_pad,
                                                       runs, seed, threshold);
  return (int)cudaGetLastError();
}
