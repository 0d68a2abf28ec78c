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
// finalizer of ops/flash_attention.py:_hash_bits (the same as
// csrc/flash_attention_fwd.cu, csrc/flash_attention_bwd.cu and
// csrc/lora_dropout.cu compute), threshold = uint32(rate * (2^32 - 1)).
// Bit-identical to the JAX interpret-mode stream.  Under tensor
// parallelism a rank holds heads [h0, h0 + H) of H_total and its rows key
// on the global head (bi*H_total + h0 + hi), so its mask is that slice of
// the full one; the batch offset of a data-parallel rank is folded into the
// seed by the caller.
//
// Bound on this card: it reads nothing and writes rows*lk bytes.  At the
// main path's shapes ([64, 8, 64, 64], 2.1 MB, and [64, 8, 2, 2], 2 KB) the
// bytes take 0.63 us and 0.6 ns at 3.35 TB/s, but the hash takes longer:
// the SMs issue 64 integer lanes a clock, so at 2.1 M keys each integer
// instruction a key costs ~0.13 us at 1.98 GHz.  The first port spent ~13
// a key (a multiply for each counter, the hash's last xor-shift, a shift
// and an OR to pack each byte) and a 64-bit division by a runtime value
// for every 16 keys.  The design:
// - no division: a block is blockDim.x runs of 16 keys of a row (all of a
//   row's runs when they fit, else a block-stride walk over them) times
//   blockDim.y rows, so a thread's row and run are its block's and thread's
//   indices;
// - the hash input walked by addition: x = row * (lk_pad * kGolden) + seed
//   + k * kGolden (uint32, wrapping as the counter does), so a key costs
//   one add with an immediate instead of a multiply;
// - the hash's last xor-shift folded into the compare, as in
//   csrc/lora_dropout.cu's `keep_x` (the proof is there);
// - each byte set by one predicated OR of its bit into the word.
// That leaves ~10 integer instructions a key (the add, the hash's 2 shifts,
// 3 xors and 2 multiplies, the compare, the OR): the compiled 16-key loop
// issues 166 to the integer pipes, where the first port's issued 235, its
// division included.  A run is stored as one 16-byte vector where lk is a
// multiple of 16 (rows then start 16-byte aligned), byte by byte elsewhere
// (lk = 2, or a ragged lk).  On an H100 SXM at 700 W a call at the cross
// shape takes 2.0 us of device time (2.4 before), of which ~1.1 is the
// floor a kernel of a few blocks shows (the fuse shape's time, bound by its
// launch whatever the body).  Packing the bytes with `prmt` (a select a key
// and three `prmt` a word), 8 keys a thread or 64 were all slower.
//
// C interface (ctypes): mmoe_dropout_keep_mask returns cudaError_t as an
// int; 0 means the launch was accepted.  It launches on the given stream,
// does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RUN = 16;  // keys a thread writes: one 16-byte vector
constexpr uint32_t kGolden = 2654435761u;

struct Params {
  long long rows;
  int lk, runs;
  // a head shard (heads [h0, h0 + heads) of h_total): local row r =
  // (bi*heads + hi)*lq + q counts as the row (bi*h_total + h0 + hi)*lq + q
  long long shard_rows;  // heads * lq; 0 when the heads are all of them
  uint32_t skip_rows;    // (h_total - heads) * lq
  uint32_t first_row;    // h0 * lq
  uint32_t row_step;  // lk_pad * kGolden: the hash input's step a row
  uint32_t seed, threshold;
  uint32_t thr_hi;    // threshold >> 16
};

// ops/flash_attention.py:_hash_bits(i) >= threshold from the hash input
// x = i * kGolden + seed, the last xor-shift folded into the compare.
__device__ __forceinline__ bool keep_x(uint32_t x, const Params& p) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return (x ^ p.thr_hi) >= p.threshold;
}

// The bytes (0 or 1) of 4 consecutive keys, the first with hash input x.
__device__ __forceinline__ uint32_t keep4(uint32_t x, const Params& p) {
  uint32_t w = 0u;
  if (keep_x(x, p)) w |= 0x1u;
  if (keep_x(x + kGolden, p)) w |= 0x100u;
  if (keep_x(x + 2u * kGolden, p)) w |= 0x10000u;
  if (keep_x(x + 3u * kGolden, p)) w |= 0x1000000u;
  return w;
}

// VEC: lk % 16 == 0, every run is 16 whole keys and 16-byte aligned.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    keep_mask_kernel(uint8_t* __restrict__ out, const Params p) {
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= p.rows) return;
  uint8_t* dst = out + row * p.lk;
  // the counter row * lk_pad + k wraps modulo 2^32, as the JAX kernel's
  // uint32 does; so does its product with kGolden.  A head shard's row
  // maps to its global row with one division a thread, outside the loop.
  uint32_t grow = (uint32_t)row;
  if (p.shard_rows)
    grow += (uint32_t)(row / p.shard_rows) * p.skip_rows + p.first_row;
  const uint32_t xrow = grow * p.row_step + p.seed;
  for (int run = threadIdx.x; run < p.runs; run += blockDim.x) {
    const int k0 = run * RUN;
    const uint32_t x = xrow + (uint32_t)k0 * kGolden;
    if (VEC) {
      *reinterpret_cast<uint4*>(dst + k0) =
          make_uint4(keep4(x, p), keep4(x + 4u * kGolden, p),
                     keep4(x + 8u * kGolden, p), keep4(x + 12u * kGolden, p));
    } else {
      const int n = p.lk - k0 < RUN ? p.lk - k0 : RUN;
      for (int e = 0; e < n; ++e)
        dst[k0 + e] = keep_x(x + (uint32_t)e * kGolden, p);
    }
  }
}

}  // namespace

// out: [rows, lk] bytes (a torch.bool tensor), 16-byte aligned; rows =
// b*heads*lq; lk_pad: the counter's row stride (lk rounded up to 128 unless
// the caller gives another); the heads are [h0, h0 + heads) of h_total, so
// a row's counter takes the global head bi*h_total + h0 + hi.
extern "C" int mmoe_dropout_keep_mask(void* out, long long rows, int lk,
                                      int lk_pad, int heads, int lq,
                                      int h_total, int h0, unsigned int seed,
                                      unsigned int threshold, void* stream) {
  if (rows <= 0 || lk <= 0 || lk_pad <= 0 || heads <= 0 || lq <= 0 ||
      h0 < 0 || h0 + heads > h_total || rows % ((long long)heads * lq))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.rows = rows;
  p.shard_rows = heads == h_total ? 0 : (long long)heads * lq;
  p.skip_rows = (uint32_t)(h_total - heads) * (uint32_t)lq;
  p.first_row = (uint32_t)h0 * (uint32_t)lq;
  p.lk = lk;
  p.runs = (lk + RUN - 1) / RUN;
  p.row_step = (uint32_t)lk_pad * kGolden;
  p.seed = seed;
  p.threshold = threshold;
  p.thr_hi = threshold >> 16;
  const int tx = p.runs < THREADS ? p.runs : THREADS;
  const int ty = THREADS / tx;
  const long long blocks = (rows + ty - 1) / ty;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (lk % RUN == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0)
    keep_mask_kernel<true><<<(unsigned)blocks, dim3(tx, ty), 0, s>>>(o, p);
  else
    keep_mask_kernel<false><<<(unsigned)blocks, dim3(tx, ty), 0, s>>>(o, p);
  return (int)cudaGetLastError();
}
