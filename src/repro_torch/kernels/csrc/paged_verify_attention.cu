// Paged multi-token verify attention, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_verify_attention.py::paged_verify_attention (body
// _paged_verify_kernel): the speculative-decode verify step's attention of
// W consecutive query tokens per slot (W * Gq query rows per KV head) over
// that slot's KV pages, gathered through a block table, with the
// dequantization of quantized pages fused into the read.  Two entries:
//
//   paged_verify_attention        the Pallas interface: q (B, Hkv, W, Gq,
//                                 D), int8 or packed-int4 code pools with
//                                 group scales, f32 math, the staircase
//                                 mask (query j sees positions
//                                 < kv_lens[b] + j), normalized output.
//   paged_verify_attention_arena  the serving verify step's cache read:
//                                 q (B, Hkv, Gq, W, D) bf16 over the
//                                 arena's bf16 fp pool and int8 code / f32
//                                 per-channel scale pools (P, PS, Hkv, D),
//                                 positions below quant_lens[b] read the
//                                 quant pool.  Every row sees the committed
//                                 prefix, positions < kv_lens[b]; the W new
//                                 tokens meet each other in the caller's
//                                 closed-form merge.  Output is the
//                                 UNNORMALIZED bf16 sum with f32 row max m
//                                 and denominator l, at the rounding points
//                                 of paged_attention_arena: quant values
//                                 round to bf16, scores are bf16-rounded
//                                 dots scaled in f32, the row max is exact,
//                                 p rounds to bf16 for the p * V sum.
//
// Bound on this card: bytes.  Every visible K and V element is read once
// (2 bytes fp, or 1 byte code + 4 bytes scale) for 2 flops per query row;
// with 20 rows that is ~10 flops per byte, far below the H100's ridge.
// Design: paged_split.cuh's two launches, the rows of a (slot, KV head) in
// tiles of up to 32 (W = 5: 20 rows, one tile).  Phase A cuts each slot's
// view into chunks of 16-128 positions across blocks (W = 5: 816 blocks of
// 64 positions; W = 2: 1,584 of 32) and keeps a chunk's scores in shared
// memory whatever the view's length; phase B sums p * v per (slot, KV
// head, 16 channels).
// This kernel's sums run in the order of kernels/ref.py's
// paged_verify_attention_arena_ref: each score in order over D (one
// thread per position and group of rows), each denominator as one warp
// takes it (lanes strided over the positions, then an xor butterfly),
// each output in order over the positions.  The staircase is applied per
// row in both phases.  What still limits it (0.066 / 0.096 ms at W = 2 /
// 5 on an H100, 5-7x the byte bound): latency in both phases
// (paged_split.cuh), and the f32 per-channel scale pool.
#include "paged_split.cuh"

namespace {
constexpr int kLWidth = 32;  // l: one warp's 32 strided partial sums
}  // namespace

extern "C" int paged_verify_attention(
    const void* q, int q_is_bf16, const void* k_codes, const float* k_scale,
    const void* v_codes, const float* v_scale, const int32_t* block_tables,
    const int32_t* kv_lens, float* ws, void* out, int b, int hkv, int w,
    int gq, int d, int pps, int ps, int bits, int group, float sm_scale,
    void* stream) {
  PallasPages pages{static_cast<const uint8_t*>(k_codes), k_scale,
                    static_cast<const uint8_t*>(v_codes), v_scale,
                    hkv, ps, d, bits, group};
  if (q_is_bf16)
    return split_launch<false, true, false, kLWidth, PallasPages,
                        __nv_bfloat16>(
        q, pages, block_tables, kv_lens, nullptr, ws, out, nullptr, nullptr,
        b, w * gq, gq, d, pps, ps, sm_scale, stream);
  return split_launch<false, true, false, kLWidth, PallasPages, float>(
      q, pages, block_tables, kv_lens, nullptr, ws, out, nullptr, nullptr, b,
      w * gq, gq, d, pps, ps, sm_scale, stream);
}

extern "C" int paged_verify_attention_arena(
    const void* q, const void* k_pool, const void* v_pool,
    const int8_t* k_codes, const float* k_scale, const int8_t* v_codes,
    const float* v_scale, const int32_t* block_tables, const int32_t* kv_lens,
    const int32_t* quant_lens, float* ws, void* out, float* m, float* l,
    int b, int hkv, int gq, int w, int d, int pps, int ps, float sm_scale,
    void* stream) {
  ArenaPages pages{static_cast<const __nv_bfloat16*>(k_pool),
                   static_cast<const __nv_bfloat16*>(v_pool),
                   k_codes, k_scale, v_codes, v_scale, hkv, ps, d};
  return split_launch<true, false, false, kLWidth, ArenaPages,
                      __nv_bfloat16>(
      q, pages, block_tables, kv_lens, quant_lens, ws, out, m, l, b, gq * w,
      gq, d, pps, ps, sm_scale, stream);
}
