// Paged quantized decode attention, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention.py::paged_attention (body
// _paged_attn_kernel): attention of one new query token per slot (Gq GQA
// query rows per KV head) over that slot's KV pages, gathered through a
// block table, with the dequantization of quantized pages fused into the
// read.  Two entry points share the structure:
//
//   paged_attention        the Pallas interface: int8 or packed-int4 code
//                          pools (P, Hkv, PS, D') with group scales, f32
//                          math, masked at kv_lens, normalized output.
//   paged_attention_arena  the serving decode step's layout: per-layer bf16
//                          fp pool plus int8 code pool and per-channel f32
//                          scale pool, all (P, PS, Hkv, D); positions below
//                          quant_lens[b] read the quant pool, the rest the
//                          fp pool.  Quant values round to bf16, scores are
//                          bf16-rounded dots scaled in f32, and the output
//                          is the UNNORMALIZED bf16 sum with f32 max m and
//                          denominator l, so the caller merges the new
//                          token in closed form (the JAX package's
//                          multihead_attention(return_stats=True)).
//   paged_attention_arena_window_cap
//                          the same with gemma-2's local-layer sliding
//                          window and attention softcap (either may be
//                          0), kept out of the entry above by a template
//                          flag (paged_split.cuh).  A row that sees no
//                          position gives m = -inf, l = 0, out = 0 in
//                          both arena entries.
//
// Bound on this card: bytes.  Every visible K and V element is read once
// (2 bytes fp, or 1 byte code + 4 bytes scale) for 2 flops per query row,
// far below the H100's ridge.  Design: paged_split.cuh's two launches.
// Phase A cuts each slot's view into chunks of 16-128 positions across
// blocks (1,584 blocks at the main shape: 6 slots, 8 KV heads, 33 chunks
// of 32) and writes the scores and each chunk's max; phase B gives each
// (slot, KV head, 16 channels) a block that sums p * v over the positions
// in order (384 blocks).  This kernel's sums run in the order of
// kernels/ref.py's paged_attention_arena_ref: each score as one warp takes
// it (lanes strided over D, then an xor butterfly), the denominator as a
// block of 128 threads takes it, each output in order over the positions.
// What still limits it (0.058 ms at the main shape on an H100, 4.4x the
// byte bound): latency in both phases (paged_split.cuh), and the f32
// per-channel scale pool (5 bytes per quant-resident element).
#include "paged_split.cuh"

namespace {
constexpr int kLWidth = 128;  // l: 128 strided partial sums (4 warps)
}  // namespace

extern "C" int paged_attention(const void* q, int q_is_bf16,
                               const void* k_codes, const float* k_scale,
                               const void* v_codes, const float* v_scale,
                               const int32_t* block_tables,
                               const int32_t* kv_lens, float* ws, void* out,
                               int b, int hkv, int gq, int d, int pps, int ps,
                               int bits, int group, float sm_scale,
                               void* stream) {
  PallasPages pages{static_cast<const uint8_t*>(k_codes), k_scale,
                    static_cast<const uint8_t*>(v_codes), v_scale,
                    hkv, ps, d, bits, group};
  if (q_is_bf16)
    return split_launch<false, false, true, kLWidth, PallasPages,
                        __nv_bfloat16>(
        q, pages, block_tables, kv_lens, nullptr, ws, out, nullptr, nullptr,
        b, gq, gq, d, pps, ps, sm_scale, stream);
  return split_launch<false, false, true, kLWidth, PallasPages, float>(
      q, pages, block_tables, kv_lens, nullptr, ws, out, nullptr, nullptr, b,
      gq, gq, d, pps, ps, sm_scale, stream);
}

extern "C" int paged_attention_arena(
    const void* q, const void* k_pool, const void* v_pool,
    const int8_t* k_codes, const float* k_scale, const int8_t* v_codes,
    const float* v_scale, const int32_t* block_tables, const int32_t* kv_lens,
    const int32_t* quant_lens, float* ws, void* out, float* m, float* l,
    int b, int hkv, int gq, int d, int pps, int ps, float sm_scale,
    void* stream) {
  ArenaPages pages{static_cast<const __nv_bfloat16*>(k_pool),
                   static_cast<const __nv_bfloat16*>(v_pool),
                   k_codes, k_scale, v_codes, v_scale, hkv, ps, d};
  return split_launch<true, false, true, kLWidth, ArenaPages, __nv_bfloat16>(
      q, pages, block_tables, kv_lens, quant_lens, ws, out, m, l, b, gq, gq,
      d, pps, ps, sm_scale, stream);
}

extern "C" int paged_attention_arena_window_cap(
    const void* q, const void* k_pool, const void* v_pool,
    const int8_t* k_codes, const float* k_scale, const int8_t* v_codes,
    const float* v_scale, const int32_t* block_tables, const int32_t* kv_lens,
    const int32_t* quant_lens, float* ws, void* out, float* m, float* l,
    int b, int hkv, int gq, int d, int pps, int ps, float sm_scale,
    int window, float softcap, void* stream) {
  ArenaPages pages{static_cast<const __nv_bfloat16*>(k_pool),
                   static_cast<const __nv_bfloat16*>(v_pool),
                   k_codes, k_scale, v_codes, v_scale, hkv, ps, d};
  return split_launch<true, false, true, kLWidth, ArenaPages, __nv_bfloat16,
                      true>(
      q, pages, block_tables, kv_lens, quant_lens, ws, out, m, l, b, gq, gq,
      d, pps, ps, sm_scale, stream, 1, window, softcap);
}
