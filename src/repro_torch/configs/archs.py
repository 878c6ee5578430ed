"""The 10 assigned architectures (exact configs from the assignment) plus the
paper's own evaluation models and a tiny byte-LM for the serving engine.

Each assigned arch also has per-file aliases under ``repro/configs/<id>.py``.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig

# --------------------------------------------------------------------------
# Assigned pool — LM-family transformers.
# --------------------------------------------------------------------------

# qwen3-4b [dense] 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936
#   qk_norm, GQA [hf:Qwen/Qwen3-8B]  (qwen3 family uses explicit head_dim=128)
QWEN3_4B = register(ModelConfig(
    name="qwen3-4b", family="dense", num_layers=36, d_model=2560,
    num_heads=32, kv_heads=8, d_ff=9728, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6,
))

# gemma2-9b [dense] 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000
#   local+global alternating, logit softcap [arXiv:2408.00118]
GEMMA2_9B = register(ModelConfig(
    name="gemma2-9b", family="dense", num_layers=42, d_model=3584,
    num_heads=16, kv_heads=8, d_ff=14336, vocab_size=256000, head_dim=256,
    attn_softcap=50.0, final_softcap=30.0, sliding_window=4096,
    local_global_period=2,
))

# granite-20b [dense] 52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152
GRANITE_20B = register(ModelConfig(
    name="granite-20b", family="dense", num_layers=52, d_model=6144,
    num_heads=48, kv_heads=1, d_ff=24576, vocab_size=49152,
))

# minicpm-2b [dense] 40L d_model=2304 36H (GQA kv=36 = MHA) d_ff=5760
#   vocab=122753 — WSD schedule (arch=llama-like) [arXiv:2404.06395]
MINICPM_2B = register(ModelConfig(
    name="minicpm-2b", family="dense", num_layers=40, d_model=2304,
    num_heads=36, kv_heads=36, d_ff=5760, vocab_size=122753,
    lr_schedule="wsd", tie_embeddings=True,
))

# jamba-v0.1-52b [hybrid] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
#   vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave (attn at index 4
#   of each 8-layer block), MoE every other layer [arXiv:2403.19887]
JAMBA_52B = register(ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", num_layers=32, d_model=4096,
    num_heads=32, kv_heads=8, d_ff=14336, vocab_size=65536,
    ssm=True, attn_period=8, attn_offset=4, ssm_state=16,
    moe=True, num_experts=16, experts_per_token=2, moe_period=2,
    sub_quadratic=True,
))

# whisper-small [audio] 12L d_model=768 12H d_ff=3072 vocab=51865
#   enc-dec, conv frontend (stub) [arXiv:2212.04356]
WHISPER_SMALL = register(ModelConfig(
    name="whisper-small", family="encdec", num_layers=12, d_model=768,
    num_heads=12, kv_heads=12, d_ff=3072, vocab_size=51865,
    encoder_decoder=True, enc_layers=12, dec_seq=448, frontend="audio",
))

# qwen2-vl-72b [vlm] 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064
#   M-RoPE, dynamic resolution [arXiv:2409.12191]
QWEN2_VL_72B = register(ModelConfig(
    name="qwen2-vl-72b", family="vlm", num_layers=80, d_model=8192,
    num_heads=64, kv_heads=8, d_ff=29568, vocab_size=152064,
    mrope=True, vision_prefix_frac=0.125, frontend="vision", rope_theta=1e6,
))

# llama4-scout-17b-a16e [moe] 48L d_model=5120 40H (GQA kv=8) d_ff=8192
#   MoE 16e top-1, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E]
LLAMA4_SCOUT = register(ModelConfig(
    name="llama4-scout-17b-a16e", family="moe", num_layers=48, d_model=5120,
    num_heads=40, kv_heads=8, d_ff=8192, vocab_size=202048,
    moe=True, num_experts=16, experts_per_token=1, num_shared_experts=1,
    rope_theta=5e5,
))

# deepseek-moe-16b [moe] 28L d_model=2048 16H (MHA kv=16) d_ff=1408
#   vocab=102400, 2 shared + 64 routed top-6, fine-grained; dense layer 0
#   [arXiv:2401.06066]
DEEPSEEK_MOE_16B = register(ModelConfig(
    name="deepseek-moe-16b", family="moe", num_layers=28, d_model=2048,
    num_heads=16, kv_heads=16, d_ff=1408, vocab_size=102400,
    moe=True, num_experts=64, experts_per_token=6, num_shared_experts=2,
    moe_dense_prefix=1,
))

# falcon-mamba-7b [ssm] 64L d_model=4096 (attn-free) vocab=65024 ssm_state=16
FALCON_MAMBA_7B = register(ModelConfig(
    name="falcon-mamba-7b", family="ssm", num_layers=64, d_model=4096,
    num_heads=1, kv_heads=1, d_ff=0, vocab_size=65024,
    ssm=True, ssm_state=16, sub_quadratic=True,
))

# --------------------------------------------------------------------------
# The paper's own evaluation models (Sec. 7.1) — extra configs.
# --------------------------------------------------------------------------
QWEN25_7B = register(ModelConfig(
    name="qwen2.5-7b", family="dense", num_layers=28, d_model=3584,
    num_heads=28, kv_heads=4, d_ff=18944, vocab_size=152064, rope_theta=1e6,
))

LLAMA31_8B = register(ModelConfig(
    name="llama3.1-8b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, kv_heads=8, d_ff=14336, vocab_size=128256, rope_theta=5e5,
))

QWEN25_32B = register(ModelConfig(
    name="qwen2.5-32b", family="dense", num_layers=64, d_model=5120,
    num_heads=40, kv_heads=8, d_ff=27648, vocab_size=152064, rope_theta=1e6,
))

# --------------------------------------------------------------------------
# Tiny byte-LM: the reference model for the quality proxy + serving engine.
# --------------------------------------------------------------------------
TINY_LM = register(ModelConfig(
    name="tiny-lm", family="dense", num_layers=4, d_model=128,
    num_heads=4, kv_heads=2, d_ff=384, vocab_size=259, head_dim=32,
    tie_embeddings=True,
))
