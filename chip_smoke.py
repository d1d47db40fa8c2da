"""Smoke run of the PyTorch port on one CUDA card: builds the kernels from
``ominix_mlx_tpu_torch/csrc``, checks each against its plain PyTorch version
at the main paths' shapes (and times it beside its bound and, where one
PyTorch call computes the same function, that call), and drives the
port's main paths on full-width Qwen3-4B and full-width, full-depth
Qwen3-30B-A3B with random weights (seeded):

  - serve: HTTP chat requests on w4a8 weights, one at a time (K1, K2),
    the kernel-vs-plain logits check and the batch-1 decode rate;
  - serve_q8: the same on w8a8 group-64 weights held in panels (K1's 8-bit
    modes at one row and at the 16-token bucket);
  - prefill_chunked: an 8192-token bf16 prefill in 2048-token chunks (K2
    then K2c), against a single-shot prefill;
  - batch_decode: w8a8 decode at batch 8 over a dense and a paged cache
    (K3), aggregate tok/s;
  - serve_batched: concurrent HTTP chat requests on a batched server (w8a8,
    paged int8 KV pool, prefix cache): chunked adoption (K2, K2c), a prefix
    hit (K2c), int8 paged decode (K3), streaming and sampling;
  - generate_rows: the bf16 weights quantized at 4 and 8 bits without
    fusion (row-major, as ``generate.py --quantize`` does), Engine.generate
    on 12- and 40-token prompts (K6 at 16 rows and at one, K7 at 64 rows);
  - serve_batched_w4: enable_batching(quantize_bits=4), four concurrent
    chat requests (K7 at adoption, K1's dq formula at the batch decode);
  - serve_moe: HTTP chat requests on Qwen3-30B-A3B w4a8 (every MoE layer's
    decode through K4, two launches a layer: gate and up in one, down;
    every prefill of more than 8 tokens through K5 on
    the packed experts, no dequantize_experts), a profiled 128-token
    prefill (moe_prefill: wall, device busy, peak memory), the
    kernel-vs-plain logits check, the batch-1 decode rate, and a batch-8
    decode over a paged cache (K4 at 8 and 64 rows, K3 at 8 query heads
    per KV head);
  - serve_moe_q8: the same chat requests on Qwen3-30B-A3B w8a8 group-64
    (K1 8-bit on panels, K4 8-bit at decode, K5 on the 8-bit experts at
    prefill), its moe_prefill line, logits check and decode rate;
  - serve_moe_batched_w8: Qwen3-30B-A3B with channel-int8 experts on a
    batched server, 8 concurrent chat requests each equal to the same
    request alone (K8 at decode, the exact int8 all-expert pass at
    adoption, K3); then a bf16 cut of 8 layers: the chat requests on its
    bf16 experts (serve_moe_bf16: K5 bf16 at prefill), and
    enable_batching(quantize_bits=8) converting it;
  - serve_mistral: Mistral-7B-Instruct-v0.2 w4a8 at full width and depth,
    the same chat requests (K1, the dq kernel, K2), logits check and
    decode rate;
  - serve_glm4: GLM-4-9B-0414 w4a8 at full width and depth (sandwich
    norms, q/k/v biases, partial interleaved RoPE; down_proj on the dense
    route, its share of the step printed), the same checks; then channel
    w8a8 at batch 8 over a paged cache (K3 at 16 query heads a KV head,
    every call held per (row, head) against its plain version);
  - prefill_window: bf16 Mistral-7B-v0.1 (sliding window 4096), an
    8192-token prefill in 2048-token chunks (K2, then K2c, each with the
    window) against single-shot prefills through K2 and through the plain
    versions, then decode steps on a paged cache (K3 with the window);
  - load_checkpoint: a 2-layer GLM-4-9B-width checkpoint written in HF
    names by the port's writer (two shards and an index), loaded onto the
    card through models.registry (every tensor bit-equal, seconds and
    GB/s), quantized and served one HTTP request; and the same weights as
    an MLX 4-bit checkpoint, loaded as QuantizedTensor weights;
  - serve_deepseek_v2_lite, serve_mixtral, serve_glm4_moe: DeepSeek-V2-Lite
    (MLA over the latent cache, a dense first layer, shared experts),
    Mixtral-8x7B-v0.1 and GLM-4.5-Air (96 query heads over 8 KV heads, a
    dense first layer, a shared expert) at full width, w4a8 g64: the route
    each projection takes, 4 HTTP chat requests one at a time and 8 at
    once on a batched server, a 128-token prefill (wall, device busy, peak
    memory), the batch-1 decode rate and decode at batch 8 (Mixtral and
    GLM-4.5-Air over a paged cache: K3, its first step held per call
    against its plain version; DeepSeek over the dense latent cache, and
    its greedy tokens after a 40-token prefill equal on two runs);
  - serve_qwen3_next: Qwen3-Next-80B-A3B-Instruct at full width and all
    48 layers (36 Gated DeltaNet, 12 gated attention; 512 experts top 10
    and a gated shared expert), w4a8 g64, about 45 GB: the route of each
    projection, 4 HTTP chat requests one at a time with k9_decode at
    every decode step, k9_prep and K9 at prompts (in the form k9_plan
    picks: recurrent under 48 tokens, chunked from it), K2, K4 and K5
    launched exactly as many times as their forwards need, a 128-token
    prefill, the logits check on 4 layers (every k9_decode, k9_prep and
    K9 call against its plain version, and each prologue and rule
    together against both plain versions), the decode rate, and 8
    concurrent requests on the dense continuous batcher, each equal to
    the same request alone;
  - serve_minicpm_sala: MiniCPM-SALA at its published widths and all 32
    layers (8 InfLLMv2 sparse, 24 lightning), w8a8 g64, about 10 GB: the
    route of each projection, 4 HTTP chat requests one at a time with
    K10 (in the form k10_plan picks at prompts, k10_decode at decode),
    K11 (k11_select and k11_attend), K2 and K1 launched exactly as many
    times as their forwards need, a 128-token prefill, the logits check
    on 4 layers (every K10 and K11 call against its plain version; also on
    a 200-token prompt with a 2-token continuation), the decode rate, an
    8194-token chunked prefill (K2, then K2c; K10's recurrent form on the
    last 2 tokens) and 16 decode steps that select the top 64 of about 190
    blocks, 8 concurrent requests on the dense batcher each equal to the
    same request alone, and decode over caches filled to 65536 and 524288
    tokens (ms/token, K11's share);
  - serve_moxin: Moxin-7B at its published widths (DINOv2 ViT-L/14 with
    4 registers and SigLIP SO400M/14 at 224 px, bf16; the 2176 -> 8704 ->
    4096 -> 4096 projector; the Mistral-7B decoder at w8a8 g64 on panels),
    registered with Server.add_model beside its decoder as a chat model:
    over HTTP at once a content-array chat with a 320x240 PNG data URI, a
    /v1/describe and a plain chat (K2 at each prefill, K1's 8-bit P
    formula at each decode step), the image chat equal to the model's own
    chat; the towers' ms, the decoder's prefill ms, the replayed decode
    tok/s, the decoder's logits check on 2 layers, and the request against
    its plain version (pipeline_vs_plain: the prefill's logits, the greedy
    tokens);
  - serve_ocr2: DeepSeek-OCR-2 at its published widths (SAM ViT-B/16 at
    1024 px with the 896-channel adapter, the 24-layer Qwen2 visual flow,
    the 896 -> 1280 projector, the 12-layer MoE decoder at w4a8 g64, 64
    experts top 6, 2 shared, layer 0 dense): /v1/ocr on a PNG and on a
    one-page PDF (K2 and K5 at the prefill, K4 and K1 at decode), SAM's
    and the flow's ms, the prefill ms, the replayed decode tok/s and the
    gathered K = 896 down projection's share of a step, the decoder's
    logits check on 2 layers, and the request against its plain version;
  - serve_paraformer: Paraformer-large at its published widths (50 + 16
    SAN-M blocks, 512 wide, vocabulary 8404), bf16: a 30 s WAV to
    /v1/audio/transcriptions answered as the model's own transcribe (K12,
    CIF, once, never its plain loop), K12 bit for bit against its plain
    loop at the clip's shapes (k12), the split and the RTF;
  - serve_qwen3_asr: Qwen3-ASR, the AuT encoder (bf16) and the Qwen3-0.6B
    decoder at w8a8 g64 on panels: a 30 s WAV transcribed over HTTP (K2 at
    the spliced prefill, K1's 8-bit P formula at every decode step), the
    split, the replayed decode tok/s, the RTF and the decoder's logits
    check on 2 layers;
  - serve_funasr_nano: Fun-ASR-Nano, the Paraformer-large encoder, the
    adaptor and the Qwen3-0.6B decoder, bf16: a 30 s WAV transcribed and
    a 45 s one translated (translate_long, two chunks) over HTTP (K2 at
    each prefill), the split, the RTF and the logits check;
  - serve_qwen3_tts: Qwen3-TTS with the 1.7B talker (bf16 and w8a8 g64),
    the e2e row's codec, the speech and ECAPA speaker encoders: each
    talker's frame step captured once and replayed (K2 inside the graph
    at the code predictor's prefill, K1 at one row at w8a8), held bit for
    bit against its eager body over 60 frames, a profile of replayed
    frames, ms a frame both ways in turns (eager over 8 frames of one
    request), the 2-layer card-vs-plain check with its planted fault; one
    /v1/audio/speech request over HTTP equal to the model's own
    synthesis (no capture), a voice-clone request from a 3 s clip, the
    split and the RTF; and float32 convolutions against float64
    (conv_tf32).

  - batcher_graph (Qwen3-4B channel w8a8 over a dense cache and a paged
    int8 pool, Qwen3-30B-A3B w4a8 paged, MiniCPM-SALA dense): the
    continuous batcher's step at 8 slots replayed from its captured
    greedy and sampled bodies against the same steps run eagerly: logits
    (difference 0), tokens and launches held; captures, pool, host time
    of a replay, aggregate tok/s both ways in turns;
  - speculative (Qwen3-4B w4a8: the target as its own draft, a 9-layer
    self-draft, and that draft with force_accept; Qwen3-4B channel w8a8,
    whose tokens must equal plain greedy's; MiniCPM-SALA's 8-layer
    self-draft at a 4096-token cache): SpeculativeEngine at batch 1, 4
    drafts a round, its replayed rounds held against eager ones, the
    tokens against plain greedy, acceptance, and replayed tok/s against
    plain replayed decode; serve_speculative_batched: a batched server
    whose batcher speculates (8 slots, 4 drafts), 8 concurrent greedy
    requests against the per-request engine path's answers and one
    sampled one: on w4a8 with a 9-layer self-draft (answers read: its
    verify at 40 rows takes the dense route), and on channel w8a8 with
    the target as its own draft and the 9-layer self-draft (every answer
    equal to the engine path's, held).

Every path that goes through Engine.generate, generate_scan or
generate_batch (the single-request server, decode_rate, the batch-8
decodes) replays the engine's decode step captured as a CUDA graph, and
every continuous batcher (the batched servers, hybrid_batched) replays
its step's captured bodies. Each family's ``decode_graph`` line (Qwen3-4B
and Qwen3-30B-A3B w4a8, Qwen3-30B-A3B channel w8a8, Mistral-7B, GLM-4-9B,
DeepSeek-V2-Lite, Mixtral-8x7B, GLM-4.5-Air, Qwen3-Next-80B-A3B and
MiniCPM-SALA) holds 17 steps of the captured step against the step's
eager body from one prefilled state: logits, tokens and launch counts,
the capture's ms, the graph pool, the host time of a replay and tok/s
both ways in turns; ``minicpm_long_decode`` times it over its long
caches beside the eager loop.

The kernel checks include K2 and K2c with the sliding window (k2_window,
k2c_window: T=8192 and the 8k prefill's last chunk, windows 4096 and
4000, 8 and 2 KV heads), K3 at GLM-4.5-Air's 12 query heads a KV head,
and K5 at Mixtral's down projection (K = 14336, whose scales it streams)
at 4 and 8 bits; and at Qwen3-Next's shapes K9 (k9: the recurrent form at
one token, batch 1 and 8; the chunked form at prompts of 128, 2048 and
8192 tokens; k9_vs_recurrent: both forms in turns at 128 and 2048), its
prologue k9_prep (one token at batch 1 and 8, a 128-token prompt; beside
the plain version's time and device operations), k9_decode (a DeltaNet
layer's decode mixer at batch 1 and 8, beside the parent's sequence of
k9_prep, K9 and the glue in turns), K2 at 16 over 2 heads
of 256 (k2_d256), K4 over 512 experts top 10 (k4_e512) and K5 on 512
packed experts at a 128-token prompt's 1280 rows; and at MiniCPM-SALA's
shapes K10 (k10: the recurrent form at batch 1 and 8; the chunked form
at prompts of 128, 2048 and 8192 tokens; k10_crossover: both forms in
turns at 2-128 tokens; k10_decode: a lightning layer's decode mixer at
batch 1 at positions 0, 4095 and 524287 and batch 8 at ragged ones,
beside the parent's sequence of glue and K10 in turns) and K11
(k11_score, k11_select, k11_attend: batch 1 at 4096, 65536 and 524288
cached tokens, batch 8 at ragged totals near 16384, each beside its plain
version and its bound; the selector beside the parent's score and
torch.topk in turns and torch.topk alone).

    python3 chip_smoke.py              # build, check, drive every path
    python3 chip_smoke.py --profile    # the same, then a decode profile
    python3 chip_smoke.py --parent DIR # K3, K1/K6 (qmm_p), K5 (bf16,
                                       # 4- and 8-bit), the DeltaNet and
                                       # K10 decode mixers, K11's
                                       # selection, the 128-token MoE
                                       # prefill and the generate_scan
                                       # decode rates against another
                                       # checkout's

The kernel checks end with a ``launch_floor`` line: an empty kernel's
device time on an idle card, alone and behind a one-CTA kernel.

Each phase prints one JSON line; any failure raises and the script exits
non-zero without a result line. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It exits non-zero at once where ``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import dataclasses
import functools
import gc
import json
import os
import pstats
import re
import socket
import statistics
import subprocess
import sys
import time
import urllib.request

import torch
import torch.nn.functional as F

EPS = 1e-6
GS = 64
SEED = 0
MAX_TOKENS = 32
# (name, N, K, RMSNorm fused at decode) for every K1 shape of one decode
# token of Qwen3-4B: 36 x (qkv, o, gate_up, down) + the tied lm_head
K1_SHAPES = (("qkv_proj", 6144, 2560, True), ("o_proj", 2560, 4096, False),
             ("gate_up_proj", 19456, 2560, True),
             ("down_proj", 2560, 9728, False),
             ("lm_head", 151936, 2560, True))
K2_T = (16, 128, 777, 2048)
# (pos, Tq) of K2c: the 8k prefill's chunks at 2048 and 6144, and ragged
K2C_SHAPES = ((2048, 2048), (6144, 2048), (128, 100), (300, 17))
# K2 and K2c with Mistral-7B-v0.1's sliding window (4096) and one that is
# not a multiple of the 128-key tile: K2 over an 8192-token prompt, K2c
# on the 8k prefill's last chunk
K2W_T = 8192
K2W_WINDOWS = (4096, 4000)
K2CW_POS_T = (6144, 2048)
# HF config.json widths of Mistral-7B (v0.1 and Instruct-v0.2 differ only
# in rope_theta and sliding_window; bench.py:49-52) and GLM-4-9B-0414
# (bench.py:55-59)
MISTRAL_7B_HF = {"model_type": "mistral", "vocab_size": 32000,
                 "hidden_size": 4096, "num_hidden_layers": 32,
                 "num_attention_heads": 32, "num_key_value_heads": 8,
                 "head_dim": 128, "intermediate_size": 14336,
                 "rms_norm_eps": 1e-5, "tie_word_embeddings": False}
GLM4_9B_HF = {"model_type": "glm4", "vocab_size": 151552, "hidden_size": 4096,
              "num_hidden_layers": 40, "num_attention_heads": 32,
              "num_key_value_heads": 2, "head_dim": 128,
              "intermediate_size": 13696, "partial_rotary_factor": 0.5,
              "attention_bias": True, "rope_theta": 10000.0,
              "rms_norm_eps": 1e-5, "tie_word_embeddings": False}
# HF config.json widths of the MoE families: Mixtral-8x7B-v0.1,
# GLM-4.5-Air and DeepSeek-V2-Lite (q_lora_rank null, yarn factor 40)
MIXTRAL_8X7B_HF = {"model_type": "mixtral", "vocab_size": 32000,
                   "hidden_size": 4096, "num_hidden_layers": 32,
                   "num_attention_heads": 32, "num_key_value_heads": 8,
                   "intermediate_size": 14336, "num_local_experts": 8,
                   "num_experts_per_tok": 2, "rope_theta": 1e6,
                   "rms_norm_eps": 1e-5, "sliding_window": None,
                   "tie_word_embeddings": False}
GLM45_AIR_HF = {"model_type": "glm4_moe", "vocab_size": 151552,
                "hidden_size": 4096, "num_hidden_layers": 46,
                "num_attention_heads": 96, "num_key_value_heads": 8,
                "head_dim": 128, "intermediate_size": 10944,
                "moe_intermediate_size": 1408, "n_routed_experts": 128,
                "num_experts_per_tok": 8, "n_shared_experts": 1,
                "first_k_dense_replace": 1, "norm_topk_prob": True,
                "routed_scaling_factor": 1.0, "n_group": 1, "topk_group": 1,
                "partial_rotary_factor": 0.5, "attention_bias": True,
                "use_qk_norm": False, "rope_theta": 1e6,
                "rms_norm_eps": 1e-5, "tie_word_embeddings": False}
DEEPSEEK_V2_LITE_HF = {
    "model_type": "deepseek_v2", "vocab_size": 102400, "hidden_size": 2048,
    "num_hidden_layers": 27, "num_attention_heads": 16,
    "num_key_value_heads": 16, "intermediate_size": 10944,
    "q_lora_rank": None, "kv_lora_rank": 512, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "n_routed_experts": 64,
    "num_experts_per_tok": 6, "n_shared_experts": 2,
    "moe_intermediate_size": 1408, "first_k_dense_replace": 1,
    "norm_topk_prob": False, "routed_scaling_factor": 1.0, "n_group": 1,
    "topk_group": 1, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
    "rope_scaling": {"type": "yarn", "factor": 40, "mscale": 0.707,
                     "mscale_all_dim": 0.707, "beta_fast": 32,
                     "beta_slow": 1,
                     "original_max_position_embeddings": 4096},
    "tie_word_embeddings": False}
# HF config.json of Qwen/Qwen3-Next-80B-A3B-Instruct: 48 layers, three
# Gated DeltaNet layers to one gated attention layer (16 query heads over
# 2 KV heads of 256, partial RoPE over 64 dims), 512 experts top 10 and a
# gated shared expert of 512
QWEN3_NEXT_80B_HF = {
    "model_type": "qwen3_next", "vocab_size": 151936, "hidden_size": 2048,
    "num_hidden_layers": 48, "num_attention_heads": 16,
    "num_key_value_heads": 2, "head_dim": 256, "intermediate_size": 5120,
    "moe_intermediate_size": 512, "shared_expert_intermediate_size": 512,
    "num_experts": 512, "num_experts_per_tok": 10, "norm_topk_prob": True,
    "decoder_sparse_step": 1, "mlp_only_layers": [],
    "full_attention_interval": 4, "linear_conv_kernel_dim": 4,
    "linear_key_head_dim": 128, "linear_num_key_heads": 16,
    "linear_num_value_heads": 32, "linear_value_head_dim": 128,
    "partial_rotary_factor": 0.25, "rope_theta": 10000000,
    "rms_norm_eps": 1e-6, "hidden_act": "silu", "tie_word_embeddings": False}
QWEN3_NEXT_E = 512
# (B, T) of K9 at Qwen3-Next's widths (16 key heads, 32 value heads,
# dk = dv = 128): decode at batch 1 and 8 (the recurrent form), the
# 128-token prefill, a 2048-token chunk and an 8192-token prompt (the
# chunked form); the recurrent and the chunked form in turns at K9_TURNS
K9_SHAPES = ((1, 1), (8, 1), (1, 128), (1, 2048), (1, 8192))
K9_TURNS = (128, 2048)
# prompt lengths at which both forms are timed in turns at B = 1: where
# they meet sets ops/gated_delta.py K9_CHUNK_MIN_T
K9_CROSSOVER_T = (16, 32, 48, 64, 96)
# (B, T) of k9_prep: decode at batch 1 and 8, the 128-token prefill
K9_PREP_SHAPES = ((1, 1), (8, 1), (1, 128))
# B of k9_decode, a DeltaNet layer's decode mixer, at Qwen3-Next's heads
K9_DECODE_B = (1, 8)
# HF config.json of openbmb/MiniCPM-SALA (as the model-configs catalog
# records it): 32 layers, 8 InfLLMv2 sparse layers ("minicpm4": 32 query
# heads over 2 KV heads of 128, QK-norm, no RoPE) and 24 lightning layers
# (32 heads of 128, RoPE, an output norm and gate); it has no
# sparse_config block, so the JAX SparseConfig defaults hold (kernel 32,
# block 64, one init block, window 2048, top 64)
MINICPM_SALA_HF = {
    "model_type": "minicpm_sala", "vocab_size": 73448, "hidden_size": 4096,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 2, "head_dim": 128, "intermediate_size": 16384,
    "tie_word_embeddings": False, "scale_emb": 12, "scale_depth": 1.4,
    "dim_model_base": 256, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
    "qk_norm": True, "attn_use_rope": False, "lightning_use_rope": True,
    "lightning_nh": 32, "lightning_head_dim": 128, "use_output_gate": True,
    "use_output_norm": True, "max_position_embeddings": 524288,
    "mixer_types": ["minicpm4" if i in (0, 9, 16, 17, 22, 29, 30, 31)
                    else "lightning-attn" for i in range(32)]}
# (B, T) of K10 at MiniCPM-SALA's 32 heads of 128: decode at batch 1 and 8
# (the recurrent form), the 128-token prefill, a 2048-token chunk and an
# 8192-token prompt (the chunked form)
K10_SHAPES = ((1, 1), (8, 1), (1, 128), (1, 2048), (1, 8192))
# prompt lengths at which both forms are timed in turns at B = 1: where
# they meet sets ops/lightning_attention.py K10_CHUNK_MIN_T
K10_CROSSOVER_T = (2, 3, 4, 6, 8, 16, 24, 64, 128)
# prompt lengths at which --parent times the parent's chunked form (the
# earlier two launches through a float32 scratch) against this one, in
# turns
K10_PARENT_T = (128, 2048, 8192)
# (B, cache positions, totals) of K11: batch 1 at 4096, 65536 and 524288
# tokens, and batch 8 with ragged totals near 16384
K11_CASES = ((1, 4096, (4096,)), (1, 65536, (65536,)),
             (1, 524288, (524288,)),
             (8, 16384, (16384, 16320, 16383, 16200, 15000, 16350, 12000,
                         16384)))
# (B, positions) of k10_decode, a lightning layer's decode mixer, at
# MiniCPM-SALA's 32 heads of 128: batch 1 at the first position, after a
# 4096-token context and at the last of 524288; batch 8 at ragged positions
K10_DECODE_CASES = ((1, 0), (1, 4095), (1, 524287),
                    (8, (0, 1, 4095, 4096, 70000, 131071, 524287, 9)))
# decode over a cache filled at random up to these offsets
MINICPM_LONG_OFFSETS = (65536, 524288)
# (name, T rows, k slots, N, K) of K4 on Qwen3-Next-80B-A3B's 512 experts,
# top 10: gate/up at one decode row, down at its 10 (row, slot) pairs
K4_NEXT_SHAPES = (("gate_up", 1, 10, 512, 2048), ("down", 10, 1, 2048, 512))
# (name, S rows, N, K) of K5 there: a 128-token prompt routes S = 1280
# token copies over 512 experts (about 2.5 a group)
K5_NEXT_SHAPES = (("gate", 1280, 512, 2048), ("down", 1280, 2048, 512))
K3_LENGTHS = (1, 127, 128, 129, 700, 1500, 2047, 2048)
# (name, lengths, pages per row) of K3's timed shapes, Qwen3-4B heads at
# page 128: the ragged batch of 8, a uniform batch of 8 x 2048, and one
# long request of 32768 tokens on the batched server
K3_SHAPES = (("B8_ragged", K3_LENGTHS, 16), ("B8x2048", (2048,) * 8, 16),
             ("B1x32768", (32768,), 256))
# (name, T rows, k slots, N, K) of K4 on Qwen3-30B-A3B: gate/up at one and
# at 8 decode rows (k = 8), down at 8 and 64 rows (M * k rows, one id each)
K4_SHAPES = (("gate_up", 1, 8, 768, 2048), ("gate_up", 8, 8, 768, 2048),
             ("down", 8, 1, 2048, 768), ("down", 64, 1, 2048, 768))
# (name, S rows, N, K) of K5 on Qwen3-30B-A3B's 128 experts: a 2048-token
# prefill routes S = 16384 token copies, the 16-token bucket 128
K5_SHAPES = (("gate", 16384, 768, 2048), ("down", 16384, 2048, 768),
             ("gate", 128, 768, 2048), ("down", 128, 2048, 768))
# K5 on packed experts: the 16-token bucket, the 128-token prefill (S =
# 1024) and a 2048-token one, gate (and up) and down
K5_PACKED_SHAPES = (("gate", 768, 2048), ("down", 2048, 768))
K5_PACKED_S = (128, 1024, 16384)
# K5 on Mixtral-8x7B's down projection (8 experts, N = 4096, K = 14336:
# 224 groups of 64 a row, whose scales K5 streams instead of staging):
# the 128-token prefill (S = 256 token copies) and a 2048-token one
K5_MIXTRAL_DOWN = ("down_mixtral", 8, 4096, 14336)
K5_MIXTRAL_S = (256, 4096)
MOE_E = 128
K4_TOL = 1e-2     # max error over max |plain| per (row, slot)
# K5 vs its float32 plain version, max error over max |plain|: both sum
# bf16 products in float32 (read 1.1e-6 to 2.8e-6 on the H100); a bf16
# output or accumulator would read about 4e-3. Packed experts are held to
# the same limit: the kernel dequantizes with the plain version's rounding
K5_TOL = 1e-4
# the card's published peaks (H100 SXM data sheet, dense, at 700 W): the
# least time a kernel could take is the larger of bytes over the memory
# rate and operations over the rate for their type
HBM_BYTES_PER_S = 3.35e12
SPIN_CYCLES = 200_000   # ~0.1 ms at the H100's clock: see time_ms
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12,
                  "tf32": 495e12}
K1_TOL = 1e-2     # max error / max |plain|: bf16 output, another sum order
K2_TOL = 1e-2     # the same for K2's and K2c's bf16 output
K2_LSE_TOL = 1e-2  # max abs error of K2's float32 row LSE (wrong scores)
# K9 vs its plain version, max error over max |plain| of the outputs and
# of the final state: both sum in float32, in another order (the card
# tests read at most this at T = 1000 and r = 2)
K9_TOL = 1e-4
# k9_prep vs its plain version, max error over max |plain| of each of q,
# k, v, g, beta (the l2norm's sum of squares in another order moves q and
# k by an ulp or two; v, g and beta are the same roundings); the window it
# writes is held bit for bit
K9_PREP_TOL = 1e-5
# k9_decode vs its plain version: q and k within K9_PREP_TOL of the plain
# ones and o a float32 sum in another order, so an element of o cast to
# bf16 may take the other neighbour (at most one ulp of the value head's
# largest), the norm's mean moves by a fraction of an ulp, and the three
# roundings after it (the normalized value, the weight's product, the
# gate's product) each add at most one: within this many bf16 ulps of the
# value head's largest |plain| output (spacing 2^(floor(log2 max) - 7)).
# Against k9_prep then K9 and the same glue it is held to the same limit;
# its state and window equal theirs bit for bit.
K9_DECODE_ULPS = 4
# K10 vs its plain version, max error over max |plain| of the outputs and
# of the final state: float32 sums in another order (3xTF32 products in
# the chunked form)
K10_TOL = 2e-5
# k10_decode vs its plain version: q, k and the state are the plain
# version's bits (the same roundings, PyTorch's reduction order), so an
# output element differs only where K10's float32 o (another sum order)
# rounds to the other bf16 neighbour, and the norm's, weight's and gate's
# products of the two round once more each: within this many bf16 ulps of
# the row's largest |plain| value (spacing 2^(floor(log2 max) - 7))
K10_DECODE_ULPS = 4
# k11_score: the finite scores' max error over their max |plain| (float32
# sums of the same bf16 products in another order); the masked ones
# NEG_INF in both
K11_SCORE_TOL = 1e-6
# k11_attend vs the gather plus masked sdpa given the same indices, per
# (row, head), as K3_TOL: both round the softmax weights to bf16
K11_TOL = 3e-2
K3_DESIGN = ("split-KV (flash-decoding): splits of whole pages from "
             "k3_plan (shapes only), a CTA per (split, KV head, row) with "
             "all its query heads; a CTA-wide cp.async ring of 64-key "
             "tiles (3 stages bf16, 4 int8, rows XOR-swizzled); q.K^T and "
             "P.V on mma.sync m16n8k16 (int8 codes widened to bf16 in "
             "shared memory); partials merged in split order by a second "
             "kernel")
QMM_P_DESIGN = ("the prologue (qmm_prep_pdl) then the rows kernel behind "
                "it by programmatic dependent launch: weight, scale and "
                "bias loads issued before griddepcontrol.wait; a warp owns "
                "1, 2 or 4 output rows (qmm_p_rows_per_warp; one with bf16 "
                "x), a lane 8 chunk loads in flight with int8 x (1-2 with "
                "bf16 x) and x's codes read once for all its rows; a lane's "
                "chunks in order, then a warp butterfly")
K2_DESIGN = ("tensor cores: wgmma (m64nBKk16 Q.K^T, m64nDk16 P.V from "
             "registers), TMA ring of K/V tiles, producer warpgroup")
DQ_DESIGN = ("tensor cores: wgmma m64nMPk16 with 64 output rows as A "
             "dequantized in registers (fma.rn.bf16x2, one rounding) and x "
             "staged once per CTA as B in shared memory (K permuted per "
             "128-column step); a per-thread cp.async ring of packed codes "
             "and scales (4 stages, 8 past 16 rows of x); K split by "
             "dq_plan where N cannot fill the card, partials summed in "
             "slice order")
GATHER_DESIGN = ("the prologue (qmm_prep_pdl for K4, chan_prep for K8) "
                 "then the rows kernel behind it by programmatic dependent "
                 "launch: expert id and first weight, scale and bias loads "
                 "before griddepcontrol.wait; gate and up in one launch; "
                 "8 rows a warp, in lane groups of 16 lanes a row (8 at "
                 "the 24-chunk 4-bit down rows: no idle lane; "
                 "gather_plan), 8 chunk loads a lane in flight, "
                 "x's codes read once for a group's rows; each row summed "
                 "in one order, a warp a row's (a lane's chunks, then the "
                 "butterfly, folded where a group stands for a warp)")
K9_DESIGN = ("the recurrent form (decode, prompts under "
             "K9_CHUNK_MIN_T): the loop over T inside one launch, a CTA of "
             "128 threads per (row, value head, 32 value columns), four "
             "threads a column holding dk/4 state rows in registers; each "
             "token's q and k staged in double-buffered shared memory (one "
             "barrier a token), the next token's inputs loaded while this "
             "one computes; S^T k and S^T q as four fma chains a thread, "
             "folded across a column's four lanes by two shuffles")
K9_CHUNK_DESIGN = ("the chunked (WY / UT-transform) form, chunks of 64 "
                   "tokens, every product on mma.sync m16n8k8 TF32 in "
                   "3xTF32: phase 1 (gated_delta_chunk, a CTA per chunk, "
                   "value head and row) K K^T and Q K^T on or below the "
                   "diagonal, masked before the exp, T = (I + A)^-1 by "
                   "forward substitution (four threads a column, two "
                   "shuffles a row), W and U0 into an 80 KiB scratch a "
                   "chunk; phase 2 (gated_delta_chunk_scan, a CTA per 32 "
                   "value columns, value head and row) the scan over "
                   "chunks, the state slice in four warps' accumulators, "
                   "W S and Q S, U, then P U beside K^T U; the next chunk's "
                   "tiles fetched by cp.async in two groups while this one "
                   "computes")
K9_PREP_DESIGN = ("one launch for the conv window, SiLU, l2norms and gates: "
                  "a warp per (q, k or v head, 16 tokens), dk/32 channels "
                  "a lane, the last K-1 inputs sliding through registers, "
                  "the l2norm one butterfly; the window read and written "
                  "by the first token tile's threads only (each channel by "
                  "one thread)")
K9_DECODE_DESIGN = ("a DeltaNet layer's decode mixer in one launch (the conv "
                    "window, SiLU, l2norms, gates, the state step, the "
                    "gated RMSNorm, the SiLU gate): a CTA of 128 threads "
                    "per (32 value columns, value head, row), the CTAs of "
                    "a (row, key head) one thread block cluster; the "
                    "state strip staged in shared memory by cp.async "
                    "before the dependent-launch wait; each CTA computes "
                    "its key head's q and k with k9_prep's arithmetic and "
                    "takes K9's fmaf chains (the state and the window "
                    "bit for bit as the pair's); the gated norm's partial "
                    "sums exchanged in distributed shared memory in "
                    "PyTorch's reduction order; the q|k window written "
                    "by one CTA after the cluster barrier")
K10_DESIGN = ("the recurrent form (decode, prompts under "
              "K10_CHUNK_MIN_T): the loop over T inside one launch, a CTA "
              "of 128 threads per (row, head, 32 value columns), four "
              "threads a column holding D/4 state rows in registers; each "
              "token's q and k staged in double-buffered shared memory (one "
              "barrier a token), the next token's loaded while this one "
              "computes; S^T q as four fma chains folded by two shuffles")
K10_CHUNK_DESIGN = ("the chunked form in one launch, chunks of 64 tokens: a "
                    "CTA per (32 value columns, head, row) walks the chunks "
                    "in order with the state's column block in wgmma "
                    "accumulators (no scratch in device memory, o written "
                    "once); bf16 q, k, v as exact operands, the float32 "
                    "ones (P, rev * V, the state) split once a chunk into "
                    "three bf16 pieces, stacked as extra B columns; two "
                    "warpgroups: Q K^T and P V (A = P's pieces from "
                    "registers) on one, Q S on the other, the state update "
                    "K^T (rev * V) split between them; V^T and the pieces "
                    "written by ldmatrix/stmatrix; the next chunk's q, k, v "
                    "by cp.async into a two-stage ring; a short final chunk "
                    "masked")
K10_DECODE_DESIGN = ("a lightning layer's decode mixer in one launch (QK-norm, "
                     "RoPE, the scale, the state step, the cast, the output "
                     "norm, the gate): a CTA of 128 threads per (32 value "
                     "columns, head, row), a thread owning 4 columns x 8 "
                     "state rows, loaded first as 16-byte vectors (before "
                     "the dependent-launch wait in the model's call); two "
                     "warps normalize and rotate q and k with the plain "
                     "path's roundings and PyTorch's reduction order (q, k "
                     "and the state bit for bit); the output norm spans the "
                     "row: each CTA writes its 32 bf16 values and draws a "
                     "ticket, the last sums the row in PyTorch's order, "
                     "normalizes and gates it (tickets kept per device)")
K11_SELECT_DESIGN = ("the block scores of k11_score (bit for bit: 8 lanes a "
                     "block holding two of its sum chains, 16 loads a lane "
                     "in flight, no branch around a sum) and their top k in "
                     "one launch: runs of 512 blocks a CTA, sorted in "
                     "chunks of 64 keys (score bits over the complement of "
                     "the index: equal scores by index) by counting ranks, "
                     "merged in index order by warp bitonic merges, chunks "
                     "with no valid block passed over; past 512 blocks one "
                     "list a CTA, the last ticket drawer merging them "
                     "(tickets and lists kept per device)")
K11_ATTEND_DESIGN = ("one launch: K3's split-KV flash-decoding over the "
                     "valid slots numbered densely (init, the finite top-k "
                     "blocks placed by their rank among the finite scores, "
                     "the window), splits of at least two 64-slot tiles "
                     "from k11_plan within one wave, a CTA per (split, KV "
                     "head, row) that first issues every independent load, "
                     "holds all 16 query heads as mma.sync m16n8k16's A "
                     "operand and runs a cp.async ring of three tiles, an "
                     "online softmax a warp; the partials merged in a fixed "
                     "tree by the CTAs that draw the last tickets (groups of "
                     "8 splits, then the groups), each ticket set back to "
                     "zero (buffers kept per device: no memset, no second "
                     "launch)")
K5_DESIGN = ("tensor cores: 128 expert rows as A (bf16 read by wgmma from "
             "128-byte-swizzled shared memory, or packed codes dequantized "
             "in registers with the plain version's rounding) against up "
             "to 128 rows of one group as B, NP = 8..128 picked per item "
             "(wgmma m64nNPk16; mma.sync for packed items of at most 32 "
             "rows); persistent CTAs, a producer thread's TMA rings of x "
             "and weight slots")
# K3 vs the gathered view + masked sdpa, held per (row, head): max error
# over max |plain| of that row and head, so a long row's small output is
# not measured against a length-1 row's raw V. The plain version rounds its
# softmax weights (and int8 pages' dequantized view) to bf16: an exact
# kernel reads at most 8.0e-3 at every shape of the card tests, while one
# page or one token left out of a row reads 0.11 or more (float64 model of
# the kernel on the CPU, the same inputs)
K3_TOL = 3e-2
# Kernel vs plain logits (check_logits), max error over max |plain|, 2
# layers. Each limit sits above every sound reading on the H100 (the kernel
# path, a second seed, the plain path with its sums reversed) and below the
# reading of a planted fault (every quantized matmul without its last
# group of K), both read by check_logits itself. K2 rounds its softmax
# weights to bf16 where the TPU kernel does, the plain version keeps them
# in float32, so K2 alone reads as much as a quantized kernel:
# - w4a8 on panels, exact copies (w4a16 / w8a16), Qwen3-30B-A3B: sound
#   readings up to 1.72e-2 (K2 alone on Qwen3-30B-A3B), the fault 8.5e-2
#   (w4a8 panels) and more
LOGITS_TOL = 2e-2
# - w8a8 on panels (a8 at every decode row): sound up to 2.22e-2 (K2
#   alone), the fault 0.328
W8A8_PANELS_LOGITS_TOL = 5e-2
# - row-major w4a8 / w8a8 (a8 at every prefill row too, where a one-ulp
#   flip moves int8 codes downstream): sound up to 5.32e-2, the fault 0.389
ROWS_A8_LOGITS_TOL = 0.1
# - MiniCPM-SALA w8a8 on panels, 4 layers (one InfLLMv2 sparse layer,
#   three lightning): sound up to 4.94e-2 (the kernel path; K11's attend
#   alone 4.84e-2, K2 alone 3.85e-2, the reversed control 3.22e-2: the
#   muP-scaled random layers pass a bf16 rounding on to the logits), the
#   fault 0.610
MINICPM_LOGITS_TOL = 0.1
# - w8a8 on panels with 8-bit experts, Qwen3-30B-A3B: sound up to 4.10e-2
#   (the kernel path, where one routed row of 38 picks another expert set
#   than the plain run, a router near-tie; the reversed control 3.81e-2,
#   each kernel alone at most 1.35e-2, K2), the fault 0.384
MOE_W8A8_LOGITS_TOL = 0.1
# chunked vs single-shot 8k prefill, last-token logits, bf16 through 36
# layers: read 0.0 on the H100 (K2c walks a query's key tiles in K2's
# order and cuBLAS gave the same rows at M=2048 and M=8192); the limit
# leaves room for a GEMM that sums the two M's in another order
PREFILL_TOL = 1e-2
# paged (K3) vs dense (sdpa) first decode step, w8a8 channel8 Qwen3-4B
# through 36 layers (read 2.09e-2 on the H100) and bf16 GLM-4-9B through 40
# (glm4_paged_witness); w8a8 channel8 GLM-4-9B is held at
# ROWS_A8_LOGITS_TOL (a8 at every row, as there)
PAGED_TOL = 5e-2
PREFILL_LEN, PREFILL_CHUNK = 8192, 2048
# Qwen3-Next's chunked prefill (1024 tokens in chunks of 256, every chunk
# at its exact width through the DeltaNet layers) vs a single-shot one,
# the last prompt token's logits and the next decode step's, max error
# over max |single-shot| of each: w4a8 through 48 layers, the chunks'
# products at other row counts (cuBLAS on the dense route, K5 items of
# other widths). Read 5.8e-3 (one bf16 ulp of the largest logit) and 0.0
# on the H100; the limit is check_logits' for w4a8 MoE models. The state
# forgotten at each chunk reads only 8.8e-3 to 1.5e-2 there (random
# weights make the last tokens depend little on those a chunk back), so
# that control is reported, not held: the CPU tests hold the carry in
# float32 (tests/test_torch_qwen3_next.py, chunked vs whole at 2e-4)
HYBRID_PREFILL_TOL = LOGITS_TOL
# - DeepSeek-OCR-2's decoder, w4a8 on panels with 4-bit experts (K = 896
#   down projections gathered): sound up to 1.94e-2 (the kernel path and
#   K1 alone; K2 alone and the reversed control 1.29e-2; K4 and K5 alone
#   0.0), the fault 0.145
OCR2_LOGITS_TOL = 5e-2
# an image request (serve_moxin, serve_ocr2) through the kernels against
# the same request through the plain versions, at full depth: the
# prefill's last-position logits (max error over max |plain|; read
# 1.24e-2 on Moxin-7B, 6.3e-3 on DeepSeek-OCR-2), and the plain logit gap
# of any greedy token the two runs choose differently (read 7.0e-3, one
# bf16 step of the largest logit, at 2 of Moxin's 16 steps)
IMAGE_LOGITS_TOL = 5e-2
BATCH = 8
# decode_graph: replays after the warm-up, and steps a turn of the timing
GRAPH_STEPS = 16


T0 = time.perf_counter()


def emit(obj):
    """One JSON line, with ``t_s``: seconds since the script started."""
    print(json.dumps({**obj, "t_s": round(time.perf_counter() - T0, 1)}),
          flush=True)


def free_device_memory():
    """Drop a finished phase's tensors: a shut-down server's objects hold
    the params in reference cycles, which only the cyclic collector
    frees; then return the cached blocks to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def row_rel_err(got, want) -> float:
    """max over rows (every index but the last) of max |got - want| over
    max |want| in that row."""
    g, w = got.float(), want.float()
    return ((g - w).abs().amax(-1)
            / w.abs().amax(-1).clamp_min(1e-12)).max().item()


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: bytes moved (each input read
    once, each output written once) over the memory rate, or operations
    over the peak rate for ``kind``, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "bound_ops": ops, "bound_kind": kind}


def versus(row: dict) -> dict:
    """share_of_bound (bound_ms / ms) and vs_library (ms / library_ms,
    null without a library time) of a kernel row."""
    lib = row["library_ms"]
    return {"share_of_bound": row["bound_ms"] / row["ms"],
            "vs_library": row["ms"] / lib if lib else None}


def time_library(fn, iters: int, flush):
    """(ms, None) of a PyTorch call that computes the same function as a
    kernel (timed as a yardstick only), or (None, reason) where the
    installed PyTorch refuses it."""
    try:
        return time_ms(fn, iters, flush), None
    except (RuntimeError, TypeError, NotImplementedError) as e:
        return None, f"{type(e).__name__}: {str(e)[:120]}"


def l2_flush(buf):
    """A call that evicts L2 by reading ``buf`` (256 MB, five times the
    H100's 50 MB L2). A read leaves L2 full of clean lines, so the timed
    kernel that follows shares DRAM with no write-back of dirty ones (a
    flush that writes the buffer would leave up to 50 MB to be written back
    under the timed kernel)."""
    words = buf.view(torch.int32)
    return lambda: words.max()


def time_ms(fn, iters: int, flush) -> float:
    """Median CUDA-event time of ``fn`` over ``iters`` launches, each
    after an L2 flush (the decode path finds every weight cold in L2).
    A device-side spin after the flush lets the host queue the start
    event and ``fn``'s launches before the card reaches them, so the
    window holds device time, not the host's time to enqueue a short
    kernel."""
    fn()
    times = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------ kernels -------

def int4pack(qt):
    """(packed weight, scales-and-zeros, None) for torch._weight_int4pack_mm
    (tinygemm: bf16 x against w = (u - 8) * scale + zero, u the unsigned
    code, the even k in a byte's high nibble), which computes K1's a16
    function with zero = qt's bias; or (None, None, reason) where the
    installed PyTorch refuses it."""
    if not hasattr(torch, "_weight_int4pack_mm"):
        return None, None, "torch._weight_int4pack_mm is not in this PyTorch"
    u = (qt.q.to(torch.int16) + 8).to(torch.uint8)
    try:
        w4 = torch._convert_weight_to_int4pack(
            ((u[:, 0::2] << 4) | u[:, 1::2]).contiguous(), 8)
    except (RuntimeError, TypeError) as e:
        return None, None, f"{type(e).__name__}: {str(e)[:120]}"
    sz = torch.stack([qt.scales, qt.biases], -1).transpose(0, 1).contiguous()
    return w4, sz, None


def random_packed(qm, g, dev, N, K, bits, act_bits=8):
    """A random QuantizedTensor [N, K] (codes, scales, biases from ``g``)
    and its packed weight."""
    from ominix_mlx_tpu_torch.core.quant import QuantizedTensor

    G, lim = K // GS, 1 << (bits - 1)
    qt = QuantizedTensor(
        q=torch.randint(-lim, lim, (N, K), generator=g, device=dev,
                        dtype=torch.int8),
        scales=((torch.rand(N, G, generator=g, device=dev) + 0.5)
                * (K ** -0.5 / lim)).bfloat16(),
        biases=(torch.randn(N, G, generator=g, device=dev)
                * (K ** -0.5 / 4)).bfloat16(),
        group_size=GS, bits=bits)
    return qt, qm.prepare(qt, act_bits=act_bits)


def qmm_row(kernel, x, pq, launch, plain, lib_call, lib_err, a8, **keys):
    """Check one quantized-matmul launch against its plain version and time
    both, beside the bound and, where ``lib_call`` is given, the PyTorch
    call computing the same function (dropped with its error where it
    disagrees with the plain version)."""
    M, K = x.shape
    N = pq.data.shape[0]
    G = K // GS
    got, want = launch(), plain()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{kernel} {keys}: non-finite")
    d = (got.float() - want.float()).abs().max().item()
    rel = row_rel_err(got, want)
    flush = keys.pop("flush")
    ms = time_ms(launch, 20, flush)
    plain_ms = time_ms(plain, 3, flush)
    lib = lib_rel = None
    if lib_call is not None:
        lib, lib_err = time_library(lib_call, 20, flush)
        if lib is not None:
            ly = lib_call().float()
            lib_rel = row_rel_err(ly, want)
            if not lib_rel < K1_TOL:          # not the same function
                lib, lib_err = None, f"disagrees: rel {lib_rel}"
    wbytes = N * K * pq.bits // 8 + 4 * N * G
    norm = keys.get("norm", False)
    row = {**keys, "N": N, "K": K, "M": M, "bits": pq.bits,
           "max_abs_err": d, "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
           "library_ms": lib, "library_error": lib_err,
           "library_rel_err": lib_rel, "GBps": wbytes / ms / 1e6,
           **bound(wbytes + 2 * M * (K + N) + (2 * K if norm else 0),
                   2 * M * N * K, "int8" if a8 else "bf16")}
    row.update(versus(row))
    emit({"phase": kernel, **row})
    if not rel < K1_TOL:
        raise RuntimeError(f"{kernel} {keys} M={M}: rel error {rel} >= "
                           f"{K1_TOL}")
    return row


def int4_library(w4, sz, x):
    """torch._weight_int4pack_mm on x, or None where no packed weight."""
    if w4 is None:
        return None
    return lambda: torch._weight_int4pack_mm(x, w4, GS, sz)


def check_k1(dev, flush):
    """K1 at Qwen3-4B's shapes: 4-bit M=1 w4a8 / w4a16 (the RMSNorm fused
    where the model fuses it) and the dq formula at M=2 and 16; 8-bit M=1
    w8a8 / w8a16 and the dq formula at M=8 and 16."""
    from ominix_mlx_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for bits in (4, 8):
        for name, N, K, norm in K1_SHAPES:
            qt, pq8 = random_packed(qm, g, dev, N, K, bits)
            pq16 = dataclasses.replace(pq8, act_bits=None)
            w4, sz, pack_err = (int4pack(qt) if bits == 4 else (
                None, None, "group-wise int8 weights: no PyTorch call"))
            del qt
            nw = (1 + 0.1 * torch.randn(K, generator=g,
                                        device=dev)).bfloat16()
            modes = ((("a8", 1), ("a16", 1), ("a16", 2), ("a16", 16))
                     if bits == 4 else
                     (("a8", 1), ("a16", 1), ("a16", 8), ("a16", 16)))
            for mode, M in modes:
                a8 = mode == "a8"
                pq = pq8 if a8 else pq16
                x = torch.randn(M, K, generator=g, device=dev).bfloat16()
                w_norm = nw if norm and M == 1 and bits == 4 else None
                if a8:
                    lib_err = ("int8 activations: no PyTorch call computes "
                               "group-wise weights against them")
                elif w_norm is not None:
                    lib_err = "the fused RMSNorm: no one PyTorch call"
                else:
                    lib_err = pack_err
                lib_call = (int4_library(w4, sz, x)
                            if not a8 and w_norm is None else None)
                if M == 1:
                    plain = lambda: qm.qmm_p_reference(x, pq, w_norm, EPS)
                else:
                    plain = lambda: qm.qmm_dq_reference(x, pq)
                rows.append(qmm_row(
                    "k1", x, pq, lambda: qm._k1(x, pq, w_norm, EPS), plain,
                    lib_call, lib_err, a8, shape=name, mode=mode,
                    norm=w_norm is not None, flush=flush,
                    library="torch._weight_int4pack_mm (tinygemm)"))
            del pq8, pq16, w4, sz
            torch.cuda.empty_cache()
    return rows


def check_k6(dev, flush):
    """K6 (row-major weights, the P formula row by row) at Qwen3-4B's
    shapes, M = 1, 4 and 16, in its three modes. No PyTorch call computes
    int8 activations or group-wise int8 weights: library_ms is null."""
    from ominix_mlx_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    rows = []
    for mode in ("w4a8", "w8a8", "w8a16"):
        bits, a8 = (4 if mode == "w4a8" else 8), mode.endswith("a8")
        for name, N, K, _ in K1_SHAPES:
            _, pq = random_packed(qm, g, dev, N, K, bits,
                                  8 if a8 else None)
            for M in (1, 4, 16):
                x = torch.randn(M, K, generator=g, device=dev).bfloat16()
                rows.append(qmm_row(
                    "k6", x, pq, lambda: qm._k6(x, pq),
                    lambda: qm.qmm_p_reference(x, pq), None,
                    "no PyTorch call computes " + (
                        "int8 activations against group-wise weights"
                        if a8 else "group-wise int8 weights"), a8,
                    shape=name, mode=mode, flush=flush))
            del pq
            torch.cuda.empty_cache()
    return rows


def check_k7(dev, flush):
    """K7 (exact w4a16 on the tensor cores) at Qwen3-4B's projections
    (its lm_head is padded, so the dense route takes it at 17..64 rows),
    M = 17, 40 and 64, with torch._weight_int4pack_mm (tinygemm, the same
    function) as the library call."""
    from ominix_mlx_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    rows = []
    for name, N, K, _ in K1_SHAPES[:4]:
        qt, pq = random_packed(qm, g, dev, N, K, 4, None)
        w4, sz, pack_err = int4pack(qt)
        del qt
        for M in (17, 40, 64):
            x = torch.randn(M, K, generator=g, device=dev).bfloat16()
            rows.append(qmm_row(
                "k7", x, pq, lambda: qm._k7(x, pq),
                lambda: qm.qmm_dq_reference(x, pq),
                int4_library(w4, sz, x), pack_err, False, shape=name,
                mode="w4a16", flush=flush,
                library="torch._weight_int4pack_mm (tinygemm)"))
        del pq, w4, sz
        torch.cuda.empty_cache()
    return rows


def check_k2(dev, flush, H=32, Hkv=8, D=128, Ts=K2_T, seed=SEED + 1,
             phase="k2"):
    """K2 against flash_prefill_reference at T in ``Ts`` (Qwen3-4B's 32
    query heads over 8 KV heads of 128 by default), timed beside sdpa."""
    from ominix_mlx_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    scale = D ** -0.5
    for T in Ts:
        q = torch.randn(1, H, T, D, generator=g, device=dev).bfloat16()
        k = torch.randn(1, Hkv, T, D, generator=g, device=dev).bfloat16()
        v = torch.randn(1, Hkv, T, D, generator=g, device=dev).bfloat16()
        out, lse = fa._k2(q, k, v, scale)
        want, want_lse = fa.flash_prefill_reference(q, k, v, scale)
        torch.cuda.synchronize()
        if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
            raise RuntimeError(f"K2 T={T}: non-finite")
        d = (out.float() - want.float()).abs().max().item()
        rel = d / max(want.float().abs().max().item(), 1e-12)
        dl = (lse - want_lse).abs().max().item()
        ms = time_ms(lambda: fa._k2(q, k, v, scale), 10, flush)
        plain = time_ms(lambda: fa.flash_prefill_reference(q, k, v, scale),
                        3, flush)
        lib, lib_err = time_library(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True), 10, flush)
        flop = 4 * H * D * T * (T + 1) / 2
        row = {"T": T, "H": H, "Hkv": Hkv, "D": D, "max_abs_err": d,
               "rel_err": rel, "lse_max_abs_err": dl, "ms": ms,
               "plain_ms": plain, "library_ms": lib,
               "library": "F.scaled_dot_product_attention(is_causal=True, "
                          "enable_gqa=True)", "library_error": lib_err,
               "TFLOPs": flop / ms / 1e9,
               **bound(2 * D * T * (2 * H + 2 * Hkv) + 4 * H * T, flop,
                       "bf16")}
        row.update(versus(row))
        emit({"phase": phase, **row})
        if not (rel < K2_TOL and dl < K2_LSE_TOL):
            raise RuntimeError(f"K2 T={T}: rel error {rel}, lse {dl}")
        rows.append(row)
    return rows


def check_k2c(dev, flush):
    """K2c against flash_chunk_reference: chunk queries at pos..pos+Tq-1
    over the [:pos+Tq] prefix of a capacity-sized cache, read in place."""
    from ominix_mlx_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows = []
    H, Hkv, D = 32, 8, 128
    scale = D ** -0.5
    cap = PREFILL_LEN + 64
    kc = torch.randn(1, Hkv, cap, D, generator=g, device=dev).bfloat16()
    vc = torch.randn(1, Hkv, cap, D, generator=g, device=dev).bfloat16()
    for pos, T in K2C_SHAPES:
        q = torch.randn(1, H, T, D, generator=g, device=dev).bfloat16()
        k, v = kc[:, :, :pos + T], vc[:, :, :pos + T]
        out, lse = fa._k2c(q, k, v, pos, scale)
        want, want_lse = fa.flash_chunk_reference(q, k, v, pos, scale)
        torch.cuda.synchronize()
        if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
            raise RuntimeError(f"K2c pos={pos} T={T}: non-finite")
        d = (out.float() - want.float()).abs().max().item()
        rel = d / max(want.float().abs().max().item(), 1e-12)
        dl = (lse - want_lse).abs().max().item()
        del want, want_lse
        ms = time_ms(lambda: fa._k2c(q, k, v, pos, scale), 10, flush)
        plain = time_ms(lambda: fa.flash_chunk_reference(q, k, v, pos, scale),
                        3, flush)
        # query i of the chunk sees keys 0..pos+i: the shifted causal mask
        mask = torch.ones(T, pos + T, dtype=torch.bool,
                          device=dev).tril(diagonal=pos)
        lib, lib_err = time_library(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale, enable_gqa=True), 10, flush)
        del mask
        flop = 4 * H * D * T * (pos + (T + 1) / 2)   # unmasked (q, k) pairs
        row = {"pos": pos, "T": T, "H": H, "Hkv": Hkv, "D": D,
               "max_abs_err": d, "rel_err": rel, "lse_max_abs_err": dl,
               "ms": ms, "plain_ms": plain, "us": ms * 1e3,
               "plain_us": plain * 1e3, "library_ms": lib,
               "library": "F.scaled_dot_product_attention(attn_mask="
                          "shifted causal, enable_gqa=True)",
               "library_error": lib_err, "TFLOPs": flop / ms / 1e9,
               **bound(2 * D * (2 * H * T + 2 * Hkv * (pos + T)) + 4 * H * T,
                       flop, "bf16")}
        row.update(versus(row))
        emit({"phase": "k2c", **row})
        if not (rel < K2_TOL and dl < K2_LSE_TOL):
            raise RuntimeError(f"K2c pos={pos} T={T}: rel error {rel}, "
                               f"lse {dl}")
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def parent_library(parent: str):
    """The kernel library of the checkout at ``parent``, built by its own
    ``ops/_build.py``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "parent_build",
        os.path.join(parent, "ominix_mlx_tpu_torch", "ops", "_build.py"))
    pbuild = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pbuild)
    return pbuild.library()


def in_turns(parent_call, this_call, flush) -> dict:
    """Times a parent checkout's launch and this one's in turns (parent,
    this, this, parent; 10 launches each, L2 flushed before each):
    parent_ms, ms and the speedup of the slower of this checkout's turns
    over the faster of the parent's."""
    t = [time_ms(fn, 10, flush) for fn in
         (parent_call, this_call, this_call, parent_call)]
    return {"parent_ms": [t[0], t[3]], "ms": t[1:3],
            "speedup": min(t[0], t[3]) / max(t[1:3])}


def device_events(run, complete, tries: int = 5):
    """The device kernels (start, end, name), sorted, of one
    torch.profiler window around ``run()``; the window is taken again
    while ``complete(events)`` is false (on the H100 a window now and
    then returns some or none of its device events); raises after
    ``tries`` windows that all missed some. A spin kernel opens and
    closes each window: once a process has been profiled before, a window
    can lose its first or its last device event (every window of the
    launch probe read 19 of its 20 kernels there, and with the two spins
    all 20 and one spin)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            run()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        ev = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
        if complete(ev):
            return ev
    raise RuntimeError(f"the profiler missed device kernels in each of "
                       f"{tries} windows")


def paced(call, flush, prep: str = "qmm_prep", rows: str = "qmm_p<",
          n: int = 10):
    """A prologue-and-rows kernel launch at a host-bound decode step's
    pace: ``n`` calls of ``call``, each issued to an idle card (L2 flushed,
    then a synchronize), under torch.profiler. The device kernels whose
    names hold ``prep`` are prologues, those that hold ``rows`` rows
    kernels; a call may launch several of each (a parent's gate and up:
    two pairs), taken in order. Per call, from the kernels' device start
    and end: the prologues' time (``prep_us``), the rows kernels'
    (``rows_us``), the rows kernels' time after their prologue ended
    (``rows_after_prep_us``: what is left once x's codes are ready, the
    whole of it where it starts later), the span from the first
    prologue's start to the last rows kernel's end, and how many rows
    kernels started before their prologue ended. Medians over the calls
    (the count over all)."""
    call()
    torch.cuda.synchronize()

    def run():
        for _ in range(n):
            flush()
            torch.cuda.synchronize()
            call()
            torch.cuda.synchronize()

    def split(ev):
        return ([(t0, t1) for t0, t1, name in ev if prep in name],
                [(t0, t1) for t0, t1, name in ev if rows in name])

    def complete(ev):
        preps, rowss = split(ev)
        m = len(preps) // n
        return m >= 1 and len(preps) == m * n == len(rowss)
    preps, rowss = split(device_events(run, complete))
    m = len(preps) // n
    med = statistics.median
    cs = [list(zip(preps[i * m:(i + 1) * m], rowss[i * m:(i + 1) * m]))
          for i in range(n)]
    return {
        "prep_us": med(sum(p1 - p0 for (p0, p1), _ in c) for c in cs),
        "rows_us": med(sum(r1 - r0 for _, (r0, r1) in c) for c in cs),
        "rows_after_prep_us": med(sum(r1 - max(r0, p1)
                                      for (_, p1), (r0, r1) in c)
                                  for c in cs),
        "span_us": med(c[-1][1][1] - c[0][0][0] for c in cs),
        "rows_started_before_prep_ended": sum(
            r0 < p1 for c in cs for (_, p1), (r0, _) in c)}


def k3_pools(g, dev, B, MP, quant, Hkv=8, D=128, ps=128):
    """Random pools of B * MP + 1 pages (page 0 the null page; bf16, or
    int8 codes with f32 per-token scales) and a shuffled table."""
    P = B * MP + 1
    table = (torch.randperm(P - 1, generator=g, device=dev) + 1).reshape(
        B, MP).to(torch.int32)
    if not quant:
        return (torch.randn(P, Hkv, ps, D, generator=g, device=dev).bfloat16(),
                torch.randn(P, Hkv, ps, D, generator=g, device=dev).bfloat16(),
                None, None, table)
    codes = [torch.randint(-127, 128, (P, Hkv, ps, D), generator=g,
                           device=dev, dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand(P, Hkv, ps, generator=g, device=dev) / 64 + 1e-3
              for _ in range(2)]
    return codes[0], codes[1], scales[0], scales[1], table


def k3_cases():
    """(shape, lengths, pages per row, mode, window, KV heads, query heads)
    of every K3 row: Qwen3-4B's 32 over 8 at every K3_SHAPES shape;
    GLM-4-9B's 32 over 2 (16 a KV head) and GLM-4.5-Air's 96 over 8 (12 a
    KV head: three CTAs of 4) on the ragged batch."""
    for name, lengths, MP in K3_SHAPES:
        for mode in ("bf16", "int8"):
            yield name, lengths, MP, mode, 0, 8, 32
        if name == "B8_ragged":
            yield name, lengths, MP, "bf16", 512, 8, 32
            for mode in ("bf16", "int8"):
                yield name + "_glm4", lengths, MP, mode, 0, 2, 32
            for mode in ("bf16", "int8"):
                yield name + "_glm45air", lengths, MP, mode, 0, 8, 96


def check_k3(dev, flush):
    """K3 against paged_decode_reference at Qwen3-4B's heads (H=32, Hkv=8,
    D=128, page 128), shuffled tables, at every K3_SHAPES shape: bf16 and
    int8 pages, and a 512-token window on the ragged batch; and at
    GLM-4-9B's (Hkv=2) and GLM-4.5-Air's (H=96, Hkv=8) on the ragged
    batch. Held per (row, head); the same bits on a second launch."""
    from ominix_mlx_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    D, ps = 128, 128
    rows = []
    pools = {}
    for name, lengths, MP, mode, window, Hkv, H in k3_cases():
        B = len(lengths)
        key = (name, mode)
        if key not in pools:
            pools.clear()
            torch.cuda.empty_cache()
            pools[key] = k3_pools(g, dev, B, MP, mode == "int8", Hkv)
        kp, vp, kscale, vscale, table = pools[key]
        q = torch.randn(B, H, D, generator=g, device=dev).bfloat16()
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        args = (q, kp, vp, table, lens, D ** -0.5, window, kscale, vscale)
        got = pa._k3(*args)
        again = pa._k3(*args)
        want = pa.paged_decode_reference(
            q, kp, vp, table, lens, D ** -0.5, window=window,
            k_scale=kscale, v_scale=vscale)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"K3 {name} {mode} window={window}: "
                               f"non-finite")
        d = (got.float() - want.float()).abs().max().item()
        rel = d / max(want.float().abs().max().item(), 1e-12)
        row_rel = row_rel_err(got, want)
        del want
        ms = time_ms(lambda: pa._k3(*args), 20, flush)
        plain = time_ms(lambda: pa.paged_decode_reference(
            q, kp, vp, table, lens, D ** -0.5, window=window, k_scale=kscale,
            v_scale=vscale), 5, flush)
        toks = sum(min(n, window) if window else n for n in lengths)
        per_tok = 2 * Hkv * D * kp.element_size() + (
            2 * Hkv * 4 if kscale is not None else 0)
        # a yardstick of the timer, not of K3: two PyTorch reductions that
        # read as many K and V bytes, contiguous (what a plain read of them
        # takes here, launches and a cold L2 and TLB included)
        side = toks * Hkv * D * kp.element_size() // 4
        k32, v32 = (t.view(-1).view(torch.int32)[:side] for t in (kp, vp))
        read_ms = time_ms(lambda: (k32.max(), v32.max()), 20, flush)
        row = {"shape": name, "mode": mode, "window": window, "B": B,
               "tokens": toks, "H": H, "Hkv": Hkv, "D": D, "page": ps,
               "splits": pa.k3_plan(
                   B, Hkv, H // Hkv // pa._rows_per_cta(H // Hkv), MP,
                   ps).splits,
               "max_abs_err": d, "rel_err": rel, "row_rel_err": row_rel,
               "bitwise_repeatable": bool(torch.equal(got, again)),
               "ms": ms, "plain_ms": plain, "us": ms * 1e3,
               "plain_us": plain * 1e3,
               "library_ms": None,    # no one PyTorch call reads the pages
               "kv_GBps": toks * per_tok / ms / 1e6,
               "read_same_kv_bytes_ms": read_ms,
               **bound(toks * per_tok + 4 * B * H * D + 4 * B * (MP + 1),
                       4 * H * D * toks, "bf16")}
        emit({"phase": "k3", **row})
        if not (row_rel < K3_TOL and row["bitwise_repeatable"]):
            raise RuntimeError(f"K3 {name} {mode} window={window}: error "
                               f"{row_rel} of a (row, head)'s max |plain|, "
                               f"repeatable {row['bitwise_repeatable']}")
        rows.append(row)
    return rows


def compare_k3(plib, dev, flush):
    """The parent's K3 (``plib``: its kernel library, the split-KV entry
    ``ominix_paged_decode(q, kp, vp, ks, vs, table, lengths, out,
    part_acc, part_ml, B, H, Hkv, D, ps, MP, window, rows_per_cta, quant,
    scale, pages_per_split, splits, stream)``, given this checkout's
    ``k3_plan``) against this checkout's on the same inputs at every K3
    row, timed in turns (parent, this, this, parent). One
    ``k3_vs_parent`` line per row."""
    from ominix_mlx_tpu_torch.ops import paged_attention as pa

    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    D, ps = 128, 128
    pools = {}
    for name, lengths, MP, mode, window, Hkv, H in k3_cases():
        B = len(lengths)
        if (name, mode) not in pools:
            pools.clear()
            torch.cuda.empty_cache()
            pools[(name, mode)] = k3_pools(g, dev, B, MP, mode == "int8",
                                           Hkv)
        kp, vp, kscale, vscale, table = pools[(name, mode)]
        q = torch.randn(B, H, D, generator=g, device=dev).bfloat16()
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        out = torch.empty_like(q)
        R = pa._rows_per_cta(H // Hkv)
        plan = pa.k3_plan(B, Hkv, (H // Hkv) // R, MP, ps)
        part = [torch.empty(B, H, plan.splits, n, dtype=torch.float32,
                            device=dev) if plan.splits > 1 else None
                for n in (D, 2)]

        def parent_call():
            rc = plib.ominix_paged_decode(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                None if kscale is None else kscale.data_ptr(),
                None if vscale is None else vscale.data_ptr(),
                table.data_ptr(), lens.data_ptr(), out.data_ptr(),
                *(None if t is None else t.data_ptr() for t in part), B,
                H, Hkv, D, ps, MP, window, R, int(kscale is not None),
                D ** -0.5, plan.pages_per_split, plan.splits, stream)
            if rc != 0:
                raise RuntimeError(f"parent K3: CUDA error {rc}")

        def this_call():
            pa._k3(q, kp, vp, table, lens, D ** -0.5, window, kscale, vscale)

        parent_call()
        rel = row_rel_err(out, pa._k3(q, kp, vp, table, lens, D ** -0.5,
                                      window, kscale, vscale))
        emit({"phase": "k3_vs_parent", "shape": name, "mode": mode,
              "window": window, "parent_vs_this_row_rel": rel,
              **in_turns(parent_call, this_call, flush)})
    pools.clear()
    torch.cuda.empty_cache()


def qmm_p_cases():
    """(kernel, shape, N, K, mode, M, fused norm) of every timed P-formula
    row: K1 at one row (w4a8, w4a16 with the norm where the model fuses
    it, w8a8) and K6 at 1, 4 and 16 rows (w4a8, w8a8, w8a16), at every
    K1_SHAPES shape."""
    for name, N, K, norm in K1_SHAPES:
        for mode in ("w4a8", "w4a16", "w8a8"):
            yield "k1", name, N, K, mode, 1, norm and mode == "w4a16"
        for mode in ("w4a8", "w8a8", "w8a16"):
            for M in (1, 4, 16):
                yield "k6", name, N, K, mode, M, False


def compare_qmm_p(plib, dev, flush):
    """The parent's P-formula kernel (``plib``'s ``ominix_qmm_p(x, norm_w,
    eps, data, scales, biases, y, xq, xg, sx, xn, M, N, K, gs, bits, a8,
    rows_per_warp, stream)``, given this checkout's
    ``qmm_p_rows_per_warp``) against this checkout's on the same inputs at
    every ``qmm_p_cases`` row, in turns (parent, this, this, parent). One
    ``qmm_p_vs_parent`` line per row; K1's one-row rows, the decode
    step's, also carry ``paced``: ``paced`` of the parent's
    launch and this one's (in that order), where the in-turns timer's
    back-to-back launches let the rows kernel overlap its prologue and a
    host-bound step may not."""
    from ominix_mlx_tpu_torch.ops import quant_matmul as qm

    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    weights = {}
    for kernel, name, N, K, mode, M, norm in qmm_p_cases():
        bits, a8 = (4 if mode.startswith("w4") else 8), mode.endswith("a8")
        if (name, bits, a8) not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            weights[(name, bits, a8)] = random_packed(
                qm, g, dev, N, K, bits, 8 if a8 else None)[1]
        pq = weights[(name, bits, a8)]
        G = K // GS
        x = torch.randn(M, K, generator=g, device=dev).bfloat16()
        nw = ((1 + 0.1 * torch.randn(K, generator=g, device=dev)).bfloat16()
              if norm else None)
        y = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
        xq = torch.empty(M, K, dtype=torch.int8, device=dev)
        xg = torch.empty(M, G, dtype=torch.float32, device=dev)
        sx = torch.empty(M, dtype=torch.float32, device=dev)
        xn = torch.empty(M, K, dtype=torch.bfloat16, device=dev)

        def parent_call():
            rc = plib.ominix_qmm_p(
                x.data_ptr(), None if nw is None else nw.data_ptr(), EPS,
                pq.data.data_ptr(), pq.scales.data_ptr(),
                pq.biases.data_ptr(), y.data_ptr(), xq.data_ptr(),
                xg.data_ptr(), sx.data_ptr(), xn.data_ptr(), M, N, K, GS,
                bits, int(a8), qm.qmm_p_rows_per_warp(M, N, a8), stream)
            if rc != 0:
                raise RuntimeError(f"parent qmm_p: CUDA error {rc}")

        def this_call():
            return qm._k1(x, pq, nw, EPS) if kernel == "k1" else qm._k6(x, pq)

        parent_call()
        mine = this_call()
        rel = row_rel_err(y, mine)
        paced_rows = ({"paced": {"parent": paced(parent_call, flush),
                                 "this": paced(this_call, flush)}}
                 if kernel == "k1" else {})
        emit({"phase": "qmm_p_vs_parent", "kernel": kernel, "shape": name,
              "mode": mode, "M": M, "N": N, "K": K, "norm": norm,
              "parent_vs_this_rel": rel,
              "bitwise_equal": bool(torch.equal(y, mine)),
              **in_turns(parent_call, this_call, flush), **paced_rows})
    weights.clear()
    torch.cuda.empty_cache()


def random_experts(qm, g, dev, N, K, bits, E=MOE_E):
    """Random packed experts [E, N, K] at 4 or 8 bits, act_bits=8."""
    G, lim = K // GS, 1 << (bits - 1)
    if bits == 4:
        data = torch.randint(0, 256, (E, N, K // 2), generator=g,
                             device=dev, dtype=torch.uint8)
    else:
        data = torch.randint(-lim, lim, (E, N, K), generator=g,
                             device=dev, dtype=torch.int8)
    return qm.PackedQuantizedExperts(
        data=data,
        scales=((torch.rand(E, N, G, generator=g, device=dev) + 0.5)
                * (K ** -0.5 / lim)).bfloat16(),
        biases=(torch.randn(E, N, G, generator=g, device=dev)
                * (K ** -0.5 / 4)).bfloat16(),
        group_size=GS, bits=bits, in_features=K, act_bits=8)


def gather_ids(g, dev, T, k, E=MOE_E):
    """Expert ids [T, k] out of order, with a repeat and the last expert."""
    ids = torch.randint(0, E, (T, k), generator=g, device=dev,
                        dtype=torch.int32)
    ids[0, -1] = E - 1
    ids[-1, 0] = ids[0, 0]
    return ids


def check_k4(dev, flush):
    """K4 against gather_qmm_reference(act_bits=8) at Qwen3-30B-A3B's
    shapes over 128 random experts, 4- and 8-bit, ids out of order with
    repeats and the last expert; the error is held per (row, slot). At
    the gate_up shapes one launch against two stacks (gate and up) is held
    bit for bit to a single launch on each."""
    from ominix_mlx_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    rows = []
    for bits in (4, 8):
        for name, T, k, N, K in K4_SHAPES:
            rows.append(k4_row(qm, g, dev, flush, name, T, k, N, K, bits))
            torch.cuda.empty_cache()
    return rows


def k4_row(qm, g, dev, flush, name, T, k, N, K, bits, E=MOE_E,
           phase="k4"):
    """One K4 line: random experts [E, N, K], x [T, K] and ids [T, k] (out
    of order, a repeat, the last expert) from ``g``; the error held per
    (row, slot); at a gate_up shape, one launch against two stacks held
    bit for bit to a single launch on each."""
    G = K // GS
    w = random_experts(qm, g, dev, N, K, bits, E)
    x = torch.randn(T, K, generator=g, device=dev).bfloat16()
    ids = gather_ids(g, dev, T, k, E)
    got = qm._k4(x, w, ids)
    pair_equal = None
    if name == "gate_up":
        w_up = random_experts(qm, g, dev, N, K, bits, E)
        pg, pu = qm._k4(x, w, ids, w_up)
        pair_equal = bool(torch.equal(pg, got) and torch.equal(
            pu, qm._k4(x, w_up, ids)))
        del w_up, pg, pu
    want = qm.gather_qmm_reference(x, w, ids, act_bits=8)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise RuntimeError(f"K4 {bits}-bit {name} T={T}: non-finite")
    d = (got.float() - want.float()).abs().max().item()
    row_rel = row_rel_err(got, want)
    del want
    ms = time_ms(lambda: qm._k4(x, w, ids), 20, flush)
    plain = time_ms(lambda: qm.gather_qmm_reference(x, w, ids, 8), 3, flush)
    # K4 streams one expert row per (row, slot), so the slabs it reads
    # count a repeated id again; the bound reads each expert once
    row_bytes = N * (K * bits // 8 + 4 * G)
    slab = T * k * row_bytes
    used = int(torch.unique(ids).numel())
    row = {"shape": name, "bits": bits, "T": T, "k": k, "N": N, "K": K,
           "E": E, "experts_used": used,
           "plan": list(qm.gather_plan(K, bits)),
           "max_abs_err": d, "row_rel_err": row_rel,
           "gate_up_equal_to_single": pair_equal, "ms": ms,
           "plain_ms": plain, "us": ms * 1e3, "plain_us": plain * 1e3,
           "library_ms": None,
           "library_error": "no PyTorch call gathers group-wise "
                            "quantized experts",
           "slab_GBps": slab / ms / 1e6,
           **bound(used * row_bytes + 2 * T * K + 4 * T * k
                   + 2 * T * k * N, 2 * T * k * N * K, "int8")}
    emit({"phase": phase, **row})
    if not row_rel < K4_TOL or pair_equal is False:
        raise RuntimeError(f"K4 {bits}-bit {name} T={T} k={k}: error "
                           f"{row_rel} of a (row, slot)'s max |plain|, gate "
                           f"and up in one launch equal to single launches: "
                           f"{pair_equal}")
    return row


def random_channel_experts(qm, g, dev, N, K):
    """Random channel-int8 experts [MOE_E, N, K]."""
    return qm.ChannelQuantizedExperts(
        data=torch.randint(-127, 128, (MOE_E, N, K), generator=g,
                           device=dev, dtype=torch.int8),
        scale=(torch.rand(MOE_E, N, generator=g, device=dev) + 0.5)
        * (K ** -0.5 / 127))


def check_k8(dev, flush):
    """K8 against channel_gather_qmm_reference at K4's shapes over 128
    random channel-int8 experts, ids out of order with repeats and the
    last expert: held exactly (the same int8 codes, exact int32 sums, the
    same float32 rescale order), on x in the float32 the down projection
    takes and in the bf16 the gate and up projections take (the prologue
    widens it); at the gate_up shapes one launch against two stacks is
    held bit for bit to a single launch on each."""
    from ominix_mlx_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    rows = []
    for name, T, k, N, K in K4_SHAPES:
        w = random_channel_experts(qm, g, dev, N, K)
        x = torch.randn(T, K, generator=g, device=dev)
        if name == "gate_up":
            x = x.bfloat16()
        ids = gather_ids(g, dev, T, k)
        got = qm._k8(x, w, ids)
        pair_equal = None
        if name == "gate_up":
            w_up = random_channel_experts(qm, g, dev, N, K)
            pg, pu = qm._k8(x, w, ids, w_up)
            pair_equal = bool(torch.equal(pg, got) and torch.equal(
                pu, qm._k8(x, w_up, ids)))
            del w_up, pg, pu
        want = qm.channel_gather_qmm_reference(x, w, ids)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"K8 {name} T={T}: non-finite")
        d = (got - want).abs().max().item()
        differ = int((got != want).sum())
        ms = time_ms(lambda: qm._k8(x, w, ids), 20, flush)
        plain = time_ms(lambda: qm.channel_gather_qmm_reference(x, w, ids),
                        3, flush)
        row_bytes = N * (K + 4)
        used = int(torch.unique(ids).numel())
        row = {"shape": name, "T": T, "k": k, "N": N, "K": K, "E": MOE_E,
               "x": str(x.dtype).replace("torch.", ""),
               "experts_used": used,
               "plan": list(qm.gather_plan(K, 8)),
               "max_abs_err": d, "outputs_differ": differ,
               "gate_up_equal_to_single": pair_equal, "ms": ms,
               "plain_ms": plain, "us": ms * 1e3, "plain_us": plain * 1e3,
               "library_ms": None,
               "library_error": "no PyTorch call gathers int8 experts "
                                "against int8 activations",
               "slab_GBps": T * k * row_bytes / ms / 1e6,
               **bound(used * row_bytes + x.element_size() * T * K
                       + 4 * T * k + 4 * T * k * N, 2 * T * k * N * K,
                       "int8")}
        emit({"phase": "k8", **row})
        if differ or pair_equal is False:
            raise RuntimeError(f"K8 {name} T={T} k={k}: {differ} outputs "
                               f"differ from the plain version (max {d}), "
                               f"gate and up in one launch equal to single "
                               f"launches: {pair_equal}")
        rows.append(row)
        del w
        torch.cuda.empty_cache()
    return rows


def launch_floor(dev, n: int = 20) -> dict:
    """What a launch costs on an idle card (``ominix_launch_probe``,
    csrc/launch_probe.cu): an empty kernel alone, and behind a one-CTA
    kernel that lets its dependents start at once, launched after it by
    programmatic dependent launch or plainly; over 1 CTA and over 768
    (K4's gate-and-up grid at one row). Each call issued to an idle card
    under torch.profiler; medians over ``n`` calls of the kernels' device
    times: ``empty_us``, ``first_us`` (the one-CTA kernel), ``gap_us``
    (the empty kernel's start less the first kernel's end: negative where
    it started before that one ended) and ``span_us`` (first start to
    last end)."""
    from ominix_mlx_tpu_torch.ops import _build

    lib = _build.library()
    med = statistics.median
    out = {"phase": "launch_floor", "calls": n}
    for ctas in (1, 768):
        for mode, label in ((0, "alone"), (1, "pdl"), (2, "plain")):
            def call():
                _build.check(lib.ominix_launch_probe(
                    mode, ctas, torch.cuda.current_stream().cuda_stream),
                    "launch probe")
            call()
            torch.cuda.synchronize()

            def run():
                for _ in range(n):
                    torch.cuda.synchronize()
                    call()
                    torch.cuda.synchronize()

            def split(ev):
                return tuple([(t0, t1) for t0, t1, nm in ev if piece in nm]
                             for piece in ("probe_empty", "probe_one"))

            empty, first = split(device_events(run, lambda ev: tuple(
                map(len, split(ev))) == (n, n if mode else 0)))
            r = {"empty_us": med(t1 - t0 for t0, t1 in empty)}
            if mode:
                r.update(first_us=med(f1 - f0 for f0, f1 in first),
                         gap_us=med(e0 - f1 for (_, f1), (e0, _)
                                    in zip(first, empty)),
                         span_us=med(e1 - f0 for (f0, _), (_, e1)
                                     in zip(first, empty)))
            out[f"{label}_ctas{ctas}"] = r
    return out


def skewed_groups(S: int, g, E: int = MOE_E) -> torch.Tensor:
    """Group sizes over E experts summing to S: a quarter of the experts
    empty, expert 1 one row, expert E // 3 (42 of 128) S/2 rows, the rest
    spread at random."""
    big = E // 3
    gs = torch.zeros(E, dtype=torch.int64)
    gs[big] = S // 2
    gs[1] = 1
    free = torch.tensor([e for e in range(E)
                         if e not in (1, big) and e % 4])
    picks = free[torch.randint(0, len(free), (S - S // 2 - 1,),
                               generator=g)]
    return gs + torch.bincount(picks, minlength=E)


def k5_row(name, S, N, K, gs, xs, w, launch, plain, lib_call, lib_label,
           flush, bits=16, E=MOE_E):
    """One K5 line: the kernel twice (bitwise repeatable) against its plain
    version, timed with L2 flushed beside its bound and ``lib_call``
    (the nearest PyTorch composition, ``lib_label``)."""
    got = launch()
    again = launch()
    want = plain()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise RuntimeError(f"K5 {bits}-bit {name} S={S}: non-finite")
    d = (got - want).abs().max().item()
    rel = d / max(want.abs().max().item(), 1e-12)
    ms = time_ms(launch, 10, flush)
    plain_ms = time_ms(plain, 3, flush)
    lib, lib_err = None, "torch._grouped_mm is not in this PyTorch"
    if hasattr(torch, "_grouped_mm"):
        lib, lib_err = time_library(lib_call, 10, flush)
    used = int((gs > 0).sum())            # experts whose slab is read
    G = K // GS
    wbytes = (2 * used * N * K if bits == 16 else
              used * N * K * bits // 8 + used * N * G * 4)
    row = {"shape": name, "S": S, "N": N, "K": K, "E": E, "bits": bits,
           "experts_used": used, "max_abs_err": d, "rel_err": rel,
           "bitwise_repeatable": bool(torch.equal(got, again)),
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib,
           "library": lib_label, "library_error": lib_err,
           "TFLOPs": 2 * S * N * K / ms / 1e9,
           **bound(2 * S * K + wbytes + 4 * S * N + 4 * E,
                   2 * S * N * K, "bf16")}
    if bits != 16:
        from ominix_mlx_tpu_torch.ops import grouped_matmul as gmm
        row["scales_streamed"] = gmm.k5_plan(K, bits, GS).stream
    row.update(versus(row))
    emit({"phase": "k5", **row})
    if not (rel < K5_TOL and row["bitwise_repeatable"]):
        raise RuntimeError(f"K5 {bits}-bit {name} S={S}: rel error {rel}, "
                           f"repeatable {row['bitwise_repeatable']}")
    return row


def check_k5(dev, flush):
    """K5 against grouped_matmul_reference over Qwen3-30B-A3B's 128
    experts on skewed groups (empty ones, a one-row group, one of S/2),
    and the same bits on a second launch: bf16 experts at K5_SHAPES
    (torch._grouped_mm, where the installed PyTorch has it, timed as the
    library yardstick, bf16 out); 4- and 8-bit experts read packed at
    K5_PACKED_S rows, gate and down, with dequantize_experts +
    torch._grouped_mm as the nearest PyTorch composition (no single call
    computes it). The port never calls either."""
    from ominix_mlx_tpu_torch.ops import grouped_matmul as gmm
    from ominix_mlx_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    cpu_g = torch.Generator().manual_seed(SEED + 9)
    rows = []
    for name, S, N, K in K5_SHAPES:
        xs = torch.randn(S, K, generator=g, device=dev).bfloat16()
        w = (torch.randn(MOE_E, N, K, generator=g, device=dev)
             * K ** -0.5).bfloat16()
        gs = skewed_groups(S, cpu_g).to(dev)
        gi = gs.int()
        offs = torch.cumsum(gs, 0).to(torch.int32)
        rows.append(k5_row(
            name, S, N, K, gs, xs, w, lambda: gmm._k5(xs, w, gi),
            lambda: gmm.grouped_matmul_reference(xs, w, gs),
            lambda: torch._grouped_mm(xs, w.transpose(1, 2), offs=offs),
            "torch._grouped_mm (bf16 out)", flush))
        del xs, w
        torch.cuda.empty_cache()
    for bits in (4, 8):
        for name, N, K in K5_PACKED_SHAPES:
            w = random_experts(qm, g, dev, N, K, bits)
            for S in K5_PACKED_S:
                xs = torch.randn(S, K, generator=g, device=dev).bfloat16()
                gs = skewed_groups(S, cpu_g).to(dev)
                gi = gs.int()
                offs = torch.cumsum(gs, 0).to(torch.int32)
                rows.append(k5_row(
                    name, S, N, K, gs, xs, w,
                    lambda: gmm._k5(xs, w, gi),
                    lambda: gmm.grouped_matmul_reference(xs, w, gs),
                    lambda: torch._grouped_mm(
                        xs, qm.dequantize_experts(w).transpose(1, 2),
                        offs=offs),
                    "dequantize_experts + torch._grouped_mm (bf16 out)",
                    flush, bits))
                del xs
            del w
            torch.cuda.empty_cache()
        name, E, N, K = K5_MIXTRAL_DOWN
        w = random_experts(qm, g, dev, N, K, bits, E)
        for S in K5_MIXTRAL_S:
            xs = torch.randn(S, K, generator=g, device=dev).bfloat16()
            gs = skewed_groups(S, cpu_g, E).to(dev)
            gi = gs.int()
            offs = torch.cumsum(gs, 0).to(torch.int32)
            rows.append(k5_row(
                name, S, N, K, gs, xs, w, lambda: gmm._k5(xs, w, gi),
                lambda: gmm.grouped_matmul_reference(xs, w, gs),
                lambda: torch._grouped_mm(
                    xs, qm.dequantize_experts(w).transpose(1, 2),
                    offs=offs),
                "dequantize_experts + torch._grouped_mm (bf16 out)",
                flush, bits, E))
            del xs
        del w
        torch.cuda.empty_cache()
    return rows


def k9_inputs(g, dev, B, T, Hk=16, Hv=32, dk=128, dv=128):
    """A DeltaNet layer's recurrence inputs: l2-normed q (scaled by
    dk^-0.5) and k, v, g < 0, beta in (0, 1), a carried state."""
    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    return (F.normalize(randn(B, T, Hk, dk), dim=-1) * dk ** -0.5,
            F.normalize(randn(B, T, Hk, dk), dim=-1), randn(B, T, Hv, dv),
            -torch.rand(B, T, Hv, generator=g, device=dev) * 1.5,
            torch.rand(B, T, Hv, generator=g, device=dev),
            randn(B, Hv, dk, dv) * 0.1)


def k9_bound(B, T, Hk, Hv, dk, dv) -> dict:
    """K9's bound, whatever the form: the larger of the bytes any form
    must move (q, k, v, g, beta and o once, the state read and written
    once) over the memory rate, and the chunked form's products over the
    TF32 peak: n^2 (3 dk + 2 dv) + 3 n dk dv multiply-adds a chunk of n
    tokens and value head. Beside it, named as such, the recurrent form's
    own bound (``recurrent_fp32_bound_ms``): 7 dk dv float32 operations a
    token and value head off the tensor cores, or the same bytes."""
    nbytes = 4 * (2 * B * T * Hk * dk + 2 * B * T * Hv * dv
                  + 2 * B * T * Hv + 2 * B * Hv * dk * dv)
    full, last = divmod(T, 64)
    macs = sum(n * n * (3 * dk + 2 * dv) + 3 * n * dk * dv
               for n in [64] * full + ([last] if last else []))
    old = bound(nbytes, 7 * B * T * Hv * dk * dv, "fp32")
    return {**bound(nbytes, 2 * B * Hv * macs, "tf32"),
            "recurrent_fp32_bound_ms": old["bound_ms"],
            "recurrent_fp32_bound_by": old["bound_by"]}


def rel_to(got, want) -> float:
    """max |got - want| over max |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def phase_us(call, names, n: int = 5) -> dict:
    """Median device time (µs) of each kernel a call launches, over ``n``
    calls of ``call`` each waited for, by torch.profiler: {name: µs} for
    each of ``names`` (a piece of the kernel's name ending in "<"; a name
    that another contains goes after it): K9's chunked form's
    ("gated_delta_chunk_scan<", "gated_delta_chunk<"), K10's
    ("lightning_chunk_bf16(",)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for _ in range(n):
            call()
            torch.cuda.synchronize()
    times: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for name in names:
            if name in e.name:
                times.setdefault(name[:-1], []).append(
                    e.time_range.end - e.time_range.start)
                break
    return {k: statistics.median(v) for k, v in times.items()}


def check_k9(dev, flush):
    """K9 in the form k9_plan picks (the recurrent form at decode, the
    chunked one for prompts) against gated_delta_rule_reference at
    Qwen3-Next's widths and K9_SHAPES: outputs and final state (written in
    place) within K9_TOL of max |plain|, the same bits on a second launch;
    timed beside k9_bound, the chunked form's two phases also each by
    torch.profiler (``phase_us``). At K9_TURNS the two forms in turns (recurrent,
    chunked, chunked, recurrent: ``k9_vs_recurrent``), each held against
    the plain version; at K9_CROSSOVER_T the same turns
    (``k9_crossover``) beside the form the plan picks. No PyTorch call
    computes the rule."""
    from ominix_mlx_tpu_torch.ops import gated_delta as gd

    g = torch.Generator(device=dev).manual_seed(SEED + 36)
    rows = []
    for B, T in K9_SHAPES:
        q, k, v, gg, beta, state = k9_inputs(g, dev, B, T)
        Hk, dk = q.shape[2], q.shape[3]
        Hv, dv = v.shape[2], v.shape[3]
        form = gd.k9_plan(B, T, Hv, dk, dv)
        s1, s2, s3 = state.clone(), state.clone(), state.clone()
        got = gd._k9_rule(q, k, v, gg, beta, s1)
        again = gd._k9_rule(q, k, v, gg, beta, s3)
        want = gd.gated_delta_rule_reference(q, k, v, gg, beta, s2)
        torch.cuda.synchronize()
        if not (torch.isfinite(got).all() and torch.isfinite(s1).all()):
            raise RuntimeError(f"K9 B={B} T={T}: non-finite")
        d = (got - want).abs().max().item()
        rel = d / max(want.abs().max().item(), 1e-12)
        rel_state = ((s1 - s2).abs().max() / s2.abs().max()).item()
        repeatable = bool(torch.equal(got, again) and torch.equal(s1, s3))
        want_state = s2.clone()
        ms = time_ms(lambda: gd._k9_rule(q, k, v, gg, beta, s1), 10, flush)
        plain_ms = time_ms(lambda: gd.gated_delta_rule_reference(
            q, k, v, gg, beta, s2), 3 if T <= 2048 else 1, flush)
        row = {"B": B, "T": T, "Hk": Hk, "Hv": Hv, "dk": dk, "dv": dv,
               "form": form, "launches": gd.k9_launches(B, T, Hv, dk, dv),
               "max_abs_err": d, "rel_err": rel, "state_rel_err": rel_state,
               "bitwise_repeatable": repeatable,
               "ms": ms, "plain_ms": plain_ms, "library_ms": None,
               "library_error": "no PyTorch call computes the gated delta "
                                "rule",
               "us_per_token": ms * 1e3 / T, **k9_bound(B, T, Hk, Hv, dk, dv)}
        if form == "chunked":
            row["phase_us"] = phase_us(
                lambda: gd._k9_rule(q, k, v, gg, beta, s1),
                ("gated_delta_chunk_scan<", "gated_delta_chunk<"))
        row.update(versus(row))
        emit({"phase": "k9", **row})
        if not (rel < K9_TOL and rel_state < K9_TOL
                and row["bitwise_repeatable"]):
            raise RuntimeError(f"K9 B={B} T={T}: rel error {rel}, state "
                               f"{rel_state}, repeatable "
                               f"{row['bitwise_repeatable']}")
        rows.append(row)
        if B == 1 and T in K9_TURNS:
            s4, s5 = state.clone(), state.clone()
            rec = gd._k9(q, k, v, gg, beta, s4)
            chk = gd._k9_chunked(q, k, v, gg, beta, s5)
            torch.cuda.synchronize()
            errs = {f: (rel_to(o, want), rel_to(s, want_state))
                    for f, o, s in (("recurrent", rec, s4),
                                    ("chunked", chk, s5))}
            turns = in_turns(lambda: gd._k9(q, k, v, gg, beta, s4),
                             lambda: gd._k9_chunked(q, k, v, gg, beta, s5),
                             flush)
            emit({"phase": "k9_vs_recurrent", "B": B, "T": T,
                  "recurrent_ms": turns["parent_ms"],
                  "chunked_ms": turns["ms"], "speedup": turns["speedup"],
                  "rel_err": {f: e[0] for f, e in errs.items()},
                  "state_rel_err": {f: e[1] for f, e in errs.items()},
                  "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                  "recurrent_fp32_bound_ms": row["recurrent_fp32_bound_ms"]})
            if not all(e[0] < K9_TOL and e[1] < K9_TOL
                       for e in errs.values()):
                raise RuntimeError(f"K9 forms at T={T}: {errs}")
        del q, k, v, state, s1, s2, s3
    for T in K9_CROSSOVER_T:
        q, k, v, gg, beta, state = k9_inputs(g, dev, 1, T)
        turns = in_turns(lambda: gd._k9(q, k, v, gg, beta, state),
                         lambda: gd._k9_chunked(q, k, v, gg, beta, state),
                         flush)
        emit({"phase": "k9_crossover", "B": 1, "T": T,
              "recurrent_ms": turns["parent_ms"], "chunked_ms": turns["ms"],
              "chunked_speedup": turns["speedup"],
              "planned": gd.k9_plan(1, T, v.shape[2], q.shape[3],
                                    v.shape[3])})
    return rows


def prep_inputs(g, dev, B, T, Hk=16, Hv=32, d=128):
    """A Qwen3-Next DeltaNet layer's prologue inputs: qkvz and ba as its
    bf16 projections write them, a carried conv window, the taps, A_log
    and dt_bias as init_layer_params makes them."""
    C = 2 * Hk * d + Hv * d

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    return (randn(B, T, Hk * (2 * d + 2 * (Hv // Hk) * d)).bfloat16(),
            (2 * randn(B, T, 2 * Hv)).bfloat16(),
            randn(B, 3, C).bfloat16(), (randn(C, 4) * 0.5).bfloat16(),
            (1 + 15 * torch.rand(Hv, generator=g, device=dev)).log(),
            randn(Hv) - 4, (Hk, Hv, d, d))


def device_ops(fn) -> int:
    """How many device operations (kernels, copies, fills) one call of
    ``fn`` runs, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


def check_k9_prep(dev, flush):
    """k9_prep against deltanet_prep_reference at Qwen3-Next's heads and
    K9_PREP_SHAPES (bf16, the main path's type): q, k, v, g, beta within
    K9_PREP_TOL of max |plain| each, the window it writes in place equal
    to the plain version's bit for bit, the same bits on a second launch;
    timed beside its bound (bytes: qkvz's q|k|v channels, ba and the taps
    read once, the window read and written, the float32 outputs written)
    and the plain version's time and device operations (the launches it
    replaces). No PyTorch call computes it."""
    from ominix_mlx_tpu_torch.ops import gated_delta as gd

    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    rows = []
    for B, T in K9_PREP_SHAPES:
        qkvz, ba, win, conv_w, a_log, dt_bias, heads = prep_inputs(
            g, dev, B, T)
        Hk, Hv, dk, dv = heads
        rest = (conv_w, a_log, dt_bias, heads)
        w1, w2, w3 = win.clone(), win.clone(), win.clone()
        got = gd._k9_prep(qkvz, ba, w1, *rest)
        again = gd._k9_prep(qkvz, ba, w3, *rest)
        want = gd.deltanet_prep_reference(qkvz, ba, w2, *rest)
        torch.cuda.synchronize()
        names = ("q", "k", "v", "g", "beta")
        rel = {n: row_rel_err(x, y) for n, x, y in zip(names, got, want)}
        exact = {n: bool(torch.equal(x, y))
                 for n, x, y in zip(names, got, want)}
        window_equal = bool(torch.equal(w1, w2))
        repeatable = all(torch.equal(x, y) for x, y in zip(got, again)) \
            and bool(torch.equal(w1, w3))
        ms = time_ms(lambda: gd._k9_prep(qkvz, ba, w1, *rest), 20, flush)
        plain_ms = time_ms(lambda: gd.deltanet_prep_reference(
            qkvz, ba, w2, *rest), 20, flush)
        C = 2 * Hk * dk + Hv * dv
        nbytes = 2 * (B * T * C + B * T * 2 * Hv + 2 * B * 3 * C + 4 * C) \
            + 8 * Hv + 4 * B * T * (2 * Hk * dk + Hv * dv + 2 * Hv)
        row = {"B": B, "T": T, "Hk": Hk, "Hv": Hv, "d": dk,
               "max_abs_err": max((x - y).abs().max().item()
                                  for x, y in zip(got, want)),
               "rel_err": rel, "exact": exact, "window_equal": window_equal,
               "bitwise_repeatable": repeatable, "ms": ms,
               "plain_ms": plain_ms,
               "plain_device_ops": device_ops(
                   lambda: gd.deltanet_prep_reference(qkvz, ba, w2, *rest)),
               "device_ops": device_ops(
                   lambda: gd._k9_prep(qkvz, ba, w1, *rest)),
               "library_ms": None,
               "library_error": "no PyTorch call computes the prologue",
               **bound(nbytes, 8 * B * T * C, "fp32")}
        row.update(versus(row))
        emit({"phase": "k9_prep", **row})
        if not (max(rel.values()) < K9_PREP_TOL and window_equal
                and repeatable):
            raise RuntimeError(f"k9_prep B={B} T={T}: {rel}, window equal "
                               f"{window_equal}, repeatable {repeatable}")
        rows.append(row)
    return rows


def k9_decode_inputs(g, dev, B):
    """A Qwen3-Next DeltaNet layer's decode-step inputs for k9_decode, in
    its argument order: prep_inputs' qkvz, ba, window, taps and gates at
    T = 1, a carried state, a norm weight near one, eps and the heads."""
    qkvz, ba, win, conv_w, a_log, dt_bias, heads = prep_inputs(g, dev, B, 1)
    Hv, d = heads[1], heads[2]
    state = torch.randn(B, Hv, d, d, generator=g, device=dev) * 0.1
    norm_w = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).bfloat16()
    return [qkvz, ba, win, conv_w, a_log, dt_bias, state, norm_w, EPS, heads]


def unfused_deltanet_decode(prep, k9):
    """The decode mixer as the parent composes it: ``prep`` (k9_prep) and
    ``k9`` (K9's recurrent form), this checkout's or the parent's, then
    the cast, rms_norm and * silu(z)."""
    from ominix_mlx_tpu_torch.ops import gated_delta as gd
    from ominix_mlx_tpu_torch.ops.quant_matmul import rms_norm

    def call(qkvz, ba, window, conv_w, A_log, dt_bias, state, norm_w, eps,
             heads):
        q, k, v, g, beta = prep(qkvz, ba, window, conv_w, A_log, dt_bias,
                                heads)
        z = gd.split_qkvz_ba(qkvz, ba, heads)[3]
        out = k9(q, k, v, g, beta, state)
        out = rms_norm(norm_w, out.to(qkvz.dtype), eps) * F.silu(z)
        return out.reshape(qkvz.shape[0], 1, -1)
    return call


def k9_decode_on(a, window, state):
    """k9_decode_inputs' arguments ``a`` with another window and state."""
    return a[:2] + [window] + a[3:6] + [state] + a[7:]


def head_ulps(got, want, dv=128) -> float:
    """row_ulps over value heads: [B, 1, Hv dv] as [B, Hv, dv] rows."""
    B = got.shape[0]
    return row_ulps(got.reshape(B, -1, dv), want.reshape(B, -1, dv))


def k9_decode_bound(B, Hk, Hv, d) -> dict:
    """k9_decode's bound: the state read and written once in float32; qkvz
    and ba read, the window read and written, the output written, in
    bf16; the taps, the norm weight and the gates' vectors once; K9's 7
    float32 operations a state element (the recurrent form's count)."""
    C = 2 * Hk * d + Hv * d
    W = 2 * Hk * d + 2 * Hv * d
    nbytes = 8 * B * Hv * d * d + 2 * (B * W + 2 * B * Hv + 6 * B * C
                                       + 4 * C + d + B * Hv * d) + 8 * Hv
    return bound(nbytes, 7 * B * Hv * d * d, "fp32")


def check_k9_decode(dev, flush):
    """k9_decode against deltanet_decode_reference at Qwen3-Next's heads
    (16 key heads, 32 value heads of 128) and K9_DECODE_B: the output
    within K9_DECODE_ULPS (head_ulps) of the plain version and of the
    parent's sequence (k9_prep, K9's recurrent form, the glue:
    unfused_deltanet_decode), the state and the window bit for bit as
    that sequence leaves them (the window also as the plain version's,
    the state within K9_TOL of it), the same bits on a second launch.
    Timed as the model calls it (by dependent launch) beside its bound,
    the kernel alone by torch.profiler (``kernel_us``), the plain
    version, and the parent's sequence in turns with its device ops. No
    PyTorch call computes the mixer."""
    from ominix_mlx_tpu_torch.ops import _build
    from ominix_mlx_tpu_torch.ops import gated_delta as gd

    g = torch.Generator(device=dev).manual_seed(SEED + 61)
    parent = unfused_deltanet_decode(gd._k9_prep, gd._k9)
    rows = []
    for B in K9_DECODE_B:
        a = k9_decode_inputs(g, dev, B)
        Hk, Hv, d, _ = a[9]

        def on(window, state):
            return k9_decode_on(a, window, state)

        w1, w2, w3, w4, w5 = (a[2].clone() for _ in range(5))
        s1, s2, s3, s4, s5 = (a[6].clone() for _ in range(5))
        torch.cuda.synchronize()
        got = gd._k9_decode(*on(w1, s1))
        again = gd._k9_decode(*on(w3, s3))
        pair = parent(*on(w2, s2))
        want = gd.deltanet_decode_reference(*on(w4, s4))
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise RuntimeError(f"k9_decode B={B}: non-finite")
        ulps, pair_ulps = head_ulps(got, want), head_ulps(got, pair)
        checks = {"state_bitwise_equal_pair": bool(torch.equal(s1, s2)),
                  "window_bitwise_equal_pair": bool(torch.equal(w1, w2)),
                  "window_bitwise_equal_plain": bool(torch.equal(w1, w4)),
                  "bitwise_repeatable": bool(torch.equal(got, again)
                                             and torch.equal(s1, s3)
                                             and torch.equal(w1, w3))}
        state_rel = rel_to(s1, s4)

        def kernel():
            gd._k9_decode(*on(w5, s5), overlap=True)

        def unfused():
            parent(*on(w5, s5))

        row = {"B": B, "Hk": Hk, "Hv": Hv, "d": d,
               "max_abs_err": (got.float() - want.float()).abs().max()
               .item(), "head_ulps": ulps, "head_ulps_vs_pair": pair_ulps,
               "head_ulps_limit": K9_DECODE_ULPS,
               "output_bitwise_equal_pair": bool(torch.equal(got, pair)),
               "share_differ": (got != want).float().mean().item(),
               "state_rel_err": state_rel, "state_limit": K9_TOL, **checks,
               "ms": time_ms(kernel, 20, flush),
               "kernel_us": phase_us(kernel, ("k9_decode_kernel<",)).get(
                   "k9_decode_kernel"),
               "plain_ms": time_ms(lambda: gd.deltanet_decode_reference(
                   *on(w4, s4)), 5, flush),
               "device_ops": device_ops(kernel),
               "unfused_device_ops": device_ops(unfused),
               "max_active_clusters": _build.library()
               .ominix_k9_decode_clusters(Hv // Hk, 1),
               "clusters": B * Hk,
               "vs_parent_sequence": in_turns(unfused, kernel, flush),
               "library_ms": None,
               "library_error": "no PyTorch call computes the mixer",
               **k9_decode_bound(B, Hk, Hv, d)}
        row.update(versus(row))
        emit({"phase": "k9_decode", **row})
        if not (ulps <= K9_DECODE_ULPS and pair_ulps <= K9_DECODE_ULPS
                and state_rel < K9_TOL and all(checks.values())):
            raise RuntimeError(f"k9_decode B={B}: {row}")
        rows.append(row)
    return rows


def k10_inputs(g, dev, B, T, H=32, D=128):
    """A lightning layer's K10 inputs at MiniCPM-SALA's heads, as the
    model hands them: bf16 q (scaled by D^-0.5), k and v, the ALiBi slopes
    and a carried state."""
    from ominix_mlx_tpu_torch.models.lightning import alibi_slopes

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    return ((randn(B, H, T, D) * D ** -0.5).bfloat16(),
            randn(B, H, T, D).bfloat16(), randn(B, H, T, D).bfloat16(),
            torch.from_numpy(alibi_slopes(H)).to(dev),
            randn(B, H, D, D) * 0.1)


def k10_bound(B, T, H, D) -> dict:
    """K10's bound, whatever the form: the larger of the bytes any form
    must move (q, k and v in bf16 read once, o in float32 written once,
    the state read and written once) over the memory rate, and the
    chunked form's products (``k10_macs``) at the TF32 peak."""
    from ominix_mlx_tpu_torch.ops.lightning_attention import k10_macs

    nbytes = 3 * 2 * B * H * T * D + 4 * B * H * T * D + 8 * B * H * D * D \
        + 4 * H
    return bound(nbytes, 2 * B * H * k10_macs(T, D), "tf32")


def check_k10(dev, flush):
    """K10 in the form k10_plan picks (the recurrent form at decode, the
    chunked one for prompts) against lightning_reference at MiniCPM-SALA's
    32 heads of 128 and K10_SHAPES, bf16 inputs: outputs and the final
    state (written in place) within K10_TOL of max |plain|, the same bits
    on a second launch; timed beside k10_bound, the chunked form's one
    kernel also alone by torch.profiler (``kernel_us``). At
    K10_CROSSOVER_T the two forms in turns (recurrent, chunked, chunked,
    recurrent: ``k10_crossover``) beside the form the plan picks. No
    PyTorch call computes lightning attention."""
    from ominix_mlx_tpu_torch.ops import lightning_attention as la

    g = torch.Generator(device=dev).manual_seed(SEED + 50)
    rows = []
    for B, T in K10_SHAPES:
        q, k, v, sl, state = k10_inputs(g, dev, B, T)
        H, D = q.shape[1], q.shape[3]
        form = la.k10_plan(B, T, H, D)
        s1, s2, s3 = state.clone(), state.clone(), state.clone()
        got = la._k10_rule(q, k, v, sl, s1)
        again = la._k10_rule(q, k, v, sl, s3)
        want = la.lightning_reference(q, k, v, sl, s2)
        torch.cuda.synchronize()
        if not (torch.isfinite(got).all() and torch.isfinite(s1).all()):
            raise RuntimeError(f"K10 B={B} T={T}: non-finite")
        rel, rel_state = rel_to(got, want), rel_to(s1, s2)
        repeatable = bool(torch.equal(got, again) and torch.equal(s1, s3))
        row = {"B": B, "T": T, "H": H, "D": D, "form": form,
               "launches": la.k10_launches(B, T, H, D),
               "max_abs_err": (got - want).abs().max().item(),
               "rel_err": rel, "state_rel_err": rel_state,
               "bitwise_repeatable": repeatable,
               "ms": time_ms(lambda: la._k10_rule(q, k, v, sl, s1), 10,
                             flush),
               "plain_ms": time_ms(lambda: la.lightning_reference(
                   q, k, v, sl, s2), 3 if T <= 2048 else 1, flush),
               "library_ms": None,
               "library_error": "no PyTorch call computes lightning "
                                "attention",
               **k10_bound(B, T, H, D)}
        row["us_per_token"] = row["ms"] * 1e3 / T
        if form == "chunked":      # the kernel alone, without the launch
            row["kernel_us"] = phase_us(
                lambda: la._k10_rule(q, k, v, sl, s1),
                ("lightning_chunk_bf16(",)).get("lightning_chunk_bf16")
        row.update(versus(row))
        emit({"phase": "k10", **row})
        if not (rel < K10_TOL and rel_state < K10_TOL and repeatable):
            raise RuntimeError(f"K10 B={B} T={T}: rel error {rel}, state "
                               f"{rel_state}, repeatable {repeatable}")
        rows.append(row)
        del q, k, v, state, s1, s2, s3
    for T in K10_CROSSOVER_T:
        q, k, v, sl, state = k10_inputs(g, dev, 1, T)
        turns = in_turns(lambda: la._k10(q, k, v, sl, state),
                         lambda: la._k10_chunked(q, k, v, sl, state), flush)
        emit({"phase": "k10_crossover", "B": 1, "T": T,
              "recurrent_ms": turns["parent_ms"], "chunked_ms": turns["ms"],
              "chunked_speedup": turns["speedup"],
              "planned": la.k10_plan(1, T, q.shape[1], q.shape[3])})
    return rows


def k10_decode_inputs(g, dev, B, H=32, D=128):
    """A lightning layer's decode-step inputs at MiniCPM-SALA's heads as the
    model hands them to k10_decode: q, k and v as views of one fused bf16
    projection, the slopes, a carried state, and the keyword arguments (z,
    the norm weights near one, eps, RoPE's theta)."""
    from ominix_mlx_tpu_torch.models.lightning import alibi_slopes

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    N = H * D
    qkv = randn(B, 1, 3 * N).bfloat16()
    q, k, v = (t.reshape(B, 1, H, D).transpose(1, 2)
               for t in qkv.split([N, N, N], -1))
    kw = {"z": randn(B, 1, N).bfloat16(),
          "q_norm": (1 + 0.1 * randn(D)).bfloat16(),
          "k_norm": (1 + 0.1 * randn(D)).bfloat16(),
          "o_norm": (1 + 0.1 * randn(N)).bfloat16(), "eps": EPS,
          "rope_theta": float(MINICPM_SALA_HF["rope_theta"])}
    return (q, k, v, torch.from_numpy(alibi_slopes(H)).to(dev),
            randn(B, H, D, D) * 0.1, kw)


def unfused_decode(k10):
    """The decode mixer as the parent composes it: QK-norm and RoPE, the
    scale, ``k10`` (the state step: K10's recurrent form, this checkout's
    or the parent's), the cast, the output norm and the gate."""
    from ominix_mlx_tpu_torch.ops import lightning_attention as la
    from ominix_mlx_tpu_torch.ops.quant_matmul import rms_norm

    def call(q, k, v, slopes, state, z, q_norm, k_norm, o_norm, eps,
             rope_theta, offset):
        B, H, _, D = q.shape
        q, k = la.norm_rope(q, k, q_norm, k_norm, eps, rope_theta, offset)
        out = k10(q * D ** -0.5, k, v, slopes, state)
        out = out.transpose(1, 2).reshape(B, 1, H * D).to(v.dtype)
        return rms_norm(o_norm, out, eps) * torch.sigmoid(z)
    return call


def row_ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of each row's largest |want|."""
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(
        w.abs().amax(-1, keepdim=True))) - 7)
    return ((g - w).abs() / ulp).max().item()


def k10_decode_bound(B, H, D) -> dict:
    """k10_decode's bound: the state read and written once in float32; q,
    k, v, z and the output in bf16; the norm weights and slopes once;
    about four float32 operations a state element."""
    N = H * D
    nbytes = 8 * B * H * D * D + 2 * 5 * B * N + 2 * (2 * D + N) + 4 * H
    return bound(nbytes, 4 * B * H * D * D, "fp32")


def check_k10_decode(dev, flush):
    """k10_decode against lightning_decode_reference at MiniCPM-SALA's 32
    heads of 128 for each of K10_DECODE_CASES (random z and norm weights
    near one): q and k as the state step reads them and the state bit for
    bit, the output within K10_DECODE_ULPS (row_ulps), the same bits on a
    second launch. Timed as the model calls it (by dependent launch)
    beside its bound, the kernel alone by torch.profiler (``kernel_us``),
    the plain version, and the parent's sequence (the glue around K10's
    recurrent form, ``unfused_decode``, and its device ops) in turns. No
    PyTorch call computes the mixer."""
    from ominix_mlx_tpu_torch.ops import lightning_attention as la

    g = torch.Generator(device=dev).manual_seed(SEED + 57)
    parent = unfused_decode(la._k10)
    rows = []
    for B, offsets in K10_DECODE_CASES:
        q, k, v, sl, state, kw = k10_decode_inputs(g, dev, B)
        H, D = q.shape[1], q.shape[3]
        off = offsets if isinstance(offsets, int) else torch.tensor(
            offsets, device=dev)
        N = H * D
        qk1, qk2 = (torch.empty(B, 2, N, dtype=torch.bfloat16, device=dev)
                    for _ in range(2))
        s1, s2, s3 = state.clone(), state.clone(), state.clone()
        torch.cuda.synchronize()
        got = la._k10_decode(q, k, v, sl, s1, offset=off, qk_out=qk1, **kw)
        again = la._k10_decode(q, k, v, sl, s3, offset=off, **kw)
        want = la.lightning_decode_reference(q, k, v, sl, s2, offset=off,
                                             qk_out=qk2, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise RuntimeError(f"k10_decode B={B}: non-finite")
        ulps = row_ulps(got, want)
        checks = {"qk_bitwise_equal": bool(torch.equal(qk1, qk2)),
                  "state_bitwise_equal": bool(torch.equal(s1, s2)),
                  "bitwise_repeatable": bool(torch.equal(got, again)
                                             and torch.equal(s1, s3))}
        scratch = state.clone()

        def kernel():
            la._k10_decode(q, k, v, sl, scratch, offset=off, overlap=True,
                           **kw)

        def unfused():
            parent(q, k, v, sl, scratch, offset=off, **kw)

        row = {"B": B, "offsets": offsets, "H": H, "D": D,
               "max_abs_err": (got.float() - want.float()).abs().max()
               .item(), "row_ulps": ulps, "row_ulps_limit": K10_DECODE_ULPS,
               "share_differ": (got != want).float().mean().item(), **checks,
               "ms": time_ms(kernel, 20, flush),
               "kernel_us": phase_us(kernel, ("lightning_decode(",)).get(
                   "lightning_decode"),
               "plain_ms": time_ms(lambda: la.lightning_decode_reference(
                   q, k, v, sl, s2, offset=off, **kw), 5, flush),
               "unfused_device_ops": device_ops(unfused),
               "vs_parent_sequence": in_turns(unfused, kernel, flush),
               "library_ms": None,
               "library_error": "no PyTorch call computes the mixer",
               **k10_decode_bound(B, H, D)}
        row.update(versus(row))
        emit({"phase": "k10_decode", **row})
        if not (ulps <= K10_DECODE_ULPS and all(checks.values())):
            raise RuntimeError(f"k10_decode B={B} at {offsets}: {row}")
        rows.append(row)
    return rows


def k11_case(g, dev, B, S, totals, Hkv=2, H=32, D=128, ks=32):
    """A MiniCPM-SALA sparse layer's cache of S positions per row, K and V
    at random and the pooled keys from them (as
    benchmarks/longcontext_bench.py:59-64 jumps the offset), a bf16 decode
    query and the rows' totals."""
    from ominix_mlx_tpu_torch.models.sparse_attention import (
        SparseKVCache, compress_keys)

    c = SparseKVCache.init(B, Hkv, S, D, torch.bfloat16, ks, dev)
    c.k.normal_(generator=g)
    c.v.normal_(generator=g)
    c.comp.copy_(compress_keys(c.k, ks))
    q = (torch.randn(B, H, 1, D, generator=g, device=dev) * 0.3).bfloat16()
    return q, c, torch.tensor(totals, dtype=torch.int32, device=dev)


def chosen(vals, idx):
    """Per (row, KV head) the sorted ids of the selected blocks with a
    finite score."""
    from ominix_mlx_tpu_torch.ops.sparse_attention import NEG_INF

    return [[sorted(i[v > NEG_INF / 2].tolist()) for v, i in zip(vr, ir)]
            for vr, ir in zip(vals.cpu(), idx.cpu())]


def selected_sets(scores, topk):
    """Per (row, KV head) the sorted ids of the top-k blocks with a finite
    score."""
    return chosen(*torch.topk(scores, topk, dim=-1))


def check_k11(dev, flush):
    """K11 at MiniCPM-SALA's 32 query heads over 2 KV heads of 128 and the
    production InfLLMv2 config, for each of K11_CASES (caches at random):
    k11_score against block_scores_reference (the finite scores within
    K11_SCORE_TOL, the masked ones NEG_INF in both, and the blocks
    torch.topk selects from each equal); k11_select against k11_score's
    scores sorted stably (values and ids bit for bit), against
    block_select_reference (the finite scores within K11_SCORE_TOL, the
    same blocks chosen) and against torch.topk's choice, and k11_attend
    given its selection bit-equal to k11_attend given the parent's (score,
    then torch.topk); k11_attend against sparse_attend_reference (the
    gather plus masked sdpa) given the same indices, per (row, head) within
    K11_TOL, bit-repeatable. Each timed beside its plain version, a read of
    the same bytes, and its bound: the scorer's bytes are the blocks that
    can be valid (it reads no other), the selector's those and the top k
    written, the attend's the valid slots' K and V rows; the selector also
    in turns with the parent's score and torch.topk, and torch.topk alone
    on the same scores as its library time. No PyTorch call computes the
    scorer or the attend. Returns (score rows, select rows, attend
    rows)."""
    from ominix_mlx_tpu_torch.models.sparse_attention import SparseConfig
    from ominix_mlx_tpu_torch.ops import sparse_attention as sa

    sc = SparseConfig()
    ie, W, ks, topk = sc.init_end, sc.window_size, sc.kernel_size, sc.topk
    g = torch.Generator(device=dev).manual_seed(SEED + 53)
    score_rows, select_rows, attend_rows = [], [], []
    for B, S, totals in K11_CASES:
        q, c, total = k11_case(g, dev, B, S, totals)
        H, D, Hkv, nb = q.shape[1], q.shape[3], c.k.shape[1], c.comp.shape[2]
        sargs = (q, c.comp, total, ie, W, ks)
        got = sa._k11_score(*sargs)
        want = sa.block_scores_reference(*sargs)
        top, idx = torch.topk(want, topk, dim=-1)
        aargs = (q, c.k, c.v, idx, top, total, ie, W, ks, D ** -0.5)
        out = sa._k11_attend(*aargs)
        again = sa._k11_attend(*aargs)
        plain = sa.sparse_attend_reference(*aargs)
        kk = min(topk, nb)
        sel = sa._k11_select(*sargs, kk)
        sel_again = sa._k11_select(*sargs, kk)
        sv, si = torch.sort(got, dim=-1, descending=True, stable=True)
        pv, pi = sa.block_select_reference(*sargs, kk)
        ptop, pidx = torch.topk(got, kk, dim=-1)
        rest = (total, ie, W, ks, D ** -0.5)
        sel_out = sa._k11_attend(q, c.k, c.v, sel[1], sel[0], *rest)
        par_out = sa._k11_attend(q, c.k, c.v, pidx, ptop, *rest)
        torch.cuda.synchronize()
        masked = want <= sa.NEG_INF / 2
        fin = ~masked
        score_rel = (((got - want)[fin].abs().max() / want[fin].abs().max())
                     .item() if fin.any() else 0.0)
        same_mask = bool(torch.equal(got <= sa.NEG_INF / 2, masked))
        same_sel = selected_sets(got, topk) == selected_sets(want, topk)
        attend_rel = row_rel_err(out, plain)
        repeatable = bool(torch.equal(out, again))
        # what each must read: the blocks that can be valid, the valid
        # slots (init, the finite top-k blocks, the window)
        tot = [int(t) for t in totals]
        ws = [max(t - W, ie) for t in tot]
        blocks = sum(max(0, w // ks - -(-ie // ks)) for w in ws) * Hkv
        nsel = (top > sa.NEG_INF / 2).sum(-1).cpu()
        slots = sum(min(ie, t) * Hkv + int(nsel[b].sum()) * ks
                    + Hkv * max(t - w, 0)
                    for b, (t, w) in enumerate(zip(tot, ws)))
        s_bytes = 2 * blocks * D + 2 * B * Hkv * D + 4 * B * Hkv * nb
        a_bytes = 4 * slots * D + 4 * B * H * D + 12 * B * Hkv * topk
        kf, vf = c.k.reshape(-1), c.v.reshape(-1)
        case = {"B": B, "S": S, "totals": tot, "H": H, "Hkv": Hkv, "D": D}
        srow = {**case, "max_abs_err": (got - want)[fin].abs().max().item()
                if fin.any() else 0.0, "rel_err": score_rel,
                "masked_equal": same_mask, "selected_equal": same_sel,
                "blocks_read": blocks,
                "ms": time_ms(lambda: sa._k11_score(*sargs), 20, flush),
                "plain_ms": time_ms(lambda: sa.block_scores_reference(
                    *sargs), 5, flush),
                "read_ms": time_ms(lambda: kf[:blocks * D].max(), 20, flush),
                "library_ms": None,
                "library_error": "no PyTorch call computes the masked block "
                                 "scores",
                **bound(s_bytes, 2 * blocks * D, "fp32")}
        arow = {**case, "max_abs_err": (out.float() - plain.float()).abs()
                .max().item(), "rel_err": attend_rel,
                "bitwise_repeatable": repeatable, "slots_read": slots,
                "splits": sa.k11_plan(B, Hkv, ie + topk * ks + W)[0],
                "ms": time_ms(lambda: sa._k11_attend(*aargs), 20, flush),
                "plain_ms": time_ms(lambda: sa.sparse_attend_reference(
                    *aargs), 5, flush),
                "read_ms": time_ms(lambda: (kf[:slots * D].max(),
                                            vf[:slots * D].max()), 20,
                                   flush),
                "library_ms": None,
                "library_error": "no PyTorch call computes attention over "
                                 "a gathered slot set",
                **bound(a_bytes, 4 * slots * D * (H // Hkv), "bf16")}
        for row, name in ((srow, "k11_score"), (arow, "k11_attend")):
            row.update(versus(row))
            emit({"phase": name, **row})
        if not (score_rel < K11_SCORE_TOL and same_mask and same_sel
                and attend_rel < K11_TOL and repeatable):
            raise RuntimeError(f"K11 B={B} S={S}: score {score_rel}, mask "
                               f"{same_mask}, selection {same_sel}, attend "
                               f"{attend_rel}, repeatable {repeatable}")
        pfin = pv > sa.NEG_INF / 2
        sel_checks = {
            "sorted_scores_bitwise_equal": bool(
                torch.equal(sel[0], sv[..., :kk])
                and torch.equal(sel[1], si[..., :kk])),
            "bitwise_repeatable": bool(torch.equal(sel[0], sel_again[0])
                                       and torch.equal(sel[1],
                                                       sel_again[1])),
            "masked_equal": bool(torch.equal(sel[0] > sa.NEG_INF / 2, pfin)),
            "chosen_equal_plain": chosen(*sel) == chosen(pv, pi),
            "chosen_equal_topk": chosen(*sel) == chosen(ptop, pidx),
            "attend_bitwise_equal_parent": bool(torch.equal(sel_out,
                                                            par_out))}
        sel_rel = (((sel[0] - pv)[pfin].abs().max() / pv[pfin].abs().max())
                   .item() if pfin.any() else 0.0)
        xrow = {**case, "k": kk, "max_abs_err": (sel[0] - pv)[pfin].abs()
                .max().item() if pfin.any() else 0.0, "rel_err": sel_rel,
                **sel_checks,
                "ms": time_ms(lambda: sa._k11_select(*sargs, kk), 20, flush),
                "plain_ms": time_ms(lambda: sa.block_select_reference(
                    *sargs, kk), 5, flush),
                "score_ms": srow["ms"],
                "vs_parent_sequence": in_turns(
                    lambda: torch.topk(sa._k11_score(*sargs), kk, dim=-1),
                    lambda: sa._k11_select(*sargs, kk), flush),
                "library_ms": time_ms(lambda: torch.topk(got, kk, dim=-1),
                                      20, flush),
                "library": "torch.topk of the parent's scores",
                **bound(s_bytes - 4 * B * Hkv * nb + 12 * B * Hkv * kk,
                        2 * blocks * D, "fp32")}
        xrow.update(versus(xrow))
        emit({"phase": "k11_select", **xrow})
        if not (sel_rel < K11_SCORE_TOL and all(sel_checks.values())):
            raise RuntimeError(f"k11_select B={B} S={S}: {xrow}")
        score_rows.append(srow)
        select_rows.append(xrow)
        attend_rows.append(arow)
        del q, c, total, kf, vf
        torch.cuda.empty_cache()
    return score_rows, select_rows, attend_rows


def parent_module(parent: str, rel: str, name: str):
    """The module file ``rel`` of the checkout at ``parent``, loaded as
    ``name`` (its imports of the package resolve to this checkout's)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(parent, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def compare_k9_decode(plib, dev, flush):
    """The parent's DeltaNet decode mixer (``plib``'s ``ominix_k9_prep`` and
    K9 recurrent entry ``ominix_gated_delta``, then the glue:
    unfused_deltanet_decode) against this checkout's one launch on the
    same inputs at each of K9_DECODE_B, timed in turns (parent, this,
    this, parent), with the parent's device ops; the state and the window
    of both bit for bit equal, the outputs within K9_DECODE_ULPS. One
    ``k9_decode_vs_parent`` line per batch."""
    from ominix_mlx_tpu_torch.ops import gated_delta as gd

    stream = torch.cuda.current_stream(dev).cuda_stream

    def parent_prep(qkvz, ba, window, conv_w, A_log, dt_bias, heads):
        Hk, Hv, dk, dv = heads
        B, T, _ = qkvz.shape

        def out(*shape):
            return torch.empty(*shape, dtype=torch.float32, device=dev)

        q, k = out(B, T, Hk, dk), out(B, T, Hk, dk)
        v, g, beta = out(B, T, Hv, dv), out(B, T, Hv), out(B, T, Hv)
        rc = plib.ominix_k9_prep(
            qkvz.data_ptr(), ba.data_ptr(), window.data_ptr(),
            conv_w.data_ptr(), A_log.data_ptr(), dt_bias.data_ptr(),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            beta.data_ptr(), B, T, Hk, Hv, dk, dv, conv_w.shape[-1],
            int(qkvz.dtype == torch.bfloat16), dk ** -0.5, stream)
        if rc != 0:
            raise RuntimeError(f"parent k9_prep: CUDA error {rc}")
        return q, k, v, g, beta

    def parent_k9(q, k, v, g, beta, state):
        B, T, Hk, dk = q.shape
        Hv, dv = v.shape[2], v.shape[3]
        o = torch.empty(B, T, Hv, dv, dtype=torch.float32, device=dev)
        rc = plib.ominix_gated_delta(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            beta.data_ptr(), state.data_ptr(), o.data_ptr(), B, T, Hk, Hv,
            dk, dv, stream)
        if rc != 0:
            raise RuntimeError(f"parent K9: CUDA error {rc}")
        return o

    parent = unfused_deltanet_decode(parent_prep, parent_k9)
    g = torch.Generator(device=dev).manual_seed(SEED + 62)
    for B in K9_DECODE_B:
        a = k9_decode_inputs(g, dev, B)
        w1, w2 = a[2].clone(), a[2].clone()
        s1, s2 = a[6].clone(), a[6].clone()
        torch.cuda.synchronize()
        theirs = parent(*k9_decode_on(a, w1, s1))
        mine = gd._k9_decode(*k9_decode_on(a, w2, s2))
        torch.cuda.synchronize()
        held = {"state_bitwise_equal": bool(torch.equal(s1, s2)),
                "window_bitwise_equal": bool(torch.equal(w1, w2)),
                "output_bitwise_equal": bool(torch.equal(theirs, mine)),
                "head_ulps": head_ulps(mine, theirs)}
        emit({"phase": "k9_decode_vs_parent", "B": B, **held,
              "parent_device_ops": device_ops(
                  lambda: parent(*k9_decode_on(a, w1, s1))),
              **in_turns(lambda: parent(*k9_decode_on(a, w1, s1)),
                         lambda: gd._k9_decode(*k9_decode_on(a, w2, s2),
                                               overlap=True), flush)})
        if not (held["state_bitwise_equal"] and held["window_bitwise_equal"]
                and held["head_ulps"] <= K9_DECODE_ULPS):
            raise RuntimeError(f"k9_decode_vs_parent B={B}: {held}")


def compare_k10_decode(plib, dev, flush):
    """The parent's decode mixer (the glue around ``plib``'s K10 recurrent
    entry ``ominix_lightning(q, k, v, slopes, state, o, B, H, T, D, bf16,
    9 strides, stream)``, ``unfused_decode``) against this checkout's one
    launch on the same inputs at each of K10_DECODE_CASES, timed in turns
    (parent, this, this, parent); the state of both held to the plain
    version (bit for bit for this checkout's, within K10_TOL for the
    parent's). One ``k10_decode_vs_parent`` line per case."""
    from ominix_mlx_tpu_torch.ops import lightning_attention as la

    stream = torch.cuda.current_stream(dev).cuda_stream

    def parent_k10(q, k, v, sl, st):
        B, H, T, D = q.shape
        o = torch.empty(B, H, T, D, dtype=torch.float32, device=dev)
        rc = plib.ominix_lightning(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), sl.data_ptr(),
            st.data_ptr(), o.data_ptr(), B, H, T, D, 1,
            *[x for t in (q, k, v) for x in t.stride()[:3]], stream)
        if rc != 0:
            raise RuntimeError(f"parent K10: CUDA error {rc}")
        return o

    parent = unfused_decode(parent_k10)
    g = torch.Generator(device=dev).manual_seed(SEED + 60)
    for B, offsets in K10_DECODE_CASES:
        q, k, v, sl, state, kw = k10_decode_inputs(g, dev, B)
        off = offsets if isinstance(offsets, int) else torch.tensor(
            offsets, device=dev)
        s1, s2, s3 = state.clone(), state.clone(), state.clone()
        torch.cuda.synchronize()
        theirs = parent(q, k, v, sl, s1, offset=off, **kw)
        mine = la._k10_decode(q, k, v, sl, s2, offset=off, **kw)
        want = la.lightning_decode_reference(q, k, v, sl, s3, offset=off,
                                             **kw)
        torch.cuda.synchronize()
        held = {"parent_state_rel": rel_to(s1, s3),
                "state_bitwise_equal": bool(torch.equal(s2, s3)),
                "parent_row_ulps": row_ulps(theirs, want),
                "row_ulps": row_ulps(mine, want)}
        emit({"phase": "k10_decode_vs_parent", "B": B, "offsets": offsets,
              **held, **in_turns(
                  lambda: parent(q, k, v, sl, s1, offset=off, **kw),
                  lambda: la._k10_decode(q, k, v, sl, s2, offset=off,
                                         overlap=True, **kw), flush)})
        if not (held["parent_state_rel"] < K10_TOL
                and held["state_bitwise_equal"]
                and held["row_ulps"] <= K10_DECODE_ULPS):
            raise RuntimeError(f"k10_decode_vs_parent B={B}: {held}")


def compare_k11_select(plib, dev, flush):
    """The parent's selection (``plib``'s ``ominix_sparse_score(q, comp,
    total, scores, B, H, Hkv, nb, D, init_end, window, ks, stream)``, then
    torch.topk) against this checkout's k11_select on the same inputs at
    each of K11_CASES, timed in turns (parent, this, this, parent); the
    chosen blocks equal. One ``k11_select_vs_parent`` line per case."""
    from ominix_mlx_tpu_torch.models.sparse_attention import SparseConfig
    from ominix_mlx_tpu_torch.ops import sparse_attention as sa

    sc = SparseConfig()
    ie, W, ks, topk = sc.init_end, sc.window_size, sc.kernel_size, sc.topk
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(SEED + 61)
    for B, S, totals in K11_CASES:
        q, c, total = k11_case(g, dev, B, S, totals)
        H, D, Hkv, nb = q.shape[1], q.shape[3], c.k.shape[1], c.comp.shape[2]
        kk = min(topk, nb)
        scores = torch.empty(B, Hkv, nb, dtype=torch.float32, device=dev)

        def parent_call():
            rc = plib.ominix_sparse_score(
                q.data_ptr(), c.comp.data_ptr(), total.data_ptr(),
                scores.data_ptr(), B, H, Hkv, nb, D, ie, W, ks, stream)
            if rc != 0:
                raise RuntimeError(f"parent k11_score: CUDA error {rc}")
            return torch.topk(scores, kk, dim=-1)

        theirs = parent_call()
        mine = sa._k11_select(q, c.comp, total, ie, W, ks, kk)
        torch.cuda.synchronize()
        same = chosen(*mine) == chosen(*theirs)
        emit({"phase": "k11_select_vs_parent", "B": B, "S": S,
              "totals": totals, "chosen_equal": same,
              **in_turns(parent_call, lambda: sa._k11_select(
                  q, c.comp, total, ie, W, ks, kk), flush)})
        if not same:
            raise RuntimeError(f"k11_select_vs_parent B={B} S={S}")
        del q, c, total, scores
        torch.cuda.empty_cache()


def check_next_experts(dev, flush):
    """K4 and K5 at Qwen3-Next-80B-A3B's 512 experts, 4-bit (its w4a8
    main path): K4 at top 10 (K4_NEXT_SHAPES), K5 on the packed experts
    at a 128-token prompt's S = 1280 token copies routed uniformly at
    random (K5_NEXT_SHAPES), beside dequantize_experts +
    torch._grouped_mm. Returns (K4 rows, K5 rows)."""
    from ominix_mlx_tpu_torch.ops import grouped_matmul as gmm
    from ominix_mlx_tpu_torch.ops import quant_matmul as qm

    E = QWEN3_NEXT_E
    g = torch.Generator(device=dev).manual_seed(SEED + 37)
    k4_rows = [k4_row(qm, g, dev, flush, name, T, k, N, K, 4, E,
                      "k4_e512") for name, T, k, N, K in K4_NEXT_SHAPES]
    k5_rows = []
    for name, S, N, K in K5_NEXT_SHAPES:
        w = random_experts(qm, g, dev, N, K, 4, E)
        xs = torch.randn(S, K, generator=g, device=dev).bfloat16()
        ids = torch.randint(0, E, (S,), generator=g, device=dev)
        gs = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
            0, ids, torch.ones_like(ids))
        gi = gs.int()
        offs = torch.cumsum(gs, 0).to(torch.int32)
        k5_rows.append(k5_row(
            name, S, N, K, gs, xs, w, lambda: gmm._k5(xs, w, gi),
            lambda: gmm.grouped_matmul_reference(xs, w, gs),
            lambda: torch._grouped_mm(
                xs, qm.dequantize_experts(w).transpose(1, 2), offs=offs),
            "dequantize_experts + torch._grouped_mm (bf16 out)", flush, 4,
            E))
        del w, xs
        torch.cuda.empty_cache()
    return k4_rows, k5_rows


def compare_k5(plib, dev, flush):
    """K5 of a parent checkout (``plib``: its kernel library, entry
    ``ominix_grouped_mm(xs, w, scales, biases, gs, out, tile_map, S, N, K,
    E, group, bits, x_slots, w_slots, stream)``, the signature this
    checkout has too) against this checkout's on the same inputs, timed
    in turns (parent, this, this, parent): bf16 experts at every
    K5_SHAPES shape, and 4- and 8-bit experts at every K5_PACKED_SHAPES
    shape and K5_PACKED_S row count (the parent given this checkout's
    plan). One ``k5_vs_parent`` line per shape."""
    from ominix_mlx_tpu_torch.ops import grouped_matmul as gmm
    from ominix_mlx_tpu_torch.ops import quant_matmul as qm

    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    cpu_g = torch.Generator().manual_seed(SEED + 9)
    cases = [(name, S, N, K, 16) for name, S, N, K in K5_SHAPES] + [
        (name, S, N, K, bits) for bits in (4, 8)
        for name, N, K in K5_PACKED_SHAPES for S in K5_PACKED_S]
    weights = {}
    for name, S, N, K, bits in cases:
        if (N, K, bits) not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            weights[(N, K, bits)] = (
                (torch.randn(MOE_E, N, K, generator=g, device=dev)
                 * K ** -0.5).bfloat16() if bits == 16
                else random_experts(qm, g, dev, N, K, bits))
        w = weights[(N, K, bits)]
        xs = torch.randn(S, K, generator=g, device=dev).bfloat16()
        gs = skewed_groups(S, cpu_g).to(dev).int()
        out = torch.empty(S, N, dtype=torch.float32, device=dev)
        tmap = torch.empty(2 * (MOE_E + 1), dtype=torch.int32, device=dev)
        packed = bits != 16
        plan = gmm.k5_plan(K, bits, GS if packed else 1)
        ptrs = ((w.data.data_ptr(), w.scales.data_ptr(), w.biases.data_ptr())
                if packed else (w.data_ptr(), None, None))

        def parent_call():
            rc = plib.ominix_grouped_mm(
                xs.data_ptr(), *ptrs, gs.data_ptr(), out.data_ptr(),
                tmap.data_ptr(), S, N, K, MOE_E, GS if packed else 1, bits,
                plan.x_slots, plan.w_slots, stream)
            if rc != 0:
                raise RuntimeError(f"parent K5: CUDA error {rc}")

        def this_call():
            gmm._k5(xs, w, gs)

        parent_call()
        rel = row_rel_err(out, gmm._k5(xs, w, gs))
        emit({"phase": "k5_vs_parent", "shape": name, "S": S, "N": N,
              "K": K, "bits": bits, "parent_vs_this_rel": rel,
              **in_turns(parent_call, this_call, flush)})
        del xs, out
    weights.clear()
    torch.cuda.empty_cache()


# ----------------------------------------------------------- main path ------

class ByteTokenizer:
    """Byte-level tokenizer: UTF-8 bytes are ids 0..255, the ChatML role
    words are one id each (as in Qwen's vocabulary), and Qwen3's special
    ids mark the turns; a vocabulary too small for those (Mistral's 32000,
    GLM-4's 151552) takes ids 259-261 for them. Any other id decodes as
    ``<id>``."""

    SPECIAL = {"<|endoftext|>": 151643, "<|im_start|>": 151644,
               "<|im_end|>": 151645, "user": 256, "assistant": 257,
               "system": 258}
    _split = re.compile("(" + "|".join(re.escape(s) for s in SPECIAL) + ")")

    def __init__(self, vocab_size: int = 151936):
        if vocab_size <= max(self.SPECIAL.values()):
            self.SPECIAL = {**self.SPECIAL, "<|endoftext|>": 259,
                            "<|im_start|>": 260, "<|im_end|>": 261}
        self.eos_token_id = self.SPECIAL["<|im_end|>"]
        self._names = {v: k for k, v in self.SPECIAL.items()}

    def encode(self, text):
        ids = []
        for part in self._split.split(text):
            if part in self.SPECIAL:
                ids.append(self.SPECIAL[part])
            else:
                ids.extend(part.encode("utf-8"))
        return ids

    def decode(self, ids):
        out, buf = [], bytearray()
        for i in ids:
            if i < 256:
                buf.append(i)
                continue
            out.append(buf.decode("utf-8", "replace"))
            buf = bytearray()
            out.append(self._names.get(i, f"<{i}>"))
        out.append(buf.decode("utf-8", "replace"))
        return "".join(out)


def qwen3_4b():
    """Qwen3-4B (HF Qwen/Qwen3-4B config.json), the same numbers as the
    repository's bench.py."""
    from ominix_mlx_tpu_torch.models.base import TransformerConfig
    return TransformerConfig(
        vocab_size=151936, hidden_size=2560, num_layers=36, num_heads=32,
        num_kv_heads=8, head_dim=128, intermediate_size=9728,
        rope_theta=1000000.0, use_qk_norm=True, tie_word_embeddings=True,
        rms_norm_eps=1e-6)


def qwen3_30b_a3b():
    """Qwen3-30B-A3B (HF Qwen/Qwen3-30B-A3B config.json): 48 layers, every
    one sparse, 128 experts, top 8."""
    from ominix_mlx_tpu_torch.models import qwen3_moe
    return qwen3_moe.config_from_hf({
        "model_type": "qwen3_moe", "vocab_size": 151936, "hidden_size": 2048,
        "num_hidden_layers": 48, "num_attention_heads": 32,
        "num_key_value_heads": 4, "head_dim": 128, "intermediate_size": 6144,
        "moe_intermediate_size": 768, "num_experts": 128,
        "num_experts_per_tok": 8, "norm_topk_prob": True,
        "decoder_sparse_step": 1, "mlp_only_layers": [],
        "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
        "tie_word_embeddings": False})


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def post(port, body) -> bytes:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            raise RuntimeError(f"HTTP {r.status}")
        return r.read()


def chat(port, content, stream=False, model="qwen3-4b", system=None,
         **kw):
    messages = [{"role": "user", "content": content}]
    if system is not None:
        messages.insert(0, {"role": "system", "content": system})
    body = {"model": model, "max_tokens": MAX_TOKENS, "temperature": 0.0,
            "stream": stream, "messages": messages, **kw}
    raw = post(port, body)
    if not stream:
        out = json.loads(raw)
        return (out["choices"][0]["message"]["content"],
                out["usage"]["prompt_tokens"],
                out["usage"]["completion_tokens"])
    events = [ln[6:] for ln in raw.decode().split("\n")
              if ln.startswith("data: ")]
    if not events or events[-1] != "[DONE]":
        raise RuntimeError("stream did not end with [DONE]")
    chunks = [json.loads(e) for e in events[:-1]]
    if any("error" in c for c in chunks):
        raise RuntimeError(f"stream error: {chunks}")
    text = "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks)
    usage = chunks[-1]["usage"]
    return text, usage["prompt_tokens"], usage["completion_tokens"]


def send_concurrent(port, model, requests) -> dict:
    """Send chat requests {key: (content, keyword arguments of chat)} to
    ``model`` all at once, a thread each. Returns {key: (text, prompt
    tokens, completion tokens, seconds)}; raises if any request failed."""
    import threading

    res, errs = {}, []

    def one(k):
        try:
            t0 = time.perf_counter()
            content, kw = requests[k]
            text, n_prompt, n_out = chat(port, content, model=model, **kw)
            res[k] = (text, n_prompt, n_out, time.perf_counter() - t0)
        except Exception as e:       # raised below
            errs.append((k, e))

    threads = [threading.Thread(target=one, args=(k,)) for k in requests]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errs or len(res) != len(requests):
        raise RuntimeError(f"concurrent requests to {model} failed: {errs}")
    return res


# the kernels whose wrappers take x [M, K] and a packed weight first
QMM_KERNELS = ("k1", "k4", "k5", "k6", "k7")


def plain_versions() -> dict:
    """{kernel: (module, wrapper name, plain version)} for every kernel
    wrapper on the model paths."""
    from ominix_mlx_tpu_torch.ops import flash_attention as fa
    from ominix_mlx_tpu_torch.ops import gated_delta as gd
    from ominix_mlx_tpu_torch.ops import grouped_matmul as gmm
    from ominix_mlx_tpu_torch.ops import lightning_attention as la
    from ominix_mlx_tpu_torch.ops import quant_matmul as qm
    from ominix_mlx_tpu_torch.ops import sparse_attention as sa

    return {"k1": (qm, "_k1", lambda x, w, nw=None, eps=EPS: (
                qm.qmm_p_reference(x, w, nw, eps) if x.shape[0] == 1
                else qm.qmm_dq_reference(x, w))),
            "k2": (fa, "_k2", fa.flash_prefill_reference),
            "k4": (qm, "_k4", lambda x, w, ids, up=None: (
                qm.gather_qmm_reference(x, w, ids, 8) if up is None else
                (qm.gather_qmm_reference(x, w, ids, 8),
                 qm.gather_qmm_reference(x, up, ids, 8)))),
            "k5": (gmm, "_k5", gmm.grouped_matmul_reference),
            "k6": (qm, "_k6", qm.qmm_p_reference),
            "k7": (qm, "_k7", qm.qmm_dq_reference),
            "k9": (gd, "_k9_rule", gd.gated_delta_rule_reference),
            "k9_prep": (gd, "_k9_prep", gd.deltanet_prep_reference),
            "k9_decode": (gd, "_k9_decode",
                          lambda *a, overlap=False, **kw:
                          gd.deltanet_decode_reference(*a, **kw)),
            "k10": (la, "_k10_rule", la.lightning_reference),
            "k10_decode": (la, "_k10_decode",
                           lambda *a, overlap=False, **kw:
                           la.lightning_decode_reference(*a, **kw)),
            "k11_score": (sa, "_k11_score", sa.block_scores_reference),
            "k11_select": (sa, "_k11_select", sa.block_select_reference),
            "k11_attend": (sa, "_k11_attend", sa.sparse_attend_reference)}


@contextlib.contextmanager
def swapped_kernels(wrap):
    """Replace every kernel wrapper by ``wrap(name, wrapper, plain
    version)`` for the duration (the logits check's runs only)."""
    table = plain_versions()
    saved = {k: getattr(mod, attr) for k, (mod, attr, _) in table.items()}
    try:
        for k, (mod, attr, plain) in table.items():
            setattr(mod, attr, wrap(k, saved[k], plain))
        yield
    finally:
        for k, (mod, attr, _) in table.items():
            setattr(mod, attr, saved[k])


def plain_kernels(keep=(), args=None):
    """Route the kernel wrappers, all but those named in ``keep``, to their
    plain versions. ``args`` (optional, (kernel, arguments) -> arguments)
    rewrites the arguments of the quantized matmuls' plain versions: the
    logits check's controls."""
    def wrap(k, kern, plain):
        if k in keep:
            return kern
        if args is None or k not in QMM_KERNELS:
            return plain
        return lambda *a: plain(*args(k, a))
    return swapped_kernels(wrap)


def reversed_k(w):
    """A packed weight (or stack of experts) with its K axis reversed:
    the groups in reverse order and each group's codes reversed. Against
    x reversed along K it computes the same function as ``w`` with every
    float32 sum in another order."""
    data = w.data.flip(-1)
    if w.bits == 4:                 # byte j holds codes 2j and 2j+1
        data = ((data & 15) << 4) | (data >> 4)
    return dataclasses.replace(w, data=data.contiguous(),
                               scales=w.scales.flip(-1).contiguous(),
                               biases=w.biases.flip(-1).contiguous())


def without_last_group(w):
    """A packed weight whose last group of K weighs nothing (scale and
    bias 0): what a kernel whose loop stops one group early computes."""
    s, b = w.scales.clone(), w.biases.clone()
    s[..., -1] = 0
    b[..., -1] = 0
    return dataclasses.replace(w, scales=s, biases=b)


def control_args(transform):
    """(kernel, arguments) -> arguments of a quantized matmul's plain
    version under ``transform``: "reversed" (x, the fused norm's weight
    and the packed weight reversed along K) or "last_group" (the packed
    weight without its last group). Transformed weights are cached."""
    cache = {}

    def weight(w):
        if id(w) not in cache:
            cache[id(w)] = (w, reversed_k(w) if transform == "reversed"
                            else without_last_group(w))
        return cache[id(w)][1]

    def args(k, a):
        x, w, *rest = a
        if transform == "reversed":
            x = x.flip(-1).contiguous()
            if k == "k1" and rest and rest[0] is not None:
                rest[0] = rest[0].flip(-1).contiguous()
        if k == "k4" and len(rest) > 1 and rest[1] is not None:
            rest[1] = weight(rest[1])        # the up stack of gate and up
        return (x, weight(w), *rest)
    return args


def serve_requests(dev, cfg, params, name, keys, module=None):
    """Four HTTP chat requests through Server + ChatModel, one at a time:
    short, long (256 bucket), streamed, and short again. Returns
    ({request: row}, launch counts of the whole run); each row holds the
    launches of ``keys`` in that request."""
    from ominix_mlx_tpu_torch.models import base
    from ominix_mlx_tpu_torch.ops import _build
    from ominix_mlx_tpu_torch.serving.server import ChatModel, Server

    model = ChatModel(name, params, cfg, ByteTokenizer(cfg.vocab_size), dev,
                      module or base)
    port = free_port()
    srv = Server(port=port)
    srv.add_model(name, model)
    srv.start_background()
    long_prompt = ("Summarise the following notes in one line. "
                   + "The kernels stream packed weights once per token. "
                   * 4)
    requests = [("short", "Hi!", False), ("long", long_prompt, False),
                ("stream", "Tell me a story.", True),
                ("short_again", "Hi!", False)]
    results = {}
    try:
        _build.reset_launches()
        for req, content, stream in requests:
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            text, n_prompt, n_out = chat(port, content, stream, model=name)
            dt = time.perf_counter() - t0
            delta = {k: _build.LAUNCHES[k] - before.get(k, 0) for k in keys}
            row = {"phase": "request", "model": name, "name": req,
                   "stream": stream, "prompt_tokens": n_prompt,
                   "completion_tokens": n_out, "seconds": dt,
                   "launches": delta, "text": text[:80]}
            emit(row)
            if n_out <= 0 or not text:
                raise RuntimeError(f"request {req}: empty completion")
            results[req] = row
        counts = dict(_build.LAUNCHES)
    finally:
        srv.shutdown()
    if results["short"]["prompt_tokens"] > 16:
        raise RuntimeError("the short prompt does not bucket to 16")
    if not 128 < results["long"]["prompt_tokens"] <= 256:
        raise RuntimeError("the long prompt does not bucket to 256")
    if results["short"]["text"] != results["short_again"]["text"]:
        raise RuntimeError("greedy decode is not deterministic")
    for k in keys:
        if counts.get(k, 0) < 1:
            raise RuntimeError(f"{k} never launched on the main path")
    return results, counts


def serve_main_path(dev, cfg, params, phase="serve", name="qwen3-4b",
                    w8="", panel_projections=4, module=None):
    """Qwen3-4B w4a8 (or, with w8="_w8", w8a8) on panels: every decode
    token runs K1 at M=1 for ``panel_projections`` projections a layer
    (qkv, o, gate_up, down: 4; GLM-4-9B's down_proj takes the dense route:
    3) and the lm_head; the 16-token bucket's prefill K1 at M=16 (the dq
    formula)."""
    layers = cfg.num_layers
    per_token = panel_projections * layers + 1
    m1, mn = "k1_m1" + w8, "k1_mn" + w8
    results, counts = serve_requests(dev, cfg, params, name, (m1, mn, "k2"),
                                     module)
    for req, row in results.items():
        n_out, delta = row["completion_tokens"], row["launches"]
        if delta[m1] < per_token * (n_out - 1):
            raise RuntimeError(f"request {req}: K1 M=1 ran "
                               f"{delta[m1]} times for {n_out} tokens")
        if delta["k2"] < 1:
            raise RuntimeError(f"request {req}: K2 never ran")
    if results["short"]["launches"][mn] < per_token:
        raise RuntimeError("prefill at bucket 16 did not run K1 at M=16")
    emit({"phase": phase, "launches": counts, "ok": True})
    return counts


@contextlib.contextmanager
def counting_dequantize_experts():
    """Count the calls of quant_matmul.dequantize_experts (the bf16 copy of
    every expert that K5 on packed experts replaces) for the duration:
    yields a dict whose "calls" grows with each."""
    from ominix_mlx_tpu_torch.ops import quant_matmul as qm

    seen, real = {"calls": 0}, qm.dequantize_experts

    def counted(*a, **k):
        seen["calls"] += 1
        return real(*a, **k)
    qm.dequantize_experts = counted
    try:
        yield seen
    finally:
        qm.dequantize_experts = real


@contextlib.contextmanager
def counting_gather_layers():
    """Count the MoE layers that take moe_block's decode branch (at most
    GATHER_M_MAX rows of x: the experts gathered, K4 or K8 on quantized
    ones) for the duration, a layer in a captured step once each replay:
    yields a dict whose "calls" grows with each."""
    from ominix_mlx_tpu_torch.models import moe

    from ominix_mlx_tpu_torch.ops import _build

    seen, real, live = {"calls": 0}, moe.moe_block, [True]

    def add():
        # a batcher's graphs outlive the count: their replays after it
        # count nothing
        if live[0]:
            seen["calls"] += 1

    def counted(lp, mcfg, x):
        if x.shape[0] * x.shape[1] <= moe.GATHER_M_MAX:
            _build.on_run(add)      # once each replay where captured
        return real(lp, mcfg, x)
    moe.moe_block = counted
    try:
        yield seen
    finally:
        moe.moe_block = real
        live[0] = False


def serve_moe(dev, cfg, params, phase="serve_moe", name="qwen3-30b-a3b",
              w8=""):
    """Qwen3-30B-A3B w4a8 (or, with w8="_w8", w8a8 group-64): every decode
    token launches K4 twice in each of the 48 MoE layers (gate and up in
    one launch, down in another: 2 x 48 a decode step, and a request of n
    tokens runs n - 1 steps, n + 1 where a stop token ends it), and every
    prefill (16 tokens and
    more, so M > 8) runs K5 on the packed experts exactly three times a
    layer, and dequantize_experts never; attention runs K1 (at the
    experts' width) and K2 as on the dense model."""
    k4_per_token = 2 * cfg.num_layers
    per_layer = 3 * cfg.num_layers
    k4, k5 = "k4" + w8, "k5_w8" if w8 else "k5_w4"
    with counting_dequantize_experts() as deq:
        results, counts = serve_requests(
            dev, cfg, params, name, ("k1_m1" + w8, "k1_mn" + w8, "k2", k4,
                                     k5))
    for req, row in results.items():
        n_out, delta = row["completion_tokens"], row["launches"]
        if not k4_per_token * (n_out - 1) <= delta[k4] \
                <= k4_per_token * (n_out + 1):
            raise RuntimeError(f"request {req}: K4 ran {delta[k4]} times "
                               f"for {n_out} tokens (want 2 a MoE layer "
                               f"and decode step)")
        if delta[k5] != per_layer or delta["k2"] < 1:
            raise RuntimeError(f"request {req}: prefill ran K5 "
                               f"{delta[k5]} times on packed experts (want "
                               f"{per_layer}), K2 {delta['k2']}")
    if counts.get("k5", 0):
        raise RuntimeError(f"{phase}: K5 ran {counts['k5']} times on bf16 "
                           f"experts")
    emit({"phase": phase, "launches": counts,
          "dequantize_experts_calls": deq["calls"], "ok": True})
    if deq["calls"]:
        raise RuntimeError(f"{phase}: dequantize_experts ran {deq['calls']} "
                           f"times on the card")
    return counts


def moe_prefill(dev, cfg, params, T: int = 128, module=None) -> dict:
    """One fresh T-token prefill at batch 1 after a warm-up: its wall ms
    alone, then under torch.profiler its wall ms, device busy ms and top
    device kernels, and the device memory it needs
    (torch.cuda.max_memory_allocated across it, and that peak over what
    was allocated at its start). ``module``: the family's (default
    models.base)."""
    from torch.profiler import ProfilerActivity, profile

    from ominix_mlx_tpu_torch.models import base

    mod = module or base
    prompt = torch.ones(1, T, dtype=torch.long, device=dev)

    def run():
        cache = mod.init_cache(cfg, 1, 1024, device=dev)
        with torch.inference_mode():
            torch.cuda.synchronize()
            start = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            mod.forward(params, cfg, prompt, cache, fresh_prefill=True)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, start

    run()
    wall, _ = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled, start = run()
    peak = torch.cuda.max_memory_allocated()
    busy_us, by_name = device_time(prof)
    return {"tokens": T, "wall_ms": wall * 1e3,
            "profiled_wall_ms": profiled * 1e3,
            "device_busy_ms": busy_us / 1e3,
            "max_memory_allocated_gib": peak / 2 ** 30,
            "prefill_extra_gib": (peak - start) / 2 ** 30,
            "top_device": top_kernels(by_name, busy_us, 8)}


def prefill_seconds(dev, cfg, params, T) -> float:
    """Wall seconds of one fresh T-token prefill at batch 1 (the second of
    two runs), ended by a device synchronize."""
    from ominix_mlx_tpu_torch.models import base

    prompt = torch.arange(1, T + 1, device=dev)[None]
    for _ in range(2):
        cache = base.init_cache(cfg, 1, T + 16, device=dev)
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            base.forward(params, cfg, prompt, cache, fresh_prefill=True)
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    return dt


def serve_moe_batched_w8(dev, cfg, smi):
    """The batched server's w8a8 scheme on Qwen3-30B-A3B. First its
    channel-int8 weights made directly at full width and depth (30 GB)
    on a batched server with 8 slots and a paged pool (quantize_bits=None:
    they are w8a8 already): 8 concurrent chat requests (each adoption the
    exact all-expert int8 pass, then K8 twice a layer at every batch
    decode step (gate and up in one launch, down), K3 for attention), then each greedy request alone, whose
    text must equal its text in the batch; the wall time of one adoption
    prefill of 16 and of 128 tokens beside. Then a bf16 Qwen3-30B-A3B of
    8 layers: the four chat requests on its bf16 experts (K5 bf16 at each
    prefill, ``serve_moe_bf16``), and enable_batching(
    quantize_bits=8) converting it (the
    conversion keeps the bf16 weights, as the JAX package's consume=False
    does, so 48 layers would not fit): 2 concurrent requests on the
    converted weights. Returns the launches of both servers' runs."""
    from ominix_mlx_tpu_torch.models import base, qwen3_moe
    from ominix_mlx_tpu_torch.ops import _build
    from ominix_mlx_tpu_torch.ops.quant_matmul import ChannelQuantizedExperts
    from ominix_mlx_tpu_torch.serving.server import ChatModel, Server

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    params = base.fuse_layer_projections(qwen3_moe.init_quantized_params(
        cfg, gen, device=dev, scheme="channel8"))
    torch.cuda.synchronize()
    emit({"phase": "model", "config": "Qwen3-30B-A3B",
          "weights": "w8a8 channel8", "layers": cfg.num_layers,
          "init_seconds": time.perf_counter() - t0,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    decode_graph(dev, cfg, params, "Qwen3-30B-A3B", "w8a8 channel8", smi)
    adopt = {T: prefill_seconds(dev, cfg, params, T) for T in (16, 128)}
    name = "qwen3-30b-a3b-batched-w8"
    srv = Server(port=free_port())
    srv.add_model(name, ChatModel(name, params, cfg, ByteTokenizer(), dev))
    srv.enable_batching(name, slots=BATCH, max_len=1024, paged=True)
    srv.start_background()
    contents = ("Hi!", "What is 2+2?", "Say hello in French.",
                "Name three colours.", "Count to five.", "Tell me a story.",
                "Pick a number.", "Why is the sky blue?")
    reqs = {f"r{i}": (c, {}) for i, c in enumerate(contents)}
    try:
        _build.reset_launches()
        t0 = time.perf_counter()
        with counting_gather_layers() as gathered:
            together = send_concurrent(srv.port, name, reqs)
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        alone = {}
        for k in reqs:
            alone.update(send_concurrent(srv.port, name, {k: reqs[k]}))
    finally:
        srv.shutdown()
    del params, srv
    free_device_memory()
    same = {k: together[k][0] == alone[k][0] for k in reqs}
    n_tok = sum(r[2] for r in together.values())
    row = {"phase": "serve_moe_batched_w8", "weights": "w8a8 channel8",
           "slots": BATCH, "launches": launches,
           "gather_layers": gathered["calls"], "seconds": wall,
           "completion_tokens": n_tok, "aggregate_tok_s": n_tok / wall,
           "adoption_prefill_seconds": adopt, "equal_alone": same,
           "prompt_tokens": {k: r[1] for k, r in together.items()},
           "text": {k: r[0][:40] for k, r in together.items()}}
    emit(row)
    # K8 twice a decode layer (gate and up, then down), and a decode step
    # for each token the longest request adds
    if launches.get("k8", 0) != 2 * gathered["calls"] \
            or gathered["calls"] < cfg.num_layers * (MAX_TOKENS - 1) \
            or launches.get("k3", 0) < cfg.num_layers * (MAX_TOKENS - 1) \
            or launches.get("k2", 0) < cfg.num_layers:
        raise RuntimeError(f"batched w8 MoE launched {launches} over "
                           f"{gathered['calls']} decode MoE layers")
    if not all(r[2] > 0 and r[0] for r in together.values()) \
            or not all(same.values()):
        raise RuntimeError(f"batched w8 MoE answers differ from solo or are "
                           f"empty: {row}")

    c8 = dataclasses.replace(cfg, num_layers=8)
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    dense = base.init_params(c8, gen, torch.bfloat16, device=dev)
    name = "qwen3-30b-a3b-8l-bf16"
    bf16_counts = serve_moe_bf16(dev, c8, dense, name)
    srv = Server(port=free_port())
    srv.add_model(name, ChatModel(name, dense, c8, ByteTokenizer(), dev))
    t0 = time.perf_counter()
    srv.enable_batching(name, slots=2, max_len=1024, quantize_bits=8)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    srv.start_background()
    try:
        ex = srv.batchers[name].batcher.params["layers"][0]["moe"]["experts"]
        kinds = {type(v).__name__ for v in ex.values()}
        _build.reset_launches()
        with counting_gather_layers() as conv_gathered:
            res = send_concurrent(srv.port, name, {k: reqs[k] for k in (
                "r0", "r1")})
        conv_launches = dict(_build.LAUNCHES)
    finally:
        srv.shutdown()
    del dense, srv
    free_device_memory()
    emit({"phase": "serve_moe_batched_w8_convert", "layers": 8,
          "weights": "bf16 -> enable_batching(quantize_bits=8)",
          "quantize_seconds": t_quant, "expert_types": sorted(kinds),
          "launches": conv_launches,
          "gather_layers": conv_gathered["calls"],
          "completion_tokens": {k: r[2] for k, r in res.items()},
          "text": {k: r[0][:40] for k, r in res.items()}})
    if kinds != {ChannelQuantizedExperts.__name__} \
            or conv_launches.get("k8", 0) != 2 * conv_gathered["calls"] \
            or conv_gathered["calls"] < 8 \
            or not all(r[2] > 0 and r[0] for r in res.values()):
        raise RuntimeError(f"enable_batching(quantize_bits=8) on a MoE model "
                           f"gave {kinds}, launched {conv_launches} over "
                           f"{conv_gathered['calls']} decode MoE layers")
    return {k: launches.get(k, 0) + conv_launches.get(k, 0)
            + bf16_counts.get(k, 0)
            for k in set(launches) | set(conv_launches) | set(bf16_counts)}


def serve_moe_bf16(dev, cfg, params, name):
    """Qwen3-30B-A3B with bf16 experts (a cut of ``cfg.num_layers``
    layers): the four chat requests, each prefill running K5 on the bf16
    experts exactly three times a layer."""
    per_layer = 3 * cfg.num_layers
    results, counts = serve_requests(dev, cfg, params, name, ("k2", "k5"))
    for req, row in results.items():
        if row["launches"]["k5"] != per_layer or row["launches"]["k2"] < 1:
            raise RuntimeError(f"request {req} on bf16 experts launched "
                               f"{row['launches']}")
    emit({"phase": "serve_moe_bf16", "layers": cfg.num_layers,
          "launches": counts, "ok": True})
    return counts


def engine_for(cfg, params, module=None):
    """The Engine a user drives: fresh prefill (K2), continuation chunks
    (K2c) and their logits-free form for non-final chunks, of ``module``
    (default models.base)."""
    from ominix_mlx_tpu_torch.core.generate import Engine
    from ominix_mlx_tpu_torch.core.sampling import SamplerConfig
    from ominix_mlx_tpu_torch.models import base

    mod = module or base
    return Engine(
        lambda p, t, c: mod.forward(p, cfg, t, c), params, SamplerConfig(),
        prefill_forward_fn=lambda p, t, c: mod.forward(
            p, cfg, t, c, fresh_prefill=True),
        chunk_forward_fn=lambda p, t, c, kl: mod.forward(
            p, cfg, t, c, kv_limit=kl),
        chunk_hidden_forward_fn=lambda p, t, c, kl: mod.forward(
            p, cfg, t, c, kv_limit=kl, skip_logits=True))


def prefill_chunked_path(dev, cfg, params, profiled=False):
    """bf16 Qwen3-4B, an 8192-token prompt prefilled in 2048-token chunks
    as bench.py's prefill cell does (chunk 0 through K2, chunks 1-3
    through K2c): launch counts, tok/s (best of 2 after a first run), and
    the last-token logits against a single-shot K2 prefill. profiled=True
    adds a ``profile_prefill`` line: one more chunked prefill under
    torch.profiler (device busy time, idle share, top kernels)."""
    from ominix_mlx_tpu_torch.models import base
    from ominix_mlx_tpu_torch.ops import _build

    eng = engine_for(cfg, params)
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    prompt = torch.randint(0, cfg.vocab_size, (1, PREFILL_LEN), generator=g,
                           device=dev)

    def run(chunked=True):
        cache = base.init_cache(cfg, 1, PREFILL_LEN + 64, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if chunked:
            last, cache = eng.prefill_chunked(prompt, cache,
                                              chunk_size=PREFILL_CHUNK)
        else:
            last, cache = eng.prefill(prompt, cache)
        torch.cuda.synchronize()
        return last.float(), time.perf_counter() - t0, cache.offset

    _build.reset_launches()
    got, t_first, offset = run()
    launches = dict(_build.LAUNCHES)
    n_chunks = PREFILL_LEN // PREFILL_CHUNK
    want_k2 = cfg.num_layers
    want_k2c = cfg.num_layers * (n_chunks - 1)
    if launches.get("k2") != want_k2 or launches.get("k2c") != want_k2c:
        raise RuntimeError(f"chunked prefill launched {launches}, want K2 "
                           f"{want_k2} and K2c {want_k2c}")
    seconds = min(run()[1] for _ in range(2))
    want, t_single, _ = run(chunked=False)
    if got.shape != (1, cfg.vocab_size) or not torch.isfinite(got).all():
        raise RuntimeError(f"bad chunked logits {tuple(got.shape)}")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    row = {"phase": "prefill_chunked", "prompt": PREFILL_LEN,
           "chunk": PREFILL_CHUNK, "offset": offset, "launches": launches,
           "tok_s": PREFILL_LEN / seconds, "seconds": seconds,
           "first_run_seconds": t_first, "single_shot_seconds": t_single,
           "rel_err_vs_single_shot": rel,
           "argmax_equal": int(got.argmax()) == int(want.argmax())}
    emit(row)
    if offset != PREFILL_LEN or not rel < PREFILL_TOL \
            or not row["argmax_equal"]:
        raise RuntimeError(f"chunked vs single-shot prefill: {row}")
    if profiled:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = run()[1]
        busy_us, by_name = device_time(prof)
        emit({"phase": "profile_prefill", "prompt": PREFILL_LEN,
              "chunk": PREFILL_CHUNK, "wall_ms": wall * 1e3,
              "device_busy_ms": busy_us / 1e3,
              "device_idle_share": 1 - busy_us / 1e3 / (wall * 1e3),
              "top_device": top_kernels(by_name, busy_us, 12)})
    return launches


def prefill_kv(layer, T: int):
    """The first T positions of a layer's cache as [B, Hkv, T, D] (K, V):
    a dense cache's slice, or a paged pool gathered through its table."""
    if not hasattr(layer, "k_pool"):
        return layer.k[:, :, :T].clone(), layer.v[:, :, :T].clone()
    pages = -(-T // layer.k_pool.shape[2])
    table = layer.page_table[:, :pages].long()

    def gather(pool):
        B, Hkv, D = table.shape[0], pool.shape[1], pool.shape[3]
        rows = pool[table].permute(0, 2, 1, 3, 4)
        return rows.reshape(B, Hkv, -1, D)[:, :, :T]

    return gather(layer.k_pool), gather(layer.v_pool)


def paged_first_step(dev, cfg, params, prompt):
    """The first decode step after ``prompt``'s prefill, over a dense cache
    (sdpa) and over init_paged_cache (K3). The paged pool must hold, after
    the prefill, the dense cache's K/V bit for bit in every layer (the
    same prefill kernels write both, so a wrong page write shows here,
    which K3's per-call checks on the same pool cannot see). Every K3 call
    of the paged step is held against its plain version on the same inputs
    per (row, head), as check_k3 holds K3 (K3_TOL). Returns the step's
    logits rel error (max |paged - dense| over max |dense|) and the K3
    calls' errors."""
    from ominix_mlx_tpu_torch.models import base
    from ominix_mlx_tpu_torch.ops import paged_attention as pa

    eng = engine_for(cfg, params)
    B, T = prompt.shape
    k3_calls, real_k3 = [], pa._k3

    def checked_k3(q, kp, vp, table, lens, scale, window, ks, vs):
        out = real_k3(q, kp, vp, table, lens, scale, window, ks, vs)
        want = pa.paged_decode_reference(q, kp, vp, table, lens, scale,
                                         window=window, k_scale=ks,
                                         v_scale=vs)
        k3_calls.append(row_rel_err(out, want))
        return out

    def first_step(paged):
        cache = (base.init_paged_cache(cfg, B, 1024, device=dev) if paged
                 else base.init_cache(cfg, B, 1024, device=dev))
        with torch.inference_mode():
            logits, cache = eng.prefill(prompt, cache)
            kv = [prefill_kv(lc, T) for lc in cache.layers]
            tok = logits.argmax(-1, keepdim=True)
            step, _ = base.forward(params, cfg, tok, cache)
        return step[:, -1].float(), kv

    dense, dense_kv = first_step(False)
    pa._k3 = checked_k3
    try:
        paged, paged_kv = first_step(True)
    finally:
        pa._k3 = real_k3
    if dense.shape != (B, cfg.vocab_size) \
            or not torch.isfinite(paged).all():
        raise RuntimeError(f"bad decode logits {tuple(paged.shape)}")
    for i, (d, p) in enumerate(zip(dense_kv, paged_kv)):
        if not (torch.equal(d[0], p[0]) and torch.equal(d[1], p[1])):
            raise RuntimeError(f"layer {i}: the paged pool after the "
                               f"prefill differs from the dense cache")
    if len(k3_calls) != cfg.num_layers or not max(k3_calls) < K3_TOL:
        raise RuntimeError(f"K3 against its plain version on the decode "
                           f"step's inputs: {len(k3_calls)} calls, max "
                           f"{max(k3_calls)} of a (row, head)'s max |plain|")
    rel = ((paged - dense).abs().max() / dense.abs().max()).item()
    return rel, k3_calls


def batch_decode(dev, cfg, params, short=32, long=128, config="Qwen3-4B",
                 logits_tol=PAGED_TOL):
    """w8a8 Qwen3-4B decode at batch 8 after a 128-token prompt, aggregate
    tok/s by bench.py's difference quotient (generate_scan of `long` vs
    `short` tokens, best of 2), over a dense cache and over
    init_paged_cache (K3); then the first decode step, paged vs dense
    (paged_first_step: the pool bit-equal to the dense cache, each K3 call
    against its plain version), its logits held at ``logits_tol``, and how
    many greedy tokens the two runs share."""
    from ominix_mlx_tpu_torch.models import base
    from ominix_mlx_tpu_torch.ops import _build

    eng = engine_for(cfg, params)
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, 128), generator=g,
                           device=dev)

    def run(n, paged):
        cache = (base.init_paged_cache(cfg, BATCH, 1024, device=dev) if paged
                 else base.init_cache(cfg, BATCH, 1024, device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, _ = eng.generate_scan(prompt, cache, max_tokens=n)
        toks = toks.cpu()
        return time.perf_counter() - t0, toks

    out, launches, toks = {}, {}, {}
    for paged in (False, True):
        name = "paged" if paged else "dense"
        _build.reset_launches()
        run(short, paged)
        launches[name] = dict(_build.LAUNCHES)
        t_short = min(run(short, paged)[0] for _ in range(2))
        longs = [run(long, paged) for _ in range(2)]
        t_long = min(t for t, _ in longs)
        toks[name] = longs[0][1]
        out[name] = {"tok_s": BATCH * (long - short) / (t_long - t_short),
                     f"t{short}_s": t_short, f"t{long}_s": t_long}
    if launches["paged"].get("k3", 0) < cfg.num_layers * short:
        raise RuntimeError(f"paged decode launched {launches['paged']}")
    if launches["dense"].get("k3", 0):
        raise RuntimeError("dense decode launched K3")
    rel, k3_calls = paged_first_step(dev, cfg, params, prompt)
    same = int((toks["paged"] == toks["dense"]).sum())
    emit({"phase": "batch_decode", "config": config,
          "weights": "w8a8 channel8", "batch": BATCH,
          "prompt": 128, **{f"{k}_{m}": v for k, d in out.items()
                            for m, v in d.items()},
          "launches": launches, "first_step_rel_err_paged_vs_dense": rel,
          "first_step_limit": logits_tol, "pool_equals_dense_cache": True,
          "k3_calls_checked": len(k3_calls),
          "k3_per_call_max_row_rel_err": max(k3_calls),
          "per_call_limit": K3_TOL,
          "greedy_tokens_equal": same, "greedy_tokens": toks["dense"].numel()})
    if not rel < logits_tol:
        raise RuntimeError(f"paged vs dense decode logits rel {rel}")
    return launches["paged"]


def serve_batched(dev, cfg, params):
    """A batched server (8 slots, paged int8 KV pool, prefix cache, w8a8
    weights quantized from the bf16 ones by enable_batching) answering 8
    concurrent HTTP chat requests: one longer than 2048 tokens (chunked
    adoption: K2 then K2c), two sharing a 300-token system prompt (a
    prefix hit: the suffix through K2c), one streaming, one sampled.

    Pass 1 sends them together and counts launches. Pass 2 sends each
    greedy request alone. Pass 3 sends all together again. Every prompt
    was adopted once in pass 1, so passes 2 and 3 take the same prefix-hit
    path for each request, and each greedy text of pass 3 must equal its
    text alone (rows are independent: the int8 products are exact and K3
    works per row); the sampled text must repeat pass 1's. Pass 1's first
    sight of a prompt attends its unquantized K/V while later passes read
    its prefix from int8 pages, so pass 1 vs pass 2 is reported, not held,
    with one exception: after the prefix cache is emptied, the long
    request alone adopts by chunks (K2, K2c) again, as in pass 1, and its
    pass-1 text must equal that solo text."""
    from ominix_mlx_tpu_torch.ops import _build
    from ominix_mlx_tpu_torch.serving.server import ChatModel, Server

    name = "qwen3-4b-batched"
    srv = Server(port=free_port())
    srv.add_model(name, ChatModel(name, params, cfg, ByteTokenizer(), dev))
    srv.enable_batching(name, slots=BATCH, max_len=4096, paged=True,
                        quantize_bits=8, kv_bits=8, prefix_cache=True)
    srv.start_background()
    port = srv.port
    system = "You are a careful assistant who answers briefly. " * 6
    notes = ("Notes: the kernels stream packed weights once per token, "
             "and the pool holds int8 pages. ") * 30 + "Summarise."
    reqs = {"sys_a": ("Name three colours.", {"system": system}),
            "sys_b": ("Count to five.", {"system": system}),
            "long": (notes, {}),
            "stream": ("Tell me a story.", {"stream": True}),
            "sampled": ("Pick a number.", {"temperature": 0.7, "seed": 1234}),
            "short1": ("Hi!", {}),
            "short2": ("What is 2+2?", {}),
            "short3": ("Say hello in French.", {})}
    greedy = [k for k in reqs if k != "sampled"]

    def send(keys):
        return send_concurrent(port, name, {k: reqs[k] for k in keys})

    try:
        runner = srv.batchers[name]
        _build.reset_launches()
        t0 = time.perf_counter()
        first = send(list(reqs))
        wall1 = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        hits = runner.batcher.prefix.hits
        alone = {}
        for k in greedy:
            alone.update(send([k]))
        t0 = time.perf_counter()
        third = send(list(reqs))
        wall3 = time.perf_counter() - t0
        pfx = runner.batcher.prefix
        with runner.lock:
            pfx.evict(runner.batcher.alloc, max_evict=len(pfx.entries))
            left = len(pfx.entries)
        misses = pfx.misses
        long_fresh = send(["long"])["long"]
        if left or pfx.misses != misses + 1:
            raise RuntimeError(f"the prefix cache kept {left} pages, or the "
                               f"long request hit it")
    finally:
        srv.shutdown()
    for k, (text, n_prompt, n_out, sec) in first.items():
        emit({"phase": "request_batched", "name": k, "prompt_tokens": n_prompt,
              "completion_tokens": n_out, "seconds": sec, "text": text[:60]})
        if n_out <= 0 or not text:
            raise RuntimeError(f"batched request {k}: empty completion")
    same_alone = {k: third[k][0] == alone[k][0] for k in greedy}
    first_vs_alone = {k: first[k][0] == alone[k][0] for k in greedy}
    row = {"phase": "serve_batched", "launches": launches,
           "prefix_hits_pass1": hits,
           "long_prompt_tokens": first["long"][1],
           "pass1_seconds": wall1, "pass3_seconds": wall3,
           "pass1_completion_tokens": sum(r[2] for r in first.values()),
           "greedy_equal_alone": same_alone,
           "pass1_equal_alone": first_vs_alone,
           "long_pass1_equal_fresh_alone": first["long"][0] == long_fresh[0],
           "sampled_repeats": third["sampled"][0] == first["sampled"][0]}
    emit(row)
    if first["long"][1] <= PREFILL_CHUNK or hits < 1:
        raise RuntimeError(f"no chunked adoption or prefix hit: {row}")
    for k in ("k2", "k2c", "k3", "k3_int8"):
        if launches.get(k, 0) < 1:
            raise RuntimeError(f"{k} never launched on the batched path")
    if not all(same_alone.values()) or not row["sampled_repeats"] \
            or not row["long_pass1_equal_fresh_alone"]:
        raise RuntimeError(f"batched answers differ from solo: {row}")
    return launches


def with_act_bits(tree, act_bits):
    """The tree with every group-quantized weight's act_bits replaced (the
    packed data is shared)."""
    from ominix_mlx_tpu_torch.ops.quant_matmul import PackedQuantizedTensor

    if isinstance(tree, PackedQuantizedTensor):
        return dataclasses.replace(tree, act_bits=act_bits)
    if isinstance(tree, dict):
        return {k: with_act_bits(v, act_bits) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(with_act_bits(v, act_bits) for v in tree)
    return tree


def generate_rows(dev, cfg, dense):
    """The generate.py --quantize route: quantize_params at 4 and at 8 bits
    on the bf16 weights with no fusion into panels, so every weight is
    row-major with act_bits=8 (what the JAX package's quantize_params
    gives). Engine.generate, greedy, on a 12-token prompt (bucket 16: K6 at
    16 rows) and a 40-token prompt (bucket 64: K7 for 4-bit; the dense
    route for 8-bit), then 32 tokens each (K6 at one row); the 12-token
    prompt again (the tokens repeat); and the kernel-vs-plain logits on a
    2-layer cut, for w4a8 on a second seed too. Returns the launches of
    the generate runs."""
    from ominix_mlx_tpu_torch.core.generate import Engine
    from ominix_mlx_tpu_torch.core.sampling import SamplerConfig
    from ominix_mlx_tpu_torch.models import base
    from ominix_mlx_tpu_torch.ops import _build

    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    prompts = {T: torch.randint(0, 256, (T,), generator=g, device=dev)
               for T in (12, 40)}
    per_token = 4 * cfg.num_layers + 1
    total = {}
    for bits in (4, 8):
        t0 = time.perf_counter()
        qp = base.quantize_params(dense, GS, bits)
        torch.cuda.synchronize()
        t_quant = time.perf_counter() - t0
        w = qp["layers"][0]["qkv_proj"]["w"]
        if w.panels or w.batched or w.act_bits != 8 or w.bits != bits:
            raise RuntimeError(f"quantize_params gave {w.bits}-bit "
                               f"panels={w.panels} batched={w.batched}")
        eng = Engine(lambda p, t, c: base.forward(p, cfg, t, c), qp,
                     SamplerConfig(),
                     prefill_forward_fn=lambda p, t, c: base.forward(
                         p, cfg, t, c, fresh_prefill=True))

        def gen(prompt):
            cache = base.init_cache(cfg, 1, 256, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = list(eng.generate(prompt, cache, max_tokens=MAX_TOKENS))
            return toks, time.perf_counter() - t0

        rows = {}
        _build.reset_launches()
        for T, prompt in prompts.items():
            before = dict(_build.LAUNCHES)
            toks, sec = gen(prompt)
            rows[T] = {"tokens": len(toks), "seconds": sec, "first": toks[:8],
                       "launches": {k: _build.LAUNCHES[k] - before.get(k, 0)
                                    for k in ("k6", "k7")}}
            rows[T]["all"] = toks
        launches = dict(_build.LAUNCHES)
        again, _ = gen(prompts[12])
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        emit({"phase": "generate_rows", "bits": bits, "weights":
              f"w{bits}a8 g64 row-major", "quantize_seconds": t_quant,
              "launches": launches, "repeat_equal": again == rows[12]["all"],
              **{f"prompt_{T}": {k: v for k, v in r.items() if k != "all"}
                 for T, r in rows.items()}})
        for T, r in rows.items():
            want_k6 = per_token * (MAX_TOKENS - 1) + (per_token if T <= 16
                                                      else 0)
            if r["tokens"] != MAX_TOKENS or r["launches"]["k6"] < want_k6:
                raise RuntimeError(f"{bits}-bit prompt {T}: {r['tokens']} "
                                   f"tokens, launches {r['launches']}")
        if bits == 4 and rows[40]["launches"]["k7"] < 4 * cfg.num_layers:
            raise RuntimeError(f"the 40-token prefill ran K7 "
                               f"{rows[40]['launches']['k7']} times")
        if again != rows[12]["all"]:
            raise RuntimeError(f"{bits}-bit greedy decode does not repeat")
        check_logits(dev, cfg, qp, f"Qwen3-4B w{bits}a8 row-major",
                     kernels=("k2", "k6"), tol=ROWS_A8_LOGITS_TOL)
        # exact copies of the same weights: 4-bit through K7 at 16 rows
        # and the dense route at one; 8-bit through K6's w8a16
        check_logits(dev, cfg, with_act_bits(qp, None),
                     f"Qwen3-4B w{bits}a16 row-major",
                     kernels=("k2", "k7" if bits == 4 else "k6"))
        del qp, eng, w
        free_device_memory()
    # the row-major w4a8 check again on a second seed (the 2 layers it reads)
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    d2 = base.fuse_layer_projections(base.init_params(
        dataclasses.replace(cfg, num_layers=2), gen, torch.bfloat16,
        device=dev))
    check_logits(dev, cfg, base.quantize_params(d2, GS, 4),
                 "Qwen3-4B w4a8 row-major, second seed",
                 kernels=("k2", "k6"), tol=ROWS_A8_LOGITS_TOL)
    del d2
    free_device_memory()
    return total


def serve_batched_w4(dev, cfg, dense):
    """The batched server's 4-bit capacity scheme: enable_batching(
    quantize_bits=4) quantizes the bf16 weights row-major, marked batched,
    act_bits=8, as the JAX package does. Four concurrent chat requests of
    33-64 prompt tokens (each adoption prefill at bucket 64: K7; the 4-slot
    batch decode: K1's dq formula on the batched weights), then each
    alone: every slot decodes every step, so the greedy texts must
    match."""
    from ominix_mlx_tpu_torch.ops import _build
    from ominix_mlx_tpu_torch.serving.server import ChatModel, Server

    name = "qwen3-4b-batched-w4"
    srv = Server(port=free_port())
    srv.add_model(name, ChatModel(name, dense, cfg, ByteTokenizer(), dev))
    srv.enable_batching(name, slots=4, max_len=1024, quantize_bits=4)
    srv.start_background()
    contents = {"colours": "Name the three primary colours, please.",
                "count": "Count from one to ten in English words.",
                "french": "Say good morning and thank you in French.",
                "story": "Tell me a very short story about a cat."}

    def send(keys):
        return send_concurrent(srv.port, name,
                               {k: (contents[k], {}) for k in keys})

    try:
        w = srv.batchers[name].batcher.params["layers"][0]["qkv_proj"]["w"]
        flags = (w.bits, w.batched, w.act_bits, w.panels)
        _build.reset_launches()
        t0 = time.perf_counter()
        together = send(list(contents))
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        alone = {}
        for k in contents:
            alone.update(send([k]))
    finally:
        srv.shutdown()
    same = {k: together[k][0] == alone[k][0] for k in contents}
    row = {"phase": "serve_batched_w4", "weights": "w4 g64 batched, a8",
           "slots": 4, "launches": launches, "seconds": wall,
           "prompt_tokens": {k: r[1] for k, r in together.items()},
           "completion_tokens": sum(r[2] for r in together.values()),
           "equal_alone": same,
           "text": {k: r[0][:40] for k, r in together.items()}}
    emit(row)
    per_token = 4 * cfg.num_layers + 1
    if flags != (4, True, 8, False):
        raise RuntimeError(f"enable_batching(quantize_bits=4) gave (bits, "
                           f"batched, act_bits, panels) = {flags}")
    if not all(32 < r[1] <= 64 and r[2] > 0 and r[0]
               for r in together.values()):
        raise RuntimeError(f"prompts outside bucket 64 or empty: {row}")
    if launches.get("k7", 0) < 4 * 4 * cfg.num_layers \
            or launches.get("k1_mn", 0) < per_token * (MAX_TOKENS - 1):
        raise RuntimeError(f"batched w4 launched {launches}")
    if not all(same.values()):
        raise RuntimeError(f"batched w4 answers differ from solo: {row}")
    return launches


def p_formula_on_kernel_prologue(x, w) -> dict:
    """K6 a8 on x once more (a comparison launch, not counted), with its
    prologue's outputs read back: the rows' int8 codes xq, scales sx and
    bf16 group sums xg. Returns how many of each differ from the plain
    version's own, and the share of outputs where the kernel differs from
    the plain P formula evaluated on the kernel's xq, sx and xg: what is
    left once the prologue's roundings are shared. Against the formula
    evaluated in float64 on the same xq, sx and xg, it counts the outputs
    of the kernel and of that plain evaluation that are not the rounded
    exact value, and it sums |bias term| and |y| over the outputs: where
    the bias term is larger than y, y is a difference of larger terms and
    their float32 rounding reaches y's last bf16 bit more often."""
    from ominix_mlx_tpu_torch.core.quant import over_127
    from ominix_mlx_tpu_torch.ops import _build
    from ominix_mlx_tpu_torch.ops import quant_matmul as qm

    M, K = x.shape
    N, gs = w.data.shape[0], w.group_size
    G = K // gs
    y = torch.empty(M, N, dtype=torch.bfloat16, device=x.device)
    xg = torch.empty(M, G, dtype=torch.float32, device=x.device)
    xq = torch.empty(M, K, dtype=torch.int8, device=x.device)
    sx = torch.empty(M, dtype=torch.float32, device=x.device)
    _build.check(_build.library().ominix_qmm_p(
        x.data_ptr(), None, 0.0, w.data.data_ptr(), w.scales.data_ptr(),
        w.biases.data_ptr(), y.data_ptr(), xq.data_ptr(), xg.data_ptr(),
        sx.data_ptr(), None, M, N, K, gs, w.bits, 1,
        qm.qmm_p_rows_per_warp(M, N),
        torch.cuda.current_stream().cuda_stream), "K6 (prologue witness)")
    c = qm._code_values(w.data, w.bits).reshape(N, G, gs)
    P = torch.einsum("mgk,ngk->mng", xq.float().reshape(M, G, gs), c)
    y_on = (sx[:, None] * (P * w.scales.float()[None]).sum(-1)
            + xg @ w.biases.float().T).to(torch.bfloat16)
    bias64 = xg.double() @ w.biases.double().T
    y64 = (sx.double()[:, None] * (P.double() * w.scales.double()[None]).sum(
        -1) + bias64)
    exact = y64.float().to(torch.bfloat16)
    xf = x.float()
    sx_p = over_127(xf.abs().amax(-1)) + 1e-12
    return {"outputs": y.numel(), "differ_on_kernel_prologue":
            int((y != y_on).sum()),
            "kernel_not_exact": int((y != exact).sum()),
            "plain_not_exact": int((y_on != exact).sum()),
            "sum_abs_bias_term": bias64.abs().sum().item(),
            "sum_abs_y": y64.abs().sum().item(),
            "xg": xg.numel(), "xg_differ": int((xg != xf.reshape(M, G, gs).sum(
                -1).to(torch.bfloat16).float()).sum()),
            "xq_differ": int((xq.float() != torch.round(
                xf / sx_p[:, None])).sum()),
            "sx_differ": int((sx != sx_p).sum())}


def k9_call_checks():
    """Wrappers for swapped_kernels that hold every k9_prep, K9 and
    k9_decode call against its plain version on the same inputs (the
    window and the state copied first): (k9 stats, prep stats, decode
    stats, {kernel: wrap}). A K9 call whose q is the output of the
    prologue call just before it is also held, with that prologue,
    against both plain versions in a row ("with_prep"); each call's form
    is counted. A k9_decode call holds its output within K9_DECODE_ULPS
    (head_ulps), its window bit for bit and its state within K9_TOL."""
    from ominix_mlx_tpu_torch.ops import gated_delta as gd

    k9 = {"calls": 0, "max_rel_err": 0.0, "state_max_rel_err": 0.0,
          "forms": {}, "with_prep_calls": 0, "with_prep_max_rel_err": 0.0,
          "with_prep_state_max_rel_err": 0.0}
    prep = {"calls": 0, "max_rel_err": 0.0, "window_equal": True}
    decode = {"calls": 0, "max_head_ulps": 0.0, "window_equal": True,
              "state_max_rel_err": 0.0}
    last_prep = {}      # the kernel prologue's q -> the plain one's outputs

    def checked_prep(kern, plain):
        def call(qkvz, ba, window, *rest):
            w0 = window.clone()
            got = kern(qkvz, ba, window, *rest)
            want = plain(qkvz, ba, w0, *rest)
            prep["calls"] += 1
            prep["max_rel_err"] = max(prep["max_rel_err"], *(
                row_rel_err(x, y) for x, y in zip(got, want)))
            prep["window_equal"] &= bool(torch.equal(window, w0))
            last_prep.clear()
            last_prep[id(got[0])] = want
            return got
        return call

    def checked_k9(kern, plain):
        def call(q, k, v, g, beta, state):
            s0, s1 = state.clone(), state.clone()
            y = kern(q, k, v, g, beta, state)
            want = plain(q, k, v, g, beta, s0)
            k9["calls"] += 1
            form = gd.k9_plan(q.shape[0], q.shape[1], v.shape[2],
                              q.shape[3], v.shape[3])
            k9["forms"][form] = k9["forms"].get(form, 0) + 1
            k9["max_rel_err"] = max(k9["max_rel_err"], row_rel_err(y, want))
            k9["state_max_rel_err"] = max(k9["state_max_rel_err"],
                                          rel_to(state, s0))
            plain_in = last_prep.pop(id(q), None)
            if plain_in is not None:
                both = plain(*plain_in, s1)
                k9["with_prep_calls"] += 1
                k9["with_prep_max_rel_err"] = max(
                    k9["with_prep_max_rel_err"], row_rel_err(y, both))
                k9["with_prep_state_max_rel_err"] = max(
                    k9["with_prep_state_max_rel_err"], rel_to(state, s1))
            return y
        return call

    def checked_decode(kern, plain):
        def call(qkvz, ba, window, conv_w, A_log, dt_bias, state, *rest,
                 **kw):
            w0, s0 = window.clone(), state.clone()
            y = kern(qkvz, ba, window, conv_w, A_log, dt_bias, state, *rest,
                     **kw)
            want = plain(qkvz, ba, w0, conv_w, A_log, dt_bias, s0, *rest)
            decode["calls"] += 1
            decode["max_head_ulps"] = max(decode["max_head_ulps"],
                                          head_ulps(y, want))
            decode["window_equal"] &= bool(torch.equal(window, w0))
            decode["state_max_rel_err"] = max(decode["state_max_rel_err"],
                                              rel_to(state, s0))
            return y
        return call

    return k9, prep, decode, {"k9": checked_k9, "k9_prep": checked_prep,
                              "k9_decode": checked_decode}


def k9_calls_hold(k9, prep, decode, where, forms=()):
    """Raise unless every K9 call (and each with its prologue) is within
    K9_TOL, every prologue call within K9_PREP_TOL with its window equal,
    each of ``forms`` ran, and k9_decode ran, every call within
    K9_DECODE_ULPS with its window equal and its state within K9_TOL."""
    if not (k9["calls"] and k9["max_rel_err"] < K9_TOL
            and decode["calls"] and decode["window_equal"]
            and decode["max_head_ulps"] <= K9_DECODE_ULPS
            and decode["state_max_rel_err"] < K9_TOL
            and k9["state_max_rel_err"] < K9_TOL
            and k9["with_prep_calls"] == k9["calls"] == prep["calls"]
            and k9["with_prep_max_rel_err"] < K9_TOL
            and k9["with_prep_state_max_rel_err"] < K9_TOL
            and prep["max_rel_err"] < K9_PREP_TOL and prep["window_equal"]
            and all(k9["forms"].get(f) for f in forms)):
        raise RuntimeError(f"{where}: K9, its prologue and k9_decode "
                           f"against their plain versions on the path's "
                           f"inputs: {k9}, {prep}, {decode}")


def k9_per_call_prompt(dev, cfg, params, T=200, layers=4, steps=2):
    """Every k9_prep and K9 call of a T-token prefill (K9's chunked form)
    and every k9_decode call of ``steps`` decode steps on the hybrid cut
    to ``layers`` layers, held against the plain versions on the path's
    own inputs (k9_call_checks, the limits of k9_calls_hold); the other
    kernels run as on the main path."""
    from ominix_mlx_tpu_torch.core.generate import Engine
    from ominix_mlx_tpu_torch.core.sampling import SamplerConfig
    from ominix_mlx_tpu_torch.models import base

    c2 = dataclasses.replace(cfg, num_layers=layers)
    p2 = {**params, "layers": params["layers"][:layers]}
    g = torch.Generator(device=dev).manual_seed(SEED + 42)
    prompt = torch.randint(0, cfg.vocab_size, (1, T), generator=g,
                           device=dev)
    k9, prep, decode, wraps = k9_call_checks()

    def wrap(k, kern, plain):
        return wraps[k](kern, plain) if k in wraps else kern

    eng = Engine(lambda p, t, c: base.forward(p, c2, t, c), p2,
                 SamplerConfig(),
                 prefill_forward_fn=lambda p, t, c: base.forward(
                     p, c2, t, c, fresh_prefill=True))
    cache = base.init_cache(c2, 1, T + steps + 1, device=dev)
    with swapped_kernels(wrap), torch.inference_mode():
        logits, cache = eng.prefill(prompt, cache)
        for t in range(steps):
            logits, cache = base.forward(
                p2, c2, torch.tensor([[t + 1]], device=dev), cache)
    emit({"phase": "k9_per_call_prompt", "layers": layers, "prompt": T,
          "decode_steps": steps, "per_call_k9": k9,
          "per_call_k9_limit": K9_TOL, "per_call_k9_prep": prep,
          "per_call_k9_prep_limit": K9_PREP_TOL, "per_call_k9_decode":
          decode, "per_call_k9_decode_head_ulps": K9_DECODE_ULPS})
    k9_calls_hold(k9, prep, decode, f"{T}-token prompt", forms=("chunked",))


def check_logits(dev, cfg, params, name="Qwen3-4B", kernels=None,
                 tol=LOGITS_TOL, layers=2, module=None):
    """Kernel path vs plain path on a ``layers``-layer cut of the
    full-width model (2; a hybrid's 4 hold its three DeltaNet layers and
    one attention layer):
    an 11-token prefill (bucket 16: K1's dq formula or K6 at 16 rows, K2;
    K5 on the packed experts of a MoE model) then 3 decode steps (K1 or K6
    at one row; K4 on a MoE model). Held: logits finite, of shape
    [4, 1, vocab], max error over max |plain| below ``tol``; and at every
    call of a quantized matmul (K1, K4, K5 packed, K6, K7) in the kernel
    run, the kernel against its
    plain version on the same inputs, per row, below K1_TOL; and the
    "last_group" control below at or above ``tol`` (the limit catches
    it) where a quantized matmul ran (a bf16 model's only kernel is K2).

    Reported beside, to say where a difference comes from and what the
    limit is worth: each kernel alone against the plain path (that kernel
    launched, every other one plain); two controls on the plain path,
    "reversed" (every quantized matmul's plain version on K reversed: the
    same function, each float32 sum in another order, so the drift
    between two sound implementations) and "last_group" (the last group
    of K left out of every quantized matmul: a kernel fault the limit
    must catch); per call the share of outputs where kernel and plain
    differ beside the share where plain on reversed K and plain differ;
    and for K6 at a8 the prologue witness (p_formula_on_kernel_prologue).
    On a MoE model it counts the rows (token, layer) whose set of routed
    experts differs between the kernel and the plain run: a router
    near-tie that one run breaks the other way moves that row's output by
    a whole expert, not by a rounding. Every K9 call of the kernel run
    (a DeltaNet layer's recurrence) is held against its plain version on
    the same inputs and a copy of the same state, outputs and final
    state, below K9_TOL (``per_call_k9``; k9_prep's and k9_decode's calls
    likewise, ``per_call_k9_prep``, ``per_call_k9_decode``: the decode
    mixer's output within K9_DECODE_ULPS); so is every K10 call (below
    K10_TOL) and every K11 call (the scores below K11_SCORE_TOL, the same
    blocks selected, the attend below K11_TOL per row and head:
    ``per_call_k10``, ``per_call_k11``) of MiniCPM-SALA (``module``
    models.minicpm_sala; default models.base)."""
    from ominix_mlx_tpu_torch.core.generate import Engine
    from ominix_mlx_tpu_torch.core.sampling import SamplerConfig
    from ominix_mlx_tpu_torch.models import base, moe

    mod = module or base

    c2 = dataclasses.replace(cfg, num_layers=layers)
    p2 = {**params, "layers": params["layers"][:layers]}
    prompt = torch.tensor(ByteTokenizer(cfg.vocab_size).encode(
        "Hello there"), device=dev)

    routes, route = [], moe.route

    def recording_route(lp, mcfg, x):
        w, idx = route(lp, mcfg, x)
        routes[-1].append(idx.sort(-1).values.cpu())
        return w, idx

    def run():
        routes.append([])
        eng = Engine(lambda p, t, c: mod.forward(p, c2, t, c), p2,
                     SamplerConfig(),
                     prefill_forward_fn=lambda p, t, c: mod.forward(
                         p, c2, t, c, fresh_prefill=True))
        cache = mod.init_cache(c2, 1, 64, device=dev)
        with torch.inference_mode():
            logits, cache = eng.prefill(prompt[None], cache)
            out = [logits]
            for t in (1, 2, 3):
                lg, cache = mod.forward(
                    p2, c2, torch.tensor([[t]], device=dev), cache)
                out.append(lg[:, -1])
        return torch.stack([o.float() for o in out])

    calls = {}
    k9, prep, decode, k9_wraps = k9_call_checks()
    sala, sala_wraps = minicpm_call_checks()
    reverse = control_args("reversed")

    def checked(k, kern, plain):
        if k in k9_wraps:
            return k9_wraps[k](kern, plain)
        if k in sala_wraps:
            return sala_wraps[k](kern, plain)
        if k not in QMM_KERNELS:
            return kern

        def call(*a):
            y = kern(*a)
            want, rev = plain(*a), plain(*reverse(k, a))
            c = calls.setdefault(k, {"calls": 0, "max_rel_err": 0.0,
                                     "differ": 0, "reversed_max_rel_err": 0.0,
                                     "reversed_differ": 0, "outputs": 0})
            c["calls"] += 1
            # K4 on gate and up at once returns a pair
            pair = isinstance(y, tuple)
            for yi, wi, ri in (zip(y, want, rev) if pair
                               else ((y, want, rev),)):
                c["outputs"] += wi.numel()
                for key, v in (("", yi), ("reversed_", ri)):
                    c[key + "max_rel_err"] = max(c[key + "max_rel_err"],
                                                 row_rel_err(v, wi))
                    c[key + "differ"] += int((v != wi).sum())
            if k == "k6" and a[1].act_bits == 8:
                for key, v in p_formula_on_kernel_prologue(*a).items():
                    c.setdefault("prologue", {})
                    c["prologue"][key] = c["prologue"].get(key, 0) + v
            return y
        return call

    hybrid = getattr(cfg, "deltanet", None) is not None
    if kernels is None:
        kernels = ("k1", "k2", "k4", "k5") if cfg.moe is not None \
            else ("k1", "k2")
    moe.route = recording_route
    try:
        with swapped_kernels(checked):
            got = run()
        with plain_kernels():
            want = run()
        alone = {}
        for k in kernels:
            with plain_kernels(keep=(k,)):
                alone[k] = rel_to(run(), want)
        controls = {}
        for c in ("reversed", "last_group"):
            with plain_kernels(args=control_args(c)):
                controls[c] = rel_to(run(), want)
    finally:
        moe.route = route
    if got.shape != (4, 1, cfg.vocab_size) or not torch.isfinite(got).all():
        raise RuntimeError(f"bad logits: {tuple(got.shape)}")
    rel = rel_to(got, want)
    per_call = {k: {"calls": c["calls"], "max_rel_err": c["max_rel_err"],
                    "share_differ": c["differ"] / c["outputs"],
                    "reversed_max_rel_err": c["reversed_max_rel_err"],
                    "reversed_share_differ":
                        c["reversed_differ"] / c["outputs"],
                    **({"prologue": c["prologue"]} if "prologue" in c
                       else {})}
                for k, c in calls.items()}
    emit({"phase": "logits", "config": name, "layers": layers,
          "rel_err": rel,
          "limit": tol, "rel_err_one_kernel": alone,
          "rel_err_control": controls, "per_call": per_call,
          "per_call_limit": K1_TOL,
          **({"per_call_k9": k9, "per_call_k9_limit": K9_TOL,
              "per_call_k9_prep": prep, "per_call_k9_prep_limit":
              K9_PREP_TOL, "per_call_k9_decode": decode,
              "per_call_k9_decode_head_ulps": K9_DECODE_ULPS}
             if hybrid else {}),
          **({"per_call_k10": sala["k10"], "per_call_k11": sala["k11"],
              "per_call_limits": {"k10": K10_TOL,
                                  "k10_decode_row_ulps": K10_DECODE_ULPS,
                                  "k11_select": K11_SCORE_TOL,
                                  "k11_attend": K11_TOL}}
             if module is not None else {}),
          "routed_rows": sum(r.shape[0] for r in routes[0]),
          "routed_rows_differ": sum(int((a != b).any(-1).sum())
                                    for a, b in zip(routes[0], routes[1]))})
    if hybrid:
        k9_calls_hold(k9, prep, decode, name)
    if module is not None:
        minicpm_calls_hold(sala, name)
    if not rel < tol:
        raise RuntimeError(f"{name}: kernel vs plain logits rel {rel}")
    # the planted fault sits in the quantized matmuls: a model without
    # one (a bf16 decoder, K2 its only kernel) has nothing to plant it in
    if calls and not controls["last_group"] >= tol:
        raise RuntimeError(f"{name}: the limit {tol} misses a quantized "
                           f"matmul without its last group (rel "
                           f"{controls['last_group']})")
    for k, c in per_call.items():
        if not c["max_rel_err"] < K1_TOL:
            raise RuntimeError(f"{name}: {k} against its plain version on "
                               f"the path's inputs: rel {c['max_rel_err']}")


def decode_rate(dev, cfg, params, short=128, long=512, module=None):
    """Decode tok/s by the difference quotient of bench.py: prompt 128,
    generate_scan of ``long`` vs ``short`` tokens, best of 2 each.
    ``module``: the family's (default models.base)."""
    from ominix_mlx_tpu_torch.core.generate import Engine
    from ominix_mlx_tpu_torch.core.sampling import SamplerConfig
    from ominix_mlx_tpu_torch.models import base

    mod = module or base
    eng = Engine(lambda p, t, c: mod.forward(p, cfg, t, c), params,
                 SamplerConfig(),
                 prefill_forward_fn=lambda p, t, c: mod.forward(
                     p, cfg, t, c, fresh_prefill=True))
    prompt = torch.ones(1, 128, dtype=torch.long, device=dev)

    def run(n):
        cache = mod.init_cache(cfg, 1, 1024, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, _ = eng.generate_scan(prompt, cache, max_tokens=n)
        toks.cpu()
        return time.perf_counter() - t0

    run(short)
    run(long)
    t_short = min(run(short) for _ in range(2))
    t_long = min(run(long) for _ in range(2))
    tps = (long - short) / (t_long - t_short)
    return {"phase": "decode_rate", "decode_tok_s": tps,
            f"t{short}_s": t_short, f"t{long}_s": t_long,
            "ms_per_token": 1e3 / tps}


def cloned_cache(cache):
    """A copy of every tensor of each layer of a ModelCache (the offset
    kept)."""
    from ominix_mlx_tpu_torch.core.cache import ModelCache

    return ModelCache(layers=[dataclasses.replace(lc, **{
        f.name: getattr(lc, f.name).clone() for f in dataclasses.fields(lc)
        if isinstance(getattr(lc, f.name), torch.Tensor)})
        for lc in cache.layers], offset=cache.offset)


def decode_graph(dev, cfg, params, name, weights, smi, module=None,
                 paged=False, prompt_len=128, max_len=1024,
                 steps=GRAPH_STEPS):
    """decode_graph: the engine's decode step (Engine.decode_step) at batch
    1 after a ``prompt_len``-token prefill, from one prefilled state (the
    cache cloned): ``steps`` + 1 steps of the step's body run eagerly,
    under set_sync_debug_mode("error") (a host sync in the body raises),
    against the captured step (its warm-up, then ``steps`` replays): the
    logits' largest difference (0: the same kernels on the same inputs),
    the tokens equal, the launch counts equal; the capture's ms, the
    graph pool, the host time of a replay; then tok/s of the eager body
    and of the replays, ``steps`` each, in turns (eager, graph, graph,
    eager), each ended by a synchronize."""
    from ominix_mlx_tpu_torch.models import base
    from ominix_mlx_tpu_torch.ops import _build

    mod = module or base
    eng = engine_for(cfg, params, module)
    g = torch.Generator(device=dev).manual_seed(SEED + 60)
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=g,
                           device=dev)
    make = base.init_paged_cache if paged else mod.init_cache
    with torch.inference_mode():
        last, cache = eng.prefill(prompt, make(cfg, 1, max_len, device=dev))
        tok = last.argmax(-1)
        a, b = cloned_cache(cache), cloned_cache(cache)
        del cache, last
        torch.cuda.synchronize()
        _build.reset_launches()
        eager = eng.decode_step(a, tok.clone())
        want = []
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(steps + 1):
                want.append((eager.body().float(), eager.tok.clone()))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        eager_launches = dict(_build.LAUNCHES)
        _build.reset_launches()
        reserved = torch.cuda.memory_reserved()
        step = eng.decode_step(b, tok.clone())
        got, host_s = [], 0.0
        for i in range(steps + 1):
            t0 = time.perf_counter()
            step()
            if i:
                host_s += time.perf_counter() - t0
            got.append((step.logits.to(torch.float32, copy=True),
                        step.tok.clone()))
        torch.cuda.synchronize()
        graph_launches = dict(_build.LAUNCHES)

        def rate(call):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                call()
            torch.cuda.synchronize()
            return steps / (time.perf_counter() - t0)

        turns = {"eager": [], "graph": []}
        for who in ("eager", "graph", "graph", "eager"):
            turns[who].append(rate(eager.body if who == "eager" else step))
        step.close()
    kept = torch.cuda.memory_reserved() - reserved
    diff = max(float((gl - wl).abs().max()) for (wl, _), (gl, _)
               in zip(want, got))
    scale = max(float(wl.abs().max()) for wl, _ in want)
    same_tokens = all(torch.equal(wt, gt) for (_, wt), (_, gt)
                      in zip(want, got))
    row = {"phase": "decode_graph", "config": name, "weights": weights,
           "cache": "paged" if paged else "dense", "prompt": prompt_len,
           "steps": steps + 1, "logits_max_abs_diff": diff,
           "logits_max_abs": scale, "tokens_equal": same_tokens,
           "capture_ms": step.captured.capture_ms[0],
           "graph_pool_mib": step.captured.pool_bytes / 2 ** 20,
           "reserved_kept_after_close_mib": kept / 2 ** 20,
           "host_us_per_replay": host_s * 1e6 / steps,
           "eager_tok_s": turns["eager"], "graph_tok_s": turns["graph"],
           "launches_equal": eager_launches == graph_launches,
           "launches": graph_launches, "card": smi}
    emit(row)
    if not (same_tokens and eager_launches == graph_launches
            and diff <= LOGITS_TOL * scale and graph_launches):
        raise RuntimeError(f"{name}: the captured step against its eager "
                           f"body: {row}, eager launches {eager_launches}")
    return row


# the batcher's captured step and speculative decoding (batcher_graph,
# speculative): steps a timing turn, drafts a round
BATCH_GRAPH_STEPS = 24
SPEC_ND = 4


def graph_batcher(dev, cfg, params, module=None, paged=False,
                  max_len=1024):
    """A continuous batcher at BATCH slots, wired as the server wires one
    (fresh prefill at adoption, K2; chunks, K2c), over a dense cache or a
    paged int8 pool."""
    from ominix_mlx_tpu_torch.models import base
    from ominix_mlx_tpu_torch.serving import batching

    mod = module or base
    kw = dict(prefill_forward_fn=lambda p, t, c: mod.forward(
        p, cfg, t, c, fresh_prefill=True))
    fwd = lambda p, t, c: mod.forward(p, cfg, t, c)
    if paged:
        return batching.PagedContinuousBatcher(
            fwd, params, cfg, slots=BATCH, max_len=max_len, quantize_kv=True,
            device=dev, **kw)
    return batching.ContinuousBatcher(
        fwd, params, cfg, lambda c, b, ml: mod.init_cache(c, b, ml,
                                                          device=dev),
        slots=BATCH, max_len=max_len, **kw)


def eager_bodies(bodies, sync_check=True):
    """Make a CapturedBodies run every body eagerly (under
    set_sync_debug_mode("error") where ``sync_check``: a host sync in a
    body raises)."""
    def run(key, body):
        if not sync_check:
            return body()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return body()
        finally:
            torch.cuda.set_sync_debug_mode(0)

    bodies.run = run


def batcher_graph(dev, cfg, params, name, weights, smi, module=None,
                  paged=False, prompt_len=128, steps=BATCH_GRAPH_STEPS,
                  max_len=1024):
    """batcher_graph: the continuous batcher's decode step at BATCH slots
    (8 requests of ``prompt_len`` + 8 i tokens, adopted at the first
    step), replayed from its captured bodies against the same batcher
    with every body run eagerly under set_sync_debug_mode("error"): over
    ``steps`` greedy steps, then 8 steps with two sampled requests among
    the 8 (the sampled body), the logits' largest difference (0), the
    tokens and the launch counts equal; the captures' ms, the pool's MiB
    and the host time of a replay; then aggregate tok/s (8 tokens a step)
    of the eager and the replayed batcher, ``steps`` steps a turn, in
    turns (eager, graph, graph, eager), each ended by a synchronize.
    Returns the replayed batcher's launches."""
    from ominix_mlx_tpu_torch.core.sampling import SamplerConfig
    from ominix_mlx_tpu_torch.ops import _build

    g = torch.Generator(device=dev).manual_seed(SEED + 70)
    prompts = [torch.randint(0, cfg.vocab_size, (prompt_len + 8 * i,),
                             generator=g, device=dev).tolist()
               for i in range(BATCH)]
    sampled = SamplerConfig(temperature=0.8, top_k=50, top_p=0.95)

    def run(mixed, n):
        """(logits a step, tokens a request, launches) of both batchers,
        and the batchers (the graph's first)."""
        out = []
        for eager in (True, False):
            cb = graph_batcher(dev, cfg, params, module, paged, max_len)
            if eager:
                eager_bodies(cb.bodies)
            for i, p in enumerate(prompts):
                cb.submit(i, p, 6 * steps + 16, seed=SEED + i,
                          sampler=sampled if mixed and i in (2, 5) else None)
            torch.cuda.synchronize()
            _build.reset_launches()
            logits, host = [], []
            with torch.inference_mode():
                for i in range(n):
                    t0 = time.perf_counter()
                    cb.step()
                    if i:
                        host.append(time.perf_counter() - t0)
                    logits.append(cb.logits.to(torch.float32, copy=True))
            torch.cuda.synchronize()
            out.append((logits, [list(r.out) for r in cb.active],
                        dict(_build.LAUNCHES), cb, host))
        return out[1], out[0]

    def held(got, want, what):
        diff = max(float((a - b).abs().max())
                   for a, b in zip(got[0], want[0]))
        row = {"logits_max_abs_diff": diff,
               "logits_max_abs": max(float(b.abs().max()) for b in want[0]),
               "tokens_equal": got[1] == want[1],
               "launches_equal": got[2] == want[2]}
        if diff != 0 or not row["tokens_equal"] or not row["launches_equal"]:
            raise RuntimeError(f"{name} batcher_graph {what}: the replayed "
                               f"step against its eager body: {row}, "
                               f"launches {got[2]} vs {want[2]}")
        return row

    graph, eager = run(False, steps + 1)
    greedy_row = held(graph, eager, "greedy")
    gcb, ecb = graph[3], eager[3]
    step_ms = statistics.median(graph[4]) * 1e3
    eager_bodies(ecb.bodies, sync_check=False)
    # the host time of a replay: the bodies' run call alone
    replay_s, replay = [], gcb.bodies.run

    def timed(key, body):
        t0 = time.perf_counter()
        out = replay(key, body)
        replay_s.append(time.perf_counter() - t0)
        return out

    gcb.bodies.run = timed

    def rate(cb):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            for _ in range(steps):
                cb.step()
        torch.cuda.synchronize()
        return BATCH * steps / (time.perf_counter() - t0)

    turns = {"eager": [], "graph": []}
    for who in ("eager", "graph", "graph", "eager"):
        turns[who].append(rate(ecb if who == "eager" else gcb))
    if any(r is None for r in gcb.active):
        raise RuntimeError(f"{name} batcher_graph: a request ended early")
    host_us = statistics.median(replay_s) * 1e6
    capture_ms = dict(gcb.bodies.capture_ms)
    pool_mib = gcb.bodies.pool_bytes / 2 ** 20
    launches = graph[2]
    gcb.close()
    del graph, eager, gcb, ecb
    free_device_memory()
    mgraph, meager = run(True, 8)
    mixed_row = held(mgraph, meager, "mixed")
    mcb = mgraph[3]
    if set(mcb.bodies.graphs) != {"sampled"} or mcb.sampled_steps != 8:
        raise RuntimeError(f"{name} batcher_graph mixed: bodies "
                           f"{set(mcb.bodies.graphs)}, sampled steps "
                           f"{mcb.sampled_steps}")
    capture_ms.update(mcb.bodies.capture_ms)
    mcb.close()
    del mgraph, meager, mcb
    free_device_memory()
    row = {"phase": "batcher_graph", "config": name, "weights": weights,
           "cache": "paged int8" if paged else "dense", "slots": BATCH,
           "prompt": prompt_len, "steps": steps + 1,
           **{f"greedy_{k}": v for k, v in greedy_row.items()},
           **{f"mixed_{k}": v for k, v in mixed_row.items()},
           "capture_ms": capture_ms, "graph_pool_mib": pool_mib,
           "host_us_per_replay": host_us, "replayed_step_ms": step_ms,
           "eager_tok_s": turns["eager"], "graph_tok_s": turns["graph"],
           "launches": launches, "card": smi}
    emit(row)
    return launches


def spec_engine(cfg, params, module, draft, nd=SPEC_ND, force=False):
    """A SpeculativeEngine on ``module``'s forward of ``cfg`` with ``draft``
    = (forward, params) and both fresh prefills through the module's
    fresh_prefill where it takes one."""
    import inspect

    from ominix_mlx_tpu_torch.core.speculative import SpeculativeEngine

    kw = {}
    if "fresh_prefill" in inspect.signature(module.forward).parameters:
        kw["target_prefill_forward"] = lambda p, t, c: module.forward(
            p, cfg, t, c, fresh_prefill=True)
    return SpeculativeEngine(
        lambda p, t, c: module.forward(p, cfg, t, c), params, draft[0],
        draft[1], num_draft_tokens=nd, force_accept=force, **kw)


def self_draft(cfg, params, module, n):
    """(forward, params, init_cache(batch, max_len)) of the first ``n``
    layers: the server's ``draft_for``."""
    from ominix_mlx_tpu_torch.serving.server import ChatModel, draft_for

    dev = params["norm"].device
    return draft_for(ChatModel("draft", params, cfg, None, dev, module),
                     draft_layers=n)


def replay_rates(dev, cfg, module, eng, se, dinit, prompt, cap, n):
    """Decode tok/s of ``n`` replays, after the capture: of the engine's
    decode step (one token each) and of the speculative round (the target
    offset's advance over the replays: n_accept + 1 tokens each), each
    from a fresh prefill, ended by a synchronize."""
    from ominix_mlx_tpu_torch.core.generate import CapturedBodies

    with torch.inference_mode():
        last, cache = eng.prefill(prompt[None], module.init_cache(
            cfg, 1, cap, device=dev))
        step = eng.decode_step(cache, last.argmax(-1))
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        plain = n / (time.perf_counter() - t0)
        step.close()
        del step, cache
        st, _ = se._start(prompt, module.init_cache(cfg, 1, cap, device=dev),
                          dinit(1, cap))
        bodies = CapturedBodies(dev)
        bodies.run("round", lambda: se.round(st))
        torch.cuda.synchronize()
        off = int(st.t_off[0])
        t0 = time.perf_counter()
        for _ in range(n):
            bodies.run("round", lambda: se.round(st))
        torch.cuda.synchronize()
        spec = (int(st.t_off[0]) - off) / (time.perf_counter() - t0)
        bodies.close()
    return plain, spec


def spec_run(dev, cfg, module, eng, dinit, prompt, n, cap):
    """One SpeculativeEngine.generate_scan of ``n`` tokens from fresh
    caches: (tokens, SpecStats, seconds to the last token read)."""
    from ominix_mlx_tpu_torch.core.speculative import SpecStats

    st = SpecStats()
    tc = module.init_cache(cfg, 1, cap, device=dev)
    dc = dinit(1, cap)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, _ = eng.generate_scan(prompt, tc, dc, max_tokens=n, stats=st)
    return toks, st, time.perf_counter() - t0


def speculative(dev, cfg, params, name, weights, smi, module=None,
                drafts=None, prompt_len=128, long=64, cap=1024, rounds=32,
                exact=False):
    """speculative: SpeculativeEngine at batch 1 after a ``prompt_len``
    prompt, 4 drafts a round, for each draft in ``drafts`` ({label:
    (forward, params, init_cache, force_accept)}): the tokens of a
    ``long``-token generate_scan against plain greedy decoding's (the
    engine's replayed step), reported as the tokens before the first
    difference; the replayed rounds against the same rounds run eagerly
    (under set_sync_debug_mode("error")): tokens, acceptance and launches
    equal, held; where ``exact`` (a model whose products do not depend on
    the rows a call takes), the tokens equal plain greedy's, held;
    acceptance, rounds, the round's capture ms and pool MiB; decode tok/s
    of ``rounds`` replayed rounds after the capture (replay_rates) against
    as many replayed plain decode steps, twice in turns; and each one's
    ``long``-token generate_scan wall (the prefill and the capture
    included). Returns the replayed runs' launches."""
    from ominix_mlx_tpu_torch.core.cache import ModelCache
    from ominix_mlx_tpu_torch.models import base
    from ominix_mlx_tpu_torch.ops import _build

    mod = module or base
    eng = engine_for(cfg, params, module)
    g = torch.Generator(device=dev).manual_seed(SEED + 80)
    prompt = torch.randint(0, cfg.vocab_size, (prompt_len,), generator=g,
                           device=dev)

    def plain(n):
        c = mod.init_cache(cfg, 1, cap, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, _ = eng.generate_scan(prompt, c, max_tokens=n)
        toks = toks[0].tolist()
        return toks, time.perf_counter() - t0

    greedy = plain(long)[0]
    total = {}
    for label, (dfwd, dparams, dinit, force) in drafts.items():
        se = spec_engine(cfg, params, mod, (dfwd, dparams), force=force)
        _build.reset_launches()
        toks, st, _ = spec_run(dev, cfg, mod, se, dinit, prompt, long, cap)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        capture_ms, pool_mib = se.capture_ms, se.pool_bytes / 2 ** 20
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        _build.reset_launches()
        eager_se = spec_engine(cfg, params, mod, (dfwd, dparams),
                               force=force)
        from ominix_mlx_tpu_torch.core import speculative as spec_mod
        real = spec_mod.CapturedBodies

        class Eager(real):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                eager_bodies(self)

        spec_mod.CapturedBodies = Eager
        try:
            etoks, est, _ = spec_run(dev, cfg, mod, eager_se, dinit, prompt,
                                     long, cap)
        finally:
            spec_mod.CapturedBodies = real
        torch.cuda.synchronize()
        eager_launches = dict(_build.LAUNCHES)
        same_eager = (toks == etoks and st == est
                      and launches == eager_launches)
        agree = next((i for i, (a, b) in enumerate(zip(toks, greedy))
                      if a != b), min(len(toks), len(greedy)))
        turns = {"plain": [], "spec": []}
        for _ in range(2):
            p, q = replay_rates(dev, cfg, mod, eng, se, dinit, prompt, cap,
                                rounds)
            turns["plain"].append(p)
            turns["spec"].append(q)
        wall = {"plain": plain(long)[1],
                "spec": spec_run(dev, cfg, mod, se, dinit, prompt, long,
                                 cap)[2]}
        row = {"phase": "speculative", "config": name, "weights": weights,
               "draft": label, "force_accept": force, "nd": SPEC_ND,
               "prompt": prompt_len, "tokens": len(toks), "cache": cap,
               "tokens_equal_greedy": toks == greedy[:len(toks)],
               "tokens_before_first_difference": agree,
               "acceptance": st.acceptance_rate, "rounds": st.rounds,
               "replayed_equal_eager": same_eager,
               "capture_ms": capture_ms, "graph_pool_mib": pool_mib,
               "plain_replay_tok_s": turns["plain"],
               "spec_replay_tok_s": turns["spec"],
               "generate_scan_seconds": wall, "launches": launches,
               "card": smi}
        emit(row)
        if not same_eager or len(toks) != long:
            raise RuntimeError(f"{name} speculative {label}: replayed "
                               f"rounds against eager: {row}, eager "
                               f"{etoks} {est} {eager_launches}")
        if exact and not force and not row["tokens_equal_greedy"]:
            raise RuntimeError(f"{name} speculative {label}: the tokens "
                               f"differ from plain greedy: {row}")
    return total


def serve_speculative_batched(dev, cfg, params, smi, weights="w4a8 g64",
                              drafts=(9,), exact=False):
    """serve_speculative_batched: a batched speculative server (8 slots,
    dense cache, 4 drafts a round) for each self-draft depth in ``drafts``
    (the first n layers; n = num_layers is the target as its own draft,
    every draft accepted), answering 8 concurrent greedy HTTP chat
    requests, each against the same request on the per-request engine
    path of a plain model over the same weights (equal texts and token
    counts: reported, and held where ``exact``, a model whose products do
    not depend on the rows a call takes), and one sampled request, which
    takes the engine path; aggregate completion tok/s, the round's
    capture ms and pool MiB. Returns the speculative runs' launches."""
    from ominix_mlx_tpu_torch.ops import _build
    from ominix_mlx_tpu_torch.serving.server import ChatModel, Server

    srv = Server(port=free_port())
    srv.add_model("plain", ChatModel("plain", params, cfg, ByteTokenizer(),
                                     dev))
    for n in drafts:
        srv.add_model(f"spec{n}", ChatModel(f"spec{n}", params, cfg,
                                            ByteTokenizer(), dev))
    srv.start_background()
    reqs = {f"r{i}": (f"Request {i}: " + "tell me about the sea. " * (i + 1),
                      {}) for i in range(BATCH)}
    total, rows = {}, []
    try:
        plain = send_concurrent(srv.port, "plain", reqs)
        for n in drafts:
            name = f"spec{n}"
            srv.enable_batching(name, slots=BATCH, max_len=1024,
                                draft_layers=n, num_draft_tokens=SPEC_ND)
            runner = srv.batchers[name]
            _build.reset_launches()
            t0 = time.perf_counter()
            got = send_concurrent(srv.port, name, reqs)
            wall = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            sampled = send_concurrent(srv.port, name, {
                "s": ("Pick a number.", {"temperature": 0.7, "seed": 3})})
            n_out = sum(r[2] for r in got.values())
            row = {"phase": "serve_speculative_batched", "config": "Qwen3-4B",
                   "weights": weights, "slots": BATCH, "nd": SPEC_ND,
                   "draft_layers": n, "completion_tokens": n_out,
                   "seconds": wall, "aggregate_tok_s": n_out / wall,
                   "equal_plain_engine": {
                       k: got[k][0] == plain[k][0] and got[k][2] == plain[k][2]
                       for k in reqs},
                   "sampled_completion_tokens": sampled["s"][2],
                   "capture_ms": dict(runner.batcher.bodies.capture_ms),
                   "graph_pool_mib": runner.batcher.bodies.pool_bytes
                   / 2 ** 20,
                   "held": "equal_plain_engine" if exact else "reported",
                   "launches": launches, "card": smi}
            emit(row)
            rows.append(row)
            # the batcher's graphs and pool go before the next one's
            runner.stop()
            del srv.batchers[name]
            free_device_memory()
    finally:
        srv.shutdown()
    for row in rows:
        if row["completion_tokens"] < BATCH \
                or row["sampled_completion_tokens"] < 1 \
                or (exact and not all(row["equal_plain_engine"].values())):
            raise RuntimeError(f"serve_speculative_batched: {row}")
    return total


def moe_batch_decode(dev, cfg, params, short=32, long=96):
    """Qwen3-30B-A3B w4a8 decode at batch 8 over init_paged_cache after a
    128-token prompt (prefill M = 1024: K5 on the packed experts at S =
    8192): each step launches K4
    twice a layer, at 8 rows (gate and up in one launch) and 64 rows
    (down), and K3 at 32 query heads over 4 KV heads. Aggregate tok/s by the difference quotient (generate_scan
    of ``long`` vs ``short`` tokens, best of 2), the launch counts of the
    first run, and the greedy tokens of two runs equal."""
    from ominix_mlx_tpu_torch.models import base
    from ominix_mlx_tpu_torch.ops import _build

    eng = engine_for(cfg, params)
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, 128), generator=g,
                           device=dev)

    def run(n):
        cache = base.init_paged_cache(cfg, BATCH, 512, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, _ = eng.generate_scan(prompt, cache, max_tokens=n)
        toks = toks.cpu()
        return time.perf_counter() - t0, toks

    _build.reset_launches()
    _, first = run(short)
    launches = dict(_build.LAUNCHES)
    t_short = min(run(short)[0] for _ in range(2))
    longs = [run(long) for _ in range(2)]
    t_long = min(t for t, _ in longs)
    k4_per_step, k5_per_prefill = 2 * cfg.num_layers, 3 * cfg.num_layers
    row = {"phase": "moe_batch_decode", "weights": "w4a8 g64",
           "batch": BATCH, "prompt": 128, "launches": launches,
           "tok_s": BATCH * (long - short) / (t_long - t_short),
           f"t{short}_s": t_short, f"t{long}_s": t_long,
           "greedy_repeatable": bool(torch.equal(longs[0][1], longs[1][1])
                                     and torch.equal(first,
                                                     longs[0][1][:, :short]))}
    emit(row)
    if not k4_per_step * (short - 1) <= launches.get("k4", 0) \
            <= k4_per_step * short \
            or launches.get("k3", 0) < cfg.num_layers * (short - 1) \
            or launches.get("k5_w4", 0) < k5_per_prefill:
        raise RuntimeError(f"batch-8 MoE decode launched {launches}")
    if first.shape != (BATCH, short) or not row["greedy_repeatable"]:
        raise RuntimeError(f"batch-8 MoE decode: {row}")
    return launches


def device_time(prof):
    """(busy us, {kernel name: (calls, us)}) of a torch.profiler window:
    busy is the union of the intervals of every kernel, copy and fill."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        raise RuntimeError("the profiler saw no device activity")
    busy_us, end = 0.0, float("-inf")
    by_name: dict = {}
    for t0, t1, name in spans:
        busy_us += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + t1 - t0)
    return busy_us, by_name


# kernel-name pieces of the port's kernels whose share of a profiled step
# --profile reports: the P formula's rows kernel, the activation
# prologues (K1, K4 and K6's qmm_prep_pdl, K8's chan_prep), K4's and K8's
# rows kernels, K3 with its merge, K9, k9_prep, k9_decode, K10 (with its
# decode mixer), K11
SHARE_OF = {"qmm_p": ("qmm_p<",), "qmm_prep": ("qmm_prep", "chan_prep"),
            "k4_k8": ("gather_qmm_a8<", "chan_gather_qmm<"),
            "k3": ("paged_decode<", "paged_merge("),
            "k9": ("gated_delta_k9<",),
            "k9_chunk": ("gated_delta_chunk<", "gated_delta_chunk_scan<"),
            "k9_prep": ("k9_prep_kernel<",),
            "k9_decode": ("k9_decode_kernel<",),
            "k10": ("lightning_k10<", "lightning_decode("),
            "k10_chunk": ("lightning_chunk_",),
            "k11": ("sparse_score<", "sparse_select<", "sparse_attend<")}


def kernel_shares(by_name, busy_us) -> dict:
    """{label: {calls, ms, share_of_busy}} of each SHARE_OF group."""
    out = {}
    for label, pieces in SHARE_OF.items():
        hit = [(c, us) for name, (c, us) in by_name.items()
               if any(p in name for p in pieces)]
        us = sum(u for _, u in hit)
        out[label] = {"calls": sum(c for c, _ in hit), "ms": us / 1e3,
                      "share_of_busy": us / busy_us}
    return out


def top_kernels(by_name, busy_us, n):
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:n]
    return [{"name": name[:90], "calls": c, "ms": us / 1e3,
             "share_of_busy": us / busy_us} for name, (c, us) in top]


def package_probe(root: str, what: str) -> dict:
    """Of the package under ``root`` (this checkout's or a parent's: the
    caller put ``root`` first on sys.path), with the smoke's random
    weights at full width and depth: ``moe_prefill`` (``what`` "prefill")
    on Qwen3-30B-A3B w4a8, or ("decode") the generate_scan decode rate
    (``decode_rate``, 16 and 48 tokens after a 128-token prompt) of
    Qwen3-4B w4a8 and of MiniCPM-SALA w8a8 g64: the parent's engine runs
    its loop eagerly, this one replays its captured step."""
    import ominix_mlx_tpu_torch
    from ominix_mlx_tpu_torch.core import generate
    from ominix_mlx_tpu_torch.models import base, minicpm_sala, qwen3_moe

    pkg = os.path.dirname(os.path.abspath(ominix_mlx_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if what == "decode":
        row = {"phase": "decode_probe", "package": pkg,
               "captured": hasattr(generate, "DecodeStep")}
        cfg = qwen3_4b()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = base.fuse_layer_projections(base.init_quantized_params(
            cfg, gen, GS, 4, act_bits=8, device=dev))
        row["qwen3_4b_tok_s"] = decode_rate(dev, cfg, params, 16,
                                            48)["decode_tok_s"]
        del params
        free_device_memory()
        cfg = minicpm_sala.MiniCPMConfig.from_hf(MINICPM_SALA_HF)
        gen = torch.Generator(device=dev).manual_seed(SEED + 51)
        params = base.fuse_layer_projections(
            minicpm_sala.init_quantized_params(cfg, gen, GS, 8, 8,
                                               device=dev))
        row["minicpm_sala_tok_s"] = decode_rate(
            dev, cfg, params, 16, 48, module=minicpm_sala)["decode_tok_s"]
        return row
    cfg = qwen3_30b_a3b()
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    params = base.fuse_layer_projections(qwen3_moe.init_quantized_params(
        cfg, gen, GS, 4, act_bits=8, device=dev))
    return {"phase": "prefill_probe", "package": pkg,
            **moe_prefill(dev, cfg, params)}


def compare_probes(parent: str, here: str, what: str, keys: tuple):
    """``package_probe(what)`` of the parent's package against this one's,
    each in a process of its own (``--prefill-probe`` or
    ``--decode-probe``), in turns: parent, this, this, parent. One
    ``moe_prefill_vs_parent`` or ``decode_vs_parent`` line with ``keys``
    of each run (and for the prefill the first runs' leading
    kernels)."""
    runs = {}
    for who, root in (("parent", parent), ("this", here), ("this", here),
                      ("parent", parent)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            f"--{what}-probe", root], capture_output=True,
                           text=True, timeout=900)
        if r.returncode != 0:
            raise RuntimeError(f"{what} probe of {root} failed "
                               f"({r.returncode}):\n{r.stderr[-3000:]}")
        runs.setdefault(who, []).append(
            json.loads(r.stdout.strip().splitlines()[-1]))
    emit({"phase": "moe_prefill_vs_parent" if what == "prefill"
          else "decode_vs_parent", **{
        f"{who}_{key}": [run[key] for run in rs]
        for who, rs in runs.items() for key in keys},
        **{f"{who}_{key}": runs[who][0][key] for who in runs
           for key in ("top_device", "kernel_shares")
           if key in runs[who][0]}})


def profile_decode(dev, cfg, params, steps: int = 32, batch: int = 1,
                   paged: bool = False, module=None):
    """Where a decode step's time goes: replays of the engine's captured
    decode step (Engine.decode_step, greedy, captured after its warm-up
    step outside the probes) of ``batch`` rows (over a dense or a paged
    cache) after a 128-token prompt, first under torch.profiler (device
    side), then under cProfile (host side).
    Each probe covers the decode steps alone; the prompt's prefill is
    profiled as a window of its own, with torch.cuda.max_memory_allocated
    across it. The device's busy time is the union of the intervals
    of every kernel, copy and fill it ran (``device_ops_per_step``: how
    many a step); the idle share is one minus busy over the window's wall
    time on the host clock. ``module``: the family's (default
    models.base)."""
    from torch.profiler import ProfilerActivity, profile

    from ominix_mlx_tpu_torch.models import base

    mod = module or base

    def probe():
        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    def decode(n, prefill_probe=contextlib.nullcontext,
               steps_probe=contextlib.nullcontext):
        cache = (base.init_paged_cache if paged else mod.init_cache)(
            cfg, batch, 1024, device=dev)
        prompt = torch.ones(batch, 128, dtype=torch.long, device=dev)
        with torch.inference_mode():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mem[:] = [torch.cuda.memory_allocated()]
            with prefill_probe():
                t0 = time.perf_counter()
                _, cache = mod.forward(params, cfg, prompt, cache,
                                       fresh_prefill=True)
                torch.cuda.synchronize()
                prefill_s = time.perf_counter() - t0
            mem.append(torch.cuda.max_memory_allocated())
            tok = torch.ones(batch, dtype=torch.long, device=dev)
            step = eng.decode_step(cache, tok)
            step()                      # the warm-up and the capture
            torch.cuda.synchronize()
            capture_ms[:] = [step.captured.capture_ms[0],
                             step.captured.pool_bytes / 2 ** 20]
            with steps_probe():
                t0 = time.perf_counter()
                for _ in range(n):
                    step()
                step.tok.cpu()
                wall = time.perf_counter() - t0
            step.close()
            return prefill_s, wall

    mem = []        # allocated at the prefill's start, the peak across it
    capture_ms = []     # the capture's ms and the graph pool's MiB
    eng = engine_for(cfg, params, module)
    decode(4)
    pre_prof, prof = probe(), probe()
    prefill_s, wall = decode(steps, lambda: pre_prof, lambda: prof)
    prefill_mem = list(mem)
    busy_us, by_name = device_time(prof)
    pre_busy_us, pre_by_name = device_time(pre_prof)
    cprof = cProfile.Profile()
    _, host_wall = decode(2 * steps, steps_probe=lambda: cprof)
    st = pstats.Stats(cprof).stats
    host = sorted(st.items(), key=lambda kv: -kv[1][2])[:12]
    return {"phase": "profile", "batch": batch, "paged": paged,
            "decode_steps": steps, "replayed": True,
            "capture_ms": capture_ms[0], "graph_pool_mib": capture_ms[1],
            "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "device_sum_ms": sum(us for _, us in by_name.values()) / 1e3,
            "device_idle_share": 1 - busy_us / 1e3 / (wall * 1e3),
            "device_ms_per_step": busy_us / 1e3 / steps,
            "device_ops_per_step": sum(c for c, _ in by_name.values())
            / steps,
            "top_device": top_kernels(by_name, busy_us, 12),
            "kernel_shares": kernel_shares(by_name, busy_us),
            "prefill_tokens": 128 * batch, "prefill_wall_ms": prefill_s * 1e3,
            "prefill_device_busy_ms": pre_busy_us / 1e3,
            "prefill_max_memory_allocated_gib": prefill_mem[1] / 2 ** 30,
            "prefill_extra_gib": (prefill_mem[1] - prefill_mem[0]) / 2 ** 30,
            "prefill_top_device": top_kernels(pre_by_name, pre_busy_us, 8),
            "host_cprofile_steps": 2 * steps,
            "host_cprofile_s": host_wall,
            "top_host_self": [{"fn": f"{os.path.basename(f)}:{ln}({fn})",
                               "calls": v[1], "self_s": v[2],
                               "cum_s": v[3]}
                              for (f, ln, fn), v in host]}


def profile_prefill16(dev, cfg, params, T: int = 16):
    """One fresh T-token prefill at batch 1 (the chat bucket: every
    projection and the lm_head take the dq formula at 16 rows on panels)
    under torch.profiler, after a warm-up: device busy time and the dq
    kernel's share of it (its main and reduce kernels)."""
    from torch.profiler import ProfilerActivity, profile

    from ominix_mlx_tpu_torch.models import base

    def run():
        cache = base.init_cache(cfg, 1, 1024, device=dev)
        prompt = torch.ones(1, T, dtype=torch.long, device=dev)
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            base.forward(params, cfg, prompt, cache, fresh_prefill=True)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run()
    busy_us, by_name = device_time(prof)
    dq = [(c, us) for name, (c, us) in by_name.items() if "qmm_dq" in name]
    return {"phase": "profile_prefill16", "tokens": T,
            "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "dq_launches": sum(c for c, _ in dq),
            "dq_ms": sum(us for _, us in dq) / 1e3,
            "dq_share_of_busy": sum(us for _, us in dq) / busy_us,
            "top_device": top_kernels(by_name, busy_us, 8)}


# ------------------------------------------------- sliding window (K2) -----

def window_pairs(q_pos0: int, T: int, window: int) -> int:
    """Visible (query, key) pairs of T queries at positions q_pos0..: query
    p sees min(p + 1, window) keys (all p + 1 without a window)."""
    p = torch.arange(q_pos0, q_pos0 + T, dtype=torch.float64) + 1
    if window:
        p = p.clamp(max=window)
    return int(p.sum().item())


def window_mask(q_pos0: int, T: int, S: int, window: int, dev):
    """[T, S] bool of visible keys (the plain versions' rule) for sdpa."""
    from ominix_mlx_tpu_torch.ops import flash_attention as fa
    return fa.visible(q_pos0 + torch.arange(T, device=dev),
                      torch.arange(S, device=dev), window)


def check_k2_window(dev, flush):
    """K2 with Mistral's sliding window at T=8192, windows 4096 and 4000
    (not a multiple of the 128-key tile), at 32 query heads over 8 KV heads
    (Mistral-7B) and over 2 (GLM-4-9B's grouping), D=128, against the
    plain version; bound: the windowed pairs' FLOPs over the bf16 peak;
    library: sdpa with the boolean window mask."""
    from ominix_mlx_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    rows = []
    T, H, D = K2W_T, 32, 128
    scale = D ** -0.5
    for Hkv in (8, 2):
        q = torch.randn(1, H, T, D, generator=g, device=dev).bfloat16()
        k = torch.randn(1, Hkv, T, D, generator=g, device=dev).bfloat16()
        v = torch.randn(1, Hkv, T, D, generator=g, device=dev).bfloat16()
        for window in K2W_WINDOWS:
            out, lse = fa._k2(q, k, v, scale, window)
            want, want_lse = fa.flash_prefill_reference(q, k, v, scale,
                                                        window)
            torch.cuda.synchronize()
            if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
                raise RuntimeError(f"K2 window={window}: non-finite")
            d = (out.float() - want.float()).abs().max().item()
            rel = d / max(want.float().abs().max().item(), 1e-12)
            dl = (lse - want_lse).abs().max().item()
            del want, want_lse
            ms = time_ms(lambda: fa._k2(q, k, v, scale, window), 10, flush)
            plain = time_ms(lambda: fa.flash_prefill_reference(
                q, k, v, scale, window), 2, flush)
            mask = window_mask(0, T, T, window, dev)
            lib, lib_err = time_library(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale, enable_gqa=True),
                10, flush)
            del mask
            flop = 4 * H * D * window_pairs(0, T, window)
            row = {"T": T, "H": H, "Hkv": Hkv, "D": D, "window": window,
                   "max_abs_err": d, "rel_err": rel, "lse_max_abs_err": dl,
                   "ms": ms, "plain_ms": plain, "library_ms": lib,
                   "library": "F.scaled_dot_product_attention(attn_mask="
                              "window, enable_gqa=True)",
                   "library_error": lib_err, "TFLOPs": flop / ms / 1e9,
                   **bound(2 * D * T * (2 * H + 2 * Hkv) + 4 * H * T, flop,
                           "bf16")}
            row.update(versus(row))
            emit({"phase": "k2_window", **row})
            if not (rel < K2_TOL and dl < K2_LSE_TOL):
                raise RuntimeError(f"K2 window={window} Hkv={Hkv}: rel "
                                   f"error {rel}, lse {dl}")
            rows.append(row)
            torch.cuda.empty_cache()
        del q, k, v
    return rows


def check_k2c_window(dev, flush):
    """K2c with the window: the 8k prefill's last chunk (pos=6144,
    Tq=2048) over the strided prefix of a capacity-sized cache, windows
    4096 and 4000, Hkv 8 and 2, against the plain version. The kernel
    reads no key tile below the first one a chunk row sees (keys from
    pos - window + 1 on)."""
    from ominix_mlx_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    rows = []
    pos, T = K2CW_POS_T
    H, D = 32, 128
    scale = D ** -0.5
    cap = PREFILL_LEN + 64
    for Hkv in (8, 2):
        kc = torch.randn(1, Hkv, cap, D, generator=g, device=dev).bfloat16()
        vc = torch.randn(1, Hkv, cap, D, generator=g, device=dev).bfloat16()
        q = torch.randn(1, H, T, D, generator=g, device=dev).bfloat16()
        k, v = kc[:, :, :pos + T], vc[:, :, :pos + T]
        for window in K2W_WINDOWS:
            out, lse = fa._k2c(q, k, v, pos, scale, window)
            want, want_lse = fa.flash_chunk_reference(q, k, v, pos, scale,
                                                      window)
            torch.cuda.synchronize()
            if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
                raise RuntimeError(f"K2c window={window}: non-finite")
            d = (out.float() - want.float()).abs().max().item()
            rel = d / max(want.float().abs().max().item(), 1e-12)
            dl = (lse - want_lse).abs().max().item()
            del want, want_lse
            ms = time_ms(lambda: fa._k2c(q, k, v, pos, scale, window), 10,
                         flush)
            plain = time_ms(lambda: fa.flash_chunk_reference(
                q, k, v, pos, scale, window), 3, flush)
            mask = window_mask(pos, T, pos + T, window, dev)
            lib, lib_err = time_library(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale, enable_gqa=True),
                10, flush)
            del mask
            flop = 4 * H * D * window_pairs(pos, T, window)
            keys = pos + T - max(0, pos - window + 1)   # keys any row sees
            row = {"pos": pos, "T": T, "H": H, "Hkv": Hkv, "D": D,
                   "window": window, "max_abs_err": d, "rel_err": rel,
                   "lse_max_abs_err": dl, "ms": ms, "plain_ms": plain,
                   "library_ms": lib,
                   "library": "F.scaled_dot_product_attention(attn_mask="
                              "shifted window, enable_gqa=True)",
                   "library_error": lib_err, "TFLOPs": flop / ms / 1e9,
                   **bound(2 * D * (2 * H * T + 2 * Hkv * keys) + 4 * H * T,
                           flop, "bf16")}
            row.update(versus(row))
            emit({"phase": "k2c_window", **row})
            if not (rel < K2_TOL and dl < K2_LSE_TOL):
                raise RuntimeError(f"K2c window={window} Hkv={Hkv}: rel "
                                   f"error {rel}, lse {dl}")
            rows.append(row)
            torch.cuda.empty_cache()
        del kc, vc, q, k, v
    return rows


# -------------------------------------------------- Mistral and GLM-4 ------

def mistral_7b_instruct_v02():
    """Mistral-7B-Instruct-v0.2 (HF config.json; bench.py:49-52): no
    sliding window, rope_theta 1e6, rms_norm_eps 1e-5."""
    from ominix_mlx_tpu_torch.models import mistral
    return mistral.config_from_hf(dict(MISTRAL_7B_HF, rope_theta=1e6,
                                       sliding_window=None))


def mistral_7b_v01():
    """Mistral-7B-v0.1 (HF config.json of mistralai/Mistral-7B-v0.1):
    sliding_window 4096, rope_theta 1e4."""
    from ominix_mlx_tpu_torch.models import mistral
    return mistral.config_from_hf(dict(MISTRAL_7B_HF, rope_theta=10000.0,
                                       sliding_window=4096))


def glm4_9b():
    """GLM-4-9B-0414 (HF config.json; bench.py:55-59): 2 KV heads, partial
    interleaved RoPE over half of each head, q/k/v biases, sandwich norms,
    rms_norm_eps 1e-5."""
    from ominix_mlx_tpu_torch.models import glm4
    return glm4.config_from_hf(GLM4_9B_HF)


def glm4_layer_extras(params, cfg, g, dev):
    """Give a GLM-4 tree made by init_*params what a checkpoint brings
    through glm4.params_from_flat: unit sandwich norms and q/k/v biases
    (random, so the fused biases are exercised)."""
    for lp in params["layers"]:
        for n in ("post_self_attn_layernorm", "post_mlp_layernorm"):
            lp[n] = torch.ones(cfg.hidden_size, dtype=torch.bfloat16,
                               device=dev)
        for n in ("q_proj", "k_proj", "v_proj"):
            rows = (cfg.num_heads if n == "q_proj"
                    else cfg.num_kv_heads) * cfg.hd
            lp[n]["b"] = (torch.randn(rows, generator=g, device=dev)
                          * 0.1).bfloat16()
    return params


def serve_family(dev, smi, cfg, name, family, seed, panel_projections,
                 profile=False, rate_tokens=(16, 48)):
    """A full-width, full-depth w4a8 g64 model from init_quantized_params
    plus fuse_layer_projections: 4 HTTP chat requests one at a time (K1,
    the dq kernel, K2), the kernel-vs-plain logits check on a 2-layer cut,
    the batch-1 decode rate (and with ``profile`` a profile line of batch-1
    decode steps). Returns the launches, the params and the rate."""
    from ominix_mlx_tpu_torch.models import base

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = base.init_quantized_params(cfg, gen, GS, 4, act_bits=8,
                                        device=dev)
    if family.__name__.endswith("glm4"):
        params = glm4_layer_extras(params, cfg, gen, dev)
    params = base.fuse_layer_projections(params)
    torch.cuda.synchronize()
    emit({"phase": "model", "config": name, "weights": "w4a8 g64",
          "layers": cfg.num_layers,
          "init_seconds": time.perf_counter() - t0,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    counts = serve_main_path(dev, cfg, params, "serve_" + name.lower(),
                             name.lower(), panel_projections=panel_projections,
                             module=family)
    check_logits(dev, cfg, params, name)
    rate = decode_rate(dev, cfg, params, *rate_tokens)
    emit({**rate, "config": name, "weights": "w4a8 g64", "card": smi})
    decode_graph(dev, cfg, params, name, "w4a8 g64", smi, family)
    if profile:
        emit({**profile_decode(dev, cfg, params), "config": name,
              "weights": "w4a8 g64", "card": smi})
    return counts, params, rate


def dense_route_share(dev, cfg, params, rate, smi):
    """GLM-4-9B's down_proj (K = 13696: K/2 is not a multiple of 128, so
    neither panels nor the row-major kernels take it, as on the TPU)
    takes route "dense": the whole weight dequantized, then cuBLAS, each
    call. Its time at one row, and its share of the decode step (one a
    layer)."""
    from ominix_mlx_tpu_torch.ops import quant_matmul as qm

    w = params["layers"][0]["down_proj"]["w"]
    if qm.route(w, 1) != "dense":
        raise RuntimeError(f"GLM-4 down_proj takes {qm.route(w, 1)!r}")
    buf = torch.zeros(256 << 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    x = torch.randn(1, w.in_features, generator=g, device=dev).bfloat16()
    ms = time_ms(lambda: qm.quantized_matmul(x, w), 10, l2_flush(buf))
    step_ms = rate["ms_per_token"]
    emit({"phase": "glm4_dense_down_proj", "N": w.data.shape[0],
          "K": w.in_features, "route": "dense", "ms": ms,
          "calls_per_token": cfg.num_layers, "decode_ms_per_token": step_ms,
          "share_of_decode_step": cfg.num_layers * ms / step_ms,
          "card": smi})


def serve_mistral(dev, smi, profile=False):
    """serve_mistral: Mistral-7B-Instruct-v0.2 w4a8 at full width and
    depth through the Mistral module."""
    from ominix_mlx_tpu_torch.models import mistral

    counts, params, _ = serve_family(dev, smi, mistral_7b_instruct_v02(),
                                     "Mistral-7B", mistral, SEED + 24, 4,
                                     profile)
    del params
    free_device_memory()
    return counts


def serve_glm4(dev, smi, profile=False):
    """serve_glm4: GLM-4-9B-0414 w4a8 at full width and depth (sandwich
    norms, q/k/v biases fused into qkv_proj, down_proj on the dense
    route), the dense route's share of the step; then channel w8a8 at
    batch 8 over a dense and a paged cache (K3 at 16 query heads a KV
    head), and glm4_paged_witness."""
    from ominix_mlx_tpu_torch.models import base, glm4

    cfg = glm4_9b()
    counts, params, rate = serve_family(dev, smi, cfg, "GLM-4-9B", glm4,
                                        SEED + 25, 3, profile, (8, 24))
    dense_route_share(dev, cfg, params, rate, smi)
    del params
    free_device_memory()
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    params = base.fuse_layer_projections(glm4_layer_extras(
        base.init_quantized_params(cfg, gen, device=dev, scheme="channel8"),
        cfg, gen, dev))
    paged = batch_decode(dev, cfg, params, 8, 24, config="GLM-4-9B",
                         logits_tol=ROWS_A8_LOGITS_TOL)
    del params
    free_device_memory()
    glm4_paged_witness(dev, cfg, smi)
    return {k: counts.get(k, 0) + paged.get(k, 0)
            for k in set(counts) | set(paged)}


def glm4_paged_witness(dev, cfg, smi):
    """GLM-4-9B's paged vs dense first decode step (paged_first_step) on
    other weights than batch_decode's: a bf16 tree (no int8 activations)
    held at PAGED_TOL, then its channel w8a8 copy (quantize_params) held
    at ROWS_A8_LOGITS_TOL, as batch_decode holds GLM-4-9B. The two read
    the same weights, so the gap between them is what per-token int8
    activations add to K3's rounding through 40 layers."""
    from ominix_mlx_tpu_torch.models import base

    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    bf16 = glm4_layer_extras(base.init_params(cfg, gen, torch.bfloat16,
                                              device=dev), cfg, gen, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, 128), generator=g,
                           device=dev)
    row = {"phase": "glm4_paged_witness", "config": "GLM-4-9B",
           "batch": BATCH, "prompt": 128}
    for weights, limit in (("bf16", PAGED_TOL),
                           ("w8a8 channel8", ROWS_A8_LOGITS_TOL)):
        params = bf16 if weights == "bf16" else base.fuse_layer_projections(
            base.quantize_params(bf16, scheme="channel8"))
        rel, k3_calls = paged_first_step(dev, cfg, params, prompt)
        row[weights] = {"first_step_rel_err_paged_vs_dense": rel,
                        "limit": limit,
                        "k3_per_call_max_row_rel_err": max(k3_calls)}
        if not rel < limit:
            emit({**row, "card": smi})
            raise RuntimeError(f"GLM-4-9B {weights}: paged vs dense decode "
                               f"logits rel {rel}")
    emit({**row, "pool_equals_dense_cache": True, "card": smi})
    del bf16, params
    free_device_memory()


def prefill_window(dev, smi):
    """prefill_window: bf16 Mistral-7B-v0.1 (sliding window 4096) at full
    width and depth, an 8192-token prompt in 2048-token chunks: chunk 0
    through K2 and chunks 1-3 through K2c, each with the window. The last
    token's logits held against a single-shot prefill through K2 with
    prefill_chunked's limit (PREFILL_TOL; K2c walks a row's key tiles in
    K2's order, so it reads 0.0), and against a single-shot prefill
    through the plain versions (the attention's plain version with the
    window) at LOGITS_TOL, the limit of K2 against its plain version (K2
    rounds its softmax weights to bf16, as the TPU kernel does; through 32
    layers that reads 1.09e-2 on the H100, above PREFILL_TOL), the argmax
    equal in both; the control "no window" (the plain single shot with the window
    left out) must read at least LOGITS_TOL (0.49 on the H100). Then 3
    decode steps on a paged cache after the chunked prefill (K3 with the window) against the same steps on the
    dense cache (the masked sdpa)."""
    from ominix_mlx_tpu_torch.models import base
    from ominix_mlx_tpu_torch.ops import _build

    cfg = mistral_7b_v01()
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    params = base.fuse_layer_projections(base.init_params(
        cfg, gen, torch.bfloat16, device=dev))
    emit({"phase": "model", "config": "Mistral-7B-v0.1", "weights": "bf16",
          "sliding_window": cfg.sliding_window,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    prompt = torch.randint(0, cfg.vocab_size, (1, PREFILL_LEN),
                           generator=gen, device=dev)
    cap = PREFILL_LEN + 128

    def run(c, chunked=True, paged=False):
        eng = engine_for(c, params)
        cache = (base.init_paged_cache(c, 1, cap, device=dev) if paged
                 else base.init_cache(c, 1, cap, device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            if chunked:
                last, cache = eng.prefill_chunked(prompt, cache,
                                                  chunk_size=PREFILL_CHUNK)
            else:
                last, cache = eng.prefill(prompt, cache)
        torch.cuda.synchronize()
        return last.float(), time.perf_counter() - t0, cache

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    _build.reset_launches()
    got, t_first, dense_cache = run(cfg)
    launches = dict(_build.LAUNCHES)
    L, n_chunks = cfg.num_layers, PREFILL_LEN // PREFILL_CHUNK
    want_counts = {"k2": L, "k2_window": L, "k2c": L * (n_chunks - 1),
                   "k2c_window": L * (n_chunks - 1)}
    if any(launches.get(k) != n for k, n in want_counts.items()):
        raise RuntimeError(f"windowed chunked prefill launched {launches}, "
                           f"want {want_counts}")
    seconds = min(run(cfg)[1] for _ in range(2))
    single, t_single, _ = run(cfg, chunked=False)
    with plain_kernels():
        plain, t_plain, _ = run(cfg, chunked=False)
        no_window, _, _ = run(dataclasses.replace(cfg, sliding_window=None),
                              chunked=False)
    # decode after the chunked prefill: paged (K3, window) vs dense (sdpa)
    _build.reset_launches()
    _, _, paged_cache = run(cfg, paged=True)
    # both caches are fed the dense run's greedy tokens
    feed = [got.argmax(-1, keepdim=True)]
    steps = {"dense": [], "paged": []}
    k3_before = _build.LAUNCHES["k3"]
    with torch.inference_mode():
        for kind, cache in (("dense", dense_cache), ("paged", paged_cache)):
            for i in range(3):
                lg, cache = base.forward(params, cfg, feed[i], cache)
                steps[kind].append(lg[:, -1].float())
                if kind == "dense":
                    feed.append(steps[kind][-1].argmax(-1, keepdim=True))
    k3 = _build.LAUNCHES["k3"] - k3_before
    step_rel = max(rel(p, d) for p, d in zip(steps["paged"],
                                             steps["dense"]))
    row = {"phase": "prefill_window", "config": "Mistral-7B-v0.1",
           "window": cfg.sliding_window, "prompt": PREFILL_LEN,
           "chunk": PREFILL_CHUNK, "launches": launches,
           "tok_s": PREFILL_LEN / seconds, "seconds": seconds,
           "first_run_seconds": t_first, "single_shot_seconds": t_single,
           "plain_single_shot_seconds": t_plain,
           "rel_err_vs_plain_single_shot": rel(got, plain),
           "argmax_equal": int(got.argmax()) == int(plain.argmax()),
           "rel_err_vs_kernel_single_shot": rel(got, single),
           "rel_err_control_no_window": rel(no_window, plain),
           "decode_k3_launches": k3,
           "decode_rel_err_paged_vs_dense": step_rel, "card": smi}
    emit(row)
    if got.shape != (1, cfg.vocab_size) or not torch.isfinite(got).all():
        raise RuntimeError(f"bad windowed logits {tuple(got.shape)}")
    if not (row["rel_err_vs_kernel_single_shot"] < PREFILL_TOL
            and row["rel_err_vs_plain_single_shot"] < LOGITS_TOL
            and row["argmax_equal"]):
        raise RuntimeError(f"windowed chunked prefill: {row}")
    if not row["rel_err_control_no_window"] >= LOGITS_TOL:
        raise RuntimeError("the window does not move the logits: the "
                           "check cannot see a kernel that ignores it")
    if k3 != 3 * L or not step_rel < PAGED_TOL:
        raise RuntimeError(f"windowed paged decode: K3 {k3}, rel {step_rel}")
    counts = dict(launches)
    counts["k3"] = counts.get("k3", 0) + k3
    del params, dense_cache, paged_cache
    free_device_memory()
    return counts


def attention_biases(params, cfg, g, dev):
    """Random q/k/v biases (what a GLM-4-MoE checkpoint brings) on a tree
    made by init_quantized_params, so fused biases are exercised."""
    for lp in params["layers"]:
        for n in ("q_proj", "k_proj", "v_proj"):
            rows = (cfg.num_heads if n == "q_proj"
                    else cfg.num_kv_heads) * cfg.hd
            lp[n]["b"] = (torch.randn(rows, generator=g, device=dev)
                          * 0.1).bfloat16()
    return params


def projection_routes(cfg, params, dense_layers) -> dict:
    """The formula each projection takes at one row: ops.quant_matmul
    ``route`` for a dense layer's weights (the first), the attention and
    the shared expert, ``expert_route`` for the routed experts."""
    from ominix_mlx_tpu_torch.ops import quant_matmul as qm

    def of(tree):
        out = {}
        for n, v in tree.items():
            w = v.get("w") if isinstance(v, dict) else None
            if isinstance(w, qm.PackedQuantizedTensor):
                out[n] = qm.route(w, 1)
            elif isinstance(w, torch.Tensor):
                out[n] = "bf16"
        return out

    routes = {}
    if dense_layers:
        routes["dense_layer"] = of(params["layers"][0])
    lp = params["layers"][dense_layers]
    routes["moe_layer"] = of(lp)
    routes["experts"] = {n: qm.expert_route(w, 1)
                         for n, w in lp["moe"]["experts"].items()}
    if "shared_expert" in lp["moe"]:
        routes["shared_expert"] = of(lp["moe"]["shared_expert"])
    return routes


def batched_family_requests(dev, cfg, params, name, module,
                            max_tokens=8):
    """The model on a batched server (enable_batching: the dense
    continuous batcher, 8 slots) answering 8 concurrent HTTP chat
    requests of up to ``max_tokens`` tokens: aggregate tok/s of the 8 and
    the launch counts; every answer non-empty."""
    from ominix_mlx_tpu_torch.ops import _build
    from ominix_mlx_tpu_torch.serving.server import ChatModel, Server

    srv = Server(port=free_port())
    srv.add_model(name, ChatModel(name, params, cfg,
                                  ByteTokenizer(cfg.vocab_size), dev, module))
    srv.enable_batching(name, slots=BATCH, max_len=512)
    srv.start_background()
    reqs = {f"r{i}": (p, {"max_tokens": max_tokens}) for i, p in enumerate((
        "Hi!", "Name three colours.", "Count to five.",
        "Tell me a story.", "What is 2+2?", "Say hello in French.",
        "Pick a number.", "Summarise: the kernels stream packed weights."))}
    try:
        _build.reset_launches()
        t0 = time.perf_counter()
        got = send_concurrent(srv.port, name, reqs)
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    finally:
        srv.shutdown()
    tokens = sum(r[2] for r in got.values())
    row = {"phase": "request_batched", "model": name, "requests": len(got),
           "completion_tokens": tokens, "seconds": wall,
           "aggregate_tok_s": tokens / wall, "launches": launches}
    emit(row)
    if any(r[2] <= 0 or not r[0] for r in got.values()):
        raise RuntimeError(f"{name}: a batched request came back empty")
    return launches


def family_batch_decode(dev, cfg, params, name, paged, short=4, long=12):
    """Decode at batch 8 after a 128-token prompt (prefill M = 1024: K5),
    over init_paged_cache (K3) or, for MLA, the dense latent cache:
    aggregate tok/s by the difference quotient (generate_scan of ``long``
    vs ``short`` tokens, best of 2), the launch counts of the first run,
    and the greedy tokens of two runs equal."""
    from ominix_mlx_tpu_torch.models import base
    from ominix_mlx_tpu_torch.ops import _build

    eng = engine_for(cfg, params)
    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, 128), generator=g,
                           device=dev)

    def run(n):
        cache = (base.init_paged_cache(cfg, BATCH, 512, device=dev) if paged
                 else base.init_cache(cfg, BATCH, 512, device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, _ = eng.generate_scan(prompt, cache, max_tokens=n)
        toks = toks.cpu()
        return time.perf_counter() - t0, toks

    _build.reset_launches()
    _, first = run(short)
    launches = dict(_build.LAUNCHES)
    t_short = min(run(short)[0] for _ in range(2))
    longs = [run(long) for _ in range(2)]
    t_long = min(t for t, _ in longs)
    row = {"phase": "family_batch_decode", "config": name,
           "weights": "w4a8 g64", "batch": BATCH, "prompt": 128,
           "cache": "paged" if paged else "dense", "launches": launches,
           "tok_s": BATCH * (long - short) / (t_long - t_short),
           f"t{short}_s": t_short, f"t{long}_s": t_long,
           "greedy_repeatable": bool(torch.equal(longs[0][1], longs[1][1])
                                     and torch.equal(first,
                                                     longs[0][1][:, :short]))}
    emit(row)
    if paged and launches.get("k3", 0) < cfg.num_layers * (short - 1):
        raise RuntimeError(f"{name}: batch-8 paged decode launched "
                           f"{launches}")
    if launches.get("k5_w4", 0) < 1 or not row["greedy_repeatable"]:
        raise RuntimeError(f"{name}: batch-8 decode: {row}")
    return launches


def repeat_prefill_decode(dev, cfg, params, name, T=40, n=16):
    """A T-token prompt (more than GATHER_M_MAX rows: K5) then n greedy
    tokens through Engine.generate, twice: the same tokens."""
    from ominix_mlx_tpu_torch.models import base

    eng = engine_for(cfg, params)
    prompt = (torch.arange(T, device=dev) * 7 + 3) % cfg.vocab_size
    runs = [list(eng.generate(prompt, base.init_cache(cfg, 1, 256,
                                                      device=dev),
                              max_tokens=n)) for _ in range(2)]
    emit({"phase": "prefill_decode_repeat", "config": name,
          "prompt_tokens": T, "tokens": runs[0], "equal": runs[0] == runs[1]})
    if runs[0] != runs[1] or len(runs[0]) != n:
        raise RuntimeError(f"{name}: greedy decode after a {T}-token "
                           f"prefill differs between runs: {runs}")


def serve_moe_family(dev, smi, phase, cfg, name, module, seed, dense_layers,
                     keys, paged, profile=False, batch_tokens=(4, 12)):
    """One MoE family at full width, w4a8 g64 from init_quantized_params
    (``dense_layers`` dense first) plus fuse_layer_projections: the route
    of each projection; 4 HTTP chat requests one at a time (every kernel
    of ``keys`` launched); 8 at once on a batched server; a 128-token
    prefill (moe_prefill: wall, device busy, peak memory); the batch-1
    decode rate; decode at batch 8 (over a paged cache where ``paged``:
    K3, each of its calls on the first step held against its plain
    version; ``batch_tokens`` the short and long runs of the difference
    quotient); with ``profile`` a profile line of batch-1 decode steps.
    Returns the launch counts of the whole phase."""
    from ominix_mlx_tpu_torch.models import base

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = base.init_quantized_params(cfg, gen, GS, 4, act_bits=8,
                                        device=dev,
                                        dense_layers=dense_layers)
    if cfg.attention_bias:
        params = attention_biases(params, cfg, gen, dev)
    params = base.fuse_layer_projections(params)
    torch.cuda.synchronize()
    emit({"phase": "model", "config": name, "weights": "w4a8 g64",
          "layers": cfg.num_layers, "dense_layers": dense_layers,
          "init_seconds": time.perf_counter() - t0,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    emit({"phase": "routes", "config": name,
          **projection_routes(cfg, params, dense_layers)})
    _, counts = serve_requests(dev, cfg, params, name.lower(), keys, module)
    runs = [counts, batched_family_requests(dev, cfg, params,
                                            name.lower() + "-batched",
                                            module)]
    emit({"phase": "moe_prefill", "config": name, "weights": "w4a8 g64",
          **moe_prefill(dev, cfg, params), "card": smi})
    emit({**decode_rate(dev, cfg, params, 8, 24), "config": name,
          "weights": "w4a8 g64", "card": smi})
    decode_graph(dev, cfg, params, name, "w4a8 g64", smi, module, paged)
    if profile:
        emit({**profile_decode(dev, cfg, params, steps=16), "config": name,
              "weights": "w4a8 g64", "card": smi})
    runs.append(family_batch_decode(dev, cfg, params, name, paged,
                                    *batch_tokens))
    if paged:
        g = torch.Generator(device=dev).manual_seed(SEED + 32)
        prompt = torch.randint(0, cfg.vocab_size, (BATCH, 128), generator=g,
                               device=dev)
        rel, k3_calls = paged_first_step(dev, cfg, params, prompt)
        emit({"phase": "paged_first_step", "config": name,
              "rel_err_paged_vs_dense": rel, "limit": MOE_W8A8_LOGITS_TOL,
              "pool_equals_dense_cache": True,
              "k3_calls_checked": len(k3_calls),
              "k3_per_call_max_row_rel_err": max(k3_calls),
              "per_call_limit": K3_TOL})
        if not rel < MOE_W8A8_LOGITS_TOL:
            raise RuntimeError(f"{name}: paged vs dense first step rel "
                               f"{rel}")
    else:
        repeat_prefill_decode(dev, cfg, params, name)
    del params
    free_device_memory()
    total = {k: sum(r.get(k, 0) for r in runs)
             for k in set().union(*runs)}
    emit({"phase": phase, "launches": total, "ok": True})
    return total


def deepseek_v2_lite():
    from ominix_mlx_tpu_torch.models import deepseek_v3
    return deepseek_v3.config_from_hf(DEEPSEEK_V2_LITE_HF)


def serve_deepseek_v2_lite(dev, smi, profile=False):
    """serve_deepseek_v2_lite: DeepSeek-V2-Lite at full width and depth
    (MLA over the latent cache, plain sdpa; layer 0 dense, its down_proj
    on the dense route; 26 MoE layers of 64 experts top 6 and 2 shared:
    K1 on q_proj, o_proj and the shared experts, K4 on gate and up, the
    down projection (K = 1408) gathered, K5 at every prefill)."""
    from ominix_mlx_tpu_torch.models import deepseek_v3

    cfg = deepseek_v2_lite()
    return serve_moe_family(
        dev, smi, "serve_deepseek_v2_lite", cfg, "DeepSeek-V2-Lite",
        deepseek_v3, SEED + 33,
        DEEPSEEK_V2_LITE_HF["first_k_dense_replace"],
        ("k1_m1", "k1_mn", "k4", "k5_w4"), paged=False, profile=profile)


def serve_mixtral(dev, smi, profile=False):
    """serve_mixtral: Mixtral-8x7B-v0.1 at full width and depth (K1, K2,
    K5 with streamed scales at the down projection's K = 14336; the
    experts at decode gathered, as the JAX package's rule sends them; K3
    at batch 8)."""
    from ominix_mlx_tpu_torch.models import mixtral

    cfg = mixtral.config_from_hf(MIXTRAL_8X7B_HF)
    return serve_moe_family(dev, smi, "serve_mixtral", cfg, "Mixtral-8x7B",
                            mixtral, SEED + 34, 0,
                            ("k1_m1", "k1_mn", "k2", "k5_w4"), paged=True,
                            profile=profile, batch_tokens=(2, 6))


def serve_glm4_moe(dev, smi, profile=False):
    """serve_glm4_moe: GLM-4.5-Air at full width and depth (46 layers: 1
    dense, the rest MoE of 128 experts top 8 and 1 shared; 96 query heads
    over 8 KV heads: K3 at 12 a KV head; K1, K2, K4 on gate and up, K5)."""
    from ominix_mlx_tpu_torch.models import glm4_moe

    cfg = glm4_moe.config_from_hf(GLM45_AIR_HF)
    return serve_moe_family(dev, smi, "serve_glm4_moe", cfg, "GLM-4.5-Air",
                            glm4_moe, SEED + 35,
                            GLM45_AIR_HF["first_k_dense_replace"],
                            ("k1_m1", "k1_mn", "k2", "k4", "k5_w4"),
                            paged=True, profile=profile)


def lin_layers(cfg) -> int:
    """How many of the model's layers are DeltaNet layers."""
    return sum(lt == "linear_attention" for lt in cfg.layer_types)


def qwen3_next_gib(cfg, shared: int, bits: int = 4) -> float:
    """The reckoned size of the w4a8 g64 tree of ``init_quantized_params``:
    every projection and expert at bits/8 bytes a weight plus a bf16 scale
    and bias per group, the router and shared-expert gates and the conv
    taps bf16, norms and the DeltaNet's per-head vectors beside."""
    D, L, m, d = cfg.hidden_size, cfg.num_layers, cfg.moe, cfg.deltanet
    q = bits / 8 + 4 / GS                          # bytes a packed weight
    lin = lin_layers(cfg)
    attn = L - lin
    delta = (2 * d.key_dim + 2 * d.value_dim) * D + 2 * d.num_v_heads * D \
        + D * d.value_dim
    gated = (2 * cfg.num_heads * cfg.hd + 2 * cfg.num_kv_heads * cfg.hd) \
        * D + D * cfg.num_heads * cfg.hd
    experts = 3 * m.num_experts * m.moe_intermediate_size * D
    packed = (lin * delta + attn * gated
              + L * (experts + 3 * shared * D) + 2 * cfg.vocab_size * D)
    dense = 2 * (L * (m.num_experts + 1) * D + lin * d.conv_dim
                 * d.conv_kernel)
    return (packed * q + dense) / 2 ** 30


@contextlib.contextmanager
def counting_forwards(module):
    """Record (rows B * T, fresh_prefill, B, T, the keyword arguments
    with "int_offset": whether the cache's offset is one int) of each call
    of ``module.forward`` (what a ChatModel and the batcher call, by the
    module's attribute) for the duration, a forward captured in the
    engine's or the batcher's step once each replay: yields the list."""
    from ominix_mlx_tpu_torch.ops import _build

    seen, real, live = [], module.forward, [True]

    @functools.wraps(real)      # the engines read forward's signature
    def counted(params, cfg, tokens, cache, **kw):
        row = (tokens.shape[0] * tokens.shape[1],
               bool(kw.get("fresh_prefill", False)),
               tokens.shape[0], tokens.shape[1],
               {**kw, "int_offset": isinstance(cache.offset, int)})
        # a forward in a captured step counts at each replay while the
        # count lasts (a batcher's graphs outlive it)
        _build.on_run(lambda: live[0] and seen.append(row))
        return real(params, cfg, tokens, cache, **kw)
    module.forward = counted
    try:
        yield seen
    finally:
        module.forward = real
        live[0] = False


def k9_forward_launches(cfg, shapes) -> dict:
    """The DeltaNet layers' launches over forwards of (B, T) ``shapes``
    (ops.gated_delta.deltanet_launches): k9_decode once per layer at T =
    1; else k9_prep, then K9 in the form k9_plan picks (k9, or the
    chunked form's k9_chunk and k9_chunk_scan)."""
    from ominix_mlx_tpu_torch.ops import gated_delta as gd

    d, lin = cfg.deltanet, lin_layers(cfg)
    want = dict.fromkeys(("k9_decode", "k9_prep", "k9", "k9_chunk",
                          "k9_chunk_scan"), 0)
    for B, T in shapes:
        for k, n in gd.deltanet_launches(B, T, d.num_v_heads, d.head_k_dim,
                                         d.head_v_dim).items():
            want[k] += lin * n
    return want


def check_hybrid_launches(cfg, forwards, launches, where):
    """The launch counts of a run of ``forwards`` on the hybrid, exactly:
    k9_decode once per DeltaNet layer and one-token forward, k9_prep and
    K9 (in its planned form) once per DeltaNet layer and longer forward;
    K4 twice per MoE layer at each forward of at most
    GATHER_M_MAX rows (decode), K5 on the packed experts three times per
    MoE layer at each longer one (prefill); K2 once per attention layer
    at each fresh prefill."""
    from ominix_mlx_tpu_torch.models import moe

    attn = cfg.num_layers - lin_layers(cfg)
    decode = sum(f[0] <= moe.GATHER_M_MAX for f in forwards)
    fresh = sum(f[1] for f in forwards if f[0] > 1)
    want = {**k9_forward_launches(cfg, [f[2:4] for f in forwards]),
            "k4": 2 * cfg.num_layers * decode,
            "k5_w4": 3 * cfg.num_layers * (len(forwards) - decode),
            "k2": attn * fresh}
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        raise RuntimeError(f"{where}: launched {got}, want {want} for "
                           f"{len(forwards)} forwards ({decode} decode, "
                           f"{fresh} fresh prefills)")
    return want


def hybrid_routes(cfg, params) -> dict:
    """The formula each projection of the hybrid takes at one row: a
    DeltaNet layer's, an attention layer's, the shared expert's
    (ops.quant_matmul ``route``) and the routed experts'
    (``expert_route``)."""
    from ominix_mlx_tpu_torch.models import base
    from ominix_mlx_tpu_torch.ops import quant_matmul as qm

    def of(tree):
        return {n: qm.route(v["w"], 1) for n, v in tree.items()
                if isinstance(v, dict)
                and isinstance(v.get("w"), qm.PackedQuantizedTensor)}

    lin = next(i for i in range(cfg.num_layers)
               if base.is_linear_layer(cfg, i))
    att = next(i for i in range(cfg.num_layers)
               if not base.is_linear_layer(cfg, i))
    moe = params["layers"][lin]["moe"]
    return {"deltanet_layer": of(params["layers"][lin]["linear_attn"]),
            "attention_layer": of(params["layers"][att]),
            "shared_expert": of(moe["shared_expert"]),
            "experts": {n: qm.expert_route(w, 1)
                        for n, w in moe["experts"].items()}}


def hybrid_batched(dev, cfg, params, name, module, check=None):
    """The hybrid on a batched server (enable_batching(paged=False): the
    dense continuous batcher, 8 slots; each adoption prefills at exactly T
    into its slot's rows, the recurrent ones zeroed first): 8 concurrent
    HTTP chat requests of up to 16 tokens, then each alone on the same
    server (its slot rows reused), whose text must equal its text in the
    batch. Launch counts of the concurrent run, held exactly by
    ``check`` (default check_hybrid_launches) over its forwards."""
    from ominix_mlx_tpu_torch.ops import _build
    from ominix_mlx_tpu_torch.serving.server import ChatModel, Server

    srv = Server(port=free_port())
    srv.add_model(name, ChatModel(name, params, cfg,
                                  ByteTokenizer(cfg.vocab_size), dev, module))
    srv.enable_batching(name, slots=BATCH, max_len=512, paged=False)
    srv.start_background()
    contents = ("Hi!", "What is 2+2?", "Say hello in French.",
                "Name three colours.", "Count to five.", "Tell me a story.",
                "Pick a number.", "Why is the sky blue?")
    reqs = {f"r{i}": (c, {"max_tokens": 16}) for i, c in enumerate(contents)}
    try:
        _build.reset_launches()
        t0 = time.perf_counter()
        with counting_forwards(module) as forwards:
            together = send_concurrent(srv.port, name, reqs)
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        alone = {}
        for k in reqs:
            alone.update(send_concurrent(srv.port, name, {k: reqs[k]}))
    finally:
        srv.shutdown()
    same = {k: together[k][0] == alone[k][0] for k in reqs}
    n_tok = sum(r[2] for r in together.values())
    emit({"phase": "request_batched", "model": name, "slots": BATCH,
          "cache": "dense (hybrid)", "requests": len(together),
          "completion_tokens": n_tok, "seconds": wall,
          "aggregate_tok_s": n_tok / wall, "forwards": len(forwards),
          "launches": launches, "equal_alone": same,
          "prompt_tokens": {k: r[1] for k, r in together.items()},
          "text": {k: r[0][:40] for k, r in together.items()}})
    (check or check_hybrid_launches)(cfg, forwards, launches,
                                     f"{name} batched")
    if not all(r[2] > 0 and r[0] for r in together.values()) \
            or not all(same.values()):
        raise RuntimeError(f"{name}: batched answers differ from solo or "
                           f"are empty: {same}")
    return launches


def hybrid_chunked_prefill(dev, cfg, params, T=1024, chunk=256):
    """The hybrid's long-prompt path through Engine.prefill_chunked: a
    T-token prompt in ``chunk``-token chunks (the first through K2, the
    rest K2c over the written prefix; every chunk at its exact width
    through the recurrent layers, k9_prep and K9's planned form once a
    chunk and layer), against
    Engine.prefill of the whole prompt: the launches exact; the last
    prompt token's logits and those of one decode step after it (which
    read the state the prefill left) within HYBRID_PREFILL_TOL, the same
    argmax; and, reported beside, the chunks run with every recurrent
    state zeroed before each continuation chunk."""
    from ominix_mlx_tpu_torch.core.generate import Engine
    from ominix_mlx_tpu_torch.models import base
    from ominix_mlx_tpu_torch.models.deltanet import RecurrentCache
    from ominix_mlx_tpu_torch.ops import _build

    eng = engine_for(cfg, params)
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    prompt = torch.randint(0, cfg.vocab_size, (1, T), generator=g,
                           device=dev)

    def forgetting(fn):
        def call(p, t, c, kl):
            for lc in c.layers:
                if isinstance(lc, RecurrentCache):
                    lc.zero_()
            return fn(p, t, c, kl)
        return call

    def run(engine, chunked=True):
        """(last prompt logits and the next step's [2, V], seconds of
        the prefill, offset after it, the prefill's launches)."""
        cache = base.init_cache(cfg, 1, T + 64, device=dev)
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if chunked:
            last, cache = engine.prefill_chunked(prompt, cache, chunk)
        else:
            last, cache = engine.prefill(prompt, cache)
        torch.cuda.synchronize()
        seconds, offset = time.perf_counter() - t0, cache.offset
        launches = dict(_build.LAUNCHES)
        with torch.inference_mode():
            step, _ = base.forward(params, cfg, prompt[:, :1], cache)
        return (torch.cat([last.float(), step[:, -1].float()]), seconds,
                offset, launches)

    got, t_chunked, offset, launches = run(eng)
    n = -(-T // chunk)
    lin = lin_layers(cfg)
    attn = cfg.num_layers - lin
    want_counts = {**k9_forward_launches(
        cfg, [(1, min(chunk, T - i)) for i in range(0, T, chunk)]),
        "k2": attn, "k2c": attn * (n - 1), "k5_w4": 3 * cfg.num_layers * n}
    want, t_single = run(eng, chunked=False)[:2]
    control = Engine(
        eng.forward_fn, eng.params, eng.sampler,
        prefill_forward_fn=eng.prefill_forward_fn,
        chunk_forward_fn=forgetting(eng.chunk_forward_fn),
        chunk_hidden_forward_fn=forgetting(eng.chunk_hidden_forward_fn))
    forgot = run(control)[0]

    def rel(a):
        return max(((a[i] - want[i]).abs().max()
                    / want[i].abs().max()).item() for i in (0, 1))

    row = {"phase": "hybrid_prefill_chunked", "prompt": T, "chunk": chunk,
           "offset": offset, "launches": launches, "want": want_counts,
           "chunked_seconds": t_chunked, "single_shot_seconds": t_single,
           "rel_err_vs_single_shot": rel(got), "limit": HYBRID_PREFILL_TOL,
           "rel_err_control_state_forgotten": rel(forgot),
           "argmax_equal": torch.equal(got.argmax(-1), want.argmax(-1))}
    emit(row)
    if {k: launches.get(k, 0) for k in want_counts} != want_counts:
        raise RuntimeError(f"hybrid chunked prefill launched {launches}, "
                           f"want {want_counts}")
    if offset != T or not torch.isfinite(got).all() \
            or not row["rel_err_vs_single_shot"] < HYBRID_PREFILL_TOL \
            or not row["argmax_equal"]:
        raise RuntimeError(f"hybrid chunked vs single-shot prefill: {row}")
    return launches


def serve_qwen3_next(dev, smi, profile=False):
    """serve_qwen3_next: Qwen3-Next-80B-A3B-Instruct at full width and all
    48 layers, w4a8 g64 random weights made packed (about 45 GB: its
    reckoning and the allocation printed): the route of each projection;
    4 HTTP chat requests one at a time (every prefill at exactly its
    length: k9_prep and K9 in the 36 DeltaNet layers, the chunked form
    from K9_CHUNK_MIN_T tokens, K2 at 16 over 2 heads of 256 in the 12
    attention layers, K5 on the 512 packed experts; every decode step
    k9_decode in each DeltaNet layer, K1 and K4 twice a MoE layer at top
    10), their launches held exactly (check_hybrid_launches); a profiled
    128-token prefill (wall, device busy, peak memory); the kernel-vs-plain
    logits check on 4 layers (K9, k9_prep and k9_decode each alone
    against the plain path, every call of each held per call, and each
    K9 call with the prologue before it against both plain versions);
    every k9_decode, k9_prep and K9 call of a 200-token prompt and two
    decode steps held likewise (k9_per_call_prompt); the batch-1 decode
    rate; with ``profile`` a profile line of
    decode steps; 8 concurrent requests on enable_batching(paged=False),
    each equal to the same request alone. Returns the phase's launches."""
    from ominix_mlx_tpu_torch.models import base, qwen3_next

    cfg = qwen3_next.config_from_hf(QWEN3_NEXT_80B_HF)
    name = "Qwen3-Next-80B-A3B"
    shared = QWEN3_NEXT_80B_HF["shared_expert_intermediate_size"]
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 38)
    params = base.fuse_layer_projections(qwen3_next.init_quantized_params(
        cfg, gen, GS, 4, 8, device=dev, shared_width=shared))
    torch.cuda.synchronize()
    emit({"phase": "model", "config": name, "weights": "w4a8 g64",
          "layers": cfg.num_layers, "layer_types": {
              lt: cfg.layer_types.count(lt) for lt in set(cfg.layer_types)},
          "init_seconds": time.perf_counter() - t0,
          "reckoned_gib": qwen3_next_gib(cfg, shared),
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30,
          "max_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    emit({"phase": "routes", "config": name, **hybrid_routes(cfg, params)})
    with counting_forwards(qwen3_next) as forwards:
        _, counts = serve_requests(dev, cfg, params, name.lower(),
                                   ("k1_m1", "k1_mn", "k2", "k4", "k5_w4",
                                    "k9", "k9_chunk", "k9_chunk_scan",
                                    "k9_prep", "k9_decode"), qwen3_next)
    want = check_hybrid_launches(cfg, forwards, counts, f"{name} serve")
    emit({"phase": "serve_qwen3_next_launches", "forwards": len(forwards),
          "launches": counts, "want": want})
    runs = [counts]
    emit({"phase": "moe_prefill", "config": name, "weights": "w4a8 g64",
          **moe_prefill(dev, cfg, params), "card": smi})
    check_logits(dev, cfg, params, name,
                 kernels=("k1", "k2", "k4", "k5", "k9", "k9_prep",
                          "k9_decode"), layers=4)
    k9_per_call_prompt(dev, cfg, params)
    emit({**decode_rate(dev, cfg, params, 16, 48), "config": name,
          "weights": "w4a8 g64", "card": smi})
    decode_graph(dev, cfg, params, name, "w4a8 g64", smi, qwen3_next)
    if profile:
        emit({**profile_decode(dev, cfg, params, steps=16), "config": name,
              "weights": "w4a8 g64", "card": smi})
    runs.append(hybrid_chunked_prefill(dev, cfg, params))
    runs.append(hybrid_batched(dev, cfg, params, name.lower() + "-batched",
                               qwen3_next))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del params
    free_device_memory()
    total = {k: sum(r.get(k, 0) for r in runs)
             for k in set().union(*runs)}
    emit({"phase": "serve_qwen3_next", "launches": total,
          "max_memory_gib": peak, "ok": True})
    return total


def minicpm_call_checks():
    """Wrappers for swapped_kernels that hold every K10 and K11 call
    against its plain version on the same inputs (a copy of the state for
    K10): (stats, {kernel: wrap}). K10 counts each call's form;
    k10_decode holds the state bit for bit and the output within
    K10_DECODE_ULPS; k11_select holds the finite scores, the NEG_INF mask
    and the blocks chosen; k11_attend holds each (row, head)
    and counts, per (row, KV head), the finite top-k blocks it was given
    (``valid_blocks``)."""
    from ominix_mlx_tpu_torch.ops import lightning_attention as la
    from ominix_mlx_tpu_torch.ops import sparse_attention as sa

    st = {"k10": {"calls": 0, "max_rel_err": 0.0, "state_max_rel_err": 0.0,
                  "forms": {}, "decode_calls": 0, "decode_max_row_ulps": 0.0,
                  "decode_state_equal": True},
          "k11": {"select_calls": 0, "score_max_rel_err": 0.0,
                  "masked_equal": True,
                  "selected_equal": True, "attend_calls": 0,
                  "attend_max_rel_err": 0.0, "valid_blocks": []}}

    def k10(kern, plain):
        def call(q, k, v, slopes, state):
            s0 = state.clone()
            y = kern(q, k, v, slopes, state)
            want = plain(q, k, v, slopes, s0)
            c = st["k10"]
            c["calls"] += 1
            form = la.k10_plan(q.shape[0], q.shape[2], q.shape[1],
                               q.shape[3])
            c["forms"][form] = c["forms"].get(form, 0) + 1
            c["max_rel_err"] = max(c["max_rel_err"], rel_to(y, want))
            c["state_max_rel_err"] = max(c["state_max_rel_err"],
                                         rel_to(state, s0))
            return y
        return call

    def decode(kern, plain):
        def call(q, k, v, slopes, state, *a, **kw):
            s0 = state.clone()
            y = kern(q, k, v, slopes, state, *a, **kw)
            want = plain(q, k, v, slopes, s0, *a, **kw)
            c = st["k10"]
            c["decode_calls"] += 1
            c["decode_max_row_ulps"] = max(c["decode_max_row_ulps"],
                                           row_ulps(y, want))
            c["decode_state_equal"] &= bool(torch.equal(state, s0))
            return y
        return call

    def held_scores(got, want):
        c = st["k11"]
        fin = want > sa.NEG_INF / 2
        c["masked_equal"] &= bool(torch.equal(got > sa.NEG_INF / 2, fin))
        if fin.any():
            c["score_max_rel_err"] = max(
                c["score_max_rel_err"],
                ((got - want)[fin].abs().max() / want[fin].abs().max())
                .item())

    def select(kern, plain):
        def call(*a):
            y = kern(*a)
            want = plain(*a)
            c = st["k11"]
            c["select_calls"] += 1
            held_scores(y[0], want[0])
            c["selected_equal"] &= chosen(*y) == chosen(*want)
            return y
        return call

    def attend(kern, plain):
        def call(q, k, v, idx, top, *rest):
            y = kern(q, k, v, idx, top, *rest)
            want = plain(q, k, v, idx, top, *rest)
            c = st["k11"]
            c["attend_calls"] += 1
            c["attend_max_rel_err"] = max(c["attend_max_rel_err"],
                                          row_rel_err(y, want))
            c["valid_blocks"].extend(
                (top > sa.NEG_INF / 2).sum(-1).flatten().tolist())
            return y
        return call

    return st, {"k10": k10, "k10_decode": decode, "k11_select": select,
                "k11_attend": attend}


def minicpm_calls_hold(st, where):
    """Raise unless every K10 and K11 call held its limit."""
    a, b = st["k10"], st["k11"]
    if not (a["max_rel_err"] < K10_TOL and a["state_max_rel_err"] < K10_TOL
            and a["decode_max_row_ulps"] <= K10_DECODE_ULPS
            and a["decode_state_equal"]
            and b["score_max_rel_err"] < K11_SCORE_TOL and b["masked_equal"]
            and b["selected_equal"] and b["attend_max_rel_err"] < K11_TOL
            and b["select_calls"] == b["attend_calls"]):
        raise RuntimeError(f"{where}: K10 / K11 against their plain versions "
                           f"on the path's inputs: {sala_summary(st)}")


def sala_summary(st) -> dict:
    """The per-call stats for a JSON line (the valid-block counts as their
    range)."""
    k11 = {k: v for k, v in st["k11"].items() if k != "valid_blocks"}
    vb = st["k11"]["valid_blocks"]
    k11["valid_blocks"] = [min(vb), max(vb)] if vb else None
    return {"per_call_k10": st["k10"], "per_call_k11": k11}


def minicpm_gib(cfg, bits: int = 8) -> float:
    """The reckoned size of the w8a8 g64 tree of init_quantized_params:
    every projection, the embedding and the lm_head at bits/8 bytes a
    weight plus a bf16 scale and bias per group; the norms bf16."""
    D, L, V = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    lin = sum(m == "lightning-attn" for m in cfg.mixer_types)
    w = cfg.gla_heads * cfg.gla_head_dim
    att = (2 * cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim * D
    packed = lin * 5 * w * D + (L - lin) * att \
        + L * 3 * cfg.intermediate_size * D + 2 * V * D
    norms = 2 * (L * 2 * D + lin * w + L * 2 * cfg.head_dim + D)
    return (packed * (bits / 8 + 4 / GS) + norms) / 2 ** 30


def minicpm_forward_launches(cfg, params, forwards) -> dict:
    """The launches of MiniCPM-SALA forwards, exactly (``forwards`` as
    counting_forwards records them): per forward of B rows and T tokens
    over its layers (``num_layers``), in each lightning layer k10_decode
    at T = 1 and otherwise K10 in the form k10_plan picks; in each sparse
    layer K2 for a fresh prompt, K2c for a continuation chunk (kv_limit) or
    a prompt at an offset, k11_select and k11_attend for a decode step (no
    k10 and no k11_score there); and K1 for each packed
    projection at M = B T rows in the formula ``route`` names (one row:
    k1_m1, 2-16 rows on panels: the dq formula k1_mn, the 8-bit counters;
    past 16 rows the dense route, no kernel), the lm_head's unless
    skip_logits."""
    from ominix_mlx_tpu_torch.ops import lightning_attention as la
    from ominix_mlx_tpu_torch.ops import quant_matmul as qm

    want = dict.fromkeys(("k10", "k10_chunk", "k10_decode", "k11_score",
                          "k11_select", "k11_attend", "k2", "k2c", "k1_m1",
                          "k1_mn", "k1_m1_w8", "k1_mn_w8"), 0)

    def k1(w, M):
        if not isinstance(w, qm.PackedQuantizedTensor):
            return
        r = qm.route(w, M)
        if r not in ("k1", "k1_mn", "dense"):
            raise RuntimeError(f"a projection takes route {r} at {M} rows")
        if r != "dense":                    # no kernel past 16 rows
            want[{"k1": "k1_m1", "k1_mn": "k1_mn"}[r]
                 + ("_w8" if w.bits == 8 else "")] += 1

    for rows, fresh, B, T, kw in forwards:
        n = kw.get("num_layers") or cfg.num_layers
        for i in range(n):
            if cfg.mixer_types[i] == "lightning-attn":
                if T == 1:
                    want["k10_decode"] += 1
                else:
                    for k, c in la.k10_launches(B, T, cfg.gla_heads,
                                                cfg.gla_head_dim).items():
                        want[k] += c
            elif kw.get("kv_limit") is not None:
                want["k2c"] += 1
            elif T == 1:
                want["k11_select"] += 1
                want["k11_attend"] += 1
            elif kw["int_offset"]:
                want["k2" if fresh else "k2c"] += 1
            for v in params["layers"][i].values():
                if isinstance(v, dict) and "w" in v:
                    k1(v["w"], rows)
        if not kw.get("skip_logits"):
            k1(params["lm_head"]["w"], rows)
    return want


def check_minicpm_launches(cfg, params, forwards, launches, where):
    want = minicpm_forward_launches(cfg, params, forwards)
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        raise RuntimeError(f"{where}: launched {got}, want {want} for "
                           f"{len(forwards)} forwards")
    return want


def minicpm_routes(params) -> dict:
    """The formula each projection takes at one row: a sparse layer's, a
    lightning layer's and the lm_head's (ops.quant_matmul ``route``)."""
    from ominix_mlx_tpu_torch.ops import quant_matmul as qm

    def of(tree):
        return {n: qm.route(v["w"], 1) for n, v in tree.items()
                if isinstance(v, dict)
                and isinstance(v.get("w"), qm.PackedQuantizedTensor)}

    return {"sparse_layer": of(params["layers"][0]),
            "lightning_layer": of(params["layers"][1]),
            "lm_head": of({"lm_head": params["lm_head"]})["lm_head"]}


def minicpm_per_call_prompt(dev, cfg, params, T=200, layers=4, steps=2):
    """Every K10 and K11 call of a T-token prefill (K10's chunked form), a
    2-token continuation (its recurrent form; K2c) and ``steps`` decode
    steps (k10_decode, k11_select, k11_attend) on the first ``layers``
    layers (one sparse, three lightning), held against the plain versions
    on the path's own inputs."""
    from ominix_mlx_tpu_torch.models import minicpm_sala as ms

    c2 = dataclasses.replace(cfg, num_layers=layers)
    p2 = {**params, "layers": params["layers"][:layers]}
    g = torch.Generator(device=dev).manual_seed(SEED + 54)
    prompt = torch.randint(0, cfg.vocab_size, (1, T), generator=g,
                           device=dev)
    st, wraps = minicpm_call_checks()
    eng = engine_for(c2, p2, ms)
    cache = ms.init_cache(c2, 1, T + steps + 3, device=dev)
    with swapped_kernels(lambda k, kern, plain: wraps[k](kern, plain)
                         if k in wraps else kern), torch.inference_mode():
        logits, cache = eng.prefill(prompt, cache)
        logits, cache = ms.forward(
            p2, c2, torch.tensor([[1, 2]], device=dev), cache)
        for t in range(steps):
            logits, cache = ms.forward(
                p2, c2, torch.tensor([[t + 3]], device=dev), cache)
    emit({"phase": "minicpm_per_call_prompt", "layers": layers, "prompt": T,
          "decode_steps": steps, **sala_summary(st)})
    minicpm_calls_hold(st, f"{T}-token prompt")
    lin = sum(m == "lightning-attn" for m in c2.mixer_types[:layers])
    if set(st["k10"]["forms"]) != {"chunked", "recurrent"} \
            or st["k10"]["decode_calls"] != steps * lin \
            or st["k11"]["select_calls"] != steps * (layers - lin):
        raise RuntimeError(f"K10's and K11's calls on the prompt: {st}")


def minicpm_long_prefill(dev, cfg, params, T=8194, chunk=2048, steps=16):
    """An 8194-token prompt through Engine.prefill_chunked in 2048-token
    chunks (K2, then K2c in the sparse layers; K10's chunked form, and its
    recurrent form on the last chunk of 2 tokens), then ``steps`` greedy
    decode steps (k10_decode, K11), every K11 call held against its plain
    version: the middle then holds about 190 whole blocks, so the top 64
    prune, and every (row, KV head) must be given 64 finite blocks. The
    launches of the whole run held exactly. Returns them."""
    from ominix_mlx_tpu_torch.models import minicpm_sala as ms
    from ominix_mlx_tpu_torch.ops import _build

    eng = engine_for(cfg, params, ms)
    g = torch.Generator(device=dev).manual_seed(SEED + 55)
    prompt = torch.randint(0, cfg.vocab_size, (1, T), generator=g,
                           device=dev)
    cache = ms.init_cache(cfg, 1, T + steps + 16, device=dev)
    st, wraps = minicpm_call_checks()
    _build.reset_launches()
    with counting_forwards(ms) as forwards:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = eng.prefill_chunked(prompt, cache, chunk)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        tok = last.argmax(-1, keepdim=True)
        with swapped_kernels(lambda k, kern, plain: wraps[k](kern, plain)
                             if k in wraps and k.startswith("k11")
                             else kern), \
                torch.inference_mode():
            for _ in range(steps):
                logits, cache = ms.forward(params, cfg, tok, cache)
                tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = check_minicpm_launches(cfg, params, forwards, launches,
                                  "MiniCPM-SALA 8k chunked prefill")
    vb = st["k11"]["valid_blocks"]
    emit({"phase": "minicpm_prefill_chunked", "prompt": T, "chunk": chunk,
          "prefill_seconds": prefill_s, "prefill_tok_s": T / prefill_s,
          "decode_steps": steps, "offset": cache.offset,
          "launches": launches, "want": want, **sala_summary(st)})
    minicpm_calls_hold(st, "8k chunked prefill")
    if cache.offset != T + steps or not vb or set(vb) != {64} \
            or not torch.isfinite(logits.float()).all():
        raise RuntimeError(f"8k chunked prefill: offset {cache.offset}, "
                           f"valid blocks {sorted(set(vb))}")
    return launches


def minicpm_long_decode(dev, cfg, params, smi, steps=16, profiled=4):
    """Decode over a cache filled at random up to each of
    MINICPM_LONG_OFFSETS (every sparse layer's K and V normal, its pooled
    keys pooled from them; every lightning state small and random), as
    benchmarks/longcontext_bench.py:59-64 jumps the offset: one step with
    every K11 call held against its plain version (64 finite blocks a
    KV head), then ``steps`` greedy steps of the eager loop (forward at
    the host offset) and ``steps`` replays of the engine's captured step
    (Engine.decode_step, captured after its warm-up step, which the
    timing leaves out), in turns (eager, graph, graph, eager; ms/token,
    each ended by a synchronize; the graph pool at this cache), then
    ``profiled`` replays under torch.profiler (device activity only):
    device busy ms a step and K11's share of it."""
    from torch.profiler import ProfilerActivity, profile

    from ominix_mlx_tpu_torch.core.cache import ModelCache
    from ominix_mlx_tpu_torch.models import minicpm_sala as ms
    from ominix_mlx_tpu_torch.models.lightning import GLACache
    from ominix_mlx_tpu_torch.models.sparse_attention import compress_keys

    eng = engine_for(cfg, params, ms)
    g = torch.Generator(device=dev).manual_seed(SEED + 56)
    for off in MINICPM_LONG_OFFSETS:
        free_device_memory()
        cache = ms.init_cache(cfg, 1, off + 128, device=dev)
        for lc in cache.layers:
            if isinstance(lc, GLACache):
                lc.state.normal_(generator=g).mul_(0.01)
            else:
                lc.k.normal_(generator=g)
                lc.v.normal_(generator=g)
                lc.comp.copy_(compress_keys(lc.k, lc.kernel_size))
        cache_gib = torch.cuda.memory_allocated() / 2 ** 30
        cache = ModelCache(layers=cache.layers, offset=off)
        tok = torch.ones(1, 1, dtype=torch.long, device=dev)
        st, wraps = minicpm_call_checks()
        walls = {"eager": [], "graph": []}
        with torch.inference_mode():
            with swapped_kernels(lambda k, kern, plain: wraps[k](kern, plain)
                                 if k in wraps and k.startswith("k11")
                                 else kern):
                logits, cache = ms.forward(params, cfg, tok, cache)
            for who in ("eager", "graph", "graph", "eager"):
                tok = logits[:, -1].argmax(-1, keepdim=True)
                if who == "graph":
                    step = eng.decode_step(cache, tok[:, 0])
                    step()                  # the warm-up and the capture
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(steps):
                    if who == "graph":
                        step()
                    else:
                        logits, cache = ms.forward(params, cfg, tok, cache)
                        tok = logits[:, -1].argmax(-1, keepdim=True)
                torch.cuda.synchronize()
                walls[who].append(time.perf_counter() - t0)
                if who == "graph":
                    logits = step.logits[:, None].clone()
                    cache = ModelCache(layers=cache.layers,
                                       offset=step.offset_host)
                    pool_mib, capture_ms = (
                        step.captured.pool_bytes / 2 ** 20,
                        step.captured.capture_ms[0])
                    if len(walls["graph"]) == 2:
                        with profile(activities=[ProfilerActivity.CUDA]) \
                                as prof:
                            for _ in range(profiled):
                                step()
                            torch.cuda.synchronize()
                    step.close()
        busy_us, by_name = device_time(prof)
        shares = kernel_shares(by_name, busy_us)
        row = {"phase": "minicpm_long_decode", "offset": off,
               "cache_gib": cache_gib, "decode_steps": steps,
               "ms_per_token": [w * 1e3 / steps for w in walls["eager"]],
               "decode_tok_s": [steps / w for w in walls["eager"]],
               "graph_ms_per_token": [w * 1e3 / steps
                                      for w in walls["graph"]],
               "graph_tok_s": [steps / w for w in walls["graph"]],
               "graph_capture_ms": capture_ms, "graph_pool_mib": pool_mib,
               "profiled_replays": profiled,
               "device_busy_ms_per_step": busy_us / 1e3 / profiled,
               "device_ops_per_step": sum(c for c, _ in by_name.values())
               / profiled,
               "k11_us_per_step": shares["k11"]["ms"] * 1e3 / profiled,
               "k11_share_of_busy": shares["k11"]["share_of_busy"],
               "k10_share_of_busy": shares["k10"]["share_of_busy"],
               "top_device": top_kernels(by_name, busy_us, 6),
               **sala_summary(st), "card": smi}
        emit(row)
        minicpm_calls_hold(st, f"decode at offset {off}")
        if set(st["k11"]["valid_blocks"]) != {64} \
                or not torch.isfinite(logits.float()).all():
            raise RuntimeError(f"decode at offset {off}: {row}")
        del cache, logits, step
    free_device_memory()


def serve_minicpm_sala(dev, smi, profile=False):
    """serve_minicpm_sala: MiniCPM-SALA at its published widths and all 32
    layers (8 InfLLMv2 sparse, 24 lightning), w8a8 g64 random weights made
    packed (about 10 GB; its reckoning and the allocation printed): the
    route of each projection; 4 HTTP chat requests one at a time (every
    prefill at exactly its length: K2 in the sparse layers, K10 in the
    form k10_plan picks; every decode step K11 and K10's recurrent form;
    K1 on panels), their launches held exactly per forward; a profiled
    128-token prefill; the logits check on 4 layers (one sparse, three
    lightning; every K10 and K11 call held against its plain version);
    a 200-token prompt's calls held likewise; the decode rate; with
    ``profile`` a profile line of decode steps; an 8192-token chunked
    prefill and 16 decode steps (the top 64 of 190 blocks); 8 concurrent
    requests on the dense batcher, each equal to the same request alone;
    decode at 65536 and 524288 cached tokens. Returns the launches of the
    runs whose every forward was counted."""
    from ominix_mlx_tpu_torch.models import base
    from ominix_mlx_tpu_torch.models import minicpm_sala as ms

    cfg = ms.MiniCPMConfig.from_hf(MINICPM_SALA_HF)
    name = "MiniCPM-SALA"
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    params = base.fuse_layer_projections(ms.init_quantized_params(
        cfg, gen, GS, 8, 8, device=dev))
    torch.cuda.synchronize()
    emit({"phase": "model", "config": name, "weights": "w8a8 g64",
          "layers": cfg.num_layers, "mixer_types": {
              m: cfg.mixer_types.count(m) for m in set(cfg.mixer_types)},
          "init_seconds": time.perf_counter() - t0,
          "reckoned_gib": minicpm_gib(cfg),
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30,
          "max_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    emit({"phase": "routes", "config": name, **minicpm_routes(params)})
    keys = ("k1_m1_w8", "k1_mn_w8", "k2", "k10_chunk", "k10_decode",
            "k11_select", "k11_attend")
    with counting_forwards(ms) as forwards:
        _, counts = serve_requests(dev, cfg, params, name.lower(), keys, ms)
    want = check_minicpm_launches(cfg, params, forwards, counts,
                                  f"{name} serve")
    emit({"phase": "serve_minicpm_sala_launches", "forwards": len(forwards),
          "launches": counts, "want": want})
    runs = [counts]
    emit({"phase": "prefill", "config": name, "weights": "w8a8 g64",
          **moe_prefill(dev, cfg, params, module=ms), "card": smi})
    check_logits(dev, cfg, params, name,
                 kernels=("k1", "k2", "k10", "k10_decode", "k11_select",
                          "k11_attend"),
                 tol=MINICPM_LOGITS_TOL, layers=4, module=ms)
    minicpm_per_call_prompt(dev, cfg, params)
    emit({**decode_rate(dev, cfg, params, 16, 48, module=ms),
          "config": name, "weights": "w8a8 g64", "card": smi})
    decode_graph(dev, cfg, params, name, "w8a8 g64", smi, ms)
    if profile:
        emit({**profile_decode(dev, cfg, params, steps=16, module=ms),
              "config": name, "weights": "w8a8 g64", "card": smi})
    runs.append(minicpm_long_prefill(dev, cfg, params))
    runs.append(hybrid_batched(
        dev, cfg, params, name.lower() + "-batched", ms,
        check=lambda c, f, la, w: check_minicpm_launches(c, params, f, la,
                                                         w)))
    runs.append(batcher_graph(dev, cfg, params, name, "w8a8 g64", smi, ms,
                              steps=16))
    runs.append(speculative(
        dev, cfg, params, name, "w8a8 g64", smi, ms, cap=4096, exact=False,
        drafts={"self_8_layers": (*self_draft(cfg, params, ms, 8), False)}))
    minicpm_long_decode(dev, cfg, params, smi)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del params
    free_device_memory()
    total = {k: sum(r.get(k, 0) for r in runs)
             for k in set().union(*runs)}
    emit({"phase": "serve_minicpm_sala", "launches": total,
          "max_memory_gib": peak, "ok": True})
    return total

def load_checkpoint(dev, smi):
    """load_checkpoint: a GLM-4-9B-width checkpoint of 2 layers in HF names
    (bf16, random from the seed, sandwich norms and biases not at their
    defaults), written by the port's writer as two shards and an index,
    loaded by registry.load_model onto the card: every tensor bit-equal to
    what was written, seconds and GB/s (from the page cache: just
    written). Then quantize_params(bits=4) plus fuse_layer_projections,
    with logits equal bit for bit to the in-memory tree's (the same
    function of the same weights), and one HTTP request through
    Server.add_model. And the same weights as an MLX-layout 4-bit
    checkpoint (uint32 words, group 64; every projection, the embedding and
    the lm_head): the loaded QuantizedTensor tree equal to
    core.quant.quantize_tensor of the weights in memory, and its logits
    (the JAX package's dequantize-then-product formula, no kernel but K2)
    equal to the in-memory QuantizedTensor tree's, bit for bit."""
    import tempfile

    from ominix_mlx_tpu_torch.core import quant
    from ominix_mlx_tpu_torch.models import base, glm4, registry
    from ominix_mlx_tpu_torch.ops import _build
    from ominix_mlx_tpu_torch.serving.server import ChatModel, Server
    from ominix_mlx_tpu_torch.utils import loading

    raw = dict(GLM4_9B_HF, num_hidden_layers=2)
    cfg = glm4.config_from_hf(raw)
    g = torch.Generator(device=dev).manual_seed(SEED + 28)
    D, hd, I = cfg.hidden_size, cfg.hd, cfg.intermediate_size

    def uniform(rows, cols):
        return ((torch.rand(rows, cols, generator=g, device=dev) * 2 - 1)
                * cols ** -0.5).bfloat16()

    def near_one():
        return (torch.rand(D, generator=g, device=dev) + 0.5).bfloat16()

    flat = {"model.embed_tokens.weight": (torch.randn(
                cfg.vocab_size, D, generator=g, device=dev) * 0.02).bfloat16(),
            "model.norm.weight": near_one(),
            "lm_head.weight": uniform(cfg.vocab_size, D)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        for n in ("input_layernorm", "post_attention_layernorm",
                  "post_self_attn_layernorm", "post_mlp_layernorm"):
            flat[f"{p}.{n}.weight"] = near_one()
        for n, rows in (("q_proj", cfg.num_heads * hd),
                        ("k_proj", cfg.num_kv_heads * hd),
                        ("v_proj", cfg.num_kv_heads * hd)):
            flat[f"{p}.self_attn.{n}.weight"] = uniform(rows, D)
            flat[f"{p}.self_attn.{n}.bias"] = (torch.randn(
                rows, generator=g, device=dev) * 0.1).bfloat16()
        flat[f"{p}.self_attn.o_proj.weight"] = uniform(D, cfg.num_heads * hd)
        flat[f"{p}.mlp.gate_up_proj.weight"] = uniform(2 * I, D)
        flat[f"{p}.mlp.down_proj.weight"] = uniform(D, I)
    nbytes = sum(t.numel() * t.element_size() for t in flat.values())
    in_memory = glm4.params_from_flat(flat, cfg)
    toks = torch.tensor([ByteTokenizer(cfg.vocab_size).encode(
        "Hello there")], device=dev)

    def logits(params):
        cache = base.init_cache(cfg, 1, 64, device=dev)
        with torch.inference_mode():
            lg, cache = base.forward(params, cfg, toks, cache,
                                     fresh_prefill=True)
            out = [lg[:, -1]]
            for t in (1, 2, 3):
                lg, cache = base.forward(params, cfg, torch.tensor(
                    [[t]], device=dev), cache)
                out.append(lg[:, -1])
        return torch.stack(out).float()

    leaves = loading.flatten_params

    row = {"phase": "load_checkpoint", "config": "GLM-4-9B", "layers": 2,
           "bytes": nbytes, "card": smi}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        loading.save_sharded(d, flat, shards=2)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(raw, f)
        row["write_seconds"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod, params, lcfg = registry.load_model(d)
        torch.cuda.synchronize()
        row["load_seconds"] = time.perf_counter() - t0
        row["load_GBps"] = nbytes / row["load_seconds"] / 1e9
    want, have = leaves(in_memory), leaves(params)
    row["tensors"] = len(have)
    row["bit_equal"] = want.keys() == have.keys() and all(
        have[k].device == dev and torch.equal(have[k].view(torch.int16),
                                              want[k].view(torch.int16))
        for k in want)
    if mod is not glm4 or lcfg != cfg or not row["bit_equal"]:
        raise RuntimeError(f"loaded checkpoint differs: {row}")
    q_loaded = base.fuse_layer_projections(base.quantize_params(
        params, GS, 4))
    del params, have
    q_memory = base.fuse_layer_projections(base.quantize_params(
        in_memory, GS, 4))
    _build.reset_launches()
    a, b = logits(q_loaded), logits(q_memory)
    row["quantized_logits_bit_equal"] = bool(torch.equal(a, b))
    row["quantized_launches"] = dict(_build.LAUNCHES)
    if not (row["quantized_logits_bit_equal"] and torch.isfinite(a).all()):
        raise RuntimeError(f"quantized loaded tree differs: {row}")
    port = free_port()
    srv = Server(port=port)
    srv.add_model("glm4-ckpt", ChatModel("glm4-ckpt", q_loaded, cfg,
                                         ByteTokenizer(cfg.vocab_size), dev,
                                         glm4))
    srv.start_background()
    try:
        text, n_prompt, n_out = chat(port, "Hi!", model="glm4-ckpt")
    finally:
        srv.shutdown()
    row.update({"request_prompt_tokens": n_prompt,
                "request_completion_tokens": n_out, "request_text": text[:40]})
    if n_out <= 0 or not text:
        raise RuntimeError("the loaded checkpoint answered nothing")
    del q_loaded, q_memory, a, b
    free_device_memory()

    # the MLX layout: uint32 words of the unsigned codes, bf16 scales and
    # biases, the config's "quantization"
    mlx, qt_memory = {}, {}
    for k, t in flat.items():
        if k.endswith(("proj.weight", "embed_tokens.weight",
                       "lm_head.weight")):
            codes, scales, biases = quant.quantize(t, GS, 4)
            stem = k[:-len(".weight")]
            mlx[k] = quant.pack_codes(codes, 4)
            mlx[stem + ".scales"], mlx[stem + ".biases"] = scales, biases
            qt_memory[stem] = quant.quantize_tensor(t, GS, 4)
        else:
            mlx[k] = t
    with tempfile.TemporaryDirectory() as d:
        loading.save_sharded(d, mlx, shards=2)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(dict(raw, quantization={"group_size": GS, "bits": 4}),
                      f)
        t0 = time.perf_counter()
        _, params, _ = registry.load_model(d)
        torch.cuda.synchronize()
        row["mlx_load_seconds"] = time.perf_counter() - t0
    lp = params["layers"][1]
    got_qt = {"model.layers.1.self_attn.q_proj": lp["q_proj"]["w"],
              "model.layers.1.mlp.gate_up_proj": lp["gate_up_proj"]["w"],
              "model.layers.1.mlp.down_proj": lp["down_proj"]["w"],
              "lm_head": params["lm_head"]["w"],
              "model.embed_tokens": params["embed"]}
    row["mlx_quantized_equal"] = all(
        isinstance(w, quant.QuantizedTensor)
        and torch.equal(w.q, qt_memory[k].q)
        and torch.equal(w.scales.view(torch.int16),
                        qt_memory[k].scales.view(torch.int16))
        and torch.equal(w.biases.view(torch.int16),
                        qt_memory[k].biases.view(torch.int16))
        for k, w in got_qt.items())
    memory_tree = glm4.params_from_flat(flat, cfg)
    for i, lpm in enumerate(memory_tree["layers"]):
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            lpm[n]["w"] = qt_memory[f"model.layers.{i}.self_attn.{n}"]
        for n in ("gate_up_proj", "down_proj"):
            lpm[n]["w"] = qt_memory[f"model.layers.{i}.mlp.{n}"]
    memory_tree["lm_head"]["w"] = qt_memory["lm_head"]
    memory_tree["embed"] = qt_memory["model.embed_tokens"]
    a, b = logits(params), logits(memory_tree)
    row["mlx_logits_bit_equal"] = bool(torch.equal(a, b))
    emit(row)
    if not (row["mlx_quantized_equal"] and row["mlx_logits_bit_equal"]
            and torch.isfinite(a).all()):
        raise RuntimeError(f"MLX-layout checkpoint differs: {row}")
    del params, memory_tree, flat, mlx, qt_memory, in_memory
    free_device_memory()
    return row["quantized_launches"]


# ------------------------------------------------- VLM and OCR pipelines ----

# serve_moxin / serve_ocr2: tokens each image request decodes in the
# kernel-vs-plain comparison, and the rows of its report
IMAGE_DECODE = 16


def image_png(h: int, w: int, seed: int) -> bytes:
    """A random RGB image of h x w as PNG bytes."""
    import io

    import numpy as np
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


def one_page_pdf(seed: int) -> bytes:
    """A one-page PDF holding one embedded JPEG page (768 x 576), built in
    memory as tests/test_vlm.py builds one."""
    import io

    import numpy as np
    from PIL import Image

    img = Image.fromarray(np.random.default_rng(seed).integers(
        0, 256, (768, 576, 3), np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="JPEG")
    jpeg = buf.getvalue()
    return (b"%PDF-1.4\n1 0 obj\n<< /Subtype /Image /Width 576 /Height 768 "
            b"/ColorSpace /DeviceRGB /BitsPerComponent 8 /Filter /DCTDecode "
            b"/Length " + str(len(jpeg)).encode() + b" >>\nstream\n"
            + jpeg + b"\nendstream\nendobj\n%%EOF")


def post_json(port, path, body) -> dict:
    """POST a JSON body to ``path``; the JSON answer (raises unless 200)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            raise RuntimeError(f"{path}: HTTP {r.status}")
        return json.loads(r.read())


def wall_ms(call, n: int = 3) -> float:
    """Best host wall time of ``call`` over n runs after one warm-up, each
    ended by a synchronize (a whole stage: towers, a prefill)."""
    with torch.inference_mode():
        call()
        best = float("inf")
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def pipeline_decode_rate(model, image, ids, short=16, long=64,
                         prefill=None) -> dict:
    """The replayed decode tok/s of a pipeline's request (prefill, then
    ``engine().decode``'s captured step): the difference quotient of
    ``long`` and ``short`` tokens, best of 2 each, so the prefill and the
    step's capture cancel. ``prefill(n)`` (default ``model.prefill(image,
    ids, n)``) gives the last logits and the cache."""
    prefill = prefill or (lambda n: model.prefill(image, ids, n))

    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(n)
        toks = list(model.engine().decode(logits, cache, n))
        if len(toks) != n:
            raise RuntimeError(f"decode stopped at {len(toks)} of {n}")
        return time.perf_counter() - t0

    run(short)
    t_short = min(run(short) for _ in range(2))
    t_long = min(run(long) for _ in range(2))
    tps = (long - short) / (t_long - t_short)
    return {"decode_tok_s": tps, "ms_per_token": 1e3 / tps,
            f"t{short}_s": t_short, f"t{long}_s": t_long}


def pipeline_vs_plain(dev, model, image, ids, tol, name,
                      n=IMAGE_DECODE) -> dict:
    """One image request through the kernels (the prefill, then the
    engine's captured decode: the served path) against the same request
    with every kernel swapped for its plain version (``plain_kernels``:
    the prefill, then eager greedy steps fed the kernel run's tokens).
    Held: the prefill's last-position logits within ``tol`` (max error
    over max |plain|), and at every step where the two greedy choices
    differ, a near-tie: the plain logit of the kernel's token within
    ``tol`` x max |plain logits| of the plain maximum. Reported: how many
    of the ``n`` tokens the plain run chose alike (all, where every step
    agrees: then the plain run's own greedy tokens are the kernel run's)."""
    from ominix_mlx_tpu_torch.models import base

    with torch.inference_mode():
        lk, cache = model.prefill(image, ids, n)
        lk = lk.float()
        toks = list(model.engine().decode(lk, cache, n))
        del cache
        with plain_kernels():
            lp, cache = model.prefill(image, ids, n)
            lp = lp.float()
            lg, gaps, same = lp, [], 0
            for i, t in enumerate(toks):
                top = int(lg.argmax(-1)[0])
                same += top == t
                if top != t:
                    gaps.append(float(lg[0, top] - lg[0, t])
                                / float(lg.abs().max()))
                if i + 1 < len(toks):
                    lg, cache = base.forward(
                        model.lm_params, model.lm_cfg,
                        torch.tensor([[t]], device=dev), cache)
                    lg = lg[:, -1].float()
    rel = rel_to(lk, lp)
    row = {"phase": "pipeline_vs_plain", "config": name, "prompt": len(ids),
           "tokens": len(toks), "plain_greedy_equal": same,
           "tokens_kernel": toks, "logits_rel_err": rel,
           "differing_steps_gap_rel": gaps, "limit": tol}
    emit(row)
    if not rel < tol or any(g >= tol for g in gaps) or not toks:
        raise RuntimeError(f"{name}: kernel vs plain request: {row}")
    return row


def moxin_7b(dev, gen):
    """Moxin-7B at its published widths, random weights: DINOv2 ViT-L/14
    with 4 registers and SigLIP SO400M/14 at 224 px, bf16; the Prismatic
    projector 2176 -> 8704 -> 4096 -> 4096; the Mistral-7B decoder of
    benchmarks/pipelines_bench.py:386-416 (vocabulary 32000, 4096 wide, 32
    layers, 32 / 8 heads of 128, FFN 14336, theta 1e6) at w8a8 g64 with
    fused projections, as its moxin_vlm_decoder_w8a8 builds it."""
    from ominix_mlx_tpu_torch.models import base, moxin_vlm, vit

    lm_cfg = base.TransformerConfig(
        vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
        num_kv_heads=8, head_dim=128, intermediate_size=14336,
        rope_theta=1000000.0, tie_word_embeddings=False)
    dcfg, scfg = vit.DINOV2_LARGE, vit.SIGLIP_SO400M
    return moxin_vlm.MoxinVLM(
        dino_params=vit.init_params(dcfg, gen, torch.bfloat16, dev),
        dino_cfg=dcfg,
        siglip_params=vit.init_params(scfg, gen, torch.bfloat16, dev),
        siglip_cfg=scfg,
        projector=moxin_vlm.init_projector(
            gen, (dcfg.hidden_size + scfg.hidden_size, 8704, 4096, 4096),
            torch.bfloat16, dev),
        lm_params=base.fuse_layer_projections(base.init_quantized_params(
            lm_cfg, gen, GS, 8, act_bits=8, device=dev)),
        lm_cfg=lm_cfg, device=dev)


def serve_moxin(dev, smi, profile=False):
    """serve_moxin: Moxin-7B (``moxin_7b``) registered with
    ``Server.add_model`` beside its own decoder as a chat model; over HTTP
    at once, a content-array chat with a 320x240 PNG data URI (``chat``
    resizes it to 224), a /v1/describe of a 224-px PNG and a plain chat on
    the decoder, each answered; the launches of K2 and K1's 8-bit P
    formula held; then the towers' ms, the decoder's prefill ms at its T,
    the replayed decode tok/s, the decoder's logits check on a 2-layer
    cut, and the request against its plain version (``pipeline_vs_plain``);
    with ``profile``, a profile line of the decoder's replayed steps.
    Returns the launches of the HTTP run."""
    import base64
    import threading

    from ominix_mlx_tpu_torch.models import base, moxin_vlm, vit
    from ominix_mlx_tpu_torch.nn.layers import resize_bilinear
    from ominix_mlx_tpu_torch.ops import _build
    from ominix_mlx_tpu_torch.serving.server import ChatModel, Server

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 70)
    m = moxin_7b(dev, gen)
    cfg = m.lm_cfg
    torch.cuda.synchronize()
    emit({"phase": "model", "config": "Moxin-7B", "weights":
          "towers and projector bf16, decoder w8a8 g64",
          "init_seconds": time.perf_counter() - t0,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    srv = Server(port=free_port())
    srv.add_model("moxin-7b", m)
    srv.add_model("mistral-7b", ChatModel("mistral-7b", m.lm_params, cfg,
                                          ByteTokenizer(cfg.vocab_size), dev))
    srv.start_background()
    png320 = image_png(240, 320, SEED + 71)
    png224 = image_png(224, 224, SEED + 72)
    calls = {
        "image_chat": lambda: post_json(srv.port, "/v1/chat/completions", {
            "model": "moxin-7b", "max_tokens": MAX_TOKENS, "messages": [
                {"role": "user", "content": [
                    {"type": "text", "text": "What is in this picture?"},
                    {"type": "image_url", "image_url": {
                        "url": "data:image/png;base64,"
                        + base64.b64encode(png320).decode()}}]}]}),
        "describe": lambda: post_json(srv.port, "/v1/describe", {
            "model": "moxin-7b", "max_tokens": MAX_TOKENS,
            "image": base64.b64encode(png224).decode()}),
        "chat": lambda: post_json(srv.port, "/v1/chat/completions", {
            "model": "mistral-7b", "max_tokens": MAX_TOKENS,
            "messages": [{"role": "user", "content": "Tell me a story."}]}),
    }
    got, errs = {}, []

    def one(k):
        try:
            t = time.perf_counter()
            got[k] = (calls[k](), time.perf_counter() - t)
        except Exception as e:        # raised below
            errs.append((k, e))

    try:
        _build.reset_launches()
        threads = [threading.Thread(target=one, args=(k,)) for k in calls]
        t_http = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t_http
        counts = dict(_build.LAUNCHES)
    finally:
        srv.shutdown()
    if errs or len(got) != len(calls):
        raise RuntimeError(f"serve_moxin requests failed: {errs}")
    texts = {"image_chat": got["image_chat"][0]["choices"][0]["message"][
                 "content"],
             "describe": got["describe"][0]["description"],
             "chat": got["chat"][0]["choices"][0]["message"]["content"]}
    # without a tokenizer a VLM answers its token ids, one word each
    n_out = {"image_chat": len(texts["image_chat"].split()),
             "describe": got["describe"][0]["tokens"],
             "chat": got["chat"][0]["usage"]["completion_tokens"]}
    steps = sum(max(n - 1, 0) for n in n_out.values())
    per_step = 4 * cfg.num_layers + 1
    row = {"phase": "serve_moxin_requests", "seconds": {
               k: v[1] for k, v in got.items()}, "wall_s": wall,
           "completion_tokens": n_out, "text": {k: v[:60]
                                                for k, v in texts.items()},
           "describe_tokens_per_second":
               got["describe"][0]["tokens_per_second"],
           "launches": counts, "card": smi}
    emit(row)
    if not all(texts.values()) or counts.get("k2", 0) < 3 \
            or counts.get("k1_m1_w8", 0) < per_step * steps:
        raise RuntimeError(f"serve_moxin: answers or launches: {row}")

    # the same image chat straight through the model: HTTP routes nothing
    # else in (greedy, so the text is the served one)
    with torch.inference_mode():
        direct = m.chat("What is in this picture?", card_image(png320, dev),
                        max_tokens=MAX_TOKENS)
    if direct != texts["image_chat"]:
        raise RuntimeError("serve_moxin: the served image chat differs "
                           "from the model's own chat")
    size = m.dino_cfg.image_size
    image = card_image(png224, dev)
    if image.shape[1:3] != (size, size):        # the rehearsal's towers
        image = resize_bilinear(image, size, size)
    ids = [1] + [ord(c) % cfg.vocab_size for c in
                 "In: Describe this image in detail.\nOut:"][:32]
    dino_in, sig_in = (x.to(torch.bfloat16)
                       for x in moxin_vlm.preprocess(image))
    embeds = m.prepare_inputs(image, ids)
    T = embeds.shape[1]
    stages = {"dino_ms": wall_ms(lambda: vit.encode(
                  m.dino_params, m.dino_cfg, dino_in)),
              "siglip_ms": wall_ms(lambda: vit.encode(
                  m.siglip_params, m.siglip_cfg, sig_in)),
              "encode_image_ms": wall_ms(lambda: m.encode_image(image)),
              "prefill_ms": wall_ms(lambda: base.forward_embeds(
                  m.lm_params, cfg, embeds,
                  base.init_cache(cfg, 1, T + 8, device=dev),
                  fresh_prefill=True)),
              "prefill_T": T,
              "image_tokens": (size // m.dino_cfg.patch_size) ** 2}
    rate = pipeline_decode_rate(m, image, ids)
    emit({"phase": "moxin_split", **stages, **rate,
          "describe_ms_est": stages["encode_image_ms"]
          + stages["prefill_ms"] + MAX_TOKENS * rate["ms_per_token"],
          "card": smi})
    check_logits(dev, cfg, m.lm_params, "Moxin-7B decoder w8a8",
                 tol=W8A8_PANELS_LOGITS_TOL)
    pipeline_vs_plain(dev, m, image, ids, IMAGE_LOGITS_TOL, "Moxin-7B")
    if profile:
        emit({**profile_decode(dev, cfg, m.lm_params),
              "config": "Moxin-7B decoder", "weights": "w8a8 g64",
              "card": smi})
    del m, srv, embeds
    free_device_memory()
    emit({"phase": "serve_moxin", "launches": counts, "ok": True})
    return counts


def card_image(png: bytes, dev) -> torch.Tensor:
    """PNG bytes -> [1, H, W, 3] float32 in [0, 1] on ``dev``, as the
    server decodes an image."""
    from ominix_mlx_tpu_torch.serving.server import _decode_image

    return torch.from_numpy(_decode_image(png))[None].to(dev)


def deepseek_ocr2_model(dev, gen):
    """DeepSeek-OCR-2 at its published widths, random weights: SAM ViT-B/16
    at 1024 px with the 896-channel adapter (deepseek_ocr2.py:350 of the
    JAX package), the 24-layer Qwen2 visual flow (896 wide, 14 / 2 heads,
    FFN 4864, theta 1e6, query banks of 144 and 256), all bf16; the 896 ->
    1280 projector; the decoder of ``config_from_hf({})`` (12 layers, 10
    heads MHA, 64 experts top 6 and 2 shared, layer 0 dense) at w4a8 g64
    with fused projections."""
    from ominix_mlx_tpu_torch.models import base, deepseek_ocr2, sam_vit

    scfg = sam_vit.SamViTConfig(adapter_chans=896)
    fcfg = deepseek_ocr2.visual_flow_config()
    flow = base.init_params(fcfg, gen, torch.bfloat16, dev)
    flow = {"layers": flow["layers"], "norm": flow["norm"],
            **{f"query_{px}": (torch.randn(n, fcfg.hidden_size, generator=gen,
                                           device=dev) * 0.02).bfloat16()
               for px, n in ((768, 144), (1024, 256))}}
    cfg = deepseek_ocr2.config_from_hf({})
    w = torch.rand(cfg.hidden_size, fcfg.hidden_size, generator=gen,
                   device=dev) * 2 - 1
    return deepseek_ocr2.DeepSeekOCR2(
        vision_params=sam_vit.init_params(scfg, gen, torch.bfloat16, dev),
        vision_cfg=scfg,
        projector={"w": (w * fcfg.hidden_size ** -0.5).bfloat16(),
                   "b": torch.zeros(cfg.hidden_size, dtype=torch.bfloat16,
                                    device=dev)},
        lm_params=base.fuse_layer_projections(base.init_quantized_params(
            cfg, gen, GS, 4, act_bits=8, device=dev, dense_layers=1)),
        lm_cfg=cfg, flow_params=flow, flow_cfg=fcfg,
        view_separator=(torch.randn(cfg.hidden_size, generator=gen,
                                    device=dev) * 0.02).bfloat16(),
        device=dev)


def serve_ocr2(dev, smi, profile=False):
    """serve_ocr2: DeepSeek-OCR-2 (``deepseek_ocr2_model``) registered with
    ``Server.add_model``; over HTTP, /v1/ocr on an 800x600 PNG (resized to
    1024) and on a one-page PDF built in memory, each answered; the
    launches of K2, K5 (packed 4-bit experts at the prefill), K4 (gate and
    up at every decode step) and K1 held; then SAM's and the visual
    flow's ms, the decoder's prefill ms at its T, the replayed decode
    tok/s and the gathered K = 896 down projection's share of a decode
    step (the route K4 does not take: ROADMAP gap #1), the decoder's
    logits check on a 2-layer cut (layer 0 dense, layer 1 MoE), and the
    request against its plain version; with ``profile``, a profile line
    of the decoder's replayed steps. Returns the launches of the HTTP
    run."""
    import base64

    from ominix_mlx_tpu_torch.models import base, deepseek_ocr2, sam_vit
    from ominix_mlx_tpu_torch.nn.layers import resize_bilinear
    from ominix_mlx_tpu_torch.ops import _build
    from ominix_mlx_tpu_torch.ops import quant_matmul as qm
    from ominix_mlx_tpu_torch.serving.server import Server

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 80)
    m = deepseek_ocr2_model(dev, gen)
    cfg = m.lm_cfg
    torch.cuda.synchronize()
    emit({"phase": "model", "config": "DeepSeek-OCR-2", "weights":
          "SAM, flow and projector bf16, decoder w4a8 g64",
          "init_seconds": time.perf_counter() - t0,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    emit({"phase": "routes", "config": "DeepSeek-OCR-2",
          **projection_routes(cfg, m.lm_params, 1)})
    srv = Server(port=free_port())
    srv.add_model("deepseek-ocr2", m)
    srv.start_background()
    png = image_png(600, 800, SEED + 81)
    got = {}
    try:
        _build.reset_launches()
        for key, body in (("image", {"image": base64.b64encode(png).decode()}),
                          ("pdf", {"pdf": base64.b64encode(
                              one_page_pdf(SEED + 82)).decode()})):
            t = time.perf_counter()
            got[key] = (post_json(srv.port, "/v1/ocr", {
                "model": "deepseek-ocr2", "max_tokens": MAX_TOKENS, **body}),
                time.perf_counter() - t)
        counts = dict(_build.LAUNCHES)
    finally:
        srv.shutdown()
    texts = {"image": got["image"][0]["text"],
             "pdf": got["pdf"][0]["pages"]}
    n_out = {"image": len(texts["image"].split()),
             "pdf": sum(len(p.split()) for p in texts["pdf"])}
    steps = sum(max(n - 1, 0) for n in n_out.values())
    moe_layers = cfg.num_layers - 1
    row = {"phase": "serve_ocr2_requests",
           "seconds": {k: v[1] for k, v in got.items()},
           "completion_tokens": n_out, "pages": len(texts["pdf"]),
           "text": {"image": texts["image"][:60],
                    "pdf": [p[:60] for p in texts["pdf"]]},
           "launches": counts, "card": smi}
    emit(row)
    if not texts["image"] or len(texts["pdf"]) != 1 \
            or counts.get("k2", 0) < 2 \
            or counts.get("k5_w4", 0) < 2 * 3 * moe_layers \
            or counts.get("k4", 0) < moe_layers * steps \
            or counts.get("k1_m1", 0) < steps:
        raise RuntimeError(f"serve_ocr2: answers or launches: {row}")

    size = m.image_size
    with torch.inference_mode():
        image = resize_bilinear(card_image(png, dev), size, size)
        x = (image * 2 - 1).to(torch.bfloat16)
        feats = sam_vit.encode(m.vision_params, m.vision_cfg, x)
    ids = m.prompt_ids("Free OCR.")
    embeds = m.prepare_inputs(image, ids)
    T = embeds.shape[1]
    stages = {"sam_ms": wall_ms(lambda: sam_vit.encode(
                  m.vision_params, m.vision_cfg, x)),
              "flow_ms": wall_ms(lambda: deepseek_ocr2.visual_flow_encode(
                  m.flow_params, m.flow_cfg, feats)),
              "encode_page_ms": wall_ms(lambda: m.encode_page(image)),
              "prefill_ms": wall_ms(lambda: base.forward_embeds(
                  m.lm_params, cfg, embeds,
                  base.init_cache(cfg, 1, T + 8, device=dev),
                  fresh_prefill=True)),
              "prefill_T": T, "image_tokens": m.n_image_tokens}
    rate = pipeline_decode_rate(m, image, ids, 16, 48)
    down = m.lm_params["layers"][1]["moe"]["experts"]["down_proj"]
    route = qm.expert_route(down, 1)
    k = cfg.moe.top_k
    h = torch.randn(k, down.in_features, generator=gen,
                    device=dev).bfloat16()
    ids_k = torch.randint(0, cfg.moe.num_experts, (k, 1), generator=gen,
                          device=dev, dtype=torch.int32)
    # timed as a decode step runs it: replayed from a CUDA graph (eager,
    # its dozen small ops would time the host's launches)
    with torch.inference_mode():
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            qm.gather_qmm(h, down, ids_k)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            qm.gather_qmm(h, down, ids_k)
    buf = torch.zeros(256 << 20, dtype=torch.uint8, device=dev)
    ms = time_ms(graph.replay, 10, l2_flush(buf))
    del buf, graph
    emit({"phase": "ocr2_split", **stages, **rate,
          "ocr_ms_est": stages["encode_page_ms"] + stages["prefill_ms"]
          + MAX_TOKENS * rate["ms_per_token"],
          "down_proj": {"N": down.data.shape[1], "K": down.in_features,
                        "route": route, "ms": ms,
                        "calls_per_token": moe_layers,
                        "share_of_decode_step":
                            moe_layers * ms / rate["ms_per_token"]},
          "card": smi})
    if route != "gathered":
        raise RuntimeError(f"OCR-2's K = 896 down projection takes {route}")
    check_logits(dev, cfg, m.lm_params, "DeepSeek-OCR-2 decoder w4a8",
                 tol=OCR2_LOGITS_TOL)
    pipeline_vs_plain(dev, m, image, ids, IMAGE_LOGITS_TOL,
                      "DeepSeek-OCR-2")
    if profile:
        emit({**profile_decode(dev, cfg, m.lm_params, steps=16),
              "config": "DeepSeek-OCR-2 decoder", "weights": "w4a8 g64",
              "card": smi})
    del m, srv, embeds, feats
    free_device_memory()
    emit({"phase": "serve_ocr2", "launches": counts, "ok": True})
    return counts


# ------------------------------------------------------------------ ASR -----

ASR_SECONDS = 30
ASR_LONG_SECONDS = 45            # two chunks of Fun-ASR-Nano's long path
ASR_RATE = 16000
K12_DESIGN = ("one launch, a CTA of 128 columns of one row (grid: columns x "
              "rows): the row's alphas staged in shared memory, its thread "
              "0 runs the scalar integrate-and-fire scan and leaves each "
              "frame's weight, remainder and fire flag in shared memory, "
              "then every thread walks its column through the frames in "
              "loop order (products and sums rounded apart, __fmul_rn and "
              "__fadd_rn), writing each fired frame and zeroing the rows "
              "past the count: the plain loop's bits; the CTAs of a row "
              "repeat its scan")


def qwen3_0p6b():
    """The Qwen3-0.6B decoder of benchmarks/pipelines_bench.py:70-73 (the
    qwen3_asr_0p6b_rtf row), copied: vocabulary 151936, 1024 wide, 28
    layers, 16 / 8 heads of 128, FFN 3072, QK-norm, tied embeddings."""
    from ominix_mlx_tpu_torch.models import base

    return base.TransformerConfig(
        vocab_size=151936, hidden_size=1024, num_layers=28, num_heads=16,
        num_kv_heads=8, head_dim=128, intermediate_size=3072,
        use_qk_norm=True, tie_word_embeddings=True)


def asr_wav(seconds: float, seed: int, rate: int = ASR_RATE) -> bytes:
    """A seeded mono 16-bit WAV: a few tones whose pitch wanders, and
    noise."""
    import io
    import wave

    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    x = sum(0.1 * np.sin(2 * np.pi * f * t * (1 + 0.05 * np.sin(t * w)))
            for f, w in ((180, 0.7), (420, 1.3), (1100, 0.4)))
    x = x + 0.02 * rng.normal(size=t.shape)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def wav_samples(data: bytes):
    """The samples and rate the audio routes decode from ``data``."""
    import io
    import wave

    import numpy as np

    from ominix_mlx_tpu_torch import native

    with wave.open(io.BytesIO(data), "rb") as w:
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    return native.pcm16_to_float(np.frombuffer(raw, np.int16)), rate


def post_audio(port, path: str, data: bytes) -> dict:
    """POST raw WAV bytes; the JSON answer (raises unless 200)."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            raise RuntimeError(f"{path}: HTTP {r.status}")
        return json.loads(r.read())


def serve_audio(name, model, requests):
    """Each (route, WAV bytes) of ``requests`` over HTTP to a server
    holding ``model`` alone, one after another: (answers, seconds, the
    launches of all of them)."""
    from ominix_mlx_tpu_torch.ops import _build
    from ominix_mlx_tpu_torch.serving.server import Server

    srv = Server(port=free_port())
    srv.add_model(name, model)
    srv.start_background()
    out, secs = [], []
    try:
        _build.reset_launches()
        for path, data in requests:
            t = time.perf_counter()
            out.append(post_audio(srv.port, path, data)["text"])
            secs.append(time.perf_counter() - t)
        counts = dict(_build.LAUNCHES)
    finally:
        srv.shutdown()
    return out, secs, counts


def check_k12(dev, flush, enc, alphas, cfg):
    """K12 against cif_reference on the encoder output and alphas of the
    phase's 30 s clip (bf16, [1, 501, 512]) and on three rows of ragged
    fires built from them (the alphas scaled by 0.5 and 1.6: a row that
    fires about half as often and one that fires at most frames): frames
    and counts bit for bit; timed beside the bound (bytes) and the plain
    loop. No PyTorch call computes CIF."""
    from ominix_mlx_tpu_torch.ops import cif as tcif

    rows = []
    a3 = torch.cat([alphas, alphas * 0.5, (alphas * 1.6).clamp(max=0.999)])
    for h, a in ((enc, alphas), (enc.expand(3, -1, -1).contiguous(), a3)):
        B, T, D = h.shape
        th, tail = cfg.cif_threshold, cfg.cif_tail_threshold
        got = tcif._k12(h, a, th, tail, T)
        want = tcif.cif_reference(h, a, th, tail)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got[0], want[0])
                     and torch.equal(got[1], want[1]))
        row = {"B": B, "T": T, "D": D, "counts": got[1].tolist(),
               "bitwise_equal": equal,
               "max_abs_err": (got[0] - want[0]).abs().max().item(),
               "ms": time_ms(lambda: tcif._k12(h, a, th, tail, T), 10,
                             flush),
               "plain_ms": time_ms(lambda: tcif.cif_reference(
                   h, a, th, tail), 3, flush),
               "library_ms": None,
               "library_error": "no PyTorch call computes CIF",
               **bound(tcif.k12_bytes(B, T, D, T), 0, "fp32")}
        row.update(versus(row))
        emit({"phase": "k12", **row})
        if not equal:
            raise RuntimeError(f"K12 B={B}: not its plain loop's bits: "
                               f"{row}")
        rows.append(row)
    return rows


def paraformer_large(dev, gen):
    """Paraformer-large at its published widths (FunASR's paraformer-large:
    ParaformerConfig(), 50 + 16 blocks, 512 wide, vocabulary 8404), random
    bf16 weights, as benchmarks/pipelines_bench.py:39-60 builds it."""
    from ominix_mlx_tpu_torch.models import paraformer as pf

    cfg = pf.ParaformerConfig()
    return pf.Transcriber(params=pf.init_params(cfg, gen, torch.bfloat16,
                                                dev), cfg=cfg, device=dev)


def serve_paraformer(dev, smi):
    """serve_paraformer: Paraformer-large (``paraformer_large``) registered
    with ``Server.add_model``; a 30 s seeded WAV to
    /v1/audio/transcriptions answered with the text of the model's own
    ``transcribe`` (token ids, no token table), K12 launched once and the
    plain loop never; then K12 against its plain version at the clip's
    shapes (``check_k12``), the split (front end, encoder, alphas, CIF,
    decoder) and the RTF (wall seconds of a transcription per second of
    audio). Returns (the launches of the HTTP run, K12's rows)."""
    from ominix_mlx_tpu_torch.models import paraformer as pf
    from ominix_mlx_tpu_torch.ops import cif as tcif

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    m = paraformer_large(dev, gen)
    cfg = m.cfg
    torch.cuda.synchronize()
    emit({"phase": "model", "config": "Paraformer-large", "weights": "bf16",
          "init_seconds": time.perf_counter() - t0,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    data = asr_wav(ASR_SECONDS, SEED + 91)
    plain = tcif.cif_reference

    def refuse(*a, **k):
        raise RuntimeError("a CUDA tensor took CIF's plain loop")

    tcif.cif_reference = refuse
    try:
        texts, secs, counts = serve_audio(
            "paraformer-large", m,
            [("/v1/audio/transcriptions", data)])
    finally:
        tcif.cif_reference = plain
    x, rate = wav_samples(data)
    direct = m.transcribe(x, rate)
    row = {"phase": "serve_paraformer_request", "seconds": secs[0],
           "tokens": len(texts[0].split()), "text": texts[0][:60],
           "launches": counts, "card": smi}
    emit(row)
    if texts[0] != direct or not texts[0] or counts.get("k12", 0) != 1:
        raise RuntimeError(f"serve_paraformer: answer or launches: {row}")

    with torch.inference_mode():
        samples = torch.from_numpy(x).to(dev)
        feats = m.features(samples, rate).to(torch.bfloat16)
        enc = pf.encode(m.params, cfg, feats)
        alphas = pf.predict_alphas(m.params["predictor"], enc)
        frames, n = tcif.cif(enc, alphas)
        frames = frames.to(enc.dtype)
        flush_buf = torch.zeros(256 << 20, dtype=torch.uint8, device=dev)
        rows = check_k12(dev, l2_flush(flush_buf), enc, alphas, cfg)
        del flush_buf
        stages = {
            "frontend_ms": wall_ms(lambda: m.features(samples, rate)),
            "encoder_ms": wall_ms(lambda: pf.encode(m.params, cfg, feats)),
            "alphas_ms": wall_ms(lambda: pf.predict_alphas(
                m.params["predictor"], enc)),
            "cif_ms": wall_ms(lambda: tcif.cif(enc, alphas)),
            "decoder_ms": wall_ms(lambda: pf.decode(m.params, cfg, frames,
                                                    enc)),
            "transcribe_ms": wall_ms(lambda: m.transcribe(x, rate), 2)}
    emit({"phase": "paraformer_split", "audio_s": ASR_SECONDS,
          "lfr_frames": enc.shape[1], "tokens": int(n[0]), **stages,
          "rtf": stages["transcribe_ms"] / 1e3 / ASR_SECONDS,
          "k12_launches_per_transcription": counts.get("k12", 0),
          "card": smi})
    del m, enc, alphas, frames, feats
    free_device_memory()
    emit({"phase": "serve_paraformer", "launches": counts, "ok": True})
    return counts, rows


def asr_decoder_checks(dev, name, m, prefill, smi, tol):
    """The decoder's split and checks for an ASR phase: its prefill's ms at
    the spliced prompt's T (``prefill(n)``: the prompt into a cache for n
    tokens, (last logits, cache)), the replayed decode tok/s (the
    difference quotient of 16 and 64 tokens), and ``check_logits`` on a
    2-layer cut."""
    logits, cache = prefill(8)
    T = cache.offset
    del logits, cache
    rate = pipeline_decode_rate(m, None, None, prefill=prefill)
    check_logits(dev, m.lm_cfg, m.lm_params, f"{name} decoder", tol=tol)
    return {"prefill_T": T, "prefill_ms": wall_ms(lambda: prefill(8)),
            **rate}


def serve_qwen3_asr(dev, smi):
    """serve_qwen3_asr: Qwen3-ASR with the default AuT encoder (bf16; output
    2048, cut to the decoder's 1024 as the JAX package does) and the
    Qwen3-0.6B decoder (``qwen3_0p6b``) at w8a8 g64 on panels (the 8-bit
    of BASELINE.md:17), random weights; a 30 s seeded WAV to
    /v1/audio/transcriptions answered with the model's own ``transcribe``
    (no tokenizer: 256 greedy token ids), K2 launched once a layer at the
    spliced prefill and K1's 8-bit P formula at every decode step; the
    split (front end, encoder, prefill, replayed decode), the RTF, and
    the decoder's logits check on 2 layers. Returns the launches of the
    HTTP run."""
    from ominix_mlx_tpu_torch.models import base
    from ominix_mlx_tpu_torch.models import qwen3_asr as qa

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 92)
    ecfg, lcfg = qa.AudioEncoderConfig(), qwen3_0p6b()
    m = qa.Qwen3ASR(
        enc_params=qa.init_encoder_params(ecfg, gen, torch.bfloat16, dev),
        enc_cfg=ecfg,
        lm_params=base.fuse_layer_projections(base.init_quantized_params(
            lcfg, gen, GS, 8, act_bits=8, device=dev)),
        lm_cfg=lcfg, device=dev)
    torch.cuda.synchronize()
    emit({"phase": "model", "config": "Qwen3-ASR-0.6B", "weights":
          "AuT encoder bf16, decoder w8a8 g64",
          "init_seconds": time.perf_counter() - t0,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    data = asr_wav(ASR_SECONDS, SEED + 93)
    texts, secs, counts = serve_audio(
        "qwen3-asr", m, [("/v1/audio/transcriptions", data)])
    x, rate = wav_samples(data)
    direct = m.transcribe(x, rate)
    steps = len(texts[0].split()) - 1
    L = lcfg.num_layers
    row = {"phase": "serve_qwen3_asr_request", "seconds": secs[0],
           "tokens": steps + 1, "text": texts[0][:60], "launches": counts,
           "card": smi}
    emit(row)
    if texts[0] != direct or counts.get("k2", 0) != L \
            or counts.get("k1_m1_w8", 0) < 4 * L * steps:
        raise RuntimeError(f"serve_qwen3_asr: answer or launches: {row}")

    with torch.inference_mode():
        samples = torch.from_numpy(x).to(dev)
        feats = m.encode_audio(x)[:, :lcfg.hidden_size]
        mel = m.mel(samples)
        n = mel.shape[1]
        mel = torch.nn.functional.pad(mel, (0, (-n) % ecfg.chunk_frames)) \
            .to(torch.bfloat16)
        pre, suf, _ = m.prompt_ids()
        stages = {"frontend_ms": wall_ms(lambda: m.mel(samples)),
                  "encoder_ms": wall_ms(lambda: qa.encode(
                      m.enc_params, ecfg, mel, n)),
                  "audio_tokens": feats.shape[0],
                  **asr_decoder_checks(
                      dev, "Qwen3-ASR-0.6B w8a8", m,
                      lambda k: m.prefill(feats, pre, suf, k), smi,
                      W8A8_PANELS_LOGITS_TOL),
                  "transcribe_ms": wall_ms(lambda: m.transcribe(x, rate),
                                           2)}
    emit({"phase": "qwen3_asr_split", "audio_s": ASR_SECONDS, **stages,
          "tokens": steps + 1,
          "rtf": stages["transcribe_ms"] / 1e3 / ASR_SECONDS,
          "k2_per_request": counts.get("k2", 0),
          "k1_m1_w8_per_request": counts.get("k1_m1_w8", 0),
          "card": smi})
    del m, feats, mel
    free_device_memory()
    emit({"phase": "serve_qwen3_asr", "launches": counts, "ok": True})
    return counts


def serve_funasr_nano(dev, smi):
    """serve_funasr_nano: Fun-ASR-Nano with the Paraformer-large SAN-M
    encoder, ``AdaptorConfig()`` and the Qwen3-0.6B decoder
    (``qwen3_0p6b``), all bf16, random weights; a 30 s seeded WAV to
    /v1/audio/transcriptions and a 45 s one to /v1/audio/translations
    (past 30 s: ``translate_long``, two chunks), each answered with the
    model's own ``transcribe`` / ``translate_long`` (256 greedy token ids
    a chunk), K2 launched once a layer at each of the three spliced
    prefills; the split, the RTF and the decoder's logits check on 2
    layers. Returns the launches of the HTTP run."""
    from ominix_mlx_tpu_torch.models import base, funasr_nano
    from ominix_mlx_tpu_torch.models import paraformer as pf

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 94)
    ecfg, acfg, lcfg = pf.ParaformerConfig(), funasr_nano.AdaptorConfig(), \
        qwen3_0p6b()
    m = funasr_nano.FunASRNano(
        enc_params=pf.init_params(ecfg, gen, torch.bfloat16, dev),
        enc_cfg=ecfg,
        adaptor_params=funasr_nano.init_adaptor(acfg, gen, torch.bfloat16,
                                                dev),
        adaptor_cfg=acfg,
        lm_params=base.fuse_layer_projections(base.init_params(
            lcfg, gen, torch.bfloat16, dev)),
        lm_cfg=lcfg, device=dev)
    torch.cuda.synchronize()
    emit({"phase": "model", "config": "Fun-ASR-Nano", "weights": "bf16",
          "init_seconds": time.perf_counter() - t0,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    short = asr_wav(ASR_SECONDS, SEED + 95)
    long = asr_wav(ASR_LONG_SECONDS, SEED + 96)
    texts, secs, counts = serve_audio(
        "fun-asr-nano", m, [("/v1/audio/transcriptions", short),
                                 ("/v1/audio/translations", long)])
    xs, rate = wav_samples(short)
    xl, _ = wav_samples(long)
    direct = [m.transcribe(xs, rate), m.translate_long(xl, rate)]
    L = lcfg.num_layers
    row = {"phase": "serve_funasr_nano_requests", "seconds": secs,
           "tokens": [len(t.split()) for t in texts],
           "text": [t[:60] for t in texts], "launches": counts, "card": smi}
    emit(row)
    if texts != direct or not all(texts) or counts.get("k2", 0) != 3 * L:
        raise RuntimeError(f"serve_funasr_nano: answers or launches: {row}")

    with torch.inference_mode():
        samples = torch.from_numpy(xs).to(dev)
        lfr = m.features(xs, rate)[None]
        pre, suf, _ = m._prompt_ids()
        stages = {"frontend_ms": wall_ms(lambda: m.features(samples, rate)),
                  "encoder_adaptor_ms": wall_ms(lambda: m.encode(lfr)),
                  "audio_tokens": m.encode(lfr).shape[1],
                  **asr_decoder_checks(
                      dev, "Fun-ASR-Nano bf16", m,
                      lambda k: m.prefill(lfr, pre, suf, k), smi,
                      LOGITS_TOL),
                  "transcribe_ms": wall_ms(lambda: m.transcribe(xs, rate),
                                           2)}
    emit({"phase": "funasr_nano_split", "audio_s": ASR_SECONDS, **stages,
          "rtf": stages["transcribe_ms"] / 1e3 / ASR_SECONDS,
          "translate_long_s": secs[1],
          "rtf_translate_long": secs[1] / ASR_LONG_SECONDS,
          "k2_per_request": counts.get("k2", 0) / 3, "card": smi})
    del m, lfr
    free_device_memory()
    emit({"phase": "serve_funasr_nano", "launches": counts, "ok": True})
    return counts


TTS_FRAMES = 60                  # the e2e row's 60 frames (4.8 s there)
TTS_TEXT = "The quick brown fox jumps over the lazy dog near the river."
TTS_VOICE = "vivian"
# a preset voice's codec prefix: 9 control ids, so the prompt is the
# reference's 10-position batched prefill (11 with a speaker x-vector)
TTS_PREFIX = [2051, 2053, 2054, 2055, 2048, 2049, 2051, 2053, 2055]
# frames timed for ms a frame: their difference quotient; every request
# of the phase falls in one capacity bucket (128), so one capture serves
TTS_TIMED_FRAMES = (48, 80)
# the eager body's ms a frame: the host clock from frame 8's read of its
# codes to frame 16's, in one request of TTS_FRAMES cut there
TTS_EAGER_WINDOW = (8, 16)
TTS_PROFILED_FRAMES = 16
TTS_CLONE_SECONDS = 3
TTS_RATE = 24000


def qwen3_tts_1p7b():
    """The Qwen3-TTS 1.7B talker of benchmarks/pipelines_bench.py:131-134,
    copied: 28 layers 2048 wide, 16 / 8 heads of 128, FFN 6144, QK-norm,
    the codec-0 vocabulary 3072; the code predictor and text embedding at
    TalkerConfig's defaults (4 layers 1024 wide, 8 heads; 151936 x
    1024)."""
    from ominix_mlx_tpu_torch.models import base
    from ominix_mlx_tpu_torch.models import qwen3_tts as qt

    return qt.TalkerConfig(transformer=base.TransformerConfig(
        vocab_size=3072, hidden_size=2048, num_layers=28, num_heads=16,
        num_kv_heads=8, head_dim=128, intermediate_size=6144,
        use_qk_norm=True))


def tts_text_ids(text: str) -> list:
    """Token ids without a tokenizer: ``TTSModel``'s ord(c) % 1000."""
    return [ord(c) % 1000 for c in text]


def tts_frames(syn, ids, prefix, n) -> list:
    with torch.inference_mode():
        return list(syn.generate_frames(ids, prefix, n))


def tts_device_frames(syn, ids, n, eager: bool, times=None) -> list:
    """The first ``n`` frames of a request of ``TTS_FRAMES`` frames (the
    preset voice's prefix; the rest not generated), copies of each
    frame's codes and codebook-0 logits on the device: every step after
    frame 0 a replay of the captured frame (``Synthesizer.step``) or,
    ``eager``, its body run directly. ``times`` gets the host clock at
    each frame's read of its codes (the request loop's one sync)."""
    step = (lambda st, cap: syn.frame_body(st)) if eager else syn.step
    out = []
    with torch.inference_mode():
        frames = syn._frames(ids, TTS_PREFIX, TTS_FRAMES, step)
        for codes, logits in frames:
            out.append((codes.clone(), logits.clone()))
            if times is not None:
                codes.cpu()
                times.append(time.perf_counter())
            if len(out) == n:
                break
        frames.close()
    return out


def tts_replay_profile(syn, ids) -> dict:
    """``TTS_PROFILED_FRAMES`` replayed frames of a request under
    torch.profiler, its prefill and frame 0 outside the window, each
    frame's codes read on the host as the request loop does: wall ms and
    device busy ms a frame (the union of the kernels', copies' and fills'
    intervals), the idle share, device operations a frame, and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    n = TTS_PROFILED_FRAMES
    with torch.inference_mode():
        frames = syn._frames(ids, TTS_PREFIX, TTS_FRAMES, syn.step)
        next(frames)[0].cpu()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                next(frames)[0].cpu()
            wall_ms = (time.perf_counter() - t0) * 1e3
        frames.close()
    busy_us, by_name = device_time(prof)
    return {"frames": n, "wall_ms_per_frame": wall_ms / n,
            "device_busy_ms_per_frame": busy_us / 1e3 / n,
            "device_idle_share": 1 - busy_us / 1e3 / wall_ms,
            "device_ops_per_frame": sum(c for c, _ in by_name.values()) / n,
            "top_device": top_kernels(by_name, busy_us, 10)}


def tts_logits_check(dev, syn, name, tol, fault: bool, smi=""):
    """Card path against plain path on a 2-layer cut of the talker (the
    code predictor whole): the 10-token prefill (K2; the dq kernel at 8
    bits) and 3 frames teacher-forced on seeded codes (the talker's step:
    K1 at one row at 8 bits; the predictor's 2-token prefill: K2): the
    codebook-0 logits [4, V0] and the predictor's first head on each
    hidden [4, 2048], max error over max |plain| below ``tol``. With
    ``fault`` (a quantized talker) the planted "last_group" control on
    the plain path must reach ``tol``."""
    from ominix_mlx_tpu_torch.core.cache import ModelCache
    from ominix_mlx_tpu_torch.models import qwen3_tts as qt
    from ominix_mlx_tpu_torch.nn.layers import embedding, linear

    tcfg = dataclasses.replace(syn.tcfg, transformer=dataclasses.replace(
        syn.tcfg.transformer, num_layers=2))
    tp = {**syn.tp, "layers": syn.tp["layers"][:2]}
    cut = qt.Synthesizer(tp, tcfg)
    cp = tp["code_predictor"]
    g = torch.Generator(device=dev).manual_seed(SEED + 101)
    codes = torch.randint(0, tcfg.codec_vocab_size, (3, 16), generator=g,
                          device=dev)
    ids = tts_text_ids(TTS_TEXT)

    def heads(hidden, code0):
        pc = qt.predictor_cache(tcfg, cp, 1, hidden.dtype, dev)
        x = torch.cat([linear(cp["small_to_mtp_projection"], hidden),
                       linear(cp["small_to_mtp_projection"], embedding(
                           tp["codec_embedding"], code0))], 1)
        h, _ = qt._cp_forward(cp, qt.predictor_config(tcfg, cp), x, pc,
                              fresh_prefill=True)
        return qt.linear_head(cp, 0, h[:, -1])

    def run():
        with torch.inference_mode():
            st = cut.state(64)
            logits, hidden = cut._prefill(st, cut.build_prefill(
                ids, TTS_PREFIX))
            lg = [logits[:, -1]]
            hd = [heads(hidden[:, -1:], codes[:1, :1])]
            cache = ModelCache(layers=st.layers, offset=st.offset)
            for i in range(3):
                emb = cut.frame_embedding(codes[i:i + 1],
                                          torch.tensor([ids[i + 1]],
                                                       device=dev))
                logits, hidden, _ = qt.talker_step(tp, tcfg, emb, cache)
                st.offset.add_(1)
                lg.append(logits[:, -1])
                hd.append(heads(hidden, codes[i:i + 1, :1]))
            return torch.stack(lg).float(), torch.stack(hd).float()

    got = run()
    with plain_kernels():
        want = run()
    controls = {}
    if fault:
        with plain_kernels(args=control_args("last_group")):
            controls["last_group"] = rel_to(run()[0], want[0])
    rel = {"codec0_logits": rel_to(got[0], want[0]),
           "predictor_head0": rel_to(got[1], want[1])}
    row = {"phase": "tts_logits", "config": name, "layers": 2,
           "rel_err": rel, "limit": tol, "rel_err_control": controls,
           "card": smi}
    emit(row)
    if not all(torch.isfinite(t).all() for t in got):
        raise RuntimeError(f"{name}: non-finite logits")
    if not max(rel.values()) < tol:
        raise RuntimeError(f"{name}: card vs plain path: {row}")
    if fault and not controls["last_group"] >= tol:
        raise RuntimeError(f"{name}: the limit {tol} misses a quantized "
                           f"matmul without its last group: {row}")
    return row


def tts_frame_graph(dev, syn, name, weights, smi):
    """The captured frame step against its eager body: ``TTS_FRAMES``
    frames of one request each way, every frame's codes and codebook-0
    logits bit for bit; the capture's ms, its pool, the launches a replay
    records by kernel; the host µs of a replay (median of single replays
    each issued to an idle card, and the mean of back-to-back ones); a
    profile of replayed frames (``tts_replay_profile``); then ms a frame
    replayed and eager in turns (3 each): replayed, the median of the
    difference quotient of requests of ``TTS_TIMED_FRAMES`` frames, so
    the prefill cancels; eager, the host clock across
    ``TTS_EAGER_WINDOW`` inside one request."""
    from ominix_mlx_tpu_torch.ops import _build

    ids = tts_text_ids(TTS_TEXT)
    before = syn.captures
    got = tts_device_frames(syn, ids, TTS_FRAMES, eager=False)
    want = tts_device_frames(syn, ids, TTS_FRAMES, eager=True)
    if len(got) != TTS_FRAMES or len(want) != TTS_FRAMES:
        raise RuntimeError(f"{name}: {len(got)} frames replayed, "
                           f"{len(want)} eager")
    differ = [i for i, ((gc, gl), (wc, wl)) in enumerate(zip(got, want))
              if not (torch.equal(gc, wc) and torch.equal(gl, wl))]
    cap = next(iter(syn.captured.graphs))
    per_replay = {k: c for counter, counts in
                  syn.captured.records[cap].launches.values()
                  if counter is _build.LAUNCHES for k, c in counts.items()
                  if c}
    graph, _ = syn.captured.graphs[cap]
    single = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        single.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        graph.replay()
    queued_us = (time.perf_counter() - t0) / 20 * 1e6
    torch.cuda.synchronize()
    profiled = tts_replay_profile(syn, ids)

    def timed(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        frames = tts_frames(syn, ids, TTS_PREFIX, n)
        torch.cuda.synchronize()
        return time.perf_counter() - t, len(frames)

    a, b = TTS_EAGER_WINDOW
    rates = {"replayed": [], "eager": []}
    for _ in range(3):
        (ta, na), (tb, nb) = map(timed, TTS_TIMED_FRAMES)
        if nb <= na:
            raise RuntimeError(f"{name}: EOS before frame {nb}")
        rates["replayed"].append((tb - ta) / (nb - na) * 1e3)
        times = []
        tts_device_frames(syn, ids, b + 1, eager=True, times=times)
        rates["eager"].append((times[b] - times[a]) / (b - a) * 1e3)
    row = {"phase": "tts_frame_graph", "config": name, "weights": weights,
           "frames": len(got), "frames_differ": differ,
           "captures": syn.captures - before,
           "capture_ms": syn.captured.capture_ms[cap],
           "pool_mib": syn.captured.pool_bytes / 2 ** 20,
           "capacity": cap, "launches_per_replay": per_replay,
           "host_us_per_replay": statistics.median(single),
           "host_us_per_replay_back_to_back": queued_us,
           "replay_profile": profiled,
           "ms_per_frame_replayed": statistics.median(rates["replayed"]),
           "ms_per_frame_eager": statistics.median(rates["eager"]),
           "ms_per_frame_runs": rates, "eager_window": [a, b],
           "card": smi}
    emit(row)
    if differ or row["captures"] != 1:
        raise RuntimeError(f"{name}: replayed frames against eager: {row}")
    return row


def tts_synth(dev, tcfg, tp, dec, ccfg, spk, enc, ecfg):
    from ominix_mlx_tpu_torch.models import qwen3_tts as qt
    from ominix_mlx_tpu_torch.models import speaker_encoder as se

    return qt.Synthesizer(tp, tcfg, dec, ccfg, spk_params=spk,
                          spk_cfg=se.SpeakerEncoderConfig(),
                          speech_enc=enc, speech_enc_cfg=ecfg)


def conv_tf32(dev, smi) -> dict:
    """float32 convolutions on the card against float64, at Paraformer's
    FSMN shape (512 channels depthwise, K = 11, 501 frames) and ECAPA's
    first TDNN (128 -> 512, K = 5, 300 frames): F.conv1d under PyTorch's
    default flags (cuDNN may take TF32) and ``nn.layers.conv1d`` (float32
    without TF32 for the call), max error over max |float64|."""
    from ominix_mlx_tpu_torch.nn import layers

    rows = {}
    for shape, (cin, cout, K, T, groups) in {
            "fsmn": (512, 512, 11, 501, 512),
            "ecapa_tdnn": (128, 512, 5, 300, 1)}.items():
        g = torch.Generator(device=dev).manual_seed(K)
        w = torch.randn(cout, K, cin // groups, generator=g, device=dev,
                        dtype=torch.float64) * (cin * K / groups) ** -0.5
        x = torch.randn(1, T, cin, generator=g, device=dev,
                        dtype=torch.float64)
        want = layers.conv1d({"w": w}, x, padding=K // 2, groups=groups)
        raw = F.conv1d(x.float().transpose(1, 2),
                       w.float().permute(0, 2, 1), padding=K // 2,
                       groups=groups).transpose(1, 2)
        got = layers.conv1d({"w": w.float()}, x.float(), padding=K // 2,
                            groups=groups)
        rows[shape] = {"default_flags_rel_err": rel_to(raw.double(), want),
                       "layer_rel_err": rel_to(got.double(), want)}
    row = {"phase": "conv_tf32", "rows": rows, "limit": 1e-5,
           "cudnn_allow_tf32_default": torch.backends.cudnn.allow_tf32,
           "card": smi}
    emit(row)
    if not all(r["layer_rel_err"] < 1e-5 for r in rows.values()):
        raise RuntimeError(f"float32 convolutions: {row}")
    return row


def serve_qwen3_tts(dev, smi):
    """serve_qwen3_tts: Qwen3-TTS with the 1.7B talker (``qwen3_tts_1p7b``,
    random weights), the e2e row's codec decoder (512 wide, 4 transformer
    layers of 8 heads, strides (2,) then (8, 5, 4, 3): 960 samples a
    frame), the speech encoder (512 wide, strides (8, 5, 4, 3)) and the
    default ECAPA speaker encoder (float32), the talker in bf16 and at
    w8a8 g64 (``quantize_params``: its layers only; fused, on panels).
    For each: the captured frame step against its eager body
    (``tts_frame_graph``) and the 2-layer card-vs-plain check
    (``tts_logits_check``). Then, on w8a8: one /v1/audio/speech request
    over HTTP (the main path: its launches returned), its WAV equal to
    ``TTSModel.synthesize``'s, no capture in it, K2 and K1's 8-bit P
    formula launched as the frames need; the waveform finite, within
    [-1, 1], 960 samples a frame; a voice-clone request from a seeded 3 s
    clip (speech encoder, speaker encoder; the same capacity bucket, so no
    capture); the split (prefill, frame, codec at 60 frames, request) and
    the RTF on the samples produced."""
    import io
    import wave

    import numpy as np

    from ominix_mlx_tpu_torch import native
    from ominix_mlx_tpu_torch.audio.dsp import log_mel_spectrogram
    from ominix_mlx_tpu_torch.models import base
    from ominix_mlx_tpu_torch.models import qwen3_tts as qt
    from ominix_mlx_tpu_torch.models import speaker_encoder as se
    from ominix_mlx_tpu_torch.ops import _build
    from ominix_mlx_tpu_torch.serving.server import Server

    conv_tf32(dev, smi)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 100)
    tcfg = qwen3_tts_1p7b()
    bf16 = qt.init_params(tcfg, gen, torch.bfloat16, dev)
    # EOS's row of the random codec head zeroed: every request runs its
    # full frame count, as the bench rows' fixed 60 frames (a random head
    # ends a request at an arbitrary frame)
    bf16["codec_head"]["w"][tcfg.codec_eos_id] = 0
    dec, ccfg = qt.init_codec(gen, frame_dim=512, n_transformer=4,
                              num_heads=8, up_strides=(2,),
                              dec_strides=(8, 5, 4, 3), codec_vocab=2048,
                              dtype=torch.bfloat16, device=dev)
    enc, ecfg = qt.init_speech_encoder(gen, dim=512,
                                       enc_strides=(8, 5, 4, 3),
                                       codec_vocab=2048, device=dev)
    spk = se.init_params(se.SpeakerEncoderConfig(), gen, device=dev)
    models = {"bf16": base.fuse_layer_projections(bf16),
              "w8a8 g64": base.fuse_layer_projections(
                  base.quantize_params(bf16, GS, 8))}
    torch.cuda.synchronize()
    emit({"phase": "model", "config": "Qwen3-TTS-1.7B",
          "weights": "talker bf16 and w8a8 g64; predictor, heads, codec "
                     "bf16; speech and speaker encoders float32",
          "init_seconds": time.perf_counter() - t0,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    per = qt.samples_per_frame(ccfg)
    L, Lc = tcfg.transformer.num_layers, tcfg.cp_layers
    Ld = len(dec["pre_transformer_layers"])
    out, graphs = {}, {}
    for weights, tp in models.items():
        syn = tts_synth(dev, tcfg, tp, dec, ccfg, spk, enc, ecfg)
        name = f"Qwen3-TTS-1.7B {weights}"
        q8 = weights != "bf16"
        graph = graphs[weights] = tts_frame_graph(dev, syn, name, weights,
                                                  smi)
        want = {"k2": Lc, **({"k1_m1_w8": 4 * L} if q8 else {})}
        if any(graph["launches_per_replay"].get(k) != n
               for k, n in want.items()):
            raise RuntimeError(f"{name}: a replay's launches "
                               f"{graph['launches_per_replay']}, want {want}")
        tts_logits_check(dev, syn, name, W8A8_PANELS_LOGITS_TOL if q8
                         else LOGITS_TOL, fault=q8, smi=smi)
        out[weights] = syn
    syn = out["w8a8 g64"]
    out["bf16"].close()
    model = qt.TTSModel(syn, voices={TTS_VOICE: TTS_PREFIX},
                        max_frames=TTS_FRAMES)

    srv = Server(port=free_port())
    srv.add_model("qwen3-tts", model)
    srv.start_background()
    captures = syn.captures
    try:
        _build.reset_launches()
        t = time.perf_counter()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/audio/speech",
            data=json.dumps({"input": TTS_TEXT, "voice": TTS_VOICE}).encode())
        with urllib.request.urlopen(req, timeout=600) as r:
            if r.status != 200:
                raise RuntimeError(f"/v1/audio/speech: HTTP {r.status}")
            data = r.read()
        seconds = time.perf_counter() - t
        counts = dict(_build.LAUNCHES)
    finally:
        srv.shutdown()
    with wave.open(io.BytesIO(data), "rb") as w:
        rate, width, ch = w.getframerate(), w.getsampwidth(), w.getnchannels()
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    wav, mrate = model.synthesize(TTS_TEXT, voice=TTS_VOICE)
    frames = len(wav) // per
    steps = frames if frames < TTS_FRAMES else frames - 1
    row = {"phase": "serve_qwen3_tts_request", "seconds": seconds,
           "frames": frames, "samples": len(pcm), "rate": rate,
           "launches": counts, "captures": syn.captures - captures,
           "card": smi}
    emit(row)
    if (rate, width, ch) != (TTS_RATE, 2, 1) or mrate != TTS_RATE \
            or not np.array_equal(pcm, native.float_to_pcm16(wav)):
        raise RuntimeError(f"serve_qwen3_tts: the WAV is not the model's: "
                           f"{row}")
    if not (np.isfinite(wav).all() and np.abs(wav).max() <= 1
            and len(wav) == frames * per and frames > 0):
        raise RuntimeError(f"serve_qwen3_tts: waveform: {row}")
    # K2: the talker's prefill, frame 0's predictor, each replay's
    # predictor, the codec's pre-transformer
    if row["captures"] or counts.get("k2", 0) != L + Lc + Lc * steps + Ld \
            or counts.get("k1_m1_w8", 0) != 4 * L * steps:
        raise RuntimeError(f"serve_qwen3_tts: captures or launches: {row}")

    g = np.random.default_rng(SEED + 102)
    t_ax = np.arange(TTS_CLONE_SECONDS * TTS_RATE) / TTS_RATE
    clip = (0.2 * np.sin(2 * np.pi * 180 * t_ax * (1 + 0.1 * np.sin(t_ax)))
            + 0.02 * g.normal(size=t_ax.shape)).astype(np.float32)
    mel = log_mel_spectrogram(torch.from_numpy(clip).to(dev), 1024, 256,
                              128, TTS_RATE)
    ids = tts_text_ids(TTS_TEXT)
    t = time.perf_counter()
    res = syn.synthesize_voice_clone(ids[:20], ids[20:], ref_mel=mel,
                                     ref_samples=clip, max_frames=16)
    torch.cuda.synchronize()
    clone = {"phase": "tts_clone", "ref_seconds": TTS_CLONE_SECONDS,
             "ref_frames": len(syn.encode_reference(clip)),
             "frames": res.frames,
             "seconds": time.perf_counter() - t,
             "captures": syn.captures - captures, "card": smi}
    emit(clone)
    if res.frames < 1 or clone["captures"]:
        raise RuntimeError(f"serve_qwen3_tts: clone: {clone}")

    with torch.inference_mode():
        st = syn.state(next(iter(syn.captured.graphs)))
        emb = syn.build_prefill(ids, TTS_PREFIX)
        codes = torch.randint(0, 2048, (TTS_FRAMES, 16), device=dev)
        stages = {
            "prefill_T": emb.shape[1],
            "prefill_ms": wall_ms(lambda: syn._prefill(st, emb)),
            "codec_frames": TTS_FRAMES,
            "codec_ms": wall_ms(lambda: qt.codec_decode(dec, codes, ccfg)),
            "speaker_encoder_ms": wall_ms(lambda: syn.encode_speaker(mel)),
            "speech_encoder_ms": wall_ms(lambda: syn.encode_reference(clip)),
            "request_ms": wall_ms(lambda: model.synthesize(
                TTS_TEXT, voice=TTS_VOICE), 2)}
    audio_s = frames * per / TTS_RATE
    emit({"phase": "qwen3_tts_split", "weights": "w8a8 g64",
          "frames": frames, "samples_per_frame": per, "audio_s": audio_s,
          **stages, "ms_per_frame_replayed":
              graphs["w8a8 g64"]["ms_per_frame_replayed"],
          "ms_per_frame_eager": graphs["w8a8 g64"]["ms_per_frame_eager"],
          "rtf": stages["request_ms"] / 1e3 / audio_s,
          "rtf_note": f"on the samples produced ({per} a frame); "
                      "benchmarks/pipelines_bench.py:253 counts 1920",
          "k2_per_request": counts.get("k2", 0),
          "k1_m1_w8_per_request": counts.get("k1_m1_w8", 0), "card": smi})
    syn.close()
    del models, out, syn, model, bf16, dec, enc, spk, st, emb, codes, mel
    free_device_memory()
    emit({"phase": "serve_qwen3_tts", "launches": counts, "ok": True})
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="only build this checkout's and DIR's kernels, "
                         "time K3, the P formula (K1 at one row, K6), K5 "
                         "(bf16, 4- and 8-bit), the DeltaNet and K10 "
                         "decode mixers and K11's selection against DIR's "
                         "sequences, the 128-token Qwen3-30B-A3B w4a8 "
                         "prefill of both packages, and their "
                         "generate_scan decode rates (the parent's eager "
                         "loop, this one's captured step) on Qwen3-4B w4a8 "
                         "and MiniCPM-SALA, in turns")
    ap.add_argument("--prefill-probe", metavar="ROOT",
                    help=argparse.SUPPRESS)   # one package_probe of ROOT's
    ap.add_argument("--decode-probe", metavar="ROOT",   # package (--parent
                    help=argparse.SUPPRESS)             # runs them)
    ap.add_argument("--profile", action="store_true",
                    help="profile decode steps on the device "
                         "(torch.profiler) and the host (cProfile): batch 1 "
                         "w4a8, batch 8 w8a8 over a paged cache, and "
                         "batch 1 Qwen3-30B-A3B w4a8, Mistral-7B, GLM-4-9B, "
                         "DeepSeek-V2-Lite, Mixtral-8x7B and GLM-4.5-Air; "
                         "one 16-token w4a8 prefill; and one 8k chunked "
                         "prefill")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if args.prefill_probe or args.decode_probe:
        root = os.path.abspath(args.prefill_probe or args.decode_probe)
        sys.path[:] = [root] + [p for p in sys.path
                                if os.path.abspath(p or os.curdir) != here]
        emit(package_probe(root, "prefill" if args.prefill_probe
                           else "decode"))
        return 0
    sys.path.insert(0, here)
    from ominix_mlx_tpu_torch.models import base, qwen3_moe
    from ominix_mlx_tpu_torch.ops import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi_line()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc.strip().splitlines()[-1],
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds})

    flush_buf = torch.zeros(256 << 20, dtype=torch.uint8, device=dev)
    flush = l2_flush(flush_buf)
    if args.parent:
        plib = parent_library(args.parent)
        compare_k3(plib, dev, flush)
        compare_qmm_p(plib, dev, flush)
        compare_k5(plib, dev, flush)
        compare_k9_decode(plib, dev, flush)
        compare_k10_decode(plib, dev, flush)
        compare_k11_select(plib, dev, flush)
        del flush_buf, flush
        free_device_memory()
        parent = os.path.abspath(args.parent)
        compare_probes(parent, here, "prefill",
                       ("wall_ms", "profiled_wall_ms", "device_busy_ms",
                        "max_memory_allocated_gib", "prefill_extra_gib"))
        compare_probes(parent, here, "decode",
                       ("captured", "qwen3_4b_tok_s", "minicpm_sala_tok_s"))
        return 0
    k1_rows = check_k1(dev, flush)
    k6_rows = check_k6(dev, flush)
    k7_rows = check_k7(dev, flush)
    k2_rows = check_k2(dev, flush)
    k2c_rows = check_k2c(dev, flush)
    k2w_rows = check_k2_window(dev, flush)
    k2cw_rows = check_k2c_window(dev, flush)
    k3_rows = check_k3(dev, flush)
    k4_rows = check_k4(dev, flush)
    k8_rows = check_k8(dev, flush)
    k5_rows = check_k5(dev, flush)
    k9_rows = check_k9(dev, flush)
    k9_prep_rows = check_k9_prep(dev, flush)
    k9_decode_rows = check_k9_decode(dev, flush)
    k2_d256_rows = check_k2(dev, flush, H=16, Hkv=2, D=256, Ts=(128, 2048),
                            seed=SEED + 39, phase="k2_d256")
    k4_e512_rows, k5_e512_rows = check_next_experts(dev, flush)
    emit({**launch_floor(dev), "card": smi})
    # after launch_floor: its profiler windows come before these checks'
    k10_rows = check_k10(dev, flush)
    k10_decode_rows = check_k10_decode(dev, flush)
    _, k11_select_rows, k11_attend_rows = check_k11(dev, flush)
    del flush_buf, flush
    torch.cuda.empty_cache()

    cfg = qwen3_4b()
    phases = {}        # main-path phase -> kernel launches in that run
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = base.fuse_layer_projections(base.init_quantized_params(
        cfg, gen, GS, 4, act_bits=8, device=dev))
    torch.cuda.synchronize()
    emit({"phase": "model", "config": "Qwen3-4B", "weights": "w4a8 g64",
          "init_seconds": time.perf_counter() - t0,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    phases["serve"] = serve_main_path(dev, cfg, params)
    check_logits(dev, cfg, params)
    emit({**decode_rate(dev, cfg, params, 32, 128), "card": smi})
    decode_graph(dev, cfg, params, "Qwen3-4B", "w4a8 g64", smi)
    phases["speculative"] = speculative(
        dev, cfg, params, "Qwen3-4B", "w4a8 g64", smi, drafts={
            "target": (lambda p, t, c: base.forward(p, cfg, t, c), params,
                       lambda b, ml: base.init_cache(cfg, b, ml, device=dev),
                       False),
            "self_9_layers": (*self_draft(cfg, params, base, 9), False),
            "self_9_layers_force_accept": (
                *self_draft(cfg, params, base, 9), True)})
    # w4a8's verify at 8 x 5 = 40 rows takes the dense route, whose
    # products differ from the one-row P formula's: its answers are read
    phases["serve_speculative_batched"] = serve_speculative_batched(
        dev, cfg, params, smi)
    if args.profile:
        emit({**profile_decode(dev, cfg, params), "card": smi})
        emit({**profile_prefill16(dev, cfg, params), "card": smi})
    del params
    free_device_memory()

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    params = base.fuse_layer_projections(base.init_quantized_params(
        cfg, gen, GS, 8, act_bits=8, device=dev))
    torch.cuda.synchronize()
    emit({"phase": "model", "config": "Qwen3-4B", "weights": "w8a8 g64",
          "init_seconds": time.perf_counter() - t0,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    phases["serve_q8"] = serve_main_path(dev, cfg, params, "serve_q8",
                                         "qwen3-4b-w8", "_w8")
    check_logits(dev, cfg, params, "Qwen3-4B w8a8",
                 tol=W8A8_PANELS_LOGITS_TOL)
    emit({**decode_rate(dev, cfg, params, 32, 96), "weights": "w8a8 g64",
          "card": smi})
    del params
    free_device_memory()

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    params = base.fuse_layer_projections(base.init_quantized_params(
        cfg, gen, device=dev, scheme="channel8"))
    phases["batch_decode"] = batch_decode(dev, cfg, params, 16, 64)
    for paged in (False, True):
        phases["batcher_graph_" + ("paged" if paged else "dense")] = \
            batcher_graph(dev, cfg, params, "Qwen3-4B", "w8a8 channel8", smi,
                          paged=paged)
    # channel w8a8 products are exact whatever rows a call takes: the
    # speculative tokens are plain greedy's, held
    phases["speculative_w8a8"] = speculative(
        dev, cfg, params, "Qwen3-4B", "w8a8 channel8", smi, exact=True,
        drafts={"target": (lambda p, t, c: base.forward(p, cfg, t, c),
                           params, lambda b, ml: base.init_cache(
                               cfg, b, ml, device=dev), False),
                "self_9_layers": (*self_draft(cfg, params, base, 9), False)})
    # the batched speculative server on exact products: every answer
    # equals the per-request engine path's, held, with the target as its
    # own draft (every draft accepted) and the 9-layer self-draft
    phases["serve_speculative_batched_w8a8"] = serve_speculative_batched(
        dev, cfg, params, smi, weights="w8a8 channel8",
        drafts=(cfg.num_layers, 9), exact=True)
    if args.profile:
        emit({**profile_decode(dev, cfg, params, batch=BATCH, paged=True),
              "weights": "w8a8 channel8", "card": smi})
    del params
    free_device_memory()

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    params = base.fuse_layer_projections(base.init_params(
        cfg, gen, torch.bfloat16, device=dev))
    emit({"phase": "model", "config": "Qwen3-4B", "weights": "bf16",
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    phases["prefill_chunked"] = prefill_chunked_path(dev, cfg, params,
                                                     args.profile)
    torch.cuda.empty_cache()
    phases["serve_batched"] = serve_batched(dev, cfg, params)
    free_device_memory()
    phases["generate_rows"] = generate_rows(dev, cfg, params)
    phases["serve_batched_w4"] = serve_batched_w4(dev, cfg, params)
    del params
    free_device_memory()

    moe_cfg = qwen3_30b_a3b()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    params = base.fuse_layer_projections(qwen3_moe.init_quantized_params(
        moe_cfg, gen, GS, 4, act_bits=8, device=dev))
    torch.cuda.synchronize()
    emit({"phase": "model", "config": "Qwen3-30B-A3B", "weights": "w4a8 g64",
          "layers": moe_cfg.num_layers, "init_seconds":
          time.perf_counter() - t0,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    phases["serve_moe"] = serve_moe(dev, moe_cfg, params)
    emit({"phase": "moe_prefill", "config": "Qwen3-30B-A3B",
          "weights": "w4a8 g64", **moe_prefill(dev, moe_cfg, params),
          "card": smi})
    check_logits(dev, moe_cfg, params, "Qwen3-30B-A3B")
    emit({**decode_rate(dev, moe_cfg, params, 16, 48),
          "config": "Qwen3-30B-A3B", "card": smi})
    decode_graph(dev, moe_cfg, params, "Qwen3-30B-A3B", "w4a8 g64", smi)
    phases["moe_batch_decode"] = moe_batch_decode(dev, moe_cfg, params, 16,
                                                  48)
    phases["batcher_graph_moe"] = batcher_graph(
        dev, moe_cfg, params, "Qwen3-30B-A3B", "w4a8 g64", smi, paged=True,
        steps=16)
    if args.profile:
        emit({**profile_decode(dev, moe_cfg, params),
              "config": "Qwen3-30B-A3B", "card": smi})
    del params
    free_device_memory()

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    params = base.fuse_layer_projections(qwen3_moe.init_quantized_params(
        moe_cfg, gen, GS, 8, act_bits=8, device=dev))
    torch.cuda.synchronize()
    emit({"phase": "model", "config": "Qwen3-30B-A3B", "weights": "w8a8 g64",
          "layers": moe_cfg.num_layers, "init_seconds":
          time.perf_counter() - t0,
          "gib_allocated": torch.cuda.memory_allocated() / 2 ** 30})
    phases["serve_moe_q8"] = serve_moe(dev, moe_cfg, params, "serve_moe_q8",
                                       "qwen3-30b-a3b-q8", "_w8")
    emit({"phase": "moe_prefill", "config": "Qwen3-30B-A3B",
          "weights": "w8a8 g64", **moe_prefill(dev, moe_cfg, params),
          "card": smi})
    check_logits(dev, moe_cfg, params, "Qwen3-30B-A3B w8a8",
                 tol=MOE_W8A8_LOGITS_TOL)
    emit({**decode_rate(dev, moe_cfg, params, 16, 48),
          "config": "Qwen3-30B-A3B", "weights": "w8a8 g64", "card": smi})
    del params
    free_device_memory()

    phases["serve_moe_batched_w8"] = serve_moe_batched_w8(dev, moe_cfg, smi)
    free_device_memory()

    phases["serve_mistral"] = serve_mistral(dev, smi, args.profile)
    phases["serve_glm4"] = serve_glm4(dev, smi, args.profile)
    phases["prefill_window"] = prefill_window(dev, smi)
    phases["load_checkpoint"] = load_checkpoint(dev, smi)
    phases["serve_deepseek_v2_lite"] = serve_deepseek_v2_lite(dev, smi,
                                                              args.profile)
    phases["serve_mixtral"] = serve_mixtral(dev, smi, args.profile)
    phases["serve_glm4_moe"] = serve_glm4_moe(dev, smi, args.profile)
    phases["serve_qwen3_next"] = serve_qwen3_next(dev, smi, args.profile)
    phases["serve_minicpm_sala"] = serve_minicpm_sala(dev, smi,
                                                      args.profile)
    phases["serve_moxin"] = serve_moxin(dev, smi, args.profile)
    phases["serve_ocr2"] = serve_ocr2(dev, smi, args.profile)
    phases["serve_paraformer"], k12_rows = serve_paraformer(dev, smi)
    phases["serve_qwen3_asr"] = serve_qwen3_asr(dev, smi)
    phases["serve_funasr_nano"] = serve_funasr_nano(dev, smi)
    phases["serve_qwen3_tts"] = serve_qwen3_tts(dev, smi)

    def launches(key, only=None):
        return sum(c.get(key, 0) for p, c in phases.items()
                   if only is None or p in only)

    def entry(name, replaces, source, rows, pick, key, only=None, **extra):
        rep = pick(rows)
        return {"name": name, "route": "cuda", "source": source, **extra,
                "replaces": replaces, "launches": launches(key, only),
                "launches_by_phase": {p: c.get(key, 0)
                                      for p, c in phases.items()},
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                "library_ms": rep["library_ms"],
                "timed_at": {k: rep[k] for k in rep
                             if k in ("shape", "N", "K", "M", "mode", "bits",
                                      "T", "pos", "window", "k", "S", "B",
                                      "D", "E")}}

    def k1_rows_of(bits, m1):
        return [r for r in k1_rows
                if r["bits"] == bits and (r["M"] == 1) == m1]

    def at(shape, M, mode=None):
        return lambda rs: next(r for r in rs if r["shape"] == shape
                               and r["M"] == M
                               and mode in (None, r["mode"]))

    def worst_vs_library(shape, M):
        """The row furthest behind its PyTorch call, or (no library time
        in any row) the row at ``shape`` and M."""
        def pick(rs):
            timed = [r for r in rs if r["vs_library"] is not None]
            if timed:
                return max(timed, key=lambda r: r["vs_library"])
            return at(shape, M)(rs)
        return pick

    def worst_k5(rs):
        """The row furthest from its bound."""
        return min(rs, key=lambda r: r["share_of_bound"])

    kernels = [
        entry("k1_qmm_w4_m1", "ominix_mlx_tpu/ops/quant_matmul.py:719",
              "ominix_mlx_tpu_torch/csrc/qmm.cu", k1_rows_of(4, True),
              at("lm_head", 1, "a8"), "k1_m1", design=QMM_P_DESIGN),
        entry("k1_qmm_w4_m2_16", "ominix_mlx_tpu/ops/quant_matmul.py:1062",
              "ominix_mlx_tpu_torch/csrc/qmm_tc.cu", k1_rows_of(4, False),
              worst_vs_library("gate_up_proj", 16), "k1_mn",
              design=DQ_DESIGN),
        entry("k1_qmm_w8_m1", "ominix_mlx_tpu/ops/quant_matmul.py:719",
              "ominix_mlx_tpu_torch/csrc/qmm.cu", k1_rows_of(8, True),
              at("lm_head", 1, "a8"), "k1_m1_w8", design=QMM_P_DESIGN),
        entry("k1_qmm_w8_m2_16", "ominix_mlx_tpu/ops/quant_matmul.py:1062",
              "ominix_mlx_tpu_torch/csrc/qmm_tc.cu", k1_rows_of(8, False),
              worst_vs_library("gate_up_proj", 16), "k1_mn_w8",
              design=DQ_DESIGN),
        entry("k6_qmm_rows", "ominix_mlx_tpu/ops/quant_matmul.py:358",
              "ominix_mlx_tpu_torch/csrc/qmm.cu", k6_rows,
              at("gate_up_proj", 1, "w4a8"), "k6", design=QMM_P_DESIGN),
        entry("k7_qmm_w4a16_tc", "ominix_mlx_tpu/ops/quant_matmul.py:1229",
              "ominix_mlx_tpu_torch/csrc/qmm_tc.cu", k7_rows,
              worst_vs_library("gate_up_proj", 64), "k7", design=DQ_DESIGN),
        entry("k2_flash_prefill", "ominix_mlx_tpu/ops/flash_attention.py:60",
              "ominix_mlx_tpu_torch/csrc/flash_attn.cu", k2_rows,
              lambda rs: rs[-1], "k2", design=K2_DESIGN),
        entry("k2c_flash_chunk", "ominix_mlx_tpu/ops/flash_attention.py:117",
              "ominix_mlx_tpu_torch/csrc/flash_attn.cu", k2c_rows,
              lambda rs: next(r for r in rs if r["pos"] == 6144), "k2c",
              design=K2_DESIGN),
        entry("k2_flash_prefill_window",
              "ominix_mlx_tpu/ops/flash_attention.py:60 (the masked sdpa of "
              "causal_mask(window), ominix_mlx_tpu/models/base.py:200-213)",
              "ominix_mlx_tpu_torch/csrc/flash_attn.cu", k2w_rows,
              lambda rs: rs[0], "k2_window", design=K2_DESIGN),
        entry("k2c_flash_chunk_window",
              "ominix_mlx_tpu/ops/flash_attention.py:117 (the masked sdpa "
              "of causal_mask(window), ominix_mlx_tpu/models/base.py:"
              "206-213)", "ominix_mlx_tpu_torch/csrc/flash_attn.cu",
              k2cw_rows, lambda rs: rs[0], "k2c_window", design=K2_DESIGN),
        entry("k3_paged_decode", "ominix_mlx_tpu/ops/paged_attention.py:73",
              "ominix_mlx_tpu_torch/csrc/paged_attn.cu", k3_rows,
              lambda rs: rs[0], "k3", design=K3_DESIGN),
        entry("k4_gather_qmm", "ominix_mlx_tpu/ops/quant_matmul.py:1606",
              "ominix_mlx_tpu_torch/csrc/gather_qmm.cu",
              [r for r in k4_rows if r["bits"] == 4], lambda rs: rs[0], "k4",
              design=GATHER_DESIGN),
        entry("k4_gather_qmm_w8",
              "ominix_mlx_tpu/ops/quant_matmul.py:1606 (bits=8)",
              "ominix_mlx_tpu_torch/csrc/gather_qmm.cu",
              [r for r in k4_rows if r["bits"] == 8], lambda rs: rs[0],
              "k4_w8", design=GATHER_DESIGN),
        entry("k8_channel_gather_qmm",
              "XLA einsum ominix_mlx_tpu/ops/quant_matmul.py:1523, no Pallas "
              "kernel", "ominix_mlx_tpu_torch/csrc/gather_qmm.cu", k8_rows,
              lambda rs: rs[0], "k8", design=GATHER_DESIGN),
        entry("k5_grouped_mm", "ominix_mlx_tpu/models/moe.py:84",
              "ominix_mlx_tpu_torch/csrc/grouped_mm.cu",
              [r for r in k5_rows if r["bits"] == 16], worst_k5, "k5",
              design=K5_DESIGN),
        entry("k5_grouped_mm_w4",
              "ominix_mlx_tpu/models/moe.py:84 (4-bit experts, read packed)",
              "ominix_mlx_tpu_torch/csrc/grouped_mm.cu",
              [r for r in k5_rows if r["bits"] == 4], worst_k5, "k5_w4",
              design=K5_DESIGN),
        entry("k5_grouped_mm_w8",
              "ominix_mlx_tpu/models/moe.py:84 (8-bit experts, read packed)",
              "ominix_mlx_tpu_torch/csrc/grouped_mm.cu",
              [r for r in k5_rows if r["bits"] == 8], worst_k5, "k5_w8",
              design=K5_DESIGN),
        entry("k9_gated_delta",
              "XLA scan ominix_mlx_tpu/models/deltanet.py:132-144, no Pallas "
              "kernel (the recurrent form)",
              "ominix_mlx_tpu_torch/csrc/gated_delta.cu",
              [r for r in k9_rows if r["form"] == "recurrent"],
              lambda rs: rs[0], "k9", design=K9_DESIGN),
        entry("k9_gated_delta_chunked",
              "XLA scan ominix_mlx_tpu/models/deltanet.py:132-144, no Pallas "
              "kernel (the chunked form: gated_delta_chunk, then "
              "gated_delta_chunk_scan, one launch each a call)",
              "ominix_mlx_tpu_torch/csrc/gated_delta.cu",
              [r for r in k9_rows if r["form"] == "chunked"],
              lambda rs: next(r for r in rs if r["T"] == 2048), "k9_chunk",
              design=K9_CHUNK_DESIGN),
        entry("k9_prep",
              "XLA ops ominix_mlx_tpu/models/deltanet.py:111-130 (conv, "
              "SiLU, l2norms, gates), no Pallas kernel",
              "ominix_mlx_tpu_torch/csrc/k9_prep.cu", k9_prep_rows,
              lambda rs: rs[0], "k9_prep", design=K9_PREP_DESIGN),
        entry("k9_decode",
              "XLA ops ominix_mlx_tpu/models/deltanet.py:103-150 at T = 1 "
              "(conv, SiLU, l2norms, gates, the scan's one step of "
              ":132-144, the gated RMSNorm and SiLU gate), no Pallas "
              "kernel", "ominix_mlx_tpu_torch/csrc/k9_decode.cu",
              k9_decode_rows, lambda rs: rs[0], "k9_decode",
              design=K9_DECODE_DESIGN),
        entry("k2_flash_prefill_d256",
              "ominix_mlx_tpu/ops/flash_attention.py:60 (Qwen3-Next: 16 "
              "over 2 heads of 256)",
              "ominix_mlx_tpu_torch/csrc/flash_attn.cu", k2_d256_rows,
              lambda rs: rs[0], "k2", only=("serve_qwen3_next",),
              design=K2_DESIGN),
        entry("k4_gather_qmm_e512",
              "ominix_mlx_tpu/ops/quant_matmul.py:1606 (512 experts, top 10)",
              "ominix_mlx_tpu_torch/csrc/gather_qmm.cu", k4_e512_rows,
              lambda rs: rs[0], "k4", only=("serve_qwen3_next",),
              design=GATHER_DESIGN),
        entry("k5_grouped_mm_w4_e512",
              "ominix_mlx_tpu/models/moe.py:84 (512 4-bit experts, read "
              "packed)", "ominix_mlx_tpu_torch/csrc/grouped_mm.cu",
              k5_e512_rows, worst_k5, "k5_w4", only=("serve_qwen3_next",),
              design=K5_DESIGN),
        entry("k10",
              "XLA einsum ominix_mlx_tpu/models/lightning.py:75-83, no "
              "Pallas kernel (the recurrent form)",
              "ominix_mlx_tpu_torch/csrc/lightning_attn.cu",
              [r for r in k10_rows if r["form"] == "recurrent"],
              lambda rs: rs[0], "k10", design=K10_DESIGN),
        entry("k10_chunk",
              "XLA scan ominix_mlx_tpu/models/lightning.py:86-119, no "
              "Pallas kernel (the chunked form: lightning_chunk, one "
              "launch a call)",
              "ominix_mlx_tpu_torch/csrc/lightning_attn.cu",
              [r for r in k10_rows if r["form"] == "chunked"],
              lambda rs: next(r for r in rs if r["T"] == 2048), "k10_chunk",
              design=K10_CHUNK_DESIGN),
        entry("k10_decode",
              "XLA ops ominix_mlx_tpu/models/minicpm_sala.py:158-184 at "
              "T = 1 (QK-norm, RoPE, the einsum step of models/lightning.py:"
              "75-83, the output norm and gate), no Pallas kernel",
              "ominix_mlx_tpu_torch/csrc/lightning_attn.cu",
              k10_decode_rows, lambda rs: rs[0], "k10_decode",
              design=K10_DECODE_DESIGN),
        entry("k11_select",
              "XLA einsum and lax.top_k ominix_mlx_tpu/models/"
              "sparse_attention.py:150-166, no Pallas kernel",
              "ominix_mlx_tpu_torch/csrc/sparse_attn.cu", k11_select_rows,
              lambda rs: next(r for r in rs if r["S"] == 524288),
              "k11_select", design=K11_SELECT_DESIGN),
        entry("k11_attend",
              "XLA gather and sdpa ominix_mlx_tpu/models/sparse_attention.py:"
              "165-197, no Pallas kernel",
              "ominix_mlx_tpu_torch/csrc/sparse_attn.cu", k11_attend_rows,
              lambda rs: rs[0], "k11_attend", design=K11_ATTEND_DESIGN),
        entry("k12_cif",
              "XLA scan ominix_mlx_tpu/models/paraformer.py:110-155, no "
              "Pallas kernel", "ominix_mlx_tpu_torch/csrc/cif.cu", k12_rows,
              lambda rs: rs[0], "k12", design=K12_DESIGN),
    ]
    for k in kernels:
        if k["launches"] < 1:
            raise RuntimeError(f"{k['name']} never launched on a main path")
    if launches("k9_chunk_scan") != launches("k9_chunk"):
        raise RuntimeError("K9's chunked form: the phases' launches differ")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "max_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    print(smi, flush=True)
    # the last two lines hold their contract's keys and nothing more
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
