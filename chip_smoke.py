#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``kandinsky5_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py [--seconds 1|5|10] [--out DIR]
    python3 chip_smoke.py --tp-seeds 6,7,8   # phase 5's tp forwards and
                                             # controls at other seeds only
    python3 chip_smoke.py --k1               # phase 2's K1 cases only
    python3 chip_smoke.py --k3               # phase 2's K3 cases only
    python3 chip_smoke.py --windows          # phase 2's K3 window-maxima
                                             # cases only
    python3 chip_smoke.py --ff               # phase 2's K2, K8, T2-T4 cases
    python3 chip_smoke.py --gemm             # phase 2's T1, T2, K8, T3, T4
                                             # cases only
    python3 chip_smoke.py --k4 [--k6]        # phase 2's K4 (K6) cases only
    python3 chip_smoke.py --int8             # phase 2's K5, K7 and T5 cases
                                             # only
    python3 chip_smoke.py --text             # phase 3's text check and the
                                             # full-size towers' timings only
    python3 chip_smoke.py --serve [--seconds 10]
                                             # phase 6 alone, on freshly
                                             # built models
    python3 chip_smoke.py --train            # phase 7 alone, on freshly
                                             # built models
    python3 chip_smoke.py --dp               # phases 5a and 5b alone
    python3 chip_smoke.py --sp               # phase 5c alone
    python3 chip_smoke.py --int8-mesh        # phase 2's K5/K7 rank cases
                                             # and phase 5d alone
    python3 chip_smoke.py --serve-mesh       # phase 5e alone
    python3 chip_smoke.py --load             # phase 8 alone, on a freshly
                                             # built DiT and VAE

Phases, each of which must pass (any failure exits nonzero):
  1. build   — compile the hand-written kernels (csrc/*.cu, one nvcc per
               source in parallel, sm_90a) and print ptxas' register /
               shared-memory / spill report and its warnings of serialized
               wgmma;
  2. kernels — K1-K7 against their plain PyTorch versions on the card, in
               bf16, at the shapes the 5 s and 10 s paths give them (K2 at
               47,616, 10,752, 93,696, 1,536 and 256 rows and a batch of two
               whose row tiles straddle the items, with controls, each
               with its TFLOP/s, share of bound and the bf16 library
               chain's time, and its modulation pass alone within one bf16
               ulp; K1
               also at the tp = 2 and 4 ranks' shares of the 5 s shape's
               heads, on a ragged, batched, masked case and on a (1, 2, 4)
               rank's 23,808 queries against the gathered 47,616 keys, each
               with its achieved TFLOP/s and computed exp2 floor in the log;
               every
               decoder conv class for K3, plain and time_padded; K3's
               GroupNorm-fold + SiLU prologue at 128, 256 and 512 channels
               and with carried prefix planes; K3's W8A8 mode plain and with
               the prologue over several TPU W tiles, with a control that
               one scale for the whole tensor fails, and its window-max
               reduction in every instance the decodes and the encode give
               it (with and without the prologue, prefix planes, 128, 256
               and 512 channels, the encoder's shapes), with a control
               (every window one column short); K3 on ragged tiles (H, W not multiples of its
               8 x 16 tile, one output frame, every plane carried, a batch
               of two), each with a control that must fail; every K3 case
               with its TFLOP/s (TOP/s), share of bound and cuDNN's time; K4
               at the smoke's headline chunk, the 1 s stream decode's two
               chunks and a tiled decode's tile, each with its TFLOP/s,
               share of bound, K/V rate through L2 and SDPA's time; K6 at
               the 10 s shape under four masks: STA only, ~15 %, ~35 % and
               ~90 % kept, and on the second sp rank's 732 rows of 7 heads'
               lists over the whole K/V (control: the first rows' lists),
               beside flex_attention; K5 and K7 at K1's four main-path
               shapes and at a (1, 2, 4) rank's (the second sp rank's
               23,808 queries of 7 heads against the 47,616 gathered keys;
               control: Q and K packed from the rank's shard alone) on one
               shared pack_int8 call, K7 bit-equal to K5, K5's error against
               K1 printed as the quantization error, SDPA's time beside), the
               tools kernels T5 (its four modes at the 5 s shape) and T1 (int8
               exact, bf16, at 8192^3, the DiT's projection shapes and two
               ragged shapes, with a control: the last k step left out), K8
               at each tensor-parallel rank's share of the 5 s FF (tp 1, 2,
               4) and the tools kernels T2-T4 at their tool's shapes (T2
               also ragged), each GEMM with its share of bound and its
               factor against its library call,
               with max-abs and relative-L2 errors against stated
               tolerances, CUDA-event times of kernel, plain version and
               (where one PyTorch call computes the same function) that
               call, and each case's bound (bytes, or bf16 and int8
               operations over the card's peak rates);
  3. reference — a cut-depth, full-width DiT (dense; NABLA on a
               (1,4,64,96) latent; int8, i.e. flash_int8 attention and W8A8
               projections, on a (1,2,48,64) latent, launching K5 4 times)
               and the full-width VAE decode on a small input (streaming,
               its first chunk large enough for K4; and tiled over 2
               temporal x 2 x 2 spatial tiles, fused, in bf16 and with int8
               convs), on the card (kernels) against the same weights in
               fp32 on the CPU (plain versions); then the text towers
               (plain PyTorch: no kernel is on this path): Qwen2.5-VL at
               full width with 2 of its 28 layers in bf16 and CLIP ViT-L/14
               whole in fp32, seeded, against the same weights in fp32 on
               the CPU on one prompt of each template through the stand-in
               tokenizers (the repository holds no tokenizer file): Qwen's
               cropped hidden states and its prefill logits within
               TEXT_BOUND, CLIP's pooled vector within CLIP_BOUND, with two
               controls that must fail them (the crop one position early,
               CLIP pooled at the last position); the Qwen tower's hidden
               states, 8 greedy tokens and 4 on its int8 decode tree, with
               each step's top-2 logit margin, saved for phase 5d;
  4. pipeline — ``Kandinsky5T2VPipeline`` with the full 2B DiT (uniform
               +-0.02 weights from a seed), the full VAE decoder and the
               text stage for real: the full-size Qwen2.5-VL-7B (bf16) and
               CLIP ViT-L/14 (fp32) with seeded weights behind the stand-in
               tokenizers, 16 steps per request; each request prints its
               text seconds (expansion and encode) and its peak memory. The
               5 s path (config_5s_distil.yaml) answers a 512x768 image,
               its prompt expanded (up to 256 new tokens, with the tokens
               and ms per token printed), and a video of ``--seconds`` 1 or
               5 (1 s = 25 frames by default); every kernel of it must
               launch. The 10 s path
               (config_10s_distil.yaml, NABLA) answers a 2 s video (49
               frames, 19,968 tokens), or the 241-frame shape with
               ``--seconds 10``; it must launch K6 exactly 32 x 16 times and
               K1 exactly 2 x 16 times (the text blocks). The 5 s int8
               path answers two videos of the 5 s path's length with the
               bf16 video's prompt and seed: (a) attn_impl "flash_int8",
               K5 exactly (2 + 32) x 16 launches and K1 none; (b)
               "flash_int8_pipe" with W8A8 projections, K7 544, K5, K1 and
               K2 none (the W8A8 visual FFs and the 256-row text FFs run
               the chain, as in the JAX package); each frame PSNR against
               the bf16 video is printed (random weights: not gated). Then
               the decodes: the 5 s path video's latents tiled (2 temporal
               tiles at 1 s), with int8 convs streamed and tiled (PSNR
               against the bf16 decode of the same mode, not gated), a
               17-frame 1024x1024 decode (2 x 2 spatial tiles) and, with
               ``--seconds 10``, the 241-frame latents tiled with their PSNR
               against the streaming decode; each with exact K3 (by mode)
               and K4 launch counts. Each path's launch counts are reset
               just before it and read just after. Then the expansion on
               int8 decode weights (``int8_expand``, timed, not gated), and
               the image request again through ``offload=True``: its peak
               must be lower than the resident request's, and its expanded
               prompt and its frames must equal them exactly. The requests'
               text embeddings and expansion are saved for phase 5, and the
               wall time the text stage added is printed;
  5. tensor parallelism — ranks sharing the one card over gloo (CUDA
               tensors staged through the host; the kernels are built
               before any rank starts): one DiT forward at full width and
               depth at the 5 s shape (47,616 tokens, seeded +-0.02
               weights, each rank drawing its share one parameter at a
               time) on one device, then as tp = 2 and tp = 4 cut to
               TP_BLOCKS (8 and 4) visual blocks against one device's
               forward at that depth, each rank held against it (TP_BOUND, relative
               L2) with exact launch counts (K8 and K1 one a visual block,
               K1 one a text block, K2 0); in the tp = 4 launch two
               controls must fail the bound (each rank keeps its FF
               partial sum; the out layers' bias added on every rank). Then the tp = 2 pipeline answers
               the 5 s path's video request with TP_VIDEO_STEPS (1; cut
               from 16 so that phases 7 and 5e fit the smoke's time; its image
               request left for phase 5d's) on phase 4's text embeddings
               (replayed from ``--out``), every rank decoding
               its share of the tiles and rank 0 blending and writing, its
               frames against the single-process tiled decode of the same
               latents (FRAME_LEVELS, FRAME_SHARE), K3 and K4 summed over
               the ranks equal to that decode's, exact K8/K1 counts per
               rank; s/step and the all-reduce share (gloo through the
               host, 2 ranks on one card, not a multi-GPU number). A failed
               rank fails the run;
  5a. dp serving — 2 ranks on the (2, 1, 1) mesh sharing the card:
               config_5s_sft.yaml at full width and depth (seeded weights
               drawn on each rank) answers the 1 s video with DP_STEPS (2)
               steps at guidance 5.0 on phase 4's replayed text
               embeddings, the CFG pair split (rank 0 cond, rank 1
               uncond): both ranks' latents equal and within DP_BOUND of
               the single-device batched-CFG run (rank 0, same weights,
               seed and steps), each rank's K1 and K2 counts equal to that
               run's; control: ranks that skip the predictions' gather.
               The request's tiled decode split (a temporal tile a rank)
               and phase 4's 17-frame 1024 x 1024 latents decoded split (2
               x 2 tiles, two a rank): rank 0's frames against the
               single-process tiled decode of the same latents, K3 and K4
               summed over the ranks equal to its; control: two tiles
               swapped before the blend. s/step, gather seconds and bytes,
               peak memory per rank;
  5b. dp x tp — 4 ranks on the (2, 1, 2) mesh, launched as two emulated
               hosts (two node launches of 2 ranks meeting on a TCPStore at
               127.0.0.1, the grid built by the hybrid layout, each tp row
               printed with its host): a two-item DiT call at the
               1 s shape, full width, cut to DPTP_BLOCKS (2 text, 8 visual)
               blocks, each dp group one item over its 2 tp ranks, the
               predictions gathered over dp: every rank within TP_BOUND of
               the single-device call, exact K8/K1 counts (K2 none);
               control: the dp peers' predictions gathered in the wrong
               order;
  5c. the sequence axis — 8 ranks on the (1, 2, 4) mesh (tp 4 over the
               heads, sp 2 over the visual tokens, K/V all-gathered over sp
               into K1 and K6): one DiT forward at full width at the 5 s
               shape, SP_FORWARD_BLOCKS (16) visual blocks deep (cut from
               32 to pay for phase 5e), every rank within TP_BOUND of one
               device's forward at that depth (K1 18, K8 16, K2 0 a rank);
               the 10 s
               NABLA forward at 93,696 tokens cut to SP_BLOCKS (2 text, 4
               visual) against one device's at that depth (K6 4 a rank; the
               mask blocks kept or dropped unlike one device's printed) and
               the 5 s forward at that depth with the controls, which must
               fail TP_BOUND (ranks that skip the K/V all-gather, every rank
               taking RoPE rows from 0, on NABLA every rank taking STA rows
               from 0, on a mask of STA alone whose sound run is held too);
               the pipeline answers phase 4's image request
               (SP_IMAGE_STEPS, 2 of its 16 steps) on the replayed text,
               rank 0's frames against the
               single-process tiled decode of its latents (FRAME_LEVELS,
               FRAME_SHARE). Per
               rank: s a forward, tp all-reduce s, sp gather s and bytes,
               peak GiB (8 ranks time-sharing one card: not a multi-GPU
               number);
  5d. int8 on the mesh — in 5c's launch, on its 8 ranks: a row-parallel
               (7,168 -> 1,792) and a column-parallel (1,792 -> 7,168) W8A8
               linear at a rank's 23,808 rows bit-equal to one device's,
               with three faults that must break the equality (a rank's own
               activation scale, a weight scale from the rank's slice, the
               bias added on every rank); the int8 forward (flash_int8 and
               W8A8, each rank quantizing its own slices) at full width and
               47,616 tokens cut to INT8_BLOCKS (2 text, 4 visual) within
               one device's own int8 error (its int8 forward against its
               bf16 one) of one device's int8 forward, K5 6 launches a
               rank and K1, K8, K2 none; the pipeline with
               ``int8_linear=True, attn_impl="flash_int8"`` answers phase
               4's image request (I8_IMAGE_STEPS, 4 of its 16 steps), K5 34
               a step a rank and K1, K2,
               K8 none, its split decode's launches and rank 0's frames as
               5c's, PSNR against one device's int8 image printed;
               Qwen2.5-VL-7B at full width with 2 layers, bf16, each rank
               drawing its 1/8 (``text/qwen.py`` ``init_qwen_shard_random``,
               sharded over the 8 sp x tp ranks): hidden states and prefill
               logits within TEXT_BOUND of phase 3's one-device run, the
               greedy tokens (and the int8 decode tree's) equal to its up to
               the first step whose top-2 margin is below the measured logit
               error; control: o_proj's sum skipped must fail TEXT_BOUND.
               Per rank and part: seconds, the all-reduces' seconds and
               bytes by dtype (int32 beside bf16), sp gather seconds, peak
               GiB;
  5e. serving on the mesh — 2 ranks on the (1, 1, 2) mesh that
               plan_dit_mesh(2, 28) plans, sharing the card: config_5s_distil
               at full width and depth (each rank's DiT share seeded, the
               full VAE, the seeded stand-in text embedder), world rank 0
               serving HTTP at 127.0.0.1 and rank 1 following it
               (``serve.follow``): two unseeded image requests batch as one
               batch of two; the seeded request, stopped after 2 chunks when
               made directly over a state of another seed (not taken; rank 0
               alone saves, one file left), resumes in the server at step 8
               and its PNG equals the same request made through the mesh
               pipeline directly, whose frames are held against the
               single-process tiled decode of its latents; a request at an
               unsupported size ends in error on both ranks and a later one
               is done; the stop ends the follower. Exact counts a rank (K1
               34 and K8 32 a step, K2 none), K3 and K4 summed over the
               ranks equal to the single-process decodes'; each job's
               queued and generation seconds, each batch's s/step and
               all-reduce share a rank (not a multi-GPU figure);
  6. serving — on phase 4's DiT, VAE and towers (moved back to the card)
               under config_5s_sft.yaml (50 steps, guidance 5.0, its MagCache
               ratios): the 1 s video (25 frames, 10,752 tokens, batched CFG,
               no expansion) without and with MagCache, the launches inside
               the visual block stack counted apart: with MagCache K1 and K2
               there must be exactly 24/50 of the run without it, and the
               text blocks' K1 launches equal; denoise seconds, their ratio
               and the frame PSNR between the two are printed (random
               weights: not gated). With ``--seconds 10`` also
               config_10s_sft.yaml with MagCache on the 2 s video
               (sequential CFG), K6 exactly 32 launches per call that runs
               its visual blocks. Then resume: a state file of another seed
               must not be taken (the request starts at step 0), and the
               MagCache request stopped after 2 chunks of 4 steps must
               resume at step 8 through the pipeline's ``checkpoint_path``
               to latents and frames bit-equal to the uninterrupted run,
               its state file removed. Then ``serve.GenerationServer`` over
               that pipeline on 127.0.0.1 (a free port): two unseeded image
               requests (SERVE_PAIR_STEPS steps) within the batch window
               must run as one batch of two; a seeded image request alone, bit-equal to the same
               request made through the pipeline directly; a request at an
               unsupported size must end in error with the server still
               answering, and a later request (SERVE_PAIR_STEPS) done; any
               other error fails
               the run; queued and generation seconds per job are printed.
               Last, the parity consumer (``tools/parity_check.run_ours``)
               on a dump of the direct request (its noise, its
               conditioning packed as the reference packs it, latents and
               tiled frames), encoding with the towers at the pipeline's
               default scheduler scale, must read the towers' error 0 and
               give bit-equal latents and frames;
  7. training — on phase 4's VAE and towers: (1) the encode at full
               width, bf16 on the card (K3's prologue instance, K3 plain,
               K4) against the same weights in fp32 on the CPU, 9 frames
               at 192 x 256 (the mid block's 2,304 voxels take K4) and 13
               frames at 64 x 128 through two temporal tiles, within
               ENCODE_BOUND, with K3 and K4 launched; the mid attention's
               branch on the card's own input within MID_BOUND, its
               control without the frame-causal ids failing it; the int8
               encode held conv by conv on the card (``held_k3``; control:
               the quantization off); K3 and K4 at the encoder's own
               shapes against their plain versions, beside cuDNN / SDPA;
               (2) full-size encodes timed with their peak memory and
               K3/K4 launches: a 512 x 768 image, a 25-frame 512 x 768 clip
               (temporal tiles), a 1024 x 1024 image (spatial tiles); (3)
               ``precompute_shard`` on four seeded 512 x 768 images with
               the towers, read back equal at fp16, and a
               ``LatentShardLoader`` on the card (batch 2); (4) on its first
               batch the sft DiT at full width (visual_cond) cut to 2 text
               and 2 visual blocks, fp32, dense: the loss and every gradient
               on the card against the CPU within TRAIN_BOUND, no kernel
               launched; control: block 0's self-attention output detached;
               (5) the whole 2B DiT in fp32 with AdamW: ``attn_impl="auto"``
               must raise the kernels' autograd refusal; three
               ``train_step``s, the state saved after step 1, restored after
               step 3 and step 2 taken again: the same loss, parameters
               within RESUME_BOUND (control: the step-0 state); s/step,
               visual tokens/s and peak memory; (6) the Qwen2.5-VL vision
               tower at full width cut to 2 blocks, bf16 on the card
               against fp32 on the CPU on a 448 x 448 image within
               VISION_BOUND (control: the window permutation left out),
               then the whole 32-block tower timed; (7b) ZeRO-1 on 2 dp
               ranks sharing the card: the cut sft DiT of (4), each rank
               on its row of the dp-placed loader's batch of 2, one step's
               loss and parameter update within TRAIN_BOUND of the
               single-process step on the whole batch with the same t and
               noise, each rank's moments at most half the unsharded ones
               (plus any kept whole); control: a step without the
               gradients' mean over dp; (7c) training on the mesh, 2 gloo
               ranks sharing the card: the cut sft DiT of (4) on the
               loader's first batch, one step on (1, 1, 2) and one on
               (1, 2, 1) (768 of the 1,536 tokens a rank): the loss, the
               whole gradients (tp shares assembled) and the parameters'
               update within TRAIN_BOUND of the single-process step at the
               same t and noise; controls that must fail the gradient
               bound: copy_to's backward all-reduce left out (tp), an exit
               gather whose backward sums (sp); each mesh's s/step and its
               all-reduce, all-gather and reduce-scatter seconds;
  8. loading — phase 4's 2B DiT and VAE, Qwen2.5-VL cut to 2 of its 28
               layers at full width and CLIP ViT-L/14 (seeded) written by
               the port's safetensors writer in the released layouts (the
               DiT file, the diffusers VAE, Qwen in two shards under an HF
               index beside a vision entry, the whole-CLIPModel names),
               with small byte-level BPE tokenizers written by hand in
               both released layouts, into a temporary directory under
               ``--out`` (removed after), then loaded back through
               ``get_T2V_pipeline`` (``Kandinsky5TextEmbedder.
               from_pretrained`` inside): every parameter, a DiT forward
               (1,152 visual tokens) and a text encode bit-equal to the
               models in memory fed the same ids; ``transformers``,
               ``tokenizers`` and ``safetensors`` absent from
               ``sys.modules``; control: the VAE file with one header
               offset changed must not load.
The last two stdout lines are the kernels' JSON summary, then
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import math
import os
import re
import shutil
import socket
import sys
import time
import zlib

ROUTE_SOURCES = {
    "K1_flash_fixed": ("kandinsky5_tpu_torch/csrc/flash_fixed.cu",
                       "kandinsky5_tpu/ops/flash_pallas.py:157 _kernel_fixed"),
    "K2_ff_mod": ("kandinsky5_tpu_torch/csrc/ff_mod.cu",
                  "kandinsky5_tpu/ops/ff_pallas.py:69 _ff_mod_kernel"),
    "K3_conv3d": ("kandinsky5_tpu_torch/csrc/conv3d.cu",
                  "kandinsky5_tpu/ops/conv_pallas.py:126 _kernel"),
    "K3_conv3d_fused": ("kandinsky5_tpu_torch/csrc/conv3d.cu",
                        "kandinsky5_tpu/ops/conv_pallas.py:126 _kernel "
                        "(fuse/act, prefix :163-182)"),
    "K3_conv3d_quant": ("kandinsky5_tpu_torch/csrc/conv3d.cu",
                        "kandinsky5_tpu/ops/conv_pallas.py:126 _kernel "
                        "(quant :183-230)"),
    "K3_quant_windows": ("kandinsky5_tpu_torch/csrc/conv3d.cu",
                         "kandinsky5_tpu/ops/conv_pallas.py:126 _kernel "
                         "(quant scale :183-198)"),
    "K4_flash_online": ("kandinsky5_tpu_torch/csrc/flash_online.cu",
                        "kandinsky5_tpu/ops/flash_pallas.py:477 _kernel_online"),
    "K5_flash_int8": ("kandinsky5_tpu_torch/csrc/flash_int8.cu",
                      "kandinsky5_tpu/ops/flash_pallas.py:267 _kernel_fixed_i8"),
    "K6_sparse_nabla": ("kandinsky5_tpu_torch/csrc/sparse_nabla.cu",
                        "kandinsky5_tpu/ops/sparse_pallas.py:67 _kernel"),
    "K7_flash_int8_pipe": ("kandinsky5_tpu_torch/csrc/flash_int8.cu",
                           "kandinsky5_tpu/ops/flash_pallas.py:390 "
                           "_kernel_fixed_i8_pipe"),
    "T1_gemm_i8": ("kandinsky5_tpu_torch/csrc/gemm_i8.cu",
                   "tools/bench_int8mm.py:22 _mm_kernel"),
    "T1_gemm_bf16": ("kandinsky5_tpu_torch/csrc/gemm_i8.cu",
                     "tools/bench_int8mm.py:22 _mm_kernel"),
    "K8_ff": ("kandinsky5_tpu_torch/csrc/ff_mod.cu",
              "kandinsky5_tpu/ops/ff_pallas.py:49 _ff_kernel"),
    "T2_gemm": ("kandinsky5_tpu_torch/csrc/gemm_i8.cu",
                "tools/bench_pallas_gemm.py:43 _gemm_kernel"),
    "T3_ff": ("kandinsky5_tpu_torch/csrc/ff_mod.cu",
              "tools/bench_pallas_gemm.py:88 _ff_kernel"),
    "T4_ff_tiled": ("kandinsky5_tpu_torch/csrc/ff_mod.cu",
                    "tools/bench_pallas_gemm.py:128 _ff_tiled_kernel"),
    "T5_i8_decomp": ("kandinsky5_tpu_torch/csrc/flash_int8.cu",
                     "tools/bench_i8_decomp.py:37 _kernel"),
}
# the tools kernels run in phase 2 only: no path of the system launches them
TOOLS = ("T1_gemm_i8", "T1_gemm_bf16", "T2_gemm", "T3_ff", "T4_ff_tiled",
         "T5_i8_decomp")
# bf16 kernel vs plain on the card: both round the same quantities to bf16
# but sum in different orders, so an output may move by a bf16 ulp (2^-8
# relative); bounds are a few ulps at the outputs' scale. The attention
# checks carry a control: uniform weights over the allowed keys (q = 0 in
# the plain version) must fail the same bound, or the inputs are too weak
# to tell a right kernel from one that ignores its scores.
# K5/K7 and their plain version share the packed inputs and differ only in
# exp2's last bits and the order of sums, so K1's bounds hold. T1's int8
# instance must equal the exact product. T5's outputs are garbage of any
# scale: its max-abs bound is relative to the plain output's largest value.
# K3's W8A8 mode and its plain version take the same codes (the prologue and
# the scales are the same fp32 operations on the card), sum them exactly and
# dequantize alike: equal, but for codes flipped where a transformed value
# lies within an ulp of a rounding (``_flips_only``); the window scales must
# equal their plain version exactly.
TOL = {"K1_flash_fixed": (3e-2, 1e-2), "K2_ff_mod": (6e-2, 1e-2),
       "K2_modulate": (0.0, 0.0),
       "K3_conv3d": (6e-2, 1e-2), "K3_conv3d_fused": (6e-2, 1e-2),
       "K3_conv3d_quant": (0.0, 0.0), "K3_quant_windows": (0.0, 0.0),
       "K4_flash_online": (3e-2, 1e-2),
       "K5_flash_int8": (3e-2, 1e-2), "K6_sparse_nabla": (3e-2, 1e-2),
       "K7_flash_int8_pipe": (3e-2, 1e-2), "K8_ff": (6e-2, 1e-2),
       "T1_gemm_i8": (0.0, 0.0), "T1_gemm_bf16": (6e-2, 1e-2),
       "T2_gemm": (6e-2, 1e-2), "T3_ff": (6e-2, 1e-2),
       "T4_ff_tiled": (6e-2, 1e-2), "T5_i8_decomp": (1e-2, 1e-2)}
# published dense peaks of one H100 SXM (700 W): bf16 and int8 tensor cores
# and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
CONF5 = "config_5s_distil.yaml"
CONF10 = "config_10s_distil.yaml"
# the case of each kernel that its JSON entry reports (K3_conv3d: the last
# decoder class, 128->128 12x512x768 time_padded, before the ragged cases)
HEADLINE = {"K1_flash_fixed": 0, "K2_ff_mod": 0, "K3_conv3d": 15,
            "K3_conv3d_fused": 0, "K3_conv3d_quant": 1, "K3_quant_windows": 0,
            "K4_flash_online": 0, "K5_flash_int8": 0, "K6_sparse_nabla": 1,
            "K7_flash_int8_pipe": 0, "K8_ff": 1, "T1_gemm_i8": 0,
            "T1_gemm_bf16": 0, "T2_gemm": 0, "T3_ff": 0, "T4_ff_tiled": 0,
            "T5_i8_decomp": 0}
# the prompt of the 5 s path's bf16 video and of both int8 videos
VIDEO_PROMPT = "a smoke-test video"


class Failure(Exception):
    pass


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# phase 2: kernels against plain versions
# ---------------------------------------------------------------------------

def _time_ms(fn, reps: int) -> float:
    return _timed(fn, reps)[1]


def _timed(fn, reps: int = 1):
    """(the last call's result, ms a call over ``reps`` calls), CUDA
    events around the calls."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


# a plain version whose reference call takes at least this long is timed
# on that call, not on a second one, which would cost phase 2 about 35 s
# more (its fp32 plain versions take up to 11 s a call on an H100 80GB
# HBM3 at 700 W); a quicker one is timed on a second, warm call
PLAIN_ONCE_MS = 200.0


def _errors(out, ref):
    import torch

    o, r = out.float(), ref.float()
    if not bool(torch.isfinite(o).all()):
        return float("inf"), float("inf")
    return ((o - r).abs().max().item(),
            ((o - r).norm() / r.norm().clamp_min(1e-30)).item())


def bound_ms(flops: float, nbytes: float, int8_ops: float = 0.0):
    """The least time the card could take: the larger of the operations
    (bf16 ones over the bf16 tensor-core peak plus int8 ones over the int8
    peak) and the bytes over the memory rate."""
    t_ops = (flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS) * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def _compare(name, shape, kernel_fn, plain_fn, results, work, reps=5,
             control_fn=None, library_fn=None, info=None, yardstick_fn=None,
             check=None, control_label=None,
             yardstick_label="bf16 SDPA: not the same function",
             check_label="flips only"):
    """Check ``kernel_fn`` against ``plain_fn`` and time both (and
    ``library_fn``, one PyTorch call computing the same function, if
    given; ``yardstick_fn``, a call that computes a different function,
    is timed and labelled ``yardstick_label``). ``work`` = (bf16 flops,
    bytes[, int8 ops]) of the call for its bound. ``check(out, ref)`` ->
    bool replaces the tolerance test (the control must fail it too;
    ``check_label`` names it in the log)."""
    import torch

    out = kernel_fn()
    torch.cuda.synchronize()
    ref, plain_ms = _timed(plain_fn)
    max_abs, rel = _errors(out, ref)
    atol, rtol = TOL[name]
    if check is not None:
        ok = check(out, ref)
    elif name in ("T1_gemm_i8", "K3_quant_windows"):
        ok = bool(torch.equal(out, ref))
    else:
        if name == "T5_i8_decomp":
            info = dict(info or {}, scale=ref.float().abs().max().item())
            atol *= info["scale"]
        ok = max_abs <= atol and rel <= rtol
    note = ""
    if control_fn is not None:
        control = control_fn()
        c_abs, c_rel = _errors(control, ref)
        if check is not None:
            control_fails = not check(out, control)
            label = control_label or "one scale for the whole tensor"
        else:
            control_fails = not (c_abs <= atol and c_rel <= rtol)
            label = control_label or "uniform weights"
        note = (f" control ({label}): max_abs {c_abs:.3e} rel_l2 "
                f"{c_rel:.3e} {'fails the bound' if control_fails else 'PASSES'}")
        del control
        ok = ok and control_fails
    del out, ref
    ms = _time_ms(kernel_fn, reps)
    if plain_ms < PLAIN_ONCE_MS:
        plain_ms = _time_ms(plain_fn, 1)
    lib_ms = yard_ms = None
    if library_fn is not None:
        library_fn()
        lib_ms = _time_ms(library_fn, reps)
    if yardstick_fn is not None:
        yardstick_fn()
        yard_ms = _time_ms(yardstick_fn, reps)
    b_ms, b_by = bound_ms(*work)
    lib_note = "" if lib_ms is None else f" library {lib_ms:.3f} ms"
    if yard_ms is not None:
        lib_note += f" yardstick {yard_ms:.3f} ms ({yardstick_label})"
    tol_note = (check_label if check is not None else "exact"
                if name in ("T1_gemm_i8", "K3_quant_windows")
                else f"tol {atol:.3g}")
    log(f"  {name} {shape}: max_abs {max_abs:.3e} ({tol_note}) rel_l2 "
        f"{rel:.3e} (tol {rtol}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms"
        f"{lib_note} bound {b_ms:.3f} ms ({b_by}){note} "
        f"{'ok' if ok else 'FAIL'}")
    results.setdefault(name, []).append(dict(
        shape=shape, max_abs=max_abs, rel=rel, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, yardstick_ms=yard_ms,
        yardstick=yardstick_label if yard_ms is not None else None, ok=ok,
        **(info or {})))
    torch.cuda.empty_cache()


def _sdpa(q, k, v, attn_mask=None):
    """scaled_dot_product_attention on (B, L, H, D) inputs, transposed to
    its (B, H, L, D) layout before the timed call."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=attn_mask)


def _max_sm_clock_hz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reports it."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout
    return float(out.split()[0]) * 1e6


def _clock_under(fn, seconds: float = 2.0) -> str:
    """Run ``fn`` back to back for about ``seconds`` while ``nvidia-smi``
    samples the SM clock and the power draw every 100 ms; their medians."""
    import subprocess

    import torch

    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    rows = [[float(x) for x in line.split(",")] for line in out.splitlines()
            if line.strip()][2:]  # the first samples precede the load
    if not rows:
        return "clock not sampled"
    mid = len(rows) // 2
    clk = sorted(r[0] for r in rows)[mid]
    watts = sorted(r[1] for r in rows)[mid]
    return f"SM clock {clk:.0f} MHz, {watts:.1f} W (medians of {len(rows)} samples)"


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _seeded(dev):
    """Phase 2's generator and its maker of bf16 rows of unit RMS."""
    import torch

    g = torch.Generator(device=dev).manual_seed(1234)

    def normed(shape):
        x = torch.randn(shape, generator=g, device=dev)
        return (x * torch.rsqrt(x.square().mean(-1, keepdim=True))).bfloat16()

    return g, normed


def phase_k1(dev, g, normed, results):
    """K1 at visual self-attention's 5 s, 1 s and image sizes (47,616,
    10,752 and 1,536 tokens), text self-attention (256 tokens, 77 valid),
    the 5 s shape at the tp = 2 and 4 ranks' shares of the heads, a
    ragged, batched case (Lq 1000, Lk 700, a valid length per batch), and a
    (1, 2, 4) rank's query shard (23,808 queries, 7 heads) against the
    gathered 47,616 keys, as phase 5c runs it. The
    log gives, beside the tensor-core bound, the achieved rate and an exp2
    floor that is computed, not measured: one exp2 per (query, valid key)
    at an assumed 16 per clock per SM (the special-function units' rate on
    sm_90) at the card's highest SM clock; and the SM clock and power under
    a steady run of the first case."""
    import torch

    from kandinsky5_tpu_torch.ops.flash import flash_fixed, flash_fixed_plain

    exp2_rate = 16 * torch.cuda.get_device_properties(dev).multi_processor_count \
        * _max_sm_clock_hz()
    for b, lq, lk, h, valid in ((1, 47616, 47616, 28, None),
                                (1, 10752, 10752, 28, None),
                                (1, 1536, 1536, 28, None),
                                (1, 256, 256, 28, (77,)),
                                (1, 47616, 47616, 14, None),
                                (1, 47616, 47616, 7, None),
                                (2, 1000, 700, 3, (466, 140)),
                                (1, 23808, 47616, 7, None)):
        q, k = normed((b, lq, h, 64)), normed((b, lk, h, 64))
        v = torch.randn((b, lk, h, 64), generator=g, device=dev).bfloat16()
        mask = None
        if valid is not None:
            mask = torch.arange(lk, device=dev)[None] \
                < torch.tensor(valid, device=dev)[:, None]
        n_keys = lk * b if valid is None else sum(valid)
        shape = (f"({b},{lq},{h},64)" if lq == lk else
                 f"({b},{lq}/{lk},{h},64)") + (" mask" if valid else "")
        _compare("K1_flash_fixed", shape,
                 lambda: flash_fixed(q, k, v, mask),
                 lambda: flash_fixed_plain(q, k, v, mask), results,
                 work=(4.0 * lq * n_keys * h * 64,
                       _nbytes(q, k, v, q, mask)),
                 reps=3 if lq > 10000 else 20,
                 control_fn=lambda: flash_fixed_plain(q * 0, k, v, mask),
                 library_fn=_sdpa(q, k, v, None if mask is None
                                  else mask[:, None, None, :]))
        r = results["K1_flash_fixed"][-1]
        r["tflops"] = 4.0 * lq * n_keys * h * 64 / r["ms"] / 1e9
        exp2_floor = lq * n_keys * h / exp2_rate * 1e3
        log(f"    {r['tflops']:.1f} TFLOP/s ({100 * r['bound_ms'] / r['ms']:.1f} "
            f"% of the tensor-core bound); exp2 floor {exp2_floor:.3f} ms "
            f"at the highest SM clock ({100 * exp2_floor / r['ms']:.1f} %); "
            f"{r['ms'] / r['library_ms']:.2f}x SDPA")
        if len(results["K1_flash_fixed"]) == 1:
            log("    under a steady run of K1: "
                + _clock_under(lambda: flash_fixed(q, k, v, mask)))
        del q, k, v


def k4_tiles_read(lq, lk, mask, q_ids, kv_ids) -> int:
    """The 32-key K/V tiles K4's blocks read in one call (B = H = 1), from
    the wrapper's own tables: a block reads its live tiles, less the fully
    masked ones where it may skip them."""
    import torch

    from kandinsky5_tpu_torch.ops.flash import online_plan

    _, plan, nxt = online_plan(1, lq, lk, mask, q_ids, kv_ids,
                               q_ids.device)
    n_live, skip = plan[0, :, 0].long(), plan[0, :, 1].bool()
    if nxt is None:
        return int(n_live.sum())
    nt = nxt.shape[1] - 1
    valid = nxt[0, :nt] == torch.arange(nt, device=nxt.device)
    before = torch.cat([valid.new_zeros(1, dtype=torch.long),
                        valid.long().cumsum(0)])
    return int(torch.where(skip, before[n_live], n_live).sum())


def phase_k4(dev, g, results):
    """K4 at the VAE mid block's shapes (one head of 512, 64x96 latent
    frames of 6,144 tokens): the smoke's headline chunk (4 frames against
    4 carried + 4, 2 of the 4 carried slots valid), the 1 s stream
    decode's two chunks (4 frames with nothing carried yet; 3 frames after
    a full buffer), and a tiled decode's tile (5 frames, q = kv, no mask).
    Each logs its TFLOP/s over the allowed (query, key) pairs, its share
    of the tensor-core bound and SDPA's time in the same run (SDPA with
    the same boolean mask: the same function but for the weights' bf16
    rounding and a row with no allowed key). Unit q and k give scores of
    standard deviation 1 (spread over several units across the keys), so
    the weights are far from uniform."""
    import torch

    for t, past, filled in ((4, 4, 2), (4, 4, 0), (3, 4, 4), (5, 0, 0)):
        run = _k4_case(dev, g, results, t, 6144, past, filled)
        if len(results["K4_flash_online"]) == 1:
            log("    under a steady run of K4: " + _clock_under(run))
        del run
    torch.cuda.empty_cache()


def _k4_case(dev, g, results, t: int, s: int, past: int = 0, filled: int = 0,
             label: str = ""):
    """One K4 case of the mid block: ``t`` frames of ``s`` tokens against
    ``past`` carried frames (``filled`` of them valid) and themselves, held
    against the plain version with a uniform-weight control, timed beside
    SDPA with the same boolean mask; its TFLOP/s and K/V rate are logged.
    Returns the kernel call on the case's inputs."""
    import torch

    from kandinsky5_tpu_torch.ops.flash import flash_online, flash_online_plain

    q = torch.randn((1, t * s, 1, 512), generator=g, device=dev).bfloat16()
    k = torch.randn((1, (past + t) * s, 1, 512), generator=g,
                    device=dev).bfloat16()
    v = torch.randn((1, (past + t) * s, 1, 512), generator=g,
                    device=dev).bfloat16()
    slot = torch.arange(past, device=dev)
    kv_ids = torch.cat([slot.repeat_interleave(s), (past + torch.arange(
        t, device=dev)).repeat_interleave(s)])[None]
    q_ids = kv_ids[:, past * s:]
    mask = None
    if past:
        mask = torch.cat([(slot >= past - filled).repeat_interleave(s),
                          torch.ones(t * s, dtype=torch.bool,
                                     device=dev)])[None]
    # the (query, key) pairs the ids and the mask allow: the work K4 does
    # and the library call's boolean mask
    allowed = q_ids[0, :, None] >= kv_ids[0, None, :]
    if mask is not None:
        allowed &= mask[0, None, :]
    pairs = int(allowed.sum())
    label = label or (f"q {t * s} kv {(past + t) * s} d 512"
                      + (f", {filled} of {past} carried valid" if past
                         else ", tiled tile (q = kv)"))
    _compare("K4_flash_online", label,
             lambda: flash_online(q, k, v, mask, q_ids, kv_ids),
             lambda: flash_online_plain(q, k, v, mask, q_ids, kv_ids),
             results,
             work=(4.0 * pairs * 512,
                   _nbytes(q, k, v, q, mask, q_ids, kv_ids)),
             control_fn=lambda: flash_online_plain(q * 0, k, v, mask,
                                                   q_ids, kv_ids),
             library_fn=_sdpa(q, k, v, allowed[None, None]))
    r = results["K4_flash_online"][-1]
    r["tflops"] = 4.0 * pairs * 512 / r["ms"] / 1e9
    r["kv_gb"] = k4_tiles_read(q.shape[1], k.shape[1], mask, q_ids,
                               kv_ids) * 2 * 32 * 1024 / 1e9
    log(f"    {r['tflops']:.1f} TFLOP/s ({100 * r['bound_ms'] / r['ms']:.1f} "
        f"% of the tensor-core bound); {r['ms'] / r['library_ms']:.2f}x "
        f"SDPA; K/V tiles read {r['kv_gb']:.2f} GB, "
        f"{r['kv_gb'] / r['ms']:.2f} TB/s through L2")
    return lambda: flash_online(q, k, v, mask, q_ids, kv_ids)


def _rate(results, name, ops: float, against: str = "the bf16 chain"):
    """Log the last case's rate (TFLOP/s, or TOP/s for int8), its share of
    the bound and its time against ``against``, the library call or
    yardstick timed beside it (the bf16 chain for K8, K2 and T3-T4;
    ``_int_mm`` or bf16 ``matmul`` for T1 and T2)."""
    r = results[name][-1]
    r["tflops"] = ops / r["ms"] / 1e9
    r["bound_share"] = r["bound_ms"] / r["ms"]
    lib = r["library_ms"] or r["yardstick_ms"]
    r["factor"] = r["ms"] / lib
    unit = "TOP/s" if name == "T1_gemm_i8" else "TFLOP/s"
    log(f"    {r['tflops']:.1f} {unit} ({100 * r['bound_share']:.1f} % of the "
        f"bound); {against} {lib:.3f} ms, kernel {r['factor']:.2f}x")


def _k2_chain(x, sc, sh, w1, w2, gt):
    """K2's yardstick, timed only: the bf16 library chain F.layer_norm ->
    modulation -> matmul -> GELU -> matmul -> gated residual (no single
    PyTorch call computes K2)."""
    import torch
    import torch.nn.functional as F

    d = x.shape[-1]
    s1, s0, g1 = ((v[:, None] + a).bfloat16() for v, a in ((sc, 1.0),
                                                           (sh, 0.0),
                                                           (gt, 0.0)))
    w1t, w2t = w1.t(), w2.t()
    return lambda: x + g1 * torch.matmul(F.gelu(torch.matmul(
        F.layer_norm(x, (d,), eps=1e-5) * s1 + s0, w1t)), w2t)


def _within_ulp(out, ref) -> bool:
    """Every bf16 output within one bf16 ulp of the plain one, or 2^-20
    where the shift cancels the normed term to near zero."""
    import torch

    _, e = torch.frexp(ref.float())
    bound = torch.ldexp(torch.ones_like(ref, dtype=torch.float32),
                        e - 8).clamp_min(2.0 ** -20)
    return bool(((out.float() - ref.float()).abs() <= bound).all())


def phase_k2(dev, g, results):
    """K2 at the visual blocks' 5 s, 10 s and 1 s shapes (47,616, 93,696
    and 10,752 rows), the image (1,536) and the text blocks (256), and a
    batch of two whose L (1,000) is not a multiple of the 128-row tile, so
    a tile holds rows of both items. Controls: the FF term left out (out =
    x), and at B = 2 the items' gates swapped; each must fail the bound.
    Each case logs its TFLOP/s, share of bound and the bf16 chain's time;
    then the modulation pass alone on 47,616 rows in two items, each output
    within one bf16 ulp of the plain version's (its control: the other
    item's scale)."""
    import torch

    from kandinsky5_tpu_torch.ops.ff import (
        ff_mod_plain,
        fused_ff_modulated,
        modulate,
        modulate_plain,
    )

    d, ff = 1792, 7168
    w1 = (torch.randn((ff, d), generator=g, device=dev) / math.sqrt(d)).bfloat16()
    w2 = (torch.randn((d, ff), generator=g, device=dev) / math.sqrt(ff)).bfloat16()
    for b, l in ((1, 47616), (1, 10752), (1, 256), (1, 1536), (2, 1000),
                 (1, 93696)):
        sc, sh, gt = (torch.randn((b, d), generator=g, device=dev) * 0.1
                      for _ in range(3))
        x = torch.randn((b, l, d), generator=g, device=dev).bfloat16()
        if b == 2:
            control, label = (lambda: ff_mod_plain(x, sc, sh, w1, w2,
                                                   gt.flip(0)),
                              "the two items' gates swapped")
        else:
            control, label = (lambda: x, "the FF term left out (out = x)")
        flops = 4.0 * b * l * d * ff
        _compare("K2_ff_mod", f"({b},{l},{d})x{ff}",
                 lambda: fused_ff_modulated(x, sc, sh, w1, w2, gt),
                 lambda: ff_mod_plain(x, sc, sh, w1, w2, gt), results,
                 work=(flops, _nbytes(x, x, w1, w2, sc, sh, gt)),
                 control_fn=control, control_label=label,
                 yardstick_fn=_k2_chain(x, sc, sh, w1, w2, gt),
                 yardstick_label="the bf16 chain LN -> modulation -> matmul "
                 "-> GELU -> matmul -> gate: no single call")
        _rate(results, "K2_ff_mod", flops)
        del x
    del w1, w2
    x = torch.randn((2, 23808, d), generator=g, device=dev).bfloat16()
    sc, sh = (torch.randn((2, d), generator=g, device=dev) * 0.1
              for _ in range(2))
    _compare("K2_modulate", f"(2,23808,{d})",
             lambda: modulate(x, sc, sh), lambda: modulate_plain(x, sc, sh),
             results, work=(0.0, _nbytes(x, x, sc, sh)), check=_within_ulp,
             check_label="one bf16 ulp",
             control_fn=lambda: modulate_plain(x, sc.flip(0), sh),
             control_label="the other item's scale")
    del x
    torch.cuda.empty_cache()


def phase_kernels(dev, results):
    g, normed = _seeded(dev)
    phase_k1(dev, g, normed, results)
    phase_k2(dev, g, results)
    phase_k3(dev, g, results)
    phase_k4(dev, g, results)
    phase_k6(dev, g, normed, results)
    phase_int8(dev, g, normed, results)
    phase_gemm(dev, g, results)
    bad = [(n, r["shape"]) for n, rs in results.items() for r in rs if not r["ok"]]
    if bad:
        raise Failure(f"kernels outside tolerance: {bad}")


def _cudnn_conv(x, wt, bias, time_padded: bool):
    """cuDNN's conv3d on ``x`` padded beforehand (replicate), channels-last
    like K3's input: the library call timed beside K3."""
    import torch
    import torch.nn.functional as F

    xp = F.pad(x.permute(0, 4, 1, 2, 3), (1, 1, 1, 1, 0 if time_padded else 2, 0),
               mode="replicate")
    xp = xp.contiguous(memory_format=torch.channels_last_3d)
    return lambda: F.conv3d(xp, wt, bias)


def _k3_rate(results, name, macs: float, int8: bool = False):
    """Log the last K3 case's rate, its share of the bound and its time
    against cuDNN's conv3d in the same run (bf16 cuDNN beside W8A8: not the
    same function)."""
    r = results[name][-1]
    r["tflops"] = 2.0 * macs / r["ms"] / 1e9
    lib = r["library_ms"] or r["yardstick_ms"]
    log(f"    {r['tflops']:.1f} {'TOP/s' if int8 else 'TFLOP/s'} "
        f"({100 * r['bound_ms'] / r['ms']:.1f} % of the bound); cuDNN"
        f"{' bf16' if int8 else ''} {lib:.3f} ms, kernel {r['ms'] / lib:.2f}x")


def _k3_zero_padded(x, wt, bias, time_padded: bool, rows_cols: bool = True):
    """Control for K3's edges: the plain conv with zeros where the kernel
    replicates (the edge rows and columns, or the two leading frames)."""
    import torch.nn.functional as F

    xc = x.permute(0, 4, 1, 2, 3).float()
    if rows_cols:
        xc = F.pad(xc, (0, 0, 0, 0, 0 if time_padded else 2, 0), mode="replicate")
        y = F.conv3d(xc, wt.float(), bias.float(), padding=(0, 1, 1))
    else:
        xc = F.pad(xc, (1, 1, 1, 1, 0, 0), mode="replicate")
        y = F.conv3d(xc, wt.float(), bias.float(), padding=(0 if time_padded else 2, 0, 0))
        y = y[:, :, :x.shape[1] - (2 if time_padded else 0)]
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


def phase_k3(dev, g, results):
    """K3 (``csrc/conv3d.cu``) at every decoder conv class (vae.py:336-385)
    at the streaming decode's chunk lengths, unpadded and ``time_padded``;
    its other modes (:func:`phase_k3_modes`); and ragged cases that the
    kernel's 8 x 16 output tile must mask, each with a control that must
    fail the bound: H and W that are not multiples of the tile (control:
    zeros in place of the replicated edges), one output frame (control:
    zeros in place of the two replicated leading frames), the prologue with
    every input plane carried (control: every plane transformed) and a
    batch of two (control: the items swapped). The library call is cuDNN's
    conv3d on an input padded (and transformed) beforehand."""
    import torch

    from kandinsky5_tpu_torch.ops import conv as conv_mod

    def weights(cin, cout):
        wt = (torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev)
              / math.sqrt(27 * cin)).bfloat16()
        return wt, torch.randn((cout,), generator=g, device=dev).bfloat16()

    classes = [(512, 512, 64, 96, 4), (512, 512, 128, 192, 7),
               (512, 512, 256, 384, 13), (512, 256, 256, 384, 13),
               (256, 256, 256, 384, 13), (256, 256, 512, 768, 12),
               (256, 128, 512, 768, 12), (128, 128, 512, 768, 12)]
    for cin, cout, hh, ww, t in classes:
        wt, bias = weights(cin, cout)
        for padded in (False, True):
            tin = t + 2 if padded else t
            x = torch.randn((1, tin, hh, ww, cin), generator=g,
                            device=dev).bfloat16()
            macs = 27.0 * t * hh * ww * cin * cout
            _compare("K3_conv3d",
                     f"{cin}->{cout} {t}x{hh}x{ww}"
                     f"{' time_padded' if padded else ''}",
                     lambda: conv_mod.causal_conv3d_fused(x, wt, bias, padded),
                     lambda: conv_mod.conv3d_plain(x, wt, bias, padded), results,
                     work=(2.0 * macs, _nbytes(x, wt, bias) + 2 * t * hh * ww * cout),
                     reps=2, library_fn=_cudnn_conv(x, wt, bias, padded))
            _k3_rate(results, "K3_conv3d", macs)
            del x

    phase_k3_modes(dev, g, results)

    def ragged(name, b, cin, cout, t, hh, ww, padded, control, label,
               prefix=None):
        """One ragged case; with ``prefix``, the prologue (SiLU) with that
        many carried planes."""
        wt, bias = weights(cin, cout)
        x = torch.randn((b, t, hh, ww, cin), generator=g, device=dev).bfloat16()
        t_out = t - 2 if padded else t
        macs = 27.0 * b * t_out * hh * ww * cin * cout
        kw, xt = {}, x
        if prefix is not None:
            kw = dict(scale=1 + 0.2 * torch.randn((cin,), generator=g, device=dev),
                      shift=0.1 * torch.randn((cin,), generator=g, device=dev),
                      act=True, prefix_planes=prefix)
            xt = conv_mod.conv_prologue(x, kw["scale"], kw["shift"], True, prefix)
        _compare(name, f"{b}x {cin}->{cout} {t_out}x{hh}x{ww}"
                 f"{' time_padded' if padded else ''} ragged ({label})",
                 lambda: conv_mod.causal_conv3d_fused(x, wt, bias, padded, **kw),
                 lambda: conv_mod.conv3d_plain(x, wt, bias, padded, **kw), results,
                 work=(2.0 * macs, _nbytes(x, wt, bias) + 2 * b * t_out * hh * ww * cout),
                 reps=3, control_fn=lambda: control(x, wt, bias, kw),
                 control_label=label, library_fn=_cudnn_conv(xt, wt, bias, padded))
        _k3_rate(results, name, macs)
        del x, xt

    ragged("K3_conv3d", 1, 256, 256, 4, 61, 93, False,
           lambda x, wt, b, kw: _k3_zero_padded(x, wt, b, False),
           "zeros at the h and w edges")
    ragged("K3_conv3d", 1, 128, 128, 5, 125, 187, True,
           lambda x, wt, b, kw: _k3_zero_padded(x, wt, b, True),
           "zeros at the h and w edges")
    ragged("K3_conv3d", 1, 512, 512, 1, 64, 96, False,
           lambda x, wt, b, kw: _k3_zero_padded(x, wt, b, False, rows_cols=False),
           "zeros as the two leading frames")
    ragged("K3_conv3d_fused", 1, 128, 128, 3, 128, 192, True,
           lambda x, wt, b, kw: conv_mod.conv3d_plain(
               x, wt, b, True, **dict(kw, prefix_planes=0)),
           "every plane transformed", prefix=3)
    ragged("K3_conv3d", 2, 256, 256, 5, 64, 96, True,
           lambda x, wt, b, kw: conv_mod.conv3d_plain(x, wt, b, True).flip(0),
           "the batch items swapped")


def _flips_only(x, wt, flips: int = 8):
    """The check of K3's W8A8 mode against its plain version (see TOL):
    equal outputs except for at most ``flips`` flipped codes, each moving
    the outputs of its 3x3x3 neighbourhood (27 voxels x Cout) by at most
    one step, s * max|w| <= max|x| / 127 * max|w|; ``x`` is the conv's
    transformed input."""
    step = float(x.float().abs().max()) / 127.0 * float(wt.float().abs().max())

    def check(out, ref):
        d = (out.float() - ref.float()).abs()
        return (int((d > 0).sum()) <= flips * 27 * out.shape[-1]
                and float(d.max()) <= 2 * step)
    return check


def phase_k3_modes(dev, g, results):
    """K3's other modes at the decoder's classes for a 17-frame 512x768
    tile (latents 5 x 64 x 96): the GroupNorm-fold + SiLU prologue at
    128->128 (17x512x768), 256->256 (9x256x384) and 512->512 (5x128x192),
    and with two prefix planes at the streaming chunk's shape (128->128, 12
    + 2 frames, time_padded); W8A8 plain at 256->256 (9x256x384, four W
    tiles of 96) and with the prologue at 128->128 (17x512x768, four W
    tiles of 192), the latter with a control that one scale for the whole
    tensor fails; then the window-max reduction alone in every instance
    (:func:`phase_windows`). The
    library call is cuDNN's conv3d on an input transformed and padded
    beforehand; no PyTorch call is an int8 conv3d or a window max, so bf16
    cuDNN is timed beside W8A8 as a yardstick, and so is K3's bf16 instance
    on the same inputs."""
    import torch

    from kandinsky5_tpu_torch.ops import conv as conv_mod

    def inputs(cin, cout, t, hh, ww):
        x = torch.randn((1, t, hh, ww, cin), generator=g, device=dev).bfloat16()
        wt = (torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev)
              / math.sqrt(27 * cin)).bfloat16()
        bias = torch.randn((cout,), generator=g, device=dev).bfloat16()
        sc = 1 + 0.2 * torch.randn((cin,), generator=g, device=dev)
        sh = 0.1 * torch.randn((cin,), generator=g, device=dev)
        return x, wt, bias, sc, sh

    def cudnn(x, wt, bias, tp, sc, sh, prefix=0):
        xt = conv_mod.conv_prologue(x, sc, sh, True, prefix)
        return _cudnn_conv(xt, wt, bias, tp)

    for cin, cout, t, hh, ww, tp in ((128, 128, 17, 512, 768, False),
                                     (256, 256, 9, 256, 384, False),
                                     (512, 512, 5, 128, 192, False),
                                     (128, 128, 14, 512, 768, True)):
        x, wt, bias, sc, sh = inputs(cin, cout, t, hh, ww)
        kw = dict(time_padded=tp, scale=sc, shift=sh, act=True,
                  prefix_planes=2 if tp else 0)
        t_out = t - 2 if tp else t
        _compare("K3_conv3d_fused",
                 f"{cin}->{cout} {t_out}x{hh}x{ww}"
                 f"{' time_padded prefix 2' if tp else ''}",
                 lambda: conv_mod.causal_conv3d_fused(x, wt, bias, **kw),
                 lambda: conv_mod.conv3d_plain(x, wt, bias, **kw), results,
                 work=(2.0 * 27 * t_out * hh * ww * cin * cout,
                       _nbytes(x, wt, bias, sc, sh) + 2 * t_out * hh * ww * cout),
                 reps=2, library_fn=cudnn(x, wt, bias, tp, sc, sh, kw["prefix_planes"]))
        _k3_rate(results, "K3_conv3d_fused", 27.0 * t_out * hh * ww * cin * cout)
        del x

    real_scales = conv_mod.window_scales

    def one_scale(*args):
        s, _ = real_scales(*args)
        top = s.max()
        return torch.full_like(s, top), torch.full_like(s, 1.0) / top

    for cin, cout, t, hh, ww, fuse in ((256, 256, 9, 256, 384, False),
                                       (128, 128, 17, 512, 768, True)):
        x, wt, bias, sc, sh = inputs(cin, cout, t, hh, ww)
        # windows of different scales: the magnitude grows along W
        x = (x.float() * (1 + torch.arange(ww, device=dev)[:, None] / ww)).bfloat16()
        kw = dict(quant=True)
        if fuse:
            kw.update(scale=sc, shift=sh, act=True)
        xt = conv_mod.conv_prologue(x, sc, sh) if fuse else x
        bw = conv_mod.quant_tile_width(ww, cin, cout)
        w8, _ = conv_mod.quantized_weight(wt)

        def control():
            conv_mod.window_scales = one_scale
            try:
                return conv_mod.conv3d_plain(x, wt, bias, **kw)
            finally:
                conv_mod.window_scales = real_scales

        ops = 2.0 * 27 * t * hh * ww * cin * cout
        _compare("K3_conv3d_quant",
                 f"{cin}->{cout} {t}x{hh}x{ww} bw {bw}"
                 f"{' with the prologue' if fuse else ''}",
                 lambda: conv_mod.causal_conv3d_fused(x, wt, bias, **kw),
                 lambda: conv_mod.conv3d_plain(x, wt, bias, **kw), results,
                 work=(0.0, _nbytes(x, w8, bias) + 2 * t * hh * ww * cout, ops),
                 reps=2, check=_flips_only(xt, wt),
                 control_fn=control if fuse else None,
                 info=dict(windows=t * (hh // 8) * (ww // bw)),
                 yardstick_fn=_cudnn_conv(xt, wt, bias, False),
                 yardstick_label="bf16 cuDNN conv3d: not the same function")
        _k3_rate(results, "K3_conv3d_quant", ops / 2, int8=True)
        bf16 = {k: v for k, v in kw.items() if k != "quant"}
        r = results["K3_conv3d_quant"][-1]
        r["bf16_k3_ms"] = _time_ms(
            lambda: conv_mod.causal_conv3d_fused(x, wt, bias, **bf16), 2)
        log(f"    K3's bf16 instance on the same inputs {r['bf16_k3_ms']:.3f} ms: "
            f"W8A8 {r['ms'] / r['bf16_k3_ms']:.2f}x")
        del x, xt
    phase_windows(dev, g, results)


def phase_windows(dev, g, results):
    """K3's W8A8 window maxima (``ops.conv.quant_window_scales``) in every
    instance the decodes and the encode give it (``tests/_torch_windows.py``:
    WINDOW_CASES, window_inputs), each equal to its plain version, with a
    control that must fail: every window one column short. The bound is
    the bytes; with the prologue the log gives beside it the MUFU floor, an
    ex2 and a reciprocal an element over the card's 16 MUFU results a clock
    an SM at its highest SM clock (computed, not measured, so it stays out
    of the kernels line). No PyTorch call computes this function."""
    import torch

    from kandinsky5_tpu_torch.ops import conv as conv_mod
    from tests._torch_windows import (
        WINDOW_CASES,
        short_window_scales,
        window_inputs,
    )

    clock = _max_sm_clock_hz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for case in WINDOW_CASES:
        x, kw, xt, bw, label = window_inputs(case, g, dev)
        _, tin, hh, ww, _ = x.shape
        tp, prefix = kw["time_padded"], kw.get("prefix_planes", 0)
        tiles = (tin - 2 if tp else tin) * (hh // 8) * (ww // bw)
        _compare("K3_quant_windows", label,
                 lambda: torch.stack(conv_mod.quant_window_scales(x, bw, **kw)),
                 lambda: torch.stack(conv_mod.window_scales(xt, bw, tp)),
                 results, work=(0.0, _nbytes(x, kw.get("scale"), kw.get("shift"))
                                + 8 * tiles),
                 reps=5, control_fn=lambda: torch.stack(
                     short_window_scales(xt, bw, tp)),
                 control_label="every window one column short")
        r = results["K3_quant_windows"][-1]
        r["bound_share"] = r["bound_ms"] / r["ms"]
        note = ""
        if "scale" in kw:
            elements = (tin - prefix) * hh * ww * x.shape[-1]
            mufu_ms = 2.0 * elements / (16 * sms * clock) * 1e3
            note = f", MUFU floor {mufu_ms:.3f} ms"
        log(f"    {100 * r['bound_share']:.1f} % of the byte bound{note}")
        del x, xt


def _flex_attention(q, k, v, mask):
    """torch's flex_attention (the reference's NABLA route), compiled once,
    as a timed yardstick: ``make(inds, nb)`` gives a call over the blocks
    listed there, passed as full blocks; the mask_mod (which the compiled
    kernel skips on full blocks) reads the block mask from ``mask``, which
    the caller refills in place. Returns (make, None), or (None, reason)
    where flex_attention does not run here."""
    import torch

    try:
        from torch.nn.attention.flex_attention import BlockMask, flex_attention

        def mask_mod(b, h, q_idx, kv_idx):
            return mask[b, h, q_idx // 64, kv_idx // 64]

        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        fn = torch.compile(flex_attention, dynamic=False)
        opts = {"BLOCK_M": 64, "BLOCK_N": 64}

        def make(inds, nb):
            bm = BlockMask.from_kv_blocks(torch.zeros_like(nb), inds, nb, inds,
                                          BLOCK_SIZE=64, mask_mod=mask_mod)
            return lambda: fn(qt, kt, vt, block_mask=bm, kernel_options=opts)

        nb = torch.ones(mask.shape[:3], dtype=torch.int32, device=q.device)
        inds = torch.arange(mask.shape[3], dtype=torch.int32, device=q.device)
        make(inds.expand(*mask.shape).contiguous(), nb)()
        torch.cuda.synchronize()
    except Exception as e:  # a yardstick only: the port never calls it
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    return make, None


def phase_k6(dev, g, normed, results):
    """K6 at the 10 s shape (1, 93,696, 28, 64) under four masks of the
    (61, 4, 6) tile grid: STA only, STA plus seeded random blocks to ~15 %,
    ~35 % and ~90 % kept (the density the 10 s request keeps with random
    weights); then the second sp rank of phase 5c's (1, 2, 4) mesh under
    the 90 % mask (46,848 queries of 7 heads with its 732 rows of the lists,
    over the whole K/V). Beside it K1 at the same shape, dense (where
    sparsity stops paying), and flex_attention as the library call; each
    case logs its TFLOP/s and share of the tensor-core bound."""
    import torch

    from kandinsky5_tpu_torch.ops.flash import flash_fixed
    from kandinsky5_tpu_torch.ops.nabla import block_mask_to_kv_lists, sta_mask
    from kandinsky5_tpu_torch.ops.sparse import (
        sparse_attention,
        sparse_attention_plain,
    )

    s, h = 93696, 28
    q, k = normed((1, s, h, 64)), normed((1, s, h, 64))
    v = torch.randn((1, s, h, 64), generator=g, device=dev).bfloat16()
    k1_ms = _time_ms(lambda: flash_fixed(q, k, v), 2)
    k1_bound = bound_ms(4.0 * s * s * h * 64, _nbytes(q, k, v, q))
    log(f"  K1_flash_fixed (1,{s},{h},64) dense, for reference: {k1_ms:.3f} ms "
        f"bound {k1_bound[0]:.3f} ms ({k1_bound[1]})")
    sta = torch.from_numpy(sta_mask(61, 4, 6)).to(dev)
    s1 = sta.shape[0]
    mask = torch.zeros((1, h, s1, s1), dtype=torch.bool, device=dev)
    t = time.perf_counter()
    make_flex, why = _flex_attention(q, k, v, mask)
    if make_flex is None:
        log(f"  flex_attention does not run here ({why}): library_ms null")
    else:
        log(f"  flex_attention compiled in {time.perf_counter() - t:.1f} s")
    for label, target in (("STA", None), ("STA+random", 0.15),
                          ("STA+random", 0.35), ("STA+random", 0.90)):
        mask.copy_(sta.expand(1, h, s1, s1))
        if target is not None:
            p = (target - float(sta.float().mean())) / (1 - float(sta.float().mean()))
            mask |= torch.rand((1, h, s1, s1), generator=g, device=dev) < p
        inds, nb = block_mask_to_kv_lists(mask)
        density = float(mask.float().mean())
        listed = int(nb.sum())
        flex = None
        if make_flex is not None:
            flex = make_flex(inds, nb)
            e_abs, e_rel = _errors(flex().transpose(1, 2),
                                   sparse_attention_plain(q, k, v, inds, nb))
            log(f"  flex_attention against K6's plain version: max_abs "
                f"{e_abs:.3e} rel_l2 {e_rel:.3e} (exact softmax vs fixed shift)")
        _compare("K6_sparse_nabla",
                 f"(1,{s},{h},64) {label} {100 * density:.2f}% kept",
                 lambda: sparse_attention(q, k, v, inds, nb),
                 lambda: sparse_attention_plain(q, k, v, inds, nb), results,
                 work=(4.0 * 64 * 64 * 64 * listed,
                       _nbytes(q, k, v, q, nb) + 4 * listed),
                 reps=3,
                 control_fn=lambda: sparse_attention_plain(q * 0, k, v, inds, nb),
                 library_fn=flex,
                 info=dict(density=density, k1_dense_ms=k1_ms,
                           k1_dense_bound_ms=k1_bound[0]))
        r = results["K6_sparse_nabla"][-1]
        r["tflops"] = 4.0 * 64 ** 3 * listed / r["ms"] / 1e9
        lib = ("" if r["library_ms"] is None
               else f"; {r['ms'] / r['library_ms']:.2f}x flex_attention")
        log(f"    {r['tflops']:.1f} TFLOP/s ({100 * r['bound_ms'] / r['ms']:.1f} "
            f"% of the tensor-core bound){lib}")
        del inds, nb, flex
    # the second sp rank of the (1, 2, 4) mesh under the 90 % mask: its 732
    # rows of its 7 heads' lists over the whole K/V; the control lists the
    # first 732 rows (a wrong row offset)
    hs, half = h // 4, s1 // 2
    rows = mask[:, :hs, half:].contiguous()
    inds, nb = block_mask_to_kv_lists(rows)
    inds0, nb0 = block_mask_to_kv_lists(mask[:, :hs, :half].contiguous())
    qs = q[:, half * 64:, :hs].contiguous()
    ks, vs = k[:, :, :hs].contiguous(), v[:, :, :hs].contiguous()
    del q, k, v, mask
    density = float(rows.float().mean())
    listed = int(nb.sum())
    k1_ms = _time_ms(lambda: flash_fixed(qs, ks, vs), 3)
    t = time.perf_counter()
    make_flex, why = _flex_attention(qs, ks, vs, rows)
    flex = None if make_flex is None else make_flex(inds, nb)
    log(f"  flex_attention at the sp rank's shape: "
        + (f"compiled in {time.perf_counter() - t:.1f} s" if flex else why))
    _compare("K6_sparse_nabla",
             f"(1,{qs.shape[1]}/{s},{hs},64) sp rank 1 rows {half}: "
             f"{100 * density:.2f}% kept",
             lambda: sparse_attention(qs, ks, vs, inds, nb),
             lambda: sparse_attention_plain(qs, ks, vs, inds, nb), results,
             work=(4.0 * 64 * 64 * 64 * listed,
                   _nbytes(qs, ks, vs, qs, nb) + 4 * listed),
             reps=3,
             control_fn=lambda: sparse_attention_plain(qs, ks, vs, inds0,
                                                       nb0),
             control_label="the first rows' lists",
             library_fn=flex,
             info=dict(density=density, k1_dense_ms=k1_ms))
    r = results["K6_sparse_nabla"][-1]
    r["tflops"] = 4.0 * 64 ** 3 * listed / r["ms"] / 1e9
    log(f"    {r['tflops']:.1f} TFLOP/s ({100 * r['bound_ms'] / r['ms']:.1f} "
        f"% of the tensor-core bound); K1 dense at this shape {k1_ms:.3f} ms")
    del qs, ks, vs, rows, inds, nb, inds0, nb0, flex
    torch.cuda.empty_cache()


# Opcodes the int8 attention kernels must not hold: the int-to-float
# conversion (I2F) shares the special-function units' rate with exp2, so
# the kernels convert by an integer add and an FADD; a generic load (LD)
# where the dequant coefficients should be read from shared memory by LDS
SASS_BANNED = ("I2F", "LD")


def sass_banned(lib: str, kernel: str) -> dict:
    """For every instance of ``kernel`` in the built library, keyed by its
    template arguments ("MODE,MASK,LAG" for flash_int8_kernel), the static
    count of each of SASS_BANNED in its code, from ``cuobjdump -sass``."""
    import re
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          timeout=300).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            m = re.search(kernel + r"I(\w+?)EEv", line)
            cur = None if m is None else counts.setdefault(
                ",".join(re.findall(r"L\w(\d+)E", m.group(1))),
                dict.fromkeys(SASS_BANNED, 0))
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if cur is not None and m is not None and m.group(1) in cur:
            cur[m.group(1)] += 1
    return counts


# K5 and K7's cases: (queries, keys, heads, masked); the last is a (1, 2, 4)
# rank's, as phase 5d runs it: the second sp rank's 23,808 queries (rows
# 23,808 on) of its 7 heads against the 47,616 gathered keys
INT8_CASES = ((47616, 47616, 28, False), (10752, 10752, 28, False),
              (1536, 1536, 28, False), (256, 256, 28, True),
              (23808, 47616, 7, False))
INT8_RANK_CASE = INT8_CASES[-1]


def phase_int8(dev, g, normed, results, cases=INT8_CASES, t5=True):
    """K5 and K7 at K1's four main-path shapes and at a (1, 2, 4) rank's
    (INT8_RANK_CASE), on one pack_int8 call shared with their plain version
    (the sides differ only in exp2's last bits and sum order), K7 held
    bit-equal to K5 and K5 against K1 (the quantization error on this
    card); T5's four modes at the 5 s shape (``t5``). The control packs
    uniform weights, and at the rank's shape Q and K from the rank's own
    shard only (no gather): each must fail the bound. The log gives,
    beside the tensor-core bound, the achieved rate, SDPA's time and K1's
    computed exp2 floor (one exp2 per query and valid key at 16 a clock per
    SM at the highest SM clock), and phase 2 fails if an instance's SASS
    holds an opcode of SASS_BANNED."""
    import torch

    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.ops.flash import (
        flash_fixed,
        flash_int8_packed,
        flash_int8_plain,
        pack_int8,
    )
    from kandinsky5_tpu_torch.tools.bench_i8_decomp import (
        MODES,
        i8_decomp,
        i8_decomp_plain,
    )
    sass = sass_banned(_kernels.build(), "flash_int8_kernel")
    log(f"  SASS of flash_int8_kernel's {len(sass)} instances, "
        f"{'/'.join(SASS_BANNED)}: {sass}")
    if len(sass) != 8 or any(any(n.values()) for n in sass.values()):
        raise Failure("flash_int8_kernel: expected 8 instances free of "
                      f"{SASS_BANNED} in the SASS, got {sass}")
    exp2_rate = 16 * torch.cuda.get_device_properties(dev).multi_processor_count \
        * _max_sm_clock_hz()
    for lq, lk, h, masked in cases:
        rank = lq != lk
        q, k = normed((1, lk, h, 64)), normed((1, lk, h, 64))
        v = torch.randn((1, lk, h, 64), generator=g, device=dev).bfloat16()
        if rank:  # the second sp rank's queries against the gathered keys
            q = q[:, lk - lq:].contiguous()
        mask = (torch.arange(lk, device=dev) < 77)[None] if masked else None
        n_keys = 77 if masked else lk
        q8, k8, coeff, shift = pack_int8(q, k)
        if rank:  # the control: Q and K packed from the rank's shard alone
            own = [t[:, lk - lq:].contiguous() for t in (k, v)]
            c8 = pack_int8(q, own[0])

            def control():
                return flash_int8_plain(c8[0], c8[1], own[1], c8[2], c8[3])
        else:
            def control():
                return flash_int8_plain(q8 * 0, k8, v, coeff, shift, mask)
        pairs = 2.0 * lq * n_keys * h * 64
        work = (pairs, _nbytes(q8, k8, v, coeff, mask, q), pairs)
        shape = (f"(1,{lq},{h},64)" if not rank else
                 f"(1,{lq}/{lk},{h},64) sp rank 1") + (" mask" if masked
                                                      else "")
        sdpa = _sdpa(q, k, v, None if mask is None else mask[:, None, None, :])
        outs = {}
        for name, pipe in (("K5_flash_int8", False), ("K7_flash_int8_pipe", True)):
            def kernel(pipe=pipe):
                return flash_int8_packed(q8, k8, v, coeff, shift, mask, pipe)

            outs[name] = kernel()
            _compare(name, shape, kernel,
                     lambda: flash_int8_plain(q8, k8, v, coeff, shift, mask),
                     results, work, reps=3 if lq > 10000 else 20,
                     control_fn=control,
                     control_label=("Q and K packed from the rank's shard, "
                                    "no gather") if rank else None,
                     yardstick_fn=sdpa)
            r = results[name][-1]
            r["tflops"] = 2 * pairs / r["ms"] / 1e9
            floor = lq * n_keys * h / exp2_rate * 1e3
            log(f"    {r['tflops']:.1f} TOP/s-equivalent "
                f"({100 * r['bound_ms'] / r['ms']:.1f} % of the tensor-core "
                f"bound {r['bound_ms']:.3f} ms); exp2 floor {floor:.3f} ms at "
                f"the highest SM clock ({100 * floor / r['ms']:.1f} %); "
                f"SDPA {r['yardstick_ms']:.3f} ms, "
                f"{r['ms'] / r['yardstick_ms']:.2f}x the SDPA yardstick")
            if lq == 47616 and not pipe:
                log("    under a steady run of K5: " + _clock_under(kernel))
        torch.cuda.synchronize()
        same = bool(torch.equal(outs["K5_flash_int8"], outs["K7_flash_int8_pipe"]))
        k7_vs_k5 = (outs["K5_flash_int8"].float()
                    - outs["K7_flash_int8_pipe"].float()).abs().max().item()
        e_abs, e_rel = _errors(outs["K5_flash_int8"], flash_fixed(q, k, v, mask))
        log(f"  K7 against K5 {shape}: max_abs {k7_vs_k5:.3e} "
            f"({'bit-equal' if same else 'DIFFERENT'}); K5 against K1 (the "
            f"int8 quantization error on this card): max_abs {e_abs:.3e} "
            f"rel_l2 {e_rel:.3e}")
        results["K7_flash_int8_pipe"][-1]["ok"] &= same
        results["K7_flash_int8_pipe"][-1]["max_abs_vs_k5"] = k7_vs_k5
        results["K5_flash_int8"][-1]["rel_l2_vs_k1"] = e_rel
        del q, k, v, q8, k8, coeff, outs

    if not t5:
        torch.cuda.empty_cache()
        return
    q, k = normed((1, 47616, 28, 64)), normed((1, 47616, 28, 64))
    v = torch.randn((1, 47616, 28, 64), generator=g, device=dev).bfloat16()
    q8, k8, coeff, shift = pack_int8(q, k)
    pairs = 2.0 * 47616 * 47616 * 28 * 64
    for mode in MODES:
        _compare("T5_i8_decomp", f"(1,47616,28,64) {mode}",
                 lambda: i8_decomp(q8, k8, v, coeff, shift, mode),
                 lambda: i8_decomp_plain(q8, k8, v, coeff, shift, mode),
                 results,
                 work=(0.0 if mode == "qk_only" else pairs,
                       _nbytes(q8, k8, v, coeff, q), pairs),
                 reps=3, info=dict(mode=mode))
    t = {r["mode"]: r["ms"] for r in results["T5_i8_decomp"]}
    log(f"  T5 at (1,47616,28,64): exp2 {t['full'] - t['no_exp2']:.3f} ms, "
        f"dequant {t['no_exp2'] - t['raw_pv']:.3f} ms, PV "
        f"{t['raw_pv'] - t['qk_only']:.3f} ms, QK + loads {t['qk_only']:.3f} ms")
    del q, k, v, q8, k8, coeff
    torch.cuda.empty_cache()


# T1's ragged cases beside SHAPES (M, K, N): rows not a multiple of the
# 128-row tile, and N not a multiple of the 256-column tile
T1_RAGGED = ((1000, 1792, 1792), (1000, 320, 136))


def phase_gemm(dev, g, results):
    """T1 in both types at the JAX tool's 8192^3 and the DiT's three
    projection shapes, then ragged (T1_RAGGED), beside ``torch._int_mm`` or
    bf16 ``matmul``, each with a control: the plain product with the last
    128-byte k step left out (128 int8 or 64 bf16 of K), which must fail
    the check (the int8 instance must equal the exact product); then K8 at
    each tp share and T2-T4 (``phase_ff_tools``, T2 also ragged). Each case
    logs its rate, share of bound and factor against its library call."""
    import torch

    from kandinsky5_tpu_torch.tools.bench_int8mm import (
        SHAPES,
        gemm,
        gemm_plain,
        library_call,
        operands,
    )

    for m, kk, n in SHAPES + T1_RAGGED:
        for name, dtype in (("T1_gemm_i8", torch.int8),
                            ("T1_gemm_bf16", torch.bfloat16)):
            a, b = operands(m, kk, n, dtype, g, dev)
            ops = 2.0 * m * n * kk
            work = (0.0 if dtype == torch.int8 else ops,
                    _nbytes(a, b) + 4 * m * n,
                    ops if dtype == torch.int8 else 0.0)
            step = 128 // a.element_size()
            _compare(name, f"({m},{kk},{n})", lambda: gemm(a, b),
                     lambda: gemm_plain(a, b), results, work=work,
                     reps=5, library_fn=library_call(a, b),
                     control_fn=lambda: gemm_plain(a[:, :-step], b[:, :-step]),
                     control_label="the last 128-byte k step left out")
            _rate(results, name, ops, "_int_mm" if dtype == torch.int8
                  else "bf16 matmul")
            del a, b
    torch.cuda.empty_cache()
    phase_ff_tools(dev, g, results)


def phase_ff_tools(dev, g, results):
    """K8 at each tensor-parallel rank's share of the 5 s visual FF, (47616,
    1792) x (1792, 7168 / tp) x (7168 / tp, 1792) for tp 1, 2 and 4, and the
    tools T2 (47616, 1792) x (1792, 1792), T3 and T4 at (47616, 1792) x
    7168; the library call of each FF is matmul -> GELU -> matmul in bf16
    (its hidden is rounded before the GELU too), T2's bf16 matmul. K8's
    control drops the last 128 hidden units (one column tile of the up
    product) from the plain version: a kernel that lost a tile of its
    reduction must fail the bound."""
    import torch

    from kandinsky5_tpu_torch.ops.ff import ff_plain, fused_ff
    from kandinsky5_tpu_torch.tools import bench_pallas_gemm as bpg

    x, wo, w1, w2 = bpg.operands(g, dev)
    rows, d = x.shape
    for tp in (1, 2, 4):
        f = bpg.FF // tp
        w1s, w2s = w1[:f].contiguous(), w2[:, :f].contiguous()
        _compare("K8_ff", f"({rows},{d})x({d},{f})x({f},{d}) tp {tp}",
                 lambda: fused_ff(x, w1s, w2s), lambda: ff_plain(x, w1s, w2s),
                 results, work=(4.0 * rows * d * f,
                                _nbytes(x, w1s, w2s) + 2 * rows * d),
                 library_fn=bpg.ff_library(x, w1s, w2s), info=dict(tp=tp),
                 control_fn=lambda: ff_plain(x, w1s[:-128], w2s[:, :-128]),
                 control_label="the last 128 of the ff sum dropped")
        _rate(results, "K8_ff", 4.0 * rows * d * f)
        del w1s, w2s
    for name, kernel, plain, library, flops, control in bpg.cases(x, wo, w1,
                                                                  w2):
        weights = (wo,) if name == "T2_gemm" else (w1, w2)
        work = (flops, _nbytes(x, *weights) + 2 * rows * d)
        _compare(name, f"({rows},{d})x{bpg.FF if name != 'T2_gemm' else d}",
                 kernel, plain, results, work=work,
                 library_fn=library, control_fn=control,
                 control_label="one tile of the reduction left out")
        _rate(results, name, flops,
              "bf16 matmul" if name == "T2_gemm" else "the bf16 chain")
    # T2 ragged: 1,000 rows, and N = 136 (not a multiple of the column tile)
    for xr, wr in ((x[:1000], wo), (x[:1000], wo[:136])):
        m, n = xr.shape[0], wr.shape[0]
        _compare("T2_gemm", f"({m},{d})x{n}", lambda: bpg.gemm(xr, wr),
                 lambda: bpg.gemm_plain(xr, wr), results,
                 work=(2.0 * m * n * d, _nbytes(xr, wr) + 2 * m * n),
                 library_fn=bpg.gemm_library(xr, wr),
                 control_fn=lambda: bpg.gemm_plain(xr[:, :-64], wr[:, :-64]),
                 control_label="the last 128-byte k step left out")
        _rate(results, "T2_gemm", 2.0 * m * n * d, "bf16 matmul")
    del x, wo, w1, w2
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: small-input reference of the path (card kernels vs CPU plain)
# ---------------------------------------------------------------------------

class SeededEmbedder:
    """Stand-in for the Qwen2.5-VL + CLIP embedder: (B, 256, 3584) text
    embeddings with a partial mask and (B, 768) pooled, from a generator
    seeded by the prompt."""

    def __init__(self, length=256, text_dim=3584, pooled_dim=768):
        self.length, self.text_dim, self.pooled_dim = length, text_dim, pooled_dim

    def encode(self, texts, type_of_content="video"):
        import torch

        from kandinsky5_tpu_torch.pipeline import TextEmbeddings

        embeds, pooled, masks = [], [], []
        for text in texts:
            seed = zlib.crc32(f"{type_of_content}:{text}".encode())
            g = torch.Generator().manual_seed(seed)
            embeds.append(torch.randn(self.length, self.text_dim, generator=g))
            pooled.append(torch.randn(self.pooled_dim, generator=g))
            n_valid = 40 + seed % 180
            masks.append(torch.arange(self.length) < n_valid)
        return TextEmbeddings(torch.stack(embeds), torch.stack(pooled),
                              torch.stack(masks))

    def expand_prompt(self, prompt):
        return prompt


class StandInTokenizer:
    """Seeded stand-in for an HF tokenizer (the repository holds no tokenizer
    file): a word or punctuation mark maps to an id from ``zlib.crc32``, the
    special tokens to their ids in the released vocabulary. It takes the
    calls the embedder makes (padding to ``max_length`` with a mask,
    truncation, ``apply_chat_template``, ``decode``); the towers run for
    real on its ids."""

    SPLIT = re.compile(r"<\|[a-z_]+\|>|\w+|[^\w\s]")

    def __init__(self, n_words, specials, pad, bos=None, eos=None):
        self.n_words, self.specials = n_words, specials
        self.pad, self.bos, self.eos = pad, bos, eos
        self.words = {i: w for w, i in specials.items()}

    @classmethod
    def qwen(cls):
        return cls(151643, {"<|endoftext|>": 151643, "<|im_start|>": 151644,
                            "<|im_end|>": 151645}, pad=151643)

    @classmethod
    def clip(cls):
        # the legacy pooling rule reads the largest id: end of text, 49407
        return cls(49406, {"<|startoftext|>": 49406, "<|endoftext|>": 49407},
                   pad=49407, bos=49406, eos=49407)

    def _ids(self, text):
        out = []
        for w in self.SPLIT.findall(text):
            i = self.specials.get(w)
            if i is None:
                i = zlib.crc32(w.encode()) % self.n_words
                self.words.setdefault(i, w)
            out.append(i)
        return out

    def __call__(self, texts, max_length=None, truncation=False,
                 padding=False, add_special_tokens=True, return_tensors="np"):
        import numpy as np

        rows = []
        for text in ([texts] if isinstance(texts, str) else texts):
            ids = self._ids(text)
            extra = [i for i in (self.bos, self.eos) if i is not None] \
                if add_special_tokens else []
            if truncation and max_length is not None:
                ids = ids[:max_length - len(extra)]
            if extra:
                ids = [self.bos] + ids + [self.eos]
            rows.append(ids)
        width = max_length if padding == "max_length" else max(map(len, rows))
        ids = np.full((len(rows), width), self.pad, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for r, row in enumerate(rows):
            ids[r, :len(row)] = row
            mask[r, :len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}

    def apply_chat_template(self, messages, tokenize=False,
                            add_generation_prompt=True):
        text = "".join(
            f"<|im_start|>{m['role']}\n"
            + "".join(c["text"] for c in m["content"]) + "<|im_end|>\n"
            for m in messages)
        return text + ("<|im_start|>assistant\n" if add_generation_prompt
                       else "")

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(self.words.get(int(i), f"w{int(i)}") for i in ids
                        if not (skip_special_tokens
                                and int(i) in self.specials.values()))


def seeded_text_embedder(dev, conf, qwen_layers=None, seed=21):
    """The Qwen2.5-VL-7B text tower (bf16; ``qwen_layers`` of its 28 layers
    when given) and CLIP ViT-L/14 (fp32, as the pipeline keeps it) at full
    width with seeded +-0.02 weights on ``dev``, behind the stand-in
    tokenizers."""
    import dataclasses

    import torch

    from kandinsky5_tpu_torch.text.clip import (
        ClipTextConfig,
        init_clip_params_random,
    )
    from kandinsky5_tpu_torch.text.embedder import Kandinsky5TextEmbedder
    from kandinsky5_tpu_torch.text.qwen import (
        QwenTextConfig,
        init_qwen_params_random,
    )

    qcfg = QwenTextConfig()
    if qwen_layers is not None:
        qcfg = dataclasses.replace(qcfg, num_hidden_layers=qwen_layers)
    qwen = init_qwen_params_random(qcfg, device=dev, dtype=torch.bfloat16,
                                   seed=seed)
    clip = init_clip_params_random(ClipTextConfig(), device=dev,
                                   dtype=torch.float32, seed=seed + 1)
    return Kandinsky5TextEmbedder(conf, qwen, clip, StandInTokenizer.qwen(),
                                  StandInTokenizer.clip())


def _params_to_cpu(t):
    """An fp32 CPU copy of a nested dict of tensors (VAE parameters)."""
    if isinstance(t, dict):
        return {k: _params_to_cpu(v) for k, v in t.items()}
    return t.float().cpu()


def _cpu_copy(model):
    """An fp32 CPU copy of a text tower built on the card."""
    import torch

    with torch.device("meta"):
        out = type(model)(model.cfg, dtype=torch.float32)
    out.load_state_dict({k: v.float().cpu() for k, v in
                         model.state_dict().items()}, assign=True)
    return out


# the file in --out where phase 4 leaves the text embeddings (and prompt
# expansions) of its requests for phase 5's ranks
TEXT_FILE = "text_embeddings.pt"


def _text_key(texts, kind):
    return kind + "\x00" + "\x01".join(texts)


class RecordingEmbedder:
    """Passes ``encode`` and ``expand_prompt`` to ``inner`` and keeps each
    result (CPU tensors) for :class:`ReplayEmbedder`."""

    def __init__(self, inner):
        self.inner = inner
        self.encodings, self.expansions = {}, {}

    @property
    def last_expansion(self):
        return self.inner.last_expansion

    def encode(self, texts, type_of_content="video"):
        e = self.inner.encode(texts, type_of_content)
        self.encodings[_text_key(texts, type_of_content)] = tuple(
            t.cpu() for t in e)
        return e

    def expand_prompt(self, prompt):
        out = self.inner.expand_prompt(prompt)
        self.expansions[prompt] = out
        return out

    def save(self, path):
        import torch

        torch.save({"encodings": self.encodings,
                    "expansions": self.expansions}, path)


class ReplayEmbedder:
    """Gives back what a :class:`RecordingEmbedder` saved at ``path``;
    anything it did not record raises."""

    def __init__(self, path):
        import torch

        d = torch.load(path)
        self.encodings, self.expansions = d["encodings"], d["expansions"]

    def encode(self, texts, type_of_content="video"):
        from kandinsky5_tpu_torch.pipeline import TextEmbeddings

        return TextEmbeddings(*self.encodings[_text_key(texts,
                                                        type_of_content)])

    def expand_prompt(self, prompt):
        return self.expansions[prompt]


def _rel(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _density(kept) -> float:
    """Mean kept fraction of the masks ``nabla.record_density`` saw."""
    import torch

    return float(torch.stack(kept).float().mean()) if kept else float("nan")


def phase_reference(dev, conf):
    """DiT (full width, 2 text + 2 visual blocks) and the VAE decoder on a
    small input: bf16 kernels on the card vs the same bf16 weights in fp32
    through the plain versions on the CPU. The DiT runs dense on a (2, 32,
    48) latent and NABLA on a (4, 64, 96) one (a (4, 4, 6) tile grid of 96
    blocks, STA alone keeps 27.8 %). The VAE latent (1, 5, 16, 32)
    decodes in a 4-frame chunk of 4 * 512 = 2048 tokens, the size at which
    mid attention goes to K4, then a 1-frame chunk that carries the K/V
    buffer. The int8 DiT (W8A8 and flash_int8, the same int8 weights on
    both sides) runs a (2, 48, 64) latent. bf16 activations through a few
    blocks keep about 2-3 significant digits, so the bound is a relative L2
    error of 5e-2; a wrong layout or index gives errors near 1."""
    import dataclasses

    import torch

    from kandinsky5_tpu_torch.models.dit import (
        SparseParams,
        dit_forward,
        fast_init_dit_params,
        quantize_dit_params,
    )
    from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE, init_vae_params
    from kandinsky5_tpu_torch.models.vae_stream import streaming_decode
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.ops.nabla import record_density, sta_mask

    cfg = dataclasses.replace(conf.model.dit_params, num_text_blocks=2,
                              num_visual_blocks=2)
    dit = fast_init_dit_params(cfg, device=dev, dtype=torch.bfloat16, seed=7)
    dit_cpu = fast_init_dit_params(cfg, device="cpu", dtype=torch.float32, seed=0)
    dit_cpu.load_state_dict({k: v.float().cpu() for k, v in dit.state_dict().items()})
    emb = SeededEmbedder().encode(["reference"], "video")
    g = torch.Generator().manual_seed(5)
    x = torch.randn((1, 2, 32, 48, 33), generator=g)
    args = (emb.text_embeds, emb.pooled_embed, torch.tensor([500.0]), emb.mask)
    _kernels.reset_launches()
    out = dit_forward(dit, x.to(dev).bfloat16(), *[a.to(dev) for a in args],
                      scale_factor=(1.0, 2.0, 2.0))
    launched = dict(_kernels.LAUNCHES)
    ref = dit_forward(dit_cpu, x, *args, scale_factor=(1.0, 2.0, 2.0))
    e_dit = _rel(out, ref)
    log(f"  DiT 2+2 blocks, full width, (1,2,32,48): rel_l2 {e_dit:.3e} "
        f"(tol 5e-2), kernel launches {launched}")

    x = torch.randn((1, 4, 64, 96, 33), generator=g)
    sta = torch.from_numpy(sta_mask(4, 4, 6))
    _kernels.reset_launches()
    with record_density() as kept:
        out = dit_forward(dit, x.to(dev).bfloat16(), *[a.to(dev) for a in args],
                          scale_factor=(1.0, 2.0, 2.0),
                          sparse=SparseParams(sta.to(dev), 0.9))
        launched_n = dict(_kernels.LAUNCHES)
    with record_density() as kept_cpu:
        ref = dit_forward(dit_cpu, x, *args, scale_factor=(1.0, 2.0, 2.0),
                          sparse=SparseParams(sta, 0.9))
    e_nabla = _rel(out, ref)
    log(f"  DiT 2+2 blocks, full width, NABLA (1,4,64,96): rel_l2 "
        f"{e_nabla:.3e} (tol 5e-2); mask density card {_density(kept):.4f} "
        f"cpu {_density(kept_cpu):.4f} (STA alone {float(sta.float().mean()):.4f});"
        f" kernel launches {launched_n}")

    # the int8 DiT: flash_int8 attention and W8A8 projections on 1,536
    # visual tokens, where the text cross-attention is short-KV (dense), so
    # K5 runs the 2 text and 2 visual self-attentions
    qdit, qdit_cpu = quantize_dit_params(dit), quantize_dit_params(dit_cpu)
    x = torch.randn((1, 2, 48, 64, 33), generator=torch.Generator().manual_seed(9))
    _kernels.reset_launches()
    out = dit_forward(qdit, x.to(dev).bfloat16(), *[a.to(dev) for a in args],
                      scale_factor=(1.0, 2.0, 2.0), attn_impl="flash_int8")
    launched_i = dict(_kernels.LAUNCHES)
    ref = dit_forward(qdit_cpu, x, *args, scale_factor=(1.0, 2.0, 2.0),
                      attn_impl="flash_int8")
    e_int8 = _rel(out, ref)
    log(f"  DiT 2+2 blocks, full width, int8 (flash_int8 + W8A8) (1,2,48,64): "
        f"rel_l2 {e_int8:.3e} (tol 5e-2), kernel launches {launched_i}")
    del dit, dit_cpu, qdit, qdit_cpu

    vp = init_vae_params(device=dev, dtype=torch.bfloat16, seed=3)

    z = torch.randn((1, 5, 16, 32, 16), generator=g)
    _kernels.reset_launches()
    out_v = streaming_decode(vp, z.to(dev).bfloat16())
    launched_v = dict(_kernels.LAUNCHES)
    ref_v = streaming_decode(_params_to_cpu(vp), z)
    e_vae = _rel(out_v, ref_v)
    log(f"  VAE stream decode (1,5,16,32,16) -> {tuple(out_v.shape)}: rel_l2 "
        f"{e_vae:.3e} (tol 5e-2), kernel launches {launched_v}")
    # the same decode through the VAE with GroupNorm + SiLU folded into K3
    # (fuse_gn): its second chunk's convs carry two prefix planes; in fp32
    # the fused and unfused streams agree to 2e-4, so the CPU reference is
    # the unfused one
    _kernels.reset_launches()
    out_f = HunyuanVideoVAE(vp, fuse_gn=True).decode(z.to(dev).bfloat16(),
                                                     mode="stream")
    launched_f = dict(_kernels.LAUNCHES)
    e_fused = _rel(out_f, ref_v)
    log(f"  VAE stream decode, fuse_gn=True, (1,5,16,32,16): rel_l2 "
        f"{e_fused:.3e} (tol 5e-2), kernel launches {launched_f}")
    tiled = phase_tiled_reference(dev, vp, _params_to_cpu(vp), g)
    if not (e_dit < 5e-2 and e_nabla < 5e-2 and e_int8 < 5e-2
            and e_vae < 5e-2 and e_fused < 5e-2):
        raise Failure(f"path disagrees with its CPU reference: DiT {e_dit}, "
                      f"NABLA DiT {e_nabla}, int8 DiT {e_int8}, VAE {e_vae}, "
                      f"fused stream VAE {e_fused}")
    if min(launched["K1_flash_fixed"], launched["K2_ff_mod"],
           launched_v["K3_conv3d"], launched_v["K4_flash_online"],
           launched_f["K3_conv3d_fused"]) == 0:
        raise Failure("the reference run missed a kernel: DiT "
                      f"{launched}, VAE {launched_v}, fused VAE {launched_f}")
    if launched_n["K6_sparse_nabla"] != 2:
        raise Failure(f"the NABLA DiT launched K6 {launched_n} times, not 2")
    if launched_i["K5_flash_int8"] != 4 or launched_i["K1_flash_fixed"] != 0:
        raise Failure(f"the int8 DiT launched {launched_i}: K5 must launch 4 "
                      "times and K1 never")
    return {"dit_rel_l2": e_dit, "nabla_dit_rel_l2": e_nabla,
            "int8_dit_rel_l2": e_int8, "vae_rel_l2": e_vae,
            "vae_fused_stream_rel_l2": e_fused, **tiled}


# bf16 through two full-width Qwen layers keeps 2-3 significant digits, as
# the DiT's cut-depth check does. CLIP runs fp32 on both sides and must stay
# fp32 on the card: bf16 or TF32 products would read 1e-3 or more, so its
# bound sits between that and the fp32 reading. A wrong crop, pooling
# position or layout gives errors near 1.
TEXT_BOUND = 2e-2
CLIP_BOUND = 1e-4


def phase_text(dev, conf, qwen_ref_path=None):
    """The text towers on the card against the same weights in fp32 on the
    CPU (plain PyTorch on both sides: no kernel is on this path): Qwen2.5-VL
    at full width (hidden 3584, 28 / 4 heads of 128, FF 18,944, vocab
    152,064) with 2 of its 28 layers in bf16, CLIP ViT-L/14 at full width
    and depth in fp32, on one prompt of each template through the stand-in
    tokenizers. Qwen's cropped hidden states over the valid positions and
    its prefill logits must agree within TEXT_BOUND, CLIP's pooled vector
    within CLIP_BOUND (relative L2); two controls must fail their bound:
    the crop one position early, and CLIP pooled at the last position.
    With ``qwen_ref_path`` the tower's one-device run that phase 5d holds
    the sharded tower against is saved there (:func:`qwen_reference`)."""
    import torch

    from kandinsky5_tpu_torch.text.clip import clip_text_forward
    from kandinsky5_tpu_torch.text.qwen import _prefill, qwen_hidden_states

    a = torch.ones((2, 8), device=dev, dtype=torch.bfloat16)
    try:
        fp32_out = torch.mm(a, a.t(), out_dtype=torch.float32).dtype == \
            torch.float32
    except (TypeError, RuntimeError):
        fp32_out = False
    log(f"  the towers' bf16 products return fp32 from one GEMM "
        f"(torch.mm out_dtype): {fp32_out}")
    emb = seeded_text_embedder(dev, conf.model.text_embedder, qwen_layers=2)
    qwen_cpu, clip_cpu = _cpu_copy(emb.qwen), _cpu_copy(emb.clip)
    out, bad = {}, []
    for kind in ("video", "image"):
        prompt = f"a smoke-test {kind} of a red fox running through snow"
        ids, mask, crop = emb._qwen_tokenize([prompt], kind)
        h = qwen_hidden_states(emb.qwen, ids, mask).float().cpu()
        h_ref = qwen_hidden_states(qwen_cpu, ids, mask)
        valid = mask[:, crop:]
        e_h = _rel(h[:, crop:][valid], h_ref[:, crop:][valid])
        c_h = _rel(h[:, crop - 1:-1][valid], h_ref[:, crop:][valid])
        n = int(mask.sum())
        _, logits = _prefill(emb.qwen, ids[:, :n], n + 1)
        _, logits_ref = _prefill(qwen_cpu, ids[:, :n], n + 1)
        e_l = _rel(logits, logits_ref)
        cids, cmask = emb._clip_tokenize([prompt])
        x, pooled = clip_text_forward(emb.clip, cids, cmask)
        _, pooled_ref = clip_text_forward(clip_cpu, cids, cmask)
        e_p = _rel(pooled, pooled_ref)
        c_p = _rel(x[:, -1], pooled_ref)
        log(f"  text, {kind} template ({n} of {ids.shape[1]} Qwen tokens "
            f"valid, crop {crop}): Qwen hidden rel_l2 {e_h:.3e}, prefill "
            f"logits {e_l:.3e} (tol {TEXT_BOUND:g}); CLIP pooled {e_p:.3e} "
            f"(tol {CLIP_BOUND:g}); "
            f"controls: crop at {crop - 1} {c_h:.3e}, CLIP pooled at the last "
            f"position {c_p:.3e} (must fail)")
        out[kind] = dict(qwen_hidden_rel_l2=e_h, qwen_logits_rel_l2=e_l,
                         clip_pooled_rel_l2=e_p, control_crop_rel_l2=c_h,
                         control_pool_rel_l2=c_p)
        if max(e_h, e_l) >= TEXT_BOUND or e_p >= CLIP_BOUND:
            bad.append(f"{kind}: the towers disagree with the CPU")
        if c_h < TEXT_BOUND or c_p < CLIP_BOUND:
            bad.append(f"{kind}: a control passed the bound")
    if qwen_ref_path is not None:
        qwen_reference(emb, qwen_ref_path)
    del emb, qwen_cpu, clip_cpu
    torch.cuda.empty_cache()
    if bad:
        raise Failure("text towers: " + "; ".join(bad))
    return out


# the tiled reference: tiles of 3 latent frames (9 px frames, stride 4) and
# 8 x 16 latents (64 x 128 px, strides 32 and 64 px) over a (3, 12, 24)
# latent: 2 temporal x 2 x 2 spatial tiles, blends on every axis
TILED_REF = ((1, 3, 12, 24, 16), (9, 64, 128), (4, 32, 64))


def held_k3(run, quant_off=False):
    """``run()`` with every K3 call of the VAE held against its plain
    version on the same input (W8A8 calls up to flipped codes,
    ``_flips_only``; the others within K3's tolerance); with ``quant_off``
    the W8A8 calls run the bf16 kernel (a control). Returns (run's result,
    [(W8A8?, rel_l2, within the check?)]). ``run`` may replace
    ``ops.conv.quant_window_scales``; it is restored after."""
    from kandinsky5_tpu_torch.models import vae as vae_mod
    from kandinsky5_tpu_torch.ops import conv as conv_mod

    real_conv, real_scales = vae_mod.causal_conv3d_fused, \
        conv_mod.quant_window_scales
    atol, rtol = TOL["K3_conv3d_fused"]
    calls = []

    def conv(x, w, b, *args, **kw):
        quant = kw.get("quant", False)
        y = real_conv(x, w, b, *args, **dict(kw, quant=quant and not
                                              quant_off))
        want = conv_mod.conv3d_plain(x, w, b, *args, **kw)
        max_abs, rel = _errors(y, want)
        if quant:
            xt = x if kw.get("scale") is None else conv_mod.conv_prologue(
                x, kw["scale"], kw["shift"], kw.get("act", False))
            ok = _flips_only(xt, w)(y, want)
        else:
            ok = max_abs <= atol and rel <= rtol
        calls.append((quant, rel, ok))
        return y

    vae_mod.causal_conv3d_fused = conv
    try:
        return run(), calls
    finally:
        vae_mod.causal_conv3d_fused = real_conv
        conv_mod.quant_window_scales = real_scales


def phase_tiled_reference(dev, vp, vp_cpu, g):
    """The tiled decode at tile settings that force two temporal and 2 x 2
    spatial tiles (``TILED_REF``; every level but the first, 16 px wide, is
    one the TPU kernel admits, so the fused and W8A8 modes run there).

    bf16 (GroupNorm folded into K3, the tiled default): the card against
    the same weights in fp32 through the plain versions on the CPU, rel_l2
    5e-2 as the stream decode.

    int8 convs: held conv by conv. Every K3 call of the card's decode is
    compared, on its own input, with its plain version on the card: W8A8
    calls equal up to a few flipped codes (``_flips_only``, as in phase 2),
    the others within K3's tolerance. Two controls must fail that check:
    the same decode with one scale for the whole tensor in every W8A8 call
    (each window-max result replaced by its largest scale), and with the
    quantization off (the bf16 kernel held against the W8A8 plain version).
    No whole-decode bound: rounding flips compound through GroupNorm's
    statistics, so the int8 decode does not stay near any reference that
    computes in another order. On an H100 a one-ulp change at 0.1 % of the
    latents moved the card's own int8 decode 1.1e-1 (rel_l2) from itself,
    further than the bf16 decode lies from it (8.6e-2); both readings are
    logged."""
    import torch

    from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.ops import conv as conv_mod

    shape, tile, stride = TILED_REF
    z = torch.randn(shape, generator=g)
    zd = z.to(dev).bfloat16()

    def vae(params, **kw):
        v = HunyuanVideoVAE(params, **kw)
        v._apply_tiling(tile, stride)
        return v

    _kernels.reset_launches()
    out_bf16 = vae(vp).decode(zd, opt_tiling=False, mode="tiled")
    launched = {k: n for k, n in _kernels.LAUNCHES.items() if n}
    ref = vae(vp_cpu, dtype=torch.float32).decode(z, opt_tiling=False,
                                                  mode="tiled")
    e_bf16 = _rel(out_bf16, ref)
    ok_bf16 = e_bf16 < 5e-2 and launched.get("K3_conv3d_fused", 0) > 0
    log(f"  VAE tiled decode bf16 {shape} tiles {tile} stride {stride} -> "
        f"{tuple(out_bf16.shape)}: rel_l2 {e_bf16:.3e} (tol 5e-2), kernel "
        f"launches {launched}")

    real_scales = conv_mod.quant_window_scales

    def one_scale(*args):
        s, _ = real_scales(*args)
        top = s.max()
        return torch.full_like(s, top), torch.full_like(s, 1.0) / top

    held = held_k3
    v8 = vae(vp, int8_conv=True)
    _kernels.reset_launches()
    out_i8, calls = held(lambda: v8.decode(zd, opt_tiling=False, mode="tiled"))
    launched_i8 = {k: n for k, n in _kernels.LAUNCHES.items() if n}

    def one_scale_run():
        conv_mod.quant_window_scales = one_scale
        return v8.decode(zd, opt_tiling=False, mode="tiled")

    _, calls_one = held(one_scale_run)
    _, calls_off = held(lambda: v8.decode(zd, opt_tiling=False, mode="tiled"),
                        quant_off=True)

    def summary(cs):
        q = [(rel, ok) for quant, rel, ok in cs if quant]
        return (len(q), sum(not ok for _, ok in q), max(r for r, _ in q),
                all(ok for _, _, ok in cs))

    n_q, bad, worst, ok_i8 = summary(calls)
    _, bad_one, worst_one, ok_one = summary(calls_one)
    _, bad_off, worst_off, ok_off = summary(calls_off)
    ok_i8 = ok_i8 and all(launched_i8.get(k) for k in ("K3_conv3d_quant",
                                                        "K3_quant_windows"))
    # the readings that rule out a whole-decode bound
    gp = torch.Generator().manual_seed(17)
    nudge = torch.rand(shape, generator=gp) < 1e-3
    zp = torch.where(nudge.to(dev), (zd.float() * (1 + 2 ** -7)).bfloat16(), zd)
    out_p = v8.decode(zp, opt_tiling=False, mode="tiled")
    e_nudge, e_vs_bf16 = _rel(out_p, out_i8), _rel(out_bf16, out_i8)
    log(f"  VAE tiled decode int8, conv by conv on the card: {len(calls)} K3 "
        f"calls, {n_q} W8A8, {bad} outside the check (flips only), worst "
        f"W8A8 rel_l2 {worst:.3e}; kernel launches {launched_i8}")
    log(f"  controls that must fail it: one scale for the whole tensor "
        f"{bad_one} of {n_q} W8A8 calls outside, worst rel_l2 "
        f"{worst_one:.3e} {'fails' if not ok_one else 'PASSES'}; "
        f"quantization off {bad_off} of {n_q} outside, worst rel_l2 "
        f"{worst_off:.3e} {'fails' if not ok_off else 'PASSES'}")
    log(f"  int8 decode against itself from latents nudged one bf16 ulp at "
        f"0.1 % of entries: rel_l2 {e_nudge:.3e}; against the bf16 decode: "
        f"{e_vs_bf16:.3e} (recorded, not gated)")
    if not (ok_bf16 and ok_i8) or ok_one or ok_off:
        raise Failure(
            f"tiled decode: bf16 rel_l2 {e_bf16} launches {launched}; int8 "
            f"{bad} of {n_q} W8A8 calls outside the check, launches "
            f"{launched_i8}; controls pass: one scale {ok_one}, "
            f"quantization off {ok_off}")
    return {"vae_tiled_bf16_rel_l2": e_bf16, "vae_tiled_int8_w8a8_calls": n_q,
            "vae_tiled_int8_worst_rel_l2": worst,
            "vae_tiled_int8_one_scale_worst_rel_l2": worst_one,
            "vae_tiled_int8_quant_off_worst_rel_l2": worst_off,
            "vae_tiled_int8_nudged_rel_l2": e_nudge,
            "vae_tiled_int8_vs_bf16_rel_l2": e_vs_bf16}


# ---------------------------------------------------------------------------
# phase 4: the pipeline at full width
# ---------------------------------------------------------------------------

def _answer(pipe, requests, out_dir):
    """Run each (name, prompt, seconds, frame shape, file) request through
    ``pipe`` and check what comes out; returns one report per request and
    the frames by request name."""
    import numpy as np
    import torch

    from kandinsky5_tpu_torch.ops.nabla import record_density

    report, videos = [], {}
    for name, prompt, tl, shape, fname, *expand in requests:
        expand = bool(expand and expand[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with record_density() as kept:
            frames = pipe(prompt, time_length=tl, width=768,
                          height=512, seed=42, expand_prompts=expand,
                          save_path=os.path.join(out_dir, fname))
        wall = time.perf_counter() - t
        tm = dict(pipe.timings)
        peak = torch.cuda.max_memory_allocated()
        steps = tm["steps"]
        saved = tm["saved"][0]
        if not os.path.isfile(saved) or os.path.getsize(saved) == 0:
            raise Failure(f"{name}: nothing written at {saved}")
        density = _density(kept)
        ms_token = (1e3 * tm["expand_s"] / tm["expand_tokens"]
                    if tm["expand_tokens"] else None)
        log(f"  {name}: frames {frames.shape} {frames.dtype}; text "
            f"{tm['text_s']:.3f} s"
            + (f" (expansion {tm['expand_tokens']} new tokens in "
               f"{tm['expand_s']:.3f} s = {ms_token:.2f} ms/token)"
               if expand else "")
            + f"; denoise "
            f"{tm['denoise_s']:.3f} s ({tm['denoise_s'] / steps:.4f} s/step, "
            f"{steps} steps, cfg {tm['cfg']}); decode {tm['decode_s']:.3f} s; "
            f"wall {wall:.3f} s; peak memory {peak / 2**30:.2f} GiB; "
            + (f"{len(kept)} NABLA masks, mean density {density:.4f}; "
               if kept else "")
            + f"wrote {saved} ({os.path.getsize(saved)} bytes)")
        if frames.shape != shape or frames.dtype != np.uint8:
            raise Failure(f"{name}: frames {frames.shape} {frames.dtype}, "
                          f"expected {shape} uint8")
        if not tm["latents_finite"]:
            raise Failure(f"{name}: non-finite latents")
        if float(frames.std()) == 0.0:
            raise Failure(f"{name}: constant frames")
        if expand and not tm["expand_tokens"]:
            raise Failure(f"{name}: the expansion made no token")
        report.append(dict(request=name, wall_s=wall, text_s=tm["text_s"],
                           expand_tokens=tm["expand_tokens"],
                           expand_ms_per_token=ms_token,
                           s_per_step=tm["denoise_s"] / steps,
                           denoise_s=tm["denoise_s"], decode_s=tm["decode_s"],
                           peak_gib=peak / 2**30,
                           nabla_density=density if kept else None))
        videos[name] = frames
    return report, videos


def _video(tag, seconds, prompt=None):
    frames = 4 * (seconds * 24 // 4) + 1
    name = f"{tag} video {seconds}s"
    return (name, prompt or f"a smoke-test {name}", seconds,
            (1, frames, 512, 768, 3), f"{tag}_video_{seconds}s.mp4")


def build_models(dev, conf5):
    """The full 2B DiT (uniform +-0.02 from seed 0), the full VAE decoder
    and the full-size seeded towers on ``dev``; returns them and the
    seconds the towers took."""
    import torch

    from kandinsky5_tpu_torch.models.dit import fast_init_dit_params
    from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE, init_vae_params

    t0 = time.perf_counter()
    dit = fast_init_dit_params(conf5.model.dit_params, device=dev,
                               dtype=torch.bfloat16, seed=0)
    vae = HunyuanVideoVAE(init_vae_params(device=dev, dtype=torch.bfloat16,
                                          seed=1))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in dit.parameters())
    log(f"  built: DiT {n_params} params, VAE decoder; "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    towers = seeded_text_embedder(dev, conf5.model.text_embedder)
    torch.cuda.synchronize()
    text_s = time.perf_counter() - t0
    log(f"  built: Qwen2.5-VL-7B text tower "
        f"{sum(p.numel() for p in towers.qwen.parameters())} params (bf16), "
        f"CLIP ViT-L/14 text {sum(p.numel() for p in towers.clip.parameters())}"
        f" params (fp32), seeded, stand-in tokenizers; {text_s:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    return dit, vae, towers, text_s


def phase_pipeline(dev, conf5, conf10, seconds5: int, seconds10: int,
                   out_dir: str):
    """The 5 s path (image, its prompt expanded, + video) and the 10 s path
    (one video), each with the launch counts reset just before it and read
    just after, then the decodes, then the image request again through
    ``offload=True``. Every request is encoded by the full-size seeded
    Qwen2.5-VL-7B and CLIP behind the stand-in tokenizers; their
    embeddings and expansions are saved in ``out_dir`` for phase 5.
    Returns the launches by path, the report, the seconds the text stage
    added and the DiT, VAE and towers (left in host memory by the offload
    request) for phase 6."""
    import torch

    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.pipeline import Kandinsky5T2VPipeline
    from kandinsky5_tpu_torch.utils.metrics import psnr

    if conf10.model.dit_params != conf5.model.dit_params:
        raise Failure("the 5 s and 10 s configs name different DiTs")
    dit, vae, towers, text_added = build_models(dev, conf5)
    os.makedirs(out_dir, exist_ok=True)
    embedder = RecordingEmbedder(towers)

    log(f"  5 s path ({os.path.basename(CONF5)}: {conf5.model.num_steps} "
        f"steps, guidance {conf5.model.guidance_weight}, dense attention)")
    pipe5 = Kandinsky5T2VPipeline(dit, conf5, embedder, vae)
    latents = _keep_latents(pipe5, "5s")
    _kernels.reset_launches()
    bf16_video = _video("5s-path", seconds5, VIDEO_PROMPT)
    report, videos = _answer(pipe5, [IMAGE_REQUEST, bf16_video], out_dir)
    launches5 = dict(_kernels.LAUNCHES)
    log(f"  kernel launches on the 5 s path: {launches5}")
    missing = [k for k in ("K1_flash_fixed", "K2_ff_mod", "K3_conv3d",
                           "K4_flash_online") if launches5[k] == 0]
    if missing:
        raise Failure(f"the 5 s path never launched {missing}")

    m10 = conf10.model
    log(f"  10 s path ({os.path.basename(CONF10)}: {m10.num_steps} steps, "
        f"guidance {m10.guidance_weight}, attention {m10.attention.type} "
        f"P {m10.attention.P} window ({m10.attention.wT}, {m10.attention.wH},"
        f" {m10.attention.wW}))")
    pipe10 = Kandinsky5T2VPipeline(dit, conf10, embedder, vae)
    _keep_latents(pipe10, "10s", latents)
    _kernels.reset_launches()
    video10 = _video("10s-path", seconds10)
    rep10, videos10 = _answer(pipe10, [video10], out_dir)
    report += rep10
    launches10 = dict(_kernels.LAUNCHES)
    log(f"  kernel launches on the 10 s path: {launches10}")
    cfg = m10.dit_params
    want = {"K6_sparse_nabla": cfg.num_visual_blocks * m10.num_steps,
            "K1_flash_fixed": cfg.num_text_blocks * m10.num_steps}
    wrong = {k: (launches10[k], n) for k, n in want.items()
             if launches10[k] != n}
    missing = [k for k in ("K2_ff_mod", "K3_conv3d", "K4_flash_online")
               if launches10[k] == 0]
    if wrong or missing:
        raise Failure(f"the 10 s path launched (got, want) {wrong}, never "
                      f"launched {missing}")

    m5, cfg5 = conf5.model, conf5.model.dit_params
    n_attn = (cfg5.num_text_blocks + cfg5.num_visual_blocks) * m5.num_steps
    log(f"  5 s int8 path ({os.path.basename(CONF5)}, the bf16 video's "
        f"prompt and seed): (a) flash_int8, (b) flash_int8_pipe + W8A8")
    launches = {"5s": launches5, "10s": launches10}
    for tag, kw, want in (
            ("a", dict(attn_impl="flash_int8"),
             {"K5_flash_int8": n_attn, "K1_flash_fixed": 0,
              "K7_flash_int8_pipe": 0}),
            ("b", dict(attn_impl="flash_int8_pipe", int8_linear=True),
             {"K7_flash_int8_pipe": n_attn, "K5_flash_int8": 0,
              "K1_flash_fixed": 0, "K2_ff_mod": 0})):
        pipe = Kandinsky5T2VPipeline(dit, conf5, embedder, vae, **kw)
        _kernels.reset_launches()
        rep, vids = _answer(pipe, [_video(f"5s-int8-{tag}", seconds5,
                                          VIDEO_PROMPT)], out_dir)
        got = dict(_kernels.LAUNCHES)
        log(f"  kernel launches on the 5 s int8 path ({tag}): {got}")
        db = psnr(next(iter(vids.values())), videos[bf16_video[0]])
        rep[0]["psnr_vs_bf16_db"] = db
        log(f"  5s-int8-{tag}: frame PSNR against the bf16 video {db:.2f} dB "
            "(random weights: recorded, not gated)")
        report += rep
        launches[f"5s-int8-{tag}"] = got
        wrong = {k: (got[k], n) for k, n in want.items() if got[k] != n}
        missing = [k for k in ("K3_conv3d", "K4_flash_online") if got[k] == 0]
        if wrong or missing:
            raise Failure(f"the 5 s int8 path ({tag}) launched (got, want) "
                          f"{wrong}, never launched {missing}")
        del pipe, vids
    torch.cuda.empty_cache()
    log("  decodes of the requests' latents: tiled, int8 convs (stream and "
        "tiled), 1024 x 1024")
    rep, dec_launches = phase_decodes(
        dev, conf5, vae, latents, videos[bf16_video[0]],
        videos10[video10[0]] if seconds10 == 10 else None)
    report += rep
    embedder.save(os.path.join(out_dir, TEXT_FILE))
    text_added += sum(r["text_s"] for r in report if "text_s" in r)
    t0 = time.perf_counter()
    report += text_options(towers, embedder, conf5, dit, vae, videos,
                           report[0], out_dir)
    text_added += time.perf_counter() - t0
    return ({**launches, **dec_launches}, report, text_added,
            (dit, vae, towers))


def text_timings(dev, conf):
    """The full-size seeded towers alone: the encode of a video request's
    caption and negative caption, and the expansion of its prompt on bf16
    and on int8 decode weights, each timed by the host clock after a
    synchronize, with its peak memory."""
    import torch

    from kandinsky5_tpu_torch.pipeline import DEFAULT_NEGATIVE

    emb = seeded_text_embedder(dev, conf.model.text_embedder)
    out = {}
    for rep in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        emb.encode([VIDEO_PROMPT], "video")
        emb.encode([DEFAULT_NEGATIVE], "video")
        torch.cuda.synchronize()
        out[f"encode_pair_s_{rep}"] = time.perf_counter() - t
    for int8 in (False, True):
        emb.int8_expand = int8
        torch.cuda.reset_peak_memory_stats()
        emb.expand_prompt(VIDEO_PROMPT)
        last = dict(emb.last_expansion)
        last["ms_per_token"] = 1e3 * last["seconds"] / max(last["new_tokens"], 1)
        last["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["expand_int8" if int8 else "expand_bf16"] = last
    log(f"  towers alone: {out}")
    return out


# the 5 s path's image request: its prompt is expanded (the JAX default)
IMAGE_REQUEST = ("image", "a smoke-test image", 0, (1, 1, 512, 768, 3),
                 "image.png", True)


def text_options(towers, embedder, conf5, dit, vae, videos, image_line,
                 out_dir):
    """The expansion on int8 decode weights (``int8_expand``), timed beside
    the bf16 one; then the image request again through ``offload=True``:
    its expansion and frames must equal the resident request's exactly
    (offload only moves bytes; the PSNR is printed, not gated), and its
    peak memory must be lower. The offload pipeline leaves the DiT, the VAE
    and the towers in host memory."""
    import numpy as np
    import torch

    from kandinsky5_tpu_torch.pipeline import Kandinsky5T2VPipeline
    from kandinsky5_tpu_torch.utils.metrics import psnr

    expanded = embedder.expansions[IMAGE_REQUEST[1]]
    towers.int8_expand = True
    t = time.perf_counter()
    int8_text = towers.expand_prompt(IMAGE_REQUEST[1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    last = towers.last_expansion
    ms_token = 1e3 * last["seconds"] / max(last["new_tokens"], 1)
    same = int8_text == expanded
    log(f"  expansion on int8 decode weights: {last['new_tokens']} new "
        f"tokens in {last['seconds']:.3f} s = {ms_token:.2f} ms/token "
        f"(quantization and all {wall:.3f} s); bf16's "
        f"{image_line['expand_ms_per_token']:.2f} ms/token; the same text as "
        f"bf16's: {same} (not gated)")
    towers.int8_expand = False
    towers.qwen_int8 = None
    torch.cuda.empty_cache()
    out = [dict(request="expansion int8", expand_tokens=last["new_tokens"],
                expand_ms_per_token=ms_token, same_text_as_bf16=same)]

    pipe = Kandinsky5T2VPipeline(dit, conf5, towers, vae, offload=True)
    torch.cuda.synchronize()
    log(f"  offload=True: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        "left on the card once the towers, the DiT and the VAE are in host "
        "memory")
    name, prompt, tl, shape, fname, _ = IMAGE_REQUEST
    offload_texts = []
    real_expand = towers.expand_prompt

    def expand_prompt(p):
        offload_texts.append(real_expand(p))
        return offload_texts[-1]

    towers.expand_prompt = expand_prompt
    try:
        rep, frames = _answer(pipe, [("image offload", prompt, tl, shape,
                                      "image_offload.png", True)], out_dir)
    finally:
        del towers.expand_prompt
    db = psnr(frames["image offload"], videos[name])
    exact = bool(np.array_equal(frames["image offload"], videos[name]))
    text_same = offload_texts == [expanded]
    peak, resident = rep[0]["peak_gib"], image_line["peak_gib"]
    log(f"  image offload: peak {peak:.2f} GiB against {resident:.2f} GiB "
        f"with resident towers, DiT and VAE; expansion equal to the "
        f"resident request's: {text_same}; frames equal: {exact} (PSNR "
        f"{db:.2f} dB, printed only: offload moves bytes, so any difference "
        f"is a fault)")
    rep[0].update(frames_equal_resident=exact, expansion_equal_resident=
                  text_same, resident_peak_gib=resident,
                  psnr_vs_resident_db=db if math.isfinite(db) else None)
    if not (peak < resident and exact and text_same):
        raise Failure(f"offload: peak {peak:.2f} GiB (resident {resident:.2f}"
                      f"), frames equal to the resident request's {exact} "
                      f"(PSNR {db:.2f} dB), expansion equal {text_same}")
    return out + rep


def _keep_latents(pipe, key, store=None):
    """Make ``pipe`` keep the latents of its last decode in ``store[key]``
    (the video request's, as it comes last)."""
    store = {} if store is None else store
    real = pipe.decode_latents

    def decode_latents(lat, mode=None):
        store[key] = lat
        return real(lat, mode)

    pipe.decode_latents = decode_latents
    return store


def expected_decode_launches(vae, shape, mode: str, int8: bool) -> dict:
    """K3's launches by mode and K4's in one ``vae.decode(z, mode=mode)``
    of latents ``shape``, counted from the decoder's structure: the tiles
    (or streaming chunks) the reference's tables give, and per tile each
    3x3x3 conv of 128-512 channels (14 resnets of two GroupNorm convs and
    three upsampler convs) routed by the TPU kernel's admission rule; K4
    once per tile or chunk of at least 2048 latent voxels."""
    import torch

    from kandinsky5_tpu_torch.models.vae import (
        BLOCK_OUT_CHANNELS,
        FLASH_MIN_TOKENS,
        LAYERS_PER_BLOCK,
        _up_plan,
    )
    from kandinsky5_tpu_torch.ops.conv import tpu_kernel_admits

    _, tf, hl, wl, _ = shape
    (ft, ht, wt), (fs, hs, ws) = vae._optimal_tiling(4 * (tf - 1) + 1,
                                                     8 * hl, 8 * wl)
    stream = mode == "stream" and not (wl > ws // 8 or hl > ht // 8)
    fuse = (not stream) if vae.fuse_gn is None else vae.fuse_gn
    if stream:
        n0 = min(tf, 4)
        frames = [n0] + [min(3, tf - i) for i in range(n0, tf, 3)]
        tiles = [(hl, wl)]
    else:
        t_lat = (ft - 1) // 4
        frames = ([len(range(tf)[i:i + t_lat + 1])
                   for i in range(0, tf - t_lat + 1, fs // 4)]
                  if tf > t_lat + 1 else [tf])
        if wl > ws // 8 or hl > ht // 8:
            tiles = [(ht // 8, wt // 8)] * (
                len(range(0, hl - ht // 8 + 1, hs // 8))
                * len(range(0, wl - wt // 8 + 1, ws // 8)))
        else:
            tiles = [(hl, wl)]
    per_tile = dict.fromkeys(("K3_conv3d", "K3_conv3d_fused",
                              "K3_conv3d_quant", "K3_quant_windows"), 0)

    def conv(cin, cout, h, w, gn):
        admitted = tpu_kernel_admits(
            torch.empty((1, 1, h, w, cin), device="meta"),
            torch.empty((cout, cin, 3, 3, 3), device="meta"))
        if int8 and admitted:
            per_tile["K3_conv3d_quant"] += 1
            per_tile["K3_quant_windows"] += 1
        elif gn and fuse and admitted:
            per_tile["K3_conv3d_fused"] += 1
        else:
            per_tile["K3_conv3d"] += 1

    def count(h, w):
        for k in per_tile:
            per_tile[k] = 0
        rev = list(reversed(BLOCK_OUT_CHANNELS))
        for _ in range(2 * 2):  # the mid block's two resnets
            conv(rev[0], rev[0], h, w, True)
        c_in = rev[0]
        for i, (add_s, _) in enumerate(_up_plan()):
            for j in range(LAYERS_PER_BLOCK + 1):
                conv(c_in if j == 0 else rev[i], rev[i], h, w, True)
                conv(rev[i], rev[i], h, w, True)
            c_in = rev[i]
            if add_s:
                h, w = 2 * h, 2 * w
                conv(rev[i], rev[i], h, w, False)
        return dict(per_tile)

    total = dict.fromkeys(list(per_tile) + ["K4_flash_online"], 0)
    for h, w in tiles:
        n = count(h, w)
        for t in frames:
            for k, v in n.items():
                total[k] += v
            total["K4_flash_online"] += t * h * w >= FLASH_MIN_TOKENS
    return total


def phase_decodes(dev, conf5, vae, latents, frames5, frames10):
    """The decodes beside the streaming default, each with its launch
    counts reset just before and held against ``expected_decode_launches``
    just after: the 5 s path video's latents (1 s, or 5 s with ``--seconds
    5``) decoded tiled, then with int8 convs streamed and tiled (frame PSNR
    against the bf16 decode of the same mode, recorded, not gated); a
    17-frame 1024 x 1024 decode through the pipeline's default decode,
    which tiles it 2 x 2 (``OPT_SPATIAL_TILING[1024]``); with ``--seconds
    10`` the 241-frame video's latents tiled, and its PSNR against the
    streaming decode the request made."""
    import numpy as np
    import torch

    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.pipeline import Kandinsky5T2VPipeline
    from kandinsky5_tpu_torch.utils.metrics import psnr

    pipe = Kandinsky5T2VPipeline(None, conf5, None, vae)
    pipe_i8 = Kandinsky5T2VPipeline(None, conf5, None, vae, int8_conv=True)
    g = torch.Generator(device=dev).manual_seed(11)
    big = torch.randn((1, 5, 128, 128, 16), generator=g, device=dev).bfloat16()
    cases = [("tiled", pipe, latents["5s"], "tiled", frames5, "stream bf16"),
             ("int8-stream", pipe_i8, latents["5s"], "stream", frames5,
              "stream bf16"),
             ("int8-tiled", pipe_i8, latents["5s"], "tiled", "tiled",
              "tiled bf16"),
             ("1024x1024", pipe, big, None, None, None)]
    if frames10 is not None:
        cases.append(("10s-tiled", pipe, latents["10s"], "tiled", frames10,
                      "stream bf16"))
    report, launches, decoded = [], {}, {}
    for name, p, lat, mode, against, against_name in cases:
        want = expected_decode_launches(p.vae, tuple(lat.shape),
                                        mode or p.decode_mode, p.int8_conv)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        t = time.perf_counter()
        frames = p.decode_latents(lat, mode)
        wall = time.perf_counter() - t
        got = dict(_kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        decoded[name] = frames
        tf, hl, wl = lat.shape[1:4]
        shape = (1, 4 * (tf - 1) + 1, 8 * hl, 8 * wl, 3)
        line = dict(request=f"decode {name}", decode_s=wall, peak_gib=peak,
                    frames=list(frames.shape))
        if isinstance(against, str):
            against = decoded[against]
        if against is not None:
            line["psnr_db"] = psnr(frames, against)
            line["psnr_against"] = against_name
        wrong = {k: (got[k], n) for k, n in want.items() if got[k] != n}
        log(f"  decode {name} {tuple(lat.shape)} -> {frames.shape}: "
            f"{wall:.3f} s, peak {peak:.2f} GiB, launches "
            f"{ {k: got[k] for k in want} }"
            + (f", PSNR against the {against_name} decode "
               f"{line['psnr_db']:.2f} dB" if against is not None else ""))
        if wrong or frames.shape != shape or frames.dtype != np.uint8 \
                or float(frames.std()) == 0.0:
            raise Failure(f"decode {name}: launches (got, want) {wrong}, "
                          f"frames {frames.shape} {frames.dtype}")
        launches[f"decode-{name}"] = got
        report.append(line)
    return report, launches


# ---------------------------------------------------------------------------
# phase 5: the tensor-parallel DiT, its ranks sharing the one card over gloo
# ---------------------------------------------------------------------------

# seed of the tp forward's weights and inputs
TP_SEED = 5
TP_WORLDS = (2, 4)
# the tp forwards' visual blocks (of 32) by tp width, as PERF.md section 7
# orders the cuts: tp 4 cut from 32 to 8 to pay for phase 5c and from 8 to
# 4 for phase 5d (its bias control read 1.6e-2 at 8 blocks), tp 2 from 32
# to 8 for phase 5e (at 32 its forward took 22.9-32.3 s a rank, H100 80GB
# HBM3, 700 W)
TP_BLOCKS = {2: 8, 4: 4}
# the tp = 2 video request's steps (the image keeps the config's 16): the
# smoke's time goes to phase 7 and, since the cut from 2, to phase 5e
TP_VIDEO_STEPS = 1
# a tp forward against the tp = 1 forward on the same card, relative L2: the
# two sum the row-parallel products in another order and round each rank's
# partial sum to bf16, which 34 bf16 blocks carry to the output. Over seeds
# 5-8 (``--tp-seeds``, H100 80GB HBM3, 700 W) the sound runs read 4.26e-3 to
# 4.51e-3 and the weakest control (bias on every rank, tp 2) 1.555e-2 to
# 1.653e-2; the bound sits near their geometric mean, about 1.8x from each
TP_BOUND = 8e-3
# the controls a sound tp forward must not resemble: each rank keeps its FF
# partial sum; each rank adds the out layers' bias before the all-reduce
TP_CONTROLS = ("no_ff_all_reduce", "bias_on_every_rank")
# the tp widths whose launch runs the controls: tp 4's (8 visual blocks),
# where they read 2-9x the bound; at tp 2 they cost two full-depth forwards
# (60 s) that phase 5c's time needs (H100 80GB HBM3, 700 W)
TP_CONTROL_WORLDS = (4,)


def tp_inputs(cfg, device, seed: int = TP_SEED, frames: int = 31,
              tiles: bool = False):
    """Seeded inputs of one DiT forward at the 5 s shape: a (1, 31, 64, 96,
    33) latent (47,616 visual tokens after 1 x 2 x 2 patches; with 61
    frames the 10 s shape, 93,696), 256 text tokens of which 200 are
    valid, a pooled embedding and t = 0.5. ``tiles``: the latent is one
    value over each 16 x 16 patch (NABLA's 64-token block) plus 10 %
    noise, so that the block-pooled attention map has structure, as a
    video's has; else white noise."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(1, frames, 64, 96, cfg.visual_embed_dim, generator=g)
    if tiles:
        coarse = x[:, :, ::16, ::16]
        x = 0.1 * x + coarse.repeat_interleave(16, 2).repeat_interleave(16, 3)
    text = torch.randn(1, 256, cfg.in_text_dim, generator=g)
    pooled = torch.randn(1, cfg.in_text_dim2, generator=g)
    mask = torch.arange(256)[None] < 200
    return (x.to(device, torch.bfloat16), text.to(device, torch.bfloat16),
            pooled.to(device, torch.bfloat16),
            torch.tensor([500.0], device=device), mask.to(device))


class _NoSum:
    """A group whose all-reduce leaves each rank's partial sum as it is."""

    def all_reduce(self, x):
        return x


def _tp_forward_rank(mesh, cfg_kw, controls, seed):
    """One rank of a tp forward: its share of the DiT seeded with ``seed``
    (weights and inputs), built one parameter at a time; the sound forward,
    then each control. Returns per run the output (the controls' on rank 0
    only), the wall and all-reduce seconds and the launch counts, reset
    just before the forward."""
    import contextlib
    from unittest import mock

    import torch
    import torch.nn.functional as F

    from kandinsky5_tpu_torch.config import DiTParams
    from kandinsky5_tpu_torch.models import dit as dit_mod
    from kandinsky5_tpu_torch.models import nn as nn_mod
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.parallel.sharding import fast_init_dit_shard

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tp = mesh.tp
    cfg = DiTParams(**cfg_kw)
    t = time.perf_counter()
    model = fast_init_dit_shard(cfg, tp, seed=seed)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t,
           "params": sum(p.numel() for p in model.parameters())}
    args = tp_inputs(cfg, tp.device, seed)
    real_ff = nn_mod.feed_forward

    def ff_without_sum(p, x, tp=None):
        return real_ff(p, x, None if tp is None else _NoSum())

    def bias_on_every_rank(layer, x, tp=None):
        if tp is None:
            return nn_mod.linear(layer, x)
        return tp.all_reduce(F.linear(x, layer.weight, layer.bias))

    patches = {"sound": (),
               "no_ff_all_reduce": ((nn_mod, "feed_forward", ff_without_sum),),
               "bias_on_every_rank": ((dit_mod, "row_parallel_linear",
                                       bias_on_every_rank),)}
    for name in ("sound",) + tuple(controls):
        with contextlib.ExitStack() as stack:
            for mod, attr, fn in patches[name]:
                stack.enter_context(mock.patch.object(mod, attr, fn))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tp.reset_stats()
            _kernels.reset_launches()
            t = time.perf_counter()
            y = dit_mod.dit_forward(model, *args, scale_factor=(1.0, 2.0, 2.0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = dict(_kernels.LAUNCHES)
        out[name] = dict(
            y=y.float().cpu() if name == "sound" or tp.rank == 0 else None,
            wall_s=wall, all_reduce_s=tp.seconds,
            all_reduce_calls=tp.calls, all_reduce_bytes=tp.bytes,
            launches=launches,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del y
    return out


def _tp_request_rank(mesh, seconds, out_dir):
    """One rank of the tp = 2 pipeline answering the 5 s path's video
    request (prompt, seed, weights and VAE as phase 4's, and phase 4's
    text embeddings, replayed from ``out_dir``); each
    rank decodes its share of the tiles, rank 0 blends and writes, then
    holds its frames against the single-process tiled decode of the same
    latents (``_single_decodes``)."""
    import numpy as np
    import torch

    from kandinsky5_tpu_torch.config import CONFIG_DIR, load_config
    from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE, init_vae_params
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.parallel.sharding import fast_init_dit_shard
    from kandinsky5_tpu_torch.pipeline import Kandinsky5T2VPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tp = mesh.tp
    conf = load_config(os.path.join(CONFIG_DIR, CONF5))
    dit = fast_init_dit_shard(conf.model.dit_params, tp, seed=0)
    vae = HunyuanVideoVAE(init_vae_params(device=tp.device,
                                          dtype=torch.bfloat16, seed=1))
    pipe = Kandinsky5T2VPipeline(dit, conf, ReplayEmbedder(
        os.path.join(out_dir, TEXT_FILE)), vae, tp=mesh)
    kept = _keep_latents(pipe, "tp2")
    # the image request left phase 5 for phase 5d's (5c's covers a mesh
    # pipeline's image)
    requests = [_video("tp2", seconds, VIDEO_PROMPT) + (False,
                                                        TP_VIDEO_STEPS)]
    report, frames, decoded = [], None, []
    _kernels.reset_launches()
    for name, prompt, tl, shape, fname, expand, steps in requests:
        torch.cuda.synchronize()
        t = time.perf_counter()
        frames = pipe(prompt, time_length=tl, width=768, height=512, seed=42,
                      num_steps=steps, expand_prompts=expand,
                      save_path=os.path.join(out_dir, fname))
        wall = time.perf_counter() - t
        tm = dict(pipe.timings)
        line = dict(request=name, rank=tp.rank, wall_s=wall,
                    s_per_step=tm["denoise_s"] / tm["steps"],
                    denoise_s=tm["denoise_s"], steps=tm["steps"],
                    all_reduce_s=tm["all_reduce_s"],
                    all_reduce_calls=tm["all_reduce_calls"],
                    all_reduce_bytes=tm["all_reduce_bytes"],
                    decoded_tiles=tm["decoded_tiles"],
                    latents_finite=tm["latents_finite"])
        decoded.append((name, kept["tp2"], frames))
        if tp.rank == 0:
            saved = tm["saved"][0]
            line.update(decode_s=tm["decode_s"], saved=saved,
                        saved_bytes=os.path.getsize(saved),
                        frames=list(frames.shape),
                        frames_ok=bool(frames.shape == shape
                                       and frames.dtype == np.uint8
                                       and float(frames.std()) > 0.0))
        elif frames is not None:
            raise Failure(f"rank {tp.rank} returned frames")
        report.append(line)
    out = dict(report=report, launches=dict(_kernels.LAUNCHES))
    if mesh.rank == 0:
        out.update(_single_decodes(pipe, decoded))
    return out


def single_forward(cfg, dev, args, seed: int, **kw):
    """One bf16 DiT forward of ``fast_init_dit_params(cfg, seed)`` on one
    device: (output on the CPU, host seconds, launches)."""
    import torch

    from kandinsky5_tpu_torch.models.dit import dit_forward, fast_init_dit_params
    from kandinsky5_tpu_torch.ops import _kernels

    dit = fast_init_dit_params(cfg, device=dev, seed=seed)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t = time.perf_counter()
    out = dit_forward(dit, *args, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got = dict(_kernels.LAUNCHES)
    out = out.float().cpu()
    del dit
    torch.cuda.empty_cache()
    return out, wall, got


def tp_forwards(dev, cfg, seed: int = TP_SEED):
    """One DiT forward at full width and depth at the 5 s shape on one
    device, then as tp = 2 and tp = 4 ranks sharing the card over gloo
    (each TP_BLOCKS visual blocks deep and held against one device's
    forward at that depth), each held against it with TP_BOUND and with the
    controls, which must fail it; launch counts per rank exact. Weights and
    inputs seeded with ``seed``. Returns the launches, the report and what
    failed."""
    import dataclasses

    import torch

    from kandinsky5_tpu_torch.parallel import launch

    n_text, n_vis = cfg.num_text_blocks, cfg.num_visual_blocks
    ref, wall1, got1 = single_forward(cfg, dev, tp_inputs(cfg, dev, seed),
                                      seed, scale_factor=(1.0, 2.0, 2.0))
    log(f"  tp 1 (seed {seed}): forward {wall1:.3f} s, output {tuple(ref.shape)}, launches "
        f"K1 {got1['K1_flash_fixed']} K2 {got1['K2_ff_mod']} K8 "
        f"{got1['K8_ff']}")
    # K2 takes the visual blocks only: the 256-row text blocks run the
    # chain, as the JAX package's gate declines them
    want1 = {"K1_flash_fixed": n_text + n_vis, "K2_ff_mod": n_vis,
             "K8_ff": 0}
    wrong = {k: (got1[k], n) for k, n in want1.items() if got1[k] != n}
    if wrong or not bool(torch.isfinite(ref).all()):
        raise Failure(f"tp 1 forward: launches (got, want) {wrong}")

    launches, report, failed = {}, [], []
    full = ref
    for world in TP_WORLDS:
        wcfg = dataclasses.replace(cfg, num_visual_blocks=TP_BLOCKS[world])
        ref = full if wcfg == cfg else single_forward(
            wcfg, dev, tp_inputs(wcfg, dev, seed), seed,
            scale_factor=(1.0, 2.0, 2.0))[0]
        n_vis = wcfg.num_visual_blocks
        want = {"K8_ff": n_vis, "K1_flash_fixed": n_text + n_vis,
                "K2_ff_mod": 0}
        controls = TP_CONTROLS if world in TP_CONTROL_WORLDS else ()
        t = time.perf_counter()
        res = launch(_tp_forward_rank, world, "gloo", "cuda",
                     args=(dataclasses.asdict(wcfg), controls, seed),
                     timeout=900)
        total = time.perf_counter() - t
        line = dict(request=f"tp{world} forward", seed=seed, launch_s=total,
                    visual_blocks=n_vis,
                    wall_s=[r["sound"]["wall_s"] for r in res],
                    all_reduce_s=[r["sound"]["all_reduce_s"] for r in res],
                    build_s=[r["build_s"] for r in res],
                    peak_gib=[r["sound"]["peak_gib"] for r in res],
                    params_per_rank=res[0]["params"])
        bad = []
        for rank, r in enumerate(res):
            s = r["sound"]
            rel, max_abs = _rel(s["y"], ref), (s["y"] - ref).abs().max().item()
            line.setdefault("rel_l2", []).append(rel)
            wrong = {k: (s["launches"][k], n) for k, n in want.items()
                     if s["launches"][k] != n}
            log(f"  tp {world} rank {rank} ({n_vis} visual blocks): "
                f"forward {s['wall_s']:.3f} s, "
                f"all-reduce {s['all_reduce_s']:.3f} s in "
                f"{s['all_reduce_calls']} calls ({s['all_reduce_bytes'] / 2**30:.2f}"
                f" GiB; gloo through the host, {world} ranks on one card), "
                f"build {r['build_s']:.1f} s, {r['params']} params, peak "
                f"{s['peak_gib']:.2f} GiB; against tp 1: rel_l2 {rel:.3e} "
                f"max_abs {max_abs:.3e} (bound {TP_BOUND}); launches K8 "
                f"{s['launches']['K8_ff']} K1 {s['launches']['K1_flash_fixed']}"
                f" K2 {s['launches']['K2_ff_mod']}")
            if (wrong or rel > TP_BOUND or s["all_reduce_calls"] != 3 * n_vis
                    or not torch.equal(s["y"], res[0]["sound"]["y"])):
                bad.append(f"rank {rank}: rel_l2 {rel:.3e}, launches (got, "
                           f"want) {wrong}, {s['all_reduce_calls']} "
                           "all-reduces, or unlike rank 0")
        for name in controls:
            c = res[0][name]
            rel = _rel(c["y"], ref)
            line[f"{name}_rel_l2"] = rel
            fails = rel > TP_BOUND
            log(f"  tp {world} control ({name}): rel_l2 {rel:.3e} "
                f"{'fails the bound' if fails else 'PASSES'}")
            if not fails:
                bad.append(f"control {name} passes the bound")
        launches[f"tp{world}-forward"] = {
            k: sum(r["sound"]["launches"][k] for r in res) for k in got1}
        report.append(line)
        del res
        if bad:
            failed.append(f"tp {world} forward (seed {seed}): "
                          f"{'; '.join(bad)}")
    return launches, report, failed


def phase_tp(dev, conf5, seconds5: int, out_dir: str):
    """(a) :func:`tp_forwards` at TP_SEED. (b) The tp = 2 pipeline answers
    the 5 s path's video request (TP_VIDEO_STEPS steps), its decode split
    over both ranks as the JAX factory
    splits them over every device of the pipeline: rank 0's frames against
    the single-process tiled decode of the same latents, K3 and K4 summed
    over the ranks equal to that decode's."""
    from kandinsky5_tpu_torch.parallel import launch

    launches, report, failed = tp_forwards(dev, conf5.model.dit_params)
    if failed:
        raise Failure("; ".join(failed))
    n_text = conf5.model.dit_params.num_text_blocks
    n_vis = conf5.model.dit_params.num_visual_blocks
    log(f"  tp 2 pipeline ({os.path.basename(CONF5)}): the video request "
        f"({TP_VIDEO_STEPS} steps), the tiles decoded over both ranks")
    res = launch(_tp_request_rank, 2, "gloo", "cuda",
                 args=(seconds5, out_dir), timeout=900)
    steps = TP_VIDEO_STEPS
    want = {"K8_ff": n_vis * steps,
            "K1_flash_fixed": (n_text + n_vis) * steps, "K2_ff_mod": 0}
    bad = _decode_split_faults(res, res[0]["single_launches"])
    for name, m in res[0]["frames"].items():
        log(f"  {name}: rank 0's frames against the single-process tiled "
            f"decode of its latents: {m['max_levels']} levels at most, on "
            f"{m['share']:.2e} of the values")
    for rank, r in enumerate(res):
        got = r["launches"]
        wrong = {k: (got[k], n) for k, n in want.items() if got[k] != n}
        if wrong:
            bad.append(f"rank {rank}: launches (got, want) {wrong}")
        for line in r["report"]:
            share = line["all_reduce_s"] / line["denoise_s"]
            line["all_reduce_share"] = share
            log(f"  {line['request']} rank {rank}: {line['s_per_step']:.4f} "
                f"s/step ({line['steps']} steps), all-reduce "
                f"{line['all_reduce_s']:.3f} s in {line['all_reduce_calls']} "
                f"calls = {share:.3f} of the denoise (gloo through the host, "
                "2 ranks on one card)"
                + f"; decoded {line['decoded_tiles']} tiles"
                + (f"; decode (tiled, split) {line['decode_s']:.3f} s, frames "
                   f"{line['frames']}, wrote {line['saved']} "
                   f"({line['saved_bytes']} bytes)" if rank == 0 else ""))
            if not line["latents_finite"] or (rank == 0
                                               and not line["frames_ok"]):
                bad.append(f"{line['request']} rank {rank}: bad output")
            report.append(line)
    launches["tp2-requests"] = {
        k: sum(r["launches"][k] for r in res) for k in res[0]["launches"]}
    if bad:
        raise Failure("tp 2 requests: " + "; ".join(bad))
    return launches, report


# ---------------------------------------------------------------------------
# the data axis (phases 5a, 5b and 7b): ranks sharing the one card over gloo
# ---------------------------------------------------------------------------

# 5a: the dp request's Euler steps and guidance (config_5s_sft's CFG)
# (cut from 4 to pay for phase 5c, as PERF.md section 7 orders the cuts)
DP_STEPS = 2
DP_GUIDANCE = 5.0
# 5a: the dp run's latents against the single-device run of the same
# weights, seed and steps with the CFG pair as two sequential calls, relative
# L2: each rank's call is one of those calls, the same shapes through the
# same kernels and routes, so only an unlike library GEMM algorithm could
# part them. Half of TP_BOUND: dp reorders no sum inside an item, where tp
# splits each row-parallel product.
DP_BOUND = 4e-3
# 5a: the same against the single-device batched-CFG run. Its text blocks
# see 512 rows, which the JAX package's gate (``ff_supported``) admits to
# K2, where a rank's 256-row call runs the bf16 chain; that rounding, carried
# through 34 blocks and 4 steps and amplified by guidance 5, read 1.364e-2
# on the card (H100 80GB HBM3, 700 W), against 1.761 for the weaker
# no-gather control. The bound sits near 4x the first and 35x under the
# second.
BATCHED_BOUND = 5e-2
# rank 0's frames against the single-process tiled decode of the same
# latents: at most FRAME_LEVELS uint8 levels apart, on under FRAME_SHARE of
# the values
FRAME_LEVELS, FRAME_SHARE = 1, 0.01
# 5b: the depth (text, visual blocks) of the full-width DiT of the dp x tp
# forward (full depth is phase 5's tp forwards'), and its seed
DPTP_BLOCKS = (2, 8)
DPTP_SEED = 6
# 7b: the seed of the ZeRO-1 step's DiT and of its t and noise
ZERO_SEED = 14
DECODE_KERNELS = ("K3_conv3d", "K3_conv3d_fused", "K4_flash_online")


def _frames_match(frames, want) -> dict:
    import numpy as np

    diff = np.abs(frames.astype(np.int16) - want.astype(np.int16))
    return dict(max_levels=int(diff.max()), share=float((diff > 0).mean()))


def _frames_ok(m) -> bool:
    return m["max_levels"] <= FRAME_LEVELS and m["share"] < FRAME_SHARE


def _without_gather(self, x):
    """A dp group that skips the predictions' gather: each rank holds its
    own predictions in its slot and zeros, never filled, in its peers'."""
    import torch

    parts = [torch.zeros_like(x) for _ in range(self.size)]
    parts[self.rank] = x
    return torch.cat(parts)


def _swapped_tiles(real):
    """``decode_shared`` with the first two decoded tiles swapped before the
    blend."""
    def swapped(group, tiles, decode_one):
        got = real(group, tiles, decode_one)
        return None if got is None else [got[1], got[0]] + got[2:]

    return swapped


def _single_decodes(pipe, decoded, controls=None) -> dict:
    """On rank 0 of a pipeline's mesh: the single-process tiled decode of
    each (name, latents, frames of the split decode), on the same card with
    the same VAE, its launches summed, and the frames compared; each of
    ``controls`` (name: frames) is compared with the same decode."""
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.pipeline import Kandinsky5T2VPipeline

    one = Kandinsky5T2VPipeline(None, pipe.conf, None,
                                pipe.vae.replace(group=None),
                                decode_mode="tiled")
    controls = controls or {}
    _kernels.reset_launches()
    out = {"frames": {}, "controls": {}}
    for name, latents, frames in decoded:
        want = one.decode_latents(latents)
        out["frames"][name] = _frames_match(frames, want)
        if name in controls:
            out["controls"][name] = _frames_match(controls[name], want)
    out["single_launches"] = dict(_kernels.LAUNCHES)
    return out


def _decode_split_faults(res, single, key="launches",
                         every_rank: bool = True) -> list:
    """What is wrong with a split decode: rank 0's frames (``_frames_ok``),
    a rank that decoded no tile (unless not ``every_rank``: fewer tiles
    than ranks), K3 and K4 summed over the ranks unlike the single-process
    decode's ``single``."""
    bad = [f"{name}: frames {m}" for name, m in res[0]["frames"].items()
           if not _frames_ok(m)]
    summed = {k: sum(r[key][k] for r in res) for k in DECODE_KERNELS}
    if summed != {k: single[k] for k in DECODE_KERNELS}:
        bad.append(f"decode launches over the ranks {summed}, single "
                   f"{ {k: single[k] for k in DECODE_KERNELS} }")
    idle = [rank for rank, r in enumerate(res)
            if sum(r[key][k] for k in DECODE_KERNELS[:2]) == 0]
    if idle and every_rank:
        bad.append(f"rank(s) {idle} decoded no tile")
    return bad


def _dp_rank(mesh, out_dir):
    """One rank of phase 5a (see :func:`phase_dp`)."""
    import dataclasses
    from unittest import mock

    import torch

    from kandinsky5_tpu_torch.config import CONFIG_DIR, load_config
    from kandinsky5_tpu_torch.models import vae as vae_mod
    from kandinsky5_tpu_torch.models.dit import fast_init_dit_params
    from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE, init_vae_params
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.parallel import DataParallel
    from kandinsky5_tpu_torch.pipeline import (
        DEFAULT_NEGATIVE,
        SCHEDULER_SCALE,
        Kandinsky5T2VPipeline,
    )
    from kandinsky5_tpu_torch.sampling import generate_latents

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    conf = load_config(os.path.join(CONFIG_DIR, CONF5_SFT))
    t = time.perf_counter()
    dit = fast_init_dit_params(conf.model.dit_params, device=dev, seed=0)
    vae = HunyuanVideoVAE(init_vae_params(device=dev, dtype=torch.bfloat16,
                                          seed=1))
    pipe = Kandinsky5T2VPipeline(dit, conf, ReplayEmbedder(
        os.path.join(out_dir, TEXT_FILE)), vae, tp=mesh)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t}
    kept = _keep_latents(pipe, "dp")
    _, prompt, tl, _, fname = _video("dp", 1, VIDEO_PROMPT)
    kw = dict(time_length=tl, width=768, height=512, seed=42,
              num_steps=DP_STEPS, guidance_weight=DP_GUIDANCE,
              expand_prompts=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t = time.perf_counter()
    frames = pipe(prompt, save_path=os.path.join(out_dir, fname), **kw)
    wall = time.perf_counter() - t
    tm = dict(pipe.timings)
    out["launches"] = dict(_kernels.LAUNCHES)
    out["line"] = dict(
        request="dp video 1s", rank=mesh.rank, wall_s=wall,
        steps=tm["steps"], s_per_step=tm["denoise_s"] / tm["steps"],
        denoise_s=tm["denoise_s"], decode_s=tm["decode_s"],
        gather_s=tm["gather_s"], gather_calls=tm["gather_calls"],
        gather_bytes=tm["gather_bytes"], dp_split=tm["dp_split"],
        decoded_tiles=tm["decoded_tiles"],
        latents_finite=tm["latents_finite"],
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    latents = kept["dp"]
    out["latents"] = latents.float().cpu()
    # control: ranks that skip the predictions' gather (nothing decoded)
    with mock.patch.object(DataParallel, "all_gather", _without_gather), \
            mock.patch.object(pipe, "decode_latents",
                              lambda lat, mode=None: kept.update(ctl=lat)):
        pipe(prompt, **kw)
    out["no_gather"] = kept["ctl"].float().cpu()
    # control: two tiles swapped before the blend (every rank takes part)
    with mock.patch.object(vae_mod, "decode_shared",
                           _swapped_tiles(vae_mod.decode_shared)):
        swapped = pipe.decode_latents(latents)
    # the 17-frame 1024 x 1024 latents of phase 4's decodes: 2 x 2 tiles
    g = torch.Generator(device=dev).manual_seed(11)
    big = torch.randn((1, 5, 128, 128, 16), generator=g,
                      device=dev).bfloat16()
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    big_frames = pipe.decode_latents(big)
    out["big"] = dict(decode_s=time.perf_counter() - t,
                      decoded_tiles=pipe.vae.decoded_tiles,
                      launches=dict(_kernels.LAUNCHES))
    if mesh.rank == 0:
        # the single-device runs of the same weights, seed and steps: the
        # CFG pair as two sequential calls, then as one batch of two
        spec = pipe._spec(DP_STEPS, DP_GUIDANCE, SCHEDULER_SCALE)
        cond = pipe._encode([prompt], "video")
        uncond = pipe._encode([DEFAULT_NEGATIVE], "video")
        for key, sequential in (("sequential", True), ("batched", False)):
            _kernels.reset_launches()
            single = generate_latents(
                dit, dataclasses.replace(spec, sequential_cfg=sequential),
                tuple(latents.shape), cond, uncond, seed=42)
            out[key] = single.float().cpu()
            out[f"{key}_launches"] = dict(_kernels.LAUNCHES)
        out.update(_single_decodes(pipe, [("dp video 1s", latents, frames)],
                                   {"dp video 1s": swapped}))
        out["big"].update(_single_decodes(
            pipe, [("dp decode 1024x1024", big, big_frames)]))
    return out


def phase_dp(out_dir: str):
    """5a: one launch of 2 ranks on the (2, 1, 1) mesh sharing the card over
    gloo. config_5s_sft.yaml at full width and depth (seeded +-0.02 weights
    drawn on each rank) answers the 1 s video (25 frames, 10,752 tokens)
    with DP_STEPS Euler steps at guidance DP_GUIDANCE on phase 4's replayed
    text embeddings, the CFG pair split (rank 0 cond, rank 1 uncond): both
    ranks' latents equal, within DP_BOUND of the single-device batched-CFG
    run on rank 0 with the pair as two sequential calls (same weights,
    seed and steps; each rank's call is one of its two calls a step, so
    each rank's K1 and K2 counts are half of its), and within
    BATCHED_BOUND of the batched-CFG run; control: ranks that skip the predictions' gather fail both. The request's tiled decode is split, a temporal tile a rank,
    and so is a 17-frame 1024 x 1024 decode (2 x 2 spatial tiles, two a
    rank): rank 0's frames against the single-process tiled decode of the
    same latents (FRAME_LEVELS, FRAME_SHARE), K3 and K4 summed over the
    ranks equal to that decode's; control: two tiles swapped before the
    blend fail it. Returns the launches by path and the report."""
    from kandinsky5_tpu_torch.parallel import launch

    t = time.perf_counter()
    res = launch(_dp_rank, 2, "gloo", "cuda", args=(out_dir,), timeout=900,
                 dp=2)
    launch_s = time.perf_counter() - t
    r0 = res[0]
    single, batched = r0["sequential"], r0["batched"]
    report, bad = [], []
    for rank, r in enumerate(res):
        line = r["line"]
        line.update(rel_l2=_rel(r["latents"], single),
                    batched_rel_l2=_rel(r["latents"], batched),
                    no_gather_rel_l2=_rel(r["no_gather"], single),
                    no_gather_batched_rel_l2=_rel(r["no_gather"], batched),
                    build_s=r["build_s"], launch_s=launch_s,
                    big_decode_s=r["big"]["decode_s"],
                    big_decoded_tiles=r["big"]["decoded_tiles"])
        got = {k: r["launches"][k] for k in ("K1_flash_fixed", "K2_ff_mod")}
        # a rank makes one of the sequential run's two calls a step
        want = {k: r0["sequential_launches"][k] // 2 for k in got}
        log(f"  dp rank {rank}: {line['s_per_step']:.4f} s/step "
            f"({line['steps']} steps, the CFG pair split: {line['dp_split']});"
            f" gather {line['gather_s']:.3f} s in {line['gather_calls']} calls"
            f" ({line['gather_bytes']} bytes; gloo through the host, 2 ranks "
            f"on one card, not a multi-GPU figure); decode {line['decode_s']:.3f}"
            f" s, {line['decoded_tiles']} tiles; 1024 x 1024 decode "
            f"{line['big_decode_s']:.3f} s, {line['big_decoded_tiles']} tiles;"
            f" peak {line['peak_gib']:.2f} GiB; build {line['build_s']:.1f} s;"
            f" latents against the single-device run, sequential CFG: rel_l2 "
            f"{line['rel_l2']:.3e} (bound {DP_BOUND}), batched CFG "
            f"{line['batched_rel_l2']:.3e} (bound {BATCHED_BOUND}); control "
            f"without the gather {line['no_gather_rel_l2']:.3e}, "
            f"{line['no_gather_batched_rel_l2']:.3e}; K1, K2 {got} (half the "
            f"single device's sequential run: {want}; its batched run "
            f"{ {k: r0['batched_launches'][k] for k in got} })")
        if not torch_equal(r["latents"], r0["latents"]):
            bad.append(f"rank {rank}'s latents unlike rank 0's")
        if (line["rel_l2"] > DP_BOUND or not line["latents_finite"]
                or line["batched_rel_l2"] > BATCHED_BOUND):
            bad.append(f"rank {rank}: rel_l2 {line['rel_l2']:.3e}, batched "
                       f"{line['batched_rel_l2']:.3e}")
        if (line["no_gather_rel_l2"] <= DP_BOUND
                or line["no_gather_batched_rel_l2"] <= BATCHED_BOUND):
            bad.append(f"rank {rank}: the control without the gather passes")
        if got != want or 2 * sum(want.values()) != sum(
                r0["sequential_launches"][k] for k in got):
            bad.append(f"rank {rank}: K1, K2 {got}, half the sequential "
                       f"run's {want}")
        if (not line["dp_split"] or line["gather_calls"] != DP_STEPS
                or line["decoded_tiles"] != 1
                or line["big_decoded_tiles"] != 2):
            bad.append(f"rank {rank}: split {line['dp_split']}, "
                       f"{line['gather_calls']} gathers, tiles "
                       f"{line['decoded_tiles']} / {line['big_decoded_tiles']}")
        report.append(line)
    for name, m in {**r0["frames"], **r0["big"]["frames"]}.items():
        log(f"  {name}: rank 0's frames against the single-process tiled "
            f"decode of the same latents: {m['max_levels']} levels at most, "
            f"on {m['share']:.2e} of the values")
    ctl = r0["controls"]["dp video 1s"]
    log(f"  control (two tiles swapped before the blend): {ctl['max_levels']}"
        f" levels at most, on {ctl['share']:.2e} of the values "
        + ("fails the check" if not _frames_ok(ctl) else "PASSES"))
    if _frames_ok(ctl):
        bad.append("the control with two tiles swapped passes")
    bad += _decode_split_faults(res, r0["single_launches"])
    bad += _decode_split_faults([r["big"] for r in res],
                                r0["big"]["single_launches"])
    if bad:
        raise Failure("dp: " + "; ".join(bad))
    launches = {"dp-request": _summed(r["launches"] for r in res),
                "dp-decode-1024x1024": _summed(r["big"]["launches"]
                                               for r in res)}
    return launches, report


def _free_port() -> int:
    """A port of 127.0.0.1 free when asked (for a TCPStore)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


def _summed(counts) -> dict:
    """Launch counts summed over the ranks."""
    counts = list(counts)
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def dptp_inputs(cfg, device, seed: int):
    """A two-item DiT call at the 1 s shape, as the CFG pair's: (2, 7, 64,
    96, 33) latents (10,752 visual tokens an item), two 256-token texts of
    which 200 and 150 are valid, their pooled embeddings. Unlike a CFG
    pair's, the two latents differ: with random weights the two texts move
    the output little, and an item gathered from the wrong dp peer must
    show."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 7, 64, 96, cfg.visual_embed_dim, generator=g)
    text = torch.randn(2, 256, cfg.in_text_dim, generator=g)
    pooled = torch.randn(2, cfg.in_text_dim2, generator=g)
    mask = torch.arange(256)[None] < torch.tensor([[200], [150]])
    return (x.to(device, torch.bfloat16),
            text.to(device, torch.bfloat16),
            pooled.to(device, torch.bfloat16), mask.to(device))


def _dptp_spec(cfg):
    from kandinsky5_tpu_torch.sampling import DenoiseSpec

    return DenoiseSpec(dit_params=cfg, num_steps=1,
                       guidance_weight=DP_GUIDANCE, scheduler_scale=10.0,
                       scale_factor=(1.0, 2.0, 2.0))


def _dptp_rank(mesh, cfg_kw, seed):
    """One rank of phase 5b: its tp share of the seeded cut DiT, the CFG
    pair's DiT call split over dp (``sampling.dp_dit_call``); then the same
    with the dp peers' predictions gathered in the wrong order (the
    control)."""
    from unittest import mock

    import torch

    from kandinsky5_tpu_torch.config import DiTParams
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.parallel import DataParallel
    from kandinsky5_tpu_torch.parallel.sharding import fast_init_dit_shard
    from kandinsky5_tpu_torch.sampling import dp_dit_call

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = DiTParams(**cfg_kw)
    model = fast_init_dit_shard(cfg, mesh.tp, seed=seed)
    args = dptp_inputs(cfg, mesh.device, seed)
    spec = _dptp_spec(cfg)

    @torch.no_grad()
    def call():
        return dp_dit_call(model, spec, None, *args, 0.5, dp=mesh.dp)[0]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    mesh.tp.reset_stats()
    mesh.dp.reset_stats()
    t = time.perf_counter()
    y = call()
    torch.cuda.synchronize()
    out = dict(y=y.cpu(), wall_s=time.perf_counter() - t, host=mesh.host,
               tp_ranks=mesh.tp.ranks, local_ranks=mesh.local.ranks,
               launches=dict(_kernels.LAUNCHES),
               all_reduce_s=mesh.tp.seconds, all_reduce_calls=mesh.tp.calls,
               gather_s=mesh.dp.seconds, gather_calls=mesh.dp.calls,
               gather_bytes=mesh.dp.bytes,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    real = DataParallel.all_gather

    def wrong_peer(self, x):
        return torch.cat(real(self, x).chunk(self.size)[::-1])

    with mock.patch.object(DataParallel, "all_gather", wrong_peer):
        out["control"] = call().cpu()
    return out


def phase_dptp(dev, conf5):
    """5b: 4 ranks on the (2, 1, 2) mesh sharing the card, launched as two
    emulated hosts (two node launches of 2 ranks each from this process,
    meeting on a TCPStore at 127.0.0.1; the grid is JAX's hybrid layout,
    each tp row one host's ranks, printed with its host): a two-item DiT
    call at the 1 s shape (``dptp_inputs``), full width,
    DPTP_BLOCKS deep, each dp group computing one item with its two tp ranks
    and the predictions gathered over dp; every rank's output within
    TP_BOUND of the single-device calls of one item each (a dp group's
    shapes) and within BATCHED_BOUND of the batched call (whose 512 text
    rows take K2) of the same seeded weights, equal on every rank, launch
    counts exact (K8 and K1 per block, K2 none); control: the dp peers'
    predictions gathered in the wrong order fail both bounds."""
    import dataclasses

    import torch

    from kandinsky5_tpu_torch.models.dit import fast_init_dit_params
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.parallel import launch
    from kandinsky5_tpu_torch.sampling import _dit_call

    n_text, n_vis = DPTP_BLOCKS
    cfg = dataclasses.replace(conf5.model.dit_params,
                              num_text_blocks=n_text,
                              num_visual_blocks=n_vis)
    model = fast_init_dit_params(cfg, device=dev, seed=DPTP_SEED)
    args = dptp_inputs(cfg, dev, DPTP_SEED)
    spec = _dptp_spec(cfg)
    _kernels.reset_launches()
    with torch.no_grad():
        # one call an item (a dp group's shapes), then the batch of two
        ref = torch.cat([_dit_call(model, spec, None,
                                   *(a[i:i + 1] for a in args), 0.5)[0]
                         for i in range(2)]).cpu()
        single = dict(_kernels.LAUNCHES)
        batched = _dit_call(model, spec, None, *args, 0.5)[0].cpu()
    del args
    del model
    torch.cuda.empty_cache()
    t = time.perf_counter()
    # two emulated hosts: a node launch of 2 ranks each, meeting on a
    # TCPStore at 127.0.0.1, on the hybrid layout (dp over the hosts)
    master = ("127.0.0.1", _free_port())
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        nodes = [pool.submit(launch, _dptp_rank, 4, "gloo", "cuda",
                             args=(dataclasses.asdict(cfg), DPTP_SEED),
                             timeout=900, dp=2, nodes=2, node_rank=h,
                             master=master) for h in range(2)]
        res = [r for node in nodes for r in node.result()]
    launch_s = time.perf_counter() - t
    for rank in (0, 2):
        r = res[rank]
        log(f"  tp row {r['tp_ranks']} on host {r['host']} (its ranks "
            f"{r['local_ranks']})")
        if r["tp_ranks"] != r["local_ranks"] or r["host"] != rank // 2:
            raise Failure(f"dp x tp: the tp row {r['tp_ranks']} is not host "
                          f"{rank // 2}'s ranks {r['local_ranks']}")
    want = {"K8_ff": n_vis, "K1_flash_fixed": n_text + n_vis, "K2_ff_mod": 0}
    bad, line = [], dict(request="dp x tp forward", blocks=DPTP_BLOCKS,
                         launch_s=launch_s, single_launches={
                             k: single[k] for k in want})
    for rank, r in enumerate(res):
        rel, ctl = _rel(r["y"], ref), _rel(r["control"], ref)
        rel_b, ctl_b = _rel(r["y"], batched), _rel(r["control"], batched)
        got = {k: r["launches"][k] for k in want}
        for k in ("wall_s", "all_reduce_s", "gather_s", "peak_gib"):
            line.setdefault(k, []).append(r[k])
        line.setdefault("rel_l2", []).append(rel)
        line.setdefault("batched_rel_l2", []).append(rel_b)
        line.setdefault("wrong_peer_rel_l2", []).append(ctl)
        log(f"  dp x tp rank {rank} (dp {rank // 2}, tp {rank % 2}): forward "
            f"{r['wall_s']:.3f} s, all-reduce {r['all_reduce_s']:.3f} s in "
            f"{r['all_reduce_calls']} calls, gather {r['gather_s']:.3f} s in "
            f"{r['gather_calls']} ({r['gather_bytes']} bytes; gloo through "
            f"the host, 4 ranks on one card), peak {r['peak_gib']:.2f} GiB; "
            f"against one device, a call an item: rel_l2 {rel:.3e} (bound "
            f"{TP_BOUND}), the batch of two {rel_b:.3e} (bound "
            f"{BATCHED_BOUND}); control (wrong dp peer) {ctl:.3e}, "
            f"{ctl_b:.3e}; launches {got}")
        if (rel > TP_BOUND or rel_b > BATCHED_BOUND or got != want
                or r["gather_calls"] != 1
                or r["all_reduce_calls"] != 3 * n_vis
                or not torch.equal(r["y"], res[0]["y"])):
            bad.append(f"rank {rank}: rel_l2 {rel:.3e}, launches {got}, "
                       f"{r['gather_calls']} gathers, "
                       f"{r['all_reduce_calls']} all-reduces, or unlike "
                       "rank 0")
        if ctl <= TP_BOUND or ctl_b <= BATCHED_BOUND:
            bad.append(f"rank {rank}: the wrong-peer control passes")
    if bad:
        raise Failure("dp x tp: " + "; ".join(bad))
    return {"dp-tp-forward": _summed(r["launches"] for r in res)}, [line]


# ---------------------------------------------------------------------------
# phase 5c: the sequence axis, 8 ranks on the (1, 2, 4) mesh sharing the card
# ---------------------------------------------------------------------------

# the mesh JAX's get_T2V_pipeline(tp=8) plans for 28 heads: (dp, sp, tp)
SP_PLAN = (1, 2, 4)
# the 10 s NABLA forward's and the controls' depth: (text, visual) blocks
SP_BLOCKS = (2, 4)
# the 5 s forward's visual blocks (of 32; its 2 text blocks whole): cut to
# 16 to pay for phase 5e, the first cut of PERF.md section 7's order
SP_FORWARD_BLOCKS = 16
# the image request's steps (cut from the config's 16 to 4 to pay for
# phase 5d, and to 2 for phase 5e)
SP_IMAGE_STEPS = 2
# the controls a sound sp forward must not resemble (TP_BOUND): ranks that
# attend only to their own shard's keys; every rank taking the first rows
# of the RoPE tables; on NABLA every rank taking the first rows of STA
SP_CONTROLS = ("no_kv_gather", "rope_from_0")
SP_REFS = "sp_references.pt"
# the cut model's visual self-attention: with the seeded +-0.02 weights a
# score is ~0.003, attention is near uniform over 47,616 keys, and which of
# them a rank sees, or where RoPE puts them, hardly moves the output. Its
# QK-norm weights at SP_QK_NORM spread the logits (standard deviation near
# 4: the NABLA mask keeps a part of each row), and its out layer scaled by
# SP_ATTN_GAIN makes it carry the residual stream, so that a control's
# fault reaches the output
SP_QK_NORM = 2.0
SP_ATTN_GAIN = 8.0
# the STA control's top-CDF mass: none (1 - P > 1), so that the mask is
# STA alone. At the 10 s configs' P of 0.9 the top-CDF blocks hold 90 % of
# each row's pooled mass and the STA-only ones so little that STA rows from
# 0 moved the output by 5.0e-3 against a sound 4.2e-3; at P 0.3 the sound
# run itself read 2.9e-2, each mask block kept or dropped unlike one
# device's (1,500 of 30 M, from q and k rounded apart) carrying a part of
# the 70 % (H100 80GB HBM3, 700 W)
SP_STA_ONLY_P = -1.0


def _peaked(model):
    """``model`` with its visual self-attention peaked and loud (SP_QK_NORM,
    SP_ATTN_GAIN; on every rank alike: the norms are replicated and the
    out layer's rows scale with its columns)."""
    import torch

    with torch.no_grad():
        for blk in model.visual_transformer_blocks:
            att = blk.self_attention
            att.query_norm.weight.fill_(SP_QK_NORM)
            att.key_norm.weight.fill_(SP_QK_NORM)
            att.out_layer.weight.mul_(SP_ATTN_GAIN)
            att.out_layer.bias.mul_(SP_ATTN_GAIN)
    return model


def _sp_patches():
    """The controls' patches of ``models/dit.py`` (module, name, function)."""
    from kandinsky5_tpu_torch.models import dit as dit_mod

    rope_rows, sta_rows = dit_mod.rope_rows, dit_mod.sta_rows
    return {
        "no_kv_gather": (dit_mod, "gather_kv", lambda k, v, sp: (k, v)),
        "rope_from_0": (dit_mod, "rope_rows",
                        lambda rope, r0, r1: rope_rows(rope, 0, r1 - r0)),
        "sta_from_0": (dit_mod, "sta_rows",
                       lambda sta, r0, r1: sta_rows(sta, 0, r1 - r0)),
    }


def _sp_sparse(conf10, x, device, P=None):
    """The 10 s config's NABLA parameters (STA mask, P) for the token grid
    of latents ``x``; ``P`` in place of the config's."""
    from kandinsky5_tpu_torch.sampling import (
        DenoiseSpec,
        _build_sparse,
        token_grid,
    )

    att = conf10.model.attention
    spec = DenoiseSpec(
        dit_params=conf10.model.dit_params, num_steps=1, guidance_weight=1.0,
        scheduler_scale=5.0, scale_factor=tuple(conf10.metrics.scale_factor),
        attention_type="nabla", nabla_P=att.P if P is None else P,
        nabla_wT=att.wT,
        nabla_wH=att.wH, nabla_wW=att.wW)
    return _build_sparse(spec, token_grid(spec.dit_params, x.shape), device)


@contextlib.contextmanager
def _masks_kept(into: list):
    """Keep each NABLA mask built inside the block (on the CPU)."""
    from unittest import mock

    from kandinsky5_tpu_torch.ops import nabla as nabla_mod

    real = nabla_mod.nabla_build_mask

    def keeping(*a, **kw):
        m = real(*a, **kw)
        into.append(m.mask.cpu())
        return m

    with mock.patch.object(nabla_mod, "nabla_build_mask", keeping):
        yield


def _sp_part(mesh, cfg_kw, cut_kw, conf10_path, seed, refs, out_dir):
    """One rank's phase 5c (see :func:`phase_sp`)."""
    import contextlib as ctx
    import hashlib
    from unittest import mock

    import numpy as np
    import torch

    from kandinsky5_tpu_torch.config import CONFIG_DIR, DiTParams, load_config
    from kandinsky5_tpu_torch.models.dit import dit_forward
    from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE, init_vae_params
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.ops.nabla import record_density
    from kandinsky5_tpu_torch.parallel.sharding import fast_init_dit_shard
    from kandinsky5_tpu_torch.pipeline import Kandinsky5T2VPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tp, sp, dev = mesh.tp, mesh.sp, mesh.device
    patches = _sp_patches()
    out = {}

    def run(model, args, patch=None, **kw):
        with ctx.ExitStack() as stack:
            if patch is not None:
                stack.enter_context(mock.patch.object(*patches[patch]))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tp.reset_stats()
            sp.reset_stats()
            _kernels.reset_launches()
            t = time.perf_counter()
            y = dit_forward(model, *args, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        y = y.float().cpu()
        return y, dict(
            wall_s=wall, all_reduce_s=tp.seconds, all_reduce_calls=tp.calls,
            all_reduce_bytes=tp.bytes, gather_s=sp.seconds,
            gather_calls=sp.calls, gather_bytes=sp.bytes,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            launches=dict(_kernels.LAUNCHES))

    def held(y, ref):
        return dict(rel_l2=_rel(y, ref),
                    max_abs=(y - ref.float()).abs().max().item(),
                    digest=hashlib.sha1(y.numpy().tobytes()).hexdigest(),
                    finite=bool(torch.isfinite(y).all()))

    # 1. the full-depth forward at the 5 s shape
    cfg = DiTParams(**cfg_kw)
    t = time.perf_counter()
    model = fast_init_dit_shard(cfg, mesh, seed=seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    y, st = run(model, tp_inputs(cfg, dev, seed),
                scale_factor=(1.0, 2.0, 2.0))
    out["forward"] = dict(st, build_s=build_s, **held(y, refs["forward"]),
                          params=sum(p.numel() for p in model.parameters()))
    del model, y
    torch.cuda.empty_cache()

    # 2. the cut model: the 10 s NABLA forward, then the dense controls
    cut = DiTParams(**cut_kw)
    conf10 = load_config(conf10_path)
    model = _peaked(fast_init_dit_shard(cut, mesh, seed=seed))
    nargs = tp_inputs(cut, dev, seed, frames=61, tiles=True)
    sparse = _sp_sparse(conf10, nargs[0], dev)
    sf = tuple(conf10.metrics.scale_factor)
    masks = []
    with _masks_kept(masks), record_density() as kept:
        y, st = run(model, nargs, scale_factor=sf, sparse=sparse)
    _, nh, nr, _ = masks[0].shape
    rows = slice(sp.rank * nr, (sp.rank + 1) * nr)
    heads = slice(tp.rank * nh, (tp.rank + 1) * nh)
    differ = sum(int((m != refs["masks"][i][:, heads, rows]).sum())
                 for i, m in enumerate(masks))
    out["nabla"] = dict(st, **held(y, refs["nabla"]), masks=len(masks),
                        mask_blocks=sum(m.numel() for m in masks),
                        mask_differ=differ, density=_density(kept))
    del masks
    sta = _sp_sparse(conf10, nargs[0], dev, SP_STA_ONLY_P)
    y, st = run(model, nargs, scale_factor=sf, sparse=sta)
    out["sta"] = dict(st, **held(y, refs["sta"]))
    y, _ = run(model, nargs, "sta_from_0", scale_factor=sf, sparse=sta)
    out["sta_from_0"] = _rel(y, refs["sta"])
    dargs = tp_inputs(cut, dev, seed)
    y, st = run(model, dargs, scale_factor=(1.0, 2.0, 2.0))
    out["cut"] = dict(st, **held(y, refs["cut"]))
    for name in SP_CONTROLS:
        y, _ = run(model, dargs, name, scale_factor=(1.0, 2.0, 2.0))
        out[name] = _rel(y, refs["cut"])
    del model, y, nargs, dargs
    torch.cuda.empty_cache()

    # 3. the pipeline answers phase 4's image request
    conf = load_config(os.path.join(CONFIG_DIR, CONF5))
    dit = fast_init_dit_shard(conf.model.dit_params, mesh, seed=0)
    vae = HunyuanVideoVAE(init_vae_params(device=dev, dtype=torch.bfloat16,
                                          seed=1))
    pipe = Kandinsky5T2VPipeline(dit, conf, ReplayEmbedder(
        os.path.join(out_dir, TEXT_FILE)), vae, tp=mesh)
    kept_latents = _keep_latents(pipe, "sp")
    name, prompt, tl, shape, _, expand = IMAGE_REQUEST
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    frames = pipe(prompt, time_length=tl, width=shape[3], height=shape[2],
                  seed=42, num_steps=SP_IMAGE_STEPS, expand_prompts=expand,
                  save_path=os.path.join(out_dir, "sp_image.png"))
    wall = time.perf_counter() - t
    tm = dict(pipe.timings)
    line = dict(request="sp image", rank=mesh.rank, wall_s=wall,
                s_per_step=tm["denoise_s"] / tm["steps"],
                denoise_s=tm["denoise_s"], steps=tm["steps"],
                all_reduce_s=tm["all_reduce_s"],
                all_reduce_calls=tm["all_reduce_calls"],
                gather_s=tm["sp_gather_s"], gather_calls=tm["sp_gather_calls"],
                gather_bytes=tm["sp_gather_bytes"],
                decoded_tiles=tm["decoded_tiles"],
                latents_finite=tm["latents_finite"])
    out["launches"] = dict(_kernels.LAUNCHES)
    if mesh.rank == 0:
        line.update(decode_s=tm["decode_s"], frames=list(frames.shape),
                    frames_ok=bool(frames.shape == shape
                                   and frames.dtype == np.uint8
                                   and float(frames.std()) > 0.0))
        out.update(_single_decodes(pipe, [(name, kept_latents["sp"],
                                           frames)]))
    elif frames is not None:
        raise Failure(f"rank {mesh.rank} returned frames")
    out["request"] = line
    return out


def _sp_rank(mesh, cfg_kw, cut_kw, conf10_path, seed, refs_path, out_dir,
             parts=("5c", "5d")):
    """One rank of the (1, 2, 4) launch: phase 5c's part, then 5d's
    (:func:`_int8_mesh_part`), those of ``parts``."""
    import torch

    refs = torch.load(refs_path, mmap=True)
    out = {}
    if "5c" in parts:
        out.update(_sp_part(mesh, cfg_kw, cut_kw, conf10_path, seed, refs,
                            out_dir))
    if "5d" in parts:
        torch.cuda.empty_cache()
        out["5d"] = _int8_mesh_part(mesh, refs, out_dir)
    return out


# phase 5d: the int8 options on the (1, 2, 4) mesh, in 5c's launch.
# The int8 forward's (text, visual) blocks: each of its 12 row-parallel
# products all-reduces 23,808 x 1,792 int32 (171 MB, twice bf16's bytes)
# over gloo, so it is cut from (2, 32)
INT8_BLOCKS = (2, 4)
# the W8A8 linears' rows (a rank's tokens) and widths (model, FF)
I8_ROWS, I8_D, I8_FF = 23808, 1792, 7168
I8_SEED = 9
# the sharded Qwen's layers (of 28) and seed: phase 3's tower
QWEN_LAYERS, QWEN_SEED = 2, 21
QWEN_GREEDY, QWEN_INT8_TOKENS = 8, 4
QWEN_REF = "qwen_reference.pt"
I8_IMAGE = "int8_image.png"
# the int8 image request's steps, on the mesh and on one device: cut from
# the config's 16 to pay for phase 5e (at 16 the mesh request took 73.0-81.1
# s, H100 80GB HBM3, 700 W)
I8_IMAGE_STEPS = 4


def qwen_greedy(model, ids, n: int):
    """``n`` greedy tokens of ``model`` on the prompt ``ids`` (no EOS ends
    them) and the fp32 logits each was picked from (the first: the
    prefill's), on the CPU."""
    from unittest import mock

    from kandinsky5_tpu_torch.text import qwen as qwen_mod

    seen = []
    real = qwen_mod._pick_token

    def pick(logits, *a, **kw):
        seen.append(logits.float().cpu())
        return real(logits, *a, **kw)

    with mock.patch.object(qwen_mod, "_pick_token", pick):
        tokens = qwen_mod.qwen_generate(model, ids, max_new_tokens=n,
                                        eos_token_ids=())
    return [int(t) for t in tokens], seen


def _margins(seen) -> list:
    """Each step's top-2 logit margin."""
    out = []
    for logits in seen:
        top = logits.reshape(-1).topk(2).values
        out.append(float(top[0] - top[1]))
    return out


def qwen_reference(emb, path: str) -> dict:
    """The one-device run phase 5d holds the sharded Qwen against (phase 3's
    2-layer tower in bf16 on the card, ``emb.qwen``), saved to ``path``:
    the video template's prompt ids, its hidden states, QWEN_GREEDY greedy
    tokens with the logits' top-2 margin at each (the first logits are the
    prefill's), and the same for QWEN_INT8_TOKENS tokens of the int8 decode
    tree."""
    import torch

    from kandinsky5_tpu_torch.text.qwen import (
        quantize_qwen_decode_params,
        qwen_hidden_states,
    )

    prompt = "a smoke-test video of a red fox running through snow"
    ids, mask, crop = emb._qwen_tokenize([prompt], "video")
    ids, mask = torch.as_tensor(ids), torch.as_tensor(mask)
    n = int(mask.sum())
    hidden = qwen_hidden_states(emb.qwen, ids, mask).float().cpu()
    greedy, seen = qwen_greedy(emb.qwen, ids[:, :n], QWEN_GREEDY)
    int8, seen8 = qwen_greedy(quantize_qwen_decode_params(emb.qwen),
                              ids[:, :n], QWEN_INT8_TOKENS)
    ref = dict(ids=ids, mask=mask, crop=crop, n=n, hidden=hidden,
               logits=seen[0], greedy=greedy, margins=_margins(seen),
               logits8=seen8[0], int8=int8, margins8=_margins(seen8))
    torch.save(ref, path)
    log(f"  Qwen reference for phase 5d: {QWEN_GREEDY} greedy tokens, top-2 "
        f"margins {[round(m, 4) for m in ref['margins']]}; int8 tree "
        f"{[round(m, 4) for m in ref['margins8']]}")
    return ref


def _tokens_agree(got, want, margins, err) -> dict:
    """Greedy tokens ``got`` against one device's ``want``, up to the first
    step whose top-2 logit margin (one device's) is below ``err``, the
    logit error measured at the prefill: there either token may win."""
    first = next((i for i, m in enumerate(margins) if m < err), len(want))
    return dict(equal_to=first, ok=list(got[:first]) == list(want[:first]),
                all_equal=list(got) == list(want))


def _int8_mesh_part(mesh, refs, out_dir):
    """One rank's phase 5d (see :func:`phase_sp`): the W8A8 linears, the int8
    forward, the int8 image request and the sharded Qwen, each part's
    seconds, all-reduces (bytes by dtype), gathers and peak memory."""
    import dataclasses
    import hashlib

    import numpy as np
    import torch

    from kandinsky5_tpu_torch.config import CONFIG_DIR, DiTParams, load_config
    from kandinsky5_tpu_torch.models import nn as port_nn
    from kandinsky5_tpu_torch.models.dit import dit_forward
    from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE, init_vae_params
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.parallel.sharding import fast_init_dit_shard
    from kandinsky5_tpu_torch.pipeline import Kandinsky5T2VPipeline
    from kandinsky5_tpu_torch.text.qwen import (
        QwenTextConfig,
        init_qwen_shard_random,
        quantize_qwen_decode_params,
        qwen_hidden_states,
    )
    from kandinsky5_tpu_torch.utils.metrics import psnr
    from tests import _torch_int8_mesh_ranks as i8
    from tests import _torch_qwen_tp_ranks as qtp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tp, sp, dev = mesh.tp, mesh.sp, mesh.device
    groups = (tp, sp, mesh.shard)
    out = {}

    def start():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for grp in groups:
            grp.reset_stats()
        _kernels.reset_launches()
        return time.perf_counter()

    def stats(t0, group=tp):
        torch.cuda.synchronize()
        return dict(seconds=time.perf_counter() - t0,
                    all_reduce_s=group.seconds, all_reduce_calls=group.calls,
                    all_reduce_bytes=dict(group.dtype_bytes),
                    gather_s=sp.seconds, gather_bytes=sp.bytes,
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                    launches=dict(_kernels.LAUNCHES))

    # 1. W8A8 linears at a rank's shapes against one device's _linear_i8
    t = start()
    g = torch.Generator(device=dev).manual_seed(I8_SEED)

    def draw(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).bfloat16()

    with torch.no_grad():
        x, w, b = draw(I8_ROWS, I8_FF), draw(I8_D, I8_FF, scale=0.02), \
            draw(I8_D, scale=0.1)
        one = port_nn.linear(port_nn.quantize_linear(
            i8._linear(w, b, torch.bfloat16)), x)
        row = {str(f): bool(torch.equal(i8.row_parallel_i8(w, b, x, tp, f),
                                        one)) for f in (None,) + i8.FAULTS}
        x, w, b = draw(I8_ROWS, I8_D), draw(I8_FF, I8_D, scale=0.02), \
            draw(I8_FF, scale=0.1)
        one = port_nn.linear(port_nn.quantize_linear(
            i8._linear(w, b, torch.bfloat16)), x)
        n = I8_FF // tp.size
        col = bool(torch.equal(i8.column_parallel_i8(w, b, x, tp),
                               one[:, tp.rank * n:(tp.rank + 1) * n]))
    del x, w, b, one
    out["linears"] = dict(stats(t), row=row, col=col)
    torch.cuda.empty_cache()

    # 2. the int8 forward (flash_int8 + W8A8), full width, INT8_BLOCKS deep
    cut = DiTParams(**refs["int8_cfg"])
    t = time.perf_counter()
    model = fast_init_dit_shard(cut, mesh, seed=TP_SEED, int8_linear=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    args = tp_inputs(cut, dev, TP_SEED)
    t = start()
    y = dit_forward(model, *args, scale_factor=(1.0, 2.0, 2.0),
                    attn_impl="flash_int8")
    st = stats(t)
    y = y.float().cpu()
    ref = refs["int8"].float()
    out["forward"] = dict(
        st, build_s=build_s, rel_l2=_rel(y, ref), bound=refs["int8_bound"],
        max_abs=(y - ref).abs().max().item(),
        digest=hashlib.sha1(y.numpy().tobytes()).hexdigest(),
        finite=bool(torch.isfinite(y).all()))
    del model, y, args
    torch.cuda.empty_cache()

    # 3. the int8 image request through the pipeline's int8 options
    conf = load_config(os.path.join(CONFIG_DIR, CONF5))
    dit = fast_init_dit_shard(conf.model.dit_params, mesh, seed=0)
    vae = HunyuanVideoVAE(init_vae_params(device=dev, dtype=torch.bfloat16,
                                          seed=1))
    pipe = Kandinsky5T2VPipeline(dit, conf, ReplayEmbedder(
        os.path.join(out_dir, TEXT_FILE)), vae, tp=mesh,
        attn_impl="flash_int8", int8_linear=True)
    del dit
    kept = _keep_latents(pipe, "int8")
    name, prompt, tl, shape, _, expand = IMAGE_REQUEST
    t = start()
    frames = pipe(prompt, time_length=tl, width=shape[3], height=shape[2],
                  seed=42, num_steps=I8_IMAGE_STEPS, expand_prompts=expand)
    st = stats(t)
    tm = dict(pipe.timings)
    line = dict(st, s_per_step=tm["denoise_s"] / tm["steps"],
                steps=tm["steps"], decoded_tiles=tm["decoded_tiles"],
                latents_finite=tm["latents_finite"], quantized=pipe.int8_linear)
    if mesh.rank == 0:
        line.update(frames_ok=bool(frames.shape == shape
                                   and frames.dtype == np.uint8
                                   and float(frames.std()) > 0.0))
        single = os.path.join(out_dir, I8_IMAGE)
        if os.path.isfile(single):
            from PIL import Image

            want = np.asarray(Image.open(single).convert("RGB"))[None, None]
            line["psnr_vs_single_db"] = psnr(frames, want)
        out.update(_single_decodes(pipe, [("int8 image", kept["int8"],
                                           frames)]))
    elif frames is not None:
        raise Failure(f"rank {mesh.rank} returned frames")
    out["image"] = line
    del pipe, vae, kept
    torch.cuda.empty_cache()

    # 4. the sharded Qwen: 2 layers at full width, 1/8 a rank
    qref = torch.load(os.path.join(out_dir, QWEN_REF))
    qcfg = dataclasses.replace(QwenTextConfig(),
                               num_hidden_layers=QWEN_LAYERS)
    t = start()
    local = init_qwen_shard_random(qcfg, mesh.shard, dtype=torch.bfloat16,
                                   seed=QWEN_SEED)
    ids, mask, crop, n = (qref[k] for k in ("ids", "mask", "crop", "n"))
    valid = mask[:, crop:].bool()

    def hidden_rel(model):
        h = qwen_hidden_states(model, ids, mask).float().cpu()
        return _rel(h[:, crop:][valid], qref["hidden"][:, crop:][valid])

    e_h = hidden_rel(local)
    greedy, seen = qwen_greedy(local, ids[:, :n], QWEN_GREEDY)
    err = (seen[0] - qref["logits"]).abs().max().item()
    local8 = quantize_qwen_decode_params(local)
    int8, seen8 = qwen_greedy(local8, ids[:, :n], QWEN_INT8_TOKENS)
    err8 = (seen8[0] - qref["logits8"]).abs().max().item()
    with qtp.without_o_proj_sum(local):
        c_h = hidden_rel(local)
    out["qwen"] = dict(
        stats(t, mesh.shard), hidden_rel_l2=e_h,
        logits_rel_l2=_rel(seen[0], qref["logits"]), logits_max_abs=err,
        greedy=_tokens_agree(greedy, qref["greedy"], qref["margins"], err),
        int8_logits_rel_l2=_rel(seen8[0], qref["logits8"]),
        int8=_tokens_agree(int8, qref["int8"], qref["margins8"], err8),
        control_no_o_proj_sum_rel_l2=c_h,
        weight_bytes=sum(v.numel() * v.element_size()
                         for v in local.state_dict().values()))
    del local, local8
    torch.cuda.empty_cache()
    return out


def phase_sp(dev, conf5, conf10, out_dir: str, parts=("5c", "5d")):
    """Phases 5c and 5d (those of ``parts``) in one launch. Phase 5c: 8
    ranks on the (1, 2, 4) mesh sharing the card over gloo,
    the kernels built before any rank starts. (1) One DiT forward at full
    width at the 5 s shape, SP_FORWARD_BLOCKS visual blocks deep (TP_SEED's
    weights and inputs), every rank within TP_BOUND of one device's at that
    depth, exact launches per rank (K1 2 + SP_FORWARD_BLOCKS, K8
    SP_FORWARD_BLOCKS, K2 0). (2) The
    10 s NABLA forward (93,696 tokens, a latent constant over each NABLA
    block plus noise, full width, SP_BLOCKS deep) within
    TP_BOUND of one device's at that depth, K6 4 launches a rank, the mask
    blocks whose keep or drop differs from one device's counted; the dense
    5 s forward at that depth and the controls (SP_CONTROLS, and on NABLA
    STA rows from 0, on the mask of STA alone, SP_STA_ONLY_P, whose sound
    run is held to TP_BOUND too), each of which must fail TP_BOUND; the cut
    model's attention is peaked and loud (SP_QK_NORM, SP_ATTN_GAIN) so that
    the controls can show. (3) The pipeline
    answers phase 4's image request (SP_IMAGE_STEPS steps) on the replayed
    text: rank 0's frames against the single-process tiled decode of its
    latents (FRAME_LEVELS, FRAME_SHARE), the decode's launches summed over
    the ranks equal to it, exact K1/K8 launches per rank.
    Phase 5d (:func:`phase_int8_mesh` checks it) on the same ranks.
    Times are of 8 ranks time-sharing one card, never a multi-GPU
    figure."""
    import dataclasses

    import torch

    from kandinsky5_tpu_torch.config import CONFIG_DIR
    from kandinsky5_tpu_torch.models.dit import dit_forward, fast_init_dit_params
    from kandinsky5_tpu_torch.parallel import launch

    n_text = conf5.model.dit_params.num_text_blocks
    n_vis = conf5.model.dit_params.num_visual_blocks
    cfg = dataclasses.replace(conf5.model.dit_params,
                              num_visual_blocks=SP_FORWARD_BLOCKS)
    cut = dataclasses.replace(conf10.model.dit_params,
                              num_text_blocks=SP_BLOCKS[0],
                              num_visual_blocks=SP_BLOCKS[1])
    t = time.perf_counter()
    refs = {}
    if "5c" in parts:
        ref = single_forward(cfg, dev, tp_inputs(cfg, dev, TP_SEED),
                             TP_SEED, scale_factor=(1.0, 2.0, 2.0))[0]
        dit = _peaked(fast_init_dit_params(cut, device=dev, seed=TP_SEED))
        masks = []
        nargs = tp_inputs(cut, dev, TP_SEED, frames=61, tiles=True)
        sf = tuple(conf10.metrics.scale_factor)
        with _masks_kept(masks):
            nabla = dit_forward(dit, *nargs, scale_factor=sf,
                                sparse=_sp_sparse(conf10, nargs[0], dev))
        sta = dit_forward(dit, *nargs, scale_factor=sf, sparse=_sp_sparse(
            conf10, nargs[0], dev, SP_STA_ONLY_P))
        dense = dit_forward(dit, *tp_inputs(cut, dev, TP_SEED),
                            scale_factor=(1.0, 2.0, 2.0))
        refs.update({"forward": ref, "nabla": nabla.float().cpu(),
                     "sta": sta.float().cpu(), "cut": dense.float().cpu(),
                     "masks": masks})
        del dit, nabla, sta, dense, masks, nargs
    if "5d" in parts:
        refs.update(int8_mesh_references(dev, conf5, out_dir))
    refs_path = os.path.join(out_dir, SP_REFS)
    torch.save(refs, refs_path)
    del refs
    torch.cuda.empty_cache()
    log(f"  one device: the references (cut forwards, masks, 5d) in "
        f"{time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    world = math.prod(SP_PLAN)
    res = launch(_sp_rank, world, "gloo", "cuda",
                 args=(dataclasses.asdict(cfg), dataclasses.asdict(cut),
                       os.path.join(CONFIG_DIR, CONF10), TP_SEED, refs_path,
                       out_dir, parts),
                 timeout=1000, dp=SP_PLAN[0], sp=SP_PLAN[1])
    total = time.perf_counter() - t
    os.remove(refs_path)
    log(f"  8 ranks: {total:.1f} s from launch to the last result")
    bad, report, launches = [], [], {}
    if "5d" in parts:
        d_launches, d_report, d_bad = phase_int8_mesh(
            [r["5d"] for r in res], total, n_text + n_vis)
        launches.update(d_launches)
        report += d_report
        bad += d_bad
    if "5c" not in parts:
        if bad:
            raise Failure("phase 5d: " + "; ".join(bad))
        return launches, report
    want = {"forward": {"K1_flash_fixed": n_text + SP_FORWARD_BLOCKS,
                        "K8_ff": SP_FORWARD_BLOCKS, "K2_ff_mod": 0},
            "nabla": {"K6_sparse_nabla": SP_BLOCKS[1],
                      "K1_flash_fixed": SP_BLOCKS[0], "K8_ff": SP_BLOCKS[1],
                      "K2_ff_mod": 0},
            "sta": {"K6_sparse_nabla": SP_BLOCKS[1],
                    "K1_flash_fixed": SP_BLOCKS[0], "K8_ff": SP_BLOCKS[1],
                    "K2_ff_mod": 0},
            "cut": {"K1_flash_fixed": sum(SP_BLOCKS), "K8_ff": SP_BLOCKS[1],
                    "K2_ff_mod": 0}}
    for run, what in (("forward", f"5 s forward, {SP_FORWARD_BLOCKS} visual "
                       "blocks"),
                      ("nabla", f"10 s NABLA forward, {SP_BLOCKS[1]} "
                       "visual blocks"),
                      ("sta", f"10 s NABLA forward, STA alone, "
                       f"{SP_BLOCKS[1]} visual blocks"),
                      ("cut", f"5 s forward, {SP_BLOCKS[1]} visual "
                       "blocks")):
        line = dict(request=f"sp {run}", launch_s=total)
        for rank, r in enumerate(res):
            s = r[run]
            wrong = {k: (s["launches"][k], n) for k, n in want[run].items()
                     if s["launches"][k] != n}
            extra = ""
            if run == "forward":
                extra = (f", build {s['build_s']:.1f} s, {s['params']} "
                         "params")
            if run == "nabla":
                extra = (f", masks {s['masks']}: {s['mask_differ']} of "
                         f"{s['mask_blocks']} blocks kept or dropped unlike "
                         f"one device's, kept {s['density']:.4f}")
            log(f"  {what} rank {rank}: {s['wall_s']:.3f} s, tp all-reduce "
                f"{s['all_reduce_s']:.3f} s in {s['all_reduce_calls']} calls "
                f"({s['all_reduce_bytes'] / 2**30:.2f} GiB), sp gather "
                f"{s['gather_s']:.3f} s in {s['gather_calls']} calls "
                f"({s['gather_bytes'] / 2**30:.2f} GiB), peak "
                f"{s['peak_gib']:.2f} GiB{extra}; against one device: rel_l2 "
                f"{s['rel_l2']:.3e} max_abs {s['max_abs']:.3e} (bound "
                f"{TP_BOUND}); launches "
                + " ".join(f"{k.split('_')[0]} {s['launches'][k]}"
                           for k in want[run]))
            for key in ("wall_s", "all_reduce_s", "gather_s",
                        "gather_bytes", "peak_gib", "rel_l2"):
                line.setdefault(key, []).append(s[key])
            if run == "nabla":
                line.setdefault("mask_differ", []).append(s["mask_differ"])
            if (wrong or s["rel_l2"] > TP_BOUND or not s["finite"]
                    or s["digest"] != res[0][run]["digest"]):
                bad.append(f"{run} rank {rank}: rel_l2 {s['rel_l2']:.3e}, "
                           f"launches (got, want) {wrong}, or unlike rank 0")
        report.append(line)
        launches[f"sp-{run}"] = {k: sum(r[run]["launches"][k] for r in res)
                                 for k in res[0][run]["launches"]}
    for name in SP_CONTROLS + ("sta_from_0",):
        rel = res[0][name]
        fails = rel > TP_BOUND
        report[-1][f"{name}_rel_l2"] = rel
        log(f"  control ({name}): rel_l2 {rel:.3e} "
            f"{'fails the bound' if fails else 'PASSES'}")
        if not fails:
            bad.append(f"control {name} passes the bound")

    steps = SP_IMAGE_STEPS
    pwant = {"K8_ff": n_vis * steps, "K1_flash_fixed": (n_text + n_vis) * steps,
             "K2_ff_mod": 0}
    for name, m in res[0]["frames"].items():
        log(f"  {name}: rank 0's frames against the single-process tiled "
            f"decode of its latents: {m['max_levels']} levels at most, on "
            f"{m['share']:.2e} of the values")
    bad += _decode_split_faults(res, res[0]["single_launches"],
                                every_rank=False)
    for rank, r in enumerate(res):
        got = r["launches"]
        wrong = {k: (got[k], n) for k, n in pwant.items() if got[k] != n}
        if wrong:
            bad.append(f"sp image rank {rank}: launches (got, want) {wrong}")
        line = r["request"]
        log(f"  sp image rank {rank}: {line['s_per_step']:.4f} s/step "
            f"({line['steps']} steps), tp all-reduce {line['all_reduce_s']:.3f}"
            f" s in {line['all_reduce_calls']} calls, sp gather "
            f"{line['gather_s']:.3f} s in {line['gather_calls']} calls; "
            f"decoded {line['decoded_tiles']} tiles"
            + (f"; decode (tiled, split) {line['decode_s']:.3f} s, frames "
               f"{line['frames']}" if rank == 0 else ""))
        if not line["latents_finite"] or (rank == 0 and not line["frames_ok"]):
            bad.append(f"sp image rank {rank}: bad output")
        report.append(line)
    launches["sp-image"] = {k: sum(r["launches"][k] for r in res)
                            for k in res[0]["launches"]}
    if bad:
        raise Failure("phases 5c-5d: " + "; ".join(bad))
    return launches, report


def int8_mesh_references(dev, conf5, out_dir) -> dict:
    """Phase 5d's one-device side, made in the parent before the ranks
    start: the int8 forward (flash_int8 + W8A8, the whole model quantized)
    at INT8_BLOCKS on TP_SEED's weights and inputs and its bound, its own
    rel_l2 against the bf16 forward of the same model (the mesh's per-shard
    quantization differs from one device's at int8 resolution, not more);
    and the int8 image request on one device (I8_IMAGE, for the PSNR
    printed beside the ranks')."""
    import dataclasses

    import torch

    from kandinsky5_tpu_torch.models.dit import (
        dit_forward,
        fast_init_dit_params,
        quantize_dit_params,
    )
    from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE, init_vae_params
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.pipeline import Kandinsky5T2VPipeline

    cut = dataclasses.replace(conf5.model.dit_params,
                              num_text_blocks=INT8_BLOCKS[0],
                              num_visual_blocks=INT8_BLOCKS[1])
    dit = fast_init_dit_params(cut, device=dev, seed=TP_SEED)
    args = tp_inputs(cut, dev, TP_SEED)
    plain = dit_forward(dit, *args, scale_factor=(1.0, 2.0, 2.0)).float()
    _kernels.reset_launches()
    int8 = dit_forward(quantize_dit_params(dit), *args,
                       scale_factor=(1.0, 2.0, 2.0),
                       attn_impl="flash_int8").float()
    launches = dict(_kernels.LAUNCHES)
    bound = _rel(int8.cpu(), plain.cpu())
    log(f"  5d one device: the int8 forward ({INT8_BLOCKS[0]} text, "
        f"{INT8_BLOCKS[1]} visual blocks) against its bf16 forward: rel_l2 "
        f"{bound:.3e}, the ranks' bound; K5 {launches['K5_flash_int8']}")
    del dit, args, plain
    dit = fast_init_dit_params(conf5.model.dit_params, device=dev, seed=0)
    vae = HunyuanVideoVAE(init_vae_params(device=dev, dtype=torch.bfloat16,
                                          seed=1))
    pipe = Kandinsky5T2VPipeline(dit, conf5, ReplayEmbedder(
        os.path.join(out_dir, TEXT_FILE)), vae, attn_impl="flash_int8",
        int8_linear=True, decode_mode="tiled")
    _, prompt, tl, shape, _, expand = IMAGE_REQUEST
    pipe(prompt, time_length=tl, width=shape[3], height=shape[2], seed=42,
         num_steps=I8_IMAGE_STEPS, expand_prompts=expand,
         save_path=os.path.join(out_dir, I8_IMAGE))
    del pipe, dit, vae
    torch.cuda.empty_cache()
    return {"int8": int8.cpu(), "int8_bound": bound,
            "int8_cfg": dataclasses.asdict(cut)}


def phase_int8_mesh(res, total: float, blocks: int):
    """Phase 5d's readings from the 8 ranks' results ``res``: (1) a
    row-parallel (7,168 -> 1,792) and a column-parallel (1,792 -> 7,168)
    W8A8 linear at a rank's 23,808 rows bit-equal to one device's
    ``_linear_i8``, each fault (a rank's own activation scale, a weight
    scale from the rank's slice, the bias on every rank) unequal; (2) the
    int8 forward (flash_int8 + W8A8, the rank-local quantization) at full
    width and 47,616 tokens, INT8_BLOCKS deep, within the one device's own
    int8 error of its int8 forward, K5 2 + 4 launches a rank, K1, K8, K2
    none; (3) the int8 image request through the pipeline (I8_IMAGE_STEPS),
    exact K5 ``blocks`` (34) x I8_IMAGE_STEPS launches a rank with K1, K2,
    K8 none, the decode's launches summed over the ranks equal to the
    single-process decode's,
    rank 0's frames against it; PSNR against one device's int8 image
    printed (random weights: not gated); (4) Qwen2.5-VL-7B at full width
    with QWEN_LAYERS layers, bf16, each rank holding its 1/8: the hidden
    states and prefill logits within TEXT_BOUND of phase 3's one-device
    card run, QWEN_GREEDY greedy tokens (QWEN_INT8_TOKENS on the int8
    decode tree) equal to one device's up to the first step whose top-2
    margin is below the measured logit error; control: o_proj's sum
    skipped must fail TEXT_BOUND. Returns (launches, report, faults)."""
    bad, report, launches = [], [], {}
    n_text, n_vis = INT8_BLOCKS
    for rank, r in enumerate(res):
        lin = r["linears"]
        log(f"  5d linears rank {rank}: row parallel bit-equal "
            f"{lin['row']['None']}, faults "
            + ", ".join(f"{f} {'unequal' if not lin['row'][f] else 'EQUAL'}"
                        for f in ("rank_sx", "slice_w_scale",
                                  "bias_on_every_rank"))
            + f"; column parallel bit-equal {lin['col']}; "
            f"{lin['seconds']:.2f} s, all-reduce {lin['all_reduce_bytes']}")
        if not (lin["row"]["None"] and lin["col"]) or any(
                lin["row"][f] for f in lin["row"] if f != "None"):
            bad.append(f"5d linears rank {rank}: {lin['row']} {lin['col']}")
    bound = None
    want = {"K5_flash_int8": n_text + n_vis, "K1_flash_fixed": 0,
            "K8_ff": 0, "K2_ff_mod": 0}
    for rank, r in enumerate(res):
        f = r["forward"]
        bound = f.get("bound", bound)
        wrong = {k: (f["launches"][k], n) for k, n in want.items()
                 if f["launches"][k] != n}
        log(f"  5d int8 forward rank {rank} ({n_vis} visual blocks): "
            f"{f['seconds']:.3f} s (build {f['build_s']:.1f} s), tp "
            f"all-reduce {f['all_reduce_s']:.3f} s in "
            f"{f['all_reduce_calls']} calls {f['all_reduce_bytes']}, sp "
            f"gather {f['gather_s']:.3f} s ({f['gather_bytes'] / 2**30:.2f}"
            f" GiB), peak {f['peak_gib']:.2f} GiB; against one device's int8 "
            f"forward: rel_l2 {f['rel_l2']:.3e} max_abs {f['max_abs']:.3e} "
            f"(bound {f['bound']:.3e}); launches "
            + " ".join(f"{k.split('_')[0]} {f['launches'][k]}" for k in want))
        if (wrong or f["rel_l2"] > f["bound"] or not f["finite"]
                or f["digest"] != res[0]["forward"]["digest"]):
            bad.append(f"5d forward rank {rank}: rel_l2 {f['rel_l2']:.3e}, "
                       f"launches (got, want) {wrong}, or unlike rank 0")
    report.append(dict(request="int8 forward", launch_s=total,
                       rel_l2=[r["forward"]["rel_l2"] for r in res],
                       bound=bound,
                       seconds=[r["forward"]["seconds"] for r in res],
                       all_reduce_bytes=res[0]["forward"]["all_reduce_bytes"]))
    launches["int8-forward"] = {k: sum(r["forward"]["launches"][k]
                                       for r in res)
                                for k in res[0]["forward"]["launches"]}

    steps = res[0]["image"]["steps"]
    want = {"K5_flash_int8": blocks * steps, "K1_flash_fixed": 0,
            "K8_ff": 0, "K2_ff_mod": 0}
    for name, m in res[0]["frames"].items():
        log(f"  {name}: rank 0's frames against the single-process tiled "
            f"decode of its latents: {m['max_levels']} levels at most, on "
            f"{m['share']:.2e} of the values")
    image = [r["image"] for r in res]
    bad += _decode_split_faults([dict(i, frames=res[0]["frames"])
                                 for i in image], res[0]["single_launches"],
                                every_rank=False)
    for rank, line in enumerate(image):
        got = line["launches"]
        wrong = {k: (got[k], n) for k, n in want.items() if got[k] != n}
        if wrong:
            bad.append(f"5d int8 image rank {rank}: launches (got, want) "
                       f"{wrong}")
        if not (line["latents_finite"] and line["quantized"]) or (
                rank == 0 and not line["frames_ok"]):
            bad.append(f"5d int8 image rank {rank}: bad output")
        log(f"  5d int8 image rank {rank}: {line['s_per_step']:.4f} s/step "
            f"({line['steps']} steps), {line['seconds']:.1f} s, tp "
            f"all-reduce {line['all_reduce_s']:.3f} s in "
            f"{line['all_reduce_calls']} calls {line['all_reduce_bytes']}, "
            f"sp gather {line['gather_s']:.3f} s, peak {line['peak_gib']:.2f}"
            f" GiB, decoded {line['decoded_tiles']} tiles; launches K5 "
            f"{got['K5_flash_int8']} K1 {got['K1_flash_fixed']}"
            + (f"; PSNR against one device's int8 image "
               f"{line.get('psnr_vs_single_db', float('nan')):.2f} dB "
               "(random weights: recorded, not gated)" if rank == 0 else ""))
    report.append(dict(request="int8 image", launch_s=total,
                       s_per_step=[i["s_per_step"] for i in image],
                       psnr_vs_single_db=image[0].get("psnr_vs_single_db")))
    launches["int8-image"] = {k: sum(i["launches"][k] for i in image)
                              for k in image[0]["launches"]}

    for rank, r in enumerate(res):
        q = r["qwen"]
        log(f"  5d sharded Qwen rank {rank}: {q['weight_bytes'] / 2**30:.3f} "
            f"GiB of weights, {q['seconds']:.2f} s, collectives over the 8 "
            f"ranks (sums and gathers) {q['all_reduce_s']:.3f} s in "
            f"{q['all_reduce_calls']} calls {q['all_reduce_bytes']}, peak "
            f"{q['peak_gib']:.2f} GiB; hidden "
            f"rel_l2 {q['hidden_rel_l2']:.3e}, prefill logits "
            f"{q['logits_rel_l2']:.3e} (max_abs {q['logits_max_abs']:.3e}; "
            f"tol {TEXT_BOUND:g}), int8 tree's logits "
            f"{q['int8_logits_rel_l2']:.3e}; greedy tokens equal to one "
            f"device's through step {q['greedy']['equal_to']} of "
            f"{QWEN_GREEDY} (all equal: {q['greedy']['all_equal']}), int8 "
            f"through {q['int8']['equal_to']} of {QWEN_INT8_TOKENS} (all "
            f"equal: {q['int8']['all_equal']}); control (o_proj's sum "
            f"skipped): hidden rel_l2 "
            f"{q['control_no_o_proj_sum_rel_l2']:.3e} (must fail)")
        if (max(q["hidden_rel_l2"], q["logits_rel_l2"],
                q["int8_logits_rel_l2"]) >= TEXT_BOUND
                or not (q["greedy"]["ok"] and q["int8"]["ok"])
                or q["control_no_o_proj_sum_rel_l2"] < TEXT_BOUND):
            bad.append(f"5d sharded Qwen rank {rank}: {q}")
    report.append(dict(request="sharded qwen",
                       hidden_rel_l2=[r["qwen"]["hidden_rel_l2"] for r in res],
                       weight_bytes=res[0]["qwen"]["weight_bytes"],
                       greedy_equal_to=res[0]["qwen"]["greedy"]["equal_to"]))
    seconds = {part: max(r[part]["seconds"] for r in res)
               for part in ("linears", "forward", "image", "qwen")}
    log(f"  5d seconds per part (the slowest rank): {seconds}")
    report[-1]["part_seconds"] = seconds
    return launches, report, bad


# ---------------------------------------------------------------------------
# phase 5e: serving on the mesh, 2 ranks on (1, 1, 2) sharing the card
# ---------------------------------------------------------------------------

# the mesh server's image requests (the config's 16 steps each): two
# unseeded ones within the batch window, a seeded one (resumed from the
# state the ranks left), one at an unsupported size, a later unseeded one
MESH_SERVE_PROMPTS = ("a mesh-served image", "another mesh-served image")
MESH_SERVE_SEEDED = ("a seeded mesh-served image", 7)
MESH_SERVE_LATER = "a later mesh-served image"
# the unseeded pair's and the later request's steps: they show batching and
# that the server goes on after an error, and are cut from the config's 16
# so that the smoke keeps its time
MESH_SERVE_PAIR_STEPS, MESH_SERVE_LATER_STEPS = 4, 4
# the seeded request made directly stops after this many chunks of 4 steps;
# the server resumes it at 4 x this step
MESH_RESUME_CHUNKS = 2


def _serve_mesh_rank(mesh, out_dir):
    """One rank of phase 5e (see :func:`phase_serve_mesh`)."""
    from unittest import mock

    import torch

    from kandinsky5_tpu_torch.config import CONFIG_DIR, load_config
    from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE, init_vae_params
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.parallel.sharding import fast_init_dit_shard
    from kandinsky5_tpu_torch.pipeline import (
        DEFAULT_NEGATIVE,
        SCHEDULER_SCALE,
        Kandinsky5T2VPipeline,
    )
    from kandinsky5_tpu_torch.serve import GenerationServer, Job, follow
    from kandinsky5_tpu_torch.utils import resume

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    conf = load_config(os.path.join(CONFIG_DIR, CONF5))
    t = time.perf_counter()
    dit = fast_init_dit_shard(conf.model.dit_params, mesh, seed=0)
    vae = HunyuanVideoVAE(init_vae_params(device=mesh.device,
                                          dtype=torch.bfloat16, seed=1))
    pipe = Kandinsky5T2VPipeline(dit, conf, SeededEmbedder(), vae, tp=mesh)
    torch.cuda.synchronize()
    out = {"rank": mesh.rank, "build_s": time.perf_counter() - t}
    decoded = []
    real_decode = pipe.decode_latents

    def keep(lat, mode=None):
        decoded.append(lat)
        return real_decode(lat, mode)

    pipe.decode_latents = keep
    barrier = lambda: mesh.world.all_reduce(torch.zeros(1))  # noqa: E731
    image = dict(time_length=0, width=768, height=512)
    prompt, seed = MESH_SERVE_SEEDED
    states = os.path.join(out_dir, "serve_mesh", "states")
    if mesh.rank == 0:
        shutil.rmtree(os.path.join(out_dir, "serve_mesh"), ignore_errors=True)
        os.makedirs(states)
    barrier()

    # the seeded request made directly with the server's state path: a
    # state of another seed first (one chunk of one step; not taken), then
    # the request stopped after MESH_RESUME_CHUNKS chunks of 4 steps; every
    # save counted on each rank
    path = os.path.join(states, Job("", prompt, seed=seed,
                                    **image).request_key() + ".npz")
    m = conf.model
    spec = pipe._spec(m.num_steps, m.guidance_weight, SCHEDULER_SCALE)
    cond = pipe._encode([pipe.expand_prompt(prompt)], "image")
    uncond = pipe._encode([DEFAULT_NEGATIVE], "image")
    saves, other, first = [], {}, {}
    real_save = resume.save_state

    def counted(*a, **kw):
        saves.append(a[1])
        return real_save(*a, **kw)

    with mock.patch.object(resume, "save_state", counted):
        for report, s, size, chunks in (
                (other, seed + 1, 1, 1), (first, seed, 4, MESH_RESUME_CHUNKS)):
            resume.resumable_generate(
                dit, spec, (1, 1, 64, 96, 16), cond, uncond, seed=s,
                checkpoint_path=path, chunk=size, mesh=mesh, report=report,
                _stop_after_chunks=chunks)
    barrier()
    out["resume"] = dict(saves=saves, other_start=other["start_step"],
                         start=first["start_step"],
                         files=sorted(os.listdir(states)))

    # the server session: rank 0 the front end, rank 1 follows; the counts
    # cover it alone
    del decoded[:]
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t = time.perf_counter()
    if mesh.rank != 0:
        out["records"] = follow(pipe)
    else:
        srv = GenerationServer(pipe, out_dir=os.path.join(out_dir,
                                                          "serve_mesh"),
                               batch_window_s=1.0, checkpoint_dir=states)
        port = srv.start(host="127.0.0.1", port=0).server_address[1]
        try:
            out["healthz"] = _http(port, "/healthz")
            jobs = {f"unseeded {i}": _http(port, "/generate", dict(
                image, prompt=p, num_steps=MESH_SERVE_PAIR_STEPS))["job_id"]
                for i, p in enumerate(MESH_SERVE_PROMPTS)}
            st = _wait_jobs(port, list(jobs.values()))
            out["after_pair"] = _http(port, "/metrics")
            for name, extra in (
                    ("seeded", dict(prompt=prompt, seed=seed)),
                    ("unsupported size", dict(prompt="too wide",
                                              width=SERVE_BAD_WIDTH)),
                    ("later", dict(prompt=MESH_SERVE_LATER,
                                   num_steps=MESH_SERVE_LATER_STEPS))):
                jobs[name] = _http(port, "/generate",
                                   dict(image, **extra))["job_id"]
                st.update(_wait_jobs(port, [jobs[name]]))
            out["metrics"] = _http(port, "/metrics")
            out["png"] = _http(port, f"/result/{jobs['seeded']}")
        finally:
            srv.stop()
            srv.join()
        out["status"] = {name: st[j] for name, j in jobs.items()}
        out["timings"] = {name: srv.jobs[j].timings
                          for name, j in jobs.items()}
        out["files_after"] = sorted(os.listdir(states))
    torch.cuda.synchronize()
    out["session_s"] = time.perf_counter() - t
    out["session_launches"] = dict(_kernels.LAUNCHES)
    session = list(decoded)

    # the seeded request through the mesh pipeline directly
    _kernels.reset_launches()
    frames = pipe(prompt, seed=seed, **image)
    torch.cuda.synchronize()
    out["direct_launches"] = dict(_kernels.LAUNCHES)
    out["direct_timings"] = dict(pipe.timings)
    if mesh.rank == 0:
        import io

        import numpy as np
        from PIL import Image

        out["png_equal"] = bool(np.array_equal(
            np.asarray(Image.open(io.BytesIO(out.pop("png")))),
            frames[0, 0]))
        out.update(_single_decodes(pipe, [("mesh direct", decoded[-1],
                                           frames)]))
        one = Kandinsky5T2VPipeline(None, pipe.conf, None,
                                    pipe.vae.replace(group=None),
                                    decode_mode="tiled")
        _kernels.reset_launches()
        for lat in session:
            one.decode_latents(lat)
        out["single_session_launches"] = dict(_kernels.LAUNCHES)
    elif frames is not None:
        raise Failure(f"rank {mesh.rank} returned frames")
    return out


def phase_serve_mesh(out_dir: str):
    """5e: one launch of 2 ranks on the (1, 1, 2) mesh that
    ``plan_dit_mesh(2, 28)`` plans, sharing the card over gloo.
    config_5s_distil.yaml at full width and depth (each rank's DiT share
    drawn by ``fast_init_dit_shard``, the full VAE, the seeded stand-in text
    embedder) serves image requests at the config's 16 steps (the pair at
    MESH_SERVE_PAIR_STEPS, the later one at MESH_SERVE_LATER_STEPS): world
    rank 0
    runs ``GenerationServer`` at 127.0.0.1, rank 1 ``serve.follow``. Before
    the server starts, the seeded request made directly with the server's
    state path stops after MESH_RESUME_CHUNKS chunks over a state of
    another seed, which it must not take (start step 0); rank 0 alone
    saves, one state file is left. Served: two unseeded requests within the
    window as one batch of two (``/metrics``); the seeded request alone,
    resumed at step 8 (``start_step``), its PNG bit-equal to the same
    request made through the mesh pipeline directly afterwards, whose
    frames are held against the single-process tiled decode of its latents
    (FRAME_LEVELS, FRAME_SHARE), the state file gone; a request at an
    unsupported size in ``error`` on both ranks, and a later one ``done``;
    ``/healthz`` counts 2 ranks; the stop ends the follower. Launch counts a
    rank, exact: K1 34 and K8 32 a step run, K2 none, in the session and
    in the direct call; K3 and K4 summed over the ranks equal to the
    single-process tiled decodes of the same latents. Printed: each job's
    ``queued_s`` and ``generation_s``, each batch's s/step and all-reduce
    share a rank. Returns the launches by path and the report."""
    from kandinsky5_tpu_torch.config import CONFIG_DIR, load_config
    from kandinsky5_tpu_torch.parallel import launch
    from kandinsky5_tpu_torch.parallel.sharding import plan_dit_mesh

    cfg = load_config(os.path.join(CONFIG_DIR, CONF5)).model.dit_params
    plan = plan_dit_mesh(2, cfg.num_heads)
    if plan != (1, 1, 2):
        raise Failure(f"plan_dit_mesh(2, {cfg.num_heads}) gives {plan}")
    t = time.perf_counter()
    res = launch(_serve_mesh_rank, 2, "gloo", "cuda", args=(out_dir,),
                 timeout=900)
    launch_s = time.perf_counter() - t
    lead, follower = res
    n_text, n_vis = cfg.num_text_blocks, cfg.num_visual_blocks
    bad = []
    st, tm = lead["status"], lead["timings"]
    names = list(st)
    # the steps each served batch ran (the seeded one from its resume step)
    batches = [tm["unseeded 0"], tm["seeded"], tm["later"]]
    ran = sum(b["steps"] - b.get("start_step", 0) for b in batches)
    direct_steps = lead["direct_timings"]["steps"]
    for rank, r in enumerate(res):
        rec = r["records"] if rank else None
        for what, got, steps in (("session", r["session_launches"], ran),
                                 ("direct", r["direct_launches"],
                                  direct_steps)):
            want = {"K1_flash_fixed": (n_text + n_vis) * steps,
                    "K8_ff": n_vis * steps, "K2_ff_mod": 0}
            wrong = {k: (got[k], n) for k, n in want.items() if got[k] != n}
            if wrong:
                bad.append(f"rank {rank} {what}: launches (got, want) {wrong}")
        rs = r["resume"]
        want_saves = [1, 4, 8] if rank == 0 else []
        if (rs["saves"] != want_saves or rs["other_start"] != 0
                or rs["start"] != 0 or len(rs["files"]) != 1):
            bad.append(f"rank {rank} direct resume runs: saves {rs['saves']} "
                       f"(want {want_saves}), start steps "
                       f"{rs['other_start']}, {rs['start']}, files "
                       f"{rs['files']}")
        per_batch = (batches if rank == 0
                     else [x["timings"] for x in rec if x["ok"]])
        for b in per_batch:
            share = b["all_reduce_s"] / b["denoise_s"]
            b["all_reduce_share"] = share
        log(f"  rank {rank}: built in {r['build_s']:.1f} s; session "
            f"{r['session_s']:.1f} s; batches' s/step "
            + ", ".join(f"{b['denoise_s'] / (b['steps'] - b.get('start_step', 0)):.4f}"
                        for b in per_batch)
            + "; all-reduce share of the denoise "
            + ", ".join(f"{b['all_reduce_share']:.3f}" for b in per_batch)
            + " (gloo through the host, 2 ranks on one card, not a "
            "multi-GPU figure)")
    for n in names:
        log(f"  served {n}: {st[n]['state']}, queued {st[n]['queued_s']:.3f} "
            f"s, generation {st[n].get('generation_s', float('nan')):.3f} s"
            + (f", start step {st[n]['start_step']}"
               if "start_step" in st[n] else "")
            + (f" ({st[n]['error']})" if st[n].get("error") else ""))
    log(f"  healthz {lead['healthz']}; metrics after the pair "
        f"{lead['after_pair']}, at the end {lead['metrics']}")
    rec = follower["records"]
    if [x["ok"] for x in rec] != [True, True, False, True] or \
            "height, width" not in rec[2]["error"]:
        bad.append(f"follower records {[(x['ok'], x.get('error')) for x in rec]}")
    if (lead["after_pair"]["batches"], lead["after_pair"]["batched_jobs"]) \
            != (1, 2):
        bad.append(f"the pair did not batch: {lead['after_pair']}")
    if (st["seeded"]["state"] != "done"
            or st["seeded"].get("start_step") != 4 * MESH_RESUME_CHUNKS
            or not lead["png_equal"] or lead["files_after"]):
        bad.append(f"seeded: {st['seeded']}, PNG bit-equal to the direct "
                   f"call {lead['png_equal']}, states left "
                   f"{lead['files_after']}")
    if st["unsupported size"]["state"] != "error" or \
            "height, width" not in st["unsupported size"].get("error", "") \
            or any(st[n]["state"] != "done" for n in names
                   if n != "unsupported size"):
        bad.append(f"job states {({n: st[n]['state'] for n in names})}")
    m = lead["metrics"]
    if (m["jobs_done"], m["jobs_failed"], m["batches"]) != (4, 1, 3) or \
            lead["healthz"]["devices"] != 2:
        bad.append(f"metrics {m}, healthz {lead['healthz']}")
    for name, fm in lead["frames"].items():
        log(f"  {name}: rank 0's frames against the single-process tiled "
            f"decode of its latents: {fm['max_levels']} levels at most, on "
            f"{fm['share']:.2e} of the values; served PNG bit-equal "
            f"{lead['png_equal']}")
    bad += _decode_split_faults(
        [dict(frames=lead["frames"], launches=lead["direct_launches"]),
         dict(launches=follower["direct_launches"])],
        lead["single_launches"], every_rank=False)
    summed = {k: sum(r["session_launches"][k] for r in res)
              for k in DECODE_KERNELS}
    single = {k: lead["single_session_launches"][k] for k in DECODE_KERNELS}
    if summed != single:
        bad.append(f"session decode launches over the ranks {summed}, "
                   f"single {single}")
    log(f"  launches a rank: session ({ran} steps) "
        f"{[{k: r['session_launches'][k] for k in ('K1_flash_fixed', 'K8_ff', 'K2_ff_mod')} for r in res]}, "
        f"direct ({direct_steps} steps) "
        f"{[{k: r['direct_launches'][k] for k in ('K1_flash_fixed', 'K8_ff', 'K2_ff_mod')} for r in res]}; "
        f"session decodes K3/K4 over the ranks {summed} (single {single})")
    if bad:
        raise Failure("serving on the mesh: " + "; ".join(bad))
    report = [dict(request="mesh server", launch_s=launch_s,
                   session_s=[r["session_s"] for r in res],
                   build_s=[r["build_s"] for r in res],
                   jobs={n: {k: st[n].get(k) for k in (
                       "state", "queued_s", "generation_s", "start_step")}
                       for n in names},
                   s_per_step={n: tm[n]["denoise_s"] / (
                       tm[n]["steps"] - tm[n].get("start_step", 0))
                       for n in names if st[n]["state"] == "done"},
                   all_reduce_share=[[b["all_reduce_share"]
                                      for b in (batches if rank == 0 else
                                                [x["timings"] for x in
                                                 r["records"] if x["ok"]])]
                                     for rank, r in enumerate(res)],
                   metrics=m)]
    return {"5e-serve-mesh": _summed(r["session_launches"] for r in res),
            "5e-direct": _summed(r["direct_launches"] for r in res)}, report


def serve_mesh_alone(out_dir) -> dict:
    """Phase 5e alone (``--serve-mesh``)."""
    os.makedirs(out_dir, exist_ok=True)
    t = time.perf_counter()
    launches, report = phase_serve_mesh(out_dir)
    return dict(launches=launches, report=report,
                seconds=time.perf_counter() - t)


def sp_alone(out_dir, dev, conf5, conf10) -> dict:
    """Phase 5c alone (``--sp``): the image request's text embeddings come
    from :class:`SeededEmbedder`, not from phase 4's towers, and one
    device's full-depth forward is computed here."""
    from kandinsky5_tpu_torch.pipeline import DEFAULT_NEGATIVE

    os.makedirs(out_dir, exist_ok=True)
    rec = RecordingEmbedder(SeededEmbedder())
    expanded = rec.expand_prompt(IMAGE_REQUEST[1])
    for text in (expanded, DEFAULT_NEGATIVE):
        rec.encode([text], "image")
    rec.save(os.path.join(out_dir, TEXT_FILE))
    t = time.perf_counter()
    launches, report = phase_sp(dev, conf5, conf10, out_dir)
    return dict(launches=launches, report=report,
                seconds=time.perf_counter() - t)


def int8_mesh_alone(out_dir, dev, conf5, conf10) -> dict:
    """Phase 5d alone (``--int8-mesh``): the image request's text embeddings
    come from :class:`SeededEmbedder`, and phase 3's Qwen reference is made
    here on a freshly built tower."""
    from kandinsky5_tpu_torch.pipeline import DEFAULT_NEGATIVE

    os.makedirs(out_dir, exist_ok=True)
    rec = RecordingEmbedder(SeededEmbedder())
    expanded = rec.expand_prompt(IMAGE_REQUEST[1])
    for text in (expanded, DEFAULT_NEGATIVE):
        rec.encode([text], "image")
    rec.save(os.path.join(out_dir, TEXT_FILE))
    t = time.perf_counter()
    emb = seeded_text_embedder(dev, conf5.model.text_embedder,
                               qwen_layers=QWEN_LAYERS, seed=QWEN_SEED)
    qwen_reference(emb, os.path.join(out_dir, QWEN_REF))
    del emb
    launches, report = phase_sp(dev, conf5, conf10, out_dir, parts=("5d",))
    return dict(launches=launches, report=report,
                seconds=time.perf_counter() - t)


def dp_alone(out_dir, dev, conf5) -> dict:
    """Phases 5a and 5b alone (``--dp``): the request's text embeddings
    come from :class:`SeededEmbedder`, not from phase 4's towers."""
    from kandinsky5_tpu_torch.pipeline import DEFAULT_NEGATIVE

    os.makedirs(out_dir, exist_ok=True)
    rec = RecordingEmbedder(SeededEmbedder())
    for text in (VIDEO_PROMPT, DEFAULT_NEGATIVE):
        rec.encode([text], "video")
    rec.save(os.path.join(out_dir, TEXT_FILE))
    out = {}
    for sub, run in (("5a", lambda: phase_dp(out_dir)),
                     ("5b", lambda: phase_dptp(dev, conf5))):
        t = time.perf_counter()
        launches, report = run()
        out[sub] = dict(launches=launches, report=report,
                        seconds=time.perf_counter() - t)
        log(f"  phase {sub} {out[sub]['seconds']:.1f} s")
    return out


def tp_seed_study(dev, seeds) -> int:
    """Phase 5's tp forwards and controls for each seed; prints one JSON
    line of readings. 0 when every seed's sound runs pass TP_BOUND and
    every control fails it."""
    from kandinsky5_tpu_torch.config import CONFIG_DIR, load_config
    from kandinsky5_tpu_torch.tools import gpu_line

    cfg = load_config(os.path.join(CONFIG_DIR, CONF5)).model.dit_params
    rows, failed = [], []
    for seed in seeds:
        t = time.perf_counter()
        _, report, bad = tp_forwards(dev, cfg, seed)
        failed += bad
        for line in report:
            rows.append({k: line.get(k) for k in (
                "request", "seed", "rel_l2", "no_ff_all_reduce_rel_l2",
                "bias_on_every_rank_rel_l2", "wall_s", "all_reduce_s")})
        log(f"  seed {seed}: {time.perf_counter() - t:.1f} s")
    log(gpu_line())
    log(json.dumps({"tp_bound": TP_BOUND, "tp_seeds": rows,
                    "failed": failed}))
    return 1 if failed else 0


# ---------------------------------------------------------------------------
# phase 6: serving — MagCache, resumable denoise, the HTTP server and the
# parity-gate consumer on phase 4's DiT, VAE and towers
# ---------------------------------------------------------------------------

CONF5_SFT = "config_5s_sft.yaml"
CONF10_SFT = "config_10s_sft.yaml"
# the served image requests: unseeded ones batch, seeded ones run alone
SERVE_PROMPTS = ("a served image", "another served image")
SERVE_SEEDED = ("a seeded served image", 7)
SERVE_BAD_WIDTH = 1024
# the unseeded pair's and the later request's steps: they show batching and
# that the server goes on after an error, and are cut from the config's 50
# so that the smoke keeps its time (the seeded request, which the direct
# call and the parity consumer replay, keeps the config's steps)
SERVE_PAIR_STEPS = 16
# the resumable request stops after this many chunks of 4 steps
RESUME_CHUNKS = 2


@contextlib.contextmanager
def visual_launches():
    """The kernel launches made inside the DiT's visual block stack, by
    kernel, while the block is open (the text blocks, the prologue and the
    epilogue are outside it)."""
    from kandinsky5_tpu_torch import sampling
    from kandinsky5_tpu_torch.ops import _kernels

    counts = {k: 0 for k in _kernels.LAUNCHES}
    real = sampling.dit_visual_blocks

    def blocks(*args, **kw):
        before = dict(_kernels.LAUNCHES)
        out = real(*args, **kw)
        for k, n in _kernels.LAUNCHES.items():
            counts[k] += n - before[k]
        return out

    sampling.dit_visual_blocks = blocks
    try:
        yield counts
    finally:
        sampling.dit_visual_blocks = real


def _serve_request(pipe, name, prompt, seconds, seed, out_dir, fname,
                   **kw):
    """One request through ``pipe`` (no expansion unless asked), its frames
    checked; returns (frames, timings)."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    frames = pipe(prompt, time_length=seconds, width=768, height=512,
                  seed=seed, save_path=os.path.join(out_dir, fname), **kw)
    wall = time.perf_counter() - t
    tm = dict(pipe.timings, wall_s=wall)
    frames_want = 1 if seconds == 0 else 4 * (seconds * 24 // 4) + 1
    if (frames.shape != (1, frames_want, 512, 768, 3)
            or frames.dtype != np.uint8 or not tm["latents_finite"]
            or float(frames.std()) == 0.0):
        raise Failure(f"{name}: frames {frames.shape} {frames.dtype}, "
                      f"finite latents {tm['latents_finite']}")
    log(f"  {name}: denoise {tm['denoise_s']:.3f} s ({tm['steps']} steps, "
        f"cfg {tm['cfg']}, MagCache {tm['magcache']}); decode "
        f"{tm['decode_s']:.3f} s; wall {wall:.3f} s")
    return frames, tm


def _magcache_gate(name, conf, spec, launches, visual, off=None):
    """Hold one MagCache run's launches against its schedule: the visual
    blocks run on the steps where a branch runs (every branch of a batched
    call, or each branch's call when sequential), the text blocks on every
    call. ``off`` is the visual and total launches of the same request
    without MagCache, when there is one. Returns the counts checked."""
    from kandinsky5_tpu_torch.sampling import skip_schedule

    skip = skip_schedule(spec, conf.magcache)
    cfg = conf.model.dit_params
    steps = spec.num_steps
    if spec.use_cfg and spec.sequential_cfg:
        calls, vis_calls = 2 * steps, int((~skip).sum())
    else:
        branches = skip[:, :1 + spec.use_cfg]
        calls, vis_calls = steps, int((~branches.all(axis=1)).sum())
    attn = ("K6_sparse_nabla" if spec.attention_type == "nabla"
            else "K1_flash_fixed")
    text_k1 = launches["K1_flash_fixed"] - visual["K1_flash_fixed"]
    want = {attn: cfg.num_visual_blocks * vis_calls,
            "text K1": cfg.num_text_blocks * calls}
    got = {attn: visual[attn], "text K1": text_k1}
    if spec.attention_type != "nabla":
        want["K2_ff_mod"] = cfg.num_visual_blocks * vis_calls
        got["K2_ff_mod"] = visual["K2_ff_mod"]
    if off is not None:
        vis_off, all_off = off
        for k in (attn, "K2_ff_mod"):
            # exactly vis_calls / steps of the run without MagCache
            if visual[k] * steps != vis_off[k] * vis_calls:
                raise Failure(f"{name}: {k} in the visual blocks {visual[k]}"
                              f", not {vis_calls}/{steps} of {vis_off[k]}")
        if text_k1 != all_off["K1_flash_fixed"] - vis_off["K1_flash_fixed"]:
            raise Failure(f"{name}: the text blocks launched K1 {text_k1} "
                          "times, not as often as without MagCache")
    wrong = {k: (got[k], n) for k, n in want.items() if got[k] != n}
    log(f"  {name}: visual blocks ran on {vis_calls} of {calls} DiT calls; "
        f"launches {got} (want {want})")
    if wrong:
        raise Failure(f"{name}: launches (got, want) {wrong}")
    return {"dit_calls": calls, "visual_calls": vis_calls, **got}


def _finite(x):
    """``x``, or None where JSON has no number for it (inf, nan)."""
    return x if x is not None and math.isfinite(x) else None


def _http(port, path, payload=None):
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        body = r.read()
    return body if path.startswith("/result/") else json.loads(body)


def _wait_jobs(port, ids, timeout=600.0):
    """Poll until every job is done or in error; returns their status."""
    t0 = time.perf_counter()
    out = {}
    while len(out) < len(ids):
        if time.perf_counter() - t0 > timeout:
            raise Failure(f"server: jobs {set(ids) - set(out)} did not end "
                          f"in {timeout} s")
        for j in ids:
            if j not in out:
                st = _http(port, f"/status/{j}")
                if st["state"] in ("done", "error"):
                    out[j] = st
        time.sleep(0.1)
    return out


def phase_serving(dev, built, seconds10: int, out_dir: str):
    """MagCache on and off, resume, the server and the parity consumer on
    the DiT, VAE and towers of phase 4 under ``config_5s_sft`` (50 steps,
    guidance 5.0, its MagCache ratios); with ``seconds10`` 10 also the 10 s
    sft path's 2 s video with MagCache (sequential CFG, K6). Each run's
    launch counts are reset just before it and read just after. Returns the
    launches by run and the report."""
    import numpy as np
    import torch
    from PIL import Image

    from kandinsky5_tpu_torch.config import CONFIG_DIR, load_config
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.pipeline import (
        DEFAULT_NEGATIVE,
        Kandinsky5T2VPipeline,
    )
    from kandinsky5_tpu_torch.sampling import seeded_noise
    from kandinsky5_tpu_torch.serve import GenerationServer
    from kandinsky5_tpu_torch.tools import parity_check
    from kandinsky5_tpu_torch.utils.metrics import psnr
    from kandinsky5_tpu_torch.utils.offload import ParamStore
    from kandinsky5_tpu_torch.utils.resume import resumable_generate

    dit, vae, towers = built
    if next(dit.parameters()).device.type != "cuda":
        # phase 4's offload request left them in host memory
        t0 = time.perf_counter()
        for obj in (dit, towers, vae.params):
            ParamStore(obj, dev).stage()
        torch.cuda.synchronize()
        log(f"  the DiT, the VAE and the towers back on the card "
            f"{time.perf_counter() - t0:.1f} s; "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    conf = load_config(os.path.join(CONFIG_DIR, CONF5_SFT))
    if conf.model.dit_params != dit.cfg:
        raise Failure(f"{CONF5_SFT} names another DiT than phase 4's")
    m = conf.model
    out_dir = os.path.join(out_dir, "serving")
    os.makedirs(out_dir, exist_ok=True)
    embedder = RecordingEmbedder(towers)
    launches, report = {}, []
    log(f"  {CONF5_SFT}: {m.num_steps} steps, guidance {m.guidance_weight}, "
        f"MagCache threshold {conf.magcache.threshold} K {conf.magcache.K} "
        f"retention {conf.magcache.retention_ratio}, "
        f"{len(conf.magcache.mag_ratios)} ratios")

    # 1. the 1 s video with MagCache off, then on
    pipes, runs = {}, {}
    for mag in (False, True):
        tag = "magcache-on" if mag else "magcache-off"
        pipe = Kandinsky5T2VPipeline(dit, conf, embedder, vae, magcache=mag)
        kept = _keep_latents(pipe, tag)
        _kernels.reset_launches()
        with visual_launches() as visual:
            frames, tm = _serve_request(
                pipe, f"sft video 1s, {tag}", VIDEO_PROMPT, 1, 42, out_dir,
                f"sft_video_1s_{tag}.mp4", expand_prompts=False)
        launches[f"6-{tag}"] = dict(_kernels.LAUNCHES)
        pipes[mag] = pipe
        runs[mag] = dict(frames=frames, tm=tm, latents=kept[tag],
                         visual=dict(visual),
                         launches=launches[f"6-{tag}"])
    spec = pipes[True]._spec(m.num_steps, m.guidance_weight, 10.0)
    gate = _magcache_gate("sft video 1s, MagCache", conf, spec,
                          runs[True]["launches"], runs[True]["visual"],
                          off=(runs[False]["visual"],
                               runs[False]["launches"]))
    if gate["visual_calls"] != 24 or gate["dit_calls"] != 50:
        raise Failure(f"the sft schedule runs the visual blocks on "
                      f"{gate['visual_calls']} of {gate['dit_calls']} calls, "
                      "not 24 of 50")
    on, off = runs[True]["tm"], runs[False]["tm"]
    ratio = off["denoise_s"] / on["denoise_s"]
    db = psnr(runs[True]["frames"], runs[False]["frames"])
    log(f"  MagCache: denoise {on['denoise_s']:.3f} s against "
        f"{off['denoise_s']:.3f} s without it: {ratio:.3f}x (ceiling "
        f"{gate['dit_calls'] / gate['visual_calls']:.3f}x); frame PSNR "
        f"against the run without it {db:.2f} dB (random weights: printed, "
        "not gated)")
    report.append(dict(request="sft video 1s magcache", launches=gate,
                       denoise_s=on["denoise_s"],
                       denoise_off_s=off["denoise_s"], ratio=ratio,
                       psnr_vs_off_db=_finite(db),
                       decode_s=on["decode_s"]))

    if seconds10 == 10:
        conf10 = load_config(os.path.join(CONFIG_DIR, CONF10_SFT))
        pipe10 = Kandinsky5T2VPipeline(dit, conf10, embedder, vae,
                                       magcache=True)
        _kernels.reset_launches()
        with visual_launches() as visual:
            _, tm = _serve_request(pipe10, "10 s sft video 2s, MagCache",
                                   "a smoke-test 10s-sft video 2s", 2, 42,
                                   out_dir, "sft10_video_2s.mp4",
                                   expand_prompts=False)
        launches["6-10s-magcache"] = dict(_kernels.LAUNCHES)
        m10 = conf10.model
        spec10 = pipe10._spec(m10.num_steps, m10.guidance_weight, 10.0)
        if not spec10.sequential_cfg:
            raise Failure("the 10 s sft path did not take sequential CFG")
        gate10 = _magcache_gate("10 s sft video 2s, MagCache", conf10, spec10,
                                launches["6-10s-magcache"], visual)
        report.append(dict(request="10s sft video 2s magcache",
                           launches=gate10, denoise_s=tm["denoise_s"],
                           s_per_step=tm["denoise_s"] / tm["steps"]))
        del pipe10
        torch.cuda.empty_cache()

    # 2. resume: a state of another fingerprint is not taken; the request
    # stopped after RESUME_CHUNKS chunks resumes to the same latents
    pipe = pipes[True]
    path = os.path.join(out_dir, "resume_state.npz")
    shape = tuple(runs[True]["latents"].shape)
    cond = pipe._encode([VIDEO_PROMPT], "video")
    uncond = pipe._encode([DEFAULT_NEGATIVE], "video")
    _kernels.reset_launches()
    resumable_generate(dit, spec, shape, cond, uncond, seed=43,
                       checkpoint_path=path, magcache=conf.magcache,
                       _stop_after_chunks=1)
    ctrl = {}
    resumable_generate(dit, spec, shape, cond, uncond, seed=42,
                       checkpoint_path=path, magcache=conf.magcache,
                       report=ctrl, _stop_after_chunks=RESUME_CHUNKS)
    log(f"  resume control: over a state of seed 43 the seed-42 request "
        f"started at step {ctrl['start_step']} (must be 0)")
    kept = _keep_latents(pipe, "resumed")
    frames, tm = _serve_request(pipe, "sft video 1s, MagCache, resumed",
                                VIDEO_PROMPT, 1, 42, out_dir,
                                "sft_video_1s_resumed.mp4",
                                expand_prompts=False, checkpoint_path=path)
    launches["6-resume"] = dict(_kernels.LAUNCHES)
    same_lat = torch.equal(kept["resumed"], runs[True]["latents"])
    same_frames = bool(np.array_equal(frames, runs[True]["frames"]))
    gone = not os.path.exists(path)
    log(f"  resumed at step {tm['start_step']} of {tm['steps']}; latents "
        f"bit-equal to the uninterrupted run: {same_lat}; frames: "
        f"{same_frames}; state file removed: {gone}")
    report.append(dict(request="sft video 1s resumed",
                       start_step=tm["start_step"],
                       control_start_step=ctrl["start_step"],
                       latents_equal=same_lat, frames_equal=same_frames))
    if not (ctrl["start_step"] == 0 and tm["start_step"] == 4 * RESUME_CHUNKS
            and same_lat and same_frames and gone):
        raise Failure("resume: control start step "
                      f"{ctrl['start_step']}, resumed at {tm['start_step']},"
                      f" latents equal {same_lat}, frames equal "
                      f"{same_frames}, state file removed {gone}")
    del kept, runs
    torch.cuda.empty_cache()

    # 3. the server over the MagCache pipeline
    serve_dir = os.path.join(out_dir, "serve")
    srv = GenerationServer(pipe, out_dir=serve_dir, batch_window_s=1.0)
    port = srv.start(host="127.0.0.1", port=0).server_address[1]
    image = dict(time_length=0, width=768, height=512)
    _kernels.reset_launches()
    try:
        health = _http(port, "/healthz")
        pair = [_http(port, "/generate", dict(
            image, prompt=p, num_steps=SERVE_PAIR_STEPS))["job_id"]
                for p in SERVE_PROMPTS]
        st = _wait_jobs(port, pair)
        batched = _http(port, "/metrics")
        seeded = _http(port, "/generate", dict(
            image, prompt=SERVE_SEEDED[0], seed=SERVE_SEEDED[1]))["job_id"]
        st.update(_wait_jobs(port, [seeded]))
        bad = _http(port, "/generate", dict(image, width=SERVE_BAD_WIDTH,
                                            prompt="too wide"))["job_id"]
        st.update(_wait_jobs(port, [bad]))
        later = _http(port, "/generate", dict(
            image, prompt="a later served image",
            num_steps=SERVE_PAIR_STEPS))["job_id"]
        st.update(_wait_jobs(port, [later]))
        metrics = _http(port, "/metrics")
        served_png = _http(port, f"/result/{seeded}")
    finally:
        srv.stop()
    torch.cuda.synchronize()  # a sticky CUDA error shows here
    launches["6-serve"] = dict(_kernels.LAUNCHES)
    names = {pair[0]: "batched a", pair[1]: "batched b", seeded: "seeded",
             bad: "unsupported size", later: "later"}
    for j, name in names.items():
        log(f"  served {name}: {st[j]['state']}, queued "
            f"{st[j]['queued_s']:.3f} s, generation "
            f"{st[j].get('generation_s', float('nan')):.3f} s"
            + (f" ({st[j]['error']})" if st[j].get("error") else ""))
    log(f"  server: healthz {health}; metrics after the pair {batched}, at "
        f"the end {metrics}")
    failed = [names[j] for j in st if st[j]["state"] != "done" and j != bad]
    if failed or st[bad]["state"] != "error" or "height, width" not in \
            st[bad].get("error", ""):
        raise Failure(f"server: jobs in error {failed}; the unsupported "
                      f"size ended {st[bad]['state']} "
                      f"({st[bad].get('error', '')})")
    if (batched["batches"], batched["batched_jobs"]) != (1, 2) or \
            metrics["jobs_failed"] != 1 or metrics["jobs_done"] != 4 or \
            health["devices"] != torch.cuda.device_count():
        raise Failure(f"server: metrics after the pair {batched}, at the end "
                      f"{metrics}, healthz {health}")
    report.append(dict(request="server", jobs={
        names[j]: {k: st[j].get(k) for k in ("state", "queued_s",
                                             "generation_s")}
        for j in st}, metrics=metrics))

    # the seeded request through the pipeline directly; its latents and
    # tiled frames make the consumer's dump
    kept = _keep_latents(pipe, "direct")
    _kernels.reset_launches()
    direct, tm = _serve_request(pipe, "seeded image, direct",
                                SERVE_SEEDED[0], 0, SERVE_SEEDED[1], out_dir,
                                "seeded_direct.png")
    served = np.asarray(Image.open(srv.jobs[seeded].result_path))
    import io

    same = bool(np.array_equal(served, direct[0, 0])) and bool(
        np.array_equal(np.asarray(Image.open(io.BytesIO(served_png))),
                       direct[0, 0]))
    log(f"  seeded served image against the same request made directly: "
        f"bit-equal {same}")
    if not same:
        raise Failure("the seeded served image differs from the direct "
                      f"request's (PSNR {psnr(served, direct[0, 0]):.2f} dB)")
    latents = kept["direct"]
    tiled = pipe.decode_latents(latents, mode=parity_check.GATE_DECODE_MODE)
    launches["6-direct"] = dict(_kernels.LAUNCHES)

    # 4. the parity consumer on a dump of that request
    caption = embedder.expansions[SERVE_SEEDED[0]]
    dump = {"noise": seeded_noise(dit, shape=tuple(latents.shape),
                                  seed=SERVE_SEEDED[1])[0].cpu().numpy(),
            "latents": latents[0].float().cpu().numpy(), "frames": tiled,
            "prompt": np.asarray(caption),
            "negative": np.asarray(DEFAULT_NEGATIVE)}
    # in the reference dump's layout: a prompt's valid tokens, packed
    for key, text in (("cond", caption), ("uncond", DEFAULT_NEGATIVE)):
        emb, pooled, mask = embedder.encodings[_text_key([text], "image")]
        dump[f"{key}_text_embeds"] = emb[0][mask[0].bool()].float().numpy()
        dump[f"{key}_pooled_embed"] = pooled.float().numpy()
        dump[f"{key}_cu_seqlens"] = np.array([0, int(mask[0].sum())],
                                             np.int32)
    _kernels.reset_launches()
    t = time.perf_counter()
    got = parity_check.run_ours(None, dump, pipe=pipe, magcache=conf.magcache,
                                log=lambda s: log("  consumer: " + s))
    launches["6-consumer"] = dict(_kernels.LAUNCHES)
    same_lat = torch.equal(got["latents"], latents)
    same_frames = bool(np.array_equal(got["frames"], tiled))
    text_err = max(got["text_err"].values())
    log(f"  consumer: {time.perf_counter() - t:.1f} s; towers' max err "
        f"against the dump {text_err:.3e}, latents bit-equal {same_lat}, "
        f"frames bit-equal {same_frames}, PSNR {got['psnr_db']:.2f} dB (the "
        "plumbing on the card; the gate waits for a reference dump)")
    report.append(dict(request="parity consumer", latents_equal=same_lat,
                       frames_equal=same_frames, text_err=text_err,
                       psnr_db=_finite(got["psnr_db"]),
                       fast_psnr_db=_finite(got["fast_psnr_db"])))
    if not (same_lat and same_frames and text_err == 0 and got["passes"]):
        raise Failure(f"consumer: latents equal {same_lat}, frames equal "
                      f"{same_frames}, towers' err {text_err:.3e}, PSNR "
                      f"{got['psnr_db']:.2f} dB")
    return launches, report


# ---------------------------------------------------------------------------
# phase 7: the training path — the VAE encode on K3 and K4, latent shards,
# the flow-matching trainer and the Qwen2.5-VL vision tower
# ---------------------------------------------------------------------------

# the encode held against the CPU: 9 frames at 192 x 256 px, whose mid
# block (3 x 24 x 32 = 2,304 latent voxels) takes K4; and 13 frames at 64 x
# 128 px through the temporal tiles (9 frames, stride 4: two tiles blended
# over one latent frame)
ENCODE_REF = (1, 9, 192, 256, 3)
ENCODE_TILED = ((1, 13, 64, 128, 3), ((9, 64, 128), (4, 64, 128)))
# bf16 encode on the card against fp32 on the CPU (the bound of the stream
# decode's check); the mid attention's residual branch on the card's own
# input against the plain one on the CPU (K4 and the bf16 q, k, v: a few
# 1e-3), which the same branch without the frame-causal ids misses by about
# 5e-2 on frames that brighten over time (measured on the CPU)
ENCODE_BOUND = 5e-2
MID_BOUND = 1.5e-2
# the full-size encodes: a 512 x 768 image (as the shard's), a 25-frame
# 512 x 768 clip (two temporal tiles of 17 frames, OPT_TEMPORAL_TILING[25])
# and a 1024 x 1024 image (2 x 2 spatial tiles, OPT_SPATIAL_TILING[1024])
FULL_ENCODES = (("image 512x768", (1, 1, 512, 768, 3)),
                ("clip 25x512x768", (1, 25, 512, 768, 3)),
                ("image 1024x1024", (1, 1, 1024, 1024, 3)))
SHARD_IMAGES = 4
SHARD_IMAGE = (1, 512, 768, 3)
SHARD_BATCH = 2
# the cut DiT's loss and gradients, fp32 on the card against fp32 on the CPU
# (TF32 off: summation order only), largest rel_l2 over the parameters
TRAIN_BOUND = 1e-3
TRAIN_LR = 1e-5
# resumed against uninterrupted parameters after step 2 (rel_l2); a step
# moves them about lr / 0.0115 = 1e-3 (uniform +-0.02 weights)
RESUME_BOUND = 1e-6
# the vision tower held against the CPU: full width, 2 blocks (the second
# full attention), a 448 x 448 image, bf16 against fp32 (6e-3 with bf16 on
# the CPU; leaving the window permutation out moves it 7e-2)
VISION_GRID = (1, 32, 32)
VISION_BOUND = 2e-2


def _ramp_pixels(shape, seed):
    """Seeded frames in [-1, 1]: noise over a brightness ramp in time, so
    the frames differ and the mid attention's frame-causal mask matters."""
    import torch

    g = torch.Generator().manual_seed(seed)
    t = shape[1]
    ramp = torch.linspace(-1.0, 1.0, t).reshape(1, t, 1, 1, 1)
    return (0.3 * torch.randn(shape, generator=g).tanh()
            + 0.7 * ramp).clamp(-1.0, 1.0)


def _encode_launches():
    from kandinsky5_tpu_torch.ops import _kernels

    return {k: n for k, n in _kernels.LAUNCHES.items() if n}


def _noncausal_mid(p, x):
    """The mid attention without its frame-causal ids (a control)."""
    from kandinsky5_tpu_torch.models import vae as vae_mod
    from kandinsky5_tpu_torch.ops.flash import flash_attention

    b, t, h, w, c = x.shape
    tokens = vae_mod.group_norm(p["group_norm"], x).reshape(b, t * h * w, c)
    q, k, v = (vae_mod._proj(p[n], tokens).to(x.dtype)[:, :, None]
               for n in ("to_q", "to_k", "to_v"))
    out = flash_attention(q, k, v)[:, :, 0].float()
    out = vae_mod._proj(p["to_out"]["0"], out)
    return out.reshape(x.shape).to(x.dtype) + x


def phase_encode_reference(dev, vae):
    """The encode at full width, bf16 on the card (K3's prologue instance
    where the TPU kernel admits a conv, K3 plain elsewhere, K4 in the mid
    block) against the same weights in fp32 on the CPU (plain versions):
    untiled (``ENCODE_REF``) and through the temporal tiles
    (``ENCODE_TILED``), each within ENCODE_BOUND. The mid attention's
    residual branch, recorded on the card, is held against the plain one on
    the card's own input (MID_BOUND); the same branch without its
    frame-causal ids must fail that bound. Then the int8 encode, held conv
    by conv against the plain versions on the card (``held_k3``), with the
    quantization off as a control that must fail."""
    import torch

    from kandinsky5_tpu_torch.models import vae as vae_mod
    from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE
    from kandinsky5_tpu_torch.ops import _kernels

    vp_cpu = {k: _params_to_cpu(vae.params[k])
              for k in ("encoder", "quant_conv")}
    cpu = HunyuanVideoVAE(vp_cpu, dtype=torch.float32)
    readings, launches, bad = {}, {}, []

    x = _ramp_pixels(ENCODE_REF, 31)
    mids = []
    real_mid = vae_mod.mid_attention

    def record(p, h):
        out = real_mid(p, h)
        mids.append((p, h, out))
        return out

    vae_mod.mid_attention = record
    try:
        _kernels.reset_launches()
        got = vae.encode_moments(x.to(dev))
        torch.cuda.synchronize()
        launches["7-encode"] = dict(_kernels.LAUNCHES)
    finally:
        vae_mod.mid_attention = real_mid
    launched = _encode_launches()
    t0 = time.perf_counter()
    ref = cpu.encode_moments(x)
    cpu_s = time.perf_counter() - t0
    e = _rel(got, ref)
    p, h, out = mids[0]
    hc = h.float().cpu()
    p_cpu = vp_cpu["encoder"]["mid_block"]["attentions"]["0"]
    want_branch = real_mid(p_cpu, hc) - hc
    e_mid = _rel(out.float().cpu() - hc, want_branch)
    e_ctl = _rel(_noncausal_mid(p, h).float().cpu() - hc, want_branch)
    ok = (e <= ENCODE_BOUND and e_mid <= MID_BOUND and e_ctl > MID_BOUND
          and launched.get("K3_conv3d_fused", 0) > 0
          and launched.get("K4_flash_online", 0) > 0)
    log(f"  encode {ENCODE_REF} -> {tuple(got.shape)}: rel_l2 {e:.3e} (tol "
        f"{ENCODE_BOUND}); mid attention {tuple(h.shape)} on the card's "
        f"input: rel_l2 {e_mid:.3e} (tol {MID_BOUND}), control (no "
        f"frame-causal ids) {e_ctl:.3e} "
        f"{'fails the bound' if e_ctl > MID_BOUND else 'PASSES'}; CPU "
        f"{cpu_s:.1f} s; kernel launches {launched} {'ok' if ok else 'FAIL'}")
    if not ok:
        bad.append(f"untiled encode rel_l2 {e:.3e}, mid {e_mid:.3e}, "
                   f"control {e_ctl:.3e}, launches {launched}")
    readings.update(encode_rel_l2=e, encode_mid_rel_l2=e_mid,
                    encode_mid_noncausal_rel_l2=e_ctl)
    del mids, p, h, out, got

    shape, tiling = ENCODE_TILED
    x = _ramp_pixels(shape, 32)
    for v in (vae, cpu):
        v._apply_tiling(*tiling)
    _kernels.reset_launches()
    got = vae.encode_moments(x.to(dev), opt_tiling=False)
    torch.cuda.synchronize()
    launches["7-encode-tiled"] = dict(_kernels.LAUNCHES)
    launched = _encode_launches()
    ref = cpu.encode_moments(x, opt_tiling=False)
    e_t = _rel(got, ref)
    ok = e_t <= ENCODE_BOUND and launched.get("K3_conv3d_fused", 0) > 0
    log(f"  encode {shape} through temporal tiles {tiling} -> "
        f"{tuple(got.shape)}: rel_l2 {e_t:.3e} (tol {ENCODE_BOUND}); "
        f"kernel launches {launched} {'ok' if ok else 'FAIL'}")
    if not ok:
        bad.append(f"tiled encode rel_l2 {e_t:.3e}, launches {launched}")
    readings["encode_tiled_rel_l2"] = e_t

    v8 = vae.replace(int8_conv=True)
    xd = _ramp_pixels(ENCODE_REF, 31).to(dev)
    _kernels.reset_launches()
    _, calls = held_k3(lambda: v8.encode_moments(xd))
    launches["7-encode-int8"] = dict(_kernels.LAUNCHES)
    launched = _encode_launches()
    _, calls_off = held_k3(lambda: v8.encode_moments(xd), quant_off=True)
    q = [(rel, ok) for quant, rel, ok in calls if quant]
    n_bad = sum(not ok for quant, _, ok in calls if quant)
    ok_i8 = (all(ok for _, _, ok in calls) and len(q) > 0
             and launched.get("K3_conv3d_quant", 0) > 0
             and launched.get("K3_quant_windows", 0) > 0)
    ok_off = all(ok for _, _, ok in calls_off)
    log(f"  encode {ENCODE_REF} int8, conv by conv on the card: {len(calls)} "
        f"K3 calls, {len(q)} W8A8, {n_bad} outside the check (flips only), "
        f"worst W8A8 rel_l2 {max(r for r, _ in q):.3e}; control "
        f"(quantization off) {'fails' if not ok_off else 'PASSES'}; kernel "
        f"launches {launched}")
    if not ok_i8 or ok_off:
        bad.append(f"int8 encode: {n_bad} of {len(q)} W8A8 calls outside, "
                   f"control passes {ok_off}, launches {launched}")
    readings["encode_int8_w8a8_calls"] = len(q)
    if bad:
        raise Failure("encode: " + "; ".join(bad))
    return readings, launches


def phase_encode_kernels(dev, results):
    """K3 and K4 at the encoder's shapes that the decoder never gives them,
    each against its plain version, timed beside cuDNN / SDPA: K3's
    prologue instance at the 25-frame clip tile's Cin != Cout convs (128 ->
    256 at 17 x 256 x 384, 256 -> 512 at 9 x 128 x 192) and a 512-channel
    conv at an image's latent size (1 x 64 x 96); K4 at a 512 x 768
    image's mid block (one frame of 6,144 tokens) and at a 1024 x 1024
    spatial tile's (68 x 68 = 4,624 tokens)."""
    import torch

    from kandinsky5_tpu_torch.ops import conv as conv_mod

    g = torch.Generator(device=dev).manual_seed(4321)
    for cin, cout, t, hh, ww in ((128, 256, 17, 256, 384),
                                 (256, 512, 9, 128, 192),
                                 (512, 512, 1, 64, 96)):
        x = torch.randn((1, t, hh, ww, cin), generator=g, device=dev).bfloat16()
        wt = (torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev)
              / math.sqrt(27 * cin)).bfloat16()
        bias = torch.randn((cout,), generator=g, device=dev).bfloat16()
        sc = 1 + 0.2 * torch.randn((cin,), generator=g, device=dev)
        sh = 0.1 * torch.randn((cin,), generator=g, device=dev)
        kw = dict(scale=sc, shift=sh, act=True)
        xt = conv_mod.conv_prologue(x, sc, sh, True)
        _compare("K3_conv3d_fused", f"{cin}->{cout} {t}x{hh}x{ww} (encode)",
                 lambda: conv_mod.causal_conv3d_fused(x, wt, bias, **kw),
                 lambda: conv_mod.conv3d_plain(x, wt, bias, **kw), results,
                 work=(2.0 * 27 * t * hh * ww * cin * cout,
                       _nbytes(x, wt, bias, sc, sh) + 2 * t * hh * ww * cout),
                 reps=2, library_fn=_cudnn_conv(xt, wt, bias, False))
        _k3_rate(results, "K3_conv3d_fused", 27.0 * t * hh * ww * cin * cout)
        del x, xt
    for s, label in ((6144, "q = kv 6144 d 512, a 512x768 image (encode)"),
                     (4624, "q = kv 4624 d 512, a 1024x1024 tile (encode)")):
        _k4_case(dev, g, results, 1, s, label=label)
    torch.cuda.empty_cache()


def phase_full_encodes(dev, vae):
    """The encodes at full size, timed: seconds, peak GiB and K3/K4
    launches of each of FULL_ENCODES (finite moments of the expected
    shape)."""
    import torch

    from kandinsky5_tpu_torch.ops import _kernels

    report, launches = [], {}
    for name, shape in FULL_ENCODES:
        x = _ramp_pixels(shape, 33).to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        t = time.perf_counter()
        z = vae.encode(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = dict(_kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = (1, (shape[1] - 1) // 4 + 1, shape[2] // 8, shape[3] // 8, 16)
        k3 = {k: n for k, n in got.items() if k.startswith("K3") and n}
        log(f"  encode {name} {shape} -> {tuple(z.shape)}: {wall:.3f} s, "
            f"peak {peak:.2f} GiB, K3 {k3}, K4 {got['K4_flash_online']}")
        if tuple(z.shape) != want or not bool(torch.isfinite(z).all()) \
                or got["K4_flash_online"] == 0:
            raise Failure(f"encode {name}: {tuple(z.shape)}, launches {got}")
        launches[f"7-encode {name}"] = got
        report.append(dict(request=f"encode {name}", encode_s=wall,
                           peak_gib=peak, k3=k3,
                           k4=got["K4_flash_online"]))
        del x, z
    torch.cuda.empty_cache()
    return report, launches


def phase_shard(dev, conf5, built, out_dir):
    """``precompute_shard`` on SHARD_IMAGES seeded 512 x 768 images with
    phase 4's VAE and full-size towers, then a ``LatentShardLoader`` on the
    card (batch SHARD_BATCH). The shard read back must equal what was
    encoded at fp16, and the loader's batches its rows. Returns the
    loader's first batch and the report line."""
    import numpy as np
    import torch

    from kandinsky5_tpu_torch.data import LatentShardLoader, precompute_shard
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.pipeline import Kandinsky5T2VPipeline

    dit, vae, towers = built
    pipe = Kandinsky5T2VPipeline(dit, conf5, towers, vae)
    g = torch.Generator().manual_seed(34)
    images = torch.randint(0, 256, (SHARD_IMAGES,) + SHARD_IMAGE,
                           generator=g, dtype=torch.uint8).numpy()
    captions = [f"a training image {i}" for i in range(SHARD_IMAGES)]
    path = os.path.join(out_dir, "shard0.npz")
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    precompute_shard(path, pipe, images, captions)
    wall = time.perf_counter() - t
    launches = dict(_kernels.LAUNCHES)
    with np.load(path) as z:
        shard = {k: z[k] for k in z.files}
    same = True
    for i in range(SHARD_IMAGES):
        x = torch.from_numpy(images[i].astype(np.float32) / 127.5 - 1.0)
        lat = vae.encode(x[None].to(dev)) * vae.scaling_factor
        cond = towers.encode([captions[i]], "video")
        want = {"latents": lat[0], "text_embeds": cond.text_embeds[0],
                "pooled_embed": cond.pooled_embed[0],
                "text_mask": cond.mask[0]}
        for k, v in want.items():
            v = v.float().cpu().numpy().astype(shard[k].dtype)
            same &= np.array_equal(shard[k][i], v[:len(shard[k][i])])
    loader = LatentShardLoader([path], SHARD_BATCH, seed=0, device=dev)
    batches = list(loader.epoch(0))
    rows = {shard["latents"][i].tobytes(): i for i in range(SHARD_IMAGES)}
    in_shard = all(b["latents"][j].float().cpu().numpy().astype(np.float16)
                   .tobytes() in rows for b in batches for j in range(
                       SHARD_BATCH))
    ok = (same and in_shard and len(batches) == SHARD_IMAGES // SHARD_BATCH
          and batches[0]["latents"].device.type == dev.type
          and batches[0]["text_mask"].dtype == torch.bool)
    log(f"  shard: {SHARD_IMAGES} images {SHARD_IMAGE[1:3]} encoded with their captions "
        f"in {wall:.2f} s ({os.path.getsize(path)} bytes), read back equal "
        f"at fp16 {same}; loader {len(batches)} batches of {SHARD_BATCH} on "
        f"the card, rows from the shard {in_shard}; launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    if not ok:
        raise Failure(f"shard: equal {same}, loader rows {in_shard}, "
                      f"{len(batches)} batches")
    return batches[0], dict(request="shard", shard_s=wall,
                            shard_bytes=os.path.getsize(path)), launches


def _zero_launches(what) -> dict:
    """The launch counts of a training run, which must all be 0: fp32
    training on dense attention runs no kernel."""
    from kandinsky5_tpu_torch.ops import _kernels

    launched = {k: n for k, n in _kernels.LAUNCHES.items() if n}
    if launched:
        raise Failure(f"{what} launched kernels {launched}: fp32 training on "
                      "dense attention runs none")
    return dict(_kernels.LAUNCHES)


def phase_train_reference(dev, conf_sft, batch):
    """The loss and every gradient of ``flow_matching_loss`` on the loader's
    batch, the sft DiT at full width (visual_cond, 33 input channels) cut
    to 2 text and 2 visual blocks, fp32 on the card against fp32 on the
    CPU (dense attention; no kernel may launch): the largest rel_l2 over
    the parameters within TRAIN_BOUND. A control must fail it: the same
    step with the first visual block's self-attention output detached (the
    fault ``refuse_grad`` keeps a kernel from committing)."""
    import dataclasses

    import torch

    from kandinsky5_tpu_torch.models import dit as dit_mod
    from kandinsky5_tpu_torch.models.dit import (
        DiffusionTransformer3D,
        fast_init_dit_params,
    )
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.training import flow_matching_loss

    cfg = dataclasses.replace(conf_sft.model.dit_params, num_text_blocks=2,
                              num_visual_blocks=2)
    model = fast_init_dit_params(cfg, device=dev, dtype=torch.float32,
                                 seed=12)
    cpu = DiffusionTransformer3D(cfg, device="cpu", dtype=torch.float32)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    g = torch.Generator().manual_seed(13)
    x0 = batch["latents"]
    t = 1e-4 + (1.0 - 1e-4) * torch.rand(x0.shape[0], generator=g)
    noise = torch.randn(x0.shape, generator=g)
    keys = ("latents", "text_embeds", "pooled_embed", "text_mask")

    def grads(m, device):
        args = [batch[k].to(device) for k in keys]
        with torch.enable_grad():
            loss = flow_matching_loss(m, cfg, *args, t.to(device),
                                      noise.to(device), attn_impl="dense")
            params = list(m.parameters())
            gs = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if gr is None else gr
                               for p, gr in zip(params, gs)]

    _kernels.reset_launches()
    t0 = time.perf_counter()
    loss, got = grads(model, dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = _zero_launches("the training reference")
    t0 = time.perf_counter()
    loss_ref, want = grads(cpu, "cpu")
    cpu_s = time.perf_counter() - t0

    real = dit_mod._self_attention
    target = model.visual_transformer_blocks[0].self_attention

    def detached(p, *a, **kw):
        out = real(p, *a, **kw)
        return out.detach() if p is target else out

    dit_mod._self_attention = detached
    try:
        _, ctl = grads(model, dev)
    finally:
        dit_mod._self_attention = real
    e_loss = abs(loss.item() - loss_ref.item()) / abs(loss_ref.item())
    worst = max(_rel(a, b) for a, b in zip(got, want))
    worst_ctl = max(_rel(a, b) for a, b in zip(ctl, want))
    ok = e_loss <= TRAIN_BOUND and worst <= TRAIN_BOUND < worst_ctl
    log(f"  training reference, DiT 2+2 blocks full width fp32 "
        f"({sum(p.numel() for p in model.parameters())} params), batch "
        f"{tuple(x0.shape)}: loss {loss.item():.6f} (CPU "
        f"{loss_ref.item():.6f}, rel {e_loss:.3e}); worst gradient rel_l2 "
        f"{worst:.3e} over {len(want)} parameters (tol {TRAIN_BOUND}); "
        f"control (block 0's self-attention detached) {worst_ctl:.3e} "
        f"{'fails the bound' if worst_ctl > TRAIN_BOUND else 'PASSES'}; card "
        f"{card_s:.2f} s, CPU {cpu_s:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise Failure(f"training reference: loss rel {e_loss:.3e}, worst "
                      f"gradient {worst:.3e}, control {worst_ctl:.3e}")
    return dict(train_loss_rel=e_loss, train_grad_worst_rel_l2=worst,
                train_grad_detached_rel_l2=worst_ctl), launches


def _params_rel(params, want) -> float:
    """rel_l2 of one list of tensors against another, over all of them."""
    num = den = 0.0
    for a, b in zip(params, want):
        num += float((a.detach() - b).float().square().sum())
        den += float(b.float().square().sum())
    return math.sqrt(num / den)


def phase_train_full(dev, conf_sft, batch, out_dir):
    """The whole 2B sft DiT in fp32 (uniform +-0.02 from a seed) with its
    AdamW state, ``train_step`` on the loader's batch (dense attention, no
    kernel may launch): ``attn_impl="auto"`` must raise the guard's error;
    three steps with finite losses; ``save_train_state`` after step 1,
    ``load_train_state`` into the state after step 3, step 2 again on the
    same draws: the loss equal to the uninterrupted step 2's and every
    parameter within RESUME_BOUND (bit-equal reported); the step-0 state
    (the seeded init, zero moments) restored instead must miss the bound.
    Prints s/step, visual tokens/s, the save and load seconds and the peak
    memory."""
    import shutil

    import torch

    from kandinsky5_tpu_torch import training
    from kandinsky5_tpu_torch.models.dit import fast_init_dit_params
    from kandinsky5_tpu_torch.ops import _kernels

    cfg = conf_sft.model.dit_params
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    model = fast_init_dit_params(cfg, device=dev, dtype=torch.float32,
                                 seed=14)
    opt = training.make_optimizer(lr=TRAIN_LR)
    state = training.init_train_state(model, opt)
    args = [batch[k] for k in ("latents", "text_embeds", "pooled_embed",
                               "text_mask")]
    n_params = sum(p.numel() for p in model.parameters())
    try:
        training.train_step(state, cfg, opt, *args,
                            torch.Generator(device=dev).manual_seed(1),
                            attn_impl="auto")
        raise Failure("train_step with attn_impl='auto' did not raise")
    except RuntimeError as e:
        refused = str(e).split(":")[0]
    gen = torch.Generator(device=dev).manual_seed(15)
    ckpt = os.path.join(out_dir, "train_state")
    shutil.rmtree(ckpt, ignore_errors=True)
    _kernels.reset_launches()
    losses, step_s = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, loss = training.train_step(state, cfg, opt, *args, gen,
                                          attn_impl="dense")
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t)
        if i == 0:
            t = time.perf_counter()
            training.save_train_state(state, ckpt, state.step)
            save_s = time.perf_counter() - t
            gen_after_1 = gen.get_state()
        if i == 1:
            after_2 = [p.detach().clone() for p in model.parameters()]
    launches = _zero_launches("fp32 training")
    torch.cuda.synchronize()
    t = time.perf_counter()
    state = training.load_train_state(ckpt, state)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    resumed_at = state.step
    gen.set_state(gen_after_1)
    state, loss_r = training.train_step(state, cfg, opt, *args, gen,
                                        attn_impl="dense")
    e_res = _params_rel(model.parameters(), after_2)
    bit_equal = all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                      after_2))
    # control: the step-0 state restored instead (fast_init_dit_params'
    # draws again, in place, and zero moments)
    with torch.no_grad():
        gi = torch.Generator(device=dev).manual_seed(14)
        for prm in model.parameters():
            prm.uniform_(-0.02, 0.02, generator=gi)
        for m in state.opt_state["mu"] + state.opt_state["nu"]:
            m.zero_()
    state = training.TrainState(model, dict(state.opt_state, count=0), 0)
    gen.set_state(gen_after_1)
    state, loss_c = training.train_step(state, cfg, opt, *args, gen,
                                        attn_impl="dense")
    e_ctl = _params_rel(model.parameters(), after_2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    shutil.rmtree(ckpt, ignore_errors=True)
    s_step = sum(step_s) / len(step_s)
    tokens = math.prod(args[0].shape[:4]) // math.prod(cfg.patch_size)
    ok = (all(math.isfinite(v) for v in losses) and loss_r.item() == losses[1]
          and resumed_at == 1 and e_res <= RESUME_BOUND < e_ctl
          and refused.startswith("K1"))
    log(f"  training, the 2B DiT fp32 ({n_params} params, AdamW lr "
        f"{TRAIN_LR}), batch {tuple(args[0].shape)} = {tokens} visual "
        f"tokens, text {tuple(args[1].shape)}: losses {losses}; "
        f"{s_step:.3f} s/step (steps {[round(v, 3) for v in step_s]}), "
        f"{tokens / s_step:.0f} visual tokens/s; attn_impl='auto' refused "
        f"at {refused}; save {save_s:.1f} s, load {load_s:.1f} s; resumed "
        f"step 2 loss {loss_r.item()} (uninterrupted {losses[1]}), params "
        f"rel_l2 {e_res:.3e} (tol {RESUME_BOUND}, bit-equal {bit_equal}); "
        f"control (step-0 state) loss {loss_c.item()}, rel_l2 {e_ctl:.3e} "
        f"{'fails the bound' if e_ctl > RESUME_BOUND else 'PASSES'}; peak "
        f"{peak:.2f} GiB ({base:.2f} GiB resident before) "
        f"{'ok' if ok else 'FAIL'}")
    del after_2, state, model
    torch.cuda.empty_cache()
    if not ok:
        raise Failure(f"training: losses {losses}, resumed {loss_r.item()}, "
                      f"params rel_l2 {e_res:.3e}, control {e_ctl:.3e}, "
                      f"guard {refused}")
    return dict(request="train 2B fp32", s_per_step=s_step,
                tokens_per_s=tokens / s_step, losses=losses,
                save_s=save_s, load_s=load_s, resume_rel_l2=e_res,
                resume_bit_equal=bit_equal, control_rel_l2=e_ctl,
                peak_gib=peak, resident_gib=base), launches


def phase_vision(dev):
    """The Qwen2.5-VL vision tower at full width (1,280 wide, 16 heads), cut
    to 2 blocks (the second full attention), bf16 on the card against the
    same weights in fp32 on the CPU on a seeded 448 x 448 image (grid 1 x
    32 x 32) within VISION_BOUND; a control that must fail: the window
    permutation left out. Then the whole 32-block tower timed on it."""
    import dataclasses

    import numpy as np
    import torch

    from kandinsky5_tpu_torch.text import qwen_vision as qv

    cfg = dataclasses.replace(qv.QwenVisionConfig(), depth=2,
                              fullatt_block_indexes=(1,))
    model = qv.init_vision_params_random(cfg, device=dev, seed=16)
    cpu = _cpu_copy(model)
    grid = np.asarray([VISION_GRID], np.int64)
    g = torch.Generator().manual_seed(17)
    patches = torch.randn((int(np.prod(VISION_GRID)), cfg.patch_dim),
                          generator=g)
    got = qv.vision_forward(model, patches.to(dev), grid)
    ref = qv.vision_forward(cpu, patches, grid)
    e = _rel(got, ref)
    real = qv.vision_indices

    def unpermuted(c, grid_thw):
        idx = real(c, grid_thw)
        n = len(idx["window_index"])
        unit = c.spatial_merge_size ** 2
        return dict(idx, perm=np.arange(n * unit), inverse=np.arange(n),
                    seg_full=idx["seg_full"][np.argsort(idx["perm"])],
                    pos_ids=idx["pos_ids"][np.argsort(idx["perm"])])

    qv.vision_indices = unpermuted
    try:
        e_ctl = _rel(qv.vision_forward(model, patches.to(dev), grid), ref)
    finally:
        qv.vision_indices = real
    del model, cpu
    full = qv.init_vision_params_random(qv.QwenVisionConfig(), device=dev,
                                        seed=18)
    xd = patches.to(dev)
    qv.vision_forward(full, xd, grid)
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = qv.vision_forward(full, xd, grid)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t
    n_full = sum(p.numel() for p in full.parameters())
    ok = (e <= VISION_BOUND < e_ctl and bool(torch.isfinite(out).all())
          and tuple(out.shape) == (int(np.prod(VISION_GRID)) // 4, 3584))
    log(f"  vision tower 2 blocks full width, grid {VISION_GRID}: rel_l2 "
        f"{e:.3e} (tol {VISION_BOUND}); control (window permutation left "
        f"out) {e_ctl:.3e} {'fails the bound' if e_ctl > VISION_BOUND else 'PASSES'}; "
        f"the 32-block tower ({n_full} params, bf16) {full_s * 1e3:.1f} ms "
        f"-> {tuple(out.shape)} {'ok' if ok else 'FAIL'}")
    del full, out
    torch.cuda.empty_cache()
    if not ok:
        raise Failure(f"vision tower: rel_l2 {e:.3e}, control {e_ctl:.3e}")
    return dict(request="vision tower", rel_l2=e, control_rel_l2=e_ctl,
                full_ms=full_s * 1e3)


def _zero_rank(mesh, cfg_kw, shard_path):
    """One rank of phase 7b: a ZeRO-1 step on the rank's row of the
    dp-placed loader's first batch; the same without the gradients' mean
    over dp (the control); on rank 0 the single-process step on the whole
    batch, and each step's parameter update held against its update (one
    step of lr 1e-5 moves a +-0.02 weight by about 5e-4 of itself, so the
    parameters alone would hide a wrong update)."""
    from unittest import mock

    import torch

    from kandinsky5_tpu_torch import training
    from kandinsky5_tpu_torch.config import DiTParams
    from kandinsky5_tpu_torch.data import LatentShardLoader
    from kandinsky5_tpu_torch.models.dit import fast_init_dit_params
    from kandinsky5_tpu_torch.ops import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = DiTParams(**cfg_kw)
    opt = training.make_optimizer(lr=TRAIN_LR)
    keys = ("latents", "text_embeds", "pooled_embed", "text_mask")

    def first_batch(dp):
        loader = LatentShardLoader([shard_path], SHARD_BATCH, seed=0,
                                   dtype=torch.float32, device=mesh.device,
                                   dp=dp)
        return list(loader.epoch(0))[0]

    def step(batch, zero):
        """The model built and sharded, then one timed step: (model, state,
        loss, step seconds)."""
        model = fast_init_dit_params(cfg, device=mesh.device,
                                     dtype=torch.float32, seed=ZERO_SEED)
        state = training.init_train_state(model, opt)
        if zero:
            state = training.shard_train_state(state, mesh)
        gen = torch.Generator(device=mesh.device).manual_seed(ZERO_SEED)
        mesh.dp.reset_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, loss = training.train_step(state, cfg, opt,
                                          *(batch[k] for k in keys), gen,
                                          attn_impl="dense")
        loss = loss.item()
        return model, state, loss, time.perf_counter() - t

    batch = first_batch(mesh.dp)
    init = [p.detach().clone() for p in fast_init_dit_params(
        cfg, device=mesh.device, dtype=torch.float32,
        seed=ZERO_SEED).parameters()]
    _kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    model, state, loss, wall = step(batch, True)
    mom = [(m.numel() * m.element_size(), d) for key in ("mu", "nu")
           for m, d in zip(state.opt_state[key], state.opt_state["dims"])]
    params = [p.detach() for p in model.parameters()]
    out = dict(rows=int(batch["latents"].shape[0]), loss=loss, step_s=wall,
               launches=dict(_kernels.LAUNCHES),
               collective_s=mesh.dp.seconds, collective_calls=mesh.dp.calls,
               collective_bytes=mesh.dp.bytes,
               moment_bytes=sum(b for b, _ in mom),
               replicated_bytes=sum(b for b, d in mom if d is None),
               unsharded_bytes=2 * sum(p.numel() * p.element_size()
                                       for p in params),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               sums=torch.stack([p.double().sum() for p in params]).cpu())
    with mock.patch.object(training, "mean_over_dp", lambda dp, xs: None):
        ctl_model = step(batch, True)[0]
    if mesh.rank == 0:
        single, _, single_loss, single_s = step(first_batch(None), False)

        def update(m):
            return [p.detach() - p0 for p, p0 in zip(m.parameters(), init)]

        want = update(single)
        out.update(single_loss=single_loss, single_step_s=single_s,
                   loss_rel=abs(loss - single_loss) / abs(single_loss),
                   update_rel_l2=_params_rel(update(model), want),
                   no_all_reduce_rel_l2=_params_rel(update(ctl_model), want))
    return out


def phase_zero(conf_sft, shard_path):
    """7b: ZeRO-1 on 2 dp ranks sharing the card: phase 7's sft DiT (full
    width, 2 text and 2 visual blocks, fp32, dense), each rank on its row of
    the dp-placed loader's batch of SHARD_BATCH; one step's loss and
    parameters within TRAIN_BOUND of the single-process step on the whole
    batch, t and noise (rank 0; the parameters' update held against its
    update), equal on both ranks; each rank's moments
    at most half of the unsharded ones plus those kept whole; control: a
    step without the gradients' mean over dp fails the bound."""
    import dataclasses

    from kandinsky5_tpu_torch.parallel import launch

    cfg = dataclasses.replace(conf_sft.model.dit_params, num_text_blocks=2,
                              num_visual_blocks=2)
    t = time.perf_counter()
    res = launch(_zero_rank, 2, "gloo", "cuda",
                 args=(dataclasses.asdict(cfg), shard_path), timeout=900,
                 dp=2)
    launch_s = time.perf_counter() - t
    r0, bad = res[0], []
    line = dict(request="zero-1 step", launch_s=launch_s,
                loss=r0["loss"], single_loss=r0["single_loss"],
                single_step_s=r0["single_step_s"],
                loss_rel=r0["loss_rel"], update_rel_l2=r0["update_rel_l2"],
                no_all_reduce_rel_l2=r0["no_all_reduce_rel_l2"])
    for rank, r in enumerate(res):
        limit = r["unsharded_bytes"] / 2 + r["replicated_bytes"]
        for k in ("step_s", "moment_bytes", "collective_s", "peak_gib"):
            line.setdefault(k, []).append(r[k])
        log(f"  ZeRO-1 rank {rank}: {r['rows']} row(s), step {r['step_s']:.3f}"
            f" s (all-reduce and gathers {r['collective_s']:.3f} s in "
            f"{r['collective_calls']} calls, {r['collective_bytes']} bytes; "
            f"gloo through the host, 2 ranks on one card), moments "
            f"{r['moment_bytes']} bytes of {r['unsharded_bytes']} unsharded "
            f"({r['replicated_bytes']} kept whole), peak {r['peak_gib']:.2f} "
            f"GiB, loss {r['loss']:.6f}")
        if (r["moment_bytes"] > limit or r["rows"] != SHARD_BATCH // 2
                or not torch_equal(r["sums"], r0["sums"])
                or r["loss"] != r0["loss"]):
            bad.append(f"rank {rank}: moments {r['moment_bytes']} (limit "
                       f"{limit:.0f}), {r['rows']} rows, or its parameters "
                       "or loss unlike rank 0's")
        if any(r["launches"].values()):
            bad.append(f"rank {rank} launched kernels: fp32 training on "
                       "dense attention runs none")
    log(f"  ZeRO-1 against the single-process step: loss {r0['loss']:.6f} "
        f"(single {r0['single_loss']:.6f}, rel {r0['loss_rel']:.3e}; its "
        f"step {r0['single_step_s']:.3f} s alone on rank 0), "
        f"the parameters' update rel_l2 {r0['update_rel_l2']:.3e} (bound "
        f"{TRAIN_BOUND});"
        f" control without the gradients' mean {r0['no_all_reduce_rel_l2']:.3e}"
        + (" fails the bound" if r0["no_all_reduce_rel_l2"] > TRAIN_BOUND
           else " PASSES"))
    if r0["loss_rel"] > TRAIN_BOUND or r0["update_rel_l2"] > TRAIN_BOUND:
        bad.append(f"loss rel {r0['loss_rel']:.3e}, update "
                   f"{r0['update_rel_l2']:.3e}")
    if r0["no_all_reduce_rel_l2"] <= TRAIN_BOUND:
        bad.append("the control without the gradients' mean passes")
    if bad:
        raise Failure("ZeRO-1: " + "; ".join(bad))
    return line, _summed(r["launches"] for r in res)


# phase 7c: training on the mesh. The t and noise of its steps; the grads'
# control patches (the tp one keeps copy_to for the QK norms' weights)
MESH_TRAIN_SEED = 17


def _mesh_train_rank(mesh, cfg_kw, shard_path):
    """One rank of phase 7c: phase 7b's cut sft DiT (seeded as ZERO_SEED)
    on the loader's first batch, whole on both ranks, at one seeded t and
    noise. First the single-process gradients and step on this rank (the
    reference), then on the launch's (1, 1, 2) mesh and on a (1, 2, 1) mesh
    cut from the same two ranks: the whole gradients
    (``training.loss_and_gradients``), the same with the mesh's fault (tp:
    ``copy_to`` left out before the column-parallel linears; sp: an exit
    gather whose backward sums, as ``torch.distributed.nn``'s does), then
    one timed ``train_step_on`` with the groups' collective counters. Each
    comparison returns, per parameter, the squared difference and the
    squared reference summed over the rank's share, so that the parent can
    assemble the tp shares."""
    from unittest import mock

    import torch

    from kandinsky5_tpu_torch import training
    from kandinsky5_tpu_torch.config import DiTParams
    from kandinsky5_tpu_torch.data import LatentShardLoader
    from kandinsky5_tpu_torch.models import dit as dit_mod
    from kandinsky5_tpu_torch.models import nn as nn_mod
    from kandinsky5_tpu_torch.models.dit import fast_init_dit_params
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.parallel import ranks
    from kandinsky5_tpu_torch.parallel.sharding import (
        fast_init_dit_shard,
        shard_tensor,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sp_mesh = ranks.rank_mesh([0, 1], 1, 2, "gloo", mesh.device)
    dev = mesh.device
    cfg = DiTParams(**cfg_kw)
    opt = training.make_optimizer(lr=TRAIN_LR)
    loader = LatentShardLoader([shard_path], SHARD_BATCH, seed=0,
                               dtype=torch.float32, device=dev)
    first = list(loader.epoch(0))[0]
    batch = [first[k] for k in ("latents", "text_embeds", "pooled_embed",
                                "text_mask")]
    g = torch.Generator(device=dev).manual_seed(MESH_TRAIN_SEED)
    t = 1e-4 + (1.0 - 1e-4) * torch.rand(batch[0].shape[0], generator=g,
                                         device=dev)
    noise = torch.randn(batch[0].shape, generator=g, device=dev)

    def grads(state):
        _, gs = training.loss_and_gradients(state, cfg, *batch, t, noise,
                                            attn_impl="dense")
        names = [n for n, p in state.model.named_parameters()
                 if p.requires_grad]
        return dict(zip(names, gs))

    def named(model):
        return {n: p.detach().clone() for n, p in model.named_parameters()}

    _kernels.reset_launches()
    single = fast_init_dit_params(cfg, device=dev, dtype=torch.float32,
                                  seed=ZERO_SEED)
    init = named(single)
    state = training.init_train_state(single, opt)
    want = grads(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, single_loss = training.train_step_on(state, cfg, opt, *batch, t,
                                                noise, attn_impl="dense")
    single_loss = single_loss.item()
    single_s = time.perf_counter() - t0
    want_update = {n: p.detach() - init[n]
                   for n, p in single.named_parameters()}
    del single, state, init

    def sums(got, ref, tp):
        out = {}
        for n, x in got.items():
            w = ref[n] if tp is None else shard_tensor(n, ref[n], tp.rank,
                                                       tp.size)
            out[n] = (float((x - w).double().square().sum()),
                      float(w.double().square().sum()))
        return out

    def on_activations(x, group, _real=ranks.copy_to):
        return _real(x, group) if isinstance(x, torch.nn.Parameter) else x

    faults = {"tp": [(nn_mod, "copy_to", on_activations),
                     (dit_mod, "copy_to", on_activations)],
              "sp": [(dit_mod, "gather_whole", ranks.gather_along)]}
    out = dict(single_loss=single_loss, single_step_s=single_s)
    for name, m in (("tp", mesh), ("sp", sp_mesh)):
        model = fast_init_dit_shard(cfg, m, dtype=torch.float32,
                                    seed=ZERO_SEED)
        init = named(model)
        state = training.init_train_state(model, opt)
        res = {"grad": sums(grads(state), want, model.tp)}
        with contextlib.ExitStack() as stack:
            for mod, attr, fn in faults[name]:
                stack.enter_context(mock.patch.object(mod, attr, fn))
            res["control"] = sums(grads(state), want, model.tp)
        groups = {"tp": m.tp, "sp": m.sp}
        for grp in groups.values():
            if grp is not None:
                grp.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = training.train_step_on(state, cfg, opt, *batch, t,
                                             noise, attn_impl="dense")
        res["loss"] = loss.item()
        res["step_s"] = time.perf_counter() - t0
        res["update"] = sums({n: p.detach() - init[n]
                              for n, p in model.named_parameters()},
                             want_update, model.tp)
        res["collectives"] = {k: dict(grp.kinds) for k, grp in groups.items()
                              if grp is not None and grp.size > 1}
        res["tp_index"] = m.tp.rank
        out[name] = res
        del model, state, init
        torch.cuda.empty_cache()
    out["launches"] = dict(_kernels.LAUNCHES)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _assembled_rel(per_rank, key, tp: bool):
    """(rel_l2 over every parameter, the worst parameter's rel_l2) of the
    tp shares' sums assembled: a sharded parameter's sums added over the tp
    ranks, a replicated one's taken once."""
    from kandinsky5_tpu_torch.parallel.sharding import split_dim

    total, worst = [0.0, 0.0], 0.0
    for name in per_rank[0][key]:
        parts = [r[key][name] for r in per_rank]
        if not tp or split_dim(name) is None:
            parts = parts[:1]
        num, den = sum(p[0] for p in parts), sum(p[1] for p in parts)
        total[0] += num
        total[1] += den
        worst = max(worst, math.sqrt(num / den) if den else math.sqrt(num))
    return math.sqrt(total[0] / total[1]), worst


def phase_mesh_train(conf_sft, shard_path):
    """7c: training on the mesh, 2 gloo ranks sharing the card: phase 7b's
    sft DiT (full width, model_dim 1,792 and 28 heads, 2 text and 2 visual
    blocks, fp32, dense) on the loader's first batch, one step on a (1, 1,
    2) mesh and one on a (1, 2, 1) mesh (the 1,536 tokens of a 512 x 768
    image, 768 a rank), each against the single-process step at the same t
    and noise: the loss, the worst parameter's whole gradient (tp shares
    assembled) and the parameters' update within TRAIN_BOUND; controls that
    must fail the gradient bound: ``copy_to``'s backward all-reduce left out
    (tp), an exit gather whose backward sums (sp). Prints each mesh's
    s/step and its groups' all-reduce, all-gather and reduce-scatter
    seconds."""
    import dataclasses

    from kandinsky5_tpu_torch.parallel import launch

    cfg = dataclasses.replace(conf_sft.model.dit_params, num_text_blocks=2,
                              num_visual_blocks=2)
    t = time.perf_counter()
    res = launch(_mesh_train_rank, 2, "gloo", "cuda",
                 args=(dataclasses.asdict(cfg), shard_path), timeout=900)
    launch_s = time.perf_counter() - t
    line = dict(request="mesh training step", launch_s=launch_s,
                single_loss=res[0]["single_loss"],
                single_step_s=[r["single_step_s"] for r in res],
                peak_gib=[r["peak_gib"] for r in res])
    bad = []
    for name, shape in (("tp", (1, 1, 2)), ("sp", (1, 2, 1))):
        per = sorted((r[name] for r in res), key=lambda x: x["tp_index"])
        tp = name == "tp"
        grad_all, grad_worst = _assembled_rel(per, "grad", tp)
        _, ctl_worst = _assembled_rel(per, "control", tp)
        update, _ = _assembled_rel(per, "update", tp)
        losses = [p["loss"] for p in per]
        loss_rel = max(abs(v - line["single_loss"]) / abs(line["single_loss"])
                       for v in losses)
        kinds = {}
        for p in per:
            for grp, ks in p["collectives"].items():
                for kind, (calls, secs) in ks.items():
                    kinds.setdefault(f"{grp}_{kind}", []).append(
                        (calls, secs))
        line[name] = dict(mesh=shape, step_s=[p["step_s"] for p in per],
                          loss_rel=loss_rel, grad_rel_l2=grad_all,
                          grad_worst_rel_l2=grad_worst,
                          update_rel_l2=update,
                          control_grad_worst_rel_l2=ctl_worst,
                          collectives=kinds)
        fault = ("copy_to's backward all-reduce left out" if tp
                 else "the exit gather's backward summing")
        log(f"  {shape}: step {[round(p['step_s'], 3) for p in per]} s a "
            f"rank (single process {line['single_step_s'][0]:.3f} s); "
            + ", ".join(f"{k} {sum(s for _, s in v) / len(v):.3f} s in "
                        f"{v[0][0]} calls" for k, v in kinds.items())
            + f" a rank; loss rel {loss_rel:.3e}, gradients rel_l2 "
            f"{grad_all:.3e} (worst parameter {grad_worst:.3e}), update "
            f"rel_l2 {update:.3e} (bound {TRAIN_BOUND}); control ({fault}) "
            f"worst gradient {ctl_worst:.3e} "
            + ("fails the bound" if ctl_worst > TRAIN_BOUND else "PASSES"))
        if max(loss_rel, grad_worst, update) > TRAIN_BOUND:
            bad.append(f"{shape}: loss rel {loss_rel:.3e}, worst gradient "
                       f"{grad_worst:.3e}, update {update:.3e}")
        if ctl_worst <= TRAIN_BOUND:
            bad.append(f"{shape}: the control passes ({ctl_worst:.3e})")
        if len(set(losses)) != 1:
            bad.append(f"{shape}: the ranks' losses differ: {losses}")
    for rank, r in enumerate(res):
        if any(r["launches"].values()):
            bad.append(f"rank {rank} launched kernels: fp32 training on "
                       "dense attention runs none")
    if bad:
        raise Failure("mesh training: " + "; ".join(bad))
    return line, _summed(r["launches"] for r in res)


def phase_train(dev, conf5, built, out_dir, results):
    """Phase 7 (see the module's docstring). Returns the launches by run,
    the report and the readings."""
    import torch

    from kandinsky5_tpu_torch.config import CONFIG_DIR, load_config

    dit, vae, towers = built
    out_dir = os.path.join(out_dir, "training")
    os.makedirs(out_dir, exist_ok=True)
    log("  7.1 the encode against the CPU")
    readings, launches = phase_encode_reference(dev, vae)
    phase_encode_kernels(dev, results)
    log("  7.2 the encodes at full size")
    report, enc_launches = phase_full_encodes(dev, vae)
    launches.update(enc_launches)
    log("  7.3 the shard and the loader")
    batch, line, launches["7-shard"] = phase_shard(dev, conf5, built, out_dir)
    report.append(line)
    conf_sft = load_config(os.path.join(CONFIG_DIR, CONF5_SFT))
    log("  7.4 training against the CPU")
    ref, launches["7-train-reference"] = phase_train_reference(
        dev, conf_sft, batch)
    readings.update(ref)
    log("  7.5 training at full size")
    line, launches["7-train"] = phase_train_full(dev, conf_sft, batch,
                                                 out_dir)
    report.append(line)
    log("  7.6 the vision tower")
    report.append(phase_vision(dev))
    torch.cuda.empty_cache()
    log("  7.7 (7b) ZeRO-1 on two dp ranks")
    t = time.perf_counter()
    line, launches["7b-zero"] = phase_zero(
        conf_sft, os.path.join(out_dir, "shard0.npz"))
    line["phase_s"] = time.perf_counter() - t
    log(f"  7b {line['phase_s']:.1f} s")
    report.append(line)
    log("  7.8 (7c) training on the mesh: 2 ranks on (1, 1, 2) and (1, 2, 1)")
    t = time.perf_counter()
    line, launches["7c-mesh-train"] = phase_mesh_train(
        conf_sft, os.path.join(out_dir, "shard0.npz"))
    line["phase_s"] = time.perf_counter() - t
    log(f"  7c {line['phase_s']:.1f} s")
    report.append(line)
    return launches, report, readings


# ---------------------------------------------------------------------------
# phase 8: the released checkpoint layouts, written and loaded back with no
# transformers, tokenizers or safetensors
# ---------------------------------------------------------------------------

def phase_load(dev, conf5, out_dir, dit=None, vae=None) -> dict:
    """Phase 8: the seeded full-width 2B DiT and the VAE (phase 4's, or
    built here), Qwen2.5-VL cut to 2 layers at full width and CLIP ViT-L/14
    written in the released layouts into a temporary directory under
    ``out_dir`` (deleted after) and loaded back through
    ``get_T2V_pipeline`` (``tests/_torch_released.load_round_trip``), on a
    DiT forward of 3 x 32 x 48 latents (1,152 visual tokens)."""
    import shutil
    import tempfile

    import torch

    from kandinsky5_tpu_torch.models.dit import fast_init_dit_params
    from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE, init_vae_params
    from tests._torch_released import load_round_trip

    t0 = time.perf_counter()
    if dit is None:
        dit = fast_init_dit_params(conf5.model.dit_params, device=dev,
                                   dtype=torch.bfloat16, seed=0)
        vae = HunyuanVideoVAE(init_vae_params(device=dev, dtype=torch.bfloat16,
                                              seed=1))
    towers = seeded_text_embedder(dev, conf5.model.text_embedder, qwen_layers=2)
    cfg = conf5.model.dit_params
    g = torch.Generator().manual_seed(8)
    inputs = (torch.randn(1, 3, 32, 48, cfg.visual_embed_dim, generator=g),
              torch.randn(1, 64, cfg.in_text_dim, generator=g),
              torch.randn(1, cfg.in_text_dim2, generator=g))
    inputs = tuple(t.to(dev, torch.bfloat16) for t in inputs) + (
        torch.tensor([500.0], device=dev), (torch.arange(64) < 40)[None].to(dev))
    os.makedirs(out_dir, exist_ok=True)
    root = tempfile.mkdtemp(prefix="released_", dir=out_dir)
    try:
        out = load_round_trip(root, dit, vae, towers, conf5, dev, inputs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if out["faults"]:
        raise Failure("the load round trip: " + "; ".join(out["faults"]))
    del towers
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"  wrote {out['written_gb']:.2f} GB in {out['write_s']:.1f} s, loaded "
        f"{out['params']} parameters through get_T2V_pipeline in "
        f"{out['load_s']:.1f} s: every parameter, the DiT forward and the "
        f"text encode bit-equal; absent from sys.modules: "
        f"{', '.join(out['absent'])}; control (an offset changed): "
        f"{out['control']}; {out['seconds']:.1f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=int, default=1, choices=(1, 5, 10),
                    help="1 or 5: the 5 s path's video length (the 10 s path "
                    "answers 2 s); 10: the 10 s path answers 10 s (the 5 s "
                    "path 1 s)")
    ap.add_argument("--out", default="smoke_out",
                    help="directory for the written image and videos")
    ap.add_argument("--tp-seeds", default=None,
                    help="comma-separated seeds: build, then run only phase "
                    "5's tp forwards and controls with each seed's weights "
                    "and inputs, and print their readings (a study of "
                    "TP_BOUND; no smoke result)")
    ap.add_argument("--k1", action="store_true",
                    help="build, then run only phase 2's K1 cases and print "
                    "their readings (no smoke result)")
    ap.add_argument("--k4", action="store_true",
                    help="build, then run only phase 2's K4 cases and print "
                    "their readings (no smoke result)")
    ap.add_argument("--k6", action="store_true",
                    help="build, then run only phase 2's K6 cases and print "
                    "their readings (no smoke result)")
    ap.add_argument("--ff", action="store_true",
                    help="build, then run only phase 2's K2 (with its "
                    "modulation pass), K8 and T2-T4 cases and print their "
                    "readings (no smoke result)")
    ap.add_argument("--gemm", action="store_true",
                    help="build, then run only phase 2's T1, T2, K8, T3 and "
                    "T4 cases and print their readings (no smoke result)")
    ap.add_argument("--int8", action="store_true",
                    help="build, then run only phase 2's K5, K7 and T5 cases "
                    "and print their readings (no smoke result)")
    ap.add_argument("--text", action="store_true",
                    help="run only phase 3's text check and time the "
                    "full-size towers' encode and expansion, bf16 and int8 "
                    "(no kernel is built; no smoke result)")
    ap.add_argument("--serve", action="store_true",
                    help="build, then run only phase 6 (MagCache on and off, "
                    "resume, the HTTP server, the parity consumer) on "
                    "freshly built models and print its readings (no smoke "
                    "result)")
    ap.add_argument("--train", action="store_true",
                    help="build, then run only phase 7 (the encode, the "
                    "shard, training, the vision tower) on freshly built "
                    "models and print its readings (no smoke result)")
    ap.add_argument("--dp", action="store_true",
                    help="build, then run only phases 5a and 5b (dp serving "
                    "and dp x tp) with seeded stand-in text embeddings, and "
                    "print their readings (no smoke result)")
    ap.add_argument("--sp", action="store_true",
                    help="build, then run only phase 5c (8 ranks on the "
                    "(1, 2, 4) mesh: the full forward, the 10 s NABLA "
                    "forward, the controls and the image request) with "
                    "seeded stand-in text embeddings, and print its readings "
                    "(no smoke result)")
    ap.add_argument("--int8-mesh", action="store_true",
                    help="build, then run only phase 2's K5 and K7 cases at "
                    "a (1, 2, 4) rank's shape and phase 5d (8 ranks on the "
                    "(1, 2, 4) mesh: the W8A8 linears, the int8 forward and "
                    "image request, the sharded Qwen) with seeded stand-in "
                    "text embeddings, and print their readings (no smoke "
                    "result)")
    ap.add_argument("--serve-mesh", action="store_true",
                    help="build, then run only phase 5e (the server on 2 "
                    "ranks of the (1, 1, 2) mesh: batching, a seeded and "
                    "resumed request against the direct mesh call, an "
                    "error, the stop) and print its readings (no smoke "
                    "result)")
    ap.add_argument("--windows", action="store_true",
                    help="build, then run only phase 2's K3 window-maxima "
                    "cases (every instance, with the control) and print "
                    "their readings (no smoke result)")
    ap.add_argument("--load", action="store_true",
                    help="build, then run only phase 8 (the released "
                    "checkpoint layouts written and loaded back with no "
                    "transformers, tokenizers or safetensors) on a freshly "
                    "built DiT and VAE, and print its readings (no smoke "
                    "result)")
    ap.add_argument("--k3", action="store_true",
                    help="build, then run only phase 2's K3 cases (classes, "
                    "modes, ragged cases) and print their readings (no smoke "
                    "result)")
    args = ap.parse_args()
    seconds5 = 1 if args.seconds == 10 else args.seconds
    seconds10 = 10 if args.seconds == 10 else 2

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from kandinsky5_tpu_torch.config import CONFIG_DIR, load_config
        from kandinsky5_tpu_torch.ops import _kernels
        from kandinsky5_tpu_torch.tools import gpu_line
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    gpu = gpu_line()
    log(gpu)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t_all = time.perf_counter()
    if args.text:
        try:
            conf5 = load_config(os.path.join(CONFIG_DIR, CONF5))
            readings = {"reference": phase_text(dev, conf5),
                        "timings": text_timings(dev, conf5)}
        except Failure as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        log(gpu_line())
        log(json.dumps(readings))
        return 0
    try:
        log("phase 1: build")
        _kernels.build(force=True)
        info = _kernels.BUILD_INFO
        for line in info["log"].splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line or "Performance Loss" in line:
                log("  " + line.strip())
        log(f"  build {info['seconds']:.1f} s")
        _kernels.library()
        if args.tp_seeds:
            return tp_seed_study(dev, [int(v) for v in args.tp_seeds.split(",")])
        if args.k1:
            results = {}
            phase_k1(dev, *_seeded(dev), results)
            log(gpu_line())
            log(json.dumps({"K1_flash_fixed": results["K1_flash_fixed"]}))
            return 0 if all(r["ok"] for r in results["K1_flash_fixed"]) else 1
        if args.int8:
            results = {}
            phase_int8(dev, *_seeded(dev), results)
            log(gpu_line())
            log(json.dumps(results))
            return 0 if all(r["ok"] for rs in results.values() for r in rs) else 1
        if args.load:
            conf5 = load_config(os.path.join(CONFIG_DIR, CONF5))
            out = phase_load(dev, conf5, args.out)
            log(gpu_line())
            log(json.dumps(out))
            return 0
        if args.windows:
            results = {}
            phase_windows(dev, _seeded(dev)[0], results)
            log(gpu_line())
            log(json.dumps(results))
            return 0 if all(r["ok"] for rs in results.values() for r in rs) else 1
        if args.k3:
            results = {}
            phase_k3(dev, _seeded(dev)[0], results)
            log(gpu_line())
            log(json.dumps(results))
            return 0 if all(r["ok"] for rs in results.values() for r in rs) else 1
        if args.ff:
            results = {}
            g = _seeded(dev)[0]
            phase_k2(dev, g, results)
            phase_ff_tools(dev, g, results)
            log(gpu_line())
            log(json.dumps(results))
            return 0 if all(r["ok"] for rs in results.values() for r in rs) else 1
        if args.gemm:
            results = {}
            phase_gemm(dev, _seeded(dev)[0], results)
            log(gpu_line())
            log(json.dumps(results))
            return 0 if all(r["ok"] for rs in results.values() for r in rs) else 1
        if args.serve:
            conf5 = load_config(os.path.join(CONFIG_DIR, CONF5))
            built = build_models(dev, conf5)[:3]
            sv_launches, sv_report = phase_serving(dev, built, seconds10,
                                                   args.out)
            log(gpu_line())
            log(json.dumps({"launches": sv_launches, "requests": sv_report}))
            return 0
        if args.train:
            conf5 = load_config(os.path.join(CONFIG_DIR, CONF5))
            built = build_models(dev, conf5)[:3]
            results = {}
            t = time.perf_counter()
            tr_launches, tr_report, tr_readings = phase_train(
                dev, conf5, built, args.out, results)
            log(f"  phase 7 {time.perf_counter() - t:.1f} s")
            log(gpu_line())
            log(json.dumps({"launches": tr_launches, "requests": tr_report,
                            "readings": tr_readings, "kernels": results}))
            return 0
        if args.dp:
            conf5 = load_config(os.path.join(CONFIG_DIR, CONF5))
            dp_out = dp_alone(args.out, dev, conf5)
            log(gpu_line())
            log(json.dumps(dp_out))
            return 0
        if args.int8_mesh:
            results = {}
            phase_int8(dev, *_seeded(dev), results, cases=(INT8_RANK_CASE,),
                       t5=False)
            conf5 = load_config(os.path.join(CONFIG_DIR, CONF5))
            conf10 = load_config(os.path.join(CONFIG_DIR, CONF10))
            d_out = int8_mesh_alone(args.out, dev, conf5, conf10)
            log(f"  phase 5d {d_out['seconds']:.1f} s")
            log(gpu_line())
            log(json.dumps(dict(d_out, kernels=results)))
            return 0 if all(r["ok"] for rs in results.values()
                            for r in rs) else 1
        if args.serve_mesh:
            e_out = serve_mesh_alone(args.out)
            log(f"  phase 5e {e_out['seconds']:.1f} s")
            log(gpu_line())
            log(json.dumps(e_out))
            return 0
        if args.sp:
            conf5 = load_config(os.path.join(CONFIG_DIR, CONF5))
            conf10 = load_config(os.path.join(CONFIG_DIR, CONF10))
            sp_out = sp_alone(args.out, dev, conf5, conf10)
            log(f"  phase 5c {sp_out['seconds']:.1f} s")
            log(gpu_line())
            log(json.dumps(sp_out))
            return 0
        if args.k4 or args.k6:
            results = {}
            g, normed = _seeded(dev)
            if args.k4:
                phase_k4(dev, g, results)
            if args.k6:
                phase_k6(dev, g, normed, results)
            log(gpu_line())
            log(json.dumps(results))
            return 0 if all(r["ok"] for rs in results.values() for r in rs) else 1

        log("phase 2: kernels vs plain versions (bf16, main-path shapes)")
        t = time.perf_counter()
        results = {}
        phase_kernels(dev, results)
        log(f"  phase 2 {time.perf_counter() - t:.1f} s")

        conf5 = load_config(os.path.join(CONFIG_DIR, CONF5))
        conf10 = load_config(os.path.join(CONFIG_DIR, CONF10))
        log("phase 3: small-input reference (card kernels vs CPU plain, fp32)")
        t = time.perf_counter()
        phase_reference(dev, conf5)
        t_text = time.perf_counter()
        os.makedirs(args.out, exist_ok=True)
        text_ref = phase_text(dev, conf5, os.path.join(args.out, QWEN_REF))
        t_text = time.perf_counter() - t_text
        log(f"  phase 3 {time.perf_counter() - t:.1f} s (text towers "
            f"{t_text:.1f} s)")

        log("phase 4: pipeline at full width")
        t = time.perf_counter()
        launches, report, text_added, built = phase_pipeline(
            dev, conf5, conf10, seconds5, seconds10, args.out)
        log(f"  phase 4 {time.perf_counter() - t:.1f} s")
        log(f"  the text stage added {t_text + text_added:.1f} s to the run "
            f"(phase 3's text check {t_text:.1f} s; phase 4's towers, "
            f"encodes, expansions and offload request {text_added:.1f} s)")
        torch.cuda.empty_cache()

        log("phase 5: tensor and data parallelism, 2 and 4 ranks sharing the "
            "card (gloo)")
        t = time.perf_counter()
        tp_launches, tp_report = phase_tp(dev, conf5, seconds5,
                                                  args.out)
        launches.update(tp_launches)
        report += tp_report
        log(f"  phase 5 (tp) {time.perf_counter() - t:.1f} s")
        for sub, what, run in (
                ("5a", "dp serving: 2 ranks on (2, 1, 1)",
                 lambda: phase_dp(args.out)),
                ("5b", "dp x tp: 4 ranks on (2, 1, 2) over two emulated "
                 "hosts",
                 lambda: phase_dptp(dev, conf5)),
                ("5c-5d", "the sequence axis and int8 on the mesh: 8 ranks "
                 "on (1, 2, 4)",
                 lambda: phase_sp(dev, conf5, conf10, args.out)),
                ("5e", "serving on the mesh: 2 ranks on (1, 1, 2), rank 0 "
                 "the front end",
                 lambda: phase_serve_mesh(args.out))):
            log(f"phase {sub}: {what}")
            t = time.perf_counter()
            sub_launches, sub_report = run()
            launches.update(sub_launches)
            report += sub_report
            log(f"  phase {sub} {time.perf_counter() - t:.1f} s")

        log(f"phase 6: serving ({CONF5_SFT}: MagCache on and off, resume, "
            "the HTTP server, the parity consumer)")
        t = time.perf_counter()
        sv_launches, sv_report = phase_serving(dev, built, seconds10,
                                               args.out)
        launches.update(sv_launches)
        report += sv_report
        log(f"  phase 6 {time.perf_counter() - t:.1f} s")

        log("phase 7: the training path (the encode on K3 and K4, the shard, "
            "training, the vision tower)")
        t = time.perf_counter()
        tr_launches, tr_report, tr_readings = phase_train(
            dev, conf5, built, args.out, results)
        launches.update(tr_launches)
        report += tr_report
        log(f"  phase 7 {time.perf_counter() - t:.1f} s")

        log("phase 8: the released checkpoint layouts, written and loaded "
            "back with no transformers, tokenizers or safetensors")
        t = time.perf_counter()
        load_out = phase_load(dev, conf5, args.out, built[0], built[1])
        log(f"  phase 8 {time.perf_counter() - t:.1f} s")
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t_all:.1f} s")

    kernels = []
    for name, (source, replaces) in ROUTE_SOURCES.items():
        rs = results[name]
        h = rs[HEADLINE[name]]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": sum(n[name] for n in launches.values()),
                 "launches_by_path": {p: n[name] for p, n in launches.items()},
                 "on_path": name not in TOOLS,
                 "max_abs_err": max(r["max_abs"] for r in rs),
                 "ms": h["ms"], "plain_ms": h["plain_ms"],
                 "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
                 "library_ms": h["library_ms"], "shape": h["shape"]}
        if name == "T5_i8_decomp":
            # garbage outputs of any scale: the error relative to each
            # mode's largest plain output
            entry["max_abs_err"] = max(r["max_abs"] / r["scale"] for r in rs)
            entry["max_abs_err_is"] = "relative to the largest plain output"
        if h["yardstick_ms"] is not None:
            entry["yardstick_ms"] = h["yardstick_ms"]
            entry["yardstick"] = h["yardstick"]
        if name == "K6_sparse_nabla":
            entry["cases"] = [{k: r[k] for k in (
                "shape", "density", "ms", "plain_ms", "bound_ms",
                "library_ms", "k1_dense_ms", "tflops")} for r in rs]
        elif len(rs) > 1:
            entry["cases"] = [{k: r[k] for k in (
                "shape", "max_abs", "rel", "ms", "plain_ms", "bound_ms",
                "library_ms", "yardstick_ms") + tuple(
                    x for x in ("rel_l2_vs_k1", "max_abs_vs_k5", "tflops",
                                "bound_share", "factor", "bf16_k3_ms")
                    if x in r)}
                for r in rs]
        kernels.append(entry)
    log(gpu_line())
    log(json.dumps({"kernels": kernels, "requests": report,
                    "text_reference": text_ref, "training": tr_readings,
                    "load": load_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
