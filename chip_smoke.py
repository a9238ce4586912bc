#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, each of which must pass (any failure exits non-zero):
  1. device  -- CUDA present; the card's name and power limit from nvidia-smi;
  2. build   -- nvcc builds the CUDA kernels from the sources in this checkout
                (into src/repro_torch/kernels/_build/, one nvcc per source, all
                started together), Triton JITs its kernels; cuobjdump's SASS of
                the flash-attention library must show tensor-core instructions
                (HMMA) in every instance of the bf16 B1 kernels;
  3. kernels -- each kernel of the serving and training paths, at the paths'
                shapes, held against its plain PyTorch version on the card,
                and timed beside the plain version, a PyTorch library call and
                its bound (B1 also in TFLOP/s; B1 in bf16 rounds P and dS to
                bf16, so it is held, row by row and in the mean, to twice the
                error of the plain version that rounds at the same points).
                B4 runs as five passes: each is also held against its own
                plain version on the kernel's own inputs, and timed; so does
                B4's backward, the port's own kernel (fp32, six passes, at
                phase 11's shapes and with an initial state and dfinal, G 2
                and unaligned rows), which must also give the same bits
                twice.  B2
                logs its split plan (blocks a cluster, slots a block) and
                torch.profiler must see one call run exactly one kernel.
                B2's partial mode (fp32 output and log-sum-exp over one
                rank's slots) runs at the per-rank shapes of gemma3-1b's
                decode_32k and long_500k cells on the production mesh, and
                on one cache cut into 8 ranges (one keeping no slot) whose
                folded partials must equal B2 on the whole cache within its
                gate; B3a's external-statistic mode (the row statistics,
                then the scale, both ways) at mamba2-370m's gate-norm rows;
                h2o-danube's phase 12 case runs the forward only, as its path
                does; granite-34b's G 48 runs both ways at its serve and its
                training shape (phase 13), and so do one rank's heads of it at
                model 8 (G 6) and model 4 (G 12), B2 at G 6 and G 12 too;
  4. serve   -- gemma3-1b at full width (26 layers, vocab 262144, bf16, random
                weights from --seed) written to checkpoint DU files and served
                from them by DecodeEngine: 4 prompts of 520 tokens plus 24 new
                tokens, max_len 1024, so the 512-slot sliding-window ring wraps.
                Launch counters prove that every attention layer and every norm
                of every step went through the kernels; decode logits are held
                against the teacher-forced forward, which runs flash attention;
  5. train   -- h2o-danube-1.8b at full width (24 layers, d_model 2560, bf16,
                random weights from --seed) restored from checkpoint DU files:
                one eval, 4 AdamW steps with remat on one batch of 2 x 8192
                tokens, one more eval.  Launch counters prove that every
                attention and every norm, forward, recompute and backward, went
                through the kernels; the loss must fall;
  6. ssm     -- mamba2-370m and zamba2-1.2b at full width, cut of depth only
                to SSM_SERVE_LAYERS (8 of 48, 14 of 38) for time (random
                weights from --seed), served from checkpoint DU files by
                DecodeEngine: 4 prompts of 489 tokens plus 24 new tokens
                (512 fed tokens, two SSD chunks of 256).  Decode logits are
                held against the teacher-forced forward, which runs the SSD
                chunk-scan kernel in every mamba layer, at positions either
                side of the chunk boundary; layer 0's final SSM state against
                the engine's; then a 32768-token prefill of mamba2-370m at
                full depth (``forward(last_only=True)``, weights drawn on the
                card).  Launch counters prove every path's kernels ran;
  7. pilot   -- the Pilot-Data runtime on the card (one Session, two pods,
                two sim:// pilots, two mem:// Pilot-Data): h2o-
                danube-1.8b, at every width but cut to PILOT_TRAIN_LAYERS
                layers so that the host holds its checkpoint chain, trained by
                PilotTrainer as two train_chunk CUs of two steps (phase 5's
                batch and schedule), each restoring ckpt_{i-1} from a DU,
                streaming its shard DU and writing ckpt_i; each CU's launches
                must be the train step's times its steps, the last
                checkpoint's step 4, and an eval on one fixed batch lower with
                it than with ckpt_0.  Then gemma3-1b's weights saved once as a
                checkpoint DU and decoded by two serve CUs at once
                (DecodeEngine.from_cu_context), whose tokens must equal each
                other's and a direct engine's.  Every plain version raises
                while the CUs run.  CU times are broken down (queue, stage-in,
                restore, step loop, encode and write, publish);
  8. moe     -- granite-moe-3b-a800m at every published width (40 experts
                top-8, 24/8 heads: GQA group 3; bf16, random weights from
                --seed), cut of depth only to MOE_SERVE_LAYERS (16 of its 32)
                for the script's time, served from checkpoint DU files by
                DecodeEngine, once on the bf16 KV cache and once on the int8
                one: 4 prompts of 256 tokens plus 24 new, max_len 512.  Every
                plain version raises; the launches of B2, B3a and B1 are exact.
                Decode logits are held against the teacher-forced forward at
                the capacity factor E / k, whose capacity is T (it drops
                nothing, as decode at 4 tokens never does); the forward at the
                published factor 1.25 logs the pairs it drops;
  9. moe-train -- granite-moe-3b-a800m at every published width and depth,
                restored from checkpoint DU files with AdamW state on the
                device, trained on phase 5's batch and schedule, every plain
                version refused and the launches exact; then, cut to
                MOE_REMAT_LAYERS layers, the routing that remat recomputes in
                the backward pass must be the forward's and the gradients
                must equal those without remat;
 10. whisper -- whisper-large-v3 (32 encoder + 32 decoder layers, bf16, random
                weights and frames from --seed) from checkpoint DU files: the
                cross cache filled from 4 x 1500 frames, then DecodeEngine
                decodes 4 prompt tokens and 124 new (max_len 448), its logits
                held against the teacher-forced forward; then trained on 8 x
                448 tokens against 1500 frames each on phase 5's schedule.
                Every plain version raises, the launches are exact;
 11. ssm-train -- mamba2-370m and zamba2-1.2b at every published width and
                depth, restored from checkpoint DU files with AdamW state on the
                device, trained on 4 x 4096 tokens (train_4k's sequence length)
                on phase 5's schedule, every plain version refused and the
                launches exact: B4 forward, again for the mamba layers of the
                stacked groups (remat), and B4's backward once per mamba layer;
                then, cut to the smallest depth that holds SSM_REMAT_LAYERS
                layers, a stacked group and a tail, the remat gradients must
                equal those without remat bit for bit, and in fp32 every
                gradient leaf must be within SSM_PLAIN_GRAD_TOL of its max |g|
                of the same loss through the plain versions on the card;
 12. dense-serve -- the dense models at every published width, bf16, random
                weights from --seed, every plain version refused, the launches
                exact: h2o-danube-1.8b (24 layers, 32/8 heads of 80: B2 at D
                80) written to checkpoint DU files and served from them, 4
                prompts of 520 tokens plus 24 new, max_len 1024 (its 4096-slot
                window is longer, so the ring does not wrap here; phase 3 holds
                a wrapped one); granite-34b (48/1 heads of 128: MQA, B1 and B2
                at G 48) cut to DENSE_GRANITE_LAYERS of its 88 layers, its
                weights drawn on the card, 4 prompts of 256 plus 24 new.
                Decode logits, recorded as the engine runs and at its next
                step, are held against the teacher-forced forward (B1);
 13. dense-train -- granite-34b at every published width (48/1 heads of 128:
                B1 both ways at G 48; d_model 6144) cut to DENSE_TRAIN_LAYERS
                of its 88 layers, its weights drawn on the card, trained on
                phase 5's batch and schedule with every plain version refused
                and the launches exact; then, cut to DENSE_REMAT_LAYERS, the
                remat gradients must equal those without within one bf16 ulp
                of each leaf's max, and at 1 layer in fp32 every gradient leaf
                must be within SSM_PLAIN_GRAD_TOL of the plain versions'; then
                one layer's attention (layer 0's projections of a random input
                at phase 5's batch) for heads 0-5 and 0-11 over the one kv head
                (the G 6 and G 12 a rank holds at model 8 and model 4): out,
                lse and dQ must equal the G 48 run's heads bit for bit, dK and
                dV are held to the plain version by B1's rounding gate;
 14. dist-train -- the distributed layer (``repro_torch.distributed``) on
                the card: a one-rank NCCL process group and a (data 1,
                model 1) mesh; granite-moe-3b-a800m at every published
                width cut to DIST_LAYERS of its 32 layers, trained
                DIST_STEPS steps on phase 5's batch and schedule through the
                sharded step (params and AdamW state as DTensors of the
                sharding rules' specs, the kernels inside local_map regions,
                the MoE layers on the expert-parallel path, whose
                all_to_all_single exchanges are counted) with every plain
                version refused, launches exact and equal to the unsharded
                step's; loss, grad norm and every updated leaf held to the
                unsharded step's on the same weights and batch bit for bit;
                then the int8 compressed all-reduce (``compress_tree_psum``)
                over NCCL on the loss's gradient tree, twice (the second
                with the first's residual), held to its plain version
                (quantise, dequantise, the residual) bit for bit; then
                mamba2-370m at every width cut to DIST_SSM_LAYERS through the
                sharded step (the mixer head-parallel, its gate norm on B3a's
                external-statistic mode) on phase 11's batch, launches exact,
                held to the unsharded step within DIST_SSM_LOSS_TOL /
                DIST_SSM_GNORM_TOL and, in fp32, every gradient leaf within
                DIST_SSM_GRAD_TOL; and gemma3-1b at every width cut to
                DIST_DECODE_LAYERS, sharded on the mesh (its caches' slots
                split: B2's partial mode and the fold), decoding phase 4's
                prompts past its ring's wrap: tokens equal to the unsharded
                decode's, logits within phase 4's gates;
 15. dryrun  -- the launch layer (``repro_torch.launch``) against the card:
                the trained cells of phases 5, 9, 11 and 13 at their shapes,
                unsharded, on meta tensors under the op analyser: their kernel
                launches must be exactly ``train_launch_schedule``'s and their
                predicted step peaks within DRYRUN_PEAK_TOL of the peaks their
                phases measured; the roofline's step time is logged beside the
                measured s/step; phase 5's step, run once more on the card
                under the analyser, must count the FLOPs, bytes and launches
                of its meta run exactly; and DRYRUN_CELLS (granite-moe-3b-a800m
                and mamba2-370m x train_4k, gemma3-1b x decode_32k on the
                256-rank pod mesh; granite-34b x train_4k and prefill_32k on it
                and on the 512-rank multi-pod mesh) each run as ``python -m
                repro_torch.launch.dryrun`` on the fake production mesh in a
                process that sees no card, started at a lower CPU priority
                before phase 9 (they run beside phases 9-15), and must be OK,
                their peaks under 80 GB, within DRYRUN_TIMEOUT_S of phase 15's
                wait;
 16. report  -- one ``{"kernels": [...]}`` JSON line, then as the last line
                ``{"ok": true, "device": {...}}``.
``--profile`` adds torch.profiler breakdowns of eight decode steps (of each
served model; granite-moe's with its MoE layers' share), of one train step
of each trained model (granite-moe's with its MoE layers' share, and one MoE
layer's forward and backward timed alone; each SSM model's with B4 forward
and backward; granite-34b's with B1's backward split into its kernels;
phase 14's unsharded and sharded steps with their kernel counts and NCCL's
share) and of one mamba2-370m prefill.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

try:  # the H100 SXM's data-sheet figures have one home, the port's roofline
    from repro_torch.launch.roofline import BF16_FLOPS, FP32_FLOPS, TF32_FLOPS
    from repro_torch.launch.roofline import HBM_BW as HBM_BYTES_PER_S
except ImportError:  # no checkout beside this script: main() refuses to start
    BF16_FLOPS = FP32_FLOPS = TF32_FLOPS = HBM_BYTES_PER_S = None
BF16_ULP = 2.0**-7  # one bf16 ulp relative to the value (8 significant bits)

DEVICE = "cuda"
MODEL = "gemma3-1b"
PROMPT_LEN, NEW_TOKENS, MAX_LEN, BATCH = 520, 24, 1024, 4
CHECK_POSITIONS = (0, 511, 512, 543)
LOGIT_TOL = 5e-2  # max |decode - forward| over max(1, max |forward|)
LOGIT_MEAN_TOL = 1e-2  # mean |decode - forward| over the same scale

TRAIN_MODEL = "h2o-danube-1.8b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 8192, 4
TRAIN_LR, TRAIN_WARMUP = 1e-4, 2

SSM_MODELS = ("mamba2-370m", "zamba2-1.2b")
# phase 6 serves each model cut of depth only to these layers for time: its
# decode loops are host-bound (74 / 63 ms a step at full depth on a slow
# host, 139 s for the phase), and the script must stay under 600 s (a
# third of the depth since phase 15 came, mamba2-370m a sixth since phase
# 14's sharded decode came: 8 layers); the cut keeps every width, the
# chunk boundary, and zamba2's shared attention block (2 occurrences) and
# tail; the prefill runs at full depth
SSM_SERVE_LAYERS = {"mamba2-370m": 8, "zamba2-1.2b": 14}
SSM_PROMPT_LEN, SSM_NEW_TOKENS, SSM_MAX_LEN, SSM_BATCH = 489, 24, 512, 4
SSM_CHECK_POSITIONS = (0, 255, 256, 511)  # position 0 first; either side of the chunk boundary
STATE_TOL = 2e-2  # max |engine state - forward state| over max(1, max |forward state|)
# the bf16 engine against the bf16 forward once a state is carried (positions
# past 0): about twice the largest reading on the H100 (0.152 mamba2-370m,
# 0.180 zamba2-1.2b; means 1.44e-2 and 9.78e-3), so a gross fault still fails
SSM_BF16_LOGIT_TOL, SSM_BF16_LOGIT_MEAN_TOL = 0.3, 3e-2
PREFILL_MODEL, PREFILL_LEN = "mamba2-370m", 32768  # prefill_32k's length at batch 1

# phase 7: TRAIN_MODEL through PilotTrainer's train_chunk CUs (phase 5's batch,
# learning rate and schedule), two CUs of two steps and three checkpoint DUs;
# then MODEL through two serve CUs on the first tokens of phase 4's prompts
PILOT_STEPS, PILOT_CHUNK_STEPS = 4, 2
# The runtime holds a checkpoint DU up to seven times over in host memory at
# the chain's peak: each DU's staging buffer, ckpt_0's Pilot-Data (mem://),
# the pilot sandboxes (mem://) that a CU's output is sealed into and that the
# next CU may stage it into, and the seal's pass over the joined file stream.
# At 24 layers a checkpoint is 25.6 GB (bf16 params, fp32 m, v and masters),
# seven of which do not fit the ~103 GB of one H100 host; 8 layers (10.1 GB)
# do, and 2 (about 4.2 GB) keep the phase, whose time is the host's codec
# over those bytes, under two minutes and the script under 600 s (at 4
# layers, 6.2 GB, the phase took 134-155 s and the script 578-622 s).  The
# cut is of depth only: every width is h2o-danube-1.8b's.  The
# Pilot-Data are mem://: on a sharedfs:// one each 64 KiB chunk of a DU is a
# file, and a 12 GB checkpoint took 210 s to write and 95 s to read back.
PILOT_TRAIN_LAYERS = 2
PILOT_HOST_COPIES = 7
PILOT_SERVE_PROMPT_LEN, PILOT_SERVE_NEW_TOKENS, PILOT_SERVE_MAX_LEN = 16, 8, 64
PILOT_TIMEOUT_S = 900.0

# phase 8: granite-moe-3b-a800m served on the bf16 and the int8 KV cache, cut
# of depth only to MOE_SERVE_LAYERS of its 32 layers (its host-bound decode
# loops made room for phase 3's G 6 / G 12 cases and phase 15's granite-34b
# cells; None: every layer)
MOE_MODEL = "granite-moe-3b-a800m"
MOE_SERVE_LAYERS = 16
MOE_PROMPT_LEN, MOE_NEW_TOKENS, MOE_MAX_LEN, MOE_BATCH = 256, 24, 512, 4
MOE_CHECK_POSITIONS = (0, 127, 255, 278)  # the engine decodes positions 0-278
MOE_INT8_LOGIT_TOL = 0.05  # tests/test_moe_blocked.py's bound on the int8 cache
# phase 9: MOE_MODEL trained at every width and depth on phase 5's batch and
# schedule; the remat check (the routing recomputed in the backward pass is
# the forward's, and remat gradients equal those without remat) runs at
# MOE_REMAT_LAYERS of the 32 layers, since without remat every layer's
# activations stay live (~4 GB a layer at 2 x 8192 tokens)
MOE_REMAT_LAYERS = 4

# phase 10: whisper-large-v3 served (a prompt of 4 tokens fed one at a time
# and 124 new against 1500 frames, max_len 448: whisper's text context) and
# trained (8 x 448 tokens against 1500 frames each)
WHISPER_MODEL = "whisper-large-v3"
WHISPER_PROMPT_LEN, WHISPER_NEW_TOKENS, WHISPER_MAX_LEN, WHISPER_BATCH = 4, 124, 448, 4
WHISPER_CHECK_POSITIONS = (0, 3, 64, 127)  # 127: the engine's next step after generate
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ = 8, 448

# phase 3 shapes.  Flash attention: (label, B, S, Hq, Hkv, D, causal, window),
# S an int or (Sq, Sk); the first is the training path's, then gemma3-1b's
# teacher-forced forward of phase 4 (5 sliding-window layers : 1 global),
# and the other paths' shapes
FLASH_CASES = [
    ("h2o-danube train", 2, 8192, 32, 8, 80, True, 4096),
    ("gemma3-1b forward, window", 4, 544, 4, 1, 256, True, 512),
    ("gemma3-1b forward, global", 4, 544, 4, 1, 256, True, None),
    ("zamba2-1.2b forward, shared attention", 4, 512, 32, 32, 64, True, None),
    ("granite-moe forward", 4, 280, 24, 8, 64, True, None),  # phase 8's, G 3
    ("granite-moe train", 2, 8192, 24, 8, 64, True, None),  # phase 9's, G 3
    # phase 10's training batch: encoder, decoder self- and cross-attention
    ("whisper encoder", 8, 1500, 20, 20, 64, False, None),
    ("whisper decoder self", 8, 448, 20, 20, 64, True, None),
    ("whisper cross", 8, (448, 1500), 20, 20, 64, False, None),
    # phase 12's teacher-forced forwards
    ("h2o-danube serve forward", 4, 544, 32, 8, 80, True, 4096),
    ("granite-34b forward", 4, 280, 48, 1, 128, True, None),  # G 48, both ways
    ("granite-34b train", 2, 8192, 48, 1, 128, True, None),  # phase 13's, G 48
    # one rank's heads of granite-34b at model 8 (G 6) and model 4 (G 12):
    # phase 12's serve shape and phase 13's training batch
    ("granite-34b forward, G 6", 4, 280, 6, 1, 128, True, None),
    ("granite-34b forward, G 12", 4, 280, 12, 1, 128, True, None),
    ("granite-34b train, G 6", 2, 8192, 6, 1, 128, True, None),
    ("granite-34b train, G 12", 2, 8192, 12, 1, 128, True, None),
]
# cases whose path runs no backward: they are checked and timed forward only
FLASH_FORWARD_ONLY = ("h2o-danube serve forward",)
FLASH_FP32_CASES = [
    ("fp32 ragged", 2, 300, 8, 2, 80, True, 128),
    ("fp32 non-causal", 1, 200, 4, 1, 256, False, None),
    ("fp32 G 48 ragged", 1, 100, 48, 1, 128, True, 64),
    # granite-34b's serve and training shapes (phases 12 and 13)
    ("fp32 granite-34b forward", 4, 280, 48, 1, 128, True, None),
    ("fp32 granite-34b train", 2, 8192, 48, 1, 128, True, None),
    # and one rank's heads at model 8 and model 4
    ("fp32 granite-34b forward, G 6", 4, 280, 6, 1, 128, True, None),
    ("fp32 granite-34b forward, G 12", 4, 280, 12, 1, 128, True, None),
    ("fp32 granite-34b train, G 6", 2, 8192, 6, 1, 128, True, None),
    ("fp32 granite-34b train, G 12", 2, 8192, 12, 1, 128, True, None),
]
# RMSNorm forward: (rows, D).  gemma3-1b's width (4 rows: a decode step at
# batch 4), then phase 6's: mamba2-370m's d_model 1024 and gate norm 2048,
# zamba2-1.2b's d_model 2048 and gate norm 4096, at a decode step (4 rows), a
# forward of 4 x 511 tokens (2044) and the mamba2 prefill (32768); then
# h2o-danube-1.8b's training batch (2 x 8192 rows of 2560), and the later
# phases' widths at their own rows.  Triton builds
# one program for each width.  The residual variant runs on no path: it is
# held at gemma3-1b's width only
RMSNORM_CASES = [(4, 1152), (8, 1152), (4096, 1152),
                 (4, 1024), (2044, 1024), (32768, 1024),
                 (4, 2048), (2044, 2048), (32768, 2048),
                 (4, 4096), (2044, 4096), (16384, 2560),
                 (4, 1536), (1120, 1536),  # granite-moe: a decode step, phase 8's forward
                 (16384, 1536),  # granite-moe training (phase 9)
                 # whisper (phase 10): a decode step, the serve forward's decoder
                 # (4 x 128) and encoder (4 x 1500) and the training batch's
                 # decoder (8 x 448) and encoder (8 x 1500)
                 (4, 1280), (512, 1280), (6000, 1280), (3584, 1280), (12000, 1280),
                 # phase 12: a decode step and the teacher-forced forward of
                 # h2o-danube-1.8b (4 x 544) and granite-34b (4 x 280); phase
                 # 13's granite-34b training batch (2 x 8192)
                 (4, 2560), (2176, 2560), (4, 6144), (1120, 6144), (16384, 6144)]
RMSNORM_RESIDUAL_CASES = [(4, 1152), (8, 1152), (4096, 1152)]
# RMSNorm backward: (rows, D); 16384 rows is the training batch, 4 a decode
# step's, 2176 x 1152 gemma3-1b's forward; then phase 9's and phase 10's
# training batches (whisper's decoder, then its encoder), and phase 13's
# (granite-34b's d_model 6144, whose fp32 rows fit 3 pipeline stages)
RMSNORM_BWD_CASES = [(16384, 2560), (4, 2560), (2176, 1152),
                     (16384, 1536), (3584, 1280), (12000, 1280), (16384, 6144)]
# decode attention: (label, B, slots, Hq, Hkv, D, window, position); the first
# is gemma3-1b's SWA ring wrapped at the last position of the serve phase
DECODE_CASES = [
    ("gemma3-1b ring", 4, 512, 4, 1, 256, 512, 543),
    ("gemma3-1b ring", 8, 512, 4, 1, 256, 512, 543),
    ("gemma3-1b global", 4, 1024, 4, 1, 256, None, 543),
    ("gemma3-1b global", 8, 1024, 4, 1, 256, None, 543),
    ("zamba2-1.2b shared attention", 4, 512, 32, 32, 64, None, 511),
    # granite-moe-3b-a800m (G 3) at phase 8's last decode step
    ("granite-moe", 4, 512, 24, 8, 64, None, 278),
    ("granite-moe", 8, 512, 24, 8, 64, None, 278),
    # whisper-large-v3 at phase 10's last decode step: the self cache, and
    # the cross cache, whose query and slots are all at position 0 (None)
    ("whisper self", 4, 448, 20, 20, 64, None, 127),
    ("whisper cross", 4, 1500, 20, 20, 64, None, None),
    # phase 12: h2o-danube-1.8b (D 80) at its last decode step over the
    # 1024-slot cache, and its 4096-slot window ring wrapped; granite-34b
    # (48/1 heads: G 48) at its last decode step
    ("h2o-danube serve", 4, 1024, 32, 8, 80, 4096, 543),
    ("h2o-danube ring wrapped", 4, 4096, 32, 8, 80, 4096, 4700),
    ("granite-34b", 4, 1024, 48, 1, 128, None, 279),
    ("granite-34b", 8, 1024, 48, 1, 128, None, 279),
    # one rank's heads of granite-34b at model 8 (G 6) and model 4 (G 12):
    # no path reaches them yet (the sharded decode gathers q over the heads'
    # split and runs G 48), so phase 3 alone holds them
    ("granite-34b G 6", 4, 1024, 6, 1, 128, None, 279),
    ("granite-34b G 6", 8, 1024, 6, 1, 128, None, 279),
    ("granite-34b G 12", 4, 1024, 12, 1, 128, None, 279),
    ("granite-34b G 12", 8, 1024, 12, 1, 128, None, 279),
]
# SSD chunk scan: (label, B, S, H, P, N, G, dtype, initial state); the timed
# cases are the mamba2 prefill and the phase 6 forwards, the edge cases are
# only held against the plain version (the last one seeds the state pass and
# walks the prefill's 128 chunks)
SSD_CASES = [
    ("mamba2-370m prefill", 1, 32768, 32, 64, 128, 1, "float32", False),
    ("mamba2-370m forward", 4, 512, 32, 64, 128, 1, "float32", False),
    ("zamba2-1.2b forward", 4, 512, 64, 64, 64, 1, "float32", False),
]
SSD_EDGE_CASES = [
    ("S < chunk", 2, 100, 8, 64, 128, 1, "float32", False),
    ("G 2", 2, 512, 8, 64, 64, 2, "float32", False),
    ("initial state", 2, 512, 8, 64, 128, 1, "float32", True),
    ("bf16 inputs", 2, 512, 8, 64, 128, 1, "bfloat16", False),
    ("initial state, 128 chunks", 1, 32768, 4, 64, 128, 1, "float32", True),
]
SSD_CHUNK = 256
# B2's partial mode at the per-rank shapes the sharding rules give these
# cells on the production (32, 8) mesh (the dry run's), each cache length's
# range of the mesh's last rank at the dry run's decode position
DECODE_PARTIAL_CELLS = [("gemma3-1b", "decode_32k"), ("gemma3-1b", "long_500k")]
# and one gemma3-1b global cache cut into 8 ranges at position 800 (the
# last range holds only slots never written: no kept slot), the ranges'
# partials folded and held to B2 on the whole cache: (B, slots, Hq, Hkv, D,
# position, ranges)
DECODE_FOLD_CASE = (4, 1024, 4, 1, 256, 800, 8)
# B3a's external-statistic mode: (rows, local columns, row width):
# mamba2-370m's gate norm on phase 14's training rows (4 x 4096) whole (one
# rank), and one rank's 256 columns of its 2048 at model 8
RMSNORM_EXT_CASES = [(16384, 2048, 2048), (16384, 256, 2048)]
# SSD backward (B4's backward, fp32): (label, B, S, H, P, N, G, chunk, initial
# state, dfinal, unaligned rows); the timed cases are phase 11's training
# shapes, the edge cases are only held against the plain version: an initial
# state with a gradient of the final state, G 2, and x and dy as views whose
# rows lie 65 elements apart in a ragged chunk of 100 (two 64-row tiles)
SSD_BWD_CASES = [
    ("mamba2-370m train", 4, 4096, 32, 64, 128, 1, 256, False, False, False),
    ("zamba2-1.2b train", 4, 4096, 64, 64, 64, 1, 256, False, False, False),
]
SSD_BWD_EDGE_CASES = [
    ("initial state, dfinal", 2, 512, 8, 64, 128, 1, 256, True, True, False),
    ("G 2", 2, 512, 8, 64, 64, 2, 256, False, True, False),
    ("unaligned rows, chunk 100", 2, 300, 4, 64, 128, 1, 100, True, True, True),
]

# phase 12: dense models served at every width, batch DENSE_BATCH, max_len
# DENSE_MAX_LEN: (model, layers (None: every layer), weights through
# checkpoint files (else drawn on the card), prompt length, new tokens, the
# positions whose decode logits are held against the forward (the last one
# is the engine's next step after generate)).  granite-34b is cut to
# DENSE_GRANITE_LAYERS of its 88 layers: at full depth its 47.25 B params
# (SwiGLU) are 94.5 GB of bf16, beyond the card's 80 GB, and drawing a
# stacked [L, 6144, 24576] MLP leaf takes two fp32 temporaries of its size
# (2 x 14.5 GB at 24 layers).  The cut is of depth only
DENSE_GRANITE_LAYERS = 24
DENSE_MODELS = [
    ("h2o-danube-1.8b", None, True, 520, 24, (0, 511, 519, 543)),
    ("granite-34b", DENSE_GRANITE_LAYERS, False, 256, 24, (0, 127, 255, 279)),
]
DENSE_BATCH, DENSE_MAX_LEN = 4, 1024

# phase 13: DENSE_TRAIN_MODEL trained at every width on phase 5's batch and
# schedule, its weights drawn on the card, cut to DENSE_TRAIN_LAYERS of its
# 88 layers: at 4 layers its 2.72 B params (2.12 B in the layers, 0.60 B in
# the untied embed and unembed) take 43.6 GB at 16 bytes a param (bf16
# weights and gradients, fp32 masters, m and v), plus the remat activations
# of 2 x 8192 tokens (a 49.7 GiB peak on the H100); each more layer adds
# 8.5 GB, so 6 layers is the most that leaves room.  The cut is of depth only.  The remat check runs at DENSE_REMAT_LAYERS layers
# (without remat every layer's activations stay live), the fp32 plain-version
# check (SSM_PLAIN_GRAD_TOL) at 1 layer on DENSE_PLAIN_SEQ tokens of the
# batch's first row
DENSE_TRAIN_MODEL = "granite-34b"
DENSE_TRAIN_LAYERS = 4
DENSE_REMAT_LAYERS = 2
DENSE_PLAIN_SEQ = 1024
# and one layer's attention for the q heads one rank holds at model 8 and
# model 4 (granite-34b's 48 heads: G 6 and G 12) against all 48
RANK_LOCAL_GROUPS = (6, 12)

# phase 11: SSM_MODELS trained at every width and depth on train_4k's
# sequence length (repro/configs/base.py), cut from its 256 sequences to 4
# so that a step fits the run's time, on phase 5's schedule; the remat and
# plain-version checks at the smallest depth that holds SSM_REMAT_LAYERS
# layers, a whole stacked group and a tail
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ = 4, 4096
# phase 14: MOE_MODEL at every width, cut of depth only to DIST_LAYERS of its
# 32 layers for time, through the sharded train step at world size 1
DIST_MODEL = "granite-moe-3b-a800m"
DIST_LAYERS = 8
DIST_STEPS = 3

# phase 14 also: DIST_SSM_MODEL at every width, cut of depth only to
# DIST_SSM_LAYERS of its 48 layers, through the sharded step (its mixer
# head-parallel, the gate norm on B3a's external-statistic mode) on phase
# 11's batch, held to the unsharded step within DIST_SSM_LOSS_TOL (loss and
# CE) and DIST_SSM_GNORM_TOL (grad norm), relative: bf16 rounding of the gate
# norm's output, whose statistic the two sum in another order; and in fp32 at
# DIST_SSM_GRAD_LAYERS layers on DIST_SSM_GRAD_SEQ tokens every gradient
# leaf within DIST_SSM_GRAD_TOL of its max |g|
DIST_SSM_MODEL = "mamba2-370m"
DIST_SSM_LAYERS = 8
DIST_SSM_LOSS_TOL, DIST_SSM_GNORM_TOL = 2e-3, 2e-2
DIST_SSM_GRAD_LAYERS, DIST_SSM_GRAD_SEQ, DIST_SSM_GRAD_TOL = 2, 1024, 1e-4
# and DIST_DECODE_MODEL at every width, cut of depth only to
# DIST_DECODE_LAYERS (one 5 swa : 1 global group), sharded on the (1, 1)
# mesh (its caches' slots split over model: B2's partial mode and the fold),
# decoding phase 4's prompts past the 512-slot ring's wrap: its tokens equal
# the unsharded decode's, its logits within phase 4's gates
DIST_DECODE_MODEL = "gemma3-1b"
DIST_DECODE_LAYERS = 6

# phase 15: the production cells (arch, shape, on the 512-rank multi-pod
# mesh rather than the 256-rank pod mesh) run in subprocesses on the fake
# mesh, without a card, started before phase 9 at a lower CPU priority than
# this process; phase 15 waits at most DRYRUN_TIMEOUT_S for them.  granite-34b's
# cells take B1 at G 6 (model 8 on both meshes).  Each trained cell's
# predicted step peak is within DRYRUN_PEAK_TOL of the one its phase measured
DRYRUN_CELLS = [("granite-moe-3b-a800m", "train_4k", False), ("mamba2-370m", "train_4k", False),
                ("gemma3-1b", "decode_32k", False),
                ("granite-34b", "train_4k", False), ("granite-34b", "prefill_32k", False),
                ("granite-34b", "train_4k", True), ("granite-34b", "prefill_32k", True)]
DRYRUN_TIMEOUT_S = 120.0
DRYRUN_NICE = 10  # the cells' CPU priority below this process's
DRYRUN_PEAK_TOL = 0.10

SSM_REMAT_LAYERS = 4
SSM_PLAIN_GRAD_TOL = 1e-3  # fp32 kernels against fp32 plain versions, of a leaf's max |g|

DECODE_SRC = "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu"
FLASH_SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
RMSNORM_SRC = "src/repro_torch/kernels/rmsnorm/rmsnorm.py"
SSD_SRC = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
SSD_BWD_SRC = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu"


def sync(torch) -> None:
    torch.cuda.synchronize()


def log(msg: str) -> None:
    print(msg, flush=True)


# a function whose first timed launch takes longer than LONG_MS (a plain
# version at a training shape: 0.1-0.5 s) is timed over LONG_ITERS launches
LONG_MS, LONG_ITERS = 50.0, 5


class Timer:
    """Per-launch device time with CUDA events, the median of ``iters``
    launches (LONG_ITERS for a function slower than LONG_MS); a 512 MiB
    buffer is rewritten before every launch so that each finds the L2 cache
    cold, as the serving path does (its weights stream through L2 between
    layers)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 * 2**20, dtype=torch.int32, device=DEVICE)

    def __call__(self, fn, iters: int = 30, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        sync(self.torch)
        probe = self.launches(fn, 1)
        if probe[0] > LONG_MS:
            return statistics.median(probe + self.launches(fn, LONG_ITERS - 1))
        return statistics.median(self.launches(fn, iters))

    def launches(self, fn, n: int) -> list:
        """ms of each of ``n`` launches, enqueued back to back."""
        torch = self.torch
        ev = [
            (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            for _ in range(n)
        ]
        for start, end in ev:
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        sync(torch)
        return [s.elapsed_time(e) for s, e in ev]


def bound_ms(n_bytes: float, flops: float, peak_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, out, ref, rtol, atol):
    """Max |out - ref|; raises unless |out - ref| <= atol + rtol * |ref|
    everywhere."""
    o, r = out.float(), ref.float()
    if o.shape != r.shape or not bool(o.isfinite().all()):
        raise AssertionError(f"{name}: shape {tuple(o.shape)} vs {tuple(r.shape)} or non-finite")
    diff = (o - r).abs()
    bad = diff > atol + rtol * r.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements beyond rtol={rtol} atol={atol}; "
            f"max |diff| {diff.max().item():.3e}"
        )
    return diff.max().item()


def check_rounded(name, out, ref, ref_p):
    """The gate of a kernel that rounds inside (B1 bf16 rounds P and dS to
    bf16 as tensor-core operands), against ``ref``, the fp32 plain version,
    and ``ref_p``, the fp32 plain version rounding at the kernel's points:
    ``rounding_ratios`` (per row, the error beyond the output's own rounding
    within 2 x the row's error of ``ref_p`` + 1e-5 x max(1, max|row|); and
    the mean error within 2 x ``ref_p``'s) at most 1.  Returns
    (max |out - ref|, row ratio, mean ratio)."""
    from repro_torch.kernels.flash_attention.ref import rounding_ratios

    o, r = out.float(), ref.float()
    if o.shape != r.shape or not bool(o.isfinite().all()):
        raise AssertionError(f"{name}: shape {tuple(o.shape)} vs {tuple(r.shape)} or non-finite")
    row, mean = rounding_ratios(out, ref, ref_p)
    if row > 1 or mean > 1:
        raise AssertionError(f"{name}: row ratio {row:.3f}, mean ratio {mean:.3f} beyond 1 (the "
                             "error of the plain version that rounds P and dS where it does)")
    return (o - r).abs().max().item(), row, mean


# ------------------------------------------------------------ phase 1
def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# ------------------------------------------------------------ phase 2
def phase_build(torch):
    from repro_torch.kernels import build
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_bwd

    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.load(name)
    nvcc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = torch.randn(4, 1152, device=DEVICE, dtype=torch.bfloat16)
    w = torch.zeros(1152, device=DEVICE, dtype=torch.bfloat16)
    for dtype in (torch.bfloat16, torch.float32):
        rmsnorm(x.to(dtype), w)
        rmsnorm(x.to(dtype), w, residual=x.to(dtype))
        rmsnorm_bwd(x.to(dtype), x.to(dtype), w.to(dtype))
    sync(torch)
    triton_s = time.perf_counter() - t0
    log(f"build: nvcc {nvcc_s:.2f} s for {sorted(build.SOURCES)} (ptxas register and "
        f"spill report in {build.BUILD_DIR.relative_to(ROOT)}/*.log), "
        f"triton JIT {triton_s:.2f} s")
    check_no_spills(build, "ssd_scan_bwd")
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.library_path("flash_attention"))],
                          check=True, capture_output=True, text=True, timeout=300).stdout
    check_tensor_cores(mma_counts(sass))


def check_no_spills(build, name: str) -> None:
    """Logs the registers and spills ptxas reports for each kernel of source
    ``name``, and fails if any kernel spills."""
    report = build.ptxas_report(build.library_path(name).with_suffix(".log").read_text())
    if not report:
        raise AssertionError(f"build: no ptxas report for {name}")
    log(f"build: {name} ptxas: " + ", ".join(
        f"{fn[-40:]} {regs} registers, {st}/{ld} bytes spilled"
        for fn, (regs, st, ld) in sorted(report.items())))
    spilled = [fn for fn, (_, st, ld) in report.items() if st or ld]
    if spilled:
        raise AssertionError(f"build: {name} spills in {spilled}")


# the bf16 B1 kernels, which must run on the tensor cores
TENSOR_CORE_KERNELS = ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel", "flash_bwd_dkv_mma_kernel")


def mma_counts(sass: str) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) per function of a
    ``cuobjdump -sass`` listing, by the function's (mangled) name."""
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    return counts


def check_tensor_cores(counts: dict) -> None:
    """Raises unless every instance of every bf16 B1 kernel has tensor-core
    instructions; logs the count of each."""
    for base in TENSOR_CORE_KERNELS:
        found = {fn: n for fn, n in counts.items() if base in fn}
        if not found:
            raise AssertionError(f"SASS: no instance of {base} in the flash_attention library")
        for fn, n in sorted(found.items()):
            log(f"build: SASS {n} HMMA/HGMMA in {fn}")
            if n == 0:
                raise AssertionError(f"SASS: {fn} has no tensor-core instruction")


def counters():
    """(kernel name, wrapper, attribute) of every launch counter."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    return [
        ("decode_attention", dec_ops.decode_attention, "launches"),
        ("rmsnorm", norm_ops.rmsnorm, "launches"),
        ("rmsnorm_residual", norm_ops.rmsnorm, "residual_launches"),
        ("flash_attention", fa_ops.flash_attention, "launches"),
        ("flash_attention_bwd", fa_ops.flash_attention, "backward_launches"),
        ("rmsnorm_bwd", norm_ops.rmsnorm, "backward_launches"),
        ("ssd_scan", ssd_ops.ssd, "launches"),
        ("ssd_scan_bwd", ssd_ops.ssd, "backward_launches"),
        ("decode_attention_partial", dec_ops.decode_attention, "partial_launches"),
        ("rmsnorm_stat", norm_ops.rmsnorm, "stat_launches"),
        ("rmsnorm_ext", norm_ops.rmsnorm, "ext_launches"),
        ("rmsnorm_ext_bwd", norm_ops.rmsnorm, "ext_backward_launches"),
    ]


def reset_counts() -> None:
    for _, fn, attr in counters():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, fn, attr in counters()}


# ------------------------------------------------------------ phase 3
PROFILE_MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep
PROFILE_ATTEMPTS = 4


def device_kernels(torch, fn) -> list:
    """The names of the device kernels that one call of ``fn`` runs, as
    torch.profiler records them (memory copies and fills count too).

    A trace can come back with no device activity at all, and an empty list
    would then say nothing of ``fn``. So a marker kernel runs just before and
    just after ``fn``: a trace that lacks either marker recorded nothing of
    the device and is taken again, up to PROFILE_ATTEMPTS times; a trace that
    holds both is read, without the markers."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1)  # load the marker's kernel before any trace
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        sync(torch)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            fn()
            torch.cuda._sleep(1)
            sync(torch)
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        markers = [n for n in names if PROFILE_MARKER in n]
        if len(markers) == 2:
            return [n for n in names if PROFILE_MARKER not in n]
        log(f"kernels: trace {attempt} of {PROFILE_ATTEMPTS} holds {len(markers)} of its 2 "
            f"marker kernels ({len(names)} device events); tracing again")
    raise AssertionError(f"torch.profiler recorded no device activity in {PROFILE_ATTEMPTS} "
                         "traces, so the device kernels of one call are unknown")


def decode_plan(torch, ops, b, hkv, sk, d, g) -> dict:
    """B2's launch for a call: its split plan, and how many clusters of it
    the card holds at once with each block's shared memory (bf16)."""
    n_split, split_len = ops.split_plan(b, hkv, sk, ops.device_sms(torch.device(DEVICE)))
    clusters, smem = ops.occupancy(torch.bfloat16, d, g, n_split)
    return dict(n_split=n_split, split_len=split_len, max_active_clusters=clusters,
                smem_bytes=smem)


def decode_cases(torch, timer, gen):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    cases = []
    for label, b, sk, hq, hkv, d, window, pos in DECODE_CASES:
        plan = decode_plan(torch, ops, b, hkv, sk, d, hq // hkv)
        log(f"kernels: decode_attention {label} B={b} Sk={sk} {hq}/{hkv}x{d}: split plan "
            f"n_split {plan['n_split']} (a cluster of {plan['n_split']} blocks) x split_len "
            f"{plan['split_len']}; {plan['max_active_clusters']} such clusters fit at once, "
            f"{plan['smem_bytes']} bytes of shared memory a block (bf16)")
        for dtype in (torch.bfloat16, torch.float32):
            def rnd(*shape):
                return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)

            q, k, v = rnd(b, 1, hq, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d)
            if pos is None:  # cross-attention: the query and every slot at position 0
                pos_k = torch.zeros((1, sk), device=DEVICE, dtype=torch.int32).expand(b, sk)
                pos_q = torch.zeros((b,), device=DEVICE, dtype=torch.int32)
            else:
                slots = torch.arange(sk, device=DEVICE, dtype=torch.int32)
                pos_k = (pos - torch.remainder(pos - slots, sk))[None].expand(b, sk)
                pos_q = torch.full((b,), pos, device=DEVICE, dtype=torch.int32)
            out = ops.decode_attention(q, k, v, pos_q, pos_k, window=window)
            ref = decode_attention_ref(q[:, 0], k, v, pos_q, pos_k, window=window)[:, None]
            sync(torch)
            rtol = BF16_ULP if dtype == torch.bfloat16 else 1e-4
            name = f"decode_attention {label} B={b} Sk={sk} {hq}/{hkv}x{d}"
            err = check_close(f"{name} {dtype}", out, ref, rtol, 1e-5)
            if dtype != torch.bfloat16:
                log(f"kernels: {name} fp32 max|err| {err:.2e} (rtol 1e-4, atol 1e-5)")
                continue
            dpos = pos_q[:, None] - pos_k
            valid = (pos_k >= 0) & (dpos >= 0)
            if window is not None:
                valid &= dpos < window
            n_valid = int(valid.sum())
            mask = valid[:, None, None, :]
            names = device_kernels(torch, lambda: ops.decode_attention(
                q, k, v, pos_q, pos_k, window=window))
            if len(names) != 1 or "decode_attention_kernel" not in names[0]:
                raise AssertionError(f"{name}: one call ran the device kernels {names}, "
                                     "not the one decode_attention_kernel")
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            ms = timer(lambda: ops.decode_attention(q, k, v, pos_q, pos_k, window=window))
            plain = timer(lambda: decode_attention_ref(q[:, 0], k, v, pos_q, pos_k, window=window))
            lib = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))
            cost = ops.cost(b, sk, hq, hkv, d, n_valid)  # the rows that the mask keeps
            bound, by = bound_ms(cost.bytes, cost.ops, cost.peak)
            # the kernel multiplies on the CUDA cores in fp32: its own ceiling
            fp32_ms = cost.flops / FP32_FLOPS * 1e3
            cases.append(dict(case=label, B=b, Sk=sk, Hq=hq, Hkv=hkv, D=d, window=window,
                              pos=pos, dtype="bfloat16", plan=plan, device_kernels=names,
                              ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                              bound_by=by, max_abs_err=err))
            log(f"kernels: {name} bf16 window={window} pos={pos}: "
                f"{ms:.4f} ms (plain {plain:.4f}, sdpa {lib:.4f}, bound {bound:.4f} by {by}; "
                f"bytes {cost.bytes / HBM_BYTES_PER_S * 1e3:.4f}, ops at the fp32 CUDA-core "
                f"rate {fp32_ms:.4f}), max|err| {err:.2e} (rtol 2^-7, atol 1e-5)")
    return cases


def decode_partial_shapes() -> list:
    """(label, B, local slots, slots, first slot, Hq, Hkv, D, window,
    position) of B2's partial mode at DECODE_PARTIAL_CELLS' per-rank shapes:
    each distinct cache length as ``cache_specs`` places it on the
    production (32, 8) mesh (batch over data, slots over data and model
    where the batch does not divide), the range of the mesh's last rank,
    at the dry run's decode position (seq_len - 1)."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.distributed import DistContext, cache_specs
    from repro_torch.launch import AbstractMesh, production_layout
    from repro_torch.launch.dryrun import PER_HOST, WORLD
    from repro_torch.models import build_model
    from repro_torch.models.transformer import _kind_window

    dims, axes = production_layout(WORLD, PER_HOST, False)
    ctx = DistContext(AbstractMesh(dims, axes), tuple(a for a in axes if a != "model"))
    size = dict(zip(axes, dims))

    def ways(entry):
        names = (entry,) if isinstance(entry, str) else (entry or ())
        return math.prod(size[a] for a in names)

    out = []
    for arch, shape_name in DECODE_PARTIAL_CELLS:
        cfg, shape = get_config(arch), get_shape(shape_name)
        cache = build_model(cfg, device="meta").init_cache(shape.global_batch, shape.seq_len)
        specs = cache_specs(cache, cfg, ctx)
        seen = set()
        for key, part in cache["groups"].items():
            kind = cfg.pattern[int(key[3:])]
            b, sk = part["k"].shape[1], part["k"].shape[2]
            spec = specs["groups"][key]["k"]
            n = sk // ways(spec[2])
            if sk in seen:
                continue
            seen.add(sk)
            label = f"{arch} {shape_name} {'ring' if _kind_window(kind, cfg) else 'global'}"
            out.append((label, b // ways(spec[1]), n, sk, sk - n, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim_, _kind_window(kind, cfg), shape.seq_len - 1))
    return out


def check_lse(name, lse, ref) -> float:
    """The partial mode's log-sum-exp against its plain version's: -inf
    exactly where the plain version's is, the rest within 1e-4 absolute."""
    empty = ref == float("-inf")
    if not bool((lse[empty] == float("-inf")).all()) or not bool(lse[~empty].isfinite().all()):
        raise AssertionError(f"{name}: lse is -inf at other rows than its plain version's")
    err = (lse[~empty] - ref[~empty]).abs().max().item() if bool((~empty).any()) else 0.0
    if err > 1e-4:
        raise AssertionError(f"{name}: lse max |err| {err:.3e} beyond 1e-4")
    return err


def decode_partial_cases(torch, timer, gen):
    """B2's partial mode at per-rank shapes, then the 8-range fold against
    B2 on the whole cache; each timed with its bound."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_partial_ref
    from repro_torch.models.attention import ring_positions

    cases = []
    for label, b, n, sk, lo, hq, hkv, d, window, pos in decode_partial_shapes():
        plan = decode_plan(torch, ops, b, hkv, n, d, hq // hkv)
        for dtype in (torch.bfloat16, torch.float32):
            def rnd(*shape):
                return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)

            q, k, v = rnd(b, 1, hq, d), rnd(b, n, hkv, d), rnd(b, n, hkv, d)
            pos_k = ring_positions(pos, sk, b, DEVICE, start=lo, count=n)
            pos_q = torch.full((b,), pos, device=DEVICE, dtype=torch.int32)
            out, lse = ops.decode_attention_partial(q, k, v, pos_q, pos_k, window=window)
            ref, ref_lse = decode_attention_partial_ref(q[:, 0], k, v, pos_q, pos_k,
                                                        window=window)
            sync(torch)
            name = f"decode_attention_partial {label} B={b} slots {lo}-{lo + n - 1} of {sk}"
            err = max(check_close(f"{name} {dtype}", out, ref, 1e-4, 1e-5),
                      check_lse(f"{name} {dtype}", lse, ref_lse))
            if dtype != torch.bfloat16:
                log(f"kernels: {name} fp32 max|err| {err:.2e} (out rtol 1e-4, lse 1e-4)")
                continue
            dpos = pos_q[:, None] - pos_k
            valid = (pos_k >= 0) & (dpos >= 0)
            if window is not None:
                valid &= dpos < window
            cost = ops.cost(b, n, hq, hkv, d, int(valid.sum()), partial=True)
            bound, by = bound_ms(cost.bytes, cost.ops, cost.peak)
            ms = timer(lambda: ops.decode_attention_partial(q, k, v, pos_q, pos_k, window=window))
            plain = timer(lambda: decode_attention_partial_ref(q[:, 0], k, v, pos_q, pos_k,
                                                               window=window))
            # no single PyTorch call returns a masked GQA decode's output with
            # its log-sum-exp
            cases.append(dict(case=label, B=b, slots=n, of=sk, first=lo, Hq=hq, Hkv=hkv, D=d,
                              window=window, pos=pos, dtype="bfloat16", plan=plan, ms=ms,
                              plain_ms=plain, library_ms=None, bound_ms=bound, bound_by=by,
                              max_abs_err=err))
            log(f"kernels: {name} {hq}/{hkv}x{d} bf16: {ms:.4f} ms (plain {plain:.4f}, bound "
                f"{bound:.4f} by {by}; split plan n_split {plan['n_split']} x "
                f"{plan['split_len']}), max|err| {err:.2e} (out rtol 1e-4, lse 1e-4)")
    # one cache cut into ranges, the partials folded, against B2 on it whole
    b, sk, hq, hkv, d, pos, ranks = DECODE_FOLD_CASE
    n = sk // ranks
    q = torch.randn(b, 1, hq, d, generator=gen, device=DEVICE).to(torch.bfloat16)
    k, v = (torch.randn(b, sk, hkv, d, generator=gen, device=DEVICE).to(torch.bfloat16)
            for _ in range(2))
    pos_q = torch.full((b,), pos, device=DEVICE, dtype=torch.int32)
    pos_k = ring_positions(pos, sk, b, DEVICE)
    ranges = [(r * n, ring_positions(pos, sk, b, DEVICE, start=r * n, count=n))
              for r in range(ranks)]

    def folded():
        parts = [ops.decode_attention_partial(q, k[:, lo:lo + n], v[:, lo:lo + n], pos_q, pk)
                 for lo, pk in ranges]
        lses = torch.stack([p[1] for p in parts])
        return ops.fold_partials(torch.stack([p[0] for p in parts]), lses).to(q.dtype), lses

    out, lses = folded()
    whole = ops.decode_attention(q, k, v, pos_q, pos_k)[:, 0]
    sync(torch)
    empty = [r for r in range(ranks) if bool((lses[r] == float("-inf")).all())]
    if not empty:
        raise AssertionError("decode_attention_partial fold: no range without a kept slot")
    name = f"decode_attention_partial fold of {ranks} ranges B={b} Sk={sk} pos={pos}"
    err = check_close(name, out, whole, BF16_ULP, 1e-5)
    cost = ops.cost(b, sk, hq, hkv, d, b * (pos + 1), partial=True)
    bound, by = bound_ms(cost.bytes, cost.ops, cost.peak)
    ms = timer(lambda: folded())
    plain = timer(lambda: ops.decode_attention(q, k, v, pos_q, pos_k))
    cases.append(dict(case=f"fold of {ranks} ranges", B=b, slots=n, of=sk, Hq=hq, Hkv=hkv, D=d,
                      pos=pos, dtype="bfloat16", empty_ranges=empty, ms=ms, plain_ms=plain,
                      library_ms=None, bound_ms=bound, bound_by=by, max_abs_err=err))
    log(f"kernels: {name}: ranges {empty} keep no slot; the fold equals B2 on the whole cache "
        f"within its gate, max|err| {err:.2e} (rtol 2^-7, atol 1e-5); {ranks} partial launches "
        f"and the fold {ms:.4f} ms, B2 whole {plain:.4f} ms, bound {bound:.4f} by {by}")
    return cases


def rmsnorm_ext_cases(torch, timer, gen):
    """B3a's external-statistic mode at RMSNORM_EXT_CASES, both ways: the
    row statistics (rmsnorm_stat), the forward and the backward against
    their plain versions, each timed with its bound.  Returns (stat, ext,
    ext_bwd) case lists."""
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.ref import (rmsnorm_ext_bwd_ref, rmsnorm_ext_ref,
                                                 row_stat_ref)

    eps = 1e-6
    stat_cases, fwd_cases, bwd_cases = [], [], []
    for rows, d, width in RMSNORM_EXT_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            # this rank's columns are the first d of rows of ``width``
            xf = (torch.randn(rows, width, generator=gen, device=DEVICE) * 3).to(dtype)
            dyf = torch.randn(rows, width, generator=gen, device=DEVICE).to(dtype)
            wf = (torch.randn(width, generator=gen, device=DEVICE) * 0.1).to(dtype)
            x, dy, w = xf[:, :d].contiguous(), dyf[:, :d].contiguous(), wf[:d].contiguous()
            ss, c = ops.row_stat(xf), ops.row_stat(xf, dyf, wf)
            rss, rc = row_stat_ref(xf), row_stat_ref(xf, dyf, wf)
            out = ops.rmsnorm_ext(x, w, ss, width, eps)
            dx, dw = ops.rmsnorm_ext_bwd(dy, x, w, ss, c, width, eps)
            ref = rmsnorm_ext_ref(x, w, ss, width, eps)
            rdx, rdw = rmsnorm_ext_bwd_ref(dy, x, w, ss, c, width, eps)
            sync(torch)
            name = f"rmsnorm_ext rows={rows} D={d} of {width} {dtype}"
            rtol = BF16_ULP if dtype == torch.bfloat16 else 1e-5
            e_stat = max(check_close(name + " stat", ss, rss, 1e-5, 1e-5 * rss.abs().max().item()),
                         check_close(name + " stat dy", c, rc, 1e-5,
                                     1e-5 * rc.abs().max().item()))
            e_fwd = check_close(name, out, ref, rtol, 1e-5)
            e_bwd = max(check_close(name + " dx", dx, rdx, rtol, 1e-5),
                        check_close(name + " dscale", dw, rdw, rtol,
                                    1e-5 * max(1.0, rdw.float().abs().max().item())))
            if dtype != torch.bfloat16:
                log(f"kernels: {name} max|err| stat {e_stat:.2e} fwd {e_fwd:.2e} bwd "
                    f"{e_bwd:.2e}")
                continue
            for cases, c_, fn, plain_fn, err in (
                    (stat_cases, ops.stat_cost(rows, d), lambda: ops.row_stat(x),
                     lambda: row_stat_ref(x), e_stat),
                    (fwd_cases, ops.ext_cost(rows, d), lambda: ops.rmsnorm_ext(x, w, ss, width, eps),
                     lambda: rmsnorm_ext_ref(x, w, ss, width, eps), e_fwd),
                    (bwd_cases, ops.ext_cost(rows, d, backward=True),
                     lambda: ops.rmsnorm_ext_bwd(dy, x, w, ss, c, width, eps),
                     lambda: rmsnorm_ext_bwd_ref(dy, x, w, ss, c, width, eps), e_bwd)):
                bound, by = bound_ms(c_.bytes, c_.ops, c_.peak)
                ms, plain = timer(fn), timer(plain_fn)
                # F.rms_norm takes no statistic from outside
                cases.append(dict(rows=rows, D=d, width=width, dtype="bfloat16", ms=ms,
                                  plain_ms=plain, library_ms=None, bound_ms=bound, bound_by=by,
                                  max_abs_err=err))
            log(f"kernels: {name}: stat {stat_cases[-1]['ms']:.4f} ms (plain "
                f"{stat_cases[-1]['plain_ms']:.4f}, bound {stat_cases[-1]['bound_ms']:.4f}), "
                f"forward {fwd_cases[-1]['ms']:.4f} ms (plain {fwd_cases[-1]['plain_ms']:.4f}, "
                f"bound {fwd_cases[-1]['bound_ms']:.4f}), backward {bwd_cases[-1]['ms']:.4f} ms "
                f"(plain {bwd_cases[-1]['plain_ms']:.4f}, bound {bwd_cases[-1]['bound_ms']:.4f}); "
                f"max|err| {e_stat:.2e} / {e_fwd:.2e} / {e_bwd:.2e} (rtol 2^-7)")
    return stat_cases, fwd_cases, bwd_cases


def rmsnorm_cases(torch, timer, gen, residual: bool):
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.ops import cost, rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref, rmsnorm_residual_ref

    eps = 1e-6
    cases = []
    for rows, d in RMSNORM_RESIDUAL_CASES if residual else RMSNORM_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(rows, d, generator=gen, device=DEVICE) * 3).to(dtype)
            r = torch.randn(rows, d, generator=gen, device=DEVICE).to(dtype)
            w = (torch.randn(d, generator=gen, device=DEVICE) * 0.1).to(dtype)
            rtol = BF16_ULP if dtype == torch.bfloat16 else 1e-5
            name = f"rmsnorm{'_residual' if residual else ''} rows={rows} D={d} {dtype}"
            if residual:
                out, s = rmsnorm(x, w, eps, residual=r)
                ref, ref_s = rmsnorm_residual_ref(x, r, w, eps)
                sync(torch)
                err = max(check_close(name, out, ref, rtol, 1e-5),
                          check_close(name + " sum", s, ref_s, rtol, 1e-5))
            else:
                out = rmsnorm(x, w, eps)
                ref = rmsnorm_ref(x, w, eps)
                sync(torch)
                err = check_close(name, out, ref, rtol, 1e-5)
            if dtype != torch.bfloat16:
                log(f"kernels: {name} max|err| {err:.2e} (rtol 1e-5, atol 1e-5)")
                continue
            if residual:
                ms = timer(lambda: rmsnorm(x, w, eps, residual=r))
                plain = timer(lambda: rmsnorm_residual_ref(x, r, w, eps))
                lib = None  # no single PyTorch call adds the residual and normalizes
            else:
                ms = timer(lambda: rmsnorm(x, w, eps))
                plain = timer(lambda: rmsnorm_ref(x, w, eps))
                w1 = (1.0 + w.float()).to(dtype)  # F.rms_norm scales by w, not 1 + w
                lib = timer(lambda: F.rms_norm(x, (d,), w1, eps))
            c = cost(rows, d, residual=residual)
            bound, by = bound_ms(c.bytes, c.ops, c.peak)
            cases.append(dict(rows=rows, D=d, dtype="bfloat16", ms=ms, plain_ms=plain,
                              library_ms=lib, bound_ms=bound, bound_by=by, max_abs_err=err))
            log(f"kernels: {name}: {ms:.4f} ms (plain {plain:.4f}, F.rms_norm {lib}, "
                f"bound {bound:.4f} by {by}), max|err| {err:.2e} (rtol 2^-7, atol 1e-5)")
    return cases


def flash_cases(torch, timer, gen):
    """B1 forward and backward against their plain versions; returns
    (forward cases, backward cases)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref,
        flash_attention_ref,
        kernel_key_tile,
    )

    fwd_cases, bwd_cases = [], []
    for label, b, s, hq, hkv, d, causal, window in FLASH_CASES + FLASH_FP32_CASES:
        dtype = torch.float32 if label.startswith("fp32") else torch.bfloat16
        sq, sk = s if isinstance(s, tuple) else (s, s)

        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)

        q, k, v, dout = rnd(b, sq, hq, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d), rnd(b, sq, hq, d)
        name = (f"flash_attention {label} [{b},{sq if sq == sk else f'{sq}/{sk}'},{hq}/{hkv},{d}] "
                f"causal={causal} window={window}")
        fwd_only = label in FLASH_FORWARD_ONLY
        out, lse = ops.flash_attention_fwd(q, k, v, causal, window)
        f32 = [t.float() for t in (q, k, v, out, dout)]  # the same values in fp32
        kw = dict(causal=causal, window=window)
        ref, ref_lse = flash_attention_ref(*f32[:3], **kw)
        if fwd_only:
            grads = ref_grads = None
        else:
            grads = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal, window)
            ref_grads = flash_attention_bwd_ref(*f32[:3], f32[3], lse, f32[4], **kw)
        sync(torch)
        lerr = check_close(name + " lse", lse, ref_lse, 1e-4, 1e-5)
        if dtype != torch.bfloat16:
            err = max(check_close(name, out, ref, 1e-4, 1e-5), lerr)
            # gradients sum over up to S keys (dq) or S x G query rows (dk, dv)
            # in another order than the plain version: absolute term scaled by
            # the tensor's largest value
            gerr = "none (forward only)" if fwd_only else "%.2e" % max(
                check_close(f"{name} d{n}", g, r, 1e-4,
                            1e-5 * max(1.0, r.float().abs().max().item()))
                for n, g, r in zip("qkv", grads, ref_grads))
            del ref, ref_lse, ref_grads, grads, f32
            log(f"kernels: {name} fp32 max|err| out {err:.2e}, grads {gerr} (rtol 1e-4)")
            continue
        # bf16 runs on the tensor cores, which round P (and dS) to bf16: held
        # against the fp32 plain version, with the error of the fp32 plain
        # version that rounds where the kernel does (and folds keys in its
        # tiles) as the yardstick
        kw_p = dict(kw, p_dtype=torch.bfloat16, block_k=kernel_key_tile(d))
        err, row, mean = check_rounded(name, out, ref, flash_attention_ref(*f32[:3], **kw_p)[0])
        err = max(err, lerr)
        ratios = [f"out {row:.3f}/{mean:.3f}"]
        gerr = 0.0
        if not fwd_only:
            grads_p = flash_attention_bwd_ref(*f32[:3], f32[3], lse, f32[4], **kw_p)
            for n, g, r, rp in zip("qkv", grads, ref_grads, grads_p):
                e, row, mean = check_rounded(f"{name} d{n}", g, r, rp)
                gerr = max(gerr, e)
                ratios.append(f"d{n} {row:.3f}/{mean:.3f}")
            del grads_p
        del f32, ref, ref_lse, ref_grads, grads
        log(f"kernels: {name}: gate row/mean ratios (pass <= 1) {', '.join(ratios)}")
        pairs = b * hq * ops.kept_pairs(sq, sk, causal, window)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        iq, ik = torch.arange(sq, device=DEVICE), torch.arange(sk, device=DEVICE)
        mask = (ik[None] <= iq[:, None]) if causal else torch.ones(
            sq, sk, dtype=torch.bool, device=DEVICE)
        if window:
            mask &= iq[:, None] - ik[None] < window
        with torch.no_grad():
            ms = timer(lambda: ops.flash_attention_fwd(q, k, v, causal, window))
            plain = timer(lambda: flash_attention_ref(q, k, v, causal=causal, window=window))
            lib = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))
        c = ops.cost(b, sq, sk, hq, hkv, d, causal, window)
        bound, by = bound_ms(c.bytes, c.ops, c.peak)
        fwd_cases.append(dict(case=label, B=b, S=sq, Sk=sk, Hq=hq, Hkv=hkv, D=d, causal=causal,
                              window=window, dtype="bfloat16", pairs=pairs, ms=ms,
                              plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                              max_abs_err=err, tflops=4 * pairs * d / ms / 1e9))
        log(f"kernels: {name}: {ms:.4f} ms (plain {plain:.4f}, sdpa {lib:.4f}, bound "
            f"{bound:.4f} by {by}; {pairs:.4g} pairs), max|err| {err:.2e} (gate: the bf16-P plain "
            f"version's error, per row and in the mean)")
        log(f"kernels: {name}: {4 * pairs * d / ms / 1e9:.1f} TFLOP/s forward "
            f"(4 x pairs x D / ms; sdpa {4 * pairs * d / lib / 1e9:.1f})")
        if fwd_only:
            log(f"kernels: {name}: forward only (no path runs its backward)")
            if DEVICE == "cuda":
                torch.cuda.empty_cache()
            continue

        bms = timer(lambda: ops.flash_attention_bwd(q, k, v, out, lse, dout, causal, window))
        bplain = timer(lambda: flash_attention_bwd_ref(
            q, k, v, out, lse, dout, causal=causal, window=window))
        qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, enable_gqa=True)
        dout_t = dout.transpose(1, 2)
        blib = timer(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dout_t, retain_graph=True))
        del lib_out, qg, kg, vg
        c = ops.cost(b, sq, sk, hq, hkv, d, causal, window, backward=True)
        bbound, bby = bound_ms(c.bytes, c.ops, c.peak)
        bwd_cases.append(dict(case=label, B=b, S=sq, Sk=sk, Hq=hq, Hkv=hkv, D=d, causal=causal,
                              window=window, dtype="bfloat16", pairs=pairs, ms=bms,
                              plain_ms=bplain, library_ms=blib, bound_ms=bbound, bound_by=bby,
                              max_abs_err=gerr, tflops=10 * pairs * d / bms / 1e9))
        log(f"kernels: {name} backward: {bms:.4f} ms (plain {bplain:.4f}, sdpa backward "
            f"{blib:.4f}, bound {bbound:.4f} by {bby}), max|err| {gerr:.2e} (gate: the bf16-P "
            f"plain version's error, per row and in the mean)")
        log(f"kernels: {name} backward: {10 * pairs * d / bms / 1e9:.1f} TFLOP/s (10 x pairs x D "
            f"/ ms; the kernels execute 14 x pairs x D; sdpa {10 * pairs * d / blib / 1e9:.1f})")
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return fwd_cases, bwd_cases


def rmsnorm_bwd_cases(torch, timer, gen):
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.ops import cost, rmsnorm_bwd
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref

    eps = 1e-6
    cases = []
    for rows, d in RMSNORM_BWD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(rows, d, generator=gen, device=DEVICE) * 3).to(dtype)
            dy = torch.randn(rows, d, generator=gen, device=DEVICE).to(dtype)
            w = (torch.randn(d, generator=gen, device=DEVICE) * 0.1).to(dtype)
            name = f"rmsnorm_bwd rows={rows} D={d} {dtype}"
            dx, dw = rmsnorm_bwd(dy, x, w, eps)
            rdx, rdw = rmsnorm_bwd_ref(dy, x, w, eps)
            sync(torch)
            rtol = BF16_ULP if dtype == torch.bfloat16 else 1e-4
            # d(scale) sums over the rows in another order: absolute term
            # scaled by its largest value
            err = max(check_close(name + " dx", dx, rdx, rtol, 1e-5),
                      check_close(name + " dscale", dw, rdw, rtol,
                                  1e-5 * max(1.0, rdw.float().abs().max().item())))
            if dtype != torch.bfloat16:
                log(f"kernels: {name} max|err| {err:.2e} (rtol 1e-4)")
                continue
            ms = timer(lambda: rmsnorm_bwd(dy, x, w, eps))
            plain = timer(lambda: rmsnorm_bwd_ref(dy, x, w, eps))
            xg = x.detach().requires_grad_()
            w1 = (1.0 + w.float()).to(dtype).requires_grad_()  # F.rms_norm scales by w
            y = F.rms_norm(xg, (d,), w1, eps)
            lib = timer(lambda: torch.autograd.grad(y, (xg, w1), dy, retain_graph=True))
            del y
            c = cost(rows, d, backward=True)
            bound, by = bound_ms(c.bytes, c.ops, c.peak)
            cases.append(dict(rows=rows, D=d, dtype="bfloat16", ms=ms, plain_ms=plain,
                              library_ms=lib, bound_ms=bound, bound_by=by, max_abs_err=err))
            log(f"kernels: {name}: {ms:.4f} ms (plain {plain:.4f}, F.rms_norm backward "
                f"{lib:.4f}, bound {bound:.4f} by {by}), max|err| {err:.2e} (rtol 2^-7)")
    return cases


def ssd_pass_checks(torch, ops, name, args, rtol):
    """B4's passes one by one, each held against its plain version computed
    from the kernel's own scratch as the pass found it, so that a fault
    shows in the pass that makes it; returns (the workspace, the largest
    error of each pass).  C B^T is compared on and below the diagonal, the
    part the kernel computes."""
    ws = ops.workspace(*args)
    errs = {}
    for p in ops.PASSES:
        ops.run_pass(ws, p)
        for field, ref in ops.plain_pass(ws, p).items():
            out = getattr(ws, field)
            if field == "cb":
                out, ref = torch.tril(out), torch.tril(ref)
            scale = max(1.0, ref.float().abs().max().item())
            errs[f"{p}.{field}"] = check_close(f"{name} pass {p} ({field})", out, ref,
                                               rtol if field == "y" else 1e-4, 1e-5 * scale)
            del ref
    sync(torch)
    return ws, errs


def ssd_cases(torch, timer, gen):
    """B4 against its plain version at the paths' shapes and the edge cases,
    pass by pass and whole; returns the timed cases."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_ref

    cases = []
    timed = {c[0] for c in SSD_CASES}
    for label, b, s, h, p, n, g, dtype_name, init in SSD_CASES + SSD_EDGE_CASES:
        dtype = getattr(torch, dtype_name)

        def rnd(*shape, scale=1.0):
            return torch.randn(*shape, generator=gen, device=DEVICE) * scale

        x = rnd(b, s, h, p).to(dtype)
        # dA < 0 as the model makes it; cum reaches about -200 over a chunk,
        # so exp(cum) underflows to 0 and exp(cum_i - cum_j) above the
        # diagonal would overflow if it were not selected away
        dA = -F.softplus(rnd(b, s, h))
        B_, C_ = rnd(b, s, g, n, scale=0.5).to(dtype), rnd(b, s, g, n, scale=0.5).to(dtype)
        state = rnd(b, h, p, n) if init else None
        q = min(SSD_CHUNK, s)
        name = f"ssd_scan {label} [{b},{s},{h},{p}] N={n} G={g} {dtype_name}"
        # y sums up to Q terms and the state Q per chunk, in another order
        # than the plain version: absolute term 1e-5 x the largest value
        rtol = BF16_ULP if dtype == torch.bfloat16 else 1e-4
        ws, pass_errs = ssd_pass_checks(torch, ops, name, (x, dA, B_, C_, SSD_CHUNK, state), rtol)
        log(f"kernels: {name} passes max|err| "
            + ", ".join(f"{k} {v:.2e}" for k, v in pass_errs.items()))
        y, final = ops.ssd(x, dA, B_, C_, SSD_CHUNK, state)
        ref_y, ref_final = ssd_ref(x, dA, B_, C_, q, state)
        sync(torch)
        err = max(
            check_close(name, y, ref_y, rtol, 1e-5 * max(1.0, ref_y.float().abs().max().item())),
            check_close(name + " state", final, ref_final, 1e-4,
                        1e-5 * max(1.0, ref_final.abs().max().item())))
        del y, final, ref_y, ref_final
        if label not in timed:
            log(f"kernels: {name} max|err| {err:.2e} (rtol {rtol:.3g}, atol 1e-5 x max|ref|)")
            del ws
            continue
        ms = timer(lambda: ops.ssd(x, dA, B_, C_, SSD_CHUNK, state))
        plain = timer(lambda: ssd_ref(x, dA, B_, C_, q, state))
        passes_ms = {pn: timer(lambda pn=pn: ops.run_pass(ws, pn)) for pn in ops.PASSES}
        del ws
        # the work the function needs (``ops.cost``: the lower triangles, the
        # state terms), in 3xTF32, three TF32 products for each fp32 one: its
        # bound is that work at the TF32 peak; the same work on the fp32 CUDA
        # cores is logged beside it
        c = ops.cost(b, s, h, p, n, g, q, init, x.element_size())
        flops, n_bytes = c.flops, c.bytes
        # the TPU kernel's work, for comparison: full Q x Q squares, C B^T per head
        chunks = s // q
        tpu_flops = b * h * chunks * (2 * q * q * n + 2 * q * q * p + 4 * q * p * n)
        bound, by = bound_ms(c.bytes, c.ops, c.peak)
        fp32_bound = max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
        cases.append(dict(case=label, B=b, S=s, H=h, P=p, N=n, G=g, dtype=dtype_name,
                          flops=flops, tpu_flops=tpu_flops, bytes=n_bytes, ms=ms, plain_ms=plain,
                          library_ms=None, bound_ms=bound, bound_by=by,
                          fp32_bound_ms=fp32_bound, passes_ms=passes_ms,
                          pass_max_abs_err=pass_errs, max_abs_err=err))
        log(f"kernels: {name}: {ms:.4f} ms (plain {plain:.4f}, no library call, bound "
            f"{bound:.4f} by {by} in 3xTF32, {fp32_bound:.4f} on the fp32 CUDA cores; "
            f"{flops / 1e9:.4g} GFLOP ({tpu_flops / 1e9:.4g} as the TPU kernel counts), "
            f"{n_bytes / 1e6:.4g} MB), max|err| {err:.2e} "
            f"(rtol {rtol:.3g}, atol 1e-5 x max|ref|); passes "
            + ", ".join(f"{k} {v:.4f}" for k, v in passes_ms.items()) + " ms")
        del x, dA, B_, C_, state
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return cases


def ssd_bwd_cases(torch, timer, gen):
    """B4's backward against its plain version (fp32: 1e-4 relative plus
    1e-5 x the tensor's largest value) at phase 11's shapes and the edge
    cases: pass by pass on the forward kernel's scratch, and whole through
    ``ops.ssd``'s autograd Function against ``ssd_bwd_ref``; two calls must
    be equal bit for bit.  Returns the timed cases."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_bwd_ref, ssd_bwd_scratch_ref

    cases = []
    timed = {c[0] for c in SSD_BWD_CASES}
    for label, b, s, h, p, n, g, chunk, init, dfin, unaligned in SSD_BWD_CASES + SSD_BWD_EDGE_CASES:
        def rnd(*shape, scale=1.0):
            return torch.randn(*shape, generator=gen, device=DEVICE) * scale

        def rows65(t):  # a view whose rows lie 65 elements apart
            return torch.cat([t, t[..., :1]], dim=-1)[..., :p] if unaligned else t

        x, dy = rows65(rnd(b, s, h, p)), rows65(rnd(b, s, h, p))
        dA = -F.softplus(rnd(b, s, h))
        bc = rnd(b, s, 2 * g * n, scale=0.5)  # B and C as views of the conv output
        B_, C_ = bc[..., : g * n].view(b, s, g, n), bc[..., g * n :].view(b, s, g, n)
        state = rnd(b, h, p, n) if init else None
        dfinal = rnd(b, h, p, n) if dfin else None
        q = min(chunk, s)
        name = (f"ssd_scan_bwd {label} [{b},{s},{h},{p}] N={n} G={g} chunk {q}"
                + (" initial state" if init else "") + (" dfinal" if dfin else ""))
        ws = ops.workspace(x, dA, B_, C_, chunk, state)
        for pn in ops.PASSES:
            ops.run_pass(ws, pn)
        bw = ops.bwd_workspace(ws, dy, dfinal)
        pass_errs = {}
        for pn in ops.BWD_PASSES:
            ops.run_pass(bw, pn)
            for field, ref in ops.plain_pass(bw, pn).items():
                scale = max(1.0, ref.abs().max().item())
                pass_errs[f"{pn}.{field}"] = check_close(f"{name} pass {pn} ({field})",
                                                         getattr(bw, field), ref, 1e-4, 1e-5 * scale)
                del ref
        sync(torch)
        log(f"kernels: {name} passes max|err| "
            + ", ".join(f"{k} {v:.2e}" for k, v in pass_errs.items()))

        def grads():
            leaves = [t.detach().requires_grad_() for t in (x, dA, bc)]
            st = state.detach().requires_grad_() if init else None
            view = leaves[2]
            y, final = ops.ssd(leaves[0], leaves[1], view[..., : g * n].view(b, s, g, n),
                               view[..., g * n :].view(b, s, g, n), chunk, st)
            outs, douts = [y], [dy]
            if dfin:
                outs.append(final)
                douts.append(dfinal)
            return torch.autograd.grad(outs, leaves + ([st] if init else []), douts)

        got, again = grads(), grads()
        want = ssd_bwd_ref(x, dA, B_, C_, q, state, dy, dfinal)
        sync(torch)
        want_bc = torch.cat([want[2].reshape(b, s, g * n), want[3].reshape(b, s, g * n)], dim=-1)
        err = 0.0
        for what, gv, av, wv in zip(("dx", "d_dA", "dB and dC", "d_initial"), got, again,
                                    (want[0], want[1], want_bc, want[4])):
            if not torch.equal(gv, av):
                raise AssertionError(f"{name}: {what} differs between two calls")
            err = max(err, check_close(f"{name} {what}", gv, wv, 1e-4,
                                       1e-5 * max(1.0, wv.abs().max().item())))
        del got, again, want, want_bc
        if label not in timed:
            log(f"kernels: {name} max|err| {err:.2e} (rtol 1e-4, atol 1e-5 x max|ref|), two "
                "calls equal bit for bit")
            del ws, bw
            continue
        ms = timer(lambda: [ops.run_pass(bw, pn) for pn in ops.BWD_PASSES])
        plain = timer(lambda: ssd_bwd_scratch_ref(x, B_, C_, ws.cum, ws.cb, ws.prev, dy, dfinal))
        passes_ms = {pn: timer(lambda pn=pn: ops.run_pass(bw, pn)) for pn in ops.BWD_PASSES}
        del ws, bw
        # the work the function needs on these inputs (``ops.bwd_cost``: the
        # lower-triangle products, the state products that the initial state
        # and dfinal need), in 3xTF32 as the forward's: its bound is that work
        # at the TF32 peak; the same work on the fp32 CUDA cores is logged
        # beside it
        c = ops.bwd_cost(b, s, h, p, n, g, q, init, dfin)
        flops, n_bytes = c.flops, c.bytes
        chunks, tri = s // q, q * (q + 1) // 2
        bound, by = bound_ms(c.bytes, c.ops, c.peak)
        fp32_bound = max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
        # the products each tensor pass runs, on the same count: dprev (dy o
        # e)^T C; dx dy x^T, S^T dy, dM^T C, B g^T and x g; dC dy x^T, dM B and
        # (dy o e) prev (dy x^T is run by both)
        state = b * h * 2 * q * p * n
        pass_flops = {
            "dprev": state * (chunks - (0 if init else 1)),
            "dx": b * h * chunks * 2 * tri * (2 * p + n) + 2 * state * (chunks - (0 if dfin else 1)),
            "dc": b * h * chunks * 2 * tri * (p + n) + state * (chunks - (0 if init else 1)),
        }
        pass_tflops = {k: f / passes_ms[k] / 1e9 for k, f in pass_flops.items()}
        cases.append(dict(case=label, B=b, S=s, H=h, P=p, N=n, G=g, chunk=q, flops=flops,
                          bytes=n_bytes, ms=ms, plain_ms=plain, library_ms=None, bound_ms=bound,
                          bound_by=by, fp32_bound_ms=fp32_bound, passes_ms=passes_ms,
                          passes_tflops=pass_tflops, pass_max_abs_err=pass_errs, max_abs_err=err))
        log(f"kernels: {name}: {ms:.4f} ms (plain {plain:.4f}, no library call, bound "
            f"{bound:.4f} by {by} in 3xTF32, {fp32_bound:.4f} on the fp32 CUDA cores; "
            f"{flops / 1e9:.4g} GFLOP, "
            f"{n_bytes / 1e6:.4g} MB, {flops / ms / 1e9:.1f} TFLOP/s), max|err| {err:.2e} "
            "(rtol 1e-4, atol 1e-5 x max|ref|), two calls equal bit for bit; passes "
            + ", ".join(f"{k} {v:.4f}" for k, v in passes_ms.items()) + " ms; TFLOP/s "
            + ", ".join(f"{k} {v:.1f}" for k, v in pass_tflops.items())
            + " (products needed, TF32 at 1x)")
        del x, dy, dA, bc, B_, C_, state, dfinal
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return cases


def phase_kernels(torch, seed):
    timer = Timer(torch)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    fwd, bwd = flash_cases(torch, timer, gen)
    results = {
        "decode_attention": decode_cases(torch, timer, gen),
        "rmsnorm": rmsnorm_cases(torch, timer, gen, residual=False),
        "rmsnorm_residual": rmsnorm_cases(torch, timer, gen, residual=True),
        "flash_attention": fwd,
        "flash_attention_bwd": bwd,
        "rmsnorm_bwd": rmsnorm_bwd_cases(torch, timer, gen),
        "ssd_scan": ssd_cases(torch, timer, gen),
        "ssd_scan_bwd": ssd_bwd_cases(torch, timer, gen),
        "decode_attention_partial": decode_partial_cases(torch, timer, gen),
    }
    results["rmsnorm_stat"], results["rmsnorm_ext"], results["rmsnorm_ext_bwd"] = (
        rmsnorm_ext_cases(torch, timer, gen))
    del timer
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    log(f"kernels: {time.perf_counter() - t0:.1f} s")
    return results


# ------------------------------------------------------------ phase 4
def phase_serve(torch, seed, smi):
    import numpy as np

    from repro_torch.checkpoint import checkpoint_files
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.models import build_model
    from repro_torch.models.layers import unembed
    from repro_torch.serving import DecodeEngine

    cfg = get_config(MODEL)
    api = build_model(cfg, device=DEVICE)
    t0 = time.perf_counter()
    files = checkpoint_files(0, "gemma3-1b-chip-smoke", api.init(seed=seed))
    engine = DecodeEngine.from_files(api, files, batch=BATCH, max_len=MAX_LEN)
    n_bytes = sum(len(b) for b in files.values())
    del files
    sync(torch)
    log(f"serve: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}) through {n_bytes / 2**30:.2f} GiB of checkpoint files "
        f"in {time.perf_counter() - t0:.1f} s")

    prompts = torch.from_numpy(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, (BATCH, PROMPT_LEN))
    )
    reset_counts()
    sync(torch)
    t0 = time.perf_counter()
    new = engine.generate(prompts, NEW_TOKENS)
    sync(torch)
    elapsed = time.perf_counter() - t0
    launches = read_counts()
    steps = PROMPT_LEN + NEW_TOKENS - 1
    n_attn = cfg.n_layers
    n_norm = 2 * cfg.n_layers + 1
    # the model adds its residuals itself, as the JAX model does, so the
    # residual variant is held against its plain version in phase 3 only
    expected = dict({name: 0 for name, _, _ in counters()},
                    decode_attention=n_attn * steps, rmsnorm=n_norm * steps)
    if launches != expected:
        raise AssertionError(f"launches {launches} != {expected} ({steps} steps)")
    if new.shape != (BATCH, NEW_TOKENS) or not bool(((new >= 0) & (new < cfg.vocab_size)).all()):
        raise AssertionError(f"bad generated tokens {new.shape}")
    log(f"serve: {steps} decode steps (prompt token by token, then greedy) at batch "
        f"{BATCH}: {elapsed:.3f} s, {elapsed / steps * 1e3:.3f} ms/step, "
        f"{BATCH * steps / elapsed:.1f} tokens/s on {smi}")
    log(f"serve: launches decode_attention {launches['decode_attention']} = {n_attn} x "
        f"{steps}, rmsnorm {launches['rmsnorm']} = {n_norm} x {steps}, rmsnorm_residual "
        f"{launches['rmsnorm_residual']}")

    # teacher-forced decode of the served sequence, against the engine and
    # against the multi-token forward
    seq = torch.cat([prompts.to(new.device), new], dim=1)  # [B, 544]
    cache = api.init_cache(BATCH, MAX_LEN)
    dec_logits = {}
    with torch.no_grad():
        for i in range(seq.shape[1]):
            lg, cache = api.decode_step(engine.params, cache, seq[:, i : i + 1], i)
            if i in CHECK_POSITIONS:
                dec_logits[i] = lg[:, 0].float()
            if PROMPT_LEN - 1 <= i < seq.shape[1] - 1:
                if not torch.equal(lg[:, 0].argmax(-1), seq[:, i + 1]):
                    raise AssertionError(f"engine token at position {i + 1} differs from decode")
        before = fa_ops.flash_attention.launches
        hidden = api.forward(engine.params, seq, return_hidden=True)
        ref = unembed(hidden[:, list(CHECK_POSITIONS)], engine.params["embed"], cfg).float()
        if fa_ops.flash_attention.launches != before + cfg.n_layers:
            raise AssertionError(f"the forward launched flash attention "
                                 f"{fa_ops.flash_attention.launches - before} times, not {cfg.n_layers}")
    dec = torch.stack([dec_logits[p] for p in CHECK_POSITIONS], dim=1)
    if not bool(dec.isfinite().all()) or dec.shape != (BATCH, len(CHECK_POSITIONS), cfg.vocab_size):
        raise AssertionError(f"decode logits {tuple(dec.shape)} not finite")
    scale = max(1.0, ref.abs().max().item())
    err = (dec - ref).abs()
    per_pos = {p: err[:, j].max().item() / scale for j, p in enumerate(CHECK_POSITIONS)}
    mean = err.mean().item() / scale
    log(f"serve: decode vs forward logits at positions {CHECK_POSITIONS}: max |err| / "
        f"{scale:.3f} = {per_pos} (tol {LOGIT_TOL}), mean {mean:.2e} (tol {LOGIT_MEAN_TOL})")
    if max(per_pos.values()) > LOGIT_TOL or mean > LOGIT_MEAN_TOL:
        raise AssertionError("decode logits disagree with the teacher-forced forward")
    return engine, cache, seq, launches


# the profiler's names of the MoE layer's spans (see ``moe_spans``)
MOE_SPANS = ("moe_mlp_local", "moe_expert_ffn")


@contextlib.contextmanager
def moe_spans():
    """While on, every ``moe_mlp_local`` call of the model, and the expert FFN
    inside it, runs in a torch.profiler ``record_function`` span, so that a
    profile can say how much device time the MoE layers take."""
    from torch.profiler import record_function

    from repro_torch.distributed import moe_parallel
    from repro_torch.models import moe

    saved = (moe_parallel.moe_mlp_local, moe._expert_ffn)

    def span(name, fn):
        def call(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return call

    moe_parallel.moe_mlp_local = span(MOE_SPANS[0], saved[0])
    moe._expert_ffn = span(MOE_SPANS[1], saved[1])
    try:
        yield
    finally:
        moe_parallel.moe_mlp_local, moe._expert_ffn = saved


def phase_profile(torch, engine, cache, seq):
    """Device time by kernel over eight decode steps after the served ones;
    for an MoE model also the device time inside its MoE layers."""
    from torch.profiler import ProfilerActivity, profile

    api = engine.api
    tok = seq[:, -1:]
    steps = 8
    spans = {}
    with torch.no_grad(), moe_spans():
        api.decode_step(engine.params, cache, tok, seq.shape[1])  # warm
        sync(torch)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                api.decode_step(engine.params, cache, tok, seq.shape[1] + 1 + i)
            sync(torch)
            wall = time.perf_counter() - t0
    groups = {}
    total = 0.0
    launches = 0
    for ev in prof.key_averages():
        if ev.key in MOE_SPANS:  # a span, not a kernel (on the device too, as an annotation)
            if ev.device_type == torch.autograd.DeviceType.CPU:  # its kernels' device time
                t = getattr(ev, "device_time_total", None)
                spans[ev.key] = ev.cuda_time_total if t is None else t
            continue
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops; their kernels are listed on their own
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        total += t
        launches += ev.count
        name = ev.key
        if "decode_attention_kernel" in name:
            g = "decode_attention kernel"
        elif "rmsnorm_kernel" in name:
            g = "rmsnorm kernel"
        elif any(s in name.lower() for s in ("gemm", "gemv", "cutlass", "xmma", "nvjet", "splitk")):
            g = "matmul (cuBLAS)"
        elif any(s in name.lower() for s in ("sort", "topk", "searchsorted", "scatter",
                                              "index", "gather")):
            g = "PyTorch sort/top-k/index/scatter (MoE routing and dispatch, embed)"
        elif "elementwise" in name or "reduce" in name or "copy" in name.lower():
            g = "PyTorch elementwise/reduce/copy"
        else:
            g = "other: " + name[:60]
        groups[g] = groups.get(g, 0.0) + t
    log(f"profile: {launches / steps:.0f} device kernels per step")
    log(f"profile: {steps} steps, wall {wall / steps * 1e3:.3f} ms/step, device busy "
        f"{total / 1e3 / steps:.3f} ms/step ({100 * total / 1e6 / wall:.1f} %)")
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1])[:14]:
        log(f"profile:   {t / 1e3 / steps:8.4f} ms/step  {g}")
    if spans:
        layer, ffn = spans.get(MOE_SPANS[0], 0.0), spans.get(MOE_SPANS[1], 0.0)
        log(f"profile:   of all kernels, inside moe_mlp_local {layer / 1e3 / steps:.4f} ms/step: "
            f"expert FFN (bmm, SiLU) {ffn / 1e3 / steps:.4f}, routing, dispatch and combine "
            f"{(layer - ffn) / 1e3 / steps:.4f}")


# ------------------------------------------------------------ phase 5
def train_launch_schedule(cfg) -> dict:
    """Launches per train step that the remat schedule implies: the forward's
    attentions, SSD scans and norms run once forward and once backward, and
    the checkpointed layers run forward again in the backward pass: the
    stacked groups of a decoder-only model (not its tail or final norm),
    every encoder and decoder layer of whisper (not the two final norms)."""
    fwd = path_launches(cfg, "forward")
    if cfg.family == "encdec":
        remat = dict(flash_attention=fwd["flash_attention"], ssd_scan=0, rmsnorm=fwd["rmsnorm"] - 2)
    else:
        stacked = cfg.layer_kinds()[: (cfg.n_layers // len(cfg.pattern)) * len(cfg.pattern)]
        n_mamba = stacked.count("mamba")
        remat = dict(flash_attention=len(stacked) - n_mamba, ssd_scan=n_mamba,
                     rmsnorm=2 * len(stacked))
    return dict(fwd, flash_attention=fwd["flash_attention"] + remat["flash_attention"],
                flash_attention_bwd=fwd["flash_attention"],
                ssd_scan=fwd["ssd_scan"] + remat["ssd_scan"], ssd_scan_bwd=fwd["ssd_scan"],
                rmsnorm=fwd["rmsnorm"] + remat["rmsnorm"], rmsnorm_bwd=fwd["rmsnorm"])


def train_step_kwargs() -> dict:
    """``make_train_step``'s arguments on phase 5's schedule."""
    return dict(peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS,
                microbatches=1, remat=True)


def token_batch(torch, cfg, seed: int, batch: int, seq: int) -> dict:
    """tokens/labels [batch, seq] on the device, drawn from ``seed``."""
    import numpy as np

    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq + 1))
    tokens = torch.from_numpy(tokens.astype(np.int32)).to(DEVICE)
    return {"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous()}


def restore_params(api, seed: int, tag: str):
    """Random params from ``seed`` written to checkpoint DU files and read
    back onto the device; returns (params, GiB of files, params count)."""
    from repro_torch.bridge import params_from_files
    from repro_torch.checkpoint import checkpoint_files, flatten_tree

    files = checkpoint_files(0, f"{api.cfg.name}-{tag}", api.init(seed=seed))
    params = params_from_files(files, device=DEVICE)
    n_bytes = sum(len(b) for b in files.values())
    del files
    return params, n_bytes / 2**30, sum(p.numel() for _, p in flatten_tree(params))


def run_train(torch, smi, tag: str, api, params, batch, tokens_per_step: int):
    """Phase 5's schedule: AdamW state initialised on the device from
    ``params``, one eval, TRAIN_STEPS remat steps on ``batch``, one more
    eval.  Every launch count must be what the schedule implies, every
    metric finite, step 0's loss (lr 0) equal to the eval loss within 2^-7
    and the loss must fall.  Returns (params, opt, train_step, launches,
    summary)."""
    from repro_torch.optim import init_adamw
    from repro_torch.training import make_eval_step, make_train_step

    opt = init_adamw(params)
    eval_step = make_eval_step(api)
    train_step = make_train_step(api, **train_step_kwargs())
    per_step, per_eval = train_launch_schedule(api.cfg), path_launches(api.cfg, "forward")

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    sync(torch)
    t0 = time.perf_counter()
    ev0 = {k: float(v) for k, v in eval_step(params, batch).items()}
    sync(torch)
    eval_s = time.perf_counter() - t0
    if read_counts() != per_eval:
        raise AssertionError(f"{tag}: eval launches {read_counts()} != {per_eval}")
    history, step_s = [], []
    for i in range(TRAIN_STEPS):
        before = read_counts()
        sync(torch)
        t0 = time.perf_counter()
        params, opt, metrics = train_step(params, opt, batch)
        sync(torch)
        step_s.append(time.perf_counter() - t0)
        check_launches(before, per_step, f"{tag}: step {i}")
        history.append({k: float(v) for k, v in metrics.items()})
        log(f"{tag}: step {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in history[-1].items())
            + f", {step_s[-1]:.3f} s")
    ev1 = {k: float(v) for k, v in eval_step(params, batch).items()}
    sync(torch)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30

    expected = {k: TRAIN_STEPS * per_step[k] + 2 * per_eval[k] for k in per_step}
    if launches != expected:
        raise AssertionError(f"{tag}: launches {launches} != {expected}")
    values = [*ev0.values(), *ev1.values()] + [v for h in history for v in h.values()]
    if not all(math.isfinite(x) for x in values):
        raise AssertionError(f"{tag}: non-finite metrics: {history}, evals {ev0}, {ev1}")
    loss0 = history[0]["loss"]
    if history[0]["lr"] != 0.0 or abs(loss0 - ev0["loss"]) > BF16_ULP * abs(ev0["loss"]) + 1e-5:
        raise AssertionError(f"{tag}: step 0 loss {loss0} (lr {history[0]['lr']}) != eval "
                             f"loss {ev0['loss']}")
    if not ev1["loss"] < loss0:
        raise AssertionError(f"{tag}: loss did not fall: step 0 {loss0}, after {TRAIN_STEPS} "
                             f"steps {ev1['loss']}")
    steady = statistics.median(step_s[1:]) if len(step_s) > 1 else step_s[0]
    log(f"{tag}: eval {ev0} ({eval_s:.3f} s) -> {ev1} after {TRAIN_STEPS} steps; step 0 loss "
        f"{loss0:.6f} (lr 0) equals the eval loss within 2^-7")
    log(f"{tag}: {tokens_per_step} tokens/step: {steady:.3f} s/step (median of steps "
        f"1-{TRAIN_STEPS - 1}; step 0 {step_s[0]:.3f} s), {tokens_per_step / steady:.1f} "
        f"tokens/s, peak device memory {peak:.2f} GiB on {smi}")
    log(f"{tag}: launches per step {per_step}; in all (2 evals + {TRAIN_STEPS} steps) {launches}")
    return params, opt, train_step, launches, dict(
        s_per_step=steady, step_s=step_s, tokens_per_s=tokens_per_step / steady,
        peak_gib=peak, eval_loss=[ev0["loss"], ev1["loss"]], history=history)


def phase_train(torch, seed, smi):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(TRAIN_MODEL)
    api = build_model(cfg, device=DEVICE)
    t0 = time.perf_counter()
    params, gib, n_params = restore_params(api, seed, "chip-smoke")
    sync(torch)
    log(f"train: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.head_dim_}, window {cfg.sliding_window}, vocab "
        f"{cfg.vocab_size}, {n_params / 1e9:.3f} B params) restored from {gib:.2f} GiB of "
        f"checkpoint files in {time.perf_counter() - t0:.1f} s")
    batch = token_batch(torch, cfg, seed, TRAIN_BATCH, TRAIN_SEQ)
    params, opt, train_step, launches, out = run_train(
        torch, smi, "train", api, params, batch, TRAIN_BATCH * TRAIN_SEQ)
    return api, params, opt, batch, train_step, launches, out


def phase_profile_train(torch, params, opt, batch, train_step, tag="train") -> float:
    """Device time of one more train step by kernel group, and of the spans
    in it: clip + AdamW, and for an MoE model its MoE layers' forwards and
    recomputes (``moe_spans``); returns the step's device time in seconds."""
    from torch.profiler import ProfilerActivity, profile

    sync(torch)
    with moe_spans(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(params, opt, batch)
        sync(torch)
        wall = time.perf_counter() - t0
    groups, total, spans, kernels, n_kernels = {}, 0.0, {}, {}, 0
    for ev in prof.key_averages():
        if ev.key in ("optimizer",) + MOE_SPANS:  # a span, not a kernel: its kernels' time
            if ev.device_type == torch.autograd.DeviceType.CPU:
                t = getattr(ev, "device_time_total", None)
                spans[ev.key] = ev.cuda_time_total if t is None else t
            continue
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        total += t
        n_kernels += ev.count
        name = ev.key
        kernels[name] = kernels.get(name, 0.0) + t
        low = name.lower()
        if "nccl" in low:
            g = "NCCL collectives"
        elif "flash_fwd" in name:
            g = "B1 flash_attention forward (CUDA)"
        elif "flash_bwd" in name:
            part = ("dK/dV" if "dkv" in name else "dQ" if "_dq_" in name
                    else "delta" if "delta" in name else "fold of the dK/dV parts"
                    if "fold" in name else "other")
            g = f"B1 flash_attention backward, {part} (CUDA)"
        elif "ssd_bwd" in name:
            g = "B4 ssd_scan backward (CUDA)"
        elif "ssd_scan" in name:
            g = "B4 ssd_scan forward (CUDA)"
        elif "rmsnorm_bwd" in name or "rmsnorm_dw" in name:
            g = "B3a rmsnorm backward (Triton)"
        elif "rmsnorm_kernel" in name:
            g = "B3a rmsnorm forward (Triton)"
        elif any(x in low for x in ("gemm", "gemv", "cutlass", "xmma", "nvjet", "splitk")):
            g = "matmul (cuBLAS)"
        elif any(x in low for x in ("sort", "topk", "searchsorted", "scatter", "index", "gather")):
            g = "PyTorch sort/top-k/index/scatter/gather"
        elif any(x in low for x in ("elementwise", "reduce", "copy", "vectorized",
                                    "softmax", "fill", "cat")):
            g = "PyTorch elementwise/reduce/copy"
        else:
            g = "other: " + name[:60]
        groups[g] = groups.get(g, 0.0) + t
    log(f"profile {tag}: one step, wall {wall:.3f} s, device busy {total / 1e6:.3f} s "
        f"({100 * total / 1e6 / wall:.1f} %), {n_kernels} device kernels")
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1])[:14]:
        log(f"profile {tag}:   {t / 1e6:8.4f} s  {g}")
    for name, t in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        log(f"profile {tag}:     kernel {t / 1e6:8.4f} s  {name[:110]}")
    if "optimizer" in spans:
        log(f"profile {tag}:   of which clip + AdamW (all groups): {spans['optimizer'] / 1e6:.4f} s")
    if MOE_SPANS[0] in spans:
        layer, ffn = spans[MOE_SPANS[0]], spans.get(MOE_SPANS[1], 0.0)
        log(f"profile {tag}:   of which inside moe_mlp_local, forwards and remat recomputes: "
            f"{layer / 1e6:.4f} s (expert FFN {ffn / 1e6:.4f}, routing, dispatch and combine "
            f"{(layer - ffn) / 1e6:.4f})")
    return total / 1e6


# ------------------------------------------------------------ phase 6
def path_launches(cfg, path: str) -> dict:
    """Launches that one decode step (``path="step"``), one teacher-forced
    forward (``"forward"``) or, for whisper, one encoder pass (``"encode"``)
    implies.  A decoder-only model: every layer's norms (two each) and the
    final norm; a decode step's attention layers run B2, a forward's run B1
    and its mamba layers B4.  Whisper: an encoder layer runs one attention
    and two norms, a decoder layer two attentions (self and cross) and
    three norms, each stack one final norm (phases 4-10)."""
    out = {name: 0 for name, _, _ in counters()}
    if cfg.family == "encdec":
        n_enc, n_dec = cfg.encdec.n_enc_layers, cfg.n_layers
        enc = dict(flash_attention=n_enc, rmsnorm=2 * n_enc + 1)
        if path == "encode":
            out.update(enc)
        elif path == "step":
            out.update(decode_attention=2 * n_dec, rmsnorm=3 * n_dec + 1)
        else:
            out.update(flash_attention=enc["flash_attention"] + 2 * n_dec,
                       rmsnorm=enc["rmsnorm"] + 3 * n_dec + 1)
        return out
    kinds = cfg.layer_kinds()
    n_mamba = kinds.count("mamba")
    out["rmsnorm"] = 2 * len(kinds) + 1
    if path == "step":
        out["decode_attention"] = len(kinds) - n_mamba
    else:
        out.update(flash_attention=len(kinds) - n_mamba, ssd_scan=n_mamba)
    return out


def check_launches(before: dict, expected: dict, what: str) -> None:
    got = {k: v - before[k] for k, v in read_counts().items()}
    if got != expected:
        raise AssertionError(f"{what}: launches {got} != {expected}")


def phase_ssm(torch, seed, smi, model: str, prefill_len: int, profile: bool = False):
    """Serve one SSM-family model from checkpoint files, hold its decode
    against its forward, and (with ``prefill_len``) time a prefill; with
    ``profile``, break eight more decode steps and one more prefill down by
    kernel group.

    In bf16 a deep SSM with random weights amplifies the one-ulp roundings in
    which decode and forward differ (GEMV against GEMM, the recurrence
    against the chunked form) once a state is carried, past what
    LOGIT_TOL allows; in fp32 the two agree closely.  So the bf16 engine is
    held to the forward to LOGIT_TOL at position 0 (no carried state), to
    SSM_BF16_LOGIT_TOL / SSM_BF16_LOGIT_MEAN_TOL at the other positions and
    on its layer-0 SSM state, and the same weights in fp32 are held to
    LOGIT_TOL / LOGIT_MEAN_TOL at every check position."""
    import dataclasses

    import numpy as np

    from repro_torch.checkpoint import checkpoint_files, tree_map
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import embed, rms_norm, unembed
    from repro_torch.models.mamba2 import mamba_block
    from repro_torch.models.transformer import _group_slice
    from repro_torch.serving import DecodeEngine

    full = get_config(model)
    cfg = dataclasses.replace(full, n_layers=SSM_SERVE_LAYERS.get(model, full.n_layers))
    api = build_model(cfg, device=DEVICE)
    recorded = {}

    def recording_step(params, cache, tokens, pos_index):
        """The model's decode step, keeping the logits at the check positions."""
        logits, cache = api.decode_step(params, cache, tokens, pos_index)
        if pos_index in SSM_CHECK_POSITIONS:
            recorded[pos_index] = logits[:, 0].float()
        return logits, cache

    t0 = time.perf_counter()
    files = checkpoint_files(0, f"{model}-chip-smoke", api.init(seed=seed))
    engine = DecodeEngine.from_files(dataclasses.replace(api, decode_step=recording_step), files,
                                     batch=SSM_BATCH, max_len=SSM_MAX_LEN)
    n_bytes = sum(len(b) for b in files.values())
    del files
    sync(torch)
    kinds = cfg.layer_kinds()
    log(f"ssm: {cfg.name} ({kinds.count('mamba')} mamba + {len(kinds) - kinds.count('mamba')} "
        f"attention layers of its {full.n_layers}, d_model {cfg.d_model}, {cfg.ssm.n_heads(cfg.d_model)} SSD heads of "
        f"{cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}, vocab {cfg.vocab_size}) through "
        f"{n_bytes / 2**30:.2f} GiB of checkpoint files in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SSM_BATCH, SSM_PROMPT_LEN)))
    steps = SSM_PROMPT_LEN + SSM_NEW_TOKENS - 1
    before = read_counts()
    sync(torch)
    t0 = time.perf_counter()
    new = engine.generate(prompts, SSM_NEW_TOKENS)
    sync(torch)
    elapsed = time.perf_counter() - t0
    per_step = path_launches(cfg, "step")
    check_launches(before, {k: v * steps for k, v in per_step.items()}, f"{model} decode")
    if new.shape != (SSM_BATCH, SSM_NEW_TOKENS) or not bool(
            ((new >= 0) & (new < cfg.vocab_size)).all()):
        raise AssertionError(f"bad generated tokens {new.shape}")
    out = dict(decode_ms_per_step=elapsed / steps * 1e3, decode_tokens_per_s=SSM_BATCH * steps / elapsed)
    log(f"ssm: {model}: {steps} decode steps at batch {SSM_BATCH}: {elapsed:.3f} s, "
        f"{out['decode_ms_per_step']:.3f} ms/step, {out['decode_tokens_per_s']:.1f} tokens/s on "
        f"{smi}; launches per step {per_step}")

    def logit_errors(dec, ref):
        scale = max(1.0, ref.abs().max().item())
        err = (torch.stack([dec[p] for p in SSM_CHECK_POSITIONS], dim=1) - ref).abs()
        if not bool(err.isfinite().all()):
            raise AssertionError(f"{model}: non-finite decode or forward logits")
        return {p: err[:, j].max().item() / scale for j, p in enumerate(SSM_CHECK_POSITIONS)}, (
            err.mean().item() / scale)

    fed = torch.cat([prompts.to(new.device), new], dim=1)[:, :steps]  # the tokens decoded
    with torch.no_grad():
        before = read_counts()
        hidden = api.forward(engine.params, fed, return_hidden=True)
        check_launches(before, path_launches(cfg, "forward"), f"{model} forward")
        ref = unembed(hidden[:, list(SSM_CHECK_POSITIONS)], engine.params["embed"], cfg).float()
        del hidden
        bf16_pos, bf16_mean = logit_errors(recorded, ref)
        # layer 0's chunked final state against the engine's after the same tokens
        bp = _group_slice(engine.params["groups"]["pos0"], 0)
        h0 = rms_norm(embed(fed, engine.params["embed"], cfg), bp["ln1"], cfg.norm_eps)
        _, state = mamba_block(bp["mamba"], h0, cfg)
        eng_state = engine.cache["groups"]["pos0"]["ssm"][0]
        state_err = (state - eng_state).abs().max().item() / max(1.0, state.abs().max().item())
        del ref, state, eng_state, h0

        # the same weights in fp32: decode against forward at every position
        cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
        api32 = build_model(cfg32, device=DEVICE)
        params32 = tree_map(lambda t: t.float() if t.is_floating_point() else t, engine.params)
        cache = api32.init_cache(SSM_BATCH, SSM_MAX_LEN)
        dec32 = {}
        for i in range(steps):
            lg, cache = api32.decode_step(params32, cache, fed[:, i : i + 1], i)
            if i in SSM_CHECK_POSITIONS:
                dec32[i] = lg[:, 0].float()
        del cache
        hidden = api32.forward(params32, fed, return_hidden=True)
        ref32 = unembed(hidden[:, list(SSM_CHECK_POSITIONS)], params32["embed"], cfg32)
        del hidden, params32
        fp32_pos, fp32_mean = logit_errors(dec32, ref32)
    log(f"ssm: {model}: bf16 engine vs bf16 forward logits at positions {SSM_CHECK_POSITIONS}: "
        f"max |err| / max(1, max |logit|) = {bf16_pos}, mean {bf16_mean:.2e} (position 0 tol "
        f"{LOGIT_TOL}, the others {SSM_BF16_LOGIT_TOL}, mean {SSM_BF16_LOGIT_MEAN_TOL}); fp32 decode vs fp32 forward: {fp32_pos}, mean {fp32_mean:.2e} (tol "
        f"{LOGIT_TOL}, mean {LOGIT_MEAN_TOL}); layer 0 state, engine vs chunk scan: max |err| / "
        f"max(1, max |state|) {state_err:.2e} (tol {STATE_TOL})")
    if bf16_pos[SSM_CHECK_POSITIONS[0]] > LOGIT_TOL:
        raise AssertionError(f"{model}: bf16 decode logits at position 0 disagree with the forward")
    if max(bf16_pos.values()) > SSM_BF16_LOGIT_TOL or bf16_mean > SSM_BF16_LOGIT_MEAN_TOL:
        raise AssertionError(f"{model}: bf16 decode logits disagree with the forward past position 0")
    if max(fp32_pos.values()) > LOGIT_TOL or fp32_mean > LOGIT_MEAN_TOL:
        raise AssertionError(f"{model}: fp32 decode logits disagree with the teacher-forced forward")
    if not state_err <= STATE_TOL:
        raise AssertionError(f"{model}: the engine's SSM state disagrees with the chunk scan")
    out.update(bf16_logit_err=bf16_pos, bf16_logit_mean_err=bf16_mean, fp32_logit_err=fp32_pos,
               fp32_logit_mean_err=fp32_mean, state_err=state_err)
    if profile:  # decodes on past the checked state
        phase_profile(torch, engine, engine.cache, new)

    if prefill_len:
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, prefill_len))).to(DEVICE)
        if cfg != full:  # the prefill at full depth, its weights drawn on the card
            del engine
            if DEVICE == "cuda":
                torch.cuda.empty_cache()
            api = build_model(full, device=DEVICE)
            engine = types.SimpleNamespace(params=api.init(seed=seed))
        runs = []
        with torch.no_grad():
            for _ in range(2):  # the first pays first-use allocations
                before = read_counts()
                sync(torch)
                t0 = time.perf_counter()
                logits = api.forward(engine.params, tokens, last_only=True)
                sync(torch)
                runs.append(time.perf_counter() - t0)
                check_launches(before, path_launches(full, "forward"), f"{model} prefill")
        if logits.shape != (1, 1, cfg.vocab_size) or not bool(logits.isfinite().all()):
            raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite")
        out.update(prefill_len=prefill_len, prefill_layers=full.n_layers, prefill_ms=runs[1] * 1e3,
                   prefill_tokens_per_s=prefill_len / runs[1], prefill_first_ms=runs[0] * 1e3)
        log(f"ssm: {model}: prefill of {prefill_len} tokens at batch 1 ({full.n_layers} layers, "
            f"forward, last_only): "
            f"{runs[1] * 1e3:.3f} ms, {prefill_len / runs[1]:.1f} tokens/s (first run "
            f"{runs[0] * 1e3:.3f} ms) on {smi}")
        if profile:
            phase_profile_prefill(torch, lambda: api.forward(engine.params, tokens, last_only=True))
    return out


def phase_profile_prefill(torch, run):
    """Device time of one more prefill by kernel group."""
    from torch.profiler import ProfilerActivity, profile

    sync(torch)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync(torch)
        wall = time.perf_counter() - t0
    groups, passes, total = {}, {}, 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        total += t
        low = ev.key.lower()
        if "ssd_scan" in low:
            g = "B4 ssd_scan (CUDA)"
            kernel = low.split("ssd_scan_", 1)[1].split("_kernel", 1)[0]
            passes[kernel] = passes.get(kernel, 0.0) + t
        elif "rmsnorm" in low:
            g = "B3a rmsnorm (Triton)"
        elif any(x in low for x in ("gemm", "gemv", "cutlass", "xmma", "nvjet", "splitk")):
            g = "matmul (cuBLAS)"
        elif any(x in low for x in ("elementwise", "reduce", "copy", "vectorized", "index",
                                    "fill", "cat")):
            g = "PyTorch elementwise/reduce/copy/index"
        else:
            g = "other: " + ev.key[:60]
        groups[g] = groups.get(g, 0.0) + t
    log(f"profile prefill: wall {wall * 1e3:.3f} ms, device busy {total / 1e3:.3f} ms "
        f"({100 * total / 1e6 / wall:.1f} %)")
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1])[:10]:
        log(f"profile prefill:   {t / 1e3:9.3f} ms  {g}")
    for kernel, t in sorted(passes.items(), key=lambda kv: -kv[1]):
        log(f"profile prefill:     {t / 1e3:9.3f} ms  B4 pass {kernel}")


# ------------------------------------------------------------ phase 7
def host_available_bytes() -> int:
    """MemAvailable of /proc/meminfo."""
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


class HostPeak:
    """Peak resident set of this process, sampled every 10 ms by a thread
    between ``with`` entry and exit."""

    def __init__(self):
        import threading

        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    @staticmethod
    def resident() -> int:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _sample(self) -> None:
        while not self._stop.is_set():
            self.peak = max(self.peak, self.resident())
            self._stop.wait(0.01)

    def __enter__(self):
        self.start = self.resident()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)


@contextlib.contextmanager
def plain_versions_forbidden():
    """While on, every kernel wrapper's plain version raises: a path run
    inside it went through the kernels or failed."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    names = [(dec_ops, "decode_attention_ref"), (fa_ops, "flash_attention_ref"),
             (fa_ops, "flash_attention_bwd_ref"), (norm_ops, "rmsnorm_ref"),
             (norm_ops, "rmsnorm_bwd_ref"), (norm_ops, "rmsnorm_residual_ref"),
             (ssd_ops, "ssd_ref"), (ssd_ops, "ssd_bwd_ref"),
             (dec_ops, "decode_attention_partial_ref"), (norm_ops, "row_stat_ref"),
             (norm_ops, "rmsnorm_ext_ref"), (norm_ops, "rmsnorm_ext_bwd_ref")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in names]

    def refuse(name):
        def call(*a, **k):
            raise AssertionError(f"plain version {name} ran on the pilot path")
        return call

    for mod, name, _ in saved:
        setattr(mod, name, refuse(name))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def plain_versions_on_card():
    """While on, the models call the kernels' plain versions (differentiable
    PyTorch) instead of the wrappers, on whatever device their tensors are:
    a reference loss and gradients on the card."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    from repro_torch.models import attention, layers, mamba2

    def rmsnorm(x, w, eps=1e-6, residual=None):
        if residual is not None:
            raise AssertionError("the models call no residual RMSNorm")
        return rmsnorm_ref(x, w, eps)

    def flash_attention(q, k, v, *, causal=True, window=None):
        return flash_attention_ref(q, k, v, causal=causal, window=window)[0]

    def ssd(x, dA, B, C, chunk=256, initial_state=None):
        return ssd_ref(x, dA, B, C, min(chunk, x.shape[1]), initial_state)

    patches = [(layers, "rmsnorm", rmsnorm), (attention, "flash_attention", flash_attention),
               (mamba2, "ssd", ssd)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def pilot_fleet(tag: str):
    """A Session on two pods of one host each, as examples/pilot_train.py
    builds it: a Pilot-Data (host memory, see PILOT_TRAIN_LAYERS) and a
    one-slot pilot in each pod.  The fault manager stays off: checkpoints
    keep one replica."""
    from repro_torch.core import Session, make_tpu_fleet_topology

    topo, _ = make_tpu_fleet_topology(pods=2, hosts_per_pod=1)
    with Session(topology=topo) as s:
        for pod in (0, 1):
            s.start_pilot_data(service_url=f"mem://cluster:pod{pod}/{tag}{pod}",
                               affinity=f"cluster:pod{pod}")
        pilots = [s.start_pilot(resource_url=f"sim://cluster:pod{pod}:host0", slots=1)
                  for pod in (0, 1)]
        for p in pilots:
            p.wait_active()
        yield s


def released(*args, **kwargs):
    raise RuntimeError("this executable's run is over and its state released")


def du_file(session, fut, rel: str) -> bytes:
    """A file of a sealed DU, read from its first replica."""
    du = session.ctx.lookup(fut.id)
    return session.ctx.lookup(du.locations[0]).fetch_du_file(du.id, rel)


def du_params(session, fut, device):
    """The ``params/`` leaves of a checkpoint DU on ``device``."""
    from repro_torch.checkpoint import decode_array, unflatten_tree

    du = session.ctx.lookup(fut.id)
    return unflatten_tree({
        rel[7:-4]: decode_array(du_file(session, fut, rel)).to(device)
        for rel in du.manifest if rel.startswith("params/") and rel.endswith(".npy")})


def phase_pilot_train(torch, seed, smi, step_s: float):
    """TRAIN_MODEL (cut to PILOT_TRAIN_LAYERS) trained by PilotTrainer as two
    train_chunk CUs; ``step_s`` is phase 5's s/step, the bare loop's."""
    import dataclasses

    import numpy as np

    from repro_torch.checkpoint import decode_array
    from repro_torch.configs import get_config
    from repro_torch.core import FUNCTIONS
    from repro_torch.data import decode_raw_tokens
    from repro_torch.training import make_eval_step
    from repro_torch.training.trainer import PilotTrainer

    cfg = get_config(TRAIN_MODEL)
    full_layers = cfg.n_layers
    if PILOT_TRAIN_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=PILOT_TRAIN_LAYERS)
    # bf16 params, fp32 m, v and masters
    predicted = cfg.param_count() * (2 + 3 * 4)
    avail = host_available_bytes()
    log(f"pilot: {cfg.name} at {cfg.n_layers} of {full_layers} layers (d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, {cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab_size}): "
        f"checkpoint ~{predicted / 1e9:.2f} GB; host {avail / 1e9:.1f} GB available (needs "
        f"~{PILOT_HOST_COPIES} x)")
    if avail < PILOT_HOST_COPIES * predicted:
        raise RuntimeError(f"pilot: {avail / 1e9:.1f} GB of host memory cannot hold "
                           f"{PILOT_HOST_COPIES} x {predicted / 1e9:.2f} GB of checkpoints")

    with pilot_fleet("chip-smoke-train") as s:
        tr = PilotTrainer(cfg, s, total_steps=PILOT_STEPS, chunk_steps=PILOT_CHUNK_STEPS,
                          batch=TRAIN_BATCH, seq=TRAIN_SEQ, peak_lr=TRAIN_LR, n_shards=2,
                          # no chunk wraps its shard: the shards hold every step's window
                          tokens_per_shard=PILOT_STEPS * TRAIN_BATCH * (TRAIN_SEQ + 1),
                          seed=seed, run_name="chip-smoke-pilot",
                          # one card, and up to 7 x the checkpoint in host memory already
                          ckpt_replication=1, device=DEVICE)
        # instruments: each step's time (synchronised), each CU body's span,
        # launches and errors, each CU's completion time
        step_spans, cu_runs, errors, done_at = [], [], [], {}
        step_fn = tr.train_step

        def timed_step(params, opt, batch):
            sync(torch)
            t0 = time.monotonic()
            out = step_fn(params, opt, batch)
            sync(torch)
            step_spans.append((t0, time.monotonic()))
            return out

        tr.train_step = timed_step
        name = f"train_chunk:{tr.run_name}"
        body = FUNCTIONS.resolve(name)

        def counted_chunk(cu_ctx, *args):
            before, n0, t0 = read_counts(), len(step_spans), time.monotonic()
            try:
                res = body(cu_ctx, *args)
            except BaseException as e:
                errors.append(e)
                raise
            cu_runs.append(dict(cu=cu_ctx.cu.id, pilot=cu_ctx.pilot.id, start=t0,
                                end=time.monotonic(), steps=step_spans[n0:],
                                launches={k: v - before[k] for k, v in read_counts().items()}))
            return res

        FUNCTIONS.register(name, counted_chunk)
        submit = tr.submit_dag

        def submit_dag():
            chunks = submit()
            for *_, cu in chunks:
                cu.add_done_callback(lambda f: done_at.setdefault(f.id, time.monotonic()))
            return chunks

        tr.submit_dag = submit_dag

        torch.cuda.reset_peak_memory_stats()
        with HostPeak() as host, plain_versions_forbidden():
            t0 = time.monotonic()
            tr.stage_data(affinities=["cluster:pod0", "cluster:pod1"])
            tr.initial_checkpoint()
            sync(torch)
            init_s = time.monotonic() - t0
            reset_counts()
            t0 = time.monotonic()
            summary = tr.run(timeout_per_chunk=PILOT_TIMEOUT_S)
            run_s = time.monotonic() - t0
            launches = read_counts()
        device_peak = torch.cuda.max_memory_allocated() / 2**30
        if errors:
            raise AssertionError(f"pilot: a train_chunk CU raised: {errors[0]!r}") from errors[0]
        # the done callbacks run on the session's dispatcher thread, which
        # may trail the result() that woke this one
        deadline = time.monotonic() + 60
        while len(done_at) < len(cu_runs) and time.monotonic() < deadline:
            time.sleep(0.01)
        per_step = train_launch_schedule(cfg)
        if len(cu_runs) != summary["chunks"] or summary["chunks"] != PILOT_STEPS // PILOT_CHUNK_STEPS:
            raise AssertionError(f"pilot: {len(cu_runs)} CU runs for {summary['chunks']} chunks")
        cus = []
        for h, run in zip(summary["history"], cu_runs):
            n = h["steps"][1] - h["steps"][0]
            expected = {k: v * n for k, v in per_step.items()}
            if run["launches"] != expected:
                raise AssertionError(f"pilot: CU {run['cu']} launches {run['launches']} != "
                                     f"{expected} ({n} steps)")
            if len(h["losses"]) != n or not all(math.isfinite(x) for x in h["losses"]):
                raise AssertionError(f"pilot: CU {run['cu']} losses {h['losses']}")
            cu = s.ctx.lookup(run["cu"])
            t = cu.timings
            steps = [b - a for a, b in run["steps"]]
            cus.append(dict(
                cu=run["cu"], pilot=run["pilot"], steps=h["steps"], losses=h["losses"],
                wall_s=done_at[run["cu"]] - t.stage_start, queue_s=t.t_q_task,
                stage_in_s=t.t_s, restore_s=run["steps"][0][0] - run["start"],
                step_s=steps, loop_s=sum(steps),
                encode_write_s=run["end"] - run["steps"][-1][1],
                publish_s=done_at[run["cu"]] - run["end"], launches=run["launches"]))
        if tr.api.device.type != torch.device(DEVICE).type:
            raise AssertionError(f"pilot: the CUs trained on {tr.api.device}")
        ckpt_bytes = [s.ctx.lookup(f.id).size for f in tr.ckpt_dus]
        meta = json.loads(du_file(s, tr.ckpt_dus[-1], "meta.json"))
        opt_step = int(decode_array(du_file(s, tr.ckpt_dus[-1], "opt/step.npy")))
        if meta != {"step": PILOT_STEPS, "run": tr.run_name} or opt_step != PILOT_STEPS:
            raise AssertionError(f"pilot: last checkpoint meta {meta}, opt/step {opt_step}")

        # one fixed batch: step 0's window of shard 0
        shard = s.ctx.lookup(tr.shard_dus[0].id)
        toks = np.concatenate([decode_raw_tokens(du_file(s, tr.shard_dus[0], rel))
                               for rel in sorted(shard.manifest)])
        window = torch.from_numpy(toks[: TRAIN_BATCH * (TRAIN_SEQ + 1)].reshape(
            TRAIN_BATCH, TRAIN_SEQ + 1).astype(np.int32)).to(DEVICE)
        batch = {"tokens": window[:, :-1].contiguous(), "labels": window[:, 1:].contiguous()}
        eval_step = make_eval_step(tr.api)
        evals = []
        with plain_versions_forbidden():
            for fut in (tr.ckpt_dus[0], tr.ckpt_dus[-1]):
                params = du_params(s, fut, tr.api.device)
                evals.append(float(eval_step(params, batch)["loss"]))
                del params
        if not all(math.isfinite(x) for x in evals) or not evals[1] < evals[0]:
            raise AssertionError(f"pilot: eval loss {evals[0]} (ckpt_0) -> {evals[1]} "
                                 f"(ckpt_{PILOT_STEPS}) did not fall")
        # the run is over: release its host copies before the serve CUs, the
        # DUs' replicas in the mem:// Pilot-Data and sandboxes (kept by the
        # process-wide memory backend) and the trainer with its DUs' staging
        # buffers (kept by the executable registry)
        for fut in tr.ckpt_dus + tr.shard_dus:
            du = s.ctx.lookup(fut.id)
            for pd_id in set(du.locations) | set(du.chunk_holders()):
                s.ctx.lookup(pd_id).remove_du(du)
        FUNCTIONS.register(name, released)
    log(f"pilot: train through {summary['chunks']} train_chunk CUs on pilots "
        f"{summary['pilots_used']}: set-up (shards + ckpt_0) {init_s:.3f} s, DAG {run_s:.3f} s; "
        f"checkpoint DUs {[b / 1e9 for b in ckpt_bytes]} GB; host resident peak "
        f"{host.peak / 1e9:.2f} GB (from {host.start / 1e9:.2f} GB), device peak "
        f"{device_peak:.2f} GiB on {smi}")
    for c in cus:
        log(f"pilot: CU {c['cu']} on {c['pilot']} steps {c['steps']}, queued {c['queue_s']:.3f} s "
            f"from submission: wall {c['wall_s']:.3f} s = stage-in {c['stage_in_s']:.3f} + restore "
            f"{c['restore_s']:.3f} + step loop {c['loop_s']:.3f} (steps {c['step_s']}) + encode "
            f"and write {c['encode_write_s']:.3f} + publish {c['publish_s']:.3f}; the bare loop's "
            f"2 steps {2 * step_s:.3f} s (phase 5); losses {c['losses']}; launches {c['launches']}")
    log(f"pilot: eval loss on one fixed batch {evals[0]:.6f} (ckpt_0) -> {evals[1]:.6f} "
        f"(ckpt_{PILOT_STEPS}); last checkpoint meta {meta}, opt/step {opt_step}")
    return launches, dict(
        layers=cfg.n_layers, ckpt_bytes=ckpt_bytes, init_s=init_s, dag_s=run_s, cus=cus,
        eval_loss=evals, host_peak_bytes=host.peak, host_start_bytes=host.start,
        device_peak_gib=device_peak, bare_loop_2_steps_s=2 * step_s)


def phase_pilot_serve(torch, seed, smi):
    """MODEL's weights saved once as a checkpoint DU, then decoded by two
    serve CUs on two pilots at once, each loading the DU it declares as
    input; both must give a direct engine's tokens."""
    import numpy as np

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.core import FUNCTIONS
    from repro_torch.models import build_model
    from repro_torch.serving import DecodeEngine

    while gc.collect():  # phase 7's train run, left unreachable in cycles
        pass
    log(f"pilot: host resident {HostPeak.resident() / 1e9:.2f} GB before the serve CUs")
    cfg = get_config(MODEL)
    api = build_model(cfg, device=DEVICE)
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (BATCH, PROMPT_LEN))
    prompts = prompts[:, :PILOT_SERVE_PROMPT_LEN].tolist()  # phase 4's first tokens
    runs, errors = {}, []

    def serve_batch(cu_ctx, weights_du, prompt_tokens, new_tokens):
        try:
            t0 = time.monotonic()
            engine = DecodeEngine.from_cu_context(api, cu_ctx, weights_du,
                                                  batch=len(prompt_tokens),
                                                  max_len=PILOT_SERVE_MAX_LEN)
            sync(torch)
            t1 = time.monotonic()
            out = engine.generate(torch.tensor(prompt_tokens), new_tokens).cpu().tolist()
            runs[cu_ctx.cu.id] = dict(pilot=cu_ctx.pilot.id, load_s=t1 - t0,
                                      generate_s=time.monotonic() - t1)
            return out
        except BaseException as e:
            errors.append(e)
            raise

    with pilot_fleet("chip-smoke-serve") as s:
        FUNCTIONS.register("chip-smoke-serve", serve_batch)
        params = api.init(seed=seed)
        t0 = time.monotonic()
        du = Checkpointer(s, run_name="chip-smoke-serve").save(0, params)
        save_s = time.monotonic() - t0
        with plain_versions_forbidden():
            reset_counts()
            sync(torch)
            t0 = time.monotonic()
            cus = [s.submit_cu(executable="chip-smoke-serve",
                               args=(du.id, prompts, PILOT_SERVE_NEW_TOKENS),
                               input_data=[du], affinity=f"cluster:pod{pod}")
                   for pod in (0, 1)]
            outs = [cu.result(timeout=PILOT_TIMEOUT_S) for cu in cus]
            serve_s = time.monotonic() - t0
            launches = read_counts()
            direct = DecodeEngine(api, params, batch=BATCH, max_len=PILOT_SERVE_MAX_LEN).generate(
                torch.tensor(prompts), PILOT_SERVE_NEW_TOKENS).cpu().tolist()
        if errors:
            raise AssertionError(f"pilot: a serve CU raised: {errors[0]!r}") from errors[0]
        timings = [dict(cu=cu.id, stage_in_s=cu.timings.t_s, **runs[cu.id]) for cu in cus]
        pilots = {cu.pilot_id for cu in cus}
        n_bytes = du.size
    steps = PILOT_SERVE_PROMPT_LEN + PILOT_SERVE_NEW_TOKENS - 1
    expected = {name: 0 for name, _, _ in counters()}
    expected.update(decode_attention=2 * cfg.n_layers * steps,
                    rmsnorm=2 * (2 * cfg.n_layers + 1) * steps)
    if launches != expected:
        raise AssertionError(f"pilot: serve CUs launches {launches} != {expected}")
    if len(pilots) != 2 or outs[0] != outs[1] or outs[0] != direct:
        raise AssertionError(f"pilot: serve CUs on {pilots} gave {outs}, the direct engine {direct}")
    log(f"pilot: serve {cfg.name} weights DU {n_bytes / 1e9:.3f} GB saved in {save_s:.3f} s; two "
        f"serve CUs (batch {BATCH}, {PILOT_SERVE_PROMPT_LEN} + {PILOT_SERVE_NEW_TOKENS} tokens) on "
        f"{sorted(pilots)} in {serve_s:.3f} s: {timings}; tokens identical to each other and to "
        f"a direct engine; launches {launches}")
    return launches, dict(weights_bytes=n_bytes, save_s=save_s, serve_s=serve_s, cus=timings)


# ------------------------------------------------------------ phase 8
def phase_moe(torch, seed, smi, profile: bool = False):
    """MOE_MODEL, cut to MOE_SERVE_LAYERS, served from checkpoint files on
    the bf16 and the int8 KV cache, every plain version refused; decode
    logits against the drop-free teacher-forced forward (capacity factor E /
    k, capacity T): decode at MOE_BATCH tokens never drops (an expert takes at
    most 4 <= 8 tokens), so that forward computes decode's function.  The
    forward at the published capacity factor logs how many (token, expert)
    pairs it drops."""
    import dataclasses

    import numpy as np

    from repro_torch.checkpoint import checkpoint_files, flatten_tree
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, moe
    from repro_torch.models.layers import unembed
    from repro_torch.serving import DecodeEngine

    full = get_config(MOE_MODEL)
    cfg = dataclasses.replace(full, n_layers=MOE_SERVE_LAYERS or full.n_layers)
    m = cfg.moe
    api = build_model(cfg, device=DEVICE)
    recorded = {}

    def recording(api_, kv):
        """The model's decode step, keeping the logits at the check positions."""
        def step(params, cache, tokens, pos_index):
            logits, cache = api_.decode_step(params, cache, tokens, pos_index)
            if pos_index in MOE_CHECK_POSITIONS:
                recorded[kv, pos_index] = logits[:, 0].float()
            return logits, cache
        return dataclasses.replace(api_, decode_step=step)

    t0 = time.perf_counter()
    files = checkpoint_files(0, f"{MOE_MODEL}-chip-smoke", api.init(seed=seed))
    engine = DecodeEngine.from_files(recording(api, "bfloat16"), files, batch=MOE_BATCH,
                                     max_len=MOE_MAX_LEN)
    n_bytes = sum(len(b) for b in files.values())
    del files
    params = engine.params
    n_params = sum(t.numel() for _, t in flatten_tree(params))
    sync(torch)
    load_s = time.perf_counter() - t0
    log(f"moe: {cfg.name} ({cfg.n_layers} of its {full.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.head_dim_} (GQA group {cfg.n_heads // cfg.n_kv_heads}), "
        f"{m.n_experts} experts top-{m.top_k} of d_ff {m.d_ff_expert}, vocab {cfg.vocab_size}, "
        f"{n_params / 1e9:.3f} B params) through {n_bytes / 2**30:.2f} GiB of checkpoint files "
        f"in {load_s:.1f} s")

    from repro_torch.kernels.decode_attention import ops as dec_ops

    plan = decode_plan(torch, dec_ops, MOE_BATCH, cfg.n_kv_heads, MOE_MAX_LEN, cfg.head_dim_,
                       cfg.n_heads // cfg.n_kv_heads)
    log(f"moe: B2's split plan for the {MOE_MAX_LEN}-slot cache at batch {MOE_BATCH}: {plan}")
    prompts = torch.from_numpy(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT_LEN)))
    steps = MOE_PROMPT_LEN + MOE_NEW_TOKENS - 1
    per_step, per_forward = path_launches(cfg, "step"), path_launches(cfg, "forward")
    out, seqs = {}, {}
    cf = m.n_experts / m.top_k
    nodrop = build_model(dataclasses.replace(cfg, moe=dataclasses.replace(m, capacity_factor=cf)),
                         device=DEVICE)
    before_phase = read_counts()
    with plain_versions_forbidden(), torch.no_grad():
        for kv in ("bfloat16", "int8"):
            eng = engine
            if kv == "int8":
                api8 = build_model(dataclasses.replace(cfg, kv_cache_dtype="int8"), device=DEVICE)
                eng = DecodeEngine(recording(api8, kv), params, batch=MOE_BATCH, max_len=MOE_MAX_LEN)
                if eng.cache["groups"]["pos0"]["k"].dtype != torch.int8:
                    raise AssertionError("moe: the int8 engine's cache is not int8")
            before = read_counts()
            sync(torch)
            t0 = time.perf_counter()
            new = eng.generate(prompts, MOE_NEW_TOKENS)
            sync(torch)
            elapsed = time.perf_counter() - t0
            check_launches(before, {k: v * steps for k, v in per_step.items()}, f"moe {kv} decode")
            if new.shape != (MOE_BATCH, MOE_NEW_TOKENS) or not bool(
                    ((new >= 0) & (new < cfg.vocab_size)).all()):
                raise AssertionError(f"moe: bad generated tokens {tuple(new.shape)}")
            seqs[kv] = torch.cat([prompts.to(new.device), new], dim=1)  # [B, 280]
            out[kv] = dict(ms_per_step=elapsed / steps * 1e3,
                           tokens_per_s=MOE_BATCH * steps / elapsed)
            log(f"moe: {kv} KV cache: {steps} decode steps at batch {MOE_BATCH}: {elapsed:.3f} s, "
                f"{out[kv]['ms_per_step']:.3f} ms/step, {out[kv]['tokens_per_s']:.1f} tokens/s "
                f"on {smi}; launches per step {per_step}")
            del eng
        same = torch.equal(seqs["int8"], seqs["bfloat16"])
        refs = {}
        for kv in ("bfloat16", "int8"):
            if kv == "int8" and same:
                refs[kv] = refs["bfloat16"]
                continue
            before = read_counts()
            hidden = nodrop.forward(params, seqs[kv], return_hidden=True)
            check_launches(before, per_forward, f"moe drop-free forward over the {kv} tokens")
            refs[kv] = unembed(hidden[:, list(MOE_CHECK_POSITIONS)], params["embed"], cfg).float()
            del hidden
        # the published capacity factor: count the pairs that each layer drops
        dropped, dispatch = [], moe._dispatch_tables

        def counting_dispatch(expert_idx, n_tokens, e_pad, cap):
            slot_table, token_slots = dispatch(expert_idx, n_tokens, e_pad, cap)
            dropped.append((token_slots == e_pad * cap).sum())
            return slot_table, token_slots

        moe._dispatch_tables = counting_dispatch
        try:
            before = read_counts()
            hidden = api.forward(params, seqs["bfloat16"], return_hidden=True)
            check_launches(before, per_forward, "moe forward at the published capacity factor")
        finally:
            moe._dispatch_tables = dispatch
        published = unembed(hidden[:, list(MOE_CHECK_POSITIONS)], params["embed"], cfg).float()
        del hidden
    launches = {k: v - before_phase[k] for k, v in read_counts().items()}
    n_fwd = 2 if same else 3  # drop-free (per distinct token sequence), published
    expected = {k: 2 * steps * per_step[k] + n_fwd * per_forward[k] for k in per_step}
    if launches != expected:
        raise AssertionError(f"moe: launches {launches} != {expected}")

    def errors(kv, ref):
        dec = torch.stack([recorded[kv, p] for p in MOE_CHECK_POSITIONS], dim=1)
        if dec.shape != ref.shape or not bool(dec.isfinite().all()):
            raise AssertionError(f"moe: {kv} decode logits {tuple(dec.shape)} not finite")
        scale = max(1.0, ref.abs().max().item())
        err = (dec - ref).abs()
        return ({p: err[:, j].max().item() / scale for j, p in enumerate(MOE_CHECK_POSITIONS)},
                err.mean().item() / scale)

    bf16_pos, bf16_mean = errors("bfloat16", refs["bfloat16"])
    int8_pos, int8_mean = errors("int8", refs["int8"])
    pub_pos, pub_mean = errors("bfloat16", published)
    n_dropped = int(torch.stack(dropped).sum())
    n_pairs = cfg.n_layers * MOE_BATCH * (MOE_PROMPT_LEN + MOE_NEW_TOKENS) * m.top_k
    log(f"moe: decode vs the drop-free forward (capacity factor {cf:g}) at positions "
        f"{MOE_CHECK_POSITIONS}: bf16 cache max |err| / max(1, max |logit|) = {bf16_pos}, mean "
        f"{bf16_mean:.2e} (tol {LOGIT_TOL}, mean {LOGIT_MEAN_TOL}); int8 cache {int8_pos}, mean "
        f"{int8_mean:.2e} (tol {MOE_INT8_LOGIT_TOL}; its tokens "
        f"{'equal' if same else 'differ from'} the bf16 engine's)")
    log(f"moe: the forward at the published capacity factor {m.capacity_factor} drops "
        f"{n_dropped} of {n_pairs} (token, expert) pairs ({100 * n_dropped / n_pairs:.2f} %); its "
        f"logits against the bf16 decode: {pub_pos}, mean {pub_mean:.2e} (logged, not a gate)")
    log(f"moe: launches {launches} = 2 x {steps} decode steps x {per_step} + {n_fwd} forwards "
        f"x {per_forward}")
    if max(bf16_pos.values()) > LOGIT_TOL or bf16_mean > LOGIT_MEAN_TOL:
        raise AssertionError("moe: bf16-cache decode logits disagree with the drop-free forward")
    if max(int8_pos.values()) > MOE_INT8_LOGIT_TOL:
        raise AssertionError("moe: int8-cache decode logits disagree with the drop-free forward")
    out.update(params=n_params, checkpoint_bytes=n_bytes, load_s=load_s, b2_plan=plan,
               bf16_logit_err=bf16_pos, bf16_logit_mean_err=bf16_mean, int8_logit_err=int8_pos,
               int8_logit_mean_err=int8_mean, int8_tokens_equal=same, dropped_pairs=n_dropped,
               pairs=n_pairs, published_cf_logit_err=pub_pos)
    if profile:  # decodes on past the served sequence
        phase_profile(torch, engine, engine.cache, seqs["bfloat16"])
    return launches, out



# ------------------------------------------------------------ phase 9
def moe_layer_times(torch, api, params, batch_rows: int):
    """Device ms of one MoE layer (layer 0's weights) at ``batch_rows``
    tokens of the train batch, alone: its forward, and its backward (to its
    input, router and experts)."""
    from repro_torch.models.moe import moe_mlp_local
    from repro_torch.models.transformer import _group_slice

    cfg = api.cfg
    timer = Timer(torch)
    lp = _group_slice(params["groups"], 0)["pos0"]["moe"]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x = torch.randn(1, batch_rows, cfg.d_model, generator=gen, device=DEVICE).to(
        getattr(torch, cfg.compute_dtype)).requires_grad_()
    with torch.no_grad():
        fwd = timer(lambda: moe_mlp_local(lp, x, cfg), iters=10)
    out, aux = moe_mlp_local(lp, x, cfg)
    dy = torch.randn(out.shape, generator=gen, device=DEVICE).to(out.dtype)
    leaves = [x, lp["router"]["w"], lp["gate"], lp["up"], lp["down"]]
    bwd = timer(lambda: torch.autograd.grad((out, aux), leaves, (dy, torch.ones_like(aux)),
                                            retain_graph=True), iters=10)
    del out, aux, dy, timer
    return fwd, bwd


def moe_remat_check(torch, seed, cfg, batch) -> dict:
    """At MOE_REMAT_LAYERS of the model's layers (the cut is of depth only),
    the gradients of ``loss_fn`` with remat against those without: the
    routing that the backward pass recomputes must be the forward's (the
    same experts and slots, so the same pairs dropped), and every leaf's
    gradient must agree within one bf16 ulp of its largest value."""
    import dataclasses

    from repro_torch.checkpoint import flatten_tree
    from repro_torch.models import build_model, moe

    cfg = dataclasses.replace(cfg, n_layers=MOE_REMAT_LAYERS or cfg.n_layers)
    api = build_model(cfg, device=DEVICE)
    params = api.init(seed=seed)
    leaves = flatten_tree(params)
    tensors = [t.requires_grad_(True) for _, t in leaves]
    dispatch, tables = moe._dispatch_tables, []

    def recording(expert_idx, n_tokens, e_pad, cap):
        slot_table, token_slots = dispatch(expert_idx, n_tokens, e_pad, cap)
        tables.append((expert_idx.clone(), token_slots.clone(),
                       int((token_slots == e_pad * cap).sum())))
        return slot_table, token_slots

    runs = {}
    moe._dispatch_tables = recording
    try:
        for remat in (True, False):
            tables.clear()
            loss, _ = api.loss_fn(params, batch, remat=remat)
            grads = torch.autograd.grad(loss, tensors)
            runs[remat] = (float(loss.detach()), grads, list(tables))
            del loss
    finally:
        moe._dispatch_tables = dispatch
    n = cfg.n_layers
    fwd, again = runs[True][2][:n], runs[True][2][n:][::-1]  # recomputed last layer first
    if len(again) != n or len(runs[False][2]) != n:
        raise AssertionError(f"moe-train remat check: {len(runs[True][2])} dispatches with remat, "
                             f"{len(runs[False][2])} without, for {n} layers")
    for i, (a, b, c) in enumerate(zip(fwd, again, runs[False][2])):
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2]
                and torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])):
            raise AssertionError(f"moe-train remat check: layer {i}'s routing in the backward "
                                 f"pass differs from its forward's (dropped {a[2]} vs {b[2]})")
    worst, equal = 0.0, 0
    for (path, _), g, h in zip(leaves, runs[True][1], runs[False][1]):
        diff = (g.float() - h.float()).abs().max().item()
        scale = h.float().abs().max().item()
        equal += diff == 0.0
        ratio = diff / scale if scale > 0 else diff
        worst = max(worst, ratio)
        if diff > BF16_ULP * scale:
            raise AssertionError(f"moe-train remat check: {path} gradient with remat differs by "
                                 f"{diff:.3e} from the one without (its max |g| {scale:.3e})")
    dropped = [t[2] for t in fwd]
    log(f"moe-train: remat check at {n} of the model's layers (depth cut only): loss "
        f"{runs[True][0]:.6f} with remat, {runs[False][0]:.6f} without; the routing recomputed "
        f"in the backward pass equals the forward's in every layer (pairs dropped {dropped}); "
        f"{equal} of {len(leaves)} gradient leaves equal bit for bit, the largest difference "
        f"{worst:.3e} of a leaf's max |g| (gate: 2^-7)")
    return dict(layers=n, loss=[runs[True][0], runs[False][0]], dropped=dropped,
                equal_leaves=equal, leaves=len(leaves), max_rel_diff=worst)


def phase_moe_train(torch, seed, smi, profile: bool = False):
    """MOE_MODEL at every published width and depth, restored from checkpoint
    files and trained on phase 5's batch and schedule with AdamW state on
    the device, every plain version refused; then the remat check."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(MOE_MODEL)
    m = cfg.moe
    api = build_model(cfg, device=DEVICE)
    t0 = time.perf_counter()
    params, gib, n_params = restore_params(api, seed, "train-chip-smoke")
    sync(torch)
    log(f"moe-train: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.head_dim_}, {m.n_experts} experts top-{m.top_k} of d_ff "
        f"{m.d_ff_expert}, capacity factor {m.capacity_factor}, {n_params / 1e9:.3f} B params) "
        f"restored from {gib:.2f} GiB of checkpoint files in {time.perf_counter() - t0:.1f} s")
    batch = token_batch(torch, cfg, seed, TRAIN_BATCH, TRAIN_SEQ)
    with plain_versions_forbidden():
        params, opt, train_step, launches, out = run_train(
            torch, smi, "moe-train", api, params, batch, TRAIN_BATCH * TRAIN_SEQ)
    if profile:
        step_s = phase_profile_train(torch, params, opt, batch, train_step, "moe-train")
        fwd, bwd = moe_layer_times(torch, api, params, TRAIN_BATCH * TRAIN_SEQ)
        per_step = cfg.n_layers * (2 * fwd + bwd) / 1e3
        share = 100 * per_step / step_s if step_s else float("nan")  # no device trace: nan
        log(f"profile moe-train: one MoE layer alone at {TRAIN_BATCH * TRAIN_SEQ} tokens: forward "
            f"{fwd:.4f} ms, backward {bwd:.4f} ms; {cfg.n_layers} x (2 forwards (remat) + 1 "
            f"backward) = {per_step:.4f} s of the step's {step_s:.4f} s of device time "
            f"({share:.1f} %)")
        out.update(moe_layer_fwd_ms=fwd, moe_layer_bwd_ms=bwd)
    del params, opt, train_step
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    with plain_versions_forbidden():
        out["remat_check"] = moe_remat_check(torch, seed, cfg, batch)
    return launches, out


# ------------------------------------------------------------ phase 11
def loss_grads(torch, api, params, batch, remat: bool):
    """(loss, the gradient of every param leaf) of ``loss_fn``."""
    from repro_torch.checkpoint import flatten_tree

    tensors = [t.requires_grad_(True) for _, t in flatten_tree(params)]
    loss, _ = api.loss_fn(params, batch, remat=remat)
    grads = torch.autograd.grad(loss, tensors)
    return float(loss.detach()), grads


def plain_grad_check(torch, api, params, batch, what: str):
    """Every gradient leaf of ``loss_fn`` (remat) through the kernels, every
    plain version refused, within SSM_PLAIN_GRAD_TOL of its max |g| of the
    same loss through the plain versions on the card
    (``plain_versions_on_card``); ``api`` is an fp32 config.  Returns (the
    worst ratio, its leaf, the loss through the kernels, through the plain
    versions)."""
    from repro_torch.checkpoint import flatten_tree

    paths = [path for path, _ in flatten_tree(params)]
    with plain_versions_forbidden():
        loss_k, grads_k = loss_grads(torch, api, params, batch, remat=True)
    with plain_versions_on_card():
        loss_p, grads_p = loss_grads(torch, api, params, batch, remat=True)
    worst, worst_path = 0.0, None
    for path, g, h in zip(paths, grads_k, grads_p):
        diff = (g - h).abs().max().item()
        scale = h.abs().max().item()
        ratio = diff / scale if scale > 0 else diff
        if ratio >= worst:
            worst, worst_path = ratio, path
        if not math.isfinite(diff) or diff > SSM_PLAIN_GRAD_TOL * scale:
            raise AssertionError(f"{what}: {path} gradient through the kernels differs by "
                                 f"{diff:.3e} from the plain versions' (its max |g| {scale:.3e})")
    return worst, worst_path, loss_k, loss_p


def ssm_train_checks(torch, seed, cfg, batch) -> dict:
    """At the smallest depth that holds SSM_REMAT_LAYERS layers, a whole
    stacked group and a tail (the cut is of depth only; zamba2's group holds
    the shared attention block): the gradients of ``loss_fn`` with remat
    must equal those without bit for bit, every plain version refused; and
    in fp32, on the batch's first row, ``plain_grad_check`` -- dB and dC
    reach the conv output ``bcc`` as slices of its gradient, so a fault
    there shows in ``conv_bc_w``, ``conv_bc_b`` and ``bc_proj``."""
    import dataclasses

    from repro_torch.checkpoint import flatten_tree
    from repro_torch.models import build_model

    n = max(SSM_REMAT_LAYERS, len(cfg.pattern) + 2)
    cfg = dataclasses.replace(cfg, n_layers=n)
    api = build_model(cfg, device=DEVICE)
    params = api.init(seed=seed)
    paths = [path for path, _ in flatten_tree(params)]
    with plain_versions_forbidden():
        runs = {remat: loss_grads(torch, api, params, batch, remat) for remat in (True, False)}
    differ = [path for path, g, h in zip(paths, runs[True][1], runs[False][1])
              if not torch.equal(g, h)]
    loss_remat = runs[True][0]
    if differ or loss_remat != runs[False][0]:
        raise AssertionError(f"ssm-train: with remat, loss {loss_remat} and the gradients of "
                             f"{differ} differ from those without ({runs[False][0]})")
    del runs, params, api
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    api = build_model(cfg32, device=DEVICE)
    params = api.init(seed=seed)
    row = {k: v[:1] for k, v in batch.items()}
    worst, worst_path, loss_k, loss_p = plain_grad_check(torch, api, params, row, "ssm-train")
    log(f"ssm-train: {cfg.name} cut to {n} layers: loss {loss_remat:.6f} and all {len(paths)} "
        f"gradient leaves with remat equal those without bit for bit; in fp32 on "
        f"{tuple(row['tokens'].shape)} tokens every leaf through the kernels within {worst:.3e} "
        f"of its max |g| of the plain versions' on the card (worst {worst_path}; gate "
        f"{SSM_PLAIN_GRAD_TOL}), loss {loss_k:.6f} vs {loss_p:.6f}")
    del params, api
    return dict(layers=n, leaves=len(paths), remat_loss=loss_remat, plain_loss=[loss_k, loss_p],
                plain_max_rel_diff=worst, plain_worst_leaf=worst_path)


def phase_ssm_train(torch, seed, smi, profile: bool = False):
    """SSM_MODELS at every published width and depth, restored from
    checkpoint files and trained on SSM_TRAIN_BATCH x SSM_TRAIN_SEQ tokens
    on phase 5's schedule with AdamW state on the device, every plain version
    refused and the launches exact (B4 forward, again for the mamba layers
    of the stacked groups, and its backward once per mamba layer); then the
    remat and plain-version checks.  Returns (launches, results)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    launches, results = {name: 0 for name, _, _ in counters()}, {}
    for model in SSM_MODELS:
        t0 = time.perf_counter()
        cfg = get_config(model)
        tag = f"ssm-train {model}"
        api = build_model(cfg, device=DEVICE)
        params, gib, n_params = restore_params(api, seed, "train-chip-smoke")
        sync(torch)
        kinds = cfg.layer_kinds()
        log(f"{tag}: {cfg.name} ({cfg.n_layers} layers: {kinds.count('mamba')} mamba of "
            f"{cfg.ssm.n_heads(cfg.d_model)} heads of {cfg.ssm.head_dim}, d_state "
            f"{cfg.ssm.d_state}, chunk {cfg.ssm.chunk}, {len(kinds) - kinds.count('mamba')} "
            f"attention; d_model {cfg.d_model}, vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B "
            f"params) restored from {gib:.2f} GiB of checkpoint files in "
            f"{time.perf_counter() - t0:.1f} s")
        batch = token_batch(torch, cfg, seed, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ)
        with plain_versions_forbidden():
            params, opt, train_step, model_launches, out = run_train(
                torch, smi, tag, api, params, batch, SSM_TRAIN_BATCH * SSM_TRAIN_SEQ)
        launches = {k: v + model_launches[k] for k, v in launches.items()}
        if profile:
            out["profile_step_s"] = phase_profile_train(torch, params, opt, batch, train_step, tag)
        del params, opt, train_step
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        out["checks"] = ssm_train_checks(torch, seed, cfg, batch)
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        log(f"{tag}: {time.perf_counter() - t0:.1f} s")
        results[model] = out
    return launches, results


# ------------------------------------------------------------ phase 10
def phase_whisper(torch, seed, smi, profile: bool = False):
    """WHISPER_MODEL at every width and depth from checkpoint files, every
    plain version refused: served by DecodeEngine after its cross cache is
    filled from frames as a caller fills it, decode logits held against the
    teacher-forced forward; then trained on phase 5's schedule."""
    import dataclasses

    import numpy as np

    from repro_torch.checkpoint import checkpoint_files, flatten_tree
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, whisper
    from repro_torch.models.layers import unembed
    from repro_torch.serving import DecodeEngine

    cfg = get_config(WHISPER_MODEL)
    e = cfg.encdec
    api = build_model(cfg, device=DEVICE)
    cdt = getattr(torch, cfg.compute_dtype)
    recorded = {}

    def recording_step(params, cache, tokens, pos_index):
        """The model's decode step, keeping the logits at the check positions."""
        logits, cache = api.decode_step(params, cache, tokens, pos_index)
        if pos_index in WHISPER_CHECK_POSITIONS:
            recorded[pos_index] = logits[:, 0].float()
        return logits, cache

    t0 = time.perf_counter()
    files = checkpoint_files(0, f"{WHISPER_MODEL}-chip-smoke", api.init(seed=seed))
    engine = DecodeEngine.from_files(dataclasses.replace(api, decode_step=recording_step), files,
                                     batch=WHISPER_BATCH, max_len=WHISPER_MAX_LEN)
    n_bytes = sum(len(b) for b in files.values())
    del files
    params = engine.params
    n_params = sum(t.numel() for _, t in flatten_tree(params))
    sync(torch)
    log(f"whisper: {cfg.name} ({e.n_enc_layers} encoder + {cfg.n_layers} decoder layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim_}, d_ff {cfg.d_ff}, "
        f"{e.n_frames} frames, vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B params) through "
        f"{n_bytes / 2**30:.2f} GiB of checkpoint files in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(seed)

    def frames_of(batch):
        x = rng.standard_normal((batch, e.n_frames, cfg.d_model), dtype=np.float32)
        return torch.from_numpy(x).to(DEVICE).to(cdt)

    frames = frames_of(WHISPER_BATCH)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (WHISPER_BATCH, WHISPER_PROMPT_LEN)))
    steps = WHISPER_PROMPT_LEN + WHISPER_NEW_TOKENS - 1
    per_step = path_launches(cfg, "step")
    before_phase = read_counts()
    with plain_versions_forbidden(), torch.no_grad():
        before = read_counts()
        sync(torch)
        t0 = time.perf_counter()
        engine.cache = whisper.prefill_cross_cache(params, frames, engine.cache, cfg)
        sync(torch)
        prefill_s = time.perf_counter() - t0
        check_launches(before, path_launches(cfg, "encode"), "whisper cross-cache prefill")
        before = read_counts()
        sync(torch)
        t0 = time.perf_counter()
        new = engine.generate(prompts, WHISPER_NEW_TOKENS)
        sync(torch)
        elapsed = time.perf_counter() - t0
        check_launches(before, {k: v * steps for k, v in per_step.items()}, "whisper decode")
        if new.shape != (WHISPER_BATCH, WHISPER_NEW_TOKENS) or not bool(
                ((new >= 0) & (new < cfg.vocab_size)).all()):
            raise AssertionError(f"whisper: bad generated tokens {tuple(new.shape)}")
        # the engine's next step, at the position after the last one it fed
        recording_step(params, engine.cache, new[:, -1:], steps)
        seq = torch.cat([prompts.to(new.device), new], dim=1)  # [B, steps + 1]
        before = read_counts()
        hidden = api.forward(params, frames, seq, return_hidden=True)
        check_launches(before, path_launches(cfg, "forward"), "whisper forward")
        ref = unembed(hidden[:, list(WHISPER_CHECK_POSITIONS)], params["embed"], cfg).float()
        del hidden
    serve_launches = {k: v - before_phase[k] for k, v in read_counts().items()}
    encode, forward = path_launches(cfg, "encode"), path_launches(cfg, "forward")
    expected = {k: encode[k] + (steps + 1) * per_step[k] + forward[k] for k in per_step}
    if serve_launches != expected:
        raise AssertionError(f"whisper: serve launches {serve_launches} != {expected}")
    dec = torch.stack([recorded[p] for p in WHISPER_CHECK_POSITIONS], dim=1)
    if dec.shape != ref.shape or not bool(dec.isfinite().all()):
        raise AssertionError(f"whisper: decode logits {tuple(dec.shape)} not finite")
    scale = max(1.0, ref.abs().max().item())
    err = (dec - ref).abs()
    per_pos = {p: err[:, j].max().item() / scale for j, p in enumerate(WHISPER_CHECK_POSITIONS)}
    mean = err.mean().item() / scale
    out = dict(params=n_params, checkpoint_bytes=n_bytes, prefill_s=prefill_s,
               ms_per_step=elapsed / steps * 1e3, tokens_per_s=WHISPER_BATCH * steps / elapsed,
               logit_err=per_pos, logit_mean_err=mean, serve_launches=serve_launches)
    log(f"whisper: cross-cache prefill (encoder over {WHISPER_BATCH} x {e.n_frames} frames) "
        f"{prefill_s:.3f} s; {steps} decode steps at batch {WHISPER_BATCH}: {elapsed:.3f} s, "
        f"{out['ms_per_step']:.3f} ms/step, {out['tokens_per_s']:.1f} tokens/s on {smi}; "
        f"launches per step {per_step}")
    log(f"whisper: decode vs forward logits at positions {WHISPER_CHECK_POSITIONS}: max |err| / "
        f"{scale:.3f} = {per_pos} (tol {LOGIT_TOL}), mean {mean:.2e} (tol {LOGIT_MEAN_TOL})")
    if max(per_pos.values()) > LOGIT_TOL or mean > LOGIT_MEAN_TOL:
        raise AssertionError("whisper: decode logits disagree with the teacher-forced forward")
    if profile:  # decodes on past the checked position
        phase_profile(torch, engine, engine.cache, seq)
    del engine, dec, ref, frames
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    batch = token_batch(torch, cfg, seed, WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ)
    batch["frames"] = frames_of(WHISPER_TRAIN_BATCH)
    with plain_versions_forbidden():
        params, opt, train_step, train_launches, out["train"] = run_train(
            torch, smi, "whisper-train", api, params, batch,
            WHISPER_TRAIN_BATCH * WHISPER_TRAIN_SEQ)
    del params, opt, train_step, batch
    launches = {k: serve_launches[k] + train_launches[k] for k in serve_launches}
    return launches, out


# ------------------------------------------------------------ phase 12
def serve_dense(torch, seed, smi, model, layers, from_files, prompt_len, new_tokens, check,
                profile):
    """One dense model served by DecodeEngine at every width, every plain
    version refused: the engine's decode launches exact, its logits
    (recorded as it runs, then at its next step) held against the
    teacher-forced forward.  Returns (launches, summary)."""
    import dataclasses

    import numpy as np

    from repro_torch.checkpoint import checkpoint_files, flatten_tree
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.models import build_model
    from repro_torch.models.layers import unembed
    from repro_torch.models.transformer import SWA_KINDS
    from repro_torch.serving import DecodeEngine

    cfg = get_config(model)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    api = build_model(cfg, device=DEVICE)
    recorded = {}

    def recording_step(params, cache, tokens, pos_index):
        """The model's decode step, keeping the logits at the check positions."""
        logits, cache = api.decode_step(params, cache, tokens, pos_index)
        if pos_index in check:
            recorded[pos_index] = logits[:, 0].float()
        return logits, cache

    rec_api = dataclasses.replace(api, decode_step=recording_step)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if from_files:
        files = checkpoint_files(0, f"{model}-chip-smoke", api.init(seed=seed))
        n_bytes = sum(len(b) for b in files.values())
        engine = DecodeEngine.from_files(rec_api, files, batch=DENSE_BATCH, max_len=DENSE_MAX_LEN)
        del files
        source = f"through {n_bytes / 2**30:.2f} GiB of checkpoint files"
    else:
        n_bytes = None
        engine = DecodeEngine(rec_api, api.init(seed=seed), batch=DENSE_BATCH,
                              max_len=DENSE_MAX_LEN)
        source = "drawn on the card (api.init)"
    params = engine.params
    leaves = [t for _, t in flatten_tree(params)]
    n_params = sum(t.numel() for t in leaves)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    sync(torch)
    load_s = time.perf_counter() - t0
    g = cfg.n_heads // cfg.n_kv_heads
    slots = engine.cache["groups"]["pos0"]["k"].shape[-3]
    wraps = "wrap" if prompt_len + new_tokens > slots else "do not wrap"
    ring = (f"window {cfg.sliding_window}, max_len {DENSE_MAX_LEN}: {slots}-slot rings that {wraps}"
            if any(k in SWA_KINDS for k in cfg.layer_kinds()) else f"{slots}-slot caches")
    log(f"dense-serve: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.head_dim_} (GQA group {g}), d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {n_params / 1e9:.3f} B params (param_count {cfg.param_count() / 1e9:.3f}"
        f" B), {weight_bytes / 1e9:.2f} GB) {source} in {load_s:.1f} s; {ring}")
    plan = decode_plan(torch, dec_ops, DENSE_BATCH, cfg.n_kv_heads, slots, cfg.head_dim_, g)
    log(f"dense-serve: B2's split plan for the {slots}-slot cache at batch {DENSE_BATCH}: {plan}")

    prompts = torch.from_numpy(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, (DENSE_BATCH, prompt_len)))
    steps = prompt_len + new_tokens - 1
    per_step, per_forward = path_launches(cfg, "step"), path_launches(cfg, "forward")
    before_phase = read_counts()
    with plain_versions_forbidden(), torch.no_grad():
        before = read_counts()
        sync(torch)
        t0 = time.perf_counter()
        new = engine.generate(prompts, new_tokens)
        sync(torch)
        elapsed = time.perf_counter() - t0
        check_launches(before, {k: v * steps for k, v in per_step.items()},
                       f"dense-serve {model} decode")
        if new.shape != (DENSE_BATCH, new_tokens) or not bool(
                ((new >= 0) & (new < cfg.vocab_size)).all()):
            raise AssertionError(f"dense-serve {model}: bad generated tokens {tuple(new.shape)}")
        # the engine's next step, at the position after the last one it fed
        recording_step(params, engine.cache, new[:, -1:], steps)
        seq = torch.cat([prompts.to(new.device), new], dim=1)  # [B, steps + 1]
        before = read_counts()
        hidden = api.forward(params, seq, return_hidden=True)
        check_launches(before, per_forward, f"dense-serve {model} forward")
        ref = unembed(hidden[:, list(check)], params["embed"], cfg).float()
        del hidden
    sync(torch)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: v - before_phase[k] for k, v in read_counts().items()}
    expected = {k: (steps + 1) * per_step[k] + per_forward[k] for k in per_step}
    if launches != expected:
        raise AssertionError(f"dense-serve {model}: launches {launches} != {expected}")
    dec = torch.stack([recorded[p] for p in check], dim=1)
    if dec.shape != ref.shape or not bool(dec.isfinite().all()):
        raise AssertionError(f"dense-serve {model}: decode logits {tuple(dec.shape)} not finite")
    scale = max(1.0, ref.abs().max().item())
    err = (dec - ref).abs()
    per_pos = {p: err[:, j].max().item() / scale for j, p in enumerate(check)}
    mean = err.mean().item() / scale
    bound = weight_bytes / HBM_BYTES_PER_S * 1e3
    out = dict(layers=cfg.n_layers, params=n_params, weight_bytes=weight_bytes,
               checkpoint_bytes=n_bytes, load_s=load_s, b2_plan=plan, steps=steps,
               ms_per_step=elapsed / steps * 1e3, tokens_per_s=DENSE_BATCH * steps / elapsed,
               weights_bound_ms=bound, peak_gib=peak, logit_err=per_pos, logit_mean_err=mean)
    log(f"dense-serve: {model}: {steps} decode steps (prompt token by token, then greedy) at "
        f"batch {DENSE_BATCH}: {elapsed:.3f} s, {out['ms_per_step']:.3f} ms/step (all weights "
        f"once: {bound:.3f} ms), {out['tokens_per_s']:.1f} tokens/s, peak device memory "
        f"{peak:.2f} GiB on {smi}")
    log(f"dense-serve: {model}: launches {launches} = {steps + 1} decode steps x {per_step} + "
        f"the forward's {per_forward}")
    log(f"dense-serve: {model}: decode vs forward logits at positions {check}: max |err| / "
        f"{scale:.3f} = {per_pos} (tol {LOGIT_TOL}), mean {mean:.2e} (tol {LOGIT_MEAN_TOL})")
    if max(per_pos.values()) > LOGIT_TOL or mean > LOGIT_MEAN_TOL:
        raise AssertionError(f"dense-serve {model}: decode logits disagree with the forward")
    if profile:  # decodes on past the checked position
        phase_profile(torch, engine, engine.cache, seq)
    return launches, out


def phase_dense_serve(torch, seed, smi, profile: bool = False):
    """Each of DENSE_MODELS served (``serve_dense``); returns (launches in
    all, summary by model)."""
    launches, out = {}, {}
    for model, layers, from_files, prompt_len, new_tokens, check in DENSE_MODELS:
        got, out[model] = serve_dense(torch, seed, smi, model, layers, from_files, prompt_len,
                                      new_tokens, check, profile)
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return launches, out


# ------------------------------------------------------------ phase 13
def dense_train_checks(torch, seed, cfg, batch) -> dict:
    """At DENSE_REMAT_LAYERS layers (the cut is of depth only), the gradients
    of ``loss_fn`` with remat against those without, every plain version
    refused: every leaf within one bf16 ulp of its largest value, as phase 9
    holds them; then at 1 layer in fp32 on DENSE_PLAIN_SEQ tokens of the
    batch's first row, ``plain_grad_check``."""
    import dataclasses

    from repro_torch.checkpoint import flatten_tree
    from repro_torch.models import build_model

    api = build_model(dataclasses.replace(cfg, n_layers=DENSE_REMAT_LAYERS), device=DEVICE)
    params = api.init(seed=seed)
    paths = [path for path, _ in flatten_tree(params)]
    with plain_versions_forbidden():
        runs = {remat: loss_grads(torch, api, params, batch, remat) for remat in (True, False)}
    worst, equal = 0.0, 0
    for path, g, h in zip(paths, runs[True][1], runs[False][1]):
        diff = (g.float() - h.float()).abs().max().item()
        scale = h.float().abs().max().item()
        equal += diff == 0.0
        worst = max(worst, diff / scale if scale > 0 else diff)
        if not math.isfinite(diff) or diff > BF16_ULP * scale:
            raise AssertionError(f"dense-train remat check: {path} gradient with remat differs by "
                                 f"{diff:.3e} from the one without (its max |g| {scale:.3e})")
    losses = [runs[True][0], runs[False][0]]
    del runs, params, api
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, n_layers=1, param_dtype="float32", compute_dtype="float32")
    api = build_model(cfg32, device=DEVICE)
    params = api.init(seed=seed)
    row = {k: v[:1, :DENSE_PLAIN_SEQ] for k, v in batch.items()}
    pworst, pworst_path, loss_k, loss_p = plain_grad_check(torch, api, params, row, "dense-train")
    log(f"dense-train: remat check at {DENSE_REMAT_LAYERS} layers (depth cut only): loss "
        f"{losses[0]:.6f} with remat, {losses[1]:.6f} without; {equal} of {len(paths)} gradient "
        f"leaves equal bit for bit, the largest difference {worst:.3e} of a leaf's max |g| (gate: "
        f"2^-7); in fp32 at 1 layer on {tuple(row['tokens'].shape)} tokens every leaf through the "
        f"kernels within {pworst:.3e} of its max |g| of the plain versions' on the card (worst "
        f"{pworst_path}; gate {SSM_PLAIN_GRAD_TOL}), loss {loss_k:.6f} vs {loss_p:.6f}")
    del params, api
    return dict(remat_layers=DENSE_REMAT_LAYERS, remat_loss=losses, equal_leaves=equal,
                leaves=len(paths), remat_max_rel_diff=worst, plain_loss=[loss_k, loss_p],
                plain_max_rel_diff=pworst, plain_worst_leaf=pworst_path)


def rank_local_attention(torch, seed, cfg, attn) -> dict:
    """One layer's attention at phase 5's batch, its q, k and v layer 0's
    projections (``attn``: its q, k, v weights) of a random input, roped:
    B1 forward and backward over all the heads (G 48), then over heads 0..g-1
    alone for each g of RANK_LOCAL_GROUPS (the q heads one rank holds at
    model 48 / g) against the same kv head.  A row's work over the key tiles
    does not depend on how the rows are packed into query tiles, so out, lse
    and dQ must equal the G 48 run's heads bit for bit; dK and dV sum over
    other heads and are held to the fp32 plain version by B1's rounding gate
    (``check_rounded``)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref, kernel_key_tile
    from repro_torch.models.layers import apply_rope, dense, rope_frequencies

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 13)
    b, s, hd = TRAIN_BATCH, TRAIN_SEQ, cfg.head_dim_
    dtype = attn["q"]["w"].dtype  # the model's: bf16
    x = torch.randn(b, s, cfg.d_model, generator=gen, device=DEVICE).to(dtype)
    pos = torch.arange(s, device=DEVICE, dtype=torch.int32)[None].expand(b, s)
    rope = rope_frequencies(hd, pos, cfg.rope_theta)
    with torch.no_grad():
        q, k = (apply_rope(dense(x, attn[n]).reshape(b, s, -1, hd), *rope) for n in ("q", "k"))
        v = dense(x, attn["v"]).reshape(b, s, -1, hd)
    del x
    dout = torch.randn(q.shape, generator=gen, device=DEVICE).to(dtype)
    out, lse = ops.flash_attention_fwd(q, k, v)
    dq, _, _ = ops.flash_attention_bwd(q, k, v, out, lse, dout)
    sync(torch)
    res = {}
    for g in RANK_LOCAL_GROUPS:
        ql, dl = q[:, :, :g], dout[:, :, :g]  # a rank's heads: strided views
        o, l = ops.flash_attention_fwd(ql, k, v)
        gq, gk, gv = ops.flash_attention_bwd(ql, k, v, o, l, dl)
        sync(torch)
        same = {n: bool(torch.equal(a, ref)) for n, a, ref in (
            ("out", o, out[:, :, :g]), ("lse", l, lse[:, :g]), ("dq", gq, dq[:, :, :g]))}
        if DEVICE == "cuda" and not all(same.values()):
            diff = {n: (a.float() - ref.float()).abs().max().item() for n, a, ref in (
                ("out", o, out[:, :, :g]), ("lse", l, lse[:, :g]), ("dq", gq, dq[:, :, :g]))}
            raise AssertionError(f"rank-local G {g}: not the G 48 run's heads bit for bit: "
                                 f"{same}, max |diff| {diff}")
        f32 = [t.float() for t in (ql, k, v, o, dl)]
        refs = flash_attention_bwd_ref(*f32[:3], f32[3], l, f32[4])
        refs_p = flash_attention_bwd_ref(*f32[:3], f32[3], l, f32[4], p_dtype=torch.bfloat16,
                                         block_k=kernel_key_tile(hd))
        del f32
        gates = {}
        for n, got, ref, ref_p in (("dk", gk, refs[1], refs_p[1]), ("dv", gv, refs[2], refs_p[2])):
            err, row, mean = check_rounded(f"rank-local G {g} {n}", got, ref, ref_p)
            gates[n] = dict(max_abs_err=err, row_ratio=row, mean_ratio=mean)
        del refs, refs_p, o, l, gq, gk, gv
        res[f"G {g}"] = dict(bit_equal=same, **gates)
        log(f"dense-train: rank-local attention, heads 0-{g - 1} of 48 over the kv head (G {g}) "
            f"on {b} x {s} tokens: out, lse and dQ equal to the G 48 run's heads bit for bit: "
            f"{same}; dK / dV within the rounding gate, row/mean ratios "
            + ", ".join(f"{n} {v['row_ratio']:.3f}/{v['mean_ratio']:.3f}"
                        for n, v in gates.items()) + " (pass <= 1)")
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return res


def phase_dense_train(torch, seed, smi, profile: bool = False):
    """DENSE_TRAIN_MODEL at every published width, cut to DENSE_TRAIN_LAYERS
    layers, its weights drawn on the card from ``seed``, trained on phase 5's
    batch and schedule with AdamW state on the device, every plain version
    refused and the launches exact (B1 both ways at G 48, B3a both ways at
    d_model 6144); then the remat and plain-version checks.  Returns
    (launches, summary); then the rank-local attention check."""
    import dataclasses

    from repro_torch.checkpoint import flatten_tree
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    full = get_config(DENSE_TRAIN_MODEL)
    cfg = dataclasses.replace(full, n_layers=DENSE_TRAIN_LAYERS)
    api = build_model(cfg, device=DEVICE)
    t0 = time.perf_counter()
    params = api.init(seed=seed)
    n_params = sum(t.numel() for _, t in flatten_tree(params))
    sync(torch)
    log(f"dense-train: {cfg.name} ({cfg.n_layers} of its {full.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim_} (GQA group "
        f"{cfg.n_heads // cfg.n_kv_heads}), d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{n_params / 1e9:.3f} B params; {full.param_count() / 1e9:.3f} B at full depth) drawn on "
        f"the card (api.init) in {time.perf_counter() - t0:.1f} s")
    batch = token_batch(torch, cfg, seed, TRAIN_BATCH, TRAIN_SEQ)
    with plain_versions_forbidden():
        params, opt, train_step, launches, out = run_train(
            torch, smi, "dense-train", api, params, batch, TRAIN_BATCH * TRAIN_SEQ)
    if profile:
        out["profile_step_s"] = phase_profile_train(torch, params, opt, batch, train_step,
                                                    "dense-train")
    attn = {n: {"w": w["w"][0].clone()} for n, w in params["groups"]["pos0"]["attn"].items()}
    del params, opt, train_step
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    out.update(layers=cfg.n_layers, params=n_params,
               checks=dense_train_checks(torch, seed, full, batch),
               rank_local=rank_local_attention(torch, seed, cfg, attn))
    return launches, out


# ------------------------------------------------------------ phase 14
def dist_group(torch) -> None:
    """A one-rank default process group (NCCL on the card, gloo on the CPU)
    that meets on a free localhost port."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.distributed.init_process_group(
        "nccl" if DEVICE == "cuda" else "gloo", init_method=f"tcp://127.0.0.1:{port}",
        rank=0, world_size=1)


def dist_steps(torch, step, params, opt, batch, tag: str, per_step: dict):
    """DIST_STEPS steps, every plain version refused, each step's launches
    exact; returns (params, opt, history, step_s, launches, EP exchanges,
    peak GiB), the counts set to 0 just before the steps and read just
    after.  The peak is that of these steps with this run's own params and
    AdamW state resident and nothing else: the peak above what was
    allocated when the steps began, plus the bytes of the two trees (the
    other run's state is resident too)."""
    from repro_torch.checkpoint import flatten_tree
    from repro_torch.models import moe

    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    state = sum(local(t).numel() * local(t).element_size()
                for tree in (params, opt) for _, t in flatten_tree(tree))
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    sync(torch)
    start = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
    torch.cuda.reset_peak_memory_stats()
    history, step_s = [], []
    reset_counts()
    moe.moe_mlp_ep.exchanges = 0
    with plain_versions_forbidden():
        for i in range(DIST_STEPS):
            before = read_counts()
            sync(torch)
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            sync(torch)
            step_s.append(time.perf_counter() - t0)
            check_launches(before, per_step, f"dist-train {tag}: step {i}")
            history.append({k: float(v) for k, v in metrics.items()})
    launches, exchanges = read_counts(), moe.moe_mlp_ep.exchanges
    peak = (torch.cuda.max_memory_allocated() - start + state) / 2**30
    return params, opt, history, step_s, launches, exchanges, peak


def compression_check(torch, grads: dict, group) -> dict:
    """``compress_tree_psum`` over ``group`` (one rank) on ``grads``, twice,
    the second with the first's residual; each output and residual held bit
    for bit to the plain version: quantise, dequantise, the residual."""
    from repro_torch.optim.compression import (compress_tree_psum, dequantize_int8,
                                               quantize_int8)
    from repro_torch.checkpoint import flatten_tree

    errors, times, numel = None, [], sum(g.numel() for g in grads.values())
    for rnd in range(2):
        sync(torch)
        t0 = time.perf_counter()
        out, new = compress_tree_psum(grads, group, errors)
        sync(torch)
        times.append(time.perf_counter() - t0)
        out, new = dict(flatten_tree(out)), dict(flatten_tree(new))
        for path, g in grads.items():
            x = g.float() + errors[path] if errors is not None else g.float()
            q, scale = quantize_int8(x)
            deq = dequantize_int8(q, scale)
            if not (torch.equal(out[path], deq) and torch.equal(new[path], x - deq)):
                raise AssertionError(f"dist-train: compress_tree_psum round {rnd} of {path} is "
                                     f"not its plain version's")
        errors = new
    log(f"dist-train: compress_tree_psum over NCCL (one rank) on the gradient tree ({len(grads)} "
        f"leaves, {numel / 1e9:.3f} B values): {times[0]:.3f} s, then {times[1]:.3f} s with the "
        f"residual; both rounds equal their plain versions (quantise, dequantise, residual) bit "
        f"for bit")
    return dict(leaves=len(grads), values=numel, s=times)


def sharded_ssm_schedule(cfg) -> dict:
    """Launches per train step of the sharded step of an SSM model: the
    unsharded schedule with every gate norm (one a mamba layer, run again
    in remat's recompute of the stacked groups) on B3a's external-statistic
    mode, each with one row statistic, forward and backward."""
    per = train_launch_schedule(cfg)
    kinds = cfg.layer_kinds()
    stacked = kinds[: (cfg.n_layers // len(cfg.pattern)) * len(cfg.pattern)]
    fwd = kinds.count("mamba") + stacked.count("mamba")
    bwd = kinds.count("mamba")
    return dict(per, rmsnorm=per["rmsnorm"] - fwd, rmsnorm_bwd=per["rmsnorm_bwd"] - bwd,
                rmsnorm_ext=fwd, rmsnorm_ext_bwd=bwd, rmsnorm_stat=fwd + bwd)


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def dist_ssm_train(torch, seed, smi, ctx):
    """DIST_SSM_MODEL cut to DIST_SSM_LAYERS through the sharded and the
    unsharded step on phase 11's batch, DIST_STEPS steps each, launches
    exact; the metrics within DIST_SSM_LOSS_TOL / DIST_SSM_GNORM_TOL; then
    in fp32 at DIST_SSM_GRAD_LAYERS layers every gradient leaf within
    DIST_SSM_GRAD_TOL of its max |g|.  Returns (the sharded steps'
    launches, summary)."""
    import dataclasses

    from repro_torch.checkpoint import flatten_tree, tree_map
    from repro_torch.configs import get_config
    from repro_torch.distributed import (batch_specs, distribute_tree, distribution, opt_specs,
                                         param_specs)
    from repro_torch.models import build_model
    from repro_torch.optim import init_adamw
    from repro_torch.training import make_train_step

    full = get_config(DIST_SSM_MODEL)
    cfg = dataclasses.replace(full, n_layers=DIST_SSM_LAYERS)
    api = build_model(cfg, device=DEVICE)
    params = api.init(seed=seed)
    n_params = sum(t.numel() for _, t in flatten_tree(params))
    batch = token_batch(torch, cfg, seed, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ)
    kw = dict(peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS,
              microbatches=1, remat=True)
    per_ref, per_sharded = train_launch_schedule(cfg), sharded_ssm_schedule(cfg)
    ref_p = tree_map(lambda t: t.detach().clone(), params)
    ref_step = make_train_step(api, **kw)
    ref_p, ref_o, ref_hist, ref_s, _, _, ref_peak = dist_steps(
        torch, ref_step, ref_p, init_adamw(ref_p), batch, "ssm unsharded", per_ref)
    del ref_p, ref_o
    opt = init_adamw(params)
    p_specs = param_specs(params, cfg, ctx)
    opt = distribute_tree(opt, opt_specs(opt, p_specs, cfg, ctx), ctx)
    params = distribute_tree(params, p_specs, ctx)
    step = make_train_step(api, ctx=ctx, **kw)
    params, opt, hist, step_s, launches, _, peak = dist_steps(
        torch, step, params, opt, batch, "ssm sharded", per_sharded)
    del params, opt
    expected = {k: DIST_STEPS * v for k, v in per_sharded.items()}
    if launches != expected:
        raise AssertionError(f"dist-train ssm: launches {launches} != {expected}")
    worst = {"loss": 0.0, "ce": 0.0, "grad_norm": 0.0}
    for i, (h, r) in enumerate(zip(hist, ref_hist)):
        if h["lr"] != r["lr"] or not all(math.isfinite(v) for v in h.values()):
            raise AssertionError(f"dist-train ssm: step {i} metrics {h} vs unsharded {r}")
        for key in worst:
            worst[key] = max(worst[key], rel(h[key], r[key]))
    if max(worst["loss"], worst["ce"]) > DIST_SSM_LOSS_TOL or \
            worst["grad_norm"] > DIST_SSM_GNORM_TOL:
        raise AssertionError(f"dist-train ssm: sharded metrics {hist} vs unsharded {ref_hist}: "
                             f"relative differences {worst}")
    bitwise = all(h == r for h, r in zip(hist, ref_hist))

    # fp32 gradients of one loss at the same weights, sharded and unsharded
    small = dataclasses.replace(full, n_layers=DIST_SSM_GRAD_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    sapi = build_model(small, device=DEVICE)
    gp = sapi.init(seed=seed)
    gbatch = {k: v[:1, :DIST_SSM_GRAD_SEQ].contiguous() for k, v in batch.items()}
    _, ref_g = loss_grads(torch, sapi, gp, gbatch, True)
    ref_g = dict(zip([p for p, _ in flatten_tree(gp)], ref_g))
    sp = distribute_tree(gp, param_specs(gp, small, ctx), ctx)
    spec = batch_specs({k: (tuple(x.shape), x.dtype) for k, x in gbatch.items()}, ctx)
    leaves = flatten_tree(sp)
    tensors = [t.requires_grad_(True) for _, t in leaves]
    with distribution(ctx):
        loss, _ = sapi.loss_fn(sp, distribute_tree(gbatch, spec, ctx), remat=True)
        grads = torch.autograd.grad(loss, tensors)
    grad_err = 0.0
    for (path, _), g in zip(leaves, grads):
        r = ref_g[path].float()
        e = (g.full_tensor().float() - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
        if e > DIST_SSM_GRAD_TOL:
            raise AssertionError(f"dist-train ssm: fp32 gradient {path} differs from the "
                                 f"unsharded one by {e:.3e} of its max")
        grad_err = max(grad_err, e)
    del sp, gp, grads, ref_g
    s_sh = statistics.median(step_s[1:]) if len(step_s) > 1 else step_s[0]
    s_un = statistics.median(ref_s[1:]) if len(ref_s) > 1 else ref_s[0]
    log(f"dist-train ssm: {cfg.name} ({cfg.n_layers} of its {full.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.3f} B params), {DIST_STEPS} steps of "
        f"{SSM_TRAIN_BATCH} x {SSM_TRAIN_SEQ} tokens: sharded launches {launches} ("
        f"{per_sharded} a step: every gate norm on the external-statistic mode); loss "
        f"{[h['loss'] for h in hist]} vs unsharded {[h['loss'] for h in ref_hist]}, largest "
        f"relative differences {worst} (tol {DIST_SSM_LOSS_TOL} / {DIST_SSM_GNORM_TOL}; bit "
        f"for bit: {bitwise}); fp32 gradients at {DIST_SSM_GRAD_LAYERS} layers within "
        f"{grad_err:.2e} of each leaf's max (tol {DIST_SSM_GRAD_TOL}); sharded {s_sh:.3f} s/step, "
        f"{peak:.2f} GiB, unsharded {s_un:.3f} s/step, {ref_peak:.2f} GiB on {smi}")
    return launches, dict(layers=cfg.n_layers, params=n_params, history=hist,
                          unsharded_history=ref_hist, metric_rel_diff=worst, bitwise=bitwise,
                          fp32_grad_rel_err=grad_err, s_per_step=s_sh, unsharded_s_per_step=s_un,
                          peak_gib=peak, unsharded_peak_gib=ref_peak)


def dist_decode(torch, seed, smi, ctx):
    """DIST_DECODE_MODEL cut to DIST_DECODE_LAYERS decodes phase 4's prompts
    and new tokens (past the ring's wrap) unsharded, then sharded on the
    mesh (params and caches as DTensors), every plain version refused and
    the launches exact; the generated tokens must be equal and the logits
    at CHECK_POSITIONS within phase 4's gates.  Returns (the sharded run's
    launches, summary)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.distributed import (batch_specs, cache_specs, distribute_tree, distribution,
                                         param_specs)
    from repro_torch.models import build_model

    full = get_config(DIST_DECODE_MODEL)
    cfg = dataclasses.replace(full, n_layers=DIST_DECODE_LAYERS)
    api = build_model(cfg, device=DEVICE)
    params = api.init(seed=seed)
    prompts = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, PROMPT_LEN))).to(DEVICE)
    steps = PROMPT_LEN + NEW_TOKENS  # the last generated token is decoded too (CHECK_POSITIONS)
    per_step = path_launches(cfg, "step")
    sharded_step = dict(per_step, decode_attention=0,
                        decode_attention_partial=per_step["decode_attention"])
    t_spec = batch_specs({"tokens": ((BATCH, 1), torch.int64)}, ctx)

    def run(p, cache, sharded: bool):
        tokens, logits, times = [], {}, []
        cur = None
        reset_counts()
        with torch.no_grad(), plain_versions_forbidden(), distribution(ctx if sharded else None):
            for i in range(steps):
                tok = prompts[:, i:i + 1] if i < PROMPT_LEN else cur
                if sharded:
                    tok = distribute_tree({"tokens": tok}, t_spec, ctx)["tokens"]
                before = read_counts()
                sync(torch)
                t0 = time.perf_counter()
                lg, cache = api.decode_step(p, cache, tok, i)
                lg = (lg.full_tensor() if sharded else lg)[:, 0]
                cur = lg.argmax(-1)[:, None]
                sync(torch)
                times.append(time.perf_counter() - t0)
                check_launches(before, sharded_step if sharded else per_step,
                               f"dist-decode {'sharded' if sharded else 'unsharded'} step {i}")
                if i in CHECK_POSITIONS:
                    logits[i] = lg.float()
                if i >= PROMPT_LEN - 1:
                    tokens.append(cur)
        return torch.cat(tokens, 1), logits, times, read_counts()

    ref_tok, ref_lg, ref_t, _ = run(params, api.init_cache(BATCH, MAX_LEN), False)
    cache = api.init_cache(BATCH, MAX_LEN)
    cache = distribute_tree(cache, cache_specs(cache, cfg, ctx), ctx)
    sp = distribute_tree(params, param_specs(params, cfg, ctx), ctx)
    tok, lg, t_sh, launches = run(sp, cache, True)
    del sp, cache, params
    if not torch.equal(tok, ref_tok):
        raise AssertionError(f"dist-decode: sharded tokens {tok.tolist()} != unsharded "
                             f"{ref_tok.tolist()}")
    dec = torch.stack([lg[p] for p in CHECK_POSITIONS], 1)
    ref = torch.stack([ref_lg[p] for p in CHECK_POSITIONS], 1)
    scale = max(1.0, ref.abs().max().item())
    err = (dec - ref).abs()
    worst, mean = err.max().item() / scale, err.mean().item() / scale
    if not bool(dec.isfinite().all()) or worst > LOGIT_TOL or mean > LOGIT_MEAN_TOL:
        raise AssertionError(f"dist-decode: sharded logits {worst:.3e} (mean {mean:.3e}) from "
                             f"the unsharded ones")
    ms_sh, ms_un = (statistics.median(t) * 1e3 for t in (t_sh, ref_t))
    log(f"dist-decode: {cfg.name} ({cfg.n_layers} of its {full.n_layers} layers, every width) "
        f"sharded on {dict(zip(ctx.mesh.mesh_dim_names, ctx.mesh.shape))}: {steps} steps at "
        f"batch {BATCH} past the {cfg.sliding_window}-slot ring's wrap, {NEW_TOKENS + 1} greedy "
        f"tokens equal to the unsharded decode's; logits at {CHECK_POSITIONS} within "
        f"{worst:.2e} (mean {mean:.2e}) of max(1, |ref|) (bit for bit: {worst == 0}); launches "
        f"{launches} ({sharded_step} a step: B2's partial mode and the fold on every attention "
        f"layer); {ms_sh:.3f} ms/step sharded, {ms_un:.3f} unsharded on {smi}")
    return launches, dict(layers=cfg.n_layers, steps=steps, logit_max_err=worst,
                          logit_mean_err=mean, ms_per_step=ms_sh, unsharded_ms_per_step=ms_un)


def phase_dist_train(torch, seed, smi, profile: bool = False):
    """DIST_MODEL at every published width cut to DIST_LAYERS layers, its
    weights drawn on the card, through the sharded train step on a (data 1,
    model 1) mesh over a one-rank NCCL group, held to the unsharded step on
    the same weights and batch; then the compressed all-reduce.  With
    ``profile``, one more step of each is broken down by kernel group.
    Returns (launches, summary)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.checkpoint import flatten_tree, tree_map
    from repro_torch.configs import get_config
    from repro_torch.distributed import (DistContext, batch_specs, distribute_tree, distribution,
                                         opt_specs, param_specs)
    from repro_torch.launch import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import init_adamw
    from repro_torch.optim.adamw import tree_get
    from repro_torch.training import make_train_step

    full = get_config(DIST_MODEL)
    cfg = dataclasses.replace(full, n_layers=DIST_LAYERS)
    m = cfg.moe
    api = build_model(cfg, device=DEVICE, ep=1)
    t0 = time.perf_counter()
    params = api.init(seed=seed)
    n_params = sum(t.numel() for _, t in flatten_tree(params))
    batch = token_batch(torch, cfg, seed, TRAIN_BATCH, TRAIN_SEQ)
    sync(torch)
    log(f"dist-train: {cfg.name} ({cfg.n_layers} of its {full.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim_}, {m.n_experts} "
        f"experts top-{m.top_k} of d_ff {m.d_ff_expert}, {n_params / 1e9:.3f} B params) drawn on "
        f"the card in {time.perf_counter() - t0:.1f} s; {DIST_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens")
    kw = dict(peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS,
              microbatches=1, remat=True)
    per_step = train_launch_schedule(cfg)
    n_moe = sum(kind in ("moe", "swa_moe") for kind in cfg.layer_kinds())
    t0 = time.perf_counter()
    dist_group(torch)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type=DEVICE)
        ctx = DistContext(mesh, ("data",))
        log(f"dist-train: process group {dist.get_backend()} of {dist.get_world_size()} rank, "
            f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} in "
            f"{time.perf_counter() - t0:.1f} s")

        # the unsharded step first, on a copy of the weights
        ref_p = tree_map(lambda t: t.detach().clone(), params)
        ref_step = make_train_step(api, **kw)
        ref_p, ref_o, ref_hist, ref_s, ref_launches, ref_ex, ref_peak = dist_steps(
            torch, ref_step, ref_p, init_adamw(ref_p), batch, "unsharded", per_step)

        opt = init_adamw(params)
        p_specs = param_specs(params, cfg, ctx)
        opt = distribute_tree(opt, opt_specs(opt, p_specs, cfg, ctx), ctx)
        params = distribute_tree(params, p_specs, ctx)
        step = make_train_step(api, ctx=ctx, **kw)
        params, opt, hist, step_s, launches, exchanges, peak = dist_steps(
            torch, step, params, opt, batch, "sharded", per_step)

        expected = {k: DIST_STEPS * v for k, v in per_step.items()}
        if launches != expected or ref_launches != expected:
            raise AssertionError(f"dist-train: launches {launches} (unsharded {ref_launches}) != "
                                 f"{expected}")
        # the EP path: an exchange out and one back a MoE layer, in the
        # forward, in remat's recompute and in the backward
        if exchanges != DIST_STEPS * 6 * n_moe or ref_ex != 0:
            raise AssertionError(f"dist-train: {exchanges} EP exchanges (unsharded {ref_ex}) != "
                                 f"{DIST_STEPS * 6 * n_moe}")
        for i, (h, r) in enumerate(zip(hist, ref_hist)):
            if h != r or not all(math.isfinite(v) for v in h.values()):
                raise AssertionError(f"dist-train: step {i} metrics {h} != unsharded {r}")
        equal = 0
        for tree, ref_tree, name in ((params, ref_p, "params"), (opt, ref_o, "opt")):
            for path, t in flatten_tree(tree):
                a, b = t.full_tensor(), tree_get(ref_tree, path)
                if not torch.equal(a, b):
                    diff = (a.float() - b.float()).abs().max().item()
                    raise AssertionError(f"dist-train: {name}/{path} differs from the unsharded "
                                         f"step's by {diff:.3e}")
                equal += 1
        del a, b
        s_sh = statistics.median(step_s[1:]) if len(step_s) > 1 else step_s[0]
        s_un = statistics.median(ref_s[1:]) if len(ref_s) > 1 else ref_s[0]
        log(f"dist-train: {DIST_STEPS} sharded steps equal the unsharded ones bit for bit: loss "
            f"{[h['loss'] for h in hist]}, grad norm {[h['grad_norm'] for h in hist]}, all "
            f"{equal} param and opt leaves; launches {launches} ({per_step} a step, as "
            f"unsharded); {exchanges} EP all_to_all_single exchanges")
        log(f"dist-train: {TRAIN_BATCH * TRAIN_SEQ} tokens/step: sharded {s_sh:.3f} s/step, peak "
            f"device memory {peak:.2f} GiB (its own state and steps); unsharded {s_un:.3f} "
            f"s/step, {ref_peak:.2f} GiB "
            f"(median of steps 1-{DIST_STEPS - 1}; step 0 {step_s[0]:.3f} / {ref_s[0]:.3f} s) on "
            f"{smi}")
        if profile:  # one more step of each, past the checked ones
            phase_profile_train(torch, ref_p, ref_o, batch, ref_step, "dist-train unsharded")
            phase_profile_train(torch, params, opt, batch, step, "dist-train sharded")
        del ref_p, ref_o

        # the compressed all-reduce on the gradient tree of the sharded loss
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        leaves = flatten_tree(params)
        tensors = [t.requires_grad_(True) for _, t in leaves]
        spec = batch_specs({k: (tuple(x.shape), x.dtype) for k, x in batch.items()}, ctx)
        with distribution(ctx):
            loss, _ = api.loss_fn(params, distribute_tree(batch, spec, ctx), remat=True)
            grads = torch.autograd.grad(loss, tensors)
        del loss
        local = {path: g.to_local() for (path, _), g in zip(leaves, grads)}
        del grads
        comp = compression_check(torch, local, mesh.get_group("data"))
        del local, params, opt
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        ssm_launches, ssm = dist_ssm_train(torch, seed, smi, ctx)
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        decode_launches, decode = dist_decode(torch, seed, smi, ctx)
    finally:
        dist.destroy_process_group()
    return launches, ssm_launches, decode_launches, dict(
        layers=cfg.n_layers, params=n_params, history=hist, step_s=step_s, s_per_step=s_sh,
        peak_gib=peak, unsharded_s_per_step=s_un, unsharded_peak_gib=ref_peak,
        ep_exchanges=exchanges, leaves_equal=equal, compression=comp, ssm=ssm, decode=decode)


# ------------------------------------------------------------ phase 15
def dryrun_cells(measured: dict) -> list:
    """(tag, config, batch, seq, the phase's summary) of each trained cell at
    the shapes its phase trains it."""
    import dataclasses

    from repro_torch.configs import get_config

    dense = dataclasses.replace(get_config(DENSE_TRAIN_MODEL), n_layers=DENSE_TRAIN_LAYERS)
    return ([("train", get_config(TRAIN_MODEL), TRAIN_BATCH, TRAIN_SEQ, measured["train"]),
             ("moe-train", get_config(MOE_MODEL), TRAIN_BATCH, TRAIN_SEQ, measured["moe-train"])]
            + [(f"ssm-train {m}", get_config(m), SSM_TRAIN_BATCH, SSM_TRAIN_SEQ,
                measured["ssm-train"][m]) for m in SSM_MODELS]
            + [("dense-train", dense, TRAIN_BATCH, TRAIN_SEQ, measured["dense-train"])])


def cell_dir(tmp: Path, arch: str, shape: str, multi_pod: bool) -> Path:
    return tmp / f"{arch}__{shape}__{'multipod' if multi_pod else 'pod'}"


def start_production_cell(tmp: Path, arch: str, shape: str, multi_pod: bool):
    """The dry run of one cell as a user starts it, in a process that sees
    no card; its records go under ``cell_dir``."""
    path = [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=os.pathsep.join(path),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
           "--out", str(cell_dir(tmp, arch, shape, multi_pod))] + (
               ["--multi-pod"] if multi_pod else [])
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            preexec_fn=lambda: os.nice(DRYRUN_NICE)), time.perf_counter()


def finish_production_cell(proc, t0: float, tmp: Path, arch: str, shape: str,
                           multi_pod: bool) -> dict:
    """A production cell's record: it must be OK within DRYRUN_TIMEOUT_S
    of this wait, its peak under the card's memory."""
    from repro_torch.launch import roofline

    try:
        out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"dryrun: {arch} x {shape} still ran {DRYRUN_TIMEOUT_S} s into "
                             "phase 15")
    wall = time.perf_counter() - t0  # from its start, beside the earlier phases
    paths = list(cell_dir(tmp, arch, shape, multi_pod).glob(f"*/{arch}__{shape}.json"))
    if proc.returncode != 0 or len(paths) != 1:
        raise AssertionError(f"dryrun: {arch} x {shape} exited {proc.returncode}:\n{out[-4000:]}")
    cell = json.loads(paths[0].read_text())
    terms = roofline.derive_terms(cell)
    if cell["status"] != "OK" or not cell["memory"]["fits_80GB"]:
        raise AssertionError(f"dryrun: {arch} x {shape} on {cell['mesh']}: {cell}")
    kernels = {k: v["launches"] for k, v in cell["op_analysis"]["kernels"].items()}
    log(f"dryrun: {arch} x {shape} on the fake {cell['mesh']} mesh ({cell['n_devices']} ranks), "
        f"no card visible: OK, its step's dry run {cell['run_s']:.1f} s (collected {wall:.1f} s "
        f"after its process started), launches a card {kernels}; "
        f"{cell['memory']['peak_per_device'] / 2**30:.2f} "
        f"GiB a card, modelled step {terms['step_s']:.4f} s ({terms['dominant']}-bound: compute "
        f"{terms['compute_s']:.4f}, memory {terms['memory_s']:.4f}, collective "
        f"{terms['collective_s']:.4f} s), useful {terms['useful_ratio']:.3f}")
    return dict(cell=f"{arch} x {shape}", mesh=cell["mesh"], wall_s=wall, run_s=cell["run_s"],
                peak_per_device=cell["memory"]["peak_per_device"], kernels=kernels,
                terms={k: terms[k] for k in ("compute_s", "memory_s", "collective_s", "step_s",
                                             "dominant", "useful_ratio")})


@contextlib.contextmanager
def production_cells():
    """DRYRUN_CELLS started at once, each as a user runs it in a process that
    sees no card, their records in a temporary directory: yields (the
    processes with their cells, the directory); kills what still runs on
    the way out.  They need no card and run beside phases 9-15, at a lower
    CPU priority than the phases' host work, one thread each."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        procs = [(start_production_cell(Path(tmp), *cell), *cell) for cell in DRYRUN_CELLS]
        try:
            yield procs, Path(tmp)
        finally:
            for (proc, _), *_ in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()


def phase_dryrun(torch, seed, smi, measured: dict, cells):
    """The launch layer against the card: the trained cells' steps run
    unsharded on meta tensors under the op analyser, at their phases'
    shapes, must launch exactly the kernels ``train_launch_schedule`` says
    and predict their phases' measured peaks within DRYRUN_PEAK_TOL; phase
    5's step run once more on the card under the analyser must count what
    its meta run counts, exactly; and DRYRUN_CELLS (``cells``, from
    :func:`production_cells`), each run as a user runs it on the fake
    production mesh in a process that sees no card, must be OK."""
    from repro_torch.launch.dryrun import train_step_analysis
    from repro_torch.models import build_model

    out = {}
    procs, tmp = cells
    for tag, cfg, b, seq, summary in dryrun_cells(measured):
        shapes = {k: ((b, seq), torch.int32) for k in ("tokens", "labels")}
        t0 = time.perf_counter()
        meta = train_step_analysis(build_model(cfg, device="meta"), shapes,
                                   **train_step_kwargs())
        meta_s = time.perf_counter() - t0
        want = train_launch_schedule(cfg)
        got = {k: meta["kernels"].get(k, {}).get("launches", 0) for k in want}
        if got != want:
            raise AssertionError(f"dryrun {tag}: meta launches {got} != {want}")
        measured_peak = summary["peak_gib"] * 2**30
        ratio = meta["peak_bytes"] / measured_peak if measured_peak else float("nan")
        if DEVICE == "cuda" and not abs(ratio - 1) <= DRYRUN_PEAK_TOL:
            raise AssertionError(f"dryrun {tag}: predicted peak {meta['peak_bytes']} B is "
                                 f"{ratio:.4f} x the measured {measured_peak:.0f} B")
        # the roofline of an unsharded step: its compute or its memory term
        model_s = max(meta["compute_seconds"], meta["hbm_bytes"] / HBM_BYTES_PER_S)
        log(f"dryrun {tag}: meta step in {meta_s:.1f} s: launches {got} (the schedule's); "
            f"peak {meta['peak_bytes'] / 2**30:.3f} GiB predicted, "
            f"{summary['peak_gib']:.3f} GiB measured in its phase on {smi} (ratio "
            f"{ratio:.4f}); modelled step {model_s:.4f} s (compute "
            f"{meta['compute_seconds']:.4f}, memory {meta['hbm_bytes'] / HBM_BYTES_PER_S:.4f}) "
            f"beside {summary['s_per_step']:.4f} s/step measured "
            f"({model_s / summary['s_per_step']:.3f} of it)")
        out[tag] = dict(launches=got, peak_predicted=meta["peak_bytes"],
                        peak_measured=measured_peak, peak_ratio=ratio,
                        flops=meta["flops"], hbm_bytes=meta["hbm_bytes"],
                        compute_s=meta["compute_seconds"], model_step_s=model_s,
                        measured_step_s=summary["s_per_step"])
        if tag != "train":
            continue
        # the same step once more on the card, counted by the same analyser
        api = build_model(cfg, device=DEVICE)
        params = api.init(seed=seed)
        card = train_step_analysis(api, shapes, params=params, **train_step_kwargs())
        del api, params
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        pairs = {"flops": (card["flops"], meta["flops"]),
                 "hbm_bytes": (card["hbm_bytes"], meta["hbm_bytes"]),
                 "launches": ({k: v["launches"] for k, v in card["kernels"].items()},
                              {k: v["launches"] for k, v in meta["kernels"].items()})}
        same = all(a == m for a, m in pairs.values())
        if DEVICE == "cuda" and not same:
            raise AssertionError(f"dryrun {tag}: the card step counted {pairs} (card, meta)")
        log(f"dryrun {tag}: the step on the card under the analyser counts "
            f"{card['flops']:.6g} FLOPs, {card['hbm_bytes']:.6g} bytes, launches "
            f"{pairs['launches'][0]}: "
            + ("the meta run's, exactly" if same else "not the meta run's (the plain "
               "versions run on the CPU)"))
        out[tag]["card_equal"] = same
    out["production"] = [finish_production_cell(proc, t_cell, tmp, *cell)
                         for (proc, t_cell), *cell in procs]
    return out


# ------------------------------------------------------------ main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: src/repro_torch is missing under {ROOT}; "
                         "run it from a checkout of the repo")

    import torch

    t_start = time.perf_counter()
    smi = phase_device(torch)
    phase_build(torch)
    results = phase_kernels(torch, args.seed)
    t0 = time.perf_counter()
    engine, cache, seq, serve_launches = phase_serve(torch, args.seed, smi)
    if args.profile:
        phase_profile(torch, engine, cache, seq)
    del engine, cache, seq
    torch.cuda.empty_cache()
    log(f"serve: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    api, params, opt, batch, train_step, train_launches, train = phase_train(torch, args.seed, smi)
    if args.profile:
        phase_profile_train(torch, params, opt, batch, train_step)
    del api, params, opt, batch, train_step
    torch.cuda.empty_cache()
    log(f"train: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    reset_counts()
    ssm = {m: phase_ssm(torch, args.seed, smi, m, PREFILL_LEN if m == PREFILL_MODEL else 0,
                        args.profile)
           for m in SSM_MODELS}
    ssm_launches_all = read_counts()
    torch.cuda.empty_cache()
    log(f"ssm: launches in all {ssm_launches_all}; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_cu_launches, pilot_train = phase_pilot_train(torch, args.seed, smi, train["s_per_step"])
    torch.cuda.empty_cache()
    serve_cu_launches, pilot_serve = phase_pilot_serve(torch, args.seed, smi)
    torch.cuda.empty_cache()
    pilot_launches = {k: train_cu_launches[k] + serve_cu_launches[k] for k in train_cu_launches}
    log(f"pilot: launches in all (train and serve CUs) {pilot_launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moe_launches_all, moe_out = phase_moe(torch, args.seed, smi, args.profile)
    torch.cuda.empty_cache()
    log(f"moe: {time.perf_counter() - t0:.1f} s")
    # phase 15's production cells need no card: they run beside phases 9-15,
    # whose host work (but phase 12's and 14's) leaves the CPU mostly idle
    with production_cells() as cells:
        t0 = time.perf_counter()
        moe_train_launches, moe_train = phase_moe_train(torch, args.seed, smi, args.profile)
        torch.cuda.empty_cache()
        log(f"moe-train: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        whisper_launches, whisper_out = phase_whisper(torch, args.seed, smi, args.profile)
        torch.cuda.empty_cache()
        log(f"whisper: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ssm_train_launches, ssm_train = phase_ssm_train(torch, args.seed, smi, args.profile)
        torch.cuda.empty_cache()
        log(f"ssm-train: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        dense_launches, dense = phase_dense_serve(torch, args.seed, smi, args.profile)
        torch.cuda.empty_cache()
        log(f"dense-serve: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        dense_train_launches, dense_train = phase_dense_train(torch, args.seed, smi, args.profile)
        torch.cuda.empty_cache()
        log(f"dense-train: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        dist_launches, dist_ssm_launches, dist_decode_launches, dist_train = phase_dist_train(
            torch, args.seed, smi, args.profile)
        torch.cuda.empty_cache()
        log(f"dist-train: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        dryrun = phase_dryrun(torch, args.seed, smi, {
            "train": train, "moe-train": moe_train, "ssm-train": ssm_train,
            "dense-train": dense_train}, cells)
        torch.cuda.empty_cache()
        log(f"dryrun: {time.perf_counter() - t0:.1f} s")

    # name: (route, source, what it replaces, the path whose run it counts)
    meta = {
        "decode_attention": ("cuda", DECODE_SRC,
                             "src/repro/kernels/decode_attention/decode_attention.py:125", "serve"),
        "rmsnorm": ("triton", RMSNORM_SRC, "src/repro/kernels/rmsnorm/rmsnorm.py:51", "serve"),
        "rmsnorm_residual": ("triton", RMSNORM_SRC, "src/repro/kernels/rmsnorm/rmsnorm.py:62",
                             "serve"),
        "flash_attention": ("cuda", FLASH_SRC,
                            "src/repro/kernels/flash_attention/flash_attention.py:129", "train"),
        # the JAX package has no backward kernels: these replace its jnp custom
        # VJP of attention and the autodiff of rms_norm
        "flash_attention_bwd": ("cuda", FLASH_SRC, "src/repro/models/blocked_attention.py:137",
                                "train"),
        "rmsnorm_bwd": ("triton", RMSNORM_SRC, "src/repro/models/layers.py:31", "train"),
        "ssd_scan": ("cuda", SSD_SRC, "src/repro/kernels/ssd_scan/ssd_scan.py:105", "ssm"),
        # replaces the autodiff of the jnp reference ssd_chunked
        "ssd_scan_bwd": ("cuda", SSD_BWD_SRC, "src/repro/models/mamba2.py:93", "ssm-train"),
        # the modes a sequence-split cache and a row split over ranks take
        # (the Pallas kernels' work under GSPMD's partitioning)
        "decode_attention_partial": (
            "cuda", DECODE_SRC, "src/repro/kernels/decode_attention/decode_attention.py:125",
            "dist-decode"),
        "rmsnorm_stat": ("triton", RMSNORM_SRC, "src/repro/kernels/rmsnorm/rmsnorm.py:51",
                         "dist-ssm"),
        "rmsnorm_ext": ("triton", RMSNORM_SRC, "src/repro/kernels/rmsnorm/rmsnorm.py:51",
                        "dist-ssm"),
        "rmsnorm_ext_bwd": ("triton", RMSNORM_SRC, "src/repro/models/layers.py:31", "dist-ssm"),
    }
    by_path = {"serve": serve_launches, "train": train_launches, "ssm": ssm_launches_all,
               "pilot": pilot_launches, "moe": moe_launches_all, "moe-train": moe_train_launches,
               "whisper": whisper_launches, "ssm-train": ssm_train_launches,
               "dense-serve": dense_launches, "dense-train": dense_train_launches,
               "dist-train": dist_launches, "dist-ssm": dist_ssm_launches,
               "dist-decode": dist_decode_launches}
    kernels = []
    for name, cases in results.items():
        route, source, replaces, path = meta[name]
        main_case = cases[0]  # the path's own shape
        err = max(c["max_abs_err"] for c in cases)
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": by_path[path][name], "max_abs_err": err,
            **{k: main_case[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            # the same two numbers under the names PERF.md's table uses
            "kernel_ms": main_case["ms"], "max_err": err,
            "launches_by_path": {p: counts[name] for p, counts in by_path.items()},
            "card": smi, "cases": cases,
        })
    if any(k["launches"] == 0 for k in kernels if k["name"] != "rmsnorm_residual"):
        raise AssertionError("a kernel of a path was not launched on it")
    if any(not math.isfinite(k["ms"]) for k in kernels):
        raise AssertionError("a kernel time is not finite")
    log("train: " + json.dumps(train))
    log("ssm: " + json.dumps(ssm))
    log("pilot: " + json.dumps({"train": pilot_train, "serve": pilot_serve}))
    log("moe: " + json.dumps(moe_out))
    log("moe-train: " + json.dumps(moe_train))
    log("whisper: " + json.dumps(whisper_out))
    log("ssm-train: " + json.dumps(ssm_train))
    log("dense-serve: " + json.dumps(dense))
    log("dense-train: " + json.dumps(dense_train))
    log("dist-train: " + json.dumps(dist_train))
    log("dryrun: " + json.dumps(dryrun))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
