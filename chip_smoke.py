"""On-card smoke test of the fgdm_tpu_torch port (one NVIDIA GPU).

    python3 chip_smoke.py [--sweep]

With ``--sweep`` it builds the kernels, times K1 at each tile choice (keys
per tile, ring stages, consumer warpgroups), K5 and K6 at each tile choice
(streamed tile, ring stages, consumer warpgroups) at the ``BWD_CASES``
shapes, K4 at each cluster size and the host cost of the steps around its
launch, K7 at each forced tile size and the d = 512 forward at forced KV
slice counts (how ``flash_fwd_plan``, ``flash_bwd_plan``, ``gn_plan``, K4's
wrapper, ``conv3x3_plan``'s cost weights and ``kv_splits`` were chosen),
and exits.  With no argument
it builds the port's kernels from the sources in this checkout (one
``nvcc`` per CUDA source, started together), then:

1. prints the card's name and power limit;
2. holds every kernel against its plain PyTorch version on the card at the
   shapes the paths below give it (the flash forward's lse output,
   K1 also at two ragged query lengths the gate admits,
   the d = 512 forward with and without a KV split and its combine pass,
   the flash backward's dQ and dK/dV, the fused GroupNorm+SiLU (K4, one
   cluster launch a call) also at two ragged spans, in f16 and in f32, the
   direct 3x3 conv with its transposing pre-pass at the serving shapes and
   at three ragged shapes the gates admit; each rerun must be bit-identical
   where the kernel has no atomics), and, in float32, K1 at d 40 and 80
   (with and without lse, two ragged query lengths), K2, K3 (with a forced
   single slice), the combine pass into float32, K7 and its float32
   pre-pass at the ``precision_full`` path's shapes and at the three ragged
   ones, and K5/K6 in float32 at the backward's four shapes, against the
   float32 plain versions (TF32 off), the library yardsticks SDPA (its
   backward too) and cuDNN's ``F.conv2d`` in float32; prints K4's plan
   per shape, checks
   ``Conv3x3``'s
   gradients against autograd through
   the plain conv, and times kernel, plain version and the PyTorch library
   call that computes the same function (the yardstick, never used by the
   port).  Every kernel is timed as CUDA-graph replays (``ms``, device
   time) and eagerly (``eager_ms``, which adds the host's launch cost where
   that is longer); replays of a small shape find their operands in L2.
   The rows of K1, K5 and K6 carry the time of the transposed copies their
   wrappers make (``copy_ms``, included in ``ms``: K1's V^T; K5 and K6 read
   K, Q and dO in place and make none, 0); SDPA's backward, K5 and K6's
   yardstick, is timed as the summed kernel time of ``torch.profiler`` over
   repeated calls.  Each bound counts the exponentials of the
   attention kernels beside their tensor operations and bytes
   (``bound_term``);
3. runs one full-width SD-1.4 UNet forward (with the FG-DM adapter) with the
   kernels on and with the plain versions, and compares;
4. the chain path: drives the full-width text->seg->image chain
   (``builders.build_chain`` + ``fgdm_chain``: 50 + 20 DDIM steps, batch 1,
   seeded random weights and contexts) with every launch count set to 0 just
   before, checks the image and that each kernel launched, then profiles one
   more run for the device time by kernel; then, with the conv-kernel flags
   on, compares one factor-2 UNet + ControlNet forward at [8, 4, 64, 64] and
   one 512^2 VAE decode kernels-on vs plain;
5. the checkpoint and CLI path: writes the chain's seeded weights as the
   reference's two checkpoints (``{"state_dict": ...}`` in its key schema:
   ``fgdm_seg.pth`` with the adapter UNet, VAE, CLIP and three
   ``model_ema.*`` keys, ``fgdm_control_sd15_seg.pth`` with the UNet
   without adapter, ControlNet, VAE and CLIP) into a temporary directory
   under ``build/``, loads them on the card through ``load_fgdm`` and
   ``load_controlnet`` (on its own, then sharing the factor-1 VAE and CLIP)
   and checks 0 missing, 0 unexpected keys and every tensor bit-equal to
   its source (never more than two copies of a model on the card); frees
   the chain's models; runs ``cli.txt2img_fgdm.main`` with
   run_inference.sh's flags (``--config models/config.yaml``, 5 samples,
   50 DDIM steps at CFG 7.5, 256^2, ``--use_controlnet``) on the two files,
   both conv flags on and the hash-fallback tokenizer allowed, with every
   launch count set to 0 just before, and checks 5 condition maps (256^2)
   and 5 images (512^2) as valid PNGs and that K1-K4, K7 and its pre-pass
   launched; then seg2image's compute: guess mode at strength 0.8 on those
   five maps at 512^2, 20 steps (counts reset just before), and guess
   mode's two forwards kernels on vs plain; then ``cli.seg2image.main``
   with ``--detect`` on two seeded photos at ``--detect_resolution 512``,
   conv flags on, counts reset before each run: with ``--seg_ckpt`` a
   seeded ``upernet_global_small.pth`` in mmseg's schema, then without
   (all-zero weights, as JAX); 2 images of 512^2 a run, the detected maps
   in the ADE palette, the detector's time and its own conv-kernel
   launches printed; then the guided path:
   ``cli.txt2img_fgdm.main`` with ``--inference_loss`` and the same
   factor-1 flags (no ``--use_controlnet``) on the factor-1 file, conv
   flags on, counts reset just before: 5 condition maps, K4 and K2
   launched and no K1 (the guidance captures ``"probs"``, which runs every
   attention explicitly, as in JAX), its ``[factor1]`` wall beside the
   unguided one; and one ``guided_update`` at step 10 (two unconditional
   iterations) on the CLI's CFG batch of 10, kernels on vs plain; then
   the N-factor path: ``cli.txt2img_fgdm.main`` with the same flags plus
   ``--factors seg,depth,normal --all_pconds --n_samples 2`` (the build
   of ``tools/bench_chain_n.py:49-88``: factor 1 from ``fgdm_seg.pth``,
   depth and normal at the seeded init on the card, factor 3 with one
   extra adapter fed factor 1's latent, the ControlNet stage from the
   control file rendering the normal map), conv flags on, counts reset
   just before: 2 maps a factor (256^2) and 2 images (512^2), K1-K4, K7
   and its pre-pass launched; and one forward of factor 3's multi-adapter
   UNet (full width, one ``extra_pcond``, the CLI's CFG batch of 4,
   seeded weights perturbed as the chain's), kernels on vs plain; between
   the guided and the N-factor paths, four paths on the factor-1 file's
   pipeline, conv flags on, counts reset before each: prompt-to-prompt
   editing (``ptp_sample`` at its defaults, 64^2, 50 steps, CFG 7.5, two
   prompts, a replace edit and ``LocalBlend``, CLIP contexts, both latents
   decoded at 512^2; no K1, K3 and K4 launched; the kept share printed;
   one edited UNet forward per kind at [4,4,64,64] kernels on vs plain),
   img2img (the ptp base image encoded, ``stochastic_encode`` to step 37 of
   50, ``ddim_decode`` at CFG 7.5, decoded; K1, K3, K4; then
   ``augmented_cfg_eps`` and ``composable_cfg_eps`` kernels on vs plain),
   the ancestral sampler (``p_sample_loop`` over T = 1,000 at batch 1,
   32^2, no CFG, a 256^2 decode; K1 at [1,8,1024,40], K2, K4) and the
   tiled VAE (``tiled_decode`` of a 128^2 latent as 9 tiles in one batch
   of 512^2 decodes, then ``tiled_encode``; K3 at [9,1,4096,512], K4 at
   [9,128|256,512,512], K7 at batch 9; the corner one tile alone covers
   against that tile's own decode); then the eval path (``phase_eval``):
   ``cli.eval.main`` on the factor-1 file with every scoring flag, on
   seeded reference-schema files (a ViT-L/14 CLIP in OpenAI's schema, a
   torchvision Inception, UniFormer, MiDaS, PiDiNet, OpenPose), counts
   reset just before: 8 images of 256^2, every metric finite and in range,
   K1, K2, K4, K7 and its pre-pass launched; the directory scored twice
   with identical JSON; the metric networks on the card against the CPU
   with the global TF32 switch on; the generation's UNet and VAE forwards
   kernels on vs plain; then the float32 path (``phase_precision_full``):
   ``cli.txt2img_fgdm.main`` with the CLI's flags plus ``--precision
   full`` on the two files, conv flags on, counts reset just before: 5
   maps (256^2) and 5 images (512^2), K1 at d 40 and 80, K2, K3, the
   combine pass, K7 and its pre-pass launched in float32; one float32
   factor-2 UNet + ControlNet forward at [2,4,64,64] and the float32 chain
   at batch 1 (50 + 20 steps, the same x_T), kernels on vs plain;
6. the serving path, with both conv-kernel flags on, on the engine that
   ``server.py --ckpt/--cn_ckpt`` assembles (``server.build_engine``) from
   those two files: a ``ChainEngine`` (batch 4, the fast preset:
   DPM-Solver++ 20 steps for factor 1, DDIM 20 for factor 2, CLIP on
   hash-fallback tokens, 256^2 -> 512^2) warms up with one full ``generate()``; ``server.serve`` listens on
   an ephemeral localhost port with a 500 ms batch window; with every launch
   count set to 0, four client threads POST one prompt each (distinct seeds,
   one negative), then one solo request repeats one (prompt, seed), then
   ``/healthz`` and ``/metrics``.  Checks the PNGs, that the four coalesced
   into one engine batch, that the solo image equals its coalesced slot,
   that K1-K4 and K7 (both families, with the pre-pass) launched and that
   no conv weight was packed anew; times the engine's batch of 4 (images/s
   of the serving preset) with the conv flags on and off turn about, and
   profiles one more batch of each, checking that the K4 kernels in the
   trace are as many as the wrapper's calls in that batch and that the
   tracer lost none of its kernel records; the checkpoint files are
   deleted;
7. the training path: ``builders.build_trainer`` (adapter-only fine-tuning
   at 256^2, batch 8, VAE encode + CLIP + UNet forward and backward + AdamW
   + EMA) takes one cold step with every launch count set to 0 just before,
   then 5 timed warm steps; checks the losses, the gradient norm, that the
   adapter moved and every frozen parameter did not, the EMA count; compares
   one loss and its adapter gradients kernels-on vs plain on injected
   draws; profiles one more step (printing its K4 kernels in the trace
   beside the wrapper's calls); then the distillation path on the same
   trainer: one distill step (the reference config's recipe: capture batch
   2 of 8, the teacher at the 2x latent) with every launch count set to 0
   just before, then ten steps of the config's cadence (one distill step,
   nine plain); checks ``loss_distill``, the adapter and frozen weights and
   that K1 with lse, K4, K5 and K6 launched; compares one distill loss, its
   adapter gradients and the student's and teacher's maps kernels-on vs
   plain on injected draws; profiles one distill step (the same print);
   then the condition path on the same trainer: the depth, normal, sketch
   (PiDiNet) and sketch_hed (HED) annotators at full width in float32
   (``build_condition_synth`` from a seeded generator), each target
   checked (range, depth's equal channels, normals of unit length) and its
   forward timed, then, counts reset just before, one cold and one warm
   ``make_train_step(condition=...)`` step a kind and
   ``sketch_to_normal``'s ``_encode_target`` ([8, 8, 32, 32]); the
   annotators and the frozen UNet bit-identical, one loss and its adapter
   gradients a kind kernels on vs plain;
   then the float32 training path (``phase_train_f32``):
   ``build_trainer(dtype=torch.float32)``, every model in float32, one
   cold step with every launch count set to 0 just before, 5 warm steps,
   one counted float32 distillation step: losses, grad norms, the adapter
   moved, the frozen weights bit-identical, the EMA count, launches by
   kernel and dtype (K1-f32 with lse, K4, K5-f32 and K6-f32, no bf16
   launch); one loss and its adapter gradients kernels on vs plain; one
   warm step profiled;
   then the training-CLI path: a seeded COCO-layout tree (24 + 8 JPEGs of
   320x288, L-mode label PNGs, captions) under ``build/``,
   ``cli.train.main`` on ``models/config.yaml`` at full width (batch 8 at
   256^2, ``use_checkpoint`` recomputing the UNet's blocks, distillation at
   steps 0 and 10, the config's ImageLogger at step 0) for 11 steps with
   ``--ckpt_every 10 --val_every 5``, then ``-r`` to step 13, launch counts
   reset before the first run and read after the second (the recompute's
   forwards count as launches); checks the metrics rows, the ten image
   keys, the resume, the checkpoints (frozen parameters bit-equal between
   the first and the last, the adapter moved) and that K1 with lse, K2,
   K4, K5 and K6 launched; prints the load, step, image-log, save and
   resume times and the peak memory; deletes the checkpoints; then the
   CLI on the reference's normal-factor config (``models/config.yaml``
   with ``use_depth``/``use_normal``) on the same tree for 3 steps, a
   seeded ``dpt_hybrid-midas-501f0c75.pt`` in the released schema (577
   position tokens) under ``FGDM_ANNOTATOR_DIR``, counts reset just
   before: read with 0 missing and 0 unexpected keys, finite losses,
   distillation at step 0, K1 with lse, K4, K5, K6; then, on a
   fresh seeded tree, the recipes of ``cli/recipes.py``, counts reset
   before each: ControlNet fine-tuning (``build_control``/``train_control``:
   the UNet frozen under ``remat``, AdamW on the ControlNet, ``sd_locked``,
   512^2, batch 2, 12 steps, the checkpoint round trip, 2 steps more;
   checks the losses, that the first step's gradient reaches the zero convs
   and not the ControlNet's interior and the second's the interior, the
   ControlNet moved and the UNet, VAE and CLIP bit-identical, K1 with lse,
   K3, K4, and K5/K6 at [2,8,4096,40] and [2,8,1024,80]; one loss and its
   gradients kernels on vs plain), joint two-factor training
   (``SeqTwoUNet(image_adapter, remat)``, 256^2, batch 4, 14 steps, the
   round trip after step 11; ``unet1.adapter`` and the channel mapper
   moved, both backbones bit-identical, K1 with lse, K2, K4, K5, K6; one
   loss and its gradients kernels on vs plain), co-denoising
   (``joint_denoise_fn`` under ``ddim_sample``, 20 steps at CFG 7.5, batch
   2, 32^2 of 8 channels; both halves finite with nonzero std; one forward
   kernels on vs plain) and one forward of a UNet with the config's
   variants (pixel attention in the new qkv order, ``resblock_updown``,
   ``num_classes``) kernels on vs plain, no K1; then the library modules
   no product path runs (``phase_library``): VQModel at JAX's defaults,
   LPIPS and a ``generator_loss`` with a PatchDiscriminator and its
   gradients, AdapterLight, counts reset just before that run (K2 and K7
   launched), each kernels on vs plain; VQ in float32 card vs CPU (indices
   equal but for near-ties); AttentionPool2d, BERTEmbedder (1280 x 32) and
   FrozenClipImageEmbedder (ViT-L/14) card vs CPU; MLSDdetector, Canny and
   ``sobel_edges`` at 512^2, timed stage by stage; then the parallel path
   (``phase_parallel``) on a one-rank NCCL group (one card is a world of
   one; the world-2 behaviour, halos, ring rotation and sharded gradients,
   is ``tests/test_torch_parallel.py``'s on gloo): the adapter training
   step of ``build_trainer`` (batch 8, 256^2, injected draws) plain, then
   data-parallel, tensor-parallel (``n_model`` 1) and FSDP, counts reset
   just before these three, their averaged gradients and metrics held
   against the plain step's (DP and TP bit for bit, FSDP within the
   training tolerance) and each timed; ``ring_attention`` at
   [2,8,4096,40] against ``attention_ref`` and timed beside SDPA;
   ``sample_context_parallel`` of the chain's factor 1 (fused norms off,
   50 steps, 256^2, decoded) against the plain sampler with fused norms
   off on the same x_T; ``ChainEngine(mesh=)`` at batch 4 against the plain
   engine on the same seeds, bit for bit; ``count_fsdp``/``count_sharded``
   at SD width for 2, 4 and 8 ranks; then the Winograd path
   (``phase_winograd``): ``conv3x3_winograd`` against ``F.conv2d`` in bf16
   at the served batch's K7 shapes, each timed beside cuDNN, and the
   batch-1 chain with ``FGDM_WINOGRAD_CONV`` on and off (the module flag),
   counts reset just before the flag-on run: walls, event times and the
   images' max difference;
8. holds every kernel against its plain version, and times it, at every
   other shape that a path above launched (the chain, the training step,
   the served batch, the CLI, ``--precision full``, seg2image's sampling
   and ``--detect``, the guided CLI, the distillation step, the condition
   steps, the float32 training step, the N-factor CLI, ptp, img2img, the ancestral sampler, the tiled
   VAE, the training CLI and its normal-factor config, the two recipes,
   co-denoising, the variant UNet, the library modules): K1-K3 and the
   combine pass at each (batch, heads, N, d, dtype), K5 and K6 at each
   (batch, heads, N, d, dtype), K7 and its pre-pass at each conv launch key (the
   dtype in it), K4 at each (shape, eps), each held once, in its dtype,
   under the first path that launched it; every row then reads its path's
   launch count and fails at 0;
9. prints ``{"kernels": [...]}`` (each row with its ``dtype``) and, last,
   the ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, if there is no CUDA device, if any of
the reference's kernel switches the port honours (``FGDM_DISABLE_FLASH``,
``FGDM_FLASH_MIN_N``, ``FGDM_FLASH_BWD``, ``FGDM_FLASH_TRANSPOSED``,
``FGDM_FLASH_TRANSPOSE_MAX_D``, ``FGDM_DISABLE_PALLAS_CONV``) is set away
from its default, so that no kernel is skipped quietly, or if any phase
fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import base64
import concurrent.futures
import contextlib
import gc
import itertools
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zlib

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 rate
# exp on the special-function units: 16 a clock per SM x 132 SMs x ~1.83 GHz
PEAK_EXPS = 3.9e12

ATTN_SRC = "fgdm_tpu_torch/kernels/csrc/flash_attn_fwd.cu"
ATTN512_SRC = "fgdm_tpu_torch/kernels/csrc/flash_attn_fwd_d512.cu"
BWD_SRC = "fgdm_tpu_torch/kernels/csrc/flash_attn_bwd.cu"
GN_SRC = "fgdm_tpu_torch/kernels/csrc/groupnorm_silu.cu"
CONV_SRC = "fgdm_tpu_torch/kernels/csrc/conv3x3.cu"
ATTN_F32_SRC = "fgdm_tpu_torch/kernels/csrc/flash_attn_fwd_f32.cu"
BWD_F32_SRC = "fgdm_tpu_torch/kernels/csrc/flash_attn_bwd_f32.cu"
CONV_F32_SRC = "fgdm_tpu_torch/kernels/csrc/conv3x3_f32.cu"
K1 = "fgdm_tpu/kernels/attention.py:157"   # _flash_kernel_t
K2 = "fgdm_tpu/kernels/attention.py:121"   # _flash_kernel
K3 = "fgdm_tpu/kernels/attention.py:516"   # _flash_kernel_kv
K4 = "fgdm_tpu/kernels/groupnorm.py:68"    # _kernel
K5 = "fgdm_tpu/kernels/attention.py:299"   # _flash_bwd_dq_kernel_t
K6 = "fgdm_tpu/kernels/attention.py:329"   # _flash_bwd_dkv_kernel_t
K7 = "fgdm_tpu/kernels/conv.py:100"        # _kernel (direct 3x3 conv)

# (label, TPU kernel, batch, heads, Nq, Nk, d, lse, path, splits): the
# self-attention shapes of the chain at batch 1 (CFG doubles the UNet batch;
# the VAE decodes batch 1), of the training step at batch 8 (the frozen
# input blocks launch the forward alone, the blocks that need a gradient
# with lse; the VAE encoder's mid-block at 32^2) and of the served batch of
# 4 (CFG: 8; factor 1 at 32^2 latents, factor 2 at 64^2).  ``splits`` None
# is the wrapper's own choice (at d = 512: 8, 2 and 1 KV slices at the three
# shapes); two d = 512 rows force the other case, and two K1 rows have a
# ragged query length the gate admits (Nq != Nk, Nq % 64 != 0): no path runs
# those four.
ATTN_CASES = [
    ("flash_attn_fwd d40 N1024", K1, 2, 8, 1024, 1024, 40, False, "chain",
     None),
    ("flash_attn_fwd d40 N4096", K1, 2, 8, 4096, 4096, 40, False, "chain",
     None),
    ("flash_attn_fwd d80 N1024", K1, 2, 8, 1024, 1024, 80, False, "chain",
     None),
    ("flash_attn_fwd d512 N1024", K2, 1, 1, 1024, 1024, 512, False, "chain",
     None),
    ("flash_attn_fwd d512 N4096", K3, 1, 1, 4096, 4096, 512, False, "chain",
     None),
    ("flash_attn_fwd d40 N1024 [8,8] train", K1, 8, 8, 1024, 1024, 40, False,
     "train", None),
    ("flash_attn_fwd+lse d40 N1024 [8,8] train", K1, 8, 8, 1024, 1024, 40,
     True, "train", None),
    ("flash_attn_fwd d512 N1024 [8,1] train", K2, 8, 1, 1024, 1024, 512,
     False, "train", None),
    ("flash_attn_fwd d40 N1024 [8,8] serve", K1, 8, 8, 1024, 1024, 40, False,
     "serve", None),
    ("flash_attn_fwd d40 N4096 [8,8] serve", K1, 8, 8, 4096, 4096, 40, False,
     "serve", None),
    ("flash_attn_fwd d80 N1024 [8,8] serve", K1, 8, 8, 1024, 1024, 80, False,
     "serve", None),
    ("flash_attn_fwd d512 N1024 one KV slice", K2, 1, 1, 1024, 1024, 512,
     False, None, 1),
    ("flash_attn_fwd+lse d512 N1024 [8,1] two KV slices", K2, 8, 1, 1024,
     1024, 512, True, None, 2),
    ("flash_attn_fwd+lse d40 Nq520 Nk1024 [1,3] ragged", K1, 1, 3, 520, 1024,
     40, True, None, None),
    ("flash_attn_fwd d80 Nq600 Nk1024 [1,3] ragged", K1, 1, 3, 600, 1024, 80,
     False, None, None),
]
# The float32 forwards (label, TPU kernel, batch, heads, Nq, Nk, d, lse,
# path, splits): the shapes of the ``precision_full`` path (the CLI's CFG
# batch of 10 through the UNets, its VAE batch of 5; the wrapper's own split
# count: 3 and 2 KV slices at the two VAE shapes), one forced split count,
# and two ragged query lengths the gate admits (no path).
ATTN_F32_CASES = [
    ("flash_attn_fwd f32 d40 N1024 [10,8]", K1, 10, 8, 1024, 1024, 40, False,
     "precision_full", None),
    ("flash_attn_fwd f32 d40 N4096 [10,8]", K1, 10, 8, 4096, 4096, 40, False,
     "precision_full", None),
    ("flash_attn_fwd f32 d80 N1024 [10,8]", K1, 10, 8, 1024, 1024, 80, False,
     "precision_full", None),
    ("flash_attn_fwd f32 d512 N1024 [5,1]", K2, 5, 1, 1024, 1024, 512, False,
     "precision_full", None),
    ("flash_attn_fwd f32 d512 N4096 [5,1]", K3, 5, 1, 4096, 4096, 512, False,
     "precision_full", None),
    ("flash_attn_fwd+lse f32 d40 N1024 [10,8]", K1, 10, 8, 1024, 1024, 40,
     True, None, None),
    ("flash_attn_fwd+lse f32 d80 N1024 [10,8]", K1, 10, 8, 1024, 1024, 80,
     True, None, None),
    ("flash_attn_fwd+lse f32 d512 N1024 [1,1] one KV slice", K2, 1, 1, 1024,
     1024, 512, True, None, 1),
    ("flash_attn_fwd+lse f32 d40 Nq520 Nk1024 [1,3] ragged", K1, 1, 3, 520,
     1024, 40, True, None, None),
    ("flash_attn_fwd f32 d80 Nq600 Nk1024 [1,3] ragged", K1, 1, 3, 600, 1024,
     80, False, None, None),
]
# (batch, heads, N, d): where ``--sweep`` times K1 at every tile choice
K1_SWEEP = [(2, 8, 4096, 40), (8, 8, 4096, 40), (8, 8, 1024, 40),
            (2, 8, 1024, 40), (8, 8, 1024, 80)]
# (N, splits, TPU kernel): the combine pass of the d = 512 forward at the
# chain's two VAE decodes (256^2 and 512^2 images)
COMBINE_CASES = [(1024, 8, K2), (4096, 2, K3)]
# (batch, N, splits, TPU kernel): the float32 combine pass at the
# ``precision_full`` path's two VAE decodes (batch 5, 256^2 and 512^2)
COMBINE_F32_CASES = [(5, 1024, 3, K2), (5, 4096, 2, K3)]
# (label suffix, batch, heads, Nq, Nk, d, path): backward shapes, each
# giving a K5 (dQ) and a K6 (dK/dV) row: the training step's, the
# ControlNet recipe's 512^2 shapes (N=4096 and d=80), and a ragged query
# length the gate admits (Nq != Nk, Nq % 64 != 0; no path).
BWD_CASES = [
    ("d40 N1024 [8,8] train", 8, 8, 1024, 1024, 40, "train"),
    ("d40 N4096 [2,8] control", 2, 8, 4096, 4096, 40, "control"),
    ("d80 N1024 [2,8] control", 2, 8, 1024, 1024, 80, "control"),
    ("d40 Nq520 Nk1024 [1,3] ragged", 1, 3, 520, 1024, 40, None),
]
# The float32 backward (K5-f32, K6-f32) at the same shapes: the float32
# training step's (``train_f32``; no path trains the ControlNet in float32)
BWD_F32_CASES = [(suffix, b, h, nq, nk, d, "train_f32" if path == "train"
                  else None)
                 for suffix, b, h, nq, nk, d, path in BWD_CASES]
# The reference's kernel switches the port reads, with their defaults.
SWITCHES = {"FGDM_DISABLE_FLASH": ("attention", "_DISABLE_FLASH", False),
            "FGDM_FLASH_MIN_N": ("attention", "_MIN_N", 512),
            "FGDM_FLASH_BWD": ("attention", "_FLASH_BWD", True),
            "FGDM_FLASH_TRANSPOSED": ("attention", "_FLASH_TRANSPOSED", True),
            "FGDM_FLASH_TRANSPOSE_MAX_D": ("attention", "_TRANSPOSE_MAX_D",
                                           96),
            "FGDM_DISABLE_PALLAS_CONV": ("conv", "_DISABLE", False)}
# (label, shape, eps, path): GroupNorm+SiLU shapes of UNet/ControlNet
# ResBlocks (eps 1e-5) and VAE ResnetBlocks (eps 1e-6).
GN_CASES = [
    ("group_norm_silu [2,320,64,64]", (2, 320, 64, 64), 1e-5, "chain"),
    ("group_norm_silu [2,2560,8,8]", (2, 2560, 8, 8), 1e-5, "chain"),
    ("group_norm_silu [1,512,64,64]", (1, 512, 64, 64), 1e-6, "chain"),
    ("group_norm_silu [1,128,512,512]", (1, 128, 512, 512), 1e-6, "chain"),
    ("group_norm_silu [8,320,32,32] train", (8, 320, 32, 32), 1e-5, "train"),
    ("group_norm_silu [8,128,256,256] train", (8, 128, 256, 256), 1e-6,
     "train"),
]
# The two-launch Triton kernel that K4 replaced, at the GN_CASES shapes:
# (device ms by graph replay, eager ms), H100 80GB HBM3, 700.00 W, as
# PERF.md records them ("before" in the rows' log lines)
GN_BEFORE = {(2, 320, 64, 64): (0.0102, 0.0953),
             (2, 2560, 8, 8): (0.0058, 0.0817),
             (1, 512, 64, 64): (0.0121, 0.0682),
             (1, 128, 512, 512): (0.0804, 0.0989),
             (8, 320, 32, 32): (0.0095, 0.0524),
             (8, 128, 256, 256): (0.1489, 0.1540)}
# (label, shape, eps, dtype, SiLU): shapes and types the gate admits and no
# path runs: spans that are no whole number of 16-byte vectors (element
# loads; one of them split over a cluster of 2), f16, and the f32 512^2
# plane (streamed)
GN_OTHER = [
    ("group_norm_silu [3,128,5,7] ragged", (3, 128, 5, 7), 1e-5,
     "bfloat16", True),
    ("group_norm_silu [2,160,17,23] ragged", (2, 160, 17, 23), 1e-6,
     "bfloat16", True),
    ("group_norm [2,160,17,23] f32 ragged, no SiLU", (2, 160, 17, 23), 1e-5,
     "float32", False),
    ("group_norm_silu [2,320,64,64] f16", (2, 320, 64, 64), 1e-5, "float16",
     True),
    ("group_norm_silu [1,128,512,512] f32", (1, 128, 512, 512), 1e-6,
     "float32", True),
]
# K7's launch keys (N, C, Co, H, W) of the served batch's 3x3 convs, one per
# family: the factor-2 UNet and ControlNet at batch 8 with CFG (levels 0-2,
# one up-block concat input), the VAE decoder at batch 4 (64^2 x 512 and
# the level-0 512^2 x 128 family).  The other shapes the served batch
# launches are checked after it, from its launch counts.
CONV_CASES = [(8, 320, 320, 64, 64), (8, 640, 640, 32, 32),
              (8, 1280, 1280, 16, 16), (8, 960, 320, 64, 64),
              (4, 512, 512, 64, 64), (4, 128, 128, 512, 512)]
# shapes the gates admit and no path launches: W % 8 != 0, Co % 128 != 0,
# C % 64 != 0, H != W
RAGGED_CONV_CASES = [(3, 136, 200, 24, 24), (2, 128, 136, 17, 23),
                     (1, 264, 128, 64, 20)]
# K7's float32 launch keys, one per family, of the ``precision_full`` path
# (the CLI's factor-2 UNet and ControlNet at its CFG batch of 10, the VAE
# decoder at 5); the path's other shapes are held after it, from its
# launch counts; and the ragged shapes in float32
CONV_F32_CASES = [(10, 320, 320, 64, 64, "float32"),
                  (10, 640, 640, 32, 32, "float32"),
                  (10, 1280, 1280, 16, 16, "float32"),
                  (10, 960, 320, 64, 64, "float32"),
                  (5, 512, 512, 64, 64, "float32"),
                  (5, 128, 128, 512, 512, "float32")]
RAGGED_CONV_F32_CASES = [(*k, "float32") for k in RAGGED_CONV_CASES]
ATTN_TOL = (1e-2, 1e-3)   # max|d| <= 1e-2 * max|ref| + 1e-3 (bf16 out, P)
LSE_TOL = 1e-3            # max|d| of the f32 lse (same f32 scores)
BWD_TOL = (2e-2, 2e-3)    # max|d| <= 2e-2 * max|ref| + 2e-3 (bf16 p and dS)
GN_TOL = 1e-2             # max |d| / (1 + |ref|) (bf16 output rounding)
CONV_TOL = (1e-2, 1e-3)   # max|d| <= 1e-2 * max|ref| + 1e-3 (bf16 output)
UNET_TOL = 5e-2           # max|d| / max|ref| of the UNet eps, bf16 chain
# float32 kernels against their float32 plain versions, TF32 off: sums in
# another order, no rounding to a narrower type
ATTN_F32_TOL = (1e-4, 1e-5)   # max|d| <= 1e-4 * max|ref| + 1e-5
LSE_F32_TOL = 1e-4
CONV_F32_TOL = (1e-4, 1e-5)
UNET_F32_TOL = 1e-3       # max|d| / max|ref| of a float32 UNet eps
CHAIN_F32_TOL = 1e-2      # max|d| / max|ref| of the float32 chain's image
WINO_TOL = 3e-2           # max|d| / max|ref|, Winograd bf16 vs f32 direct
LOSS_TOL = 1e-2           # relative difference of the training loss
TRAIN_BATCH, WARM_STEPS = 8, 5
SERVE_BATCH, SERVE_TIMED = 4, 3
SERVE_SEEDS = (11, 22, -33, 44)   # one client each; the third repeats solo
PROMPT_CLI = "a dog running on the beach"


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps, rounds=2):
    """Device time of ``fn`` per call over ``reps`` back-to-back calls
    (where ``fn`` is shorter than its launch cost, the host's time), after
    three warm-up calls; the least of ``rounds`` such means."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = math.inf
    for _ in range(rounds):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def graph_ms(fn, reps):
    """Device time of ``fn`` alone: ``reps`` calls captured into one CUDA
    graph and replayed, so the host's launch cost drops out.  For the
    kernels that take less time than the host needs to launch them."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 3, rounds=1) / reps


def profiled_ms(fn, reps):
    """Device time of ``fn`` per call: the summed kernel time that
    ``torch.profiler`` records over ``reps`` calls after three warm-up
    calls (``trace_run``); None if the trace holds no device time."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    by_name, _ = trace_run(lambda: [fn() for _ in range(reps)])
    us = sum(t for _, t in by_name.values())
    return us / 1e3 / reps if us > 0 else None


# The tracer loses the kernel records of the first few launches of a trace
# and, in some traces, of its last ones (up to thousands), whatever the
# kernel; their launch records stay.  So a traced run sits between two pads
# of spin kernels (about 50 us each on an H100) that take those losses.
PAD_LAUNCHES = (512, 4096)
PAD_CYCLES = 100_000
TRACE_TRIES = 3


def trace_run(run):
    """{kernel name: (launches, us)} of the device events that ``run``
    issued, from a trace of ``run`` between the two pads, and the trace's
    lost kernel records ``(in the first pad, in the run, in the last pad)``:
    launches whose kernel the trace does not hold (launches and kernels are
    matched by their correlation ids).  A run with a lost record is traced
    again, at most ``TRACE_TRIES`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    lead, trail = PAD_LAUNCHES

    def pad(n):
        for _ in range(n):
            torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()

    for _ in range(TRACE_TRIES):
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            pad(lead)
            run()
            torch.cuda.synchronize()
            pad(trail)
        events = prof.profiler.kineto_results.events()
        launches = sorted(e.correlation_id() for e in events
                          if e.device_type() == cpu and "Launch" in e.name()
                          and "Kernel" in e.name())
        lo, hi = launches[lead - 1], launches[-trail]
        by_name, recorded = {}, set()
        for e in events:
            # user annotations (e.g. "Optimizer.step#AdamW.step") span
            # kernels that are counted on their own
            if e.device_type() != cuda or e.is_user_annotation():
                continue
            recorded.add(e.correlation_id())
            if lo < e.correlation_id() < hi:
                n, t = by_name.get(e.name(), (0, 0.0))
                by_name[e.name()] = (n + 1, t + e.duration_ns() / 1e3)
        lost = tuple(sum(c not in recorded for c in part) for part in (
            launches[:lead], launches[lead:-trail], launches[-trail:]))
        if lost[1] == 0:
            break
    return by_name, lost


def switches_off_default():
    """The names of the reference's kernel switches that this process reads
    away from their defaults."""
    import importlib

    return [name for name, (mod, attr, default) in SWITCHES.items()
            if getattr(importlib.import_module(
                f"fgdm_tpu_torch.kernels.{mod}"), attr) != default]


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def build_kernels():
    """nvcc every CUDA source at once."""
    from fgdm_tpu_torch.kernels import _build, attention, conv, groupnorm

    t0 = time.perf_counter()
    names = ("flash_attn_fwd", "flash_attn_fwd_d512", "flash_attn_bwd",
             "flash_attn_fwd_f32", "flash_attn_bwd_f32", "conv3x3",
             "conv3x3_f32", "groupnorm_silu")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        paths = list(pool.map(_build.build, names))
    attention._lib()
    attention._d512_lib()
    attention._bwd_lib()
    attention._f32_lib()
    attention._bwd_f32_lib()
    conv._lib()
    conv._f32_lib()
    groupnorm._lib()
    log(f"built {', '.join(p.name for p in paths)} in "
        f"{time.perf_counter() - t0:.1f}s")
    for path in paths:
        for line in path.with_suffix(".log").read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry",
                                       "Performance Loss")):
                log(f"  ptxas {path.name.split('-')[0]}: " + line.strip())


def bound(flops, nbytes, peak_flops, exps=0.0):
    """``(ms, by, term)``: the least time for ``flops`` operations at
    ``peak_flops``, ``exps`` exponentials at ``PEAK_EXPS`` and ``nbytes``
    at the HBM rate, the larger of the three.  ``by`` is "operations" (the
    tensor-core, f32 or exp term) or "bytes"; ``term`` names which of the
    four: "tensor", "f32", "exp" or "bytes"."""
    terms = {("tensor" if peak_flops == PEAK_BF16_FLOPS else "f32"):
             flops / peak_flops, "exp": exps / PEAK_EXPS,
             "bytes": nbytes / PEAK_BYTES}
    term = max(terms, key=terms.get)
    return (1e3 * terms[term], "bytes" if term == "bytes" else "operations",
            term)


def attn_kernel(d, nk):
    """The TPU kernel a forward at head dim ``d`` over ``nk`` keys stands
    for: K1 (transposed layout) up to d = 96, else K3 where the reference
    streams the keys (K+V, double-buffered and lane-padded, over its 8 MiB
    residency budget, ``attention.py:612-618``), else K2."""
    if d <= 96:
        return K1
    return K3 if 2 * 2 * nk * (-(-d // 128) * 128) * 2 > 8 << 20 else K2


def attn_rows(gen):
    """K1-K3 forward rows at ``ATTN_CASES`` (bf16) and ``ATTN_F32_CASES``."""
    return ([attn_row(gen, *case) for case in ATTN_CASES]
            + [attn_row(gen, *case, dtype="float32")
               for case in ATTN_F32_CASES])


def attn_row(gen, label, tpu, b, h, nq, nk, d, with_lse, path, splits,
             dtype="bfloat16"):
    """A K1-K3 forward row in ``dtype``: the output against the plain
    version's, the lse output against the plain version's, the output with
    lse against the output without, and the rerun, bit for bit.  Kernel and
    SDPA (in the same dtype; TF32 off) are timed as device time (CUDA graph
    replays, ``ms``) and eagerly (``eager_ms``, the timer of PR 1-4's K1
    figures; SDPA's is logged), the plain version as a replay up to 2^26
    scores, eagerly above.  A float32 row's bound takes the f32 rate and 4
    bytes an element."""
    import torch
    import torch.nn.functional as F
    from fgdm_tpu_torch.kernels import attention

    f32 = dtype == "float32"
    dt = getattr(torch, dtype)
    q = torch.randn(b, h, nq, d, device="cuda", generator=gen, dtype=dt)
    k, v = (torch.randn(b, h, nk, d, device="cuda", generator=gen, dtype=dt)
            for _ in range(2))
    scale = d ** -0.5
    kw = {"splits": splits} if d == 512 else {}
    out = attention.flash_attention(q, k, v, scale, **kw)
    ref, ref_lse = attention.attention_ref(q, k, v, scale,
                                           return_lse=True)
    tol, lse_tol = (ATTN_F32_TOL, LSE_F32_TOL) if f32 else (ATTN_TOL,
                                                            LSE_TOL)
    err = (out.float() - ref.float()).abs().max().item()
    lim = tol[0] * ref.float().abs().max().item() + tol[1]
    ok = math.isfinite(err) and err <= lim and out.dtype == dt
    out_l, lse = attention.flash_attention(q, k, v, scale,
                                           return_lse=True, **kw)
    lse_err = (lse - ref_lse).abs().max().item()
    same = torch.equal(out_l, out)
    rerun = torch.equal(attention.flash_attention(q, k, v, scale, **kw),
                        out)
    ok = (ok and math.isfinite(lse_err) and lse_err <= lse_tol and same
          and rerun)
    note = (f"  lse max|d|={lse_err:.3e} (tol {lse_tol}), output "
            f"with lse {'==' if same else '!='} without, rerun "
            f"bit-identical {rerun}")
    vt_ms = None
    if f32:
        plan = attention.flash_f32_plan(b * h, nq, nk, d, kw.get("splits"))
        note += (f", tile {plan.bm} rows x {plan.bn} keys, {plan.splits} KV "
                 f"slice(s), {plan.grid[0] * plan.grid[1] * plan.grid[2]} "
                 f"blocks")
    elif d == 512:
        used = splits or attention.kv_splits(b * h, nq, nk)
        note += f", {used} KV slice(s)"
    else:
        plan = attention.flash_fwd_plan(b * h, nq, nk, d)
        vt_ms = graph_ms(lambda: v.transpose(2, 3).contiguous(), 20)
        note += (f", tile {plan.bn} keys x {plan.stages} stages x "
                 f"{plan.wgs} warpgroup(s), "
                 f"{plan.grid[0] * plan.grid[1]} blocks, of the kernel "
                 f"time the V^T copy {vt_ms:.4f} ms")
    reps = 20 if nq * b >= 8192 else 50

    def run():
        return attention.flash_attention(q, k, v, scale,
                                         return_lse=with_lse, **kw)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, scale=scale)

    ms = graph_ms(run, reps)
    eager_ms = cuda_ms(run, reps)
    # the plain version's f32 scores take GBs at N = 4096: eagerly there
    # (the launch cost is nothing beside it), not ``reps`` copies in one
    # graph's pool
    plain_timer = graph_ms if b * h * nq * nk <= 1 << 26 else cuda_ms
    plain_ms = plain_timer(lambda: attention.attention_ref(
        q, k, v, scale, return_lse=with_lse), reps)
    lib_ms = graph_ms(sdpa, reps)
    lib_eager = cuda_ms(sdpa, reps)
    bound_ms, bound_by, term = bound(
        4.0 * b * h * nq * nk * d,
        q.element_size() * b * h * d * (2 * nq + 2 * nk)
        + (4.0 * b * h * nq if with_lse else 0),
        PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS,
        exps=1.0 * b * h * nq * nk)
    row = dict(
        name=label, route="cuda",
        source=(ATTN_F32_SRC if f32 else ATTN512_SRC if d == 512
                else ATTN_SRC), replaces=tpu, dtype=dtype,
        key=("attn", b, h, nq, nk, d, with_lse, dtype), path=path,
        max_abs_err=err, tol=lim, ok=ok, ms=ms, eager_ms=eager_ms,
        copy_ms=vt_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, bound_term=term, library_ms=lib_ms)
    log(f"{label}: max|d|={err:.3e} (tol {lim:.3e}){note} "
        f"{'OK' if ok else 'FAIL'}  kernel {ms:.4f} ms (eager "
        f"{eager_ms:.4f})  plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms "
        f"(eager {lib_eager:.4f})  bound {bound_ms:.4f} ms ({term}; "
        f"{100 * bound_ms / ms:.1f} % of it)")
    return row


def combine_rows(gen):
    """The combine pass at ``COMBINE_CASES`` (bf16) and
    ``COMBINE_F32_CASES``."""
    return ([combine_row(gen, 1, 1, n, splits, tpu, "chain")
             for n, splits, tpu in COMBINE_CASES]
            + [combine_row(gen, b, 1, n, splits, tpu, "precision_full",
                           "float32")
               for b, n, splits, tpu in COMBINE_F32_CASES])


def combine_row(gen, b, h, n, splits, tpu, path, dtype="bfloat16"):
    """The combine pass of the d = 512 forward at [b, h, n, 512] in
    ``splits`` slices into ``dtype`` against ``combine_ref`` on the plain
    split version's partials (the same f32 inputs to both)."""
    import torch
    from fgdm_tpu_torch.kernels import attention

    f32 = dtype == "float32"
    dt = getattr(torch, dtype)
    label = (f"flash_combine{' f32' if f32 else ''} d512 N{n} [{b},{h}] "
             f"{splits} slices")
    q, k, v = (torch.randn(b, h, n, 512, device="cuda", generator=gen,
                           dtype=dt) for _ in range(3))
    parts = attention.attention_split_ref(q, k, v, 512 ** -0.5, splits)
    parts = tuple(p.contiguous() for p in parts)
    out, lse = attention.flash_combine(*parts, dt)
    ref, ref_lse = attention.combine_ref(*parts, dt)
    again = attention.flash_combine(*parts, dt)
    tol, lse_tol = (ATTN_F32_TOL, LSE_F32_TOL) if f32 else (ATTN_TOL,
                                                            LSE_TOL)
    err = (out.float() - ref.float()).abs().max().item()
    lim = tol[0] * ref.float().abs().max().item() + tol[1]
    lse_err = (lse - ref_lse).abs().max().item()
    same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ok = (math.isfinite(err) and err <= lim and math.isfinite(lse_err)
          and lse_err <= lse_tol and same and out.dtype == dt)
    ms = graph_ms(lambda: attention.flash_combine(*parts, dt), 50)
    eager_ms = cuda_ms(lambda: attention.flash_combine(*parts, dt), 50)
    plain_ms = graph_ms(lambda: attention.combine_ref(*parts, dt), 50)
    rows = b * h * n
    nbytes = (4.0 * splits * rows * (512 + 2)
              + rows * (out.element_size() * 512.0 + 4))
    bound_ms, bound_by, term = bound(3.0 * splits * rows * 512, nbytes,
                                     PEAK_F32_FLOPS)
    log(f"{label}: max|d|={err:.3e} (tol {lim:.3e}), lse max|d|="
        f"{lse_err:.3e} (tol {lse_tol}), rerun bit-identical {same} "
        f"{'OK' if ok else 'FAIL'}  kernel {ms:.4f} ms  plain "
        f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})  "
        f"(device times; eager {eager_ms:.4f} ms)")
    return dict(
        name=label, route="cuda", source=ATTN512_SRC, replaces=tpu,
        dtype=dtype, key=("combine", b, h, n, splits, dtype), path=path,
        max_abs_err=err,
        tol=lim, ok=ok, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, bound_term=term,
        library_ms=None)


def bwd_inputs(gen, b, h, nq, nk, d, dtype="bfloat16"):
    """q, k, v, dO in ``dtype`` and the forward kernel's output and lse,
    and delta."""
    import torch
    from fgdm_tpu_torch.kernels import attention

    dt = getattr(torch, dtype)
    q, do = (torch.randn(b, h, nq, d, device="cuda", generator=gen,
                         dtype=dt) for _ in range(2))
    k, v = (torch.randn(b, h, nk, d, device="cuda", generator=gen,
                        dtype=dt) for _ in range(2))
    scale = d ** -0.5
    o, lse = attention.flash_attention(q, k, v, scale, return_lse=True)
    delta = (do.float() * o.float()).sum(dim=-1)
    return q, k, v, do, o, lse, delta, scale


def bwd_errors(got, refs, tol=BWD_TOL):
    """{name: (max|d|, limit)} of (dq, dk, dv) or a part of it, keyed
    by the gradient's name; the limit ``tol[0] * max|ref| + tol[1]``."""
    out = {}
    for name, g, ref in zip("qkv", got, refs):
        if g is None:
            continue
        err = (g.float() - ref.float()).abs().max().item()
        out[name] = (err, tol[0] * ref.float().abs().max().item() + tol[1])
    return out


def bwd_rows(gen):
    """K5 and K6 at ``BWD_CASES`` (bf16) and ``BWD_F32_CASES``."""
    rows = []
    for case in BWD_CASES:
        rows += bwd_row(gen, *case)
    for case in BWD_F32_CASES:
        rows += bwd_row(gen, *case, dtype="float32")
    return rows


def bwd_row(gen, suffix, b, h, nq, nk, d, path, dtype="bfloat16"):
    """K5 (dQ) and K6 (dK/dV) against ``attention_bwd_ref`` on the same
    inputs in ``dtype`` and the forward kernel's output and lse, each rerun
    bit for bit.  The plain version of each is the whole plain backward (the
    wrappers' CPU route); the library yardstick is SDPA's backward alone in
    the same dtype (TF32 off), by its kernels' summed device time
    (``profiled_ms``).  A float32 row is held within ``ATTN_F32_TOL`` and
    bounded by the f32 rate at 4 bytes an element."""
    import torch
    import torch.nn.functional as F
    from fgdm_tpu_torch.kernels import attention

    f32 = dtype == "float32"
    rows = []
    q, k, v, do, o, lse, delta, scale = bwd_inputs(gen, b, h, nq, nk, d,
                                                   dtype)
    dq = attention.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)
    dk, dv = attention.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                               scale)
    again = attention.flash_attention_backward(q, k, v, o, lse, do, scale)
    refs = attention.attention_bwd_ref(q, k, v, o, lse, do, scale)
    errs = bwd_errors((dq, dk, dv), refs, ATTN_F32_TOL if f32 else BWD_TOL)
    oks = {c: math.isfinite(errs[c][0]) and errs[c][0] <= errs[c][1]
           and torch.equal(got, rep) and got.dtype == q.dtype
           for c, got, rep in zip("qkv", (dq, dk, dv), again)}
    reps = 10 if nq >= 4096 else 30
    if f32:
        plans = attention.flash_bwd_f32_plan(b * h, nq, nk, d)
        tiles = [f"{p.rows} rows x {p.bt} streamed" for p in plans]
    else:
        plans = attention.flash_bwd_plan(b * h, nq, nk, d)
        tiles = [f"{p.bt} x {p.stages} stages x {p.wgs} warpgroup(s)"
                 for p in plans]
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
    lib_ms = profiled_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), reps)
    plain_ms = cuda_ms(lambda: attention.attention_bwd_ref(
        q, k, v, o, lse, do, scale), reps)
    bh, ops = b * h, 1.0 * b * h * nq * nk * d
    esize = q.element_size()
    for kern, tpu, plan, tile, names, flops, nbytes, run in (
            ("flash_attn_bwd_dq", K5, plans[0], tiles[0], "q", 6.0 * ops,
             esize * d * bh * (3.0 * nq + 2 * nk) + 8.0 * bh * nq,
             lambda: attention.flash_attention_bwd_dq(
                 q, k, v, do, lse, delta, scale)),
            ("flash_attn_bwd_dkv", K6, plans[1], tiles[1], "kv", 8.0 * ops,
             esize * d * bh * (2.0 * nq + 4 * nk) + 8.0 * bh * nq,
             lambda: attention.flash_attention_bwd_dkv(
                 q, k, v, do, lse, delta, scale))):
        # each recomputes P: one exp per score
        bound_ms, bound_by, term = bound(
            flops, nbytes, PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS,
            exps=1.0 * b * h * nq * nk)
        ms = graph_ms(run, reps)
        eager_ms = cuda_ms(run, reps)
        err = max(errs[c][0] for c in names)
        ok = all(oks[c] for c in names)
        label = f"{kern}{' f32' if f32 else ''} {suffix}"
        rows.append(dict(
            name=label, route="cuda", source=BWD_F32_SRC if f32 else BWD_SRC,
            replaces=tpu, dtype=dtype, key=(kern, b, h, nq, nk, d, dtype),
            path=path,
            max_abs_err=err, ok=ok, ms=ms, eager_ms=eager_ms, copy_ms=0.0,
            plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, bound_term=term, library_ms=lib_ms))
        log(f"{label}: "
            + " ".join(f"d{c} max|d|={errs[c][0]:.3e} (tol "
                       f"{errs[c][1]:.3e})" for c in names)
            + f", rerun bit-identical {all(oks[c] for c in names)}, tile "
            f"{tile}, {plan.grid[0] * plan.grid[1]} blocks "
            f"{'OK' if ok else 'FAIL'}  kernel {ms:.4f} ms (eager "
            f"{eager_ms:.4f})"
            f"  plain backward {plain_ms:.4f} ms  sdpa backward "
            f"{'not measured' if lib_ms is None else f'{lib_ms:.4f} ms'}"
            f" (profiled kernel time)  bound {bound_ms:.4f} ms ({term}; "
            f"{100 * bound_ms / ms:.1f} % of it)")
    return rows


def gn_row(gen, label, shape, eps, path, dtype="bfloat16", silu=True):
    """K4 at one shape: the output against ``group_norm_silu_ref`` and a
    rerun bit-identical; kernel, plain version and ``F.group_norm``
    (+ ``F.silu``) in x's dtype timed by graph replay (device time) and
    eagerly; the plan the card runs."""
    import torch
    import torch.nn.functional as F
    from fgdm_tpu_torch.kernels import groupnorm

    dt = getattr(torch, dtype)
    c = shape[1]
    x = torch.randn(shape, device="cuda", generator=gen, dtype=dt)
    w = 1 + 0.1 * torch.randn(c, device="cuda", generator=gen)
    bias = 0.1 * torch.randn(c, device="cuda", generator=gen)

    def kern():
        return groupnorm.group_norm_silu_kernel(x, w, bias, 32, eps, silu)

    out = kern()
    same = torch.equal(out, kern())
    ref = groupnorm.group_norm_silu_ref(x, w, bias, 32, eps, silu)
    torch.cuda.synchronize()
    rel = ((out.float() - ref.float()).abs()
           / (1 + ref.float().abs())).max().item()
    err = (out.float() - ref.float()).abs().max().item()
    ok = math.isfinite(rel) and rel <= GN_TOL and same
    del out, ref
    reps = 20 if x.numel() > 1 << 24 else 100
    wb, bb = w.to(dt), bias.to(dt)

    def lib():
        y = F.group_norm(x, 32, wb, bb, eps)
        return F.silu(y) if silu else y

    ms, eager_ms = graph_ms(kern, reps), cuda_ms(kern, reps)
    plain_ms = graph_ms(lambda: groupnorm.group_norm_silu_ref(
        x, w, bias, 32, eps, silu), reps)
    lib_ms, lib_eager = graph_ms(lib, reps), cuda_ms(lib, reps)
    nbytes = 2.0 * x.numel() * x.element_size() + 2 * c * 4
    flops = 8.0 * x.numel()   # sums, affine, SiLU: ~8 f32 ops/element
    bound_ms, bound_by, term = bound(flops, nbytes, PEAK_F32_FLOPS)
    plan = groupnorm.card_plan(tuple(shape), dt, 32)
    before = GN_BEFORE.get(tuple(shape)) if dtype == "bfloat16" else None
    log(f"{label} {dtype} eps={eps}: max|d|={err:.3e} max|d|/(1+|ref|)="
        f"{rel:.3e} (tol {GN_TOL}), rerun bit-identical {same} "
        f"{'OK' if ok else 'FAIL'}  kernel {ms:.4f} ms (eager {eager_ms:.4f};"
        f" {100 * bound_ms / ms:.0f}% of bound; before: "
        f"{'%.4f / %.4f' % before if before else '-'})  plain "
        f"{plain_ms:.4f} ms  F.group_norm{'+silu' if silu else ''} "
        f"{lib_ms:.4f} ms (eager {lib_eager:.4f})  bound {bound_ms:.4f} ms "
        f"({term})  plan k={plan.k} per_sm={plan.per_sm} threads="
        f"{plan.threads} slice="
        f"{plan.slice} resident={plan.resident} smem={plan.smem} streams="
        f"{plan.streams} aligned={plan.aligned} blocks={plan.blocks}")
    return dict(
        name=label, route="cuda", source=GN_SRC, replaces=K4, dtype=dtype,
        key=("gn", tuple(shape), eps), path=path, max_abs_err=err,
        tol=GN_TOL, ok=ok, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, bound_term=term,
        library_ms=lib_ms)


def gn_rows(gen):
    """K4 at ``GN_CASES`` and ``GN_OTHER``."""
    rows = [gn_row(gen, label, shape, eps, path)
            for label, shape, eps, path in GN_CASES]
    rows += [gn_row(gen, label, shape, eps, None, dtype, silu)
             for label, shape, eps, dtype, silu in GN_OTHER]
    return rows


def gn_path_rows(gen, by_path):
    """K4 at every (shape, eps) that a path launched and ``GN_CASES`` does
    not hold, in bf16 (the paths' dtype); a shape two paths launch is held
    once, under the first."""
    import torch

    done = {(shape, eps) for _, shape, eps, _ in GN_CASES}
    rows = []
    for path, counts in by_path.items():
        for shape, eps in sorted(set(counts["gn"]) - done):
            done.add((shape, eps))
            label = f"group_norm_silu [{','.join(map(str, shape))}] {path}"
            rows.append(gn_row(gen, label, shape, eps, path))
            torch.cuda.empty_cache()
    return rows


def attn_path_rows(gen, by_path):
    """K1-K3 and the combine pass at every forward shape a path launched
    that ``ATTN_CASES`` and ``COMBINE_CASES`` do not hold (the served batch's
    VAE decodes, the CLI's CFG batch of 10 and VAE batch of 5, seg2image's
    two guess-mode forwards of 5), each under the first path that launched
    it.  ``splits`` is the wrapper's own choice, as on the paths."""
    import torch

    done = {("attn", b, h, nq, nk, d, lse, "bfloat16")
            for _, _, b, h, nq, nk, d, lse, path, _ in ATTN_CASES if path}
    done |= {("attn", b, h, nq, nk, d, lse, "float32")
             for _, _, b, h, nq, nk, d, lse, path, _ in ATTN_F32_CASES
             if path}
    done |= {("combine", 1, 1, n, s, "bfloat16")
             for n, s, _ in COMBINE_CASES}
    done |= {("combine", b, 1, n, s, "float32")
             for b, n, s, _ in COMBINE_F32_CASES}
    rows = []
    for path, counts in by_path.items():
        for b, h, nq, nk, d, lse, dt in sorted(counts["attn"]):
            if ("attn", b, h, nq, nk, d, lse, dt) in done:
                continue
            done.add(("attn", b, h, nq, nk, d, lse, dt))
            label = (f"flash_attn_fwd{'+lse' if lse else ''}"
                     f"{' f32' if dt == 'float32' else ''} d{d} "
                     f"N{nq}" + (f" Nk{nk}" if nk != nq else "")
                     + f" [{b},{h}] {path}")
            rows.append(attn_row(gen, label, attn_kernel(d, nk), b, h, nq,
                                 nk, d, lse, path, None, dt))
            torch.cuda.empty_cache()
        for b, h, n, splits, dt in sorted(counts["combine"]):
            if ("combine", b, h, n, splits, dt) in done:
                continue
            done.add(("combine", b, h, n, splits, dt))
            rows.append(combine_row(gen, b, h, n, splits,
                                    attn_kernel(512, n), path, dt))
    return rows


def bwd_path_rows(gen, by_path):
    """K5 and K6 at every (B, H, Nq, Nk, d, dtype) a path launched that
    ``BWD_CASES`` and ``BWD_F32_CASES`` do not hold (the distillation
    steps' split batches), each under the first path that launched it."""
    import torch

    done = {(b, h, nq, nk, d, "bfloat16")
            for _, b, h, nq, nk, d, path in BWD_CASES if path}
    done |= {(b, h, nq, nk, d, "float32")
             for _, b, h, nq, nk, d, path in BWD_F32_CASES if path}
    rows = []
    for path, counts in by_path.items():
        keys = set(counts["flash_attn_bwd_dq"]) | set(
            counts["flash_attn_bwd_dkv"])
        for b, h, nq, nk, d, dt in sorted(keys - done):
            done.add((b, h, nq, nk, d, dt))
            rows += bwd_row(gen, f"d{d} N{nq}" + (f" Nk{nk}" if nk != nq
                                                  else "")
                            + f" [{b},{h}] {path}", b, h, nq, nk, d, path,
                            dt)
            torch.cuda.empty_cache()
    return rows


def conv_path_rows(gen, by_path):
    """K7 and its pre-pass at every launch key a path launched that
    ``CONV_CASES`` does not hold, each under the first path that launched
    it."""
    import torch

    done = {(*k, "bfloat16") for k in CONV_CASES} | set(CONV_F32_CASES)
    rows = []
    for path, counts in by_path.items():
        keys = sorted(set(counts["conv"]) - done)
        done |= set(keys)
        for key in keys:
            rows += conv_rows(gen, [key], path=path)
            torch.cuda.empty_cache()
    return rows


def gn_host_costs():
    """Host microseconds a call, each over 20,000 calls: the steps around
    K4's launch (the device context and the stream object the wrapper
    avoids, what it calls in their place, the output it allocates, its plan
    lookup) and the whole wrapper at [2,320,8,8], where the host, not the
    card, sets the pace."""
    import torch
    from fgdm_tpu_torch.kernels import groupnorm

    x = torch.empty(2, 320, 8, 8, device="cuda", dtype=torch.bfloat16)
    w = torch.ones(320, device="cuda")
    groupnorm.card_plan(tuple(x.shape), x.dtype, 32)

    def device_context():
        with torch.cuda.device(x.device):
            pass

    steps = {
        "with torch.cuda.device(x.device)": device_context,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch.cuda.current_stream(x.device).cuda_stream":
            lambda: torch.cuda.current_stream(x.device).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(i)":
            lambda: torch._C._cuda_getCurrentRawStream(x.device.index),
        "torch.empty_like(x)": lambda: torch.empty_like(x),
        "card_plan lookup": lambda: groupnorm.card_plan(
            tuple(x.shape), x.dtype, 32),
        "group_norm_silu_kernel": lambda: groupnorm.group_norm_silu_kernel(
            x, w, w, 32, 1e-5, True),
    }
    msgs = []
    for name, fn in steps.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20000):
            fn()
        msgs.append(f"{name} {(time.perf_counter() - t0) / 20000 * 1e6:.2f}")
    torch.cuda.synchronize()
    log("K4 wrapper host cost, us a call (host clock): " + "; ".join(msgs))


_PREPASS_SEEN = set()


def conv_rows(gen, keys, path="serve"):
    """K7 (the pre-pass plus the conv kernel, as the wrapper runs them; the
    weight's pack is made once, at the first call, and is in no time here)
    against ``conv3x3_ref`` (f32 cuDNN conv, TF32 off), and the pre-pass
    alone against its plain version, at launch keys ``(N, C, Co, H, W)``
    (bf16) or ``(N, C, Co, H, W, dtype)``.  The library yardsticks are
    ``F.conv2d`` in x's dtype on a weight and bias cast beforehand (TF32
    off), and ``x.contiguous(memory_format=torch.channels_last)`` for the
    pre-pass.  ``ms`` is device time (CUDA graph): the small shapes take
    less than the host's launch cost, which ``eager_ms`` includes.  The
    bound counts the pack the kernel reads (bf16 or f32), not the f32
    weight; a float32 row's the f32 rate."""
    import torch
    import torch.nn.functional as F
    from fgdm_tpu_torch.kernels import conv

    rows = []
    for key in keys:
        n, c, co, h, w = key[:5]
        dtype = key[5] if len(key) > 5 else "bfloat16"
        f32 = dtype == "float32"
        dt = getattr(torch, dtype)
        label = f"conv3x3{' f32' if f32 else ''} [{n},{c},{h},{w}]->{co}"
        x = torch.randn(n, c, h, w, device="cuda", generator=gen, dtype=dt)
        wt = torch.randn(co, c, 3, 3, device="cuda", generator=gen) \
            * (9 * c) ** -0.5
        b = 0.1 * torch.randn(co, device="cuda", generator=gen)
        out = conv.conv3x3_kernel(x, wt, b)
        ref = conv.conv3x3_ref(x, wt, b)
        same = torch.equal(out, conv.conv3x3_kernel(x, wt, b))
        tol = CONV_F32_TOL if f32 else CONV_TOL
        err = (out.float() - ref.float()).abs().max().item()
        lim = tol[0] * ref.float().abs().max().item() + tol[1]
        ok = math.isfinite(err) and err <= lim and same and out.dtype == dt
        reps = 10 if h >= 512 or f32 else 30
        ms = graph_ms(lambda: conv.conv3x3_kernel(x, wt, b), reps)
        eager_ms = cuda_ms(lambda: conv.conv3x3_kernel(x, wt, b), reps)
        plain_ms = graph_ms(lambda: conv.conv3x3_ref(x, wt, b), reps)
        wb, bb = wt.to(dt), b.to(dt)
        lib_ms = graph_ms(lambda: F.conv2d(x, wb, bb, 1, 1), reps)
        size = x.element_size()
        nbytes = (size * n * h * w * (c + co) + size * co * 9.0 * c
                  + 4.0 * co)
        flops = 2.0 * n * h * w * 9 * c * co
        bound_ms, bound_by, term = bound(
            flops, nbytes, PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS)
        plan = conv.conv3x3_plan(n, c, co, h, w, dt)
        rows.append(dict(
            name=label, route="cuda", source=CONV_F32_SRC if f32 else
            CONV_SRC, replaces=K7, dtype=dtype,
            key=("conv", n, c, co, h, w, dtype), path=path,
            max_abs_err=err, tol=lim, ok=ok, ms=ms, eager_ms=eager_ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            bound_term=term, library_ms=lib_ms))
        log(f"{label}: max|d|={err:.3e} (tol {lim:.3e}), rerun bit-identical "
            f"{same} {'OK' if ok else 'FAIL'}  kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.0f} TF/s; eager {eager_ms:.4f} ms; tile "
            f"{plan.th}x{plan.tw} of {plan.bm}, {plan.grid[0] * plan.grid[1]}"
            f" blocks)  plain {plain_ms:.4f} ms  F.conv2d {dtype} "
            f"{lib_ms:.4f} ms  bound {bound_ms:.4f} ms ({term})")
        if (n, c, h, w, dtype) in _PREPASS_SEEN:   # one row per input shape
            continue
        _PREPASS_SEEN.add((n, c, h, w, dtype))
        xt = conv.nchw_to_nhwc(x)
        pre_ok = torch.equal(xt, conv.nchw_to_nhwc_ref(x))
        pre_ms = graph_ms(lambda: conv.nchw_to_nhwc(x), reps)
        pre_eager = cuda_ms(lambda: conv.nchw_to_nhwc(x), reps)
        pre_plain = graph_ms(lambda: conv.nchw_to_nhwc_ref(x), reps)
        pre_lib = graph_ms(lambda: x.contiguous(
            memory_format=torch.channels_last), reps)
        pre_bound, pre_by, pre_term = bound(0.0, 2.0 * size * x.numel(),
                                            PEAK_BF16_FLOPS)
        pre_label = (f"nchw_to_nhwc{' f32' if f32 else ''} "
                     f"[{n},{c},{h},{w}]")
        rows.append(dict(
            name=pre_label, route="cuda",
            source=CONV_F32_SRC if f32 else CONV_SRC, replaces=K7,
            dtype=dtype, key=("prepass", n, c, h, w, dtype),
            path=path, max_abs_err=0.0 if pre_ok else float("inf"), tol=0.0,
            ok=pre_ok, ms=pre_ms, eager_ms=pre_eager, plain_ms=pre_plain,
            bound_ms=pre_bound, bound_by=pre_by, bound_term=pre_term,
            library_ms=pre_lib))
        log(f"{pre_label}: {'==' if pre_ok else '!='} "
            f"plain {'OK' if pre_ok else 'FAIL'}  kernel {pre_ms:.4f} ms "
            f"(eager {pre_eager:.4f} ms)  plain {pre_plain:.4f} ms  "
            f"channels_last copy {pre_lib:.4f} ms  bound {pre_bound:.4f} ms "
            f"({pre_by})")
    return rows


def conv_grad_check(gen):
    """``Conv3x3`` at [8, 320, 32, 32]: the kernel forward and the plain
    backward against autograd through ``conv3x3_ref``."""
    import torch
    from fgdm_tpu_torch.kernels import conv

    x = torch.randn(8, 320, 32, 32, device="cuda", generator=gen,
                    dtype=torch.bfloat16).requires_grad_()
    wt = (torch.randn(320, 320, 3, 3, device="cuda", generator=gen)
          * (9 * 320) ** -0.5).requires_grad_()
    b = (0.1 * torch.randn(320, device="cuda", generator=gen)
         ).requires_grad_()
    g = torch.randn(8, 320, 32, 32, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    y = conv.conv3x3(x, wt, b)
    got = torch.autograd.grad(y, (x, wt, b), g)
    y_ref = conv.conv3x3_ref(x, wt, b)
    refs = torch.autograd.grad(y_ref, (x, wt, b), g)
    ok = type(y.grad_fn).__name__ == "Conv3x3Backward"
    msgs = []
    for name, a, r in zip(("y", "dx", "dw", "db"), (y,) + got,
                          (y_ref,) + refs):
        err = (a.float() - r.float()).abs().max().item()
        lim = CONV_TOL[0] * r.float().abs().max().item() + CONV_TOL[1]
        ok = ok and math.isfinite(err) and err <= lim
        msgs.append(f"{name} max|d|={err:.3e} (tol {lim:.3e})")
    log(f"Conv3x3 gradient [8,320,32,32] vs autograd through the plain conv:"
        f" {', '.join(msgs)}; {'OK' if ok else 'FAIL'}")
    return ok


def phase_kernels():
    """Each kernel against its plain version at the paths' shapes."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = (attn_rows(gen) + combine_rows(gen) + bwd_rows(gen)
            + gn_rows(gen) + conv_rows(gen, CONV_CASES)
            + conv_rows(gen, RAGGED_CONV_CASES, path=None)
            + conv_rows(gen, CONV_F32_CASES, path="precision_full")
            + conv_rows(gen, RAGGED_CONV_F32_CASES, path=None))
    grad_ok = conv_grad_check(gen)
    torch.cuda.empty_cache()
    return rows, grad_ok


@contextlib.contextmanager
def plain_path():
    """Route every gate to the plain versions (for the on/off comparison);
    convs the conv flags send to K7 take ``conv3x3_ref``."""
    from fgdm_tpu_torch.kernels import attention, conv, groupnorm

    saved = attention.use_flash, groupnorm.use_fused_gn, conv.conv3x3
    attention.use_flash = lambda *a, **k: False
    groupnorm.use_fused_gn = lambda *a, **k: False
    conv.conv3x3 = conv.conv3x3_ref
    try:
        yield
    finally:
        attention.use_flash, groupnorm.use_fused_gn, conv.conv3x3 = saved


@contextlib.contextmanager
def conv_flags():
    """Both conv-kernel flags on (``FGDM_PALLAS_CONV``/``_VAE``)."""
    from fgdm_tpu_torch.nn import layers

    saved = layers._PALLAS_CONV, layers._PALLAS_CONV_VAE
    layers._PALLAS_CONV = layers._PALLAS_CONV_VAE = True
    try:
        yield
    finally:
        layers._PALLAS_CONV, layers._PALLAS_CONV_VAE = saved


def _counters():
    from fgdm_tpu_torch.kernels import attention, conv, groupnorm

    return {"attn": attention.flash_attention.launches,
            "combine": attention.flash_combine.launches,
            "prepass": conv.nchw_to_nhwc.launches,
            "flash_attn_bwd_dq": attention.flash_attention_bwd_dq.launches,
            "flash_attn_bwd_dkv": attention.flash_attention_bwd_dkv.launches,
            "gn": groupnorm.group_norm_silu_kernel.launches,
            "conv": conv.conv3x3_kernel.launches}


def reset_counts():
    for c in _counters().values():
        c.clear()


def read_counts():
    """{kind: {key: launches}} since the last ``reset_counts``."""
    return {kind: dict(c) for kind, c in _counters().items()}


def log_counts(path, counts):
    for kind, c in counts.items():
        log(f"{path} {kind} launches by key: "
            + json.dumps({str(k): v for k, v in sorted(c.items())}))


def phase_unet():
    """One full-width factor-1 UNet forward, kernels on vs plain."""
    import torch
    from fgdm_tpu_torch.builders import build_unet

    unet = build_unet(device="cuda", use_adapter=True, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(2, 4, 32, 32, device="cuda", generator=gen)
    t = torch.tensor([981, 981], device="cuda")
    ctx = torch.randn(2, 77, 768, device="cuda", generator=gen)
    with torch.inference_mode():
        reset_counts()
        on = unet(x, t, context=ctx)
        torch.cuda.synchronize()
        from fgdm_tpu_torch.kernels import attention, groupnorm

        n_attn = sum(attention.flash_attention.launches.values())
        n_gn = sum(groupnorm.group_norm_silu_kernel.launches.values())
        with plain_path():
            off = unet(x, t, context=ctx)
        torch.cuda.synchronize()
    rel = ((on - off).abs().max() / off.abs().max()).item()
    ok = (math.isfinite(rel) and rel <= UNET_TOL and n_attn > 0 and n_gn > 0
          and bool(torch.isfinite(on).all()))
    log(f"UNet f1 forward [2,4,32,32]: kernels on vs plain max|d|/max|ref| = "
        f"{rel:.3e} (tol {UNET_TOL}); flash launches {n_attn}, groupnorm "
        f"launches {n_gn}; {'OK' if ok else 'FAIL'}")
    del unet
    torch.cuda.empty_cache()
    return ok


def phase_chain():
    """The full-width chain at batch 1, 50 + 20 steps.  The first run is the
    main path's run: every launch count is set to 0 just before it and read
    just after.  A second run on the same inputs gives the warm wall time
    and must reproduce the first."""
    import torch
    from fgdm_tpu_torch.builders import build_chain
    from fgdm_tpu_torch.sampling.chain import fgdm_chain

    t0 = time.perf_counter()
    ld, cldm = build_chain(device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"built the chain's models in {time.perf_counter() - t0:.1f}s")
    gen = torch.Generator(device="cuda").manual_seed(3)
    ctxs = [torch.randn(1, 77, 768, device="cuda", generator=gen)
            for _ in range(4)]

    def run():
        t0 = time.perf_counter()
        out = fgdm_chain(ld, cldm, *ctxs, f1_steps=50, f2_steps=20,
                         slot_seeds=[1234])
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    reset_counts()
    out, cold = run()
    counts = read_counts()
    torch.cuda.reset_peak_memory_stats()
    again, warm = run()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    img = out["image"].float()
    finite = bool(torch.isfinite(img).all())
    std = img.std().item()
    repeat = (again["image"].float() - img).abs().max().item()
    ok = (finite and std > 1e-4
          and tuple(img.shape) == (1, 3, 512, 512)
          and tuple(out["condition"].shape) == (1, 3, 256, 256))
    log(f"chain: image {tuple(img.shape)} finite={finite} std={std:.4e} "
        f"mean={img.mean().item():.4e} rerun max|d|={repeat:.3e}; wall "
        f"{cold:.3f}s first run (kernel compiles included), {warm:.3f}s "
        f"second run (host clock); peak memory {peak_gib:.2f} GiB; "
        f"{'OK' if ok else 'FAIL'}")
    log_counts("chain", counts)
    profile("chain", run, warm)
    return ok, counts, ld, cldm


def phase_conv_forwards(cldm):
    """With the conv flags on: one factor-2 UNet + ControlNet forward at
    [8, 4, 64, 64] (the served batch with CFG) and one 512^2 VAE decode at
    batch 1, kernels on vs plain."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4)
    ok = True
    with torch.inference_mode(), conv_flags():
        x = torch.randn(8, 4, 64, 64, device="cuda", generator=gen)
        t = torch.full((8,), 981, device="cuda")
        ctx = torch.randn(8, 77, 768, device="cuda", generator=gen)
        hint = torch.rand(8, 3, 512, 512, device="cuda", generator=gen)
        z = torch.randn(1, 4, 64, 64, device="cuda", generator=gen)
        cond = {"c_crossattn": ctx, "c_hint_emb": cldm.encode_hint(hint)}
        for label, fn in (
                ("f2 UNet + ControlNet forward [8,4,64,64]",
                 lambda: cldm.apply_model(x, t, cond)),
                ("VAE decode [1,4,64,64] -> 512^2",
                 lambda: cldm.decode_first_stage(z))):
            reset_counts()
            on = fn()
            torch.cuda.synchronize()
            counts = read_counts()
            with plain_path():
                off = fn()
            torch.cuda.synchronize()
            rel = ((on.float() - off.float()).abs().max()
                   / off.float().abs().max()).item()
            n = {k: sum(c.values()) for k, c in counts.items()}
            good = (math.isfinite(rel) and rel <= UNET_TOL and n["conv"] > 0
                    and bool(torch.isfinite(on).all()))
            ok = ok and good
            log(f"{label}, conv flags on: kernels on vs plain max|d|/max|ref|"
                f" = {rel:.3e} (tol {UNET_TOL}); launches conv {n['conv']} "
                f"attn {n['attn']} gn {n['gn']}; {'OK' if good else 'FAIL'}")
    del cond, on, off
    torch.cuda.empty_cache()
    return ok


# run_inference.sh's flags (its prompt aside), through the port's CLI
CLI_FLAGS = ["--config", "models/config.yaml", "--ddim_eta", "0.0",
             "--n_samples", "5", "--n_iter", "1", "--scale", "7.5",
             "--ddim_steps", "50", "--H", "256", "--W", "256", "--C", "4",
             "--use_controlnet"]
CLI_BATCH = 5
# the guided path: the factor-1 stage of run_inference.sh's flow with the
# reference's attention-alignment guidance
GUIDED_FLAGS = [f for f in CLI_FLAGS if f != "--use_controlnet"] + [
    "--inference_loss"]
# the N-factor chain of tools/bench_chain_n.py (its default batch of 2)
CHAIN_N_FACTORS = ("seg", "depth", "normal")
CHAIN_N_BATCH = 2
DISTILL_CADENCE = 10   # steps of the distillation cadence timed
# three of the keys the reference's EMA writes beside the weights; the
# loader drops them (ignore_keys)
EMA_KEYS = ("model_ema.decay", "model_ema.num_updates",
            "model_ema.diffusion_modelout2bias")


@contextlib.contextmanager
def hash_tokenizer_allowed():
    """``FGDM_ALLOW_HASH_TOKENIZER=1``: the entry points load checkpoints
    with the hash-fallback tokenizer (no CLIP vocabulary in the repo)."""
    saved = os.environ.get("FGDM_ALLOW_HASH_TOKENIZER")
    os.environ["FGDM_ALLOW_HASH_TOKENIZER"] = "1"
    try:
        yield
    finally:
        if saved is None:
            del os.environ["FGDM_ALLOW_HASH_TOKENIZER"]
        else:
            os.environ["FGDM_ALLOW_HASH_TOKENIZER"] = saved


def write_checkpoints(ld, cldm, root):
    """The chain's seeded weights as the reference's two checkpoints, each
    a ``{"state_dict": ...}`` of CPU tensors: the factor-1 file (UNet with
    the adapter, VAE, CLIP and three ``model_ema.*`` keys) and the control
    file (UNet without adapter, ControlNet, VAE, the second CLIP).
    Returns ``{name: path}``, the bytes written and the seconds taken."""
    import torch
    from fgdm_tpu_torch.checkpoint import torch_ingest as ti

    files = {"f1": (os.path.join(root, "fgdm_seg.pth"),
                    ((ti.UNET_PREFIX, ld.unet), (ti.VAE_PREFIX, ld.vae),
                     (ti.CLIP_PREFIX, ld.clip))),
             "cn": (os.path.join(root, "fgdm_control_sd15_seg.pth"),
                    ((ti.UNET_PREFIX, cldm.unet),
                     (ti.CONTROL_PREFIX, cldm.control),
                     (ti.VAE_PREFIX, cldm.vae), (ti.CLIP_PREFIX, cldm.clip)))}
    t0 = time.perf_counter()
    nbytes, paths = 0, {}
    for name, (path, parts) in files.items():
        sd = {prefix + k: v.detach().cpu() for prefix, module in parts
              for k, v in module.state_dict().items()}
        if name == "f1":
            sd[EMA_KEYS[0]] = torch.tensor(0.9999)
            sd[EMA_KEYS[1]] = torch.tensor(1000, dtype=torch.int32)
            sd[EMA_KEYS[2]] = sd[ti.UNET_PREFIX + "out.2.bias"].clone()
        torch.save({"state_dict": sd}, path)
        del sd
        nbytes += os.path.getsize(path)
        paths[name] = path
    return paths, nbytes, time.perf_counter() - t0


def same_weights(pairs):
    """``[(label, loaded module, source module)]`` -> the labels whose
    state dicts differ in a key or in any bit of a tensor."""
    import torch

    bad = []
    for label, got, ref in pairs:
        a, b = got.state_dict(), ref.state_dict()
        if set(a) != set(b) or not all(torch.equal(a[k], b[k]) for k in a):
            bad.append(label)
    return bad


def clean_report(report, parts):
    """Zero missing keys in each of ``parts`` and zero unexpected keys."""
    return (not report["unexpected"]
            and all(report["missing"][p] == [] for p in parts))


def phase_checkpoints(ld, cldm, root):
    """Write the chain's weights as reference-schema ``.pth`` files, then
    load them on the card through ``load_fgdm`` and ``load_controlnet``
    (once on its own, once sharing the factor-1 VAE and CLIP) and hold
    every loaded tensor bit-equal to its source.  No more than two copies
    of a model are on the card at once.  Returns the paths and the loaded
    pipelines (factor 1, and the control stage sharing its first stage)."""
    import torch
    from fgdm_tpu_torch.checkpoint.loader import load_controlnet, load_fgdm

    paths, written, secs = write_checkpoints(ld, cldm, root)
    log(f"checkpoints: wrote {written / 2 ** 30:.2f} GiB ({written} bytes) "
        f"in {secs:.1f}s: " + ", ".join(
            f"{os.path.basename(p)} {os.path.getsize(p)}"
            for p in paths.values()))
    read, times = 0, {}

    def load(label, fn, *a, **kw):
        nonlocal read
        t0 = time.perf_counter()
        out = fn(*a, device="cuda", **kw)
        torch.cuda.synchronize()
        times[label] = time.perf_counter() - t0
        read += os.path.getsize(a[0])
        return out

    ld2 = load("load_fgdm", load_fgdm, paths["f1"])
    cn_full = load("load_controlnet", load_controlnet, paths["cn"])
    bad = same_weights([("f1 unet", ld2.unet, ld.unet),
                        ("f1 vae", ld2.vae, ld.vae),
                        ("f1 clip", ld2.clip, ld.clip),
                        ("cn unet", cn_full.unet, cldm.unet),
                        ("cn control", cn_full.control, cldm.control),
                        ("cn vae", cn_full.vae, cldm.vae),
                        ("cn clip", cn_full.clip, cldm.clip)])
    reports = [ld2.load_report, cn_full.load_report]
    ok = (clean_report(ld2.load_report, ("unet", "vae", "clip"))
          and clean_report(cn_full.load_report,
                           ("unet", "control", "vae", "clip")))
    del cn_full
    torch.cuda.empty_cache()
    cldm2 = load("load_controlnet(share_first_stage)", load_controlnet,
                 paths["cn"], share_first_stage=ld2)
    bad += same_weights([("shared cn unet", cldm2.unet, cldm.unet),
                         ("shared cn control", cldm2.control,
                          cldm.control)])
    shared = cldm2.vae is ld2.vae and cldm2.clip is ld2.clip
    ok = (ok and not bad and shared
          and clean_report(cldm2.load_report, ("unet", "control")))
    reports.append(cldm2.load_report)
    log("checkpoints: loaded on the card: " + ", ".join(
        f"{k} {v:.2f}s" for k, v in times.items())
        + f"; read {read / 2 ** 30:.2f} GiB ({read} bytes); missing "
        + "; ".join(" ".join(f"{p}={len(m)}" for p, m in r["missing"].items())
                    for r in reports)
        + f"; unexpected {[len(r['unexpected']) for r in reports]} (the "
        f"{len(EMA_KEYS)} model_ema.* keys dropped by ignore_keys); tensors "
        f"not bit-equal to their source: {bad or 'none'}; control stage "
        f"shares the factor-1 VAE and CLIP objects: {shared}; "
        f"{'OK' if ok else 'FAIL'}")
    return ok, paths, ld2, cldm2


def phase_cli(paths, outdir):
    """``python -m fgdm_tpu_torch.cli.txt2img_fgdm`` with run_inference.sh's
    flags on the two checkpoints, conv flags on: the CLI path's counted run.
    Checks 5 condition maps (256^2) and 5 images (512^2) as valid PNGs."""
    import torch
    from fgdm_tpu_torch.cli import txt2img_fgdm

    argv = CLI_FLAGS + ["--prompt", PROMPT_CLI, "--ckpt", paths["f1"],
                        "--cn_ckpt", paths["cn"], "--outdir", outdir]
    log("cli: python -m fgdm_tpu_torch.cli.txt2img_fgdm " + " ".join(argv))
    torch.cuda.reset_peak_memory_stats()
    with conv_flags(), hash_tokenizer_allowed():
        reset_counts()
        t0 = time.perf_counter()
        out = txt2img_fgdm.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    maps = sorted(p for p in out["files"] if "sample1" + os.sep in p)
    images = sorted(p for p in out["files"] if "seg_images" + os.sep in p)
    shapes = {}
    for p in maps + images:
        with open(p, "rb") as f:
            shapes[p] = png_rgb(f.read())[:2]
    ok = (len(maps) == len(images) == CLI_BATCH
          and len(out["files"]) == 2 * CLI_BATCH
          and all(shapes[p] == (256, 256) for p in maps)
          and all(shapes[p] == (512, 512) for p in images))
    f1, f2 = out["factor1_s"][0], out["factor2_s"][0]
    log(f"cli: {len(maps)} maps {sorted(set(shapes[p] for p in maps))}, "
        f"{len(images)} images {sorted(set(shapes[p] for p in images))}; "
        f"load {out['load_s']:.2f}s, [factor1] {f1:.2f}s, [factor2] "
        f"{f2:.2f}s ({CLI_BATCH / (f1 + f2):.3f} images/s over both "
        f"factors, first run: no warmup), main() {wall:.2f}s; peak memory "
        f"{peak_gib:.2f} GiB; {'OK' if ok else 'FAIL'}")
    log_counts("cli", counts)
    return ok, counts, maps, f1


def phase_precision_full(paths, outdir):
    """``--precision full`` on the card.  ``cli.txt2img_fgdm`` with
    run_inference.sh's flags plus ``--precision full`` on the two
    checkpoints, both conv flags on, every launch count set to 0 just before
    and read just after (the path's counted run): 5 condition maps (256^2)
    and 5 images (512^2) as valid PNGs, and K1 at d 40 and 80, K2, K3, the
    combine pass, K7 and its pre-pass launched in float32.  Then, on the
    chain's models built in float32, one factor-2 UNet + ControlNet forward
    at [2, 4, 64, 64] (UNET_F32_TOL) and the whole chain at batch 1 (50 + 20
    steps, the same x_T from the slot seed; CHAIN_F32_TOL on the image
    before uint8), conv flags on, kernels on vs ``plain_path()``."""
    import torch
    from fgdm_tpu_torch.builders import build_chain
    from fgdm_tpu_torch.cli import txt2img_fgdm
    from fgdm_tpu_torch.sampling.chain import fgdm_chain

    argv = CLI_FLAGS + ["--precision", "full", "--prompt", PROMPT_CLI,
                        "--ckpt", paths["f1"], "--cn_ckpt", paths["cn"],
                        "--outdir", outdir]
    log("precision_full: python -m fgdm_tpu_torch.cli.txt2img_fgdm "
        + " ".join(argv))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with conv_flags(), hash_tokenizer_allowed():
        reset_counts()
        t0 = time.perf_counter()
        out = txt2img_fgdm.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    maps = sorted(p for p in out["files"] if "sample1" + os.sep in p)
    images = sorted(p for p in out["files"] if "seg_images" + os.sep in p)
    shapes = {}
    for p in maps + images:
        with open(p, "rb") as f:
            shapes[p] = png_rgb(f.read())[:2]
    files_ok = (len(maps) == len(images) == CLI_BATCH
                and len(out["files"]) == 2 * CLI_BATCH
                and all(shapes[p] == (256, 256) for p in maps)
                and all(shapes[p] == (512, 512) for p in images))
    f32 = {kind: {k: v for k, v in c.items() if k[-1] == "float32"}
           for kind, c in counts.items()
           if kind in ("attn", "combine", "conv", "prepass")}
    n_bf16 = sum(v for kind in f32 for k, v in counts[kind].items()
                 if k[-1] != "float32")
    launched = {
        "K1 d40": any(k[4] == 40 for k in f32["attn"]),
        "K1 d80": any(k[4] == 80 for k in f32["attn"]),
        "K2": any(attn_kernel(k[4], k[3]) == K2 for k in f32["attn"]),
        "K3": any(attn_kernel(k[4], k[3]) == K3 for k in f32["attn"]),
        "combine": sum(f32["combine"].values()) > 0,
        "K7": sum(f32["conv"].values()) > 0,
        "pre-pass": sum(f32["prepass"].values()) > 0}
    f1, f2 = out["factor1_s"][0], out["factor2_s"][0]
    ok = files_ok and all(launched.values())
    log(f"precision_full: {len(maps)} maps "
        f"{sorted(set(shapes[p] for p in maps))}, {len(images)} images "
        f"{sorted(set(shapes[p] for p in images))}; load "
        f"{out['load_s']:.2f}s, [factor1] {f1:.2f}s, [factor2] {f2:.2f}s "
        f"({CLI_BATCH / (f1 + f2):.3f} images/s over both factors, first "
        f"run), main() {wall:.2f}s; peak memory {peak_gib:.2f} GiB; float32 "
        "launches " + ", ".join(f"{k} {v}" for k, v in launched.items())
        + f"; bf16 launches of K1-K3, K7 {n_bf16}; "
        f"{'OK' if ok else 'FAIL'}")
    log_counts("precision_full", counts)
    del out
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ld, cldm = build_chain(device="cuda", dtype=torch.float32, seed=0)
    torch.cuda.synchronize()
    log(f"precision_full: built the chain's models in float32 in "
        f"{time.perf_counter() - t0:.1f}s")
    gen = torch.Generator(device="cuda").manual_seed(21)
    with torch.inference_mode(), conv_flags():
        x = torch.randn(2, 4, 64, 64, device="cuda", generator=gen)
        t = torch.full((2,), 981, device="cuda")
        ctx = torch.randn(2, 77, 768, device="cuda", generator=gen)
        hint = torch.rand(2, 3, 512, 512, device="cuda", generator=gen)
        cond = {"c_crossattn": ctx, "c_hint_emb": cldm.encode_hint(hint)}
        on = cldm.apply_model(x, t, cond)
        with plain_path():
            off = cldm.apply_model(x, t, cond)
        torch.cuda.synchronize()
    rel = ((on - off).abs().max() / off.abs().max()).item()
    good = (on.dtype == torch.float32 and math.isfinite(rel)
            and rel <= UNET_F32_TOL)
    ok = ok and good
    log(f"precision_full: f2 UNet + ControlNet forward [2,4,64,64] float32, "
        f"conv flags on: kernels on vs plain max|d|/max|ref| = {rel:.3e} "
        f"(tol {UNET_F32_TOL}); {'OK' if good else 'FAIL'}")
    del cond, on, off
    ctxs = [torch.randn(1, 77, 768, device="cuda", generator=gen)
            for _ in range(4)]
    runs = {}
    with conv_flags():
        for label in ("kernels", "plain"):
            with plain_path() if label == "plain" else contextlib.nullcontext():
                t0 = time.perf_counter()
                res = fgdm_chain(ld, cldm, *ctxs, f1_steps=50, f2_steps=20,
                                 slot_seeds=[1234])
                torch.cuda.synchronize()
                runs[label] = (res, time.perf_counter() - t0)
    img, ref = runs["kernels"][0]["image"], runs["plain"][0]["image"]
    rel = ((img - ref).abs().max() / ref.abs().max()).item()
    cond_rel = ((runs["kernels"][0]["condition"] - runs["plain"][0][
        "condition"]).abs().max()).item()
    good = (img.dtype == torch.float32 and tuple(img.shape) == (1, 3, 512, 512)
            and bool(torch.isfinite(img).all()) and math.isfinite(rel)
            and rel <= CHAIN_F32_TOL)
    ok = ok and good
    log(f"precision_full: float32 chain at batch 1 (50 + 20 steps), conv "
        f"flags on: image {tuple(img.shape)} kernels on vs plain "
        f"max|d|/max|ref| = {rel:.3e} (tol {CHAIN_F32_TOL}), condition "
        f"max|d| {cond_rel:.3e}; wall {runs['kernels'][1]:.2f}s with the "
        f"kernels, {runs['plain'][1]:.2f}s plain (first runs, host clock); "
        f"{'OK' if good else 'FAIL'}")
    del ld, cldm, runs, img, ref
    gc.collect()
    torch.cuda.empty_cache()
    return ok, counts


def phase_seg2image(ld, cldm, maps):
    """seg2image's compute on the card: ``sample_image_factor`` in guess
    mode at strength 0.8 on the CLI's five maps (NEAREST to 512^2, 20 DDIM
    steps, CFG 9.0), conv flags on, with the counts reset just before; then
    guess mode's two ``apply_model`` forwards kernels on vs plain at
    [5, 4, 64, 64]."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F
    from fgdm_tpu_torch.models.clip import CLIPTokenizer
    from fgdm_tpu_torch.models.controlnet import guess_mode_scales
    from fgdm_tpu_torch.sampling.chain import (A_PROMPT, N_PROMPT,
                                               sample_image_factor)

    arrs = []
    for p in maps:
        with open(p, "rb") as f:
            arrs.append(png_rgb(f.read())[2])
    hint = torch.from_numpy(np.stack(arrs)).permute(0, 3, 1, 2).float()
    hint = F.interpolate(hint.cuda() / 255.0, size=(512, 512),
                         mode="nearest")
    tok = CLIPTokenizer()
    n = len(maps)
    with torch.inference_mode():
        ctx = cldm.get_learned_conditioning(
            tok([PROMPT_CLI + ", " + A_PROMPT] * n).cuda())
        uc = cldm.get_learned_conditioning(tok([N_PROMPT] * n).cuda())
    gen = torch.Generator(device="cuda").manual_seed(7)
    with conv_flags():
        reset_counts()
        t0 = time.perf_counter()
        z = sample_image_factor(cldm, hint, ctx, uc, num_steps=20,
                                cfg_scale=9.0, strength=0.8,
                                guess_mode=True, generator=gen)
        with torch.inference_mode():
            img = cldm.decode_first_stage(z).float()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        g = dataclasses.replace(cldm, control_scales=guess_mode_scales(0.8))
        x = torch.randn(n, 4, 64, 64, device="cuda", generator=gen)
        t = torch.full((n,), 981, device="cuda")

        def forwards():
            """Guess mode's two ``apply_model`` forwards: the prompt with
            the control residuals at the geometric scales, and the negative
            prompt with none."""
            with torch.inference_mode():
                emb = g.encode_hint(hint)
                return (g.apply_model(x, t, {"c_crossattn": ctx,
                                             "c_hint_emb": emb}).float(),
                        g.apply_model(x, t, {"c_crossattn": uc}).float())

        on = forwards()
        with plain_path():
            off = forwards()
    rels = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(on, off)]
    finite = bool(torch.isfinite(img).all())
    ok = (finite and tuple(img.shape) == (n, 3, 512, 512)
          and img.std().item() > 1e-4
          and all(math.isfinite(r) and r <= UNET_TOL for r in rels))
    log(f"seg2image: guess mode, strength 0.8, {n} maps at 512^2, 20 DDIM "
        f"steps: images {tuple(img.shape)} finite={finite} std="
        f"{img.std().item():.4e}, {secs:.2f}s ({n / secs:.3f} images/s); "
        f"guess-mode forwards [{n},4,64,64] kernels on vs plain "
        f"max|d|/max|ref| = {rels[0]:.3e} (with the control residuals), "
        f"{rels[1]:.3e} (without) (tol {UNET_TOL}); "
        f"{'OK' if ok else 'FAIL'}")
    log_counts("seg2image", counts)
    return ok, counts


def png_rgb(data: bytes):
    """``(height, width, pixels)`` of an 8-bit RGB PNG whose rows all use
    filter 0, as ``server.png_bytes`` writes them; checks every CRC."""
    import numpy as np

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != (
                zlib.crc32(tag + body) & 0xFFFFFFFF):
            raise ValueError(f"bad CRC in {tag!r}")
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = ihdr[:4]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    if depth != 8 or ctype != 2 or rows.shape[1] != 1 + 3 * w \
            or rows[:, 0].any():
        raise ValueError(f"unexpected PNG layout {ihdr}")
    return h, w, rows[:, 1:].reshape(h, w, 3)


def _http(port, path, payload=None):
    """``(status, body bytes, seconds)`` of one localhost request."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.read(), time.perf_counter() - t0


def phase_serve(paths):
    """The serving path, conv flags on, on the engine that
    ``server.py --ckpt/--cn_ckpt`` assembles (``server.build_engine``) from
    the two checkpoints.  The four coalesced requests are the path's counted
    run."""
    import torch
    from fgdm_tpu_torch import server
    from fgdm_tpu_torch.builders import PROMPTS

    prompts = PROMPTS[:SERVE_BATCH]
    with conv_flags():
        t0 = time.perf_counter()
        with hash_tokenizer_allowed():
            engine = server.build_engine(
                paths["f1"], paths["cn"], device="cuda",
                max_batch=SERVE_BATCH, f1_sampler="dpm", f1_steps=20)
        log(f"serve: server.build_engine(--ckpt, --cn_ckpt) loaded the two "
            f"checkpoints and warmed up in {time.perf_counter() - t0:.2f}s; "
            f"missing " + "; ".join(
                " ".join(f"{k}={len(v)}" for k, v in
                         p.load_report["missing"].items())
                for p in (engine.ld, engine.cldm))
            + f"; unexpected {len(engine.ld.load_report['unexpected'])}, "
            f"{len(engine.cldm.load_report['unexpected'])}")
        loaded = (clean_report(engine.ld.load_report, ("unet", "vae", "clip"))
                  and clean_report(engine.cldm.load_report,
                                   ("unet", "control", "vae", "clip")))
        log(f"serve: engine warmup (one full generate() of the preset "
            f"dpm-20 + ddim-20, batch {SERVE_BATCH}, 256^2 -> 512^2) "
            f"{engine.compile_seconds:.2f}s")
        ready = threading.Event()
        srv = threading.Thread(
            target=server.serve, args=(engine, "127.0.0.1", 0),
            kwargs=dict(max_requests=SERVE_BATCH + 3, batch_window_ms=500,
                        ready=ready), daemon=True)
        srv.start()
        if not ready.wait(60):
            raise RuntimeError("the server did not start")
        port = ready.server.server_address[1]
        responses, errors = {}, []

        def client(i):
            try:
                responses[i] = _http(port, "/generate", {
                    "prompts": [prompts[i]], "seed": SERVE_SEEDS[i]})
            except Exception as e:  # reported below
                errors.append(f"client {i}: {type(e).__name__}: {e}")

        from fgdm_tpu_torch.kernels import conv as kconv

        reset_counts()
        packs0 = kconv.packed_weight.packs
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(SERVE_BATCH)]
        for th in clients:
            th.start()
        for th in clients:
            th.join(timeout=600)
        counts = read_counts()
        packs = kconv.packed_weight.packs - packs0
        solo = _http(port, "/generate", {"prompts": [prompts[2]],
                                         "seed": SERVE_SEEDS[2]})
        health = json.loads(_http(port, "/healthz")[1])
        metrics = _http(port, "/metrics")[1].decode()
        srv.join(timeout=60)
        # serve() returned after its last request and closed its batcher;
        # the last handler thread may still be closing its socket
        deadline = time.perf_counter() + 5.0
        while True:
            left = [t.name for t in threading.enumerate()
                    if t is not threading.main_thread()]
            if not left or time.perf_counter() > deadline:
                break
            time.sleep(0.05)

        ok, pngs = not errors and len(responses) == SERVE_BATCH, {}
        for i, (status, body, secs) in sorted(responses.items()):
            body = json.loads(body)
            ok = ok and status == 200
            img = png_rgb(base64.b64decode(body["images"][0]))
            cnd = png_rgb(base64.b64decode(body["conditions"][0]))
            ok = ok and img[:2] == (512, 512) and cnd[:2] == (256, 256)
            pngs[i] = img[2]
            log(f"serve: request {i} (seed {SERVE_SEEDS[i]}) {status}, "
                f"client latency {secs:.3f}s, server latency_s "
                f"{body['latency_s']}, image {img[:2]}, condition {cnd[:2]}")
        solo_img = png_rgb(base64.b64decode(
            json.loads(solo[1])["images"][0]))[2]
        delta = (int(abs(solo_img.astype(int) - pngs[2].astype(int)).max())
                 if 2 in pngs else -1)
        vals = {ln.split()[0]: float(ln.split()[1])
                for ln in metrics.splitlines()
                if ln and not ln.startswith("#")}
        coalesced = vals.get("fgdm_engine_batches_total") == 2.0
        conv_keys = counts["conv"].keys()
        families = (any(16 <= k[3] <= 64 for k in conv_keys),
                    any(k[3] >= 512 for k in conv_keys))
        launched = all(sum(counts[k].values()) > 0
                       for k in ("attn", "combine", "gn", "conv", "prepass"))
        ok = (ok and loaded and solo[0] == 200 and delta == 0 and coalesced
              and all(families) and launched and packs == 0
              and health["status"] == "ok"
              and vals.get("fgdm_images_total") == SERVE_BATCH + 1
              and not left)
        log(f"serve: {SERVE_BATCH} concurrent requests -> engine batches "
            f"{vals.get('fgdm_engine_batches_total')} with the solo repeat "
            f"(coalesced into one: {coalesced}); solo vs coalesced slot max "
            f"uint8 |d| = {delta}; healthz {health}; K7 whole-plane / VAE "
            f"families launched {families}; conv weights packed during the "
            f"counted batch {packs} (of {len(kconv._PACKS)} kept from the "
            f"warmup); errors {errors}; threads left "
            f"after the server stopped {left}; {'OK' if ok else 'FAIL'}")
        log_counts("serve", counts)

        def run():
            engine.generate(prompts, seeds=list(SERVE_SEEDS))

        def timed():
            t0 = time.perf_counter()
            run()
            return time.perf_counter() - t0

        torch.cuda.reset_peak_memory_stats()
        timed()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    # The same batch with the conv flags on (K7) and off (cuDNN's convs),
    # turn about, since the host's clock drifts between minutes; the flags
    # are read at call time.  One untimed batch with the flags off first:
    # cuDNN meets these batch-8 shapes for the first time here.
    run()
    on, off = [], []
    for _ in range(SERVE_TIMED):
        with conv_flags():
            on.append(timed())
        off.append(timed())
    warm = sum(on) / len(on)
    log(f"serve: serving preset (dpm-20 + ddim-20, 512^2, conv kernels "
        f"on) {warm:.3f} s per engine batch of {SERVE_BATCH} (mean of "
        f"{SERVE_TIMED} {[round(t, 3) for t in on]}, host clock, generate() "
        f"returns host arrays), {SERVE_BATCH / warm:.3f} images/s at batch "
        f"{SERVE_BATCH}, {SERVE_BATCH / min(on):.3f} at best; peak memory "
        f"{peak_gib:.2f} GiB")
    cold = sum(off) / len(off)
    log(f"serve: the same batch with the conv flags off (F.conv2d), turn "
        f"about with the above: {cold:.3f} s per batch (mean of "
        f"{SERVE_TIMED} {[round(t, 3) for t in off]}), "
        f"{SERVE_BATCH / cold:.3f} images/s, {SERVE_BATCH / min(off):.3f} "
        f"at best")

    with conv_flags():
        reset_counts()
        one_launch = k4_match("serve", *profile("serve", run, warm))
    log(f"serve: one K4 launch a call {'OK' if one_launch else 'FAIL'}")
    profile("serve with the conv flags off", run, cold)
    return ok and one_launch, counts


def profile(path, run, warm_s):
    """Device time by kernel over one more run of ``run`` (``trace_run``),
    and the device's busy share: that kernel time over the unprofiled warm
    wall time.  Prints "not measured" if the trace holds no device time.
    Returns ({kernel name: (launches, us)}, the run's lost kernel records).
    Traces the device alone: the kernels' times are all it reads, and host
    op records slow the run."""
    t0 = time.perf_counter()
    by_name, lost = trace_run(run)
    log(f"{path}: kernel records the tracer lost: {lost[0]} of "
        f"{PAD_LAUNCHES[0]} in the first pad, {lost[1]} in the run, "
        f"{lost[2]} of {PAD_LAUNCHES[1]} in the last pad")
    total_ms = sum(t for _, t in by_name.values()) / 1e3
    log(f"{path}: traced in {time.perf_counter() - t0:.1f}s (host clock)")
    if total_ms == 0:
        log(f"{path} device time by kernel: not measured (no device events)")
        return by_name, lost[1]
    log(f"{path} device kernel time {total_ms:.1f} ms over a warm wall of "
        f"{1e3 * warm_s:.1f} ms: device busy share "
        f"{total_ms / (1e3 * warm_s):.3f}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    # the top 15, and every kernel of the port below them
    anon = "(anonymous namespace)::"
    ours = (anon + "flash_", anon + "conv3x3_", anon + "nchw_to_nhwc_",
            anon + "gn_silu_")
    for name, (n, t) in ranked[:15] + [
            kv for kv in ranked[15:] if any(o in kv[0] for o in ours)]:
        log(f"  {t / 1e3:9.2f} ms {100 * t / 1e3 / total_ms:5.1f}% "
            f"{n:6d}x  {name[:110]}")
    n_k4, t_k4 = k4_in_trace(by_name)
    log(f"{path}: K4 {t_k4 / 1e3:.2f} ms of device time in {n_k4} launches")
    return by_name, lost[1]


def k4_match(path, traced, lost):
    """Whether a trace holds one K4 kernel for each K4 call the wrapper
    counted since the last ``reset_counts``, and lost no kernel record of
    the run; logged."""
    from fgdm_tpu_torch.kernels import groupnorm

    calls = sum(groupnorm.group_norm_silu_kernel.launches.values())
    n_k4 = k4_in_trace(traced)[0]
    ok = lost == 0 and n_k4 == calls > 0
    log(f"{path}: K4 kernels in the profiled run's trace {n_k4}, K4 calls "
        f"counted by the wrapper in that run {calls}, kernel records of the "
        f"run lost by the tracer {lost}: one launch a call {ok}")
    return ok


def k4_in_trace(by_name):
    """(launches, us) of K4's kernels in a profile's {name: (n, us)}."""
    hits = [v for name, v in by_name.items() if "gn_silu_kernel" in name]
    return sum(n for n, _ in hits), sum(t for _, t in hits)


def adapter_grads(ld, state, batch, draws, distill=False):
    """Loss terms and adapter gradients of one forward/backward on injected
    t, noise and posterior eps (no optimizer step)."""
    import torch
    from fgdm_tpu_torch.diffusion.losses import diffusion_loss

    t, noise, eps = draws
    with torch.no_grad():
        x0 = ld.encode_first_stage(batch["image"], eps=eps)
        ctx = ld.get_learned_conditioning(batch["input_ids"])
    loss, parts = diffusion_loss(ld, x0, {"c_crossattn": ctx}, t=t,
                                 noise=noise, distill=distill)
    loss.backward()
    grads = {k: p.grad.float() for k, p in state.params.items()}
    for p in state.params.values():
        p.grad = None
    return {k: v.item() for k, v in parts.items()}, grads


def checksum(params):
    """One int64 per float32 tensor of ``params``: the sum of its bit
    patterns."""
    import torch

    return torch.stack([p.detach().view(torch.int32).sum(dtype=torch.int64)
                        for p in params])


def frozen_checksum(state):
    return checksum(state.frozen.values())


def phase_train():
    """The adapter-only training step at full width, batch 8, 256^2.  The
    cold step is the path's counted run."""
    import torch
    from fgdm_tpu_torch.builders import build_trainer

    t0 = time.perf_counter()
    tr = build_trainer(device="cuda", seed=0, batch=TRAIN_BATCH,
                       use_ema=True)
    ld, state, batch = tr.ld, tr.state, tr.batch
    torch.cuda.synchronize()
    n_train = sum(p.numel() for p in state.params.values())
    n_frozen = sum(p.numel() for p in state.frozen.values())
    log(f"built the trainer in {time.perf_counter() - t0:.1f}s: "
        f"{n_train} trainable (adapter) and {n_frozen} frozen UNet "
        f"parameters, batch {tuple(batch['image'].shape)}")
    gen = torch.Generator(device="cuda").manual_seed(7)
    adapter0 = {k: p.detach().clone() for k, p in state.params.items()}
    frozen0 = frozen_checksum(state)
    metrics = []

    def step():
        nonlocal state
        state, m = tr.train_step(state, batch, gen)
        metrics.append(m)

    reset_counts()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    counts = read_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(WARM_STEPS):
        step()
    torch.cuda.synchronize()
    warm = (time.perf_counter() - t0) / WARM_STEPS
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [m["loss"].item() for m in metrics]
    norms = [m["grad_norm"].item() for m in metrics]
    moved = max((p - adapter0[k]).abs().max().item()
                for k, p in state.params.items())
    frozen_same = torch.equal(frozen_checksum(state), frozen0)
    ok = (all(math.isfinite(x) for x in losses)
          and all(math.isfinite(x) and x > 0 for x in norms)
          and moved > 0 and frozen_same
          and state.ema.num_updates == state.step == 1 + WARM_STEPS)
    log(f"train: {1 + WARM_STEPS} steps, losses "
        f"{[round(x, 5) for x in losses]}, grad norms "
        f"{[round(x, 5) for x in norms]}; adapter max|moved|={moved:.3e}; "
        f"frozen bit-identical {frozen_same}; EMA updates "
        f"{state.ema.num_updates}; {'OK' if ok else 'FAIL'}")
    log(f"train: cold step {1e3 * cold:.1f} ms (kernel compiles included); "
        f"warm {1e3 * warm:.1f} ms/step over {WARM_STEPS} steps (host "
        f"clock), {TRAIN_BATCH / warm:.2f} images/s at batch {TRAIN_BATCH}; "
        f"peak memory {peak_gib:.2f} GiB")
    log_counts("train", counts)

    # kernels on vs plain, one loss and its adapter gradients
    b = batch["image"].shape[0]
    draws = (torch.randint(0, 1000, (b,), device="cuda", generator=gen),
             torch.randn(b, 4, 32, 32, device="cuda", generator=gen),
             torch.randn(b, 4, 32, 32, device="cuda", generator=gen))
    parts_on, g_on = adapter_grads(ld, state, batch, draws)
    with plain_path():
        parts_off, g_off = adapter_grads(ld, state, batch, draws)
    loss_on, loss_off = parts_on["loss"], parts_off["loss"]
    loss_rel = abs(loss_on - loss_off) / abs(loss_off)
    g_err = max((g_on[k] - g_off[k]).abs().max().item() for k in g_on)
    g_scale = max(g.abs().max().item() for g in g_off.values())
    cmp_ok = (math.isfinite(loss_rel) and loss_rel <= LOSS_TOL
              and g_scale > 0 and g_err / g_scale <= UNET_TOL)
    log(f"train kernels on vs plain: loss {loss_on:.6f} vs {loss_off:.6f} "
        f"(rel {loss_rel:.3e}, tol {LOSS_TOL}); adapter grads max|d|/max|ref|"
        f" = {g_err / max(g_scale, 1e-30):.3e} (tol {UNET_TOL}); "
        f"{'OK' if cmp_ok else 'FAIL'}")

    def run():
        step()
        torch.cuda.synchronize()

    reset_counts()
    k4_match("train", *profile("train", run, warm))
    return ok and cmp_ok, counts, tr


def phase_distill(tr):
    """The reference config's distillation step (``apply_distill_loss``,
    every ``distill_every_n_step`` = 10 steps) at full width, batch 8,
    256^2, on the training phase's trainer: one distill step with every
    launch count set to 0 just before (the path's counted run), then ten
    steps of the cadence (``Trainer.step_fn``: one distill step, nine
    plain), each timed to its synchronize.  Checks ``loss_distill``, the
    adapter and the frozen weights and the launches; compares one distill
    loss, its adapter gradients and the student's and teacher's maps
    kernels on vs plain on injected draws; profiles one distill step."""
    import torch
    from fgdm_tpu_torch.diffusion.losses import teacher_attention_maps
    from fgdm_tpu_torch.nn.attention import CaptureSpec
    from fgdm_tpu_torch.utils.attention_maps import get_token_maps

    ld, state, batch = tr.ld, tr.state, tr.batch
    gen = torch.Generator(device="cuda").manual_seed(8)
    adapter0 = {k: p.detach().clone() for k, p in state.params.items()}
    frozen0 = frozen_checksum(state)
    metrics = []

    def step(fn):
        t0 = time.perf_counter()
        _, m = fn(state, batch, gen)
        torch.cuda.synchronize()
        metrics.append(m)
        return time.perf_counter() - t0

    reset_counts()
    cold = step(tr.distill_step)
    counts = read_counts()
    torch.cuda.reset_peak_memory_stats()
    times = [step(tr.step_fn(i)) for i in range(DISTILL_CADENCE)]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    distills = [m["loss_distill"].item() for m in metrics
                if "loss_distill" in m]
    losses = [m["loss"].item() for m in metrics]
    moved = max((p - adapter0[k]).abs().max().item()
                for k, p in state.params.items())
    frozen_same = torch.equal(frozen_checksum(state), frozen0)
    n = {k: sum(c.values()) for k, c in counts.items()}
    lse = sum(v for k, v in counts["attn"].items() if k[5])
    launched = (lse > 0 and n["gn"] > 0 and n["flash_attn_bwd_dq"] > 0
                and n["flash_attn_bwd_dkv"] > 0)
    ok = (len(distills) == 2
          and all(math.isfinite(x) and x > 0 for x in distills)
          and all(math.isfinite(x) for x in losses) and moved > 0
          and frozen_same and launched)
    plain_ms = 1e3 * sum(times[1:]) / (len(times) - 1)
    log(f"distill: losses {[round(x, 5) for x in losses]}, loss_distill "
        f"{distills}; adapter max|moved|={moved:.3e}; frozen bit-identical "
        f"{frozen_same}; K1 with lse {lse}, K4 {n['gn']}, K5 "
        f"{n['flash_attn_bwd_dq']}, K6 {n['flash_attn_bwd_dkv']} launches; "
        f"{'OK' if ok else 'FAIL'}")
    log(f"distill: first distill step {1e3 * cold:.1f} ms (new shapes' "
        f"first launches included); in the cadence the distill step "
        f"{1e3 * times[0]:.1f} ms, the plain steps {plain_ms:.1f} ms each "
        f"(mean of {len(times) - 1}); {DISTILL_CADENCE} steps in "
        f"{sum(times):.3f} s, {DISTILL_CADENCE * TRAIN_BATCH / sum(times):.2f}"
        f" images/s at batch {TRAIN_BATCH} (host clock, a synchronize after "
        f"each step); peak memory {peak_gib:.2f} GiB")
    log_counts("distill", counts)

    # kernels on vs plain: one distill loss, its adapter gradients, the maps
    b = batch["image"].shape[0]
    draws = (torch.randint(0, 1000, (b,), device="cuda", generator=gen),
             torch.randn(b, 4, 32, 32, device="cuda", generator=gen),
             torch.randn(b, 4, 32, 32, device="cuda", generator=gen))
    parts_on, g_on = adapter_grads(ld, state, batch, draws, distill=True)
    with plain_path():
        parts_off, g_off = adapter_grads(ld, state, batch, draws,
                                         distill=True)
    rel = {k: abs(parts_on[k] - parts_off[k]) / abs(parts_off[k])
           for k in ("loss", "loss_distill")}
    g_err = max((g_on[k] - g_off[k]).abs().max().item() for k in g_on)
    g_scale = max(g.abs().max().item() for g in g_off.values())

    def maps():
        t, noise, eps = draws
        tb = 2
        with torch.no_grad():
            x0 = ld.encode_first_stage(batch["image"][:tb], eps=eps[:tb])
            cond = {"c_crossattn": ld.get_learned_conditioning(
                batch["input_ids"][:tb])}
            _, sa, ca = ld.apply_model(
                ld.q_sample(x0, t[:tb], noise[:tb]), t[:tb], cond,
                capture=CaptureSpec(self_n=32 * 32))
            return (*get_token_maps(sa, ca, resn=32),
                    *teacher_attention_maps(ld, x0, noise[:tb], t[:tb], cond))

    on = maps()
    with plain_path():
        off = maps()
    map_rel = [((a - r).abs().max() / r.abs().max()).item()
               for a, r in zip(on, off)]
    cmp_ok = (all(math.isfinite(x) and x <= LOSS_TOL for x in rel.values())
              and g_scale > 0 and g_err / g_scale <= UNET_TOL
              and all(math.isfinite(x) and x <= UNET_TOL for x in map_rel))
    log(f"distill kernels on vs plain: loss {parts_on['loss']:.6f} vs "
        f"{parts_off['loss']:.6f} (rel {rel['loss']:.3e}), loss_distill "
        f"{parts_on['loss_distill']:.6f} vs {parts_off['loss_distill']:.6f} "
        f"(rel {rel['loss_distill']:.3e}; tol {LOSS_TOL}); adapter grads "
        f"max|d|/max|ref| = {g_err / max(g_scale, 1e-30):.3e}; maps "
        f"max|d|/max|ref|: student self {map_rel[0]:.3e}, cross "
        f"{map_rel[1]:.3e}, teacher self {map_rel[2]:.3e}, cross "
        f"{map_rel[3]:.3e} (tol {UNET_TOL}); {'OK' if cmp_ok else 'FAIL'}")
    del on, off, g_on, g_off

    def run():
        step(tr.distill_step)

    reset_counts()
    k4_match("distill", *profile("distill", run, times[0]))
    return ok and cmp_ok, counts


def _dtypes_launched(counts, gn_dtypes):
    """{kernel: {dtype name: launches}} of a counted run: the dtype is the
    last field of every launch key but K4's, whose dtypes ``gn_dtypes``
    holds."""
    out = {"gn": dict(gn_dtypes)}
    for kind, c in counts.items():
        if kind == "gn":
            continue
        by = out.setdefault(kind, {})
        for key, n in c.items():
            by[key[-1]] = by.get(key[-1], 0) + n
    return out


@contextlib.contextmanager
def gn_dtype_tally(tally):
    """Tallies the dtype of each K4 launch into ``tally`` (K4's launch key
    holds no dtype): wraps ``groupnorm._launch``, which launches once a
    call."""
    from fgdm_tpu_torch.kernels import attention, groupnorm

    real = groupnorm._launch

    def launch(x, *a, **kw):
        tally[attention.dtype_name(x.dtype)] += 1
        return real(x, *a, **kw)

    groupnorm._launch = launch
    try:
        yield
    finally:
        groupnorm._launch = real


def phase_train_f32():
    """Float32 training: ``build_trainer(dtype=torch.float32)``, the
    adapter-only step at full width with every model in float32 (batch 8,
    256^2, AdamW, EMA).  The cold step with every launch count set to 0
    just before is the path's counted run, then ``WARM_STEPS`` warm steps;
    then one float32 distillation step, counted too (K1-f32 with lse
    through ``attention_with_scores``, K5-f32 and K6-f32).  Checks losses,
    grad norms, the adapter moved, the frozen weights bit-identical, the
    EMA count; K1-f32 with lse, K4, K5-f32 and K6-f32 launched, every
    launch float32.  Before the steps, at the trainer as built, one loss and
    its adapter gradients kernels on vs plain within ``LOSS_TOL`` and
    ``UNET_F32_TOL``; beside them, as a yardstick of how far float32
    rounding alone moves these gradients, the plain path with the scale
    folded into q before Q K^T (printed, not held); both again after the
    steps, printed only: there the two plain orderings differ by more than
    ``UNET_F32_TOL`` of max.  Profiles one warm step."""
    import collections
    import torch
    from fgdm_tpu_torch.builders import build_trainer
    from fgdm_tpu_torch.kernels import attention

    t0 = time.perf_counter()
    tr = build_trainer(device="cuda", seed=0, batch=TRAIN_BATCH,
                       use_ema=True, dtype=torch.float32)
    ld, state, batch = tr.ld, tr.state, tr.batch
    torch.cuda.synchronize()
    log(f"train_f32: built the float32 trainer in "
        f"{time.perf_counter() - t0:.1f}s, batch "
        f"{tuple(batch['image'].shape)}")
    gen = torch.Generator(device="cuda").manual_seed(9)
    b = batch["image"].shape[0]
    draws = (torch.randint(0, 1000, (b,), device="cuda", generator=gen),
             torch.randn(b, 4, 32, 32, device="cuda", generator=gen),
             torch.randn(b, 4, 32, 32, device="cuda", generator=gen))

    def scale_first(q, k, v, scale, return_lse=False):
        sim = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
        out = torch.matmul(torch.softmax(sim, dim=-1).to(v.dtype), v)
        return (out, torch.logsumexp(sim, dim=-1)) if return_lse else out

    def on_vs_plain():
        """(loss rel, adapter grads max|d|/max|ref| kernels on vs plain,
        the same of the plain path with the scale folded into q)."""
        parts_on, g_on = adapter_grads(ld, state, batch, draws)
        with plain_path():
            parts_off, g_off = adapter_grads(ld, state, batch, draws)
            ref = attention.attention_ref
            attention.attention_ref = scale_first
            try:
                _, g_alt = adapter_grads(ld, state, batch, draws)
            finally:
                attention.attention_ref = ref
        scale = max(g.abs().max().item() for g in g_off.values())
        return (abs(parts_on["loss"] - parts_off["loss"])
                / abs(parts_off["loss"]),
                *(max((g[k] - g_off[k]).abs().max().item() for k in g)
                  / scale if scale > 0 else math.inf
                  for g in (g_on, g_alt)))

    # kernels on vs plain, one loss and its adapter gradients
    loss_rel, g_err, alt_err = on_vs_plain()
    cmp_ok = (math.isfinite(loss_rel) and loss_rel <= LOSS_TOL
              and g_err <= UNET_F32_TOL)
    log(f"train_f32 kernels on vs plain (the trainer as built): loss rel "
        f"{loss_rel:.3e} (tol {LOSS_TOL}); adapter grads max|d|/max|ref| = "
        f"{g_err:.3e} (tol {UNET_F32_TOL}); {'OK' if cmp_ok else 'FAIL'}; "
        f"the plain path with the scale folded into q vs plain: "
        f"{alt_err:.3e} (f32 rounding alone)")

    adapter0 = {k: p.detach().clone() for k, p in state.params.items()}
    frozen0 = frozen_checksum(state)
    metrics = []
    gn_dtypes = collections.Counter()

    def step(fn=tr.train_step):
        nonlocal state
        state, m = fn(state, batch, gen)
        metrics.append(m)

    reset_counts()
    t0 = time.perf_counter()
    with gn_dtype_tally(gn_dtypes):
        step()
        torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    counts = read_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(WARM_STEPS):
        step()
    torch.cuda.synchronize()
    warm = (time.perf_counter() - t0) / WARM_STEPS
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    ema_ok = state.ema.num_updates == state.step == 1 + WARM_STEPS
    reset_counts()
    t0 = time.perf_counter()
    with gn_dtype_tally(gn_dtypes):
        step(tr.distill_step)
        torch.cuda.synchronize()
    distill_s = time.perf_counter() - t0
    distill_counts = read_counts()
    counts = merge_counts(counts, distill_counts)
    losses = [m["loss"].item() for m in metrics]
    norms = [m["grad_norm"].item() for m in metrics]
    distill = metrics[-1]["loss_distill"].item()
    moved = max((p - adapter0[k]).abs().max().item()
                for k, p in state.params.items())
    frozen_same = torch.equal(frozen_checksum(state), frozen0)
    by_dtype = _dtypes_launched(counts, gn_dtypes)
    lse = {k[6] for k in counts["attn"] if k[5]}
    n = {k: sum(c.values()) for k, c in counts.items()}
    launched = (lse == {"float32"} and n["gn"] > 0
                and n["flash_attn_bwd_dq"] > 0 and n["flash_attn_bwd_dkv"] > 0
                and sum(distill_counts["flash_attn_bwd_dq"].values()) > 0
                and all(set(c) <= {"float32"} for c in by_dtype.values()))
    ok = (all(math.isfinite(x) for x in losses)
          and all(math.isfinite(x) and x > 0 for x in norms)
          and math.isfinite(distill) and distill > 0
          and moved > 0 and frozen_same and ema_ok and launched)
    log(f"train_f32: {len(losses)} steps (the last a distillation step), "
        f"losses {[round(x, 5) for x in losses]}, grad norms "
        f"{[round(x, 5) for x in norms]}, loss_distill {distill:.6f}; "
        f"adapter max|moved|={moved:.3e}; frozen bit-identical "
        f"{frozen_same}; EMA updates {state.ema.num_updates} of "
        f"{1 + WARM_STEPS} before the distill step {ema_ok}; launches by "
        f"kernel and dtype {json.dumps(by_dtype, sort_keys=True)}; "
        f"{'OK' if ok else 'FAIL'}")
    log(f"train_f32: cold step {1e3 * cold:.1f} ms (kernel compiles "
        f"included); warm {1e3 * warm:.1f} ms/step over {WARM_STEPS} steps "
        f"(host clock), {TRAIN_BATCH / warm:.2f} images/s at batch "
        f"{TRAIN_BATCH}; peak memory {peak_gib:.2f} GiB; one distill step "
        f"{1e3 * distill_s:.1f} ms (its shapes' first launches included)")
    log_counts("train_f32", counts)
    after = on_vs_plain()
    log(f"train_f32 after the {len(metrics)} steps (printed, not held): "
        f"loss rel {after[0]:.3e}; adapter grads max|d|/max|ref| kernels on "
        f"vs plain {after[1]:.3e}, the plain path with the scale folded "
        f"into q vs plain {after[2]:.3e}")

    def run():
        step()
        torch.cuda.synchronize()

    profile("train_f32", run, warm)
    del tr, ld, state, batch
    return ok and cmp_ok, counts


COND_KINDS = ("depth", "normal", "sketch", "sketch_hed")
COND_TOL = 1e-4   # max| |n| - 1 | of a normal target's rows


def target_checks(kind, tgt):
    """``(ok, text)`` of a target's shape and range: in [-1, 1]; depth's
    three channels equal; normal rows of unit length; PiDiNet's edges in
    {-1, 1}."""
    import torch

    b = tgt.shape[0]
    ok = (tuple(tgt.shape) == (b, 3, 256, 256)
          and bool(torch.isfinite(tgt).all())
          and tgt.min().item() >= -1 - 1e-6 and tgt.max().item() <= 1 + 1e-6)
    text = (f"{tuple(tgt.shape)} in [{tgt.min().item():.4f}, "
            f"{tgt.max().item():.4f}]")
    if kind == "depth":
        same = (torch.equal(tgt[:, 0], tgt[:, 1])
                and torch.equal(tgt[:, 1], tgt[:, 2]))
        ok = ok and same
        text += f", channels equal {same}"
    elif kind == "normal":
        dev = (tgt.norm(dim=1) - 1).abs().max().item()
        ok = ok and dev <= COND_TOL
        text += f", max| |n| - 1 | = {dev:.2e} (tol {COND_TOL})"
    elif kind == "sketch":
        vals = set(torch.unique(tgt).tolist())
        ok = ok and vals <= {-1.0, 1.0}
        text += f", values {sorted(vals)}"
    return ok, text


def phase_condition(tr):
    """Condition-target training at full width on the training phase's
    trainer (batch 8 at 256^2): the frozen annotators of the depth, normal,
    sketch (PiDiNet) and sketch_hed (HED) configs, built by
    ``build_condition_synth`` from a seeded generator in float32 (the
    DPT-Hybrid's 577-token position table resized to the 16^2 grid).  Each
    target is checked and its annotator forward timed; then, counts reset
    just before (the path's counted run), one cold and one warm
    ``make_train_step(condition=...)`` step a kind and ``sketch_to_normal``'s
    ``_encode_target`` (MiDaS and PiDiNet, an 8-channel latent); then the
    annotators and the frozen UNet bit-identical, and one loss and its
    adapter gradients a kind kernels on vs plain on injected draws."""
    import torch
    from fgdm_tpu_torch.diffusion.losses import diffusion_loss
    from fgdm_tpu_torch.train.condition import (ConditionSynth,
                                                build_condition_synth)
    from fgdm_tpu_torch.train.train_step import (_encode_target,
                                                 make_train_step)

    ld, state, batch = tr.ld, tr.state, tr.batch
    img = batch["image"]
    gen = torch.Generator(device="cuda").manual_seed(9)
    t0 = time.perf_counter()
    synths = {k: build_condition_synth(k, generator=gen, device="cuda")
              for k in COND_KINDS}
    torch.cuda.synchronize()
    log(f"condition: annotators built and seeded in "
        f"{time.perf_counter() - t0:.1f}s (float32): " + ", ".join(
            f"{k} {type(s.model).__name__} "
            f"{sum(p.numel() for p in s.model.parameters())} parameters"
            for k, s in synths.items()))
    ann0 = {k: checksum(s.model.state_dict().values())
            for k, s in synths.items()}
    ok, fwd_ms = True, {}
    for kind, synth in synths.items():
        tgt = synth.target(img)
        good, text = target_checks(kind, tgt)
        fwd_ms[kind] = cuda_ms(lambda: synth.target(img), 3)
        ok = ok and good
        log(f"condition {kind}: target {text}; annotator forward "
            f"{fwd_ms[kind]:.2f} ms at batch {img.shape[0]}, 256^2; "
            f"{'OK' if good else 'FAIL'}")
    s2n = ConditionSynth("sketch_to_normal", synths["normal"].model,
                         synths["sketch"].model)
    frozen0 = frozen_checksum(state)
    metrics, step_ms, peaks = {}, {}, {}
    reset_counts()
    for kind, synth in synths.items():
        step = make_train_step(ld, condition=synth)
        times = []
        for i in range(2):
            if i:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, m = step(state, batch, gen)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            metrics.setdefault(kind, []).append(m)
        peaks[kind] = torch.cuda.max_memory_allocated() / 2 ** 30
        step_ms[kind] = times
    t0 = time.perf_counter()
    z = _encode_target(ld, batch, s2n, generator=gen)
    torch.cuda.synchronize()
    s2n_ms = 1e3 * (time.perf_counter() - t0)
    counts = read_counts()
    s2n_ok = (tuple(z.shape) == (img.shape[0], 8, 32, 32)
              and bool(torch.isfinite(z).all()) and z.std().item() > 0)
    frozen_same = torch.equal(frozen_checksum(state), frozen0)
    ann_same = {k: torch.equal(checksum(s.model.state_dict().values()),
                               ann0[k]) for k, s in synths.items()}
    losses = {k: [m["loss"].item() for m in ms] for k, ms in metrics.items()}
    norms = {k: [m["grad_norm"].item() for m in ms]
             for k, ms in metrics.items()}
    ok = (ok and s2n_ok and frozen_same and all(ann_same.values())
          and all(math.isfinite(x) for v in losses.values() for x in v)
          and all(math.isfinite(x) and x > 0
                  for v in norms.values() for x in v))
    for kind in synths:
        warm = step_ms[kind][1]
        log(f"condition {kind}: losses {[round(x, 5) for x in losses[kind]]}"
            f", grad norms {[round(x, 5) for x in norms[kind]]}; cold step "
            f"{step_ms[kind][0]:.1f} ms, warm step {warm:.1f} ms (host "
            f"clock), {img.shape[0] * 1e3 / warm:.2f} images/s; peak memory "
            f"{peaks[kind]:.2f} GiB; annotator bit-identical "
            f"{ann_same[kind]}")
    log(f"condition sketch_to_normal: _encode_target {tuple(z.shape)} "
        f"finite std {z.std().item():.4f} in {s2n_ms:.1f} ms (cold); frozen "
        f"UNet bit-identical {frozen_same}; {'OK' if ok else 'FAIL'}; "
        f"{card_line()}")
    log_counts("condition", counts)
    b = img.shape[0]
    t, noise, eps = (
        torch.randint(0, 1000, (b,), device="cuda", generator=gen),
        torch.randn(b, 4, 32, 32, device="cuda", generator=gen),
        torch.randn(b, 4, 32, 32, device="cuda", generator=gen))
    for kind, synth in synths.items():
        def loss_fn():
            with torch.no_grad():
                x0 = _encode_target(ld, batch, synth, eps)
                ctx = ld.get_learned_conditioning(batch["input_ids"])
            return diffusion_loss(ld, x0, {"c_crossattn": ctx}, t=t,
                                  noise=noise)

        ok = grads_on_off(f"condition {kind}", state, loss_fn, "loss") and ok
    del synths, s2n
    return ok, counts


def reference_midas_file(path, seed=0):
    """A seeded full-width DPT-Hybrid written as the released
    ``dpt_hybrid-midas-501f0c75.pt`` holds it: a flat state dict with the
    577-token position table, the final ViT norm and the deepest fusion
    block's ``resConfUnit1``, which the model never reads."""
    import torch
    from fgdm_tpu_torch.annotators import seed_
    from fgdm_tpu_torch.annotators.midas import DPTHybrid

    net = seed_(DPTHybrid(device="cuda"),
                torch.Generator(device="cuda").manual_seed(seed))
    sd = {k: v.cpu() for k, v in net.state_dict().items()}
    d = sd["pretrained.model.cls_token"].shape[-1]
    sd["pretrained.model.norm.weight"] = torch.ones(d)
    sd["pretrained.model.norm.bias"] = torch.zeros(d)
    for k, v in list(sd.items()):
        if k.startswith("scratch.refinenet3.resConfUnit1."):
            sd[k.replace("refinenet3", "refinenet4")] = v.clone()
    torch.save(sd, path)
    return net.pretrained.model.pos_embed.shape[1], len(sd)


def phase_condition_cli(root):
    """The training CLI on the reference's normal-factor config
    (``nautilus_coco_adapter_normal_map_gt_captions_distill_loss.yaml``:
    ``models/config.yaml`` with ``use_depth: true, use_normal: true``,
    written to ``root``) on the training-CLI phase's seeded COCO tree, for 3
    steps with ``--no-test`` (distillation at step 0, the config's
    ImageLogger at step 0), ``FGDM_ANNOTATOR_DIR`` at a seeded
    ``dpt_hybrid-midas-501f0c75.pt`` in the released schema; counts reset
    just before, read just after.  Checks the annotator file read with 0
    missing and 0 unexpected keys, the normal synthesis, finite losses at
    steps 0-2 and ``loss_distill`` at 0."""
    import torch
    import yaml
    from fgdm_tpu_torch.cli import train as train_cli
    from fgdm_tpu_torch.train import train_step

    tree = os.path.join(root, "coco")
    with open("models/config.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["params"].update(use_depth=True, use_normal=True)
    cfg_path = os.path.join(root, "normal_map_distill.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    ann_dir = os.path.join(root, "annotators")
    os.makedirs(ann_dir)
    t0 = time.perf_counter()
    tokens, n_keys = reference_midas_file(
        os.path.join(ann_dir, "dpt_hybrid-midas-501f0c75.pt"))
    gc.collect()
    torch.cuda.empty_cache()
    log(f"condition_cli: wrote a seeded dpt_hybrid-midas-501f0c75.pt "
        f"({n_keys} keys, {tokens}-token position table, "
        f"{os.path.getsize(os.path.join(ann_dir, os.listdir(ann_dir)[0]))} "
        f"bytes) in {time.perf_counter() - t0:.1f}s")
    logdir = os.path.join(root, "cond_logs")
    over = [f"data.params.{s}.params.data_dir={tree}"
            for s in ("train", "validation")]
    times = []
    real, make = _timed_steps(times)
    env = {"FGDM_RANDOMIZE_ZERO_HEADS": "1", "FGDM_ANNOTATOR_DIR": ann_dir}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    tee = _Tee(sys.stdout)
    train_step.make_train_step = make
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            train_cli.main(["-b", cfg_path, "-t", "--max_steps", "3",
                            "--no-test", "-l", logdir, "-n", "normal",
                            *over])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        train_step.make_train_step = real
        for k, v in saved_env.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    out = tee.text()
    run = os.path.join(logdir, os.listdir(logdir)[0])
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train_rows = {r["step"]: r for r in rows if "train/loss" in r}
    read_ok = re.search(r"annotator \S+dpt_hybrid-midas-501f0c75\.pt: "
                        r"missing=0 unexpected=0", out) is not None
    synth = re.search(r"condition synthesis: normal \(([\d.]+)s\)", out)
    distill_steps = sorted(s for s, r in train_rows.items()
                           if "train/loss_distill" in r)
    losses_ok = sorted(train_rows) == [0, 1, 2] and all(
        math.isfinite(r["train/loss"]) for r in train_rows.values())
    n = {k: sum(c.values()) for k, c in counts.items()}
    lse = sum(v for k, v in counts["attn"].items() if k[5])
    launched = (lse > 0 and n["gn"] > 0 and n["flash_attn_bwd_dq"] > 0
                and n["flash_attn_bwd_dkv"] > 0)
    ok = (read_ok and synth is not None and losses_ok
          and distill_steps == [0] and launched)
    shutil.rmtree(os.path.join(run, "checkpoints"), ignore_errors=True)
    log(f"condition_cli: main() {wall:.1f}s; annotator read with 0 missing "
        f"and 0 unexpected keys {read_ok}; annotators built and loaded in "
        f"{synth.group(1) if synth else '?'}s; train/loss finite at steps "
        f"0-2 {losses_ok}; loss_distill at {distill_steps}; step ms "
        f"{[round(ms, 1) for _, ms in times]} (the first cold, distill "
        f"first); peak memory {peak_gib:.2f} GiB; K1 with lse {lse}, K4 "
        f"{n['gn']}, K5 {n['flash_attn_bwd_dq']}, K6 "
        f"{n['flash_attn_bwd_dkv']} launches; {'OK' if ok else 'FAIL'}; "
        f"{card_line()}")
    log_counts("condition_cli", counts)
    return ok, counts


DETECT_PHOTOS = (2, (288, 320))   # photos under sample1/; H x W


def reference_uniformer_file(path, seed=0):
    """A seeded UniFormer-S + UPerHead written as mmseg's
    ``upernet_global_small.pth`` holds it: ``{"meta", "state_dict"}`` with
    each BatchNorm's ``num_batches_tracked`` and an ``auxiliary_head``,
    which inference never reads; the BatchNorms' statistics drawn too."""
    import torch
    from fgdm_tpu_torch.annotators import seed_
    from fgdm_tpu_torch.annotators.uniformer import (FrozenBatchNorm,
                                                     UniFormerSeg)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    net = seed_(UniFormerSeg(device="cuda"), gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, FrozenBatchNorm):
                m.weight.normal_(1.0, 0.1, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    sd = {k: v.cpu() for k, v in net.state_dict().items()}
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(1)
    sd["auxiliary_head.conv_seg.weight"] = torch.zeros(150, 256, 1, 1)
    sd["auxiliary_head.conv_seg.bias"] = torch.zeros(150)
    torch.save({"meta": {"seed": seed}, "state_dict": sd}, path)


def phase_detect(paths, root):
    """``python -m fgdm_tpu_torch.cli.seg2image --detect`` on the checkpoint
    phase's ControlNet file, conv flags on, ``--detect_resolution 512``, two
    seeded photos (320x288 JPEGs under ``sample1/``): once with
    ``--seg_ckpt`` a seeded ``upernet_global_small.pth`` in mmseg's schema,
    once without (all-zero weights, as JAX); counts reset just before each
    run and read after.  Times the detector (to its synchronize) and each
    render's sampling; checks 2 PNGs of 512^2 a run, the detected maps in
    the ADE palette (one colour, label 0's, without weights) and counts the
    conv-kernel launches the detector itself makes."""
    import numpy as np
    import torch
    from fgdm_tpu_torch.annotators import uniformer
    from fgdm_tpu_torch.cli import seg2image
    from fgdm_tpu_torch.data.colorize import ade_cmap
    from PIL import Image

    data = os.path.join(root, "detect")
    os.makedirs(os.path.join(data, "sample1"))
    rng = np.random.default_rng(11)
    n, (h, w) = DETECT_PHOTOS
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(data, "sample1", f"photo{i}.jpg"))
    seg = os.path.join(root, "upernet_global_small.pth")
    t0 = time.perf_counter()
    reference_uniformer_file(seg)
    log(f"detect: wrote a seeded upernet_global_small.pth "
        f"({os.path.getsize(seg)} bytes) in {time.perf_counter() - t0:.1f}s")
    det_ms, det_conv, maps, render_s = [], [], [], []
    call, sample = uniformer.UniformerDetector.__call__, \
        seg2image.sample_image_factor

    def timed_call(self, img):
        torch.cuda.synchronize()
        before = sum(read_counts()["conv"].values())
        t0 = time.perf_counter()
        out = call(self, img)
        det_ms.append(1e3 * (time.perf_counter() - t0))
        det_conv.append(sum(read_counts()["conv"].values()) - before)
        maps.append(out)
        return out

    def timed_sample(*a, **kw):
        t0 = time.perf_counter()
        z = sample(*a, **kw)
        torch.cuda.synchronize()
        render_s.append(time.perf_counter() - t0)
        return z

    uniformer.UniformerDetector.__call__ = timed_call
    seg2image.sample_image_factor = timed_sample
    runs = {}
    try:
        with conv_flags(), hash_tokenizer_allowed():
            for label, extra in (("detect", ["--seg_ckpt", seg]),
                                 ("detect0", [])):
                argv = ["--data_dir", data, "--cn_ckpt", paths["cn"],
                        "--detect", "--detect_resolution", "512",
                        "--num_images", str(n), "--prompt", PROMPT_CLI,
                        "--outdir", os.path.join(root, label), *extra]
                log(f"{label}: python -m fgdm_tpu_torch.cli.seg2image "
                    + " ".join(argv))
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                t0 = time.perf_counter()
                written = seg2image.main(argv)
                torch.cuda.synchronize()
                runs[label] = dict(
                    wall=time.perf_counter() - t0, written=written,
                    counts=read_counts(),
                    peak=torch.cuda.max_memory_allocated() / 2 ** 30)
    finally:
        uniformer.UniformerDetector.__call__ = call
        seg2image.sample_image_factor = sample
    palette = {tuple(c) for c in ade_cmap()[1:].tolist()}
    ok = True
    for i, (label, r) in enumerate(runs.items()):
        shapes = []
        for p in r["written"]:
            with open(p, "rb") as f:
                shapes.append(png_rgb(f.read())[:2])
        colours = [{tuple(c) for c in m.reshape(-1, 3).tolist()}
                   for m in maps[n * i:n * (i + 1)]]
        in_palette = all(c <= palette for c in colours)
        want = (lambda c: len(c) > 1) if label == "detect" else (
            lambda c: c == {tuple(ade_cmap()[1].tolist())})
        good = (shapes == [(512, 512)] * n and in_palette
                and all(want(c) for c in colours)
                and all(m.shape == (512, 512, 3) for m in
                        maps[n * i:n * (i + 1)]))
        ok = ok and good
        log(f"{label}: {len(r['written'])} images {shapes}; detected maps "
            f"{[len(c) for c in colours]} colours, in the ADE palette "
            f"{in_palette}; detector "
            f"{[round(x, 1) for x in det_ms[n * i:n * (i + 1)]]} ms an image "
            f"(512^2, bf16; the first cold), its conv-kernel launches "
            f"{det_conv[n * i:n * (i + 1)]}; sampling "
            f"{[round(x, 2) for x in render_s[n * i:n * (i + 1)]]} s an "
            f"image (20 DDIM steps, CFG 9.0); main() {r['wall']:.2f}s; peak "
            f"memory {r['peak']:.2f} GiB; {'OK' if good else 'FAIL'}; "
            f"{card_line()}")
        log_counts(label, r["counts"])
    return ok, runs["detect"]["counts"], runs["detect0"]["counts"]


EVAL_PROMPTS = 8          # prompts, images a directory
EVAL_BATCH = 4            # --n_samples: CFG doubles the UNet's batch to 8
EVAL_HW = 256
EVAL_TOL = 1e-4           # max|d| / max|ref|, card vs CPU, float32
EVAL_LABEL_AGREE = 0.995  # UniFormer labels equal on the card and the CPU
EVAL_HELD = 2             # images the card-vs-CPU checks run


def reference_clip_file(path, seed=0):
    """A seeded ViT-L/14 CLIP in OpenAI's schema (fused ``in_proj``,
    ``visual.*``, ``positional_embedding``, ``text_projection`` ``[768,
    768]``), except that the vision projection is stored as HF stores it
    (``visual_projection.weight``): JAX's fuzzy matcher has no slot for
    OpenAI's bare ``visual.proj`` and refuses such a file, and the port
    does as JAX does.  Returns the state dict with ``visual.proj`` instead
    (held in host memory, for the refusal check)."""
    import torch
    from fgdm_tpu_torch.models.clip import CLIPTextEncoder
    from fgdm_tpu_torch.nn.layers import init_params_
    from fgdm_tpu_torch.utils.clip_score import CLIPVisionEncoder

    gen = torch.Generator(device="cuda").manual_seed(seed)
    vision = init_params_(CLIPVisionEncoder(device="cuda"), gen, 0.02)
    vision.reset_parameters(gen)
    text = init_params_(CLIPTextEncoder(device="cuda"), gen, 0.02)
    vsd = {k: v.cpu() for k, v in vision.state_dict().items()}
    tsd = {k.replace("text_model.", ""): v.cpu()
           for k, v in text.state_dict().items()}
    d = tsd["final_layer_norm.weight"].shape[0]
    sd = {"positional_embedding": tsd["embeddings.position_embedding.weight"],
          "text_projection": torch.randn(d, vision.proj_dim, generator=gen,
                                         device="cuda").cpu() * d ** -0.5,
          "logit_scale": torch.tensor(4.6052),
          "visual.class_embedding": vsd["class_embedding"],
          "visual.positional_embedding": vsd["position_embedding"],
          "visual_projection.weight": vsd["visual_projection.weight"],
          "visual.conv1.weight": vsd["patch_embed.weight"],
          "visual.ln_pre.weight": vsd["pre_layernorm.weight"],
          "visual.ln_pre.bias": vsd["pre_layernorm.bias"]}
    names = (("ln_1", "layer_norm1"), ("ln_2", "layer_norm2"),
             ("mlp.c_fc", "mlp.fc1"), ("mlp.c_proj", "mlp.fc2"),
             ("attn.out_proj", "self_attn.out_proj"))
    for src, dst in ((vsd, "visual.transformer."), (tsd, "transformer.")):
        n = sum(k.endswith("layer_norm1.weight") for k in src)
        pre = "" if src is vsd else "encoder."
        for i in range(n):
            s, t = f"{pre}layers.{i}.", f"{dst}resblocks.{i}."
            for leaf in ("weight", "bias"):
                sd[t + f"attn.in_proj_{leaf}"] = torch.cat(
                    [src[s + f"self_attn.{x}_proj.{leaf}"] for x in "qkv"])
                for o, h in names:
                    sd[t + f"{o}.{leaf}"] = src[s + f"{h}.{leaf}"]
    sd["visual.ln_post.weight"] = vsd["post_layernorm.weight"]
    sd["visual.ln_post.bias"] = vsd["post_layernorm.bias"]
    sd["token_embedding.weight"] = tsd["embeddings.token_embedding.weight"]
    sd["ln_final.weight"] = tsd["final_layer_norm.weight"]
    sd["ln_final.bias"] = tsd["final_layer_norm.bias"]
    torch.save(sd, path)
    openai = {("visual.proj" if k == "visual_projection.weight" else k):
              (v.T.contiguous() if k == "visual_projection.weight" else v)
              for k, v in sd.items()}
    del vision, text
    torch.cuda.empty_cache()
    return openai


def reference_inception_file(path, seed=0):
    """JAX's seeded ``init_inception_params(seed)`` as torchvision's
    ``inception_v3`` state dict: ``fc.*``, ``AuxLogits.*`` and each
    BatchNorm's ``num_batches_tracked`` beside the FID keys."""
    import torch
    from fgdm_tpu_torch.utils.inception import init_inception_params

    sd = {k: torch.from_numpy(v)
          for k, v in init_inception_params(seed).items()}
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    sd["fc.weight"] = torch.zeros(1008, 2048)
    sd["fc.bias"] = torch.zeros(1008)
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    sd["AuxLogits.fc.weight"] = torch.zeros(1008, 768)
    torch.save(sd, path)


def reference_openpose_file(path, seed=0):
    """A seeded ``BodyPoseNet`` as the released ``body_pose_model.pth``
    holds it: bare conv names (``conv1_1.weight``,
    ``Mconv7_stage6_L2.bias``)."""
    import torch
    from fgdm_tpu_torch.annotators import seed_
    from fgdm_tpu_torch.annotators.openpose import BodyPoseNet

    net = seed_(BodyPoseNet(device="cuda"),
                torch.Generator(device="cuda").manual_seed(seed))
    torch.save({k.split(".", 1)[1]: v.cpu()
                for k, v in net.state_dict().items()}, path)


def reference_pidinet_file(path, seed=0):
    """A seeded PiDiNet as ``table5_pidinet.pth`` holds it: ``module.``
    keys under ``"state_dict"``."""
    import torch
    from fgdm_tpu_torch.annotators import seed_
    from fgdm_tpu_torch.annotators.pidinet import PiDiNet

    net = seed_(PiDiNet(device="cuda"),
                torch.Generator(device="cuda").manual_seed(seed))
    torch.save({"state_dict": {"module." + k: v.cpu()
                               for k, v in net.state_dict().items()}}, path)


def write_eval_dirs(root, seed=0):
    """``EVAL_PROMPTS`` images of 256^2 a directory: real images (seeded
    noise), colorized ADE maps, depth (grayscale ramps), normals, sketches
    (sparse strokes) and pose renders (``render_skeleton`` of two random
    Halpe-136 people), and the prompt file."""
    import numpy as np
    from fgdm_tpu_torch.cli.txt2img_fgdm import _write_png
    from fgdm_tpu_torch.data.colorize import ade_cmap, colorize
    from fgdm_tpu_torch.data.pose import NUM_JOINTS, render_skeleton

    rng = np.random.default_rng(seed)
    n, hw = EVAL_PROMPTS, EVAL_HW
    yy, xx = np.mgrid[:hw, :hw] / hw
    maps = {
        "ref": [rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8)
                for _ in range(n)],
        "cond": [colorize(rng.integers(0, 150, (8, 8)).repeat(32, 0)
                          .repeat(32, 1), ade_cmap()[1:]) for _ in range(n)],
        "depth": [np.repeat((255 * (a * xx + (1 - a) * yy))[..., None], 3,
                            -1).astype(np.uint8) for a in rng.random(n)],
        "normal": [rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8)
                   for _ in range(n)],
        "sketch": [np.repeat((255 * (rng.random((hw, hw)) > 0.97))[..., None],
                             3, -1).astype(np.uint8) for _ in range(n)],
        "pose": [render_skeleton([np.concatenate([
            rng.uniform(16, hw - 16, (NUM_JOINTS, 2)),
            np.ones((NUM_JOINTS, 1))], 1) for _ in range(2)], hw, hw)
            for _ in range(n)],
    }
    dirs = {}
    for name, arrs in maps.items():
        d = dirs[name] = os.path.join(root, name)
        os.makedirs(d)
        for i, a in enumerate(arrs):
            _write_png(os.path.join(d, f"{i:03}.png"), a)
    dirs["prompts"] = os.path.join(root, "prompts.txt")
    with open(dirs["prompts"], "w") as f:
        f.write("\n".join(f"{PROMPT_CLI}, view {i}" for i in range(n)))
    return dirs


def _images(args):
    for a in args[1:]:
        if hasattr(a, "shape"):
            return 1 if len(a.shape) == 3 else int(a.shape[0])
    return 1


@contextlib.contextmanager
def timed_calls(targets):
    """Patch each ``(label, owner, name)`` to record ``(seconds, images)``
    of every call, the card synchronized around it."""
    import torch

    times = {label: [] for label, _, _ in targets}
    saved = []
    for label, owner, name in targets:
        fn = getattr(owner, name)
        saved.append((owner, name, fn))

        def wrapper(*a, _fn=fn, _label=label, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            times[_label].append((time.perf_counter() - t0, _images(a)))
            return out

        setattr(owner, name, wrapper)
    try:
        yield times
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def _per_image_ms(calls):
    n = sum(k for _, k in calls)
    return round(1e3 * sum(s for s, _ in calls) / max(n, 1), 2)


def _metrics_ok(m, n):
    """Every metric finite and in its range."""
    unit = ("clip_score",)
    frac = ("miou", "sketch_f1", "sketch_precision", "sketch_recall",
            "pose_f1", "pose_precision", "pose_recall")
    ok = m.get("n_images") == n
    for k, v in m.items():
        if isinstance(v, str):
            continue
        ok = ok and math.isfinite(v)
        if k in unit:
            ok = ok and -1.0 <= v <= 1.0
        elif k in frac:
            ok = ok and 0.0 <= v <= 1.0
        elif k.startswith("normal_"):
            ok = ok and 0.0 <= v <= 180.0
        else:
            ok = ok and v >= 0.0
    return ok


def _max_rel(got, ref):
    import numpy as np

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def eval_held_on_cpu(opt, imgs):
    """The metric networks on the card against the same seeded modules on
    the card's CPU, on ``EVAL_HELD`` generated images, with the global
    TF32 switches on (the networks turn it off themselves): CLIP image
    features, Inception pool3, MiDaS depth, PiDiNet's unthresholded edges
    and OpenPose's PAF and heat maps within ``EVAL_TOL``; UniFormer labels
    equal on ``EVAL_LABEL_AGREE`` of the pixels."""
    import copy

    import numpy as np
    import torch
    from fgdm_tpu_torch import full_f32
    from fgdm_tpu_torch.checkpoint import annotator_ingest as ai
    from fgdm_tpu_torch.checkpoint.torch_ingest import load_torch_state_dict
    from fgdm_tpu_torch.cli import eval as ev
    from fgdm_tpu_torch.utils import clip_score, inception

    x = imgs[:EVAL_HELD]
    u8 = (np.clip(x, 0.0, 1.0) * 255).astype(np.uint8)
    res = {}
    scorer, _ = ev.default_scorer_factory(opt)
    cpu = clip_score.CLIPScorer(copy.deepcopy(scorer.vision).cpu(),
                                copy.deepcopy(scorer.text).cpu(),
                                scorer.text_proj.cpu())
    res["CLIP features"] = _max_rel(scorer.encode_image(x).cpu(),
                                cpu.encode_image(x))
    del scorer, cpu
    sd = load_torch_state_dict(opt.inception_ckpt)
    fns = [inception.inception_feature_fn(
        inception.ingest_inception(sd, device=d))[0] for d in ("cuda", "cpu")]
    res["Inception pool3"] = _max_rel(fns[0](x), fns[1](x))
    dets = [ai.load_midas(opt.midas_ckpt, device=d) for d in ("cuda", "cpu")]
    res["MiDaS depth"] = _max_rel(ev._midas(dets[0], x)[0],
                              ev._midas(dets[1], x)[0])
    nets = [ai.load_pidinet(opt.pidinet_ckpt, device=d)
            for d in ("cuda", "cpu")]
    outs = []
    for net in nets:
        net.binarize = False
        dev = next(net.parameters()).device
        with torch.no_grad(), full_f32():
            xx = torch.from_numpy(x).to(dev).permute(0, 3, 1, 2) * 2 - 1
            outs.append(net(xx).cpu().numpy())
    res["PiDiNet edges"] = _max_rel(*outs)
    dets = [ai.load_openpose(opt.openpose_ckpt, device=d)
            for d in ("cuda", "cpu")]
    maps = [[det.maps(im) for im in u8] for det in dets]
    res["OpenPose PAF"] = max(_max_rel(a[0], b[0]) for a, b in zip(*maps))
    res["OpenPose heat"] = max(_max_rel(a[1], b[1]) for a, b in zip(*maps))
    dets = [ai.load_uniformer(opt.seg_ckpt, device=d)
            for d in ("cuda", "cpu")]
    with full_f32():
        labels = [det.labels(u8) for det in dets]
    agree = float((labels[0] == labels[1]).mean())
    ok = (all(v <= EVAL_TOL for v in res.values())
          and agree >= EVAL_LABEL_AGREE)
    log("eval: card vs CPU on " + str(EVAL_HELD) + " images (global TF32 "
        "on, the metric networks' own switch off): " + ", ".join(
            f"{k} max|d|/max|ref| {v:.3e}" for k, v in res.items())
        + f" (tol {EVAL_TOL}); UniFormer labels agree on {agree:.5f} of "
        f"the pixels (>= {EVAL_LABEL_AGREE}); {'OK' if ok else 'FAIL'}")
    return ok


def phase_eval(paths, root):
    """``python -m fgdm_tpu_torch.cli.eval`` at full width on seeded
    weights written in the reference schemas (a ViT-L/14 CLIP in OpenAI's
    schema, a torchvision InceptionV3, ``body_pose_model.pth``, UniFormer,
    MiDaS and PiDiNet), under ``FGDM_ALLOW_HASH_TOKENIZER=1``, conv flags
    on, the global TF32 switches on (the metric networks turn it off for
    themselves).  Run 1, the eval path's counted run: generate 8 images of
    256^2 from the checkpoint phase's factor-1 file (``--n_samples 4``, 50
    DDIM steps) and score them with every flag (CLIP score, Inception-FID,
    mIoU, depth, normal, edge-F1, skeleton-F1).  Runs 2 and 3: score run
    1's PNGs (``--images_dir``) with CLIP-FID and the same adherence flags;
    their JSON must be identical.  Times each metric network per image,
    OpenPose's network and host grouping apart, and each FID; then holds
    the metric networks on the card against the CPU and the factor-1 UNet
    and VAE forwards of the generation kernels on vs plain."""
    import numpy as np
    import torch
    from fgdm_tpu_torch.annotators import midas, openpose, pidinet, uniformer
    from fgdm_tpu_torch.builders import ModelSpec
    from fgdm_tpu_torch.checkpoint import fuzzy_ingest
    from fgdm_tpu_torch.checkpoint.torch_ingest import load_torch_state_dict
    from fgdm_tpu_torch.cli import eval as ev
    from fgdm_tpu_torch.models.clip import CLIPTextEncoder
    from fgdm_tpu_torch.utils import clip_score, fid, inception
    from fgdm_tpu_torch.utils.clip_score import CLIPVisionEncoder

    files = {name: os.path.join(root, name) for name in (
        "clip-vit-large-patch14.pt", "pt_inception-2015-12-21.pth",
        "body_pose_model.pth", "upernet_global_small.pth",
        "dpt_hybrid-midas-501f0c75.pt", "table5_pidinet.pth")}
    t0 = time.perf_counter()
    openai = reference_clip_file(files["clip-vit-large-patch14.pt"])
    reference_inception_file(files["pt_inception-2015-12-21.pth"])
    reference_openpose_file(files["body_pose_model.pth"])
    reference_uniformer_file(files["upernet_global_small.pth"])
    reference_midas_file(files["dpt_hybrid-midas-501f0c75.pt"])
    reference_pidinet_file(files["table5_pidinet.pth"])
    dirs = write_eval_dirs(os.path.join(root, "dirs"))
    log(f"eval: wrote the reference-schema files in "
        f"{time.perf_counter() - t0:.1f}s: " + ", ".join(
            f"{k} {os.path.getsize(p)}" for k, p in files.items()))

    # the CLIP file through the fuzzy matcher (the towers on the meta device)
    vision, text = CLIPVisionEncoder(device="meta"), \
        CLIPTextEncoder(device="meta")
    try:
        ev.ingest_clip_towers(openai, vision, text)
        refusal = "loaded"
    except SystemExit as e:
        refusal = str(e)
    refused = refusal == ("[eval] CLIP vision ingest failed: 1 unconsumed "
                          "ckpt params, e.g. ['visual.proj']")
    matches, match = [], fuzzy_ingest.match_state_dict

    def recorded(*a):
        matches.append(match(*a))
        return matches[-1]

    fuzzy_ingest.match_state_dict = recorded
    try:
        ev.ingest_clip_towers(load_torch_state_dict(
            files["clip-vit-large-patch14.pt"]), vision, text)
    finally:
        fuzzy_ingest.match_state_dict = match
    layer = re.compile(r"resblocks\.(\d+)\.")
    moved = [sum(1 for k, p in m.items() if layer.search(k) and not
                 p.startswith(f"layers_{layer.search(k).group(1)}/"))
             for m, _, _ in matches]
    ingest_ok = refused and all(not t and not f for _, t, f in matches)
    del openai, vision, text
    log("eval: the CLIP file through the fuzzy ingest: " + "; ".join(
        f"{label} {len(m)} tensors matched, {len(t)} unconsumed, {len(f)} "
        f"tower parameters at init, {n} in another layer's slot than their "
        f"name's (JAX's tie rule, ROADMAP Queue C)"
        for label, (m, t, f), n in zip(("vision", "text"), matches, moved))
        + f"; the same file with OpenAI's visual.proj refused as JAX "
        f"refuses it: {refused}; {'OK' if ingest_ok else 'FAIL'}")

    outdir = os.path.join(root, "eval_out")
    score = ["--clip_ckpt", files["clip-vit-large-patch14.pt"],
             "--ref_dir", dirs["ref"], "--cond_dir", dirs["cond"],
             "--seg_ckpt", files["upernet_global_small.pth"],
             "--depth_dir", dirs["depth"], "--normal_dir", dirs["normal"],
             "--midas_ckpt", files["dpt_hybrid-midas-501f0c75.pt"],
             "--sketch_dir", dirs["sketch"],
             "--pidinet_ckpt", files["table5_pidinet.pth"],
             "--pose_dir", dirs["pose"],
             "--openpose_ckpt", files["body_pose_model.pth"],
             "--from-file", dirs["prompts"]]
    runs = {
        "generate": ["--config", "models/config.yaml", "--ckpt", paths["f1"],
                     "--n_samples", str(EVAL_BATCH), "--ddim_steps", "50",
                     "--H", str(EVAL_HW), "--W", str(EVAL_HW),
                     "--inception_ckpt",
                     files["pt_inception-2015-12-21.pth"], "--outdir",
                     outdir, "--out", os.path.join(root, "eval1.json")]
        + score,
        "score_dir": ["--images_dir", outdir] + score,
        "score_dir_again": ["--images_dir", outdir] + score}
    targets = [("CLIP scorer", clip_score.CLIPScorer, "encode_image"),
               ("Inception", inception.InceptionV3, "forward"),
               ("UniFormer", uniformer.UniformerDetector, "labels"),
               ("MiDaS", midas.MidasDetector, "__call__"),
               ("PiDiNet", pidinet.PiDiNet, "forward"),
               ("OpenPose network", openpose.OpenposeDetector, "maps"),
               ("OpenPose host grouping", openpose.OpenposeDetector,
                "render"),
               ("FID (sqrtm)", fid, "frechet_distance"),
               ("generation", ev, "_generate"),
               ("load", ModelSpec, "load")]
    pipes = []
    load = ModelSpec.load

    def keep(self, *a, **kw):
        pipes.append(load(self, *a, **kw))
        return pipes[-1]

    saved_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32)
    out, ok = {}, ingest_ok
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        ModelSpec.load = keep
        for label, argv in runs.items():
            log(f"eval ({label}): python -m fgdm_tpu_torch.cli.eval "
                + " ".join(argv))
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ev._MIDAS_MEMO.clear()
            with conv_flags(), hash_tokenizer_allowed(), \
                    timed_calls(targets) as times:
                if label == "generate":
                    reset_counts()
                t0 = time.perf_counter()
                m = ev.main(argv)
                wall = time.perf_counter() - t0
                if label == "generate":
                    counts = read_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            out[label] = m
            good = _metrics_ok(m, EVAL_PROMPTS) and (
                m.get("fid_backend") == ("inception_pool3"
                                         if label == "generate" else "clip"))
            line = f"eval ({label}): {json.dumps(m)}; main() {wall:.2f}s"
            if label == "generate":
                gen_s = sum(s for s, _ in times["generation"])
                line += (f", load {sum(s for s, _ in times['load']):.2f}s, "
                         f"generation (load included) {gen_s:.2f}s "
                         f"({EVAL_PROMPTS / gen_s:.3f} images/s)")
                shapes = []
                for name in sorted(os.listdir(outdir)):
                    with open(os.path.join(outdir, name), "rb") as f:
                        shapes.append(png_rgb(f.read())[:2])
                good = good and shapes == [(EVAL_HW, EVAL_HW)] * EVAL_PROMPTS
                line += f", {len(shapes)} PNGs {sorted(set(shapes))}"
            ok = ok and good
            log(line + "; per image ms: " + ", ".join(
                f"{k} {_per_image_ms(v)}" for k, v in times.items()
                if k not in ("FID (sqrtm)", "generation", "load") and v)
                + "; FID s " + str([round(s, 2) for s, _ in
                                    times["FID (sqrtm)"]])
                + f"; peak memory {peak:.2f} GiB; "
                f"{'OK' if good else 'FAIL'}; {card_line()}")
        ModelSpec.load = load
        same = (json.dumps(out["score_dir"])
                == json.dumps(out["score_dir_again"]))
        log(f"eval: the directory scored twice gives identical JSON: {same}")
        ok = ok and same
        log_counts("eval", counts)
        imgs = ev._load_dir_images(outdir)
        opt = ev.get_parser().parse_args(runs["generate"])
        with hash_tokenizer_allowed():
            ok = eval_held_on_cpu(opt, imgs) and ok
    finally:
        ModelSpec.load = load
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved_tf32

    # the generation's forwards, kernels on vs plain
    ld = pipes[0]
    gen = torch.Generator(device="cuda").manual_seed(12)
    b = 2 * EVAL_BATCH
    lat = EVAL_HW // 8
    with torch.inference_mode(), conv_flags():
        x = torch.randn(b, 4, lat, lat, device="cuda", generator=gen)
        t = torch.full((b,), 981, device="cuda")
        ctx = torch.randn(b, 77, 768, device="cuda", generator=gen)
        z = torch.randn(EVAL_BATCH, 4, lat, lat, device="cuda", generator=gen)
        for label, fn in ((f"UNet forward [{b},4,{lat},{lat}]",
                           lambda: ld.apply_model(x, t, {"c_crossattn": ctx})),
                          (f"VAE decode [{EVAL_BATCH},4,{lat},{lat}]",
                           lambda: ld.decode_first_stage(z))):
            on = fn()
            with plain_path():
                off = fn()
            torch.cuda.synchronize()
            rel = _max_rel(on.float().cpu(), off.float().cpu())
            good = math.isfinite(rel) and rel <= UNET_TOL
            ok = ok and good
            log(f"eval: {label}, conv flags on: kernels on vs plain "
                f"max|d|/max|ref| = {rel:.3e} (tol {UNET_TOL}); "
                f"{'OK' if good else 'FAIL'}")
    del pipes, ld, on, off
    gc.collect()
    torch.cuda.empty_cache()
    return ok, counts


TRAIN_CLI_TREE = (24, 8, (288, 320))   # train, val images; H x W
TRAIN_CLI_KEYS = ("inputs", "reconstruction", "conditioning", "samples",
                  "samples_inpainting", "samples_outpainting", "mask",
                  "denoise_row", "diffusion_row", "progressive_row")


def write_coco_tree(root, seed=0):
    """A seeded tree in COCO's layout: JPEG RGB images, L-mode label PNGs
    (ids 0-181 in 16-pixel blocks, a void 255 band) and the captions
    JSON of each split."""
    import numpy as np
    from fgdm_tpu_torch.builders import PROMPTS
    from PIL import Image

    rng = np.random.default_rng(seed)
    n_train, n_val, (h, w) = TRAIN_CLI_TREE
    for split, n in (("train2017", n_train), ("val2017", n_val)):
        img_dir = os.path.join(root, "images", split)
        lab_dir = os.path.join(root, "annotations", split)
        os.makedirs(img_dir)
        os.makedirs(lab_dir)
        anns = []
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                            ).save(os.path.join(img_dir, f"{i:012d}.jpg"))
            lab = np.kron(rng.integers(0, 182, (h // 16, w // 16)),
                          np.ones((16, 16), np.int64)).astype(np.uint8)
            lab[: h // 8] = 255
            Image.fromarray(lab, "L").save(os.path.join(lab_dir,
                                                        f"{i:012d}.png"))
            anns += [{"image_id": i, "caption": PROMPTS[(i + j) % 8]}
                     for j in range(2)]
        with open(os.path.join(root, "annotations",
                               f"captions_{split}.json"), "w") as f:
            json.dump({"annotations": anns}, f)


class _Tee:
    """stdout to the log and to a buffer the checks read."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.parts)


def _timed_steps(times):
    """Wrap ``make_train_step`` so each step is timed to its synchronize
    (``times``: (distill, ms) in step order)."""
    import torch
    from fgdm_tpu_torch.train import train_step

    real = train_step.make_train_step

    def make(*a, **kw):
        fn = real(*a, **kw)

        def step(*sa, **skw):
            t0 = time.perf_counter()
            out = fn(*sa, **skw)
            torch.cuda.synchronize()
            times.append((kw.get("distill", False),
                          1e3 * (time.perf_counter() - t0)))
            return out

        return step

    return real, make


def phase_train_cli(root):
    """The training CLI (``python -m fgdm_tpu_torch.cli.train``) at full
    width on the shipped recipe (``models/config.yaml``: UNet 320 with the
    adapter and activation checkpointing, VAE 128, CLIP 768, batch 8 at
    256^2, AdamW under the LambdaLinear schedule, distillation every 10th
    step, the config's ImageLogger) on a seeded COCO tree: 11 steps with
    ``--ckpt_every 10 --val_every 5``, then ``-r`` to step 13.  The launch
    counts are reset before the first run and read after the second."""
    import torch
    from fgdm_tpu_torch.cli import train as train_cli
    from fgdm_tpu_torch.data import native
    from fgdm_tpu_torch.train import train_step

    tree = os.path.join(root, "coco")
    write_coco_tree(tree)
    logdir = os.path.join(root, "logs")
    log(f"train_cli: data transforms "
        f"{'native ' + str(native.library_path()) if native.HAS_NATIVE else 'numpy (no library built)'}")
    over = [f"data.params.{s}.params.data_dir={tree}"
            for s in ("train", "validation")]
    times = []
    real, make = _timed_steps(times)
    saved_env = os.environ.get("FGDM_RANDOMIZE_ZERO_HEADS")
    os.environ["FGDM_RANDOMIZE_ZERO_HEADS"] = "1"
    tee = _Tee(sys.stdout)
    train_step.make_train_step = make
    t_runs = []
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with contextlib.redirect_stdout(tee):
            for args in (["-b", "models/config.yaml", "-t", "--max_steps",
                          "11", "--ckpt_every", "10", "--val_every", "5",
                          "-l", logdir, "-n", "chip", *over],
                         ["-r", None, "-t", "--max_steps", "13"]):
                if args[1] is None:
                    args[1] = os.path.join(logdir, os.listdir(logdir)[0])
                t0 = time.perf_counter()
                train_cli.main(args)
                torch.cuda.synchronize()
                t_runs.append(time.perf_counter() - t0)
                gc.collect()
                torch.cuda.empty_cache()
        counts = read_counts()
    finally:
        train_step.make_train_step = real
        if saved_env is None:
            del os.environ["FGDM_RANDOMIZE_ZERO_HEADS"]
        else:
            os.environ["FGDM_RANDOMIZE_ZERO_HEADS"] = saved_env
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    out = tee.text()
    run = os.path.join(logdir, os.listdir(logdir)[0])
    rows = [json.loads(line) for line in open(os.path.join(run,
                                                           "metrics.jsonl"))]
    train_rows = {r["step"]: r for r in rows if "train/loss" in r}
    losses_ok = (sorted(train_rows) == list(range(13)) and all(
        math.isfinite(r["train/loss"]) for r in train_rows.values()))
    distill_steps = sorted(s for s, r in train_rows.items()
                           if "train/loss_distill" in r)
    val_steps = sorted(r["step"] for r in rows
                       if any(k.startswith("val/") for k in r))
    pngs = set(os.listdir(os.path.join(run, "images")))
    missing = [k for k in TRAIN_CLI_KEYS if f"{k}_gs-000000.png" not in pngs]
    resumed = re.search(r"resumed from \S+ at step 11 \(([\d.]+)s\)", out)
    done = "done at step 13" in out
    ckdir = os.path.join(run, "checkpoints")
    steps = sorted(int(f[:-3]) for f in os.listdir(ckdir) if f.endswith(".pt"))
    first = torch.load(os.path.join(ckdir, f"{steps[0]}.pt"),
                       map_location="cpu", weights_only=True)
    last = torch.load(os.path.join(ckdir, f"{steps[-1]}.pt"),
                      map_location="cpu", weights_only=True)
    frozen_same = (set(first["frozen"]) == set(last["frozen"]) and all(
        torch.equal(v, last["frozen"][k]) for k, v in first["frozen"].items()))
    adapter_moved = any(not torch.equal(v, last["params"][k])
                        for k, v in first["params"].items())
    state_steps = (first["step"], last["step"])
    del first, last
    shutil.rmtree(ckdir, ignore_errors=True)
    n = {k: sum(c.values()) for k, c in counts.items()}
    lse = sum(v for k, v in counts["attn"].items() if k[5])
    k2 = sum(v for k, v in counts["attn"].items()
             if attn_kernel(k[4], k[3]) == K2)
    launched = (lse > 0 and k2 > 0 and n["gn"] > 0
                and n["flash_attn_bwd_dq"] > 0 and n["flash_attn_bwd_dkv"] > 0)
    ok = (losses_ok and distill_steps == [0, 10] and val_steps == [5, 10]
          and not missing and resumed is not None and done and frozen_same
          and adapter_moved and steps == [0, 10, 12]
          and state_steps == (1, 13) and launched)
    log(f"train_cli: runs {t_runs[0]:.1f}s + {t_runs[1]:.1f}s; train/loss "
        f"finite at steps 0-12 {losses_ok}; loss_distill at {distill_steps};"
        f" val rows at {val_steps}; missing images {missing}; resumed "
        f"{resumed is not None}, done at 13 {done}; checkpoints {steps} "
        f"(state steps {state_steps}), frozen bit-equal {frozen_same}, "
        f"adapter moved {adapter_moved}; K1 with lse {lse}, K2 {k2}, K4 "
        f"{n['gn']}, K5 {n['flash_attn_bwd_dq']}, K6 "
        f"{n['flash_attn_bwd_dkv']} launches; {'OK' if ok else 'FAIL'}")
    loads = [float(x) for x in re.findall(r"model on cuda\S* in ([\d.]+)s",
                                          out)]
    logged = [float(x) for x in re.findall(r"images logged at step \d+ "
                                           r"\(([\d.]+)s\)", out)]
    saves = re.findall(r"saved step (\d+) \((\d+) bytes, ([\d.]+)s\)", out)
    plain = [ms for i, (distill, ms) in enumerate(times)
             if not distill and i not in (0, 1, 11)]
    distill_ms = [ms for distill, ms in times if distill]
    warm = sum(plain) / max(len(plain), 1)
    log(f"train_cli: load {loads} s; warm plain step {warm:.1f} ms (mean of "
        f"{len(plain)}, each to its synchronize, host clock; "
        f"{TRAIN_BATCH * 1e3 / warm:.2f} images/s at batch {TRAIN_BATCH}); "
        f"distill steps {[round(x, 1) for x in distill_ms]} ms (the first "
        f"cold); image log {logged} s; saves "
        + ", ".join(f"step {st}: {int(b) / 1e9:.2f} GB in {t}s"
                    for st, b, t in saves)
        + f"; resume {resumed.group(1) if resumed else '?'} s; peak memory "
        f"{peak_gib:.2f} GiB; {card_line()}")
    log_counts("train_cli", counts)
    return ok, counts


def record_grad_maxima(state, groups, n):
    """Wrap ``state.optimizer.step`` so that each of its first ``n`` calls
    records ``{group: max|grad|}`` over each group of trainable names (a
    missing gradient counts 0) before the update."""
    import torch

    seen, step = [], state.optimizer.step

    def recording():
        if len(seen) < n:
            seen.append({g: torch.stack([
                state.params[k].grad.abs().max()
                if state.params[k].grad is not None
                else state.params[k].new_zeros(()) for k in names]
            ).max().item() for g, names in groups.items()})
        return step()

    state.optimizer.step = recording
    return seen


def trainable_grads(state, loss_fn):
    """Loss terms and the trainable gradients of one ``loss_fn()`` forward
    and backward (no optimizer step)."""
    loss, parts = loss_fn()
    loss.backward()
    grads = {k: p.grad.float() for k, p in state.params.items()
             if p.grad is not None}
    for p in state.params.values():
        p.grad = None
    return {k: float(v.detach()) for k, v in parts.items()}, grads


def grads_on_off(label, state, loss_fn, key):
    """One loss and its trainable gradients, kernels on vs plain."""
    parts_on, g_on = trainable_grads(state, loss_fn)
    with plain_path():
        parts_off, g_off = trainable_grads(state, loss_fn)
    loss_rel = abs(parts_on[key] - parts_off[key]) / abs(parts_off[key])
    g_err = max((g_on[k] - g_off[k]).abs().max().item() for k in g_off)
    g_scale = max(g.abs().max().item() for g in g_off.values())
    ok = (set(g_on) == set(g_off) and math.isfinite(loss_rel)
          and loss_rel <= LOSS_TOL and g_scale > 0
          and g_err / g_scale <= UNET_TOL)
    log(f"{label} kernels on vs plain: {key} {parts_on[key]:.6f} vs "
        f"{parts_off[key]:.6f} (rel {loss_rel:.3e}, tol {LOSS_TOL}); "
        f"trainable grads max|d|/max|ref| = {g_err / max(g_scale, 1e-30):.3e}"
        f" (tol {UNET_TOL}); {'OK' if ok else 'FAIL'}")
    return ok


@contextlib.contextmanager
def coco_env(tree):
    """``FGDM_COCO_DIR`` set to ``tree`` for the recipes' loaders."""
    saved = os.environ.get("FGDM_COCO_DIR")
    os.environ["FGDM_COCO_DIR"] = tree
    try:
        yield
    finally:
        if saved is None:
            del os.environ["FGDM_COCO_DIR"]
        else:
            os.environ["FGDM_COCO_DIR"] = saved


def _launched(counts):
    n = {k: sum(c.values()) for k, c in counts.items()}
    kinds = {attn_kernel(k[4], k[3]) for k in counts["attn"]}
    return n, any(k[5] for k in counts["attn"]), kinds


def _recipe_log(name, out, build_s):
    ms = out["step_ms"]
    warm = ms[2:-2] if name == "control" else ms[2:]
    mean = sum(warm) / len(warm)
    log(f"{name}: built in {build_s:.1f}s; {out['steps']} steps in "
        f"{out['wall_s']}s, losses {out['losses']}; step ms {ms}; warm "
        f"{mean:.1f} ms/step (mean of {len(warm)}, to the metrics' "
        f"read-back, host clock), {out['batch'] * 1e3 / mean:.2f} images/s "
        f"at batch {out['batch']}, {out['res']}^2; peak memory "
        f"{out['peak_gib']} GiB; {card_line()}")


def phase_control(root, tree):
    """ControlNet fine-tuning at full width (``cli.recipes control``: the
    UNet frozen under ``remat``, the VAE and CLIP outside the optimizer,
    AdamW on the ControlNet, ``sd_locked``) at 512^2, batch 2, 12 steps, the
    checkpoint round trip, 2 more steps from a fresh loader; counts reset
    just before.  Checks the losses, that the first step's gradient reaches
    the zero convs and not the ControlNet's interior (all-zero zero convs)
    and the second step's reaches the interior, that the control branch
    moved and the UNet, VAE and CLIP did not, the launches; then one loss
    and its ControlNet gradients kernels on vs plain."""
    import torch
    from fgdm_tpu_torch.cli import recipes
    from fgdm_tpu_torch.diffusion.losses import diffusion_loss

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cldm, state = recipes.build_control("cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    zero = [k for k in state.params if k.startswith(
        ("control.zero_convs.", "control.middle_block_out."))]
    interior = [k for k in state.params if k not in zero]
    n_train = sum(p.numel() for p in state.params.values())
    n_frozen = sum(p.numel() for p in state.frozen.values())
    log(f"control: {n_train} trainable (ControlNet) and {n_frozen} frozen "
        f"UNet parameters; zero convs all zero "
        f"{not any(state.params[k].any() for k in zero)}")
    control0 = checksum(cldm.control.parameters())
    frozen0 = frozen_checksum(state)
    others0 = [checksum(m.parameters()) for m in (cldm.vae, cldm.clip)]
    maxima = record_grad_maxima(state, {"zero": zero, "interior": interior},
                                2)
    reset_counts()
    with coco_env(tree):
        out = recipes.train_control(cldm, state,
                                    logdir=os.path.join(root, "hw_control"))
    counts = read_counts()
    _recipe_log("control", out, build_s)
    moved = not torch.equal(checksum(cldm.control.parameters()), control0)
    frozen_same = torch.equal(frozen_checksum(state), frozen0)
    others_same = all(torch.equal(checksum(m.parameters()), c)
                      for m, c in zip((cldm.vae, cldm.clip), others0))
    grads_ok = (len(maxima) == 2 and maxima[0]["zero"] > 0
                and maxima[0]["interior"] == 0
                and maxima[1]["interior"] > 0)
    n, lse, kinds = _launched(counts)
    bwd = [(2, 8, 4096, 4096, 40, "bfloat16"),
           (2, 8, 1024, 1024, 80, "bfloat16")]
    launched = (lse and K3 in kinds and n["gn"] > 0 and all(
        counts[k].get(key, 0) > 0 for key in bwd
        for k in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv")))
    ok = (out["steps"] == 14 and all(math.isfinite(x) for x in out["losses"])
          and grads_ok and moved and frozen_same and others_same
          and launched)
    log(f"control: max|grad| step 1 zero convs {maxima[0]['zero']:.3e}, "
        f"interior {maxima[0]['interior']:.3e}; step 2 interior "
        f"{maxima[1]['interior']:.3e}; control moved {moved}; UNet "
        f"bit-identical {frozen_same}, VAE and CLIP {others_same}; round "
        f"trip equal (checked in the recipe); K1 with lse {lse}, K3 "
        f"{K3 in kinds}, K4 {n['gn']}, K5 {n['flash_attn_bwd_dq']}, K6 "
        f"{n['flash_attn_bwd_dkv']} launches; {'OK' if ok else 'FAIL'}")
    log_counts("control", counts)

    gen = torch.Generator(device="cuda").manual_seed(12)
    b = 2
    image = torch.rand(b, 3, 512, 512, device="cuda", generator=gen) * 2 - 1
    hint = torch.rand(b, 3, 512, 512, device="cuda", generator=gen)
    t = torch.randint(0, 1000, (b,), device="cuda", generator=gen)
    noise = torch.randn(b, 4, 64, 64, device="cuda", generator=gen)
    with torch.no_grad():
        x0 = cldm.encode_first_stage(image)
        ctx = torch.randn(b, 77, 768, device="cuda", generator=gen)
    cmp_ok = grads_on_off("control", state, lambda: diffusion_loss(
        cldm, x0, {"c_crossattn": ctx, "c_concat": hint}, t=t, noise=noise),
        "loss")
    del cldm, state, x0
    return ok and cmp_ok, counts


def phase_joint(root, tree):
    """Joint two-factor training at full width (``cli.recipes joint``:
    ``SeqTwoUNet(image_adapter, remat)``, both halves VAE encodes) at
    256^2, batch 4, 14 steps with the round trip after step 11; counts
    reset just before.  Checks the losses, that ``unet1.adapter`` and the
    channel mapper moved and both backbones did not, the launches; then one
    loss and its adapter gradients kernels on vs plain.  Returns the
    trained model and the CLIP for the co-denoising phase."""
    import torch
    from fgdm_tpu_torch.checkpoint.loader import SD_SCHEDULE
    from fgdm_tpu_torch.cli import recipes
    from fgdm_tpu_torch.core.schedules import DiffusionSchedule

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, state, vae, clip = recipes.build_joint("cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    params0 = {k: p.detach().clone() for k, p in state.params.items()}
    frozen0 = frozen_checksum(state)
    reset_counts()
    with coco_env(tree):
        out = recipes.train_joint(model, state, vae, clip,
                                  logdir=os.path.join(root, "hw_joint"))
    counts = read_counts()
    _recipe_log("joint", out, build_s)
    moved = {g: any(not torch.equal(p, params0[k])
                    for k, p in state.params.items() if k.startswith(g))
             for g in ("unet1.adapter.", "channel_mapper.")}
    frozen_same = torch.equal(frozen_checksum(state), frozen0)
    n, lse, kinds = _launched(counts)
    launched = (lse and K2 in kinds and n["gn"] > 0
                and n["flash_attn_bwd_dq"] > 0 and n["flash_attn_bwd_dkv"] > 0)
    ok = (out["steps"] == 14 and all(math.isfinite(x) for x in out["losses"])
          and all(moved.values()) and frozen_same and launched)
    log(f"joint: moved {moved}; both backbones bit-identical {frozen_same}; "
        f"round trip equal (checked in the recipe); K1 with lse {lse}, K2 "
        f"{K2 in kinds}, K4 {n['gn']}, K5 {n['flash_attn_bwd_dq']}, K6 "
        f"{n['flash_attn_bwd_dkv']} launches; {'OK' if ok else 'FAIL'}")
    log_counts("joint", counts)

    gen = torch.Generator(device="cuda").manual_seed(13)
    b = 4
    lat = torch.randn(b, 8, 32, 32, device="cuda", generator=gen)
    ctx = torch.randn(b, 77, 768, device="cuda", generator=gen)
    t = torch.randint(0, 1000, (b,), device="cuda", generator=gen)
    noise = torch.randn(b, 4, 32, 32, device="cuda", generator=gen)
    sched = DiffusionSchedule.create(**SD_SCHEDULE).to("cuda")
    fc = model.factor_channels

    def loss_fn():   # the joint step's loss on injected draws
        x_in = torch.cat([sched.q_sample(lat[:, :fc], t, noise),
                          lat[:, fc:]], dim=1)
        eps = model(x_in, t, context=ctx, cond_map=lat[:, fc:])
        loss = ((eps[:, :fc].float() - noise) ** 2).mean()
        return loss, {"train/loss": loss.detach()}

    cmp_ok = grads_on_off("joint", state, loss_fn, "train/loss")
    del state, vae
    return ok and cmp_ok, counts, model, clip


def phase_codenoise(model, clip):
    """Co-denoising of both factors (``joint_denoise_fn`` under
    ``ddim_sample``): 20 DDIM steps at CFG 7.5, batch 2, a 32^2 latent of
    8 channels, the joint phase's model at full width; counts reset just
    before.  Checks both halves finite with nonzero std, K1 launched, and
    one ``SeqTwoUNet`` forward kernels on vs plain."""
    import torch
    from fgdm_tpu_torch.builders import PROMPTS
    from fgdm_tpu_torch.checkpoint.loader import SD_SCHEDULE
    from fgdm_tpu_torch.core.schedules import DDIMSchedule, DiffusionSchedule
    from fgdm_tpu_torch.models.clip import CLIPTokenizer
    from fgdm_tpu_torch.models.seq_two_unet import joint_denoise_fn
    from fgdm_tpu_torch.sampling.ddim import ddim_sample

    tok = CLIPTokenizer()
    with torch.no_grad():
        ctx = clip(tok(PROMPTS[:2]).cuda())
        uc = clip(tok(["", ""]).cuda())
    sched = DDIMSchedule.create(DiffusionSchedule.create(**SD_SCHEDULE), 20)
    gen = torch.Generator(device="cuda").manual_seed(14)
    x_T = torch.randn(2, 8, 32, 32, device="cuda", generator=gen)
    fn = joint_denoise_fn(model)
    runs = []
    for run in range(2):   # the first is the counted run
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = ddim_sample(fn, (2, 8, 32, 32), sched,
                              {"c_crossattn": ctx}, {"c_crossattn": uc},
                              cfg_scale=7.5, x_T=x_T, device="cuda")
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        if run == 0:
            counts = read_counts()
    halves = out[:, :4], out[:, 4:]
    stds = [h.float().std().item() for h in halves]
    finite = bool(torch.isfinite(out).all())
    n, lse, kinds = _launched(counts)
    t = torch.tensor([501, 501, 501, 501], device="cuda")
    x = torch.randn(4, 8, 32, 32, device="cuda", generator=gen)
    c4 = torch.cat([uc, ctx])
    with torch.no_grad():
        on = model(x, t, context=c4)
        with plain_path():
            off = model(x, t, context=c4)
    rel = _rel(on, off)
    ok = (finite and all(s > 0 for s in stds) and K1 in kinds
          and math.isfinite(rel) and rel <= UNET_TOL)
    log(f"codenoise: 20 DDIM steps at CFG 7.5, batch 2, [2,8,32,32] in "
        f"{runs[0]:.3f}s (counted run) and {runs[1]:.3f}s (host clock); "
        f"finite {finite}, std image half {stds[0]:.4f}, condition half "
        f"{stds[1]:.4f}; K1 {n['attn']} launches (with lse {lse}); "
        f"SeqTwoUNet forward [4,8,32,32] kernels on vs plain max|d|/max|ref| "
        f"= {rel:.3e} (tol {UNET_TOL}); {'OK' if ok else 'FAIL'}")
    log_counts("codenoise", counts)
    return ok, counts


def phase_variant():
    """One forward of a UNet at SD-1.4 width with the config-reachable
    variants on (pixel attention in the new qkv order, ``resblock_updown``,
    ``num_classes`` with labels; fused GroupNorm+SiLU), batch 2 at 32^2,
    counts reset just before; kernels on vs plain.  Pixel attention is torch
    ops in both packages: no K1 may run."""
    import torch
    from fgdm_tpu_torch.checkpoint.loader import sd_unet, seeded_init_

    unet = seeded_init_(sd_unet(
        torch.bfloat16, "cuda", use_adapter=False, context_dim=None,
        use_spatial_transformer=False, use_new_attention_order=True,
        resblock_updown=True, num_classes=1000), 15, 0.02)
    gen = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn(2, 4, 32, 32, device="cuda", generator=gen)
    t = torch.tensor([17, 733], device="cuda")
    y = torch.tensor([207, 981], device="cuda")
    with torch.inference_mode():
        reset_counts()
        on = unet(x, t, y=y)
        torch.cuda.synchronize()
        counts = read_counts()
        with plain_path():
            off = unet(x, t, y=y)
    rel = _rel(on, off)
    n = {k: sum(c.values()) for k, c in counts.items()}
    ok = (bool(torch.isfinite(on).all()) and math.isfinite(rel)
          and rel <= UNET_TOL and n["gn"] > 0 and n["attn"] == 0)
    log(f"variant UNet (pixel attention, new qkv order, resblock_updown, "
        f"num_classes) forward [2,4,32,32]: kernels on vs plain "
        f"max|d|/max|ref| = {rel:.3e} (tol {UNET_TOL}); K4 {n['gn']}, K1 "
        f"{n['attn']} launches; {'OK' if ok else 'FAIL'}")
    log_counts("variant", counts)
    del unet
    return ok, counts


def phase_guided(paths, outdir, ld, f1_unguided):
    """``txt2img_fgdm --inference_loss`` with run_inference.sh's factor-1
    flags (no ControlNet stage) on the factor-1 checkpoint, conv flags on as
    in the CLI phase: the guided path's counted run.  Checks 5 condition
    maps (256^2), that K4 and K2 launched and that no K1 did (the guidance's
    ``"probs"`` capture runs every attention explicitly, as in JAX); then
    one ``guided_update`` at step 10 (two unconditional iterations) on the
    CLI's CFG batch, kernels on vs plain, on ``ld`` (the same file)."""
    import torch
    from fgdm_tpu_torch.cli import txt2img_fgdm
    from fgdm_tpu_torch.core.schedules import DDIMSchedule
    from fgdm_tpu_torch.models.clip import CLIPTokenizer
    from fgdm_tpu_torch.sampling.guidance import alignment_loss, guided_update

    argv = GUIDED_FLAGS + ["--prompt", PROMPT_CLI, "--ckpt", paths["f1"],
                           "--outdir", outdir]
    log("guided: python -m fgdm_tpu_torch.cli.txt2img_fgdm " + " ".join(argv))
    torch.cuda.reset_peak_memory_stats()
    with conv_flags(), hash_tokenizer_allowed():
        reset_counts()
        t0 = time.perf_counter()
        out = txt2img_fgdm.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    maps = sorted(out["files"])
    shapes = set()
    for p in maps:
        with open(p, "rb") as f:
            shapes.add(png_rgb(f.read())[:2])
    k1 = sum(v for k, v in counts["attn"].items() if k[4] <= 96)
    k2 = sum(v for k, v in counts["attn"].items()
             if attn_kernel(k[4], k[3]) == K2)
    n_gn = sum(counts["gn"].values())
    ok = (len(maps) == CLI_BATCH and shapes == {(256, 256)} and k1 == 0
          and k2 > 0 and n_gn > 0)
    f1 = out["factor1_s"][0]
    log(f"guided: {len(maps)} maps {sorted(shapes)}; [factor1] {f1:.2f}s "
        f"with the guidance against {f1_unguided:.2f}s without (the CLI "
        f"phase, this run; both first runs), load {out['load_s']:.2f}s, "
        f"main() {wall:.2f}s; peak memory {peak_gib:.2f} GiB; launches K1 "
        f"{k1}, K2 {k2}, K4 {n_gn}, K7 {sum(counts['conv'].values())}; "
        f"{'OK' if ok else 'FAIL'}")
    log_counts("guided", counts)

    # one guided_update at step 10 on the CLI's CFG batch, kernels on vs
    # plain: x_out - x_in within UNET_TOL of the update, plus the float32
    # rounding of x; and the first iteration's loss.  Its gradient is
    # printed, not held: at seeded weights the loss is ~1.5e-4, a sum of
    # squared differences of near-equal maps, and the gradient's relative
    # difference between the two bf16 paths read 4.800e-2 and 4.894e-2 in
    # two runs of the same code on an H100, too near UNET_TOL to hold
    gen = torch.Generator(device="cuda").manual_seed(9)
    tok = CLIPTokenizer()
    ld.unet.requires_grad_(False)
    with torch.no_grad():
        ctx = torch.cat([ld.get_learned_conditioning(tok([p] * CLI_BATCH)
                                                     .cuda())
                         for p in ("", PROMPT_CLI)])
    sched = DDIMSchedule.create(ld.schedule, 50)
    t = sched.timesteps[50 - 1 - 10].expand(2 * CLI_BATCH).cuda()
    x_in = torch.randn(2 * CLI_BATCH, 4, 32, 32, device="cuda", generator=gen)
    fn = ld.capture_fn()

    def update():
        with torch.no_grad():
            return guided_update(fn, x_in, t, {"c_crossattn": ctx}, 10,
                                 num=CLI_BATCH)

    def loss_grad():
        x = x_in.clone().requires_grad_()
        _, sa, ca = fn(x, t, {"c_crossattn": ctx})
        loss = alignment_loss(sa, ca, CLI_BATCH, 1.0)
        return loss.item(), torch.autograd.grad(loss, x)[0]

    with conv_flags():
        x_on, (l_on, g_on) = update(), loss_grad()
        with plain_path():
            x_off, (l_off, g_off) = update(), loss_grad()
    step_max = (x_off - x_in).abs().max().item()
    err = (x_on - x_off).abs().max().item()
    lim = UNET_TOL * step_max + 4 * 2.0 ** -24 * x_in.abs().max().item()
    l_rel = abs(l_on - l_off) / abs(l_off)
    g_rel = ((g_on - g_off).abs().max() / g_off.abs().max()).item()
    upd_ok = (math.isfinite(err) and step_max > 0 and err <= lim
              and l_rel <= LOSS_TOL and math.isfinite(g_rel))
    log(f"guided_update at step 10 [{2 * CLI_BATCH},4,32,32] kernels on vs "
        f"plain: max|x_on - x_off| = {err:.3e}, the update max|x_off - x_in|"
        f" = {step_max:.3e} (tol {lim:.3e}: {UNET_TOL} of the update + 4 "
        f"half-ulps of max|x|); the alignment loss {l_on:.6e} vs "
        f"{l_off:.6e} (rel {l_rel:.3e}, tol {LOSS_TOL}), its gradient "
        f"max|d|/max|ref| = {g_rel:.3e} (printed, not held; max|ref| "
        f"{g_off.abs().max().item():.3e}); {'OK' if upd_ok else 'FAIL'}")
    return ok and upd_ok, counts


def phase_chain_n(paths, outdir):
    """``txt2img_fgdm --factors seg,depth,normal --all_pconds
    --use_controlnet`` with the CLI phase's flags at batch 2 on the two
    files (depth and normal at the seeded init, built on the card), conv
    flags on: the N-factor path's counted run.  Checks 2 maps a factor
    (256^2) and 2 images (512^2) as valid PNGs; then one forward of factor
    3's multi-adapter UNet (``num_prompts`` 2, one ``extra_pcond``) at the
    CFG batch of 4, kernels on vs plain."""
    import torch
    from fgdm_tpu_torch.checkpoint.loader import seeded_init_
    from fgdm_tpu_torch.cli import txt2img_fgdm
    from fgdm_tpu_torch.config import instantiate_from_config, load_config

    n = CHAIN_N_BATCH
    argv = CLI_FLAGS + [
        "--factors", ",".join(CHAIN_N_FACTORS), "--factor_ckpts",
        paths["f1"] + "," * (len(CHAIN_N_FACTORS) - 1), "--all_pconds",
        "--cn_ckpt", paths["cn"], "--n_samples", str(n), "--prompt",
        PROMPT_CLI, "--outdir", outdir]
    log("chain_n: python -m fgdm_tpu_torch.cli.txt2img_fgdm "
        + " ".join(argv))
    torch.cuda.reset_peak_memory_stats()
    with conv_flags(), hash_tokenizer_allowed():
        reset_counts()
        t0 = time.perf_counter()
        out = txt2img_fgdm.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    want = {os.path.join(outdir, f"factor_{m}", f"{m}_00_{i:04}.png"):
            (256, 256) for m in CHAIN_N_FACTORS for i in range(n)}
    want.update({os.path.join(outdir, f"{CHAIN_N_FACTORS[-1]}_images",
                              f"image_00_{i:04}.png"): (512, 512)
                 for i in range(n)})
    shapes = {}
    for p in out["files"]:
        with open(p, "rb") as f:
            shapes[p] = png_rgb(f.read())[:2]
    ok = shapes == want
    secs = out["chain_s"][0]
    log(f"chain_n: {len(shapes)} PNGs ({len(CHAIN_N_FACTORS)} x {n} maps "
        f"256^2, {n} images 512^2: {ok}); load {out['load_s']:.2f}s, "
        f"[chain_n] {secs:.2f}s ({n / secs:.3f} images/s, first run: no "
        f"warmup), main() {wall:.2f}s; peak memory {peak_gib:.2f} GiB; "
        f"{'OK' if ok else 'FAIL'}")
    log_counts("chain_n", counts)

    # factor 3's UNet as the CLI builds it (the config's, one extra
    # adapter), seeded and perturbed so that its zero-init heads work
    spec = instantiate_from_config(load_config("models/config.yaml")["model"])
    unet = seeded_init_(spec.unet_def.clone(num_prompts=2).build("cuda"), 8,
                        0.02)
    gen = torch.Generator(device="cuda").manual_seed(10)
    b = 2 * n
    x, pcond, extra = (torch.randn(b, 4, 32, 32, device="cuda",
                                   generator=gen) for _ in range(3))
    t = torch.full((b,), 981, device="cuda")
    ctx = torch.randn(b, 77, 768, device="cuda", generator=gen)
    with torch.inference_mode(), conv_flags():
        on = unet(x, t, context=ctx, pcond=pcond, extra_pconds=[extra])
        base = unet(x, t, context=ctx, pcond=pcond)
        with plain_path():
            off = unet(x, t, context=ctx, pcond=pcond, extra_pconds=[extra])
        torch.cuda.synchronize()
    rel = ((on - off).abs().max() / off.abs().max()).item()
    moved = (on - base).abs().max().item()
    fwd_ok = (math.isfinite(rel) and rel <= UNET_TOL and moved > 0
              and bool(torch.isfinite(on).all()))
    log(f"multi-adapter UNet forward [{b},4,32,32] (num_prompts 2, one "
        f"extra_pcond), conv flags on: kernels on vs plain max|d|/max|ref| "
        f"= {rel:.3e} (tol {UNET_TOL}); the extra adapter moves eps by "
        f"{moved:.3e}; {'OK' if fwd_ok else 'FAIL'}")
    del unet, on, off, base
    torch.cuda.empty_cache()
    return ok and fwd_ok, counts


PTP_PROMPTS = ["a photo of a cat riding a bike",
               "a photo of a dog riding a bike"]
PTP_STEPS, PTP_STEP_HELD = 50, 10
IMG2IMG_STRENGTH = 0.75       # t_enc = int(0.75 * 50) = 37 DDIM steps


def _edit_controllers(tok, prompts):
    """The replace controller of the ptp run (0.8 of the steps for the
    cross maps, 0.4 for the self maps), and a refine and a reweight one
    (``dog`` x2, ``inner`` the replace controller) on the same prompts."""
    from fgdm_tpu_torch.utils.ptp import get_equalizer, make_controller

    kw = dict(cross_replace_steps=0.8, self_replace_steps=0.4)
    replace = make_controller(prompts, tok, PTP_STEPS, kind="replace", **kw)
    return {"replace": replace,
            "refine": make_controller(prompts, tok, PTP_STEPS,
                                      kind="refine", **kw),
            "reweight": make_controller(
                prompts, tok, PTP_STEPS, kind="reweight",
                equalizer=get_equalizer(prompts[1], "dog", [2.0], tok),
                inner=replace, **kw)}


def _rel(on, off):
    return ((on.float() - off.float()).abs().max()
            / off.float().abs().max()).item()


def phase_ptp(ld):
    """Prompt-to-prompt editing at ``ptp_sample``'s defaults (64^2 latent,
    50 DDIM steps, CFG 7.5, eta 0) for two prompts with a replace edit and
    ``LocalBlend`` on cat/dog, CLIP contexts, the two latents decoded at
    512^2, conv flags on: the ptp path's counted run.  Checks both images
    finite and distinct, no K1 (the editor runs every attention
    explicitly, as in JAX), K3 and K4 launched; prints the share of latent
    positions where the edit equals the base bit for bit (the blend's kept
    region).  Then one edited UNet forward per kind at the CFG batch
    [4,4,64,64] at step 10, kernels on vs plain.  Returns the base image
    for the img2img phase."""
    import torch
    from fgdm_tpu_torch.core.schedules import DDIMSchedule
    from fgdm_tpu_torch.models.clip import CLIPTokenizer
    from fgdm_tpu_torch.sampling.ptp_sampler import ptp_sample
    from fgdm_tpu_torch.utils.ptp import LocalBlend

    tok = CLIPTokenizer()
    ctls = _edit_controllers(tok, PTP_PROMPTS)
    blend = LocalBlend.create(PTP_PROMPTS, [["cat"], ["dog"]], tok)
    with torch.inference_mode():
        ctx = ld.get_learned_conditioning(tok(PTP_PROMPTS).cuda())
        uc = ld.get_learned_conditioning(tok([""] * 2).cuda())
    gen = torch.Generator(device="cuda").manual_seed(12)
    log(f"ptp: ptp_sample {PTP_PROMPTS}, replace (cross 0.8, self 0.4), "
        f"LocalBlend cat/dog, 64^2 latent, {PTP_STEPS} steps, CFG 7.5")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with conv_flags():
        reset_counts()
        t0 = time.perf_counter()
        # its defaults: 64^2, CFG 7.5, eta 0; the controller's step count
        z = ptp_sample(ld, ctls["replace"], ctx, uc, num_steps=PTP_STEPS,
                       local_blend=blend, generator=gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.inference_mode():
            img = ld.decode_first_stage(z)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    k1 = sum(v for k, v in counts["attn"].items() if k[4] <= 96)
    k3 = sum(v for k, v in counts["attn"].items()
             if attn_kernel(k[4], k[3]) == K3)
    n_gn = sum(counts["gn"].values())
    finite = bool(torch.isfinite(img).all())
    distinct = (img[0].float() - img[1].float()).abs().max().item()
    kept = (z[1] == z[0]).all(dim=0).float().mean().item()
    ok = (finite and distinct > 0 and k1 == 0 and k3 > 0 and n_gn > 0
          and tuple(img.shape) == (2, 3, 512, 512))
    log(f"ptp: images {tuple(img.shape)} finite={finite}, max|image 1 - "
        f"image 0| = {distinct:.3e}; latent positions of the edit equal to "
        f"the base bit for bit (LocalBlend's kept region, printed, not held):"
        f" {kept:.4f}; wall {t1 - t0:.2f}s sampling + {t2 - t1:.2f}s decode "
        f"(first run), peak memory {peak_gib:.2f} GiB; launches K1 {k1}, K3 "
        f"{k3}, K4 {n_gn}, K7 {sum(counts['conv'].values())}; "
        f"{'OK' if ok else 'FAIL'}")
    log_counts("ptp", counts)

    sched = DDIMSchedule.create(ld.schedule, PTP_STEPS)
    index = PTP_STEPS - 1 - PTP_STEP_HELD
    t = sched.timesteps[index].expand(4).cuda()
    x = torch.randn(2, 4, 64, 64, device="cuda", generator=gen)
    x_in, ctx_in = torch.cat([x, x]), torch.cat([uc, ctx])
    fwd_ok = True
    for kind, ctl in ctls.items():
        editor = ctl.to("cuda").editor(PTP_STEP_HELD)
        with torch.inference_mode(), conv_flags():
            on = ld.unet(x_in, t, context=ctx_in, attn_editor=editor)
            with plain_path():
                off = ld.unet(x_in, t, context=ctx_in, attn_editor=editor)
            torch.cuda.synchronize()
        rel = _rel(on, off)
        good = (math.isfinite(rel) and rel <= UNET_TOL
                and bool(torch.isfinite(on).all()))
        fwd_ok = fwd_ok and good
        log(f"ptp: {kind}-edited UNet forward [4,4,64,64] at step "
            f"{PTP_STEP_HELD}, conv flags on: kernels on vs plain "
            f"max|d|/max|ref| = {rel:.3e} (tol {UNET_TOL}); "
            f"{'OK' if good else 'FAIL'}")
    del on, off, z
    torch.cuda.empty_cache()
    return ok and fwd_ok, counts, img[:1], ctx, uc


def phase_img2img(ld, image, ctx, uc):
    """img2img on the ptp run's base image (512^2), conv flags on: the
    img2img path's counted run.  The VAE encoder (its mid block at N =
    4096 on K3), ``stochastic_encode`` to DDIM step t_enc = 37 of 50,
    ``ddim_decode`` over 37 steps at CFG 7.5, batch 1, and a decode.
    Checks the image finite and that K1, K3 and K4 launched.  Then one
    call each of ``augmented_cfg_eps`` and ``composable_cfg_eps`` (the two
    ptp prompts) on a 64^2 latent, kernels on vs plain: within UNET_TOL of
    the sum of the combination's weights times max|eps| of the batched
    forward."""
    import torch
    from fgdm_tpu_torch.core.schedules import DDIMSchedule
    from fgdm_tpu_torch.sampling.ddim import (augmented_cfg_eps,
                                              composable_cfg_eps, ddim_decode,
                                              stochastic_encode)

    sched = DDIMSchedule.create(ld.schedule, PTP_STEPS)
    t_enc = int(IMG2IMG_STRENGTH * PTP_STEPS)
    gen = torch.Generator(device="cuda").manual_seed(13)
    cond, uncond = {"c_crossattn": ctx[:1]}, {"c_crossattn": uc[:1]}
    torch.cuda.synchronize()
    with conv_flags():
        reset_counts()
        t0 = time.perf_counter()
        with torch.inference_mode():
            z0 = ld.encode_first_stage(image)
            noise = torch.randn(z0.shape, device="cuda", generator=gen)
            zt = stochastic_encode(ld.schedule, sched, z0, t_enc, noise)
        z = ddim_decode(ld.denoise_fn(), zt, sched, t_enc, cond, uncond, 7.5)
        with torch.inference_mode():
            img = ld.decode_first_stage(z)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    kinds = {attn_kernel(k[4], k[3]) for k in counts["attn"]}
    finite = bool(torch.isfinite(img).all())
    moved = (img.float() - image.float()).abs().max().item()
    ok = (finite and tuple(img.shape) == (1, 3, 512, 512) and K1 in kinds
          and K3 in kinds and sum(counts["gn"].values()) > 0)
    log(f"img2img: encode, stochastic_encode to step {t_enc} of "
        f"{PTP_STEPS}, ddim_decode {t_enc} steps at CFG 7.5, decode: image "
        f"{tuple(img.shape)} finite={finite}, max|out - in| = {moved:.3e}; "
        f"wall {wall:.2f}s (first run); launches K1 "
        f"{sum(v for k, v in counts['attn'].items() if k[4] <= 96)}, K3 "
        f"{sum(v for k, v in counts['attn'].items() if attn_kernel(k[4], k[3]) == K3)}"
        f", K4 {sum(counts['gn'].values())}, K7 "
        f"{sum(counts['conv'].values())}; {'OK' if ok else 'FAIL'}")
    log_counts("img2img", counts)

    x = torch.randn(1, 4, 64, 64, device="cuda", generator=gen)
    t = sched.timesteps[PTP_STEPS - 1 - PTP_STEP_HELD].expand(1).cuda()
    scale = 7.5
    calls = (
        ("augmented_cfg_eps (scale 7.5)", abs(1 - scale)
         + abs(scale * (1 - scale)) + scale * scale,
         lambda fn: augmented_cfg_eps(fn, x, t, cond, {"c_crossattn":
                                                       ctx[1:]}, uncond,
                                      scale)),
        ("composable_cfg_eps (2 prompts)", 3.0,
         lambda fn: composable_cfg_eps(fn, x, t, {"c_crossattn": ctx},
                                       uncond, 2)))
    eps_ok = True
    for label, weight, call in calls:
        seen = []

        def fn(xx, tt, c):
            e = ld.denoise_fn()(xx, tt, c)
            seen.append(e)
            return e

        with torch.inference_mode(), conv_flags():
            on = call(fn)
            with plain_path():
                off = call(fn)
            torch.cuda.synchronize()
        err = (on - off).abs().max().item()
        eps_max = seen[1].abs().max().item()
        lim = UNET_TOL * weight * eps_max
        good = (math.isfinite(err) and err <= lim and _rel(seen[0], seen[1])
                <= UNET_TOL and bool(torch.isfinite(on).all()))
        eps_ok = eps_ok and good
        log(f"img2img: {label} [1,4,64,64] (batch {seen[0].shape[0]}), conv "
            f"flags on: kernels on vs plain max|d| = {err:.3e} (tol "
            f"{lim:.3e}: {UNET_TOL} x {weight:g}, the sum of the weights, x "
            f"max|eps| {eps_max:.3e}), the batched eps max|d|/max|ref| = "
            f"{_rel(seen[0], seen[1]):.3e} (tol {UNET_TOL}); "
            f"{'OK' if good else 'FAIL'}")
    torch.cuda.empty_cache()
    return ok and eps_ok, counts


def phase_ancestral(ld, ctx):
    """``p_sample_loop`` over the model's full T = 1,000 at batch 1 on a
    32^2 latent (256^2, factor 1's size), no CFG (the ``log_images`` use),
    the base prompt's context, then a 256^2 decode, conv flags on: the
    ancestral path's counted run.  Checks the image finite and that K1 at
    [1,8,1024,40], K2 and K4 launched."""
    import torch
    from fgdm_tpu_torch.sampling.ancestral import p_sample_loop

    gen = torch.Generator(device="cuda").manual_seed(14)
    T = ld.schedule.num_timesteps
    torch.cuda.synchronize()
    with conv_flags():
        reset_counts()
        t0 = time.perf_counter()
        z, _ = p_sample_loop(ld.denoise_fn(), (1, 4, 32, 32), ld.schedule,
                             {"c_crossattn": ctx[:1]}, generator=gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.inference_mode():
            img = ld.decode_first_stage(z)
        torch.cuda.synchronize()
        counts = read_counts()
    finite = bool(torch.isfinite(img).all())
    k1 = counts["attn"].get((1, 8, 1024, 1024, 40, False, "bfloat16"), 0)
    k2 = sum(v for k, v in counts["attn"].items()
             if attn_kernel(k[4], k[3]) == K2)
    n_gn = sum(counts["gn"].values())
    ok = (finite and tuple(img.shape) == (1, 3, 256, 256) and k1 > 0
          and k2 > 0 and n_gn > 0)
    log(f"ancestral: p_sample_loop T={T} [1,4,32,32], decode 256^2: image "
        f"{tuple(img.shape)} finite={finite} std="
        f"{img.float().std().item():.4e}; wall {t1 - t0:.2f}s sampling "
        f"({1e3 * (t1 - t0) / T:.2f} ms a step, host clock), "
        f"{time.perf_counter() - t1:.2f}s decode; launches K1 [1,8,1024,40] "
        f"{k1}, K2 {k2}, K4 {n_gn}, K7 {sum(counts['conv'].values())}; "
        f"{'OK' if ok else 'FAIL'}")
    log_counts("ancestral", counts)
    return ok, counts


def phase_tiled(ld):
    """``tiled_decode`` of a 128^2 latent (a 1024^2 image: 9 tiles of 64^2,
    overlap 16, one VAE decode at batch 9 of 512^2), then ``tiled_encode``
    of that image (9 tiles of 512^2, overlap 128), conv flags on: the tiled
    path's counted run.  Checks shapes and finiteness, that K3 launched at
    [9,1,4096,512], K4 at [9,128,512,512] and [9,256,512,512], K7 at batch
    9; then the output where tile (0, 0) alone covers it (its window
    normalises to 1) against ``ld.decode_first_stage`` of that tile."""
    import torch
    from fgdm_tpu_torch.sampling.tiled import tiled_decode, tiled_encode

    gen = torch.Generator(device="cuda").manual_seed(15)
    z = torch.randn(1, 4, 128, 128, device="cuda", generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with conv_flags():
        reset_counts()
        t0 = time.perf_counter()
        img = tiled_decode(ld, z)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lat = tiled_encode(ld, img)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = read_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        with torch.inference_mode():
            alone = ld.decode_first_stage(z[:, :, :64, :64])
    finite = bool(torch.isfinite(img).all() and torch.isfinite(lat).all())
    k3 = counts["attn"].get((9, 1, 4096, 4096, 512, False, "bfloat16"), 0)
    gn9 = {c: counts["gn"].get(((9, c, 512, 512), 1e-6), 0)
           for c in (128, 256)}
    k7 = sum(v for k, v in counts["conv"].items() if k[0] == 9)
    rel = _rel(img[:, :, :384, :384], alone[:, :, :384, :384])
    ok = (finite and tuple(img.shape) == (1, 3, 1024, 1024)
          and tuple(lat.shape) == (1, 4, 128, 128) and k3 > 0
          and all(gn9.values()) and k7 > 0 and rel <= UNET_TOL)
    log(f"tiled: tiled_decode [1,4,128,128] -> {tuple(img.shape)} in "
        f"{t1 - t0:.2f}s, tiled_encode -> {tuple(lat.shape)} in "
        f"{t2 - t1:.2f}s (first runs), finite={finite}, peak memory "
        f"{peak_gib:.2f} GiB; the corner one tile alone covers [:384,:384] "
        f"against decode_first_stage of that tile max|d|/max|ref| = "
        f"{rel:.3e} (tol {UNET_TOL}); launches K3 [9,1,4096,512] {k3}, K4 "
        f"[9,128|256,512,512] {gn9[128]}|{gn9[256]}, K7 at batch 9 {k7}; "
        f"{'OK' if ok else 'FAIL'}")
    log_counts("tiled", counts)
    del img, lat, alone
    torch.cuda.empty_cache()
    return ok, counts


def _card_vs_cpu(module, *args):
    """``module`` on the card and a copy of it on the CPU, float32 (TF32
    off), on the same inputs: (card output, max|d|/max|ref|)."""
    import copy

    import torch

    cpu = copy.deepcopy(module).to("cpu")
    with torch.no_grad():
        on = module(*args)
        off = cpu(*(a.cpu() for a in args))
    return on, _rel(on.cpu(), off)


def _timed(fn, reps=3):
    """(result, ms a call): the host's clock around ``reps`` synchronised
    calls after one warm-up call."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / reps * 1e3


def phase_library():
    """The library modules no product path runs, at the reference's widths
    on seeded weights: VQModel at JAX's defaults (ch 128, ch_mult (1,2,4,4),
    16,384 codes of 4) at batch 4, 256^2, bf16, conv flag on (encode,
    quantize, decode: K2 at the mid-blocks, K7 at the 64^2 and 32^2 convs);
    LPIPS at 256^2, batch 4, bf16, conv flag on (K7 at the VGG's conv3-5)
    and one ``generator_loss`` with a ``PatchDiscriminator`` (ndf 64) and
    its gradients; AdapterLight (320, 640, 1280, 1280) on a 512^2 image;
    AttentionPool2d; BERTEmbedder at 1280 x 32 layers on 77 tokens;
    FrozenClipImageEmbedder at ViT-L/14; MLSDdetector at 512^2 (the net's
    and the host stages' times); CannyDetector and sobel_edges at 512^2.
    Counts are reset just before the counted run of the kernel users (VQ,
    LPIPS and the generator loss, the light adapter) and read just after;
    then the kernel users kernels on vs plain (VQ's f32 encode and indices
    at 256^2, its mid-blocks on K2's float32 kernel, card vs CPU, differing indices only at near-ties: the two codes'
    distances to the CPU's latent within 1e-5 * max(1, max distance)), and
    the modules without a kernel in float32 card vs CPU."""
    import copy

    import numpy as np
    import torch
    from fgdm_tpu_torch.annotators.canny import CannyDetector, sobel_edges
    from fgdm_tpu_torch.annotators.mlsd import (MLSDdetector,
                                                MobileV2MLSDLarge,
                                                decode_lines)
    from fgdm_tpu_torch.diffusion.perceptual_losses import (
        LPIPS, PatchDiscriminator, generator_loss)
    from fgdm_tpu_torch.models.adapter import AdapterLight
    from fgdm_tpu_torch.models.encoders import (BERTEmbedder,
                                                FrozenClipImageEmbedder)
    from fgdm_tpu_torch.models.vq import VQModel
    from fgdm_tpu_torch.nn.attention import AttentionPool2d

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(17)
    torch.manual_seed(17)
    vq = VQModel(dtype=bf16).requires_grad_(False).eval()
    with torch.no_grad():       # codes spread like the latents
        vq.quantize.embedding.weight.normal_(0.0, 0.5, generator=gen)
    lpips = LPIPS(dtype=bf16).requires_grad_(False).eval()
    disc = PatchDiscriminator(ndf=64, dtype=bf16)
    light = AdapterLight(dtype=bf16).to("cuda").requires_grad_(False).eval()
    x = torch.rand(4, 3, 256, 256, device="cuda", generator=gen) * 2 - 1
    y = (x + 0.2 * torch.randn(x.shape, device="cuda", generator=gen)
         ).clamp(-1, 1)
    img512 = torch.rand(1, 3, 512, 512, device="cuda", generator=gen)
    msgs, ok = [], True

    def counted():
        with torch.no_grad():
            z_q, emb_loss, idx = vq.encode(x)
            rec = vq.decode(z_q)
            d = lpips(x, y)
            feats = light(img512)
        r = rec.detach().float().requires_grad_(True)
        loss, _ = generator_loss(x, r, lpips, disc_fn=disc,
                                 codebook_loss=emb_loss)
        loss.backward()
        return z_q, emb_loss, idx, rec, d, feats, loss, r.grad

    with conv_flags():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        z_q, emb_loss, idx, rec, d, feats, loss, grad = counted()
        torch.cuda.synchronize()
        counted_s = time.perf_counter() - t0
        counts = read_counts()
        disc_grads = [p.grad.clone() for p in disc.parameters()]
        disc.zero_grad()
        with torch.no_grad():
            _, vq_ms = _timed(lambda: vq.decode(vq.encode(x)[0]))
            _, lpips_ms = _timed(lambda: lpips(x, y))
            _, light_ms = _timed(lambda: light(img512))
            h_on = vq.encode_pre_quant(x)
            rec_on = vq.decode(z_q)
        with plain_path(), torch.no_grad():
            h_off = vq.encode_pre_quant(x)
            rec_off = vq.decode(z_q)
            d_off = lpips(x, y)
            feats_off = light(img512)
        with plain_path():
            r = rec.detach().float().requires_grad_(True)
            loss_off, _ = generator_loss(x, r, lpips, disc_fn=disc,
                                         codebook_loss=emb_loss)
            loss_off.backward()
            grad_off = r.grad
        disc_grads_off = [p.grad.clone() for p in disc.parameters()]
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (z_q, rec, d, loss, grad, *feats, *disc_grads))
    rels = {"VQ encode": _rel(h_on, h_off), "VQ decode": _rel(rec_on, rec_off),
            "LPIPS": _rel(d, d_off),
            "generator loss": _rel(loss.detach(), loss_off.detach()),
            "d loss / d recon": _rel(grad, grad_off),
            "discriminator grads": max(_rel(a, b) for a, b in
                                       zip(disc_grads, disc_grads_off)),
            "AdapterLight": max(_rel(a, b) for a, b in zip(feats,
                                                            feats_off))}
    n = {k: sum(c.values()) for k, c in counts.items()}
    k2 = any(attn_kernel(k[4], k[3]) == K2 for k in counts["attn"])
    good = (finite and k2 and n["conv"] > 0 and n["prepass"] > 0
            and all(math.isfinite(v) and v <= UNET_TOL
                    for v in rels.values())
            and tuple(rec.shape) == (4, 3, 256, 256)
            and tuple(idx.shape) == (4, 32, 32)
            and [tuple(f.shape[1:]) for f in feats] == [
                (320, 64, 64), (640, 32, 32), (1280, 16, 16), (1280, 8, 8)])
    ok &= good
    msgs.append(
        f"counted run (VQ encode/quantize/decode, LPIPS, generator_loss + "
        f"backward, AdapterLight; first calls) {counted_s:.2f}s; VQ "
        f"[4,3,256,256] bf16 {vq_ms:.2f} ms, LPIPS {lpips_ms:.2f} ms, "
        f"AdapterLight [1,3,512,512] {light_ms:.2f} ms a batch (host clock);"
        f" kernels on vs plain max|d|/max|ref|: " + ", ".join(
            f"{k} {v:.3e}" for k, v in rels.items())
        + f" (tol {UNET_TOL}); launches K2 {k2}, K7 {n['conv']}, pre-pass "
        f"{n['prepass']}, K4 {n['gn']}; {'OK' if good else 'FAIL'}")

    # VQ in float32: the card (TF32 off) against the CPU, batch 1 at the
    # reference's 256^2 (32^2 latents: the mid-blocks' N = 1024 takes K2's
    # float32 kernel)
    x = x[:1].contiguous()
    k2_before = sum(v for k, v in _counters()["attn"].items()
                    if k[-1] == "float32" and k[4] == 512)
    torch.manual_seed(18)
    vq32 = VQModel().requires_grad_(False).eval()
    with torch.no_grad():
        vq32.quantize.embedding.weight.normal_(0.0, 0.5, generator=gen)
        vq_cpu = copy.deepcopy(vq32).to("cpu")
        h_card = vq32.encode_pre_quant(x)
        h_cpu = vq_cpu.encode_pre_quant(x.cpu())
        rel_h = _rel(h_card.cpu(), h_cpu)
        idx_card = vq32.quantize(h_card)[2].cpu()
        zq_cpu, _, idx_cpu = vq_cpu.quantize(h_cpu)
        rec_cpu = vq_cpu.decode(zq_cpu)
        rec_card = vq32.decode(zq_cpu.cuda())
    flat = h_cpu.permute(0, 2, 3, 1).reshape(-1, 4).double()
    cb = vq_cpu.quantize.embedding.weight.double()
    dist = torch.cdist(flat, cb) ** 2
    a, b = idx_card.reshape(-1), idx_cpu.reshape(-1)
    diff = (a != b).nonzero().reshape(-1)
    gap = (dist[diff, a[diff]] - dist[diff, b[diff]]).abs()
    ties_ok = bool((gap <= 1e-5 * max(1.0, dist.max().item())).all())
    rel_rec = _rel(rec_card.cpu(), rec_cpu)
    k2_f32 = sum(v for k, v in _counters()["attn"].items()
                 if k[-1] == "float32" and k[4] == 512) - k2_before
    good = (rel_h <= EVAL_TOL and ties_ok and rel_rec <= EVAL_TOL
            and k2_f32 > 0)
    ok &= good
    msgs.append(f"VQ f32 card vs CPU [1,3,256,256]: latents max|d|/max|ref| "
                f"{rel_h:.3e}, decode {rel_rec:.3e} (tol {EVAL_TOL}); indices "
                f"{len(diff)} of {a.numel()} differ, all near-ties {ties_ok}; "
                f"K2 float32 launches {k2_f32}; {'OK' if good else 'FAIL'}")
    del vq, vq32, vq_cpu, lpips, disc, light
    torch.cuda.empty_cache()

    # the modules without a kernel: float32 on the card against the CPU
    torch.manual_seed(19)
    pool = AttentionPool2d(8, 2048, 64, output_dim=1024).to("cuda")
    pool.requires_grad_(False).eval()
    fmap = torch.randn(4, 2048, 8, 8, device="cuda", generator=gen)
    out, rel = _card_vs_cpu(pool, fmap)
    with torch.no_grad():
        _, pool_ms = _timed(lambda: pool(fmap))
    good = rel <= EVAL_TOL and tuple(out.shape) == (4, 1024)
    ok &= good
    msgs.append(f"AttentionPool2d [4,2048,8,8] -> {tuple(out.shape)}: card "
                f"vs CPU {rel:.3e}, {pool_ms:.2f} ms; "
                f"{'OK' if good else 'FAIL'}")
    bert = BERTEmbedder().requires_grad_(False).eval()
    ids = torch.randint(0, 30522, (4, 77), device="cuda", generator=gen)
    out, rel = _card_vs_cpu(bert, ids[:1])
    with torch.no_grad():
        _, bert_ms = _timed(lambda: bert(ids))
    good = rel <= EVAL_TOL and tuple(out.shape) == (1, 77, 1280)
    ok &= good
    msgs.append(f"BERTEmbedder 1280 x 32 layers [1,77]: card vs CPU "
                f"{rel:.3e}; batch 4 {bert_ms:.2f} ms; "
                f"{'OK' if good else 'FAIL'}")
    del bert
    torch.cuda.empty_cache()
    clip = FrozenClipImageEmbedder().requires_grad_(False).eval()
    out, rel = _card_vs_cpu(clip, y[:1])
    with torch.no_grad():
        _, clip_ms = _timed(lambda: clip(y))
    good = rel <= EVAL_TOL and tuple(out.shape) == (1, 768)
    ok &= good
    msgs.append(f"FrozenClipImageEmbedder ViT-L/14 [1,3,256,256]: card vs "
                f"CPU {rel:.3e}; batch 4 {clip_ms:.2f} ms; "
                f"{'OK' if good else 'FAIL'}")
    del clip
    torch.cuda.empty_cache()

    # MLSD and Canny at 512^2 on one seeded image
    rng = np.random.default_rng(20)
    photo = rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
    photo[96:400, 128:136] = 255
    photo[300:308, 40:480] = 0
    det = MLSDdetector(MobileV2MLSDLarge())
    inp, resize_ms = _timed(lambda: det.net_input(photo))
    tp, net_ms = _timed(lambda: det.tp_map(inp))
    lines, decode_ms = _timed(lambda: decode_lines(tp))
    drawn, draw_ms = _timed(lambda: det.draw(lines, 512, 512))
    _, rel = _card_vs_cpu(det.model, torch.from_numpy(inp).permute(
        2, 0, 1)[None].cuda())
    full = det(photo)
    # seeded weights make no line: the host stages again on a seeded map
    # whose 40 centres do
    tp_seeded = rng.normal(-4.0, 1.0, (256, 256, 9)).astype(np.float32)
    for cy, cx in rng.integers(0, 256, (40, 2)):
        tp_seeded[cy, cx, 0] = 3.0
        tp_seeded[cy, cx, 1:5] = rng.uniform(-40.0, 40.0, 4)
    segs, segs_ms = _timed(lambda: decode_lines(tp_seeded))
    seg_map, seg_draw_ms = _timed(lambda: det.draw(segs, 512, 512))
    good = (rel <= EVAL_TOL and tp.shape == (256, 256, 9)
            and full.shape == (512, 512) and np.array_equal(full, drawn)
            and len(segs) > 0 and seg_map.max() == 255)
    ok &= good
    msgs.append(f"MLSDdetector 512^2: resize {resize_ms:.2f} ms, net "
                f"{net_ms:.2f} ms, decode {decode_ms:.2f} ms ({len(lines)} "
                f"lines), draw {draw_ms:.2f} ms an image (host clock); on "
                f"the seeded map decode {segs_ms:.2f} ms ({len(segs)} "
                f"lines), draw {seg_draw_ms:.2f} ms ({int((seg_map > 0).sum())}"
                f" pixels); net card vs CPU {rel:.3e}; "
                f"{'OK' if good else 'FAIL'}")
    edges, canny_ms = _timed(lambda: CannyDetector()(photo, 100, 200))
    img = torch.from_numpy(photo).permute(2, 0, 1)[None].float() / 127.5 - 1
    sob, sobel_ms = _timed(lambda: sobel_edges(img.cuda()))
    sob_cpu = sobel_edges(img)
    flips = int((sob.cpu() != sob_cpu).sum())
    good = (edges.shape == (512, 512) and edges.max() == 255
            and flips <= sob_cpu.numel() // 1000)
    ok &= good
    msgs.append(f"CannyDetector 512^2 {canny_ms:.2f} ms (host), sobel_edges "
                f"{sobel_ms:.3f} ms (card), card vs CPU {flips} of "
                f"{sob_cpu.numel()} pixels differ (at most 0.1 %); "
                f"{'OK' if good else 'FAIL'}")
    for m in msgs:
        log("library: " + m)
    log_counts("library", counts)
    del det
    torch.cuda.empty_cache()
    return ok, counts


def sweep_k1(gen):
    """K1 at the planned tile (*) and at every tile the kernel takes (keys
    per tile, ring stages, consumer warpgroups) at the ``K1_SWEEP`` shapes,
    each held against the plain version; device times.  Returns the number
    of failures."""
    import torch
    from fgdm_tpu_torch.kernels import attention

    bad = 0
    for b, h, n, d in K1_SWEEP:
        q, k, v = (torch.randn(b, h, n, d, device="cuda", generator=gen,
                               dtype=torch.bfloat16) for _ in range(3))
        scale = d ** -0.5
        ref = attention.attention_ref(q, k, v, scale)
        lim = ATTN_TOL[0] * ref.float().abs().max().item() + ATTN_TOL[1]
        planned = attention.flash_fwd_plan(b * h, n, n, d)
        plans = [planned]
        for bn, wgs, stages in itertools.product(
                attention._K1_BNS, attention._K1_WGS,
                range(2, attention._K1_MAX_STAGES + 1)):
            try:
                plan = attention.k1_tile(b * h, n, n, d, bn, stages, wgs)
            except ValueError:
                continue   # more shared memory than a block has
            if plan != planned:
                plans.append(plan)
        msgs = []
        for plan in plans:
            out = attention._flash_k1(q, k, v, scale, False, plan)[0]
            err = (out.float() - ref.float()).abs().max().item()
            ok = math.isfinite(err) and err <= lim
            bad += not ok
            ms = graph_ms(lambda: attention._flash_k1(q, k, v, scale, False,
                                                      plan), 20)
            msgs.append(f"{plan.bn}x{plan.stages}x{plan.wgs}"
                        f"{'*' if plan is planned else ''} {ms:.4f} ms "
                        f"{'OK' if ok else 'FAIL'}")
        log(f"flash_attn_fwd d{d} [{b},{h},{n}] (keys x stages x "
            f"warpgroups): " + "; ".join(msgs))
        del ref
        torch.cuda.empty_cache()
    return bad


def sweep_bwd(gen):
    """K5 and K6 at the planned tile (*) and at every tile each kernel takes
    (streamed tile, ring stages, consumer warpgroups) at the ``BWD_CASES``
    shapes, each held against the plain version; device times.  Returns the
    number of failures."""
    import torch
    from fgdm_tpu_torch.kernels import attention

    bad = 0
    for suffix, b, h, nq, nk, d, _ in BWD_CASES:
        q, k, v, do, o, lse, delta, scale = bwd_inputs(gen, b, h, nq, nk, d)
        refs = attention.attention_bwd_ref(q, k, v, o, lse, do, scale)
        planned = attention.flash_bwd_plan(b * h, nq, nk, d)
        for i, (kernel, run) in enumerate((("dq", attention._flash_k5),
                                           ("dkv", attention._flash_k6))):
            plans = [planned[i]]
            for bt, wgs, stages in itertools.product(
                    attention._BWD_TILES[kernel], attention._BWD_WGS,
                    range(2, attention._BWD_MAX_STAGES + 1)):
                try:
                    plan = attention.bwd_tile(kernel, b * h, nq, nk, d, bt,
                                              stages, wgs)
                except ValueError:
                    continue   # more shared memory than a block has
                if plan != planned[i]:
                    plans.append(plan)
            msgs = []
            for plan in plans:
                got = run(q, k, v, do, lse, delta, scale, plan)
                got = (got, None, None) if kernel == "dq" else (None, *got)
                errs = bwd_errors(got, refs)
                ok = all(math.isfinite(e) and e <= lim
                         for e, lim in errs.values())
                bad += not ok
                ms = graph_ms(lambda: run(q, k, v, do, lse, delta, scale,
                                          plan), 10)
                msgs.append(f"{plan.bt}x{plan.stages}x{plan.wgs}"
                            f"{'*' if plan is planned[i] else ''} {ms:.4f} ms "
                            f"{'OK' if ok else 'FAIL'}")
            log(f"flash_attn_bwd_{kernel} {suffix} (tile x stages x "
                f"warpgroups): " + "; ".join(msgs))
        del refs
        torch.cuda.empty_cache()
    return bad


def sweep_k4(gen):
    """K4 at the planned launch (*) and at every other cluster size k and
    share of an SM (blocks an SM's shared memory is cut for, ``per_sm``)
    that gives another plan and whose clusters schedule, at the
    ``GN_CASES`` shapes, the served batch's [8,320,64,64] (the most K4 time
    of a served batch) and the chain's streamed [1,256,512,512], each held
    against the plain version; device times.  Returns the number of
    failures."""
    import torch
    from fgdm_tpu_torch.kernels import groupnorm

    bad = 0
    cases = [(shape, eps) for _, shape, eps, _ in GN_CASES]
    for shape, eps in cases + [((8, 320, 64, 64), 1e-5),
                               ((1, 256, 512, 512), 1e-6)]:
        x = torch.randn(shape, device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        w = 1 + 0.1 * torch.randn(shape[1], device="cuda", generator=gen)
        b = 0.1 * torch.randn(shape[1], device="cuda", generator=gen)
        ref = groupnorm.group_norm_silu_ref(x, w, b, 32, eps, True).float()
        planned = groupnorm.card_plan(shape, x.dtype, 32)
        msgs, seen = [], set()
        for k, per_sm in itertools.product(groupnorm._CLUSTERS, (1, 2, 3, 4)):
            plan = groupnorm.gn_tile(shape, x.dtype, 32, k, per_sm)
            if plan._replace(per_sm=0) in seen:
                continue   # another share gives the same launch
            seen.add(plan._replace(per_sm=0))
            active = groupnorm.max_active_clusters(x.dtype, plan)
            if active < 1:
                msgs.append(f"{k}x{per_sm} does not schedule")
                continue
            out = groupnorm._launch(x, w, b, 32, eps, True, plan)
            rel = ((out.float() - ref).abs() / (1 + ref.abs())).max().item()
            ok = math.isfinite(rel) and rel <= GN_TOL
            bad += not ok
            ms = graph_ms(lambda: groupnorm._launch(x, w, b, 32, eps, True,
                                                    plan), 20)
            star = plan._replace(per_sm=0) == planned._replace(per_sm=0)
            msgs.append(f"{k}x{per_sm}{'*' if star else ''} "
                        f"({active} clusters at once"
                        f"{', streams' if plan.streams else ''}) {ms:.4f} ms "
                        f"{'OK' if ok else 'FAIL'}")
        log(f"group_norm_silu [{','.join(map(str, shape))}] (cluster size x "
            f"blocks an SM): " + "; ".join(msgs))
        del x, ref
        torch.cuda.empty_cache()
    return bad


def sweep():
    """K1 at each tile choice (``sweep_k1``), K5 and K6 at each tile choice
    (``sweep_bwd``), K4 at each cluster size (``sweep_k4``) and its
    wrapper's host cost (``gn_host_costs``), K7's ``wgmma`` kernel alone (no
    pre-pass) at the planned tile (*) and at each forced size, and the d =
    512 forward at forced KV slice counts; each held against its plain
    version, device times."""
    import torch
    from fgdm_tpu_torch.kernels import attention, conv

    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = sweep_k1(gen) + sweep_bwd(gen) + sweep_k4(gen)
    gn_host_costs()
    for n, c, co, h, w in CONV_CASES + RAGGED_CONV_CASES:
        x = torch.randn(n, c, h, w, device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        wt = torch.randn(co, c, 3, 3, device="cuda", generator=gen) \
            * (9 * c) ** -0.5
        b = 0.1 * torch.randn(co, device="cuda", generator=gen)
        ref = conv.conv3x3_ref(x, wt, b)
        lim = CONV_TOL[0] * ref.float().abs().max().item() + CONV_TOL[1]
        xt, (wk, bias) = conv.nchw_to_nhwc(x), conv.packed_weight(wt, b)
        planned = conv.conv3x3_plan(n, c, co, h, w)
        msgs = []
        for plan in (planned, conv._tile(n, c, co, h, w, 64),
                     conv._tile(n, c, co, h, w, 128)):
            out = conv._launch(xt, wk, bias, co, plan)
            err = (out.float() - ref.float()).abs().max().item()
            ok = math.isfinite(err) and err <= lim
            bad += not ok
            ms = graph_ms(lambda: conv._launch(xt, wk, bias, co, plan), 20)
            msgs.append(f"{plan.bm}{'*' if plan is planned else ''} slots "
                        f"{plan.grid[0] * plan.grid[1]} blocks {ms:.4f} ms "
                        f"{'OK' if ok else 'FAIL'}")
        log(f"conv3x3 [{n},{c},{h},{w}]->{co}: " + "; ".join(msgs))
    for b, n in ((1, 1024), (1, 4096), (8, 1024)):
        q, k, v = (torch.randn(b, 1, n, 512, device="cuda", generator=gen,
                               dtype=torch.bfloat16) for _ in range(3))
        scale = 512 ** -0.5
        ref = attention.attention_ref(q, k, v, scale)
        lim = ATTN_TOL[0] * ref.float().abs().max().item() + ATTN_TOL[1]
        tiles = n // attention._D512_BN
        msgs = []
        for splits in (None, 1, 2, 3, 4, 6, 8, 11, 16):
            if splits and -(-tiles // -(-tiles // splits)) != splits:
                continue   # the last slices would be empty
            out = attention.flash_attention(q, k, v, scale, splits=splits)
            err = (out.float() - ref.float()).abs().max().item()
            ok = math.isfinite(err) and err <= lim
            bad += not ok
            ms = graph_ms(lambda: attention.flash_attention(
                q, k, v, scale, splits=splits), 20)
            msgs.append(f"{splits or attention.kv_splits(b, n, n)}"
                        f"{'' if splits else '*'} slices {ms:.4f} ms "
                        f"{'OK' if ok else 'FAIL'}")
        log(f"flash_attn_fwd d512 [{b},1,{n},512]: " + "; ".join(msgs))
    log("FAILED" if bad else "sweep OK")
    return 1 if bad else 0


PAR_RING = (2, 8, 4096, 40)        # the factor-2 self-attention
PAR_ENGINE_STEPS = (20, 10)        # the mesh engine's f1 and f2 steps
PAR_WIDTHS = (2, 4, 8)             # ranks count_fsdp/count_sharded read
CP_STEPS = 50
# the served batch's K7 shapes (n, c, co, h, w): kernels/conv.py's list
WINO_CASES = [(8, 960, 320, 32, 32), (8, 2560, 1280, 16, 16),
              (8, 1920, 640, 32, 32), (8, 640, 640, 64, 64),
              (8, 960, 320, 64, 64), (8, 640, 320, 64, 64)]


def merge_counts(*parts):
    """{kind: {key: launches}} summed over several counted runs."""
    out = {}
    for part in parts:
        for kind, c in part.items():
            dst = out.setdefault(kind, {})
            for k, v in c.items():
                dst[k] = dst.get(k, 0) + v
    return out


def _step_grads(step_fn, state, batch, draws):
    """One train step's metrics and its averaged gradients (gathered whole),
    the optimizer step skipped, so every variant starts from the same
    weights."""
    from fgdm_tpu_torch.train.state import _full

    grads = {}

    def capture():
        for k, p in state.params.items():
            grads[k] = _full(p.grad).float()
            p.grad = None
        return state

    state.apply_gradients = capture
    try:
        _, m = step_fn(state, batch, None, t=draws[0], noise=draws[1],
                       posterior_eps=draws[2])
    finally:
        del state.apply_gradients
    return {k: v.item() for k, v in m.items()}, grads


def phase_parallel():
    """The data-, tensor- and context-parallel paths and the mesh engine on
    a one-rank NCCL group (see the module's docstring, item 7)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from fgdm_tpu_torch.builders import build_chain, build_trainer
    from fgdm_tpu_torch.checkpoint.loader import sd_unet
    from fgdm_tpu_torch.core.schedules import DDIMSchedule
    from fgdm_tpu_torch.kernels.attention import attention_ref
    from fgdm_tpu_torch.parallel import context as cp
    from fgdm_tpu_torch.parallel.fsdp import count_fsdp, shard_state_fsdp
    from fgdm_tpu_torch.parallel.mesh import create_mesh
    from fgdm_tpu_torch.parallel.ring_attention import ring_attention
    from fgdm_tpu_torch.parallel.tp import count_sharded, shard_params_tp
    from fgdm_tpu_torch.sampling.ddim import ddim_sample
    from fgdm_tpu_torch.serving import ChainEngine
    from fgdm_tpu_torch.train.train_step import make_train_step

    msgs, ok = [], True
    mesh = create_mesh(device_type="cuda")
    msgs.append(f"a {dist.get_backend()} group of {dist.get_world_size()} "
                "rank (one card is a world of one: halos, ring rotation and "
                "sharded gradients at world 2 are tests/test_torch_parallel"
                ".py's, on gloo)")
    try:
        # -- the training steps: plain, then DP, TP and FSDP (counted) ------
        tr = build_trainer(device="cuda", seed=0, batch=TRAIN_BATCH)
        ld, state, batch = tr.ld, tr.state, tr.batch
        gen = torch.Generator(device="cuda").manual_seed(31)
        b = batch["image"].shape[0]
        draws = (torch.randint(0, 1000, (b,), device="cuda", generator=gen),
                 torch.randn(b, 4, 32, 32, device="cuda", generator=gen),
                 torch.randn(b, 4, 32, 32, device="cuda", generator=gen))

        def timed(fn, st, reps=3):
            out = _step_grads(fn, st, batch, draws)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                _step_grads(fn, st, batch, draws)
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) / reps * 1e3

        (m0, g0), plain_ms = timed(make_train_step(ld), state)
        dp_fn = make_train_step(ld, mesh=mesh)
        _, dp_ms = timed(dp_fn, state)
        reset_counts()
        m_dp, g_dp = _step_grads(dp_fn, state, batch, draws)
        n_tp = count_sharded(mesh, ld.unet)[0]
        shard_params_tp(mesh, ld.unet)
        m_tp, g_tp = _step_grads(dp_fn, state, batch, draws)
        fstate = shard_state_fsdp(mesh, state)
        n_dt = sum(hasattr(p, "placements") for p in fstate.params.values())
        m_fs, g_fs = _step_grads(dp_fn, fstate, batch, draws)
        torch.cuda.synchronize()
        counts = read_counts()
        _, fsdp_ms = timed(dp_fn, fstate)
        for label, m, g, exact in (("DP", m_dp, g_dp, True),
                                   ("TP", m_tp, g_tp, True),
                                   ("FSDP", m_fs, g_fs, False)):
            err = max((g[k] - g0[k]).abs().max().item() for k in g0)
            scale = max(v.abs().max().item() for v in g0.values())
            loss_rel = abs(m["loss"] - m0["loss"]) / abs(m0["loss"])
            good = (set(g) == set(g0) and scale > 0 and (
                (err == 0 and m["loss"] == m0["loss"]) if exact else
                (err <= UNET_TOL * scale and loss_rel <= LOSS_TOL)))
            ok &= good
            msgs.append(
                f"{label} step vs plain: grads max|d| {err:.3e} (max|ref| "
                f"{scale:.3e}), loss {m['loss']:.6f} vs {m0['loss']:.6f}, "
                f"grad_norm {m['grad_norm']:.6f} vs {m0['grad_norm']:.6f}; "
                + ("bit for bit" if exact else
                   f"tol {UNET_TOL} / loss {LOSS_TOL}")
                + f"; {'OK' if good else 'FAIL'}")
        msgs.append(f"steps (forward + backward + gradient averaging, no "
                    f"optimizer; host clock, 3 each) at batch {TRAIN_BATCH}:"
                    f" plain {plain_ms:.1f} ms, DP {dp_ms:.1f} ms, FSDP "
                    f"{fsdp_ms:.1f} ms; TP at n_model 1 shards "
                    f"{n_tp} weights (the rule's floor is 2 ranks); FSDP "
                    f"manages {n_dt} of {len(fstate.params)} trainable "
                    "leaves")
        del tr, ld, state, fstate, batch, g0, g_dp, g_tp, g_fs
        gc.collect()
        torch.cuda.empty_cache()

        # -- ring attention ------------------------------------------------
        rb, rh, rn, rd = PAR_RING
        q, k, v = (torch.randn(rb, rh, rn, rd, device="cuda", generator=gen,
                               dtype=torch.bfloat16) for _ in range(3))
        scale = rd ** -0.5
        got = ring_attention(q, k, v, None, scale)
        ref = attention_ref(q, k, v, scale)
        err = (got.float() - ref.float()).abs().max().item()
        rmax = ref.float().abs().max().item()
        good = err <= ATTN_TOL[0] * rmax + ATTN_TOL[1]
        ok &= good
        ring_ms = cuda_ms(lambda: ring_attention(q, k, v, None, scale), 5)
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale), 5)
        msgs.append(f"ring_attention {list(PAR_RING)} vs attention_ref: "
                    f"max|d| {err:.3e} (max|ref| {rmax:.3e}); {ring_ms:.3f} "
                    f"ms (f32 online softmax, one block) vs SDPA "
                    f"{sdpa_ms:.3f} ms; {'OK' if good else 'FAIL'}")
        del q, k, v, got, ref

        # -- context-parallel sampling of factor 1, then the mesh engine ----
        ld, cldm = build_chain(device="cuda", seed=0)
        ld_cp = cp.context_parallel_pipeline(ld, None)
        ld_plain = dataclasses.replace(
            ld, unet=cp.shared_clone(ld.unet, None),
            vae=cp.shared_clone(ld.vae, None))
        ctx, uc = (torch.randn(1, 77, 768, device="cuda", generator=gen)
                   for _ in range(2))
        x_T = torch.randn(1, 4, 32, 32, device="cuda", generator=gen)
        reset_counts()
        t0 = time.perf_counter()
        img = cp.sample_context_parallel(ld_cp, None, ctx, uc, (256, 256),
                                         num_steps=CP_STEPS, x_T=x_T)
        torch.cuda.synchronize()
        cp_s = time.perf_counter() - t0
        counts = merge_counts(counts, read_counts())
        t0 = time.perf_counter()
        with plain_path():
            z = ddim_sample(ld_plain.denoise_fn(), x_T.shape,
                            DDIMSchedule.create(ld.schedule, CP_STEPS),
                            {"c_crossattn": ctx}, {"c_crossattn": uc},
                            x_T=x_T)
            with torch.inference_mode():
                ref = ld_plain.decode_first_stage(z)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        rel = _rel(img.float(), ref.float())
        good = (tuple(img.shape) == (1, 3, 256, 256) and math.isfinite(rel)
                and rel <= UNET_TOL)
        ok &= good
        msgs.append(f"sample_context_parallel factor 1 ({CP_STEPS} steps, "
                    f"256^2, fused norms off) vs the plain sampler (fused "
                    f"norms off, plain attention): max|d|/max|ref| "
                    f"{rel:.3e} (tol {UNET_TOL}); {cp_s:.2f} s vs "
                    f"{plain_s:.2f} s (host clock); "
                    f"{'OK' if good else 'FAIL'}")
        del ld_cp, ld_plain, img, ref, z
        kw = dict(max_batch=4, f1_steps=PAR_ENGINE_STEPS[0],
                  f2_steps=PAR_ENGINE_STEPS[1], warmup=False)
        prompts = ["a cat", "a dog on a beach", "two birds", "a red car"]
        plain_out = ChainEngine(ld, cldm, **kw).generate(
            prompts, seeds=list(SERVE_SEEDS))
        engine = ChainEngine(ld, cldm, mesh=mesh, **kw)
        reset_counts()
        t0 = time.perf_counter()
        mesh_out = engine.generate(prompts, seeds=list(SERVE_SEEDS))
        eng_s = time.perf_counter() - t0
        counts = merge_counts(counts, read_counts())
        good = all(np.array_equal(mesh_out[k], plain_out[k])
                   for k in ("images", "conditions"))
        ok &= good
        msgs.append(f"ChainEngine(mesh=) batch 4 ({PAR_ENGINE_STEPS[0]}+"
                    f"{PAR_ENGINE_STEPS[1]} steps) vs the plain engine on "
                    f"the same seeds: images equal {good}, {eng_s:.2f} s; "
                    f"{'OK' if good else 'FAIL'}")
    finally:
        dist.destroy_process_group()
    meta = sd_unet(dtype=torch.float32, device="meta")
    for n in PAR_WIDTHS:
        ns, tot, frac = count_fsdp(n, meta)
        nt, tot_t = count_sharded(n, meta)
        msgs.append(f"SD-1.4 UNet at {n} ranks: count_fsdp {ns}/{tot} "
                    f"leaves ({frac:.1%} of the elements), count_sharded "
                    f"{nt}/{tot_t}")
    for m in msgs:
        log("parallel: " + m)
    log_counts("parallel", counts)
    return ok, counts, ld, cldm


def phase_winograd(ld, cldm):
    """Winograd F(2x2, 3x3) (``kernels/winograd.py``, behind
    ``FGDM_WINOGRAD_CONV``): each served K7 shape against ``F.conv2d`` and
    timed beside cuDNN; the batch-1 chain with the flag on and off."""
    import torch
    import torch.nn.functional as F
    from fgdm_tpu_torch.kernels.winograd import conv3x3_winograd, winograd_ok
    from fgdm_tpu_torch.nn import layers
    from fgdm_tpu_torch.sampling.chain import fgdm_chain

    gen = torch.Generator(device="cuda").manual_seed(41)
    msgs, ok = [], True
    bf16 = torch.bfloat16
    for n, c, co, h, w in WINO_CASES:
        x = torch.randn(n, c, h, w, device="cuda", generator=gen, dtype=bf16)
        wt = (torch.randn(co, c, 3, 3, device="cuda", generator=gen)
              * 0.05).to(bf16)
        bias = torch.randn(co, device="cuda", generator=gen)
        got = conv3x3_winograd(x, wt, bias)
        ref = F.conv2d(x.float(), wt.float(), bias, padding=1)
        rel = _rel(got.float(), ref)
        good = (winograd_ok(x.shape, wt.shape) and got.dtype == bf16
                and rel <= WINO_TOL)
        ok &= good
        wino_ms = cuda_ms(lambda: conv3x3_winograd(x, wt, bias), 5)
        b16 = bias.to(bf16)
        cudnn_ms = cuda_ms(lambda: F.conv2d(x, wt, b16, padding=1), 5)
        msgs.append(f"[{n},{c},{h},{w}] -> {co}: max|d|/max|ref| {rel:.3e} "
                    f"(tol {WINO_TOL}); Winograd {wino_ms:.3f} ms vs cuDNN "
                    f"{cudnn_ms:.3f} ms; {'OK' if good else 'FAIL'}")
        del x, wt, got, ref
    ctxs = [torch.randn(1, 77, 768, device="cuda", generator=gen)
            for _ in range(4)]
    saved = layers._WINOGRAD_CONV
    runs = {}
    try:
        for flag in (True, False):
            layers._WINOGRAD_CONV = flag
            if flag:
                reset_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            with torch.inference_mode():
                out = fgdm_chain(ld, cldm, *ctxs, f1_steps=50, f2_steps=20,
                                 slot_seeds=[1234])
            end.record()
            torch.cuda.synchronize()
            runs[flag] = (out["image"].float(), time.perf_counter() - t0,
                          start.elapsed_time(end))
            if flag:
                counts = read_counts()
    finally:
        layers._WINOGRAD_CONV = saved
    diff = (runs[True][0] - runs[False][0]).abs().max().item()
    good = (bool(torch.isfinite(runs[True][0]).all()) and math.isfinite(diff)
            and sum(counts["gn"].values()) > 0)
    ok &= good
    msgs.append(f"chain batch 1 (50+20 steps): FGDM_WINOGRAD_CONV on "
                f"{runs[True][1]:.3f} s wall / {runs[True][2]:.1f} ms between"
                f" events, off {runs[False][1]:.3f} s / {runs[False][2]:.1f}"
                f" ms (one run each, the chain warm from the phases before); "
                f"image max|d| on vs off {diff:.3e} (values in [-1, 1]); "
                f"{'OK' if good else 'FAIL'}")
    for m in msgs:
        log("winograd: " + m)
    log_counts("winograd", counts)
    return ok, counts


def main():
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    off = switches_off_default()
    if off:
        log(f"chip_smoke: kernel switches set away from their defaults: "
            f"{', '.join(off)}; unset them, so that every kernel runs")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    if sys.argv[1:] not in ([], ["--sweep"]):
        log(f"chip_smoke: unknown arguments {sys.argv[1:]}")
        return 2
    build_kernels()
    if sys.argv[1:]:
        return sweep()
    rows, grad_ok = phase_kernels()
    unet_ok = phase_unet()
    chain_ok, chain, ld, cldm = phase_chain()
    t0 = time.perf_counter()
    conv_ok = phase_conv_forwards(cldm)
    t1 = time.perf_counter()
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir="build")
    try:
        ckpt_ok, paths, ld2, cldm2 = phase_checkpoints(ld, cldm, root)
        del ld, cldm
        gc.collect()
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        cli_ok, cli, maps, f1 = phase_cli(paths, os.path.join(root, "out"))
        seg_ok, seg = phase_seg2image(ld2, cldm2, maps)
        t_detect = time.perf_counter()
        detect_ok, detect, detect0 = phase_detect(paths, root)
        t_guided = time.perf_counter()
        t_detect = t_guided - t_detect
        guided_ok, guided = phase_guided(paths, os.path.join(root, "guided"),
                                         ld2, f1)
        t_guided = time.perf_counter() - t_guided
        del cldm2
        gc.collect()
        torch.cuda.empty_cache()
        t_edit = time.perf_counter()
        ptp_ok, ptp, base_img, ctx, uc = phase_ptp(ld2)
        t_ptp = time.perf_counter()
        img2img_ok, img2img = phase_img2img(ld2, base_img, ctx, uc)
        t_img2img = time.perf_counter()
        ancestral_ok, ancestral = phase_ancestral(ld2, ctx)
        t_ancestral = time.perf_counter()
        tiled_ok, tiled = phase_tiled(ld2)
        t_tiled = time.perf_counter()
        log(f"ptp phase {t_ptp - t_edit:.1f}s, img2img phase "
            f"{t_img2img - t_ptp:.1f}s, ancestral phase "
            f"{t_ancestral - t_img2img:.1f}s, tiled phase "
            f"{t_tiled - t_ancestral:.1f}s")
        del ld2, base_img, ctx, uc
        gc.collect()
        torch.cuda.empty_cache()
        t_chain_n = time.perf_counter()
        chain_n_ok, chain_n = phase_chain_n(paths,
                                            os.path.join(root, "chain_n"))
        t_eval = time.perf_counter()
        t_chain_n = t_eval - t_chain_n
        gc.collect()
        torch.cuda.empty_cache()
        eval_root = os.path.join(root, "eval")
        os.makedirs(eval_root)
        eval_ok, eval_counts = phase_eval(paths, eval_root)
        shutil.rmtree(eval_root, ignore_errors=True)
        t_pf = time.perf_counter()
        t_eval = t_pf - t_eval
        pf_ok, precision_full = phase_precision_full(
            paths, os.path.join(root, "precision_full"))
        t3 = time.perf_counter()
        t_pf = t3 - t_pf
        serve_ok, serve = phase_serve(paths)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"conv forwards {t1 - t0:.1f}s, checkpoints {t2 - t1:.1f}s, CLI, "
        f"seg2image, seg2image --detect, the guided CLI, the four editing and"
        f" sampler phases and the N-factor CLI {t3 - t2:.1f}s (--detect "
        f"{t_detect:.1f}s, the guided CLI {t_guided:.1f}s, "
        f"the four phases {t_tiled - t_edit:.1f}s, the N-factor CLI "
        f"{t_chain_n:.1f}s), eval phase {t_eval:.1f}s, precision_full "
        f"phase {t_pf:.1f}s, serving phase {time.perf_counter() - t3:.1f}s")
    t0 = time.perf_counter()
    train_ok, train, tr = phase_train()
    t1 = time.perf_counter()
    distill_ok, distill = phase_distill(tr)
    t_cond = time.perf_counter()
    condition_ok, condition = phase_condition(tr)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    t_f32 = time.perf_counter()
    train_f32_ok, train_f32 = phase_train_f32()
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_train_", dir="build")
    try:
        train_cli_ok, train_cli = phase_train_cli(root)
        gc.collect()
        torch.cuda.empty_cache()
        t_cond_cli = time.perf_counter()
        condition_cli_ok, condition_cli = phase_condition_cli(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    log(f"training phase {t1 - t0:.1f}s, distillation phase "
        f"{t_cond - t1:.1f}s, condition phase {t_f32 - t_cond:.1f}s, "
        f"train_f32 phase {t2 - t_f32:.1f}s, training "
        f"CLI phase {t_cond_cli - t2:.1f}s, condition CLI phase "
        f"{t3 - t_cond_cli:.1f}s")
    root = tempfile.mkdtemp(prefix="chip_smoke_recipes_", dir="build")
    try:
        tree = os.path.join(root, "coco")
        write_coco_tree(tree)
        control_ok, control = phase_control(root, tree)
        gc.collect()
        torch.cuda.empty_cache()
        t4 = time.perf_counter()
        joint_ok, joint, model, clip = phase_joint(root, tree)
        t5 = time.perf_counter()
        codenoise_ok, codenoise = phase_codenoise(model, clip)
        del model, clip
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    t6 = time.perf_counter()
    variant_ok, variant = phase_variant()
    gc.collect()
    torch.cuda.empty_cache()
    t7 = time.perf_counter()
    library_ok, library = phase_library()
    gc.collect()
    torch.cuda.empty_cache()
    t8 = time.perf_counter()
    parallel_ok, parallel, ld, cldm = phase_parallel()
    t9 = time.perf_counter()
    winograd_ok, winograd = phase_winograd(ld, cldm)
    del ld, cldm
    gc.collect()
    torch.cuda.empty_cache()
    log(f"control phase {t4 - t3:.1f}s, joint phase {t5 - t4:.1f}s, "
        f"codenoise phase {t6 - t5:.1f}s, variant forward "
        f"{t7 - t6:.1f}s, library phase {t8 - t7:.1f}s, parallel phase "
        f"{t9 - t8:.1f}s, winograd phase {time.perf_counter() - t9:.1f}s")
    by_path = {"chain": chain, "train": train, "serve": serve, "cli": cli,
               "precision_full": precision_full, "seg2image": seg, "guided": guided, "distill": distill,
               "train_f32": train_f32,
               "chain_n": chain_n, "ptp": ptp, "img2img": img2img,
               "ancestral": ancestral, "tiled": tiled,
               "train_cli": train_cli, "control": control, "joint": joint,
               "codenoise": codenoise, "variant": variant,
               "condition": condition, "condition_cli": condition_cli,
               "detect": detect, "detect0": detect0, "eval": eval_counts,
               "library": library, "parallel": parallel,
               "winograd": winograd}
    for name, fn, seed in (("K1-K3 and the combine pass", attn_path_rows, 4),
                           ("K5 and K6", bwd_path_rows, 7),
                           ("K7 and its pre-pass", conv_path_rows, 5),
                           ("K4", gn_path_rows, 6)):
        t0 = time.perf_counter()
        rows += fn(torch.Generator(device="cuda").manual_seed(seed), by_path)
        log(f"{name} at the other shapes the paths launched "
            f"{time.perf_counter() - t0:.1f}s")

    failures = [r["name"] for r in rows if not r["ok"]]
    for r in rows:
        kind, key = r["key"][0], r["key"][1:]
        r["launches"] = by_path.get(r["path"], {}).get(kind, {}).get(key, 0)
        if r["path"] and r["launches"] == 0:
            failures.append(f"{r['name']} not launched by the {r['path']}")
    for kind in ("attn", "combine", "gn"):
        if sum(chain[kind].values()) == 0:
            failures.append(f"{kind} not launched by the chain")
    for kind in ("attn", "flash_attn_bwd_dq", "flash_attn_bwd_dkv", "gn"):
        if sum(train[kind].values()) == 0:
            failures.append(f"{kind} not launched by the training step")
    for kind in ("attn", "combine", "gn", "conv", "prepass"):
        if sum(serve[kind].values()) == 0:
            failures.append(f"{kind} not launched by the served batch")
        if sum(cli[kind].values()) == 0:
            failures.append(f"{kind} not launched by the CLI")
    for kind in ("attn", "gn", "conv", "prepass"):
        if sum(chain_n[kind].values()) == 0:
            failures.append(f"{kind} not launched by the N-factor CLI")
        if sum(eval_counts[kind].values()) == 0:
            failures.append(f"{kind} not launched by the eval CLI")
    for name, tpu in (("K1", K1), ("K2", K2)):
        if not any(attn_kernel(k[4], k[3]) == tpu
                   for k in eval_counts["attn"]):
            failures.append(f"{name} not launched by the eval CLI")
    for name, tpu in (("K1", K1), ("K2", K2), ("K3", K3)):
        if not any(attn_kernel(k[4], k[3]) == tpu for k in cli["attn"]):
            failures.append(f"{name} not launched by the CLI")
        if not any(attn_kernel(k[4], k[3]) == tpu for k in chain_n["attn"]):
            failures.append(f"{name} not launched by the N-factor CLI")
    for kind in ("attn", "gn", "conv"):
        if sum(seg[kind].values()) == 0:
            failures.append(f"{kind} not launched by seg2image's sampling")
    for kind in ("attn", "flash_attn_bwd_dq", "flash_attn_bwd_dkv", "gn"):
        if sum(distill[kind].values()) == 0:
            failures.append(f"{kind} not launched by the distillation step")
    if not any(k[5] for k in distill["attn"]):
        failures.append("K1 with lse not launched by the distillation step")
    for kind in ("attn", "flash_attn_bwd_dq", "flash_attn_bwd_dkv", "gn"):
        if sum(train_f32[kind].values()) == 0:
            failures.append(f"{kind} not launched by the float32 training "
                            "step")
    if not any(k[5] and k[6] == "float32" for k in train_f32["attn"]):
        failures.append("K1-f32 with lse not launched by the float32 "
                        "training step")
    if not train_f32_ok:
        failures.append("float32 training step (train_f32)")
    for kind in ("attn", "flash_attn_bwd_dq", "flash_attn_bwd_dkv", "gn"):
        if sum(train_cli[kind].values()) == 0:
            failures.append(f"{kind} not launched by the training CLI")
    if not any(k[5] for k in train_cli["attn"]):
        failures.append("K1 with lse not launched by the training CLI")
    if not any(attn_kernel(k[4], k[3]) == K2 for k in train_cli["attn"]):
        failures.append("K2 not launched by the training CLI")
    for path, counts, names in (("control", control, ("K1", "K3")),
                                ("joint", joint, ("K1", "K2")),
                                ("codenoise", codenoise, ("K1",)),
                                ("condition", condition, ("K1", "K2")),
                                ("condition_cli", condition_cli,
                                 ("K1", "K2")),
                                ("detect", detect, ("K1", "K3")),
                                ("detect0", detect0, ("K1", "K3"))):
        for name in names:
            tpu = {"K1": K1, "K2": K2, "K3": K3}[name]
            if not any(attn_kernel(k[4], k[3]) == tpu for k in counts["attn"]):
                failures.append(f"{name} not launched by the {path} path")
    for path, counts in (("control", control), ("joint", joint),
                         ("condition", condition),
                         ("condition_cli", condition_cli)):
        if not any(k[5] for k in counts["attn"]):
            failures.append(f"K1 with lse not launched by the {path} path")
        for kind in ("gn", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
            if sum(counts[kind].values()) == 0:
                failures.append(f"{kind} not launched by the {path} path")
    if any(k[4] <= 96 for k in guided["attn"]):
        failures.append("K1 launched by the guided factor 1")
    if not any(attn_kernel(k[4], k[3]) == K2 for k in guided["attn"]):
        failures.append("K2 not launched by the guided CLI")
    if sum(guided["gn"].values()) == 0:
        failures.append("gn not launched by the guided CLI")
    if any(k[4] <= 96 for k in ptp["attn"]):
        failures.append("K1 launched by the ptp sampler")
    for path, counts, names in (("ptp", ptp, ("K3",)),
                                ("img2img", img2img, ("K1", "K3")),
                                ("ancestral", ancestral, ("K1", "K2"))):
        for name in names:
            tpu = {"K1": K1, "K2": K2, "K3": K3}[name]
            if not any(attn_kernel(k[4], k[3]) == tpu for k in counts["attn"]):
                failures.append(f"{name} not launched by the {path} path")
    for path, counts in (("condition", condition),
                         ("condition_cli", condition_cli)):
        for kind in ("gn", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
            if sum(counts[kind].values()) == 0:
                failures.append(f"{kind} not launched by the {path} path")
    for path, counts in (("ptp", ptp), ("img2img", img2img),
                         ("ancestral", ancestral), ("tiled", tiled),
                         ("detect", detect), ("detect0", detect0)):
        for kind in ("gn", "conv", "prepass"):
            if sum(counts[kind].values()) == 0:
                failures.append(f"{kind} not launched by the {path} path")
    if ancestral["attn"].get((1, 8, 1024, 1024, 40, False, "bfloat16"),
                             0) == 0:
        failures.append("K1 not launched at [1,8,1024,40] by the ancestral "
                        "sampler")
    if tiled["attn"].get((9, 1, 4096, 4096, 512, False, "bfloat16"),
                         0) == 0:
        failures.append("K3 not launched at [9,1,4096,512] by the tiled VAE")
    for c in (128, 256):
        if tiled["gn"].get(((9, c, 512, 512), 1e-6), 0) == 0:
            failures.append(f"K4 not launched at [9,{c},512,512] by the "
                            "tiled VAE")
    if not any(k[0] == 9 for k in tiled["conv"]):
        failures.append("K7 not launched at batch 9 by the tiled VAE")
    if not any(attn_kernel(k[4], k[3]) == K2 for k in library["attn"]):
        failures.append("K2 not launched by the library phase")
    if sum(library["conv"].values()) == 0:
        failures.append("K7 not launched by the library phase")
    if not library_ok:
        failures.append("library modules (VQ, LPIPS, encoders, MLSD, Canny)")
    for kind in ("attn", "flash_attn_bwd_dq", "flash_attn_bwd_dkv", "gn",
                 "combine"):
        if sum(parallel[kind].values()) == 0:
            failures.append(f"{kind} not launched by the parallel path")
    if not any(k[5] for k in parallel["attn"]):
        failures.append("K1 with lse not launched by the parallel path")
    for kind in ("attn", "gn"):
        if sum(winograd[kind].values()) == 0:
            failures.append(f"{kind} not launched by the winograd path")
    if not parallel_ok:
        failures.append("parallel paths (DP, TP, FSDP, ring, context "
                        "parallelism, mesh engine)")
    if not winograd_ok:
        failures.append("Winograd conv and the chain with it")
    if not ckpt_ok:
        failures.append("checkpoints written and loaded")
    if not cli_ok:
        failures.append("txt2img_fgdm CLI")
    if not pf_ok:
        failures.append("txt2img_fgdm --precision full and the float32 chain")
    if not seg_ok:
        failures.append("seg2image guess mode")
    if not grad_ok:
        failures.append("Conv3x3 gradient")
    if not unet_ok:
        failures.append("UNet kernels-on vs plain")
    if not conv_ok:
        failures.append("conv-gated forwards kernels-on vs plain")
    if not serve_ok:
        failures.append("serving")
    if not chain_ok:
        failures.append("chain output")
    if not train_ok:
        failures.append("training step")
    if not distill_ok:
        failures.append("distillation step")
    if not train_cli_ok:
        failures.append("training CLI (cli/train.py, -r resume)")
    for good, label in ((condition_ok, "condition-target training step"),
                        (condition_cli_ok,
                         "training CLI on the normal-factor config"),
                        (detect_ok, "seg2image --detect"),
                        (control_ok, "ControlNet fine-tuning recipe"),
                        (joint_ok, "joint two-factor recipe"),
                        (codenoise_ok, "co-denoising sampler"),
                        (variant_ok, "variant UNet kernels-on vs plain")):
        if not good:
            failures.append(label)
    if not guided_ok:
        failures.append("guided CLI (--inference_loss)")
    if not chain_n_ok:
        failures.append("N-factor CLI (--factors)")
    if not eval_ok:
        failures.append("eval CLI (cli/eval.py)")
    for good, label in ((ptp_ok, "prompt-to-prompt sampler"),
                        (img2img_ok, "img2img"),
                        (ancestral_ok, "ancestral sampler"),
                        (tiled_ok, "tiled VAE decode and encode")):
        if not good:
            failures.append(label)
    keys = ("name", "route", "source", "replaces", "dtype", "launches",
            "max_abs_err",
            "ms", "eager_ms", "copy_ms", "plain_ms", "bound_ms", "bound_by",
            "bound_term", "library_ms", "path")
    for path, counts in by_path.items():
        log(f"total launches in the {path}: " + ", ".join(
            f"{kind} {sum(c.values())}" for kind, c in counts.items()))
    if failures:
        log("FAILED: " + "; ".join(failures))
        return 1
    log(card)
    print(json.dumps({"kernels": [{k: r.get(k) for k in keys}
                                  for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
